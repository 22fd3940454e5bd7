"""``mxnet_tpu_torch.elastic``: the parts of the fault-tolerance plane
that the serving plane runs on.

* :mod:`.faults` — deterministic fault injection (``MXTPU_FAULT_INJECT``),
  hooked into ``Server``'s dispatch and live resize;
* :mod:`.manager` — :func:`~.manager.record_recovery`, the recovery
  telemetry of ``Server.recover`` and a resize's crash-heal;
* :mod:`.resize` — the live-resize registry and
  :class:`~.resize.ServingAutoscaler`, which drives
  ``Server.resize_slots``;
* :mod:`.integrity` — the KV-page and token checksums.

Still to come (ROADMAP queue 1 item 7): ``CheckpointManager``,
``ResizeController`` (the training plane's live resize), the guardian
and the chaos soak.
"""
from __future__ import annotations

from . import faults, integrity, manager, resize
from .manager import record_recovery
from .resize import ServingAutoscaler

__all__ = ["ServingAutoscaler", "faults", "integrity", "manager",
           "record_recovery", "resize"]
