"""The recovery telemetry of the elastic plane.

Only :func:`record_recovery` is here: the serving plane's ``recover()``
and a live resize's crash-heal report through it.  ``CheckpointManager``
comes with the checkpoints of the training plane (ROADMAP queue 1
item 7).
"""
from __future__ import annotations

__all__ = ["record_recovery"]


def record_recovery(where: str, seconds: float, poisoned: bool,
                    **fields) -> None:
    """Emit the recovery telemetry triple in one place for every
    recoverable owner: the counter ``mxtpu_recoveries_total``, the
    time-to-recover histogram ``mxtpu_recovery_seconds`` and a retained
    ``recovery`` event."""
    from .. import telemetry
    telemetry.counter("mxtpu_recoveries_total",
                      "recoveries of a poisoned or healthy owner "
                      "(train stacks: checkpoint restore; serving: "
                      "pool rebuild + request replay)").inc()
    telemetry.histogram(
        "mxtpu_recovery_seconds",
        "time to rebuild an owner's dispatchable state after "
        "recover() (s)").observe(seconds)
    telemetry.record_event("recovery", where=where,
                           seconds=round(seconds, 4),
                           poisoned=poisoned, **fields)
