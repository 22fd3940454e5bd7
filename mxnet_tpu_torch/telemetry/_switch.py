"""The telemetry master switch, in its own module so the metrics, the
recorder and the hot paths (the serving dispatch) read one plain
attribute without import cycles.

``enabled`` is read from ``MXTPU_TELEMETRY`` once at import;
``telemetry.enable()``/``disable()`` flip it at runtime.  Call sites read
it as ``_switch.enabled``: one attribute load when the plane is off.
"""
from __future__ import annotations

from .. import envs

enabled: bool = bool(envs.get("MXTPU_TELEMETRY"))
