"""Live resize of the serving plane: the registry of completed resizes
and the autoscale policy.

``serving.Server.resize_slots`` takes a running server from one slot
count to another (prewarm -> drain -> migrate -> swap) and reports here:
:func:`_note_completed` for every resize that ended on a consistent
configuration (a crash-healed one included), :func:`_note_failed` for
one that aborted or healed.  :class:`ServingAutoscaler` watches the
queue depth and occupancy and drives ``resize_slots`` with hysteresis
from the ``MXTPU_RESIZE_*`` knobs.

The records, the events and the policy are the JAX package's.  Its
``ResizeController`` (the training plane's mesh resize) comes with the
checkpoints (ROADMAP queue 1 item 7).
"""
from __future__ import annotations

import threading
import time
from typing import List, Optional

from ..base import MXNetError

__all__ = ["ServingAutoscaler", "resizes", "report"]

_reg_lock = threading.Lock()
_records: List[dict] = []


def _note_completed(rec: dict) -> dict:
    """Append a completed resize to the registry and emit the counter,
    the downtime histogram and a retained ``resize`` event."""
    from .. import telemetry
    with _reg_lock:
        _records.append(rec)
    telemetry.counter(
        "mxtpu_resizes_total",
        "completed live resizes (train mesh changes + serving slot "
        "changes), healed ones included").inc()
    telemetry.histogram(
        "mxtpu_resize_downtime_seconds",
        "drain start -> executable swap complete per live resize "
        "(s)").observe(float(rec.get("downtime_seconds", 0.0)))
    # the record's "kind" would collide with the event's taxonomy key
    telemetry.record_event(
        "resize", **{("resize_kind" if k == "kind" else k): v
                     for k, v in rec.items() if not k.startswith("_")})
    return rec


def _note_failed(kind: str, phase: str, error: str, **fields):
    from .. import telemetry
    telemetry.record_event("resize_failed", resize_kind=kind,
                           phase=phase, error=error[:300], **fields)


def resizes() -> List[dict]:
    """Completed-resize records, oldest first (copies)."""
    with _reg_lock:
        return [dict(r) for r in _records]


def _reset():
    """Test hook."""
    with _reg_lock:
        _records.clear()


def report() -> dict:
    """This process's resizes: the records, the counter, the downtime
    histogram's count and sum, and the ``resize_failed`` events."""
    from .. import telemetry
    snap = telemetry.snapshot()
    hist = snap["histograms"].get("mxtpu_resize_downtime_seconds", {})
    return {
        "resizes": resizes(),
        "total": snap["counters"].get("mxtpu_resizes_total", 0.0),
        "downtime_seconds": {k: hist.get(k) for k in ("count", "sum")},
        "failed_events": telemetry.events("resize_failed"),
    }


class ServingAutoscaler:
    """Hysteresis autoscale policy over the serving plane's queue depth
    and occupancy, driving ``Server.resize_slots``.

    Call :meth:`observe` once per scheduling round.  Growth doubles the
    slot count when the wait queue has been at or above ``up_queue`` for
    ``patience`` consecutive observations; shrink halves it when the
    queue is empty and occupancy has been at or below ``down_occupancy``
    for ``patience`` observations.  ``cooldown_s`` spaces resizes so the
    two thresholds cannot flap the plane.  The defaults come from the
    ``MXTPU_RESIZE_*`` knobs."""

    def __init__(self, server, min_slots: Optional[int] = None,
                 max_slots: Optional[int] = None,
                 up_queue: Optional[int] = None,
                 down_occupancy: Optional[float] = None,
                 patience: Optional[int] = None,
                 cooldown_s: Optional[float] = None):
        from .. import envs

        def _get(v, name, typ):
            return typ(envs.get(name)) if v is None else typ(v)

        self.server = server
        self.min_slots = _get(min_slots, "MXTPU_RESIZE_MIN_SLOTS", int)
        self.max_slots = _get(max_slots, "MXTPU_RESIZE_MAX_SLOTS", int)
        self.up_queue = _get(up_queue, "MXTPU_RESIZE_UP_QUEUE", int)
        self.down_occupancy = _get(down_occupancy,
                                   "MXTPU_RESIZE_DOWN_OCCUPANCY", float)
        self.patience = max(1, _get(patience, "MXTPU_RESIZE_PATIENCE",
                                    int))
        self.cooldown_s = _get(cooldown_s, "MXTPU_RESIZE_COOLDOWN_S",
                               float)
        if self.min_slots < 1 or self.max_slots < self.min_slots:
            raise MXNetError(
                f"bad slot bounds [{self.min_slots}, {self.max_slots}]")
        self._hot = 0
        self._cold = 0
        self._last_resize = float("-inf")

    def slots(self) -> int:
        return max(b.slots for b in self.server.sched.buckets)

    def observe(self) -> Optional[dict]:
        """One policy tick; returns the resize record when one fired,
        else ``None``."""
        sched = self.server.sched
        q = sched.queue_depth()
        occ = sched.occupancy()
        if q >= self.up_queue:
            self._hot += 1
            self._cold = 0
        elif q == 0 and occ <= self.down_occupancy:
            self._cold += 1
            self._hot = 0
        else:
            self._hot = 0
            self._cold = 0
        now = time.monotonic()
        if now - self._last_resize < self.cooldown_s:
            return None
        cur = self.slots()
        target = None
        reason = None
        if self._hot >= self.patience and cur < self.max_slots:
            target = min(self.max_slots, cur * 2)
            reason = f"queue_depth {q} >= {self.up_queue}"
        elif self._cold >= self.patience and cur > self.min_slots:
            target = max(self.min_slots, cur // 2)
            reason = (f"occupancy {occ:.2f} <= "
                      f"{self.down_occupancy:.2f}, queue empty")
        if target is None or target == cur:
            return None
        self._hot = 0
        self._cold = 0
        self._last_resize = now
        return self.server.resize_slots(target, reason=reason)
