"""Flight recorder: a bounded ring of recent runtime events.

The numeric metrics answer "how much"; the flight recorder answers
"what just happened": the last N structured events (dispatches,
evictions, poison, recovery, resizes) so a crash dump carries the
sequence that led to it, not just the final counter values.

* capacity comes from ``MXTPU_FLIGHT_RECORDER_SIZE`` (a ``deque``
  maxlen: appends stay O(1) and old events fall off the far end);
* there are two rings of that capacity: high-volume timeline events
  (``dispatch``) in one, the rare forensic kinds in the other, so a
  flood of dispatches cannot push out the poison or the eviction that
  explains a failure; :func:`events` and the dumps merge both by order
  of arrival;
* :func:`dump_flight_recorder` writes both rings and a metrics snapshot
  as one JSON artifact: on demand, or throttled through
  :func:`auto_dump` when a serving dispatch fails.

The event taxonomy and the artifact's schema are the JAX package's.
"""
from __future__ import annotations

import collections
import json
import os
import threading
import time
from typing import Deque, List, Optional

__all__ = ["record_event", "events", "clear_events",
           "dump_flight_recorder", "auto_dump", "last_dump",
           "note_step", "current_step"]

_lock = threading.Lock()
#: the kinds kept in the retained ring (the JAX package's list: kinds
#: this port does not emit yet stay, so a shared taxonomy stays shared)
_RARE_KINDS = frozenset(("retrace", "fallback", "poison", "error",
                         "evict", "prefetch_stall", "oom_risk",
                         "mem_analysis_unavailable", "health_anomaly",
                         "request_evicted", "slot_oom",
                         "resize", "resize_failed",
                         "hang_suspected", "hang_resolved",
                         "preempted", "preempt_forced",
                         "corruption_suspected", "corruption_resolved",
                         "device_quarantined", "scrub_corrupt",
                         "integrity_inapplicable",
                         "sanitizer_violation",
                         "shed", "deadline_evicted",
                         "recovery"))
_ring: Optional[Deque[dict]] = None        # high-volume kinds
_rare: Optional[Deque[dict]] = None        # retained rare kinds
_dropped = 0          # events pushed out of either ring since clear
_seq = 0              # monotone order of arrival, the merge key
_step = 0             # completed train steps at event-emit time
_t0 = time.time()
_last_dump: Optional[str] = None
# crash-path dumps are throttled: a test suite that provokes failures
# would otherwise write one artifact per provoked error
_auto_dumps_left = 25


def _capacity() -> int:
    from .. import envs
    return max(16, envs.get("MXTPU_FLIGHT_RECORDER_SIZE"))


def _get_rings():
    global _ring, _rare
    if _ring is None:
        cap = _capacity()
        _ring = collections.deque(maxlen=cap)
        _rare = collections.deque(maxlen=cap)
    return _ring, _rare


def note_step() -> int:
    """Advance the global train-step counter (once per train step, at
    its end): an event's ``step`` field reads "completed steps when this
    happened"."""
    global _step
    with _lock:
        _step += 1
        return _step


def current_step() -> int:
    return _step


def record_event(kind: str, **fields):
    """Append one structured event (no-op when telemetry is disabled).
    ``kind`` is the taxonomy key; fields must be JSON-serializable.
    Rare kinds go to the retained ring."""
    from . import _switch
    if not _switch.enabled:
        return
    global _dropped, _seq
    with _lock:
        ring, rare = _get_rings()
        target = rare if kind in _RARE_KINDS else ring
        _seq += 1
        ev = {"ts": round(time.time() - _t0, 6), "seq": _seq,
              "kind": kind, "step": _step}
        ev.update(fields)
        if len(target) == target.maxlen:
            _dropped += 1
        target.append(ev)


def events(kind: Optional[str] = None) -> List[dict]:
    """Current recorded events (oldest first, both rings merged into
    one timeline), optionally filtered by kind."""
    with _lock:
        ring, rare = _get_rings()
        evs = sorted(list(ring) + list(rare), key=lambda e: e["seq"])
    if kind is not None:
        evs = [e for e in evs if e["kind"] == kind]
    return evs


def clear_events():
    """Empty both rings (the capacity is read from the environment again
    at the next event).  The global step counter survives."""
    global _ring, _rare, _dropped
    with _lock:
        _ring = None
        _rare = None
        _dropped = 0


def _reset_steps():
    """Zero the global step counter (part of ``telemetry.reset()``)."""
    global _step
    with _lock:
        _step = 0


def dump_flight_recorder(path: Optional[str] = None,
                         reason: str = "on_demand") -> str:
    """Write both rings and a metrics snapshot as one JSON artifact;
    returns the path written (also :func:`last_dump`).

    Default location: ``MXTPU_TELEMETRY_EXPORT`` when set (created if
    missing), else the system temp dir; the file name carries the pid
    and a millisecond stamp so concurrent dumps never clobber."""
    import tempfile
    from . import metrics
    from .. import envs
    if path is None:
        out_dir = envs.get("MXTPU_TELEMETRY_EXPORT") or \
            tempfile.gettempdir()
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(
            out_dir, "mxtpu_flight_%d_%d.json"
            % (os.getpid(), int(time.time() * 1e3)))
    with _lock:
        ring, rare = _get_rings()
        evs = sorted(list(ring) + list(rare), key=lambda e: e["seq"])
        dropped = _dropped
        step = _step
    artifact = {
        "reason": reason,
        "pid": os.getpid(),
        "wall_time": time.time(),
        "step": step,
        "dropped_events": dropped,
        "events": evs,
        "metrics": metrics.snapshot(),
    }
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(artifact, f, indent=1)
    os.replace(tmp, path)
    global _last_dump
    _last_dump = path
    return path


def auto_dump(reason: str) -> Optional[str]:
    """Crash-path dump: :func:`dump_flight_recorder`, throttled per
    process and never raising (forensics must not mask the failure that
    called it)."""
    global _auto_dumps_left
    from . import _switch
    if not _switch.enabled:
        return None
    with _lock:
        if _auto_dumps_left <= 0:
            return None
        _auto_dumps_left -= 1
    try:
        return dump_flight_recorder(reason=reason)
    except Exception:
        return None


def last_dump() -> Optional[str]:
    """Path of the most recent flight-recorder artifact (or None)."""
    return _last_dump
