"""``mxnet_tpu_torch.telemetry``: the runtime observability plane.

* **metrics** (:mod:`.metrics`): thread-safe counters, gauges and
  fixed-bucket histograms with ``snapshot()``, Prometheus-text and
  JSONL exporters;
* **events and the flight recorder** (:mod:`.recorder`): bounded rings
  of structured events (dispatch, poison, recovery, request_evicted,
  shed, resize, ...), dumped to a JSON artifact on failure or on
  demand.

The serving plane reports here under the JAX package's metric names and
event kinds, so one dashboard, one ``parse_prometheus`` and one
flight-recorder reader serve both packages.

Master switch: ``MXTPU_TELEMETRY`` (default on) / :func:`enable` /
:func:`disable`.  Disabled, every call site pays one attribute load and
returns.

Not here yet: the memory observatory (``telemetry.memory``) and the
training-health plane (``telemetry.health``), with ``record_step`` at
the trainers and the DataLoader's prefetch metrics (ROADMAP queue 1
item 7).
"""
from __future__ import annotations

import threading as _threading

from . import _switch
from . import metrics
from .metrics import (Counter, Gauge, Histogram, counter, gauge,
                      histogram, snapshot, reset_metrics, to_prometheus,
                      parse_prometheus, write_jsonl, read_jsonl,
                      DEFAULT_LATENCY_BUCKETS)
from .recorder import (record_event, events, clear_events,
                       dump_flight_recorder, auto_dump, last_dump,
                       note_step, current_step)

__all__ = [
    "enabled", "enable", "disable", "reset",
    "Counter", "Gauge", "Histogram", "counter", "gauge", "histogram",
    "snapshot", "reset_metrics", "to_prometheus", "parse_prometheus",
    "write_jsonl", "read_jsonl", "DEFAULT_LATENCY_BUCKETS",
    "record_event", "events", "clear_events", "dump_flight_recorder",
    "auto_dump", "last_dump", "note_step", "current_step",
    "record_step", "step_owner", "step_owned",
    "prefetch_stall_ratio", "export_metrics",
]

#: dispatch-count boundaries of the per-step dispatch histogram
DISPATCH_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024)


def enabled() -> bool:
    """Is the telemetry plane recording?"""
    return _switch.enabled


def enable():
    _switch.enabled = True


def disable():
    _switch.enabled = False


def reset():
    """Zero every metric, empty the event rings and rewind the global
    step counter (test isolation).  Instrument identities survive."""
    from . import recorder
    reset_metrics()
    clear_events()
    recorder._reset_steps()


_tls = _threading.local()


class _StepOwner:
    """Marks the dynamic extent of a whole-step owner (a serving
    dispatch, a captured train step): a step recorded inside it is
    accounted once, by the owner."""

    __slots__ = ("_owner", "_what")

    def __init__(self, owner=None, what=None):
        self._owner = owner
        self._what = what

    def __enter__(self):
        _tls.depth = getattr(_tls, "depth", 0) + 1
        return self

    def __exit__(self, exc_type, exc, tb):
        _tls.depth -= 1


def step_owner(owner=None, what: str = None) -> _StepOwner:
    return _StepOwner(owner, what)


def step_owned() -> bool:
    """Is a whole-step owner on this thread's stack?"""
    return getattr(_tls, "depth", 0) > 0


def record_step(where: str, seconds: float, dispatches=None,
                examples=None, path: str = None, steps: int = 1):
    """Everything one train step owes the plane: the latency histogram
    of its seam (``mxtpu_{where}_seconds``, or ``..._bulk_seconds`` for a
    call of ``steps > 1``), the steps counter, the dispatches-per-step
    distribution and throughput, and a ``step`` event.  Returns the
    global step count after it."""
    if not _switch.enabled:
        return
    step = None
    for _ in range(max(1, int(steps))):
        step = note_step()
    suffix = "_seconds" if steps <= 1 else "_bulk_seconds"
    histogram(f"mxtpu_{where}{suffix}",
              f"{where} wall-clock latency (s)"
              + ("" if steps <= 1 else ", per bulked multi-step call")
              ).observe(seconds)
    counter("mxtpu_steps_total", "train steps recorded").inc(
        max(1, int(steps)))
    fields = {"where": where, "seconds": round(seconds, 6)}
    if steps > 1:
        fields["bulked_steps"] = int(steps)
    if path is not None:
        fields["path"] = path
    if dispatches is not None:
        fields["dispatches"] = dispatches
        if steps <= 1:
            # a bulked call's one dispatch covers K steps and would read
            # as a wrong per-step value
            gauge("mxtpu_last_step_dispatches",
                  "engine dispatches in the most recent step"
                  ).set(dispatches)
            histogram("mxtpu_step_dispatches",
                      "engine dispatches per train step",
                      buckets=DISPATCH_BUCKETS).observe(dispatches)
    if examples:
        counter("mxtpu_examples_total", "training examples consumed"
                ).inc(examples)
        if seconds > 0:
            gauge("mxtpu_examples_per_sec",
                  "throughput of the most recent step"
                  ).set(examples / seconds)
    record_event("step", **fields)
    return step


def prefetch_stall_ratio() -> float:
    """Fraction of consumed batches on which the consumer found the
    prefetch queue dry; 0.0 before any loader reported."""
    snap = snapshot()["counters"]
    batches = snap.get("mxtpu_dataloader_batches_total", 0.0)
    if not batches:
        return 0.0
    return snap.get("mxtpu_prefetch_stalls_total", 0.0) / batches


def export_metrics(path: str = None) -> str:
    """Append a JSONL metrics snapshot to ``path`` (default
    ``metrics.jsonl`` under ``MXTPU_TELEMETRY_EXPORT``, else the cwd);
    returns the path written."""
    import os
    from .. import envs
    if path is None:
        out_dir = envs.get("MXTPU_TELEMETRY_EXPORT") or "."
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(out_dir, "metrics.jsonl")
    write_jsonl(path)
    return path
