"""Structured runtime metrics: counters, gauges, histograms.

The registry is the numeric half of the telemetry plane (events are the
other half, ``recorder.py``).  Design constraints, in order:

* **near-zero when disabled** — every mutating call checks the module
  switch (a plain attribute read) before touching a lock, so a process
  running with ``MXTPU_TELEMETRY=0`` pays one branch per call site;
* **thread-safe** — loader threads, a server's callers and the train
  loop may record concurrently; one registry lock serializes
  mutations (instrument updates are a few arithmetic ops, so a single
  lock does not contend measurably);
* **fixed histogram buckets** — bucket boundaries are part of an
  instrument's identity, chosen at creation and never resized, so two
  snapshots are always comparable and the Prometheus exposition is
  stable across a process's lifetime.

Exporters: :func:`snapshot` (point-in-time dict), :func:`to_prometheus`
(text exposition format) and :func:`write_jsonl` / :func:`read_jsonl`
(one JSON object per instrument per line).
"""
from __future__ import annotations

import json
import math
import threading
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = ["Counter", "Gauge", "Histogram", "counter", "gauge",
           "histogram", "snapshot", "reset_metrics", "to_prometheus",
           "parse_prometheus", "write_jsonl", "read_jsonl",
           "DEFAULT_LATENCY_BUCKETS"]

_lock = threading.Lock()
_instruments: Dict[str, "_Instrument"] = {}

#: latency boundaries (seconds): 100 us .. 2 min, roughly geometric,
#: the JAX package's edges (so two snapshots compare bucket by bucket).
DEFAULT_LATENCY_BUCKETS = (
    1e-4, 3e-4, 1e-3, 3e-3, 1e-2, 3e-2, 0.1, 0.3, 1.0, 3.0, 10.0,
    30.0, 120.0)


def _enabled() -> bool:
    # late import: the switch lives on the package root so one flag
    # gates metrics AND events; this indirection only runs on the
    # mutation paths, which already decided to do work
    from . import _switch
    return _switch.enabled


class _Instrument:
    """Shared identity (name, doc, kind); subclasses hold the value."""

    kind = "instrument"
    __slots__ = ("name", "doc")

    def __init__(self, name: str, doc: str = ""):
        self.name = name
        self.doc = doc

    def _sample(self):
        raise NotImplementedError

    def _reset(self):
        raise NotImplementedError


class Counter(_Instrument):
    """Monotonically increasing count (dispatches, stalls, retraces)."""

    kind = "counter"
    __slots__ = ("_value",)

    def __init__(self, name, doc=""):
        super().__init__(name, doc)
        self._value = 0.0

    def inc(self, amount: float = 1.0):
        if not _enabled():
            return
        if amount < 0:
            raise ValueError(
                f"counter {self.name!r} cannot decrease (inc {amount})")
        with _lock:
            self._value += amount

    @property
    def value(self) -> float:
        return self._value

    def _sample(self):
        return {"type": "counter", "name": self.name, "value": self._value}

    def _reset(self):
        self._value = 0.0


class Gauge(_Instrument):
    """Point-in-time level (queue depth, staging occupancy)."""

    kind = "gauge"
    __slots__ = ("_value",)

    def __init__(self, name, doc=""):
        super().__init__(name, doc)
        self._value = 0.0

    def set(self, value: float):
        if not _enabled():
            return
        with _lock:
            self._value = float(value)

    def inc(self, amount: float = 1.0):
        if not _enabled():
            return
        with _lock:
            self._value += amount

    def dec(self, amount: float = 1.0):
        self.inc(-amount)

    @property
    def value(self) -> float:
        return self._value

    def _sample(self):
        return {"type": "gauge", "name": self.name, "value": self._value}

    def _reset(self):
        self._value = 0.0


class Histogram(_Instrument):
    """Distribution over FIXED bucket boundaries.

    ``buckets`` are upper bounds (``le``); an implicit +inf bucket
    catches the tail.  ``observe`` is O(len(buckets)) worst case —
    bisect would save nothing at these sizes and keeps the hot path
    allocation-free.
    """

    kind = "histogram"
    __slots__ = ("buckets", "_counts", "_count", "_sum", "_min", "_max")

    def __init__(self, name, doc="", buckets: Sequence[float] = None):
        super().__init__(name, doc)
        bounds = tuple(float(b) for b in
                       (buckets if buckets is not None
                        else DEFAULT_LATENCY_BUCKETS))
        if list(bounds) != sorted(bounds) or len(set(bounds)) != len(bounds):
            raise ValueError(
                f"histogram {name!r} buckets must be strictly "
                f"increasing, got {bounds}")
        self.buckets = bounds
        self._counts = [0] * (len(bounds) + 1)   # +1: the +inf bucket
        self._count = 0
        self._sum = 0.0
        self._min = math.inf
        self._max = -math.inf

    def observe(self, value: float):
        if not _enabled():
            return
        v = float(value)
        with _lock:
            i = 0
            for b in self.buckets:
                if v <= b:
                    break
                i += 1
            self._counts[i] += 1
            self._count += 1
            self._sum += v
            if v < self._min:
                self._min = v
            if v > self._max:
                self._max = v

    def summary(self) -> dict:
        """Aggregate view: count/sum/min/max/avg plus cumulative bucket
        counts."""
        with _lock:
            counts = list(self._counts)
            n, s = self._count, self._sum
            mn, mx = self._min, self._max
        cumulative: List[Tuple[float, int]] = []
        acc = 0
        for b, c in zip(self.buckets, counts):
            acc += c
            cumulative.append((b, acc))
        return {"count": n, "sum": s,
                "min": mn if n else None, "max": mx if n else None,
                "avg": (s / n) if n else None,
                "buckets": cumulative}

    def quantile(self, q: float):
        """Prometheus-style quantile estimate from the cumulative
        bucket counts: the upper bound of the first bucket whose
        cumulative count reaches ``q`` of the total, clamped to the
        observed min/max (so p50/p99 of a tight distribution do not
        report a coarse bucket edge beyond the real range).  ``None``
        before any observation."""
        with _lock:
            counts = list(self._counts)
            n = self._count
            mn, mx = self._min, self._max
        if not n:
            return None
        rank = q * n
        acc = 0
        for b, c in zip(self.buckets, counts):
            acc += c
            if acc >= rank:
                return min(max(b, mn), mx)
        return mx

    def _sample(self):
        d = self.summary()
        d.update(type="histogram", name=self.name,
                 buckets=[[b, c] for b, c in d["buckets"]])
        return d

    def _reset(self):
        self._counts = [0] * (len(self.buckets) + 1)
        self._count = 0
        self._sum = 0.0
        self._min = math.inf
        self._max = -math.inf


def _get_or_create(cls, name, doc, **kw):
    with _lock:
        inst = _instruments.get(name)
        if inst is None:
            inst = cls(name, doc, **kw)
            _instruments[name] = inst
        elif not isinstance(inst, cls):
            raise TypeError(
                f"metric {name!r} already registered as {inst.kind}, "
                f"requested {cls.kind}")
        return inst


def counter(name: str, doc: str = "") -> Counter:
    """Get or create the named counter (idempotent — call sites don't
    coordinate registration order)."""
    return _get_or_create(Counter, name, doc)


def gauge(name: str, doc: str = "") -> Gauge:
    return _get_or_create(Gauge, name, doc)


def histogram(name: str, doc: str = "",
              buckets: Optional[Sequence[float]] = None) -> Histogram:
    return _get_or_create(Histogram, name, doc, buckets=buckets)


def snapshot() -> dict:
    """Point-in-time view of every instrument, grouped by kind."""
    with _lock:
        insts = list(_instruments.values())
    out = {"counters": {}, "gauges": {}, "histograms": {}}
    for inst in insts:
        if inst.kind == "counter":
            out["counters"][inst.name] = inst.value
        elif inst.kind == "gauge":
            out["gauges"][inst.name] = inst.value
        else:
            out["histograms"][inst.name] = inst.summary()
    return out


def reset_metrics():
    """Zero every instrument (identity/buckets retained) — for tests
    and per-run isolation."""
    with _lock:
        for inst in _instruments.values():
            inst._reset()


# -- exporters --------------------------------------------------------------

def to_prometheus() -> str:
    """Prometheus text exposition (0.0.4) of the current registry."""
    with _lock:
        insts = sorted(_instruments.values(), key=lambda i: i.name)
    lines: List[str] = []
    for inst in insts:
        if inst.doc:
            lines.append(f"# HELP {inst.name} {inst.doc}")
        lines.append(f"# TYPE {inst.name} {inst.kind}")
        if inst.kind == "counter":
            # Prometheus counters end in _total; don't double the
            # suffix when the instrument already follows the convention
            n = inst.name if inst.name.endswith("_total") \
                else inst.name + "_total"
            lines.append(f"{n} {inst.value:g}")
        elif inst.kind == "gauge":
            lines.append(f"{inst.name} {inst.value:g}")
        else:
            s = inst.summary()
            for b, c in s["buckets"]:
                lines.append(f'{inst.name}_bucket{{le="{b:g}"}} {c}')
            lines.append(f'{inst.name}_bucket{{le="+Inf"}} {s["count"]}')
            lines.append(f"{inst.name}_sum {s['sum']:g}")
            lines.append(f"{inst.name}_count {s['count']}")
    return "\n".join(lines) + "\n"


def parse_prometheus(text: str) -> dict:
    """Parse :func:`to_prometheus` output back into
    ``{name: value-or-series}`` — the round-trip half the exporter test
    (and any scraper-less consumer) uses."""
    out: Dict[str, object] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        name_part, _, value = line.rpartition(" ")
        if "{" in name_part:
            base, _, label = name_part.partition("{")
            le = label.rstrip("}").split("=", 1)[1].strip('"')
            series = out.setdefault(base, {})
            series[le] = float(value)
        else:
            out[name_part] = float(value)
    return out


def write_jsonl(path: str) -> int:
    """Append one JSON line per instrument to ``path``; returns the
    number of lines written."""
    with _lock:
        insts = sorted(_instruments.values(), key=lambda i: i.name)
    rows = [inst._sample() for inst in insts]
    with open(path, "a") as f:
        for row in rows:
            f.write(json.dumps(row) + "\n")
    return len(rows)


def read_jsonl(path: str) -> List[dict]:
    """Load every sample row from a :func:`write_jsonl` file."""
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                rows.append(json.loads(line))
    return rows
