"""Deterministic fault injection: every failure the serving plane claims
to survive is a knob the CPU tests (and the card's smoke) can pull.

``MXTPU_FAULT_INJECT`` holds a ``;``-separated list of fault specs::

    point[:qualifier[,qualifier...]]

    dispatch:nth=2             # raise before the 2nd dispatch launches
    dispatch_post:nth=2        # the 2nd dispatch runs, then raises:
                               # the poison protocol fires
    resize_swap                # fail a live resize at its swap
    dispatch:prob=0.05         # every arrival fires with p=0.05, from
                               # the MXTPU_FAULT_SEED RNG stream

The grammar, the registry and the random stream are the JAX package's,
so one spec and one seed fire on the same arrivals in both packages.

Hooked points of this package (in ``serving.Server``):

* ``dispatch`` — before a variant launches (:func:`on_dispatch`):
  nothing was written, so ``MXTPU_DISPATCH_RETRIES`` may retry it;
* ``dispatch_post`` — after the variant ran (:func:`after_launch`): its
  graph has already written the KV pages in place, then the dispatch
  raises, so the server poisons until ``recover()``;
* ``resize_prewarm`` / ``resize_drain`` / ``resize_reshard`` /
  ``resize_swap`` — the four transitions of ``Server.resize_slots``.

The other points of :data:`POINTS` (``checkpoint_write``,
``host_copy``, ``nonfinite_grad``, ``dispatch_hang``,
``preempt_signal``, ``corrupt_*``) parse and count arrivals, but no
code of this package reaches them yet: they come with the planes that
own them (checkpoints, the health plane, the guardian).

Qualifiers: ``nth=N`` fires on the Nth arrival at the point (1-based);
``step=N`` on the first arrival at or after global train step N
(``telemetry.current_step()``); ``times=K`` repeats the fault K times
(default 1; 0 = unlimited); ``prob=P`` fires each eligible arrival with
probability P from a ``random.Random`` seeded by ``MXTPU_FAULT_SEED``
(or ``configure``'s ``seed=``); ``ms=N``, ``device=D``, ``leaf=J`` and
``bit=B`` are the payloads of the points not hooked here.  A spec is
one-shot by default, except a ``prob=`` spec, which defaults to
unlimited ``times``.

The hooks cost one module-attribute read (``_active``) when no fault is
configured.
"""
from __future__ import annotations

import os
import random as _random
import threading
from typing import Dict, List, Optional

__all__ = ["FaultError", "FaultSpec", "configure", "configure_from_env",
           "clear", "active", "fired", "maybe_fire", "on_dispatch",
           "after_launch", "POINTS", "CORRUPT_POINTS"]

#: the injection points of the shared grammar (unknown points parse but
#: are reported by :func:`configure`)
POINTS = ("dispatch", "dispatch_post", "dispatch_hang",
          "checkpoint_write", "host_copy",
          "nonfinite_grad", "preempt_signal",
          "resize_drain", "resize_prewarm",
          "resize_reshard", "resize_swap",
          "corrupt_param", "corrupt_grad", "corrupt_wire")

#: the silent-corruption points (payloads ``device=``/``leaf=``/``bit=``)
CORRUPT_POINTS = ("corrupt_param", "corrupt_grad", "corrupt_wire")


class FaultError(RuntimeError):
    """An injected fault (a RuntimeError, so the retry rule treats it as
    a runtime failure)."""


class FaultSpec:
    __slots__ = ("point", "nth", "step", "times", "prob", "ms",
                 "device", "leaf", "bit", "fired_count")

    def __init__(self, point: str, nth: Optional[int] = None,
                 step: Optional[int] = None, times: int = 1,
                 prob: Optional[float] = None,
                 ms: Optional[int] = None,
                 device: Optional[int] = None,
                 leaf: Optional[int] = None,
                 bit: Optional[int] = None):
        self.point = point
        self.nth = nth
        self.step = step
        self.times = times
        self.prob = prob
        self.ms = ms
        self.device = device
        self.leaf = leaf
        self.bit = bit
        self.fired_count = 0

    @property
    def exhausted(self) -> bool:
        # times=0 means unlimited (the prob= default)
        return self.times > 0 and self.fired_count >= self.times

    def __repr__(self):
        quals = []
        if self.nth is not None:
            quals.append(f"nth={self.nth}")
        if self.step is not None:
            quals.append(f"step={self.step}")
        if self.prob is not None:
            quals.append(f"prob={self.prob:g}")
        if self.ms is not None:
            quals.append(f"ms={self.ms}")
        for k in ("device", "leaf", "bit"):
            v = getattr(self, k)
            if v is not None:
                quals.append(f"{k}={v}")
        if self.times != (0 if self.prob is not None else 1):
            quals.append(f"times={self.times}")
        return self.point + (":" + ",".join(quals) if quals else "")


_lock = threading.Lock()
_specs: List[FaultSpec] = []
_counts: Dict[str, int] = {}
_fired: List[str] = []
#: fast-path flag: hooks read this one attribute and return when False
_active = False
#: the prob= qualifier's RNG, re-seeded by every :func:`configure`
_rng = _random.Random(0)


def _parse(text: str) -> List[FaultSpec]:
    specs: List[FaultSpec] = []
    for raw in text.replace("\n", ";").split(";"):
        raw = raw.strip()
        if not raw:
            continue
        point, _, qual = raw.partition(":")
        point = point.strip()
        kw: Dict[str, float] = {}
        for q in qual.split(","):
            q = q.strip()
            if not q:
                continue
            k, _, v = q.partition("=")
            k = k.strip()
            if k not in ("nth", "step", "times", "prob", "ms",
                         "device", "leaf", "bit") \
                    or not v.strip():
                raise ValueError(
                    f"bad fault qualifier {q!r} in {raw!r} "
                    "(expected nth=N, step=N, times=K, prob=P, "
                    "ms=N, device=D, leaf=J, or bit=B)")
            try:
                kw[k] = float(v) if k == "prob" else int(v)
            except ValueError:
                raise ValueError(
                    f"bad fault qualifier value {q!r} in {raw!r}")
        prob = kw.get("prob")
        if prob is not None and not 0.0 <= prob <= 1.0:
            raise ValueError(
                f"prob must be in [0, 1], got {prob} in {raw!r}")
        default_times = 0 if prob is not None else 1
        specs.append(FaultSpec(point, nth=kw.get("nth"),
                               step=kw.get("step"),
                               times=int(kw.get("times",
                                                default_times)),
                               prob=prob,
                               ms=kw.get("ms"),
                               device=kw.get("device"),
                               leaf=kw.get("leaf"),
                               bit=kw.get("bit")))
    return specs


def _seed_from_env() -> int:
    from .. import envs
    try:
        return int(envs.get("MXTPU_FAULT_SEED"))
    except ValueError:
        return 0


def configure(text: Optional[str], seed: Optional[int] = None) -> int:
    """Install the fault plan from ``text`` (the ``MXTPU_FAULT_INJECT``
    grammar); ``None``/empty clears it.  Returns the spec count.  The
    arrival counters, the fired log and the ``prob=`` RNG (seeded by
    ``seed`` or ``MXTPU_FAULT_SEED``) reset with each configure."""
    global _active
    specs = _parse(text) if text else []
    unknown = [s.point for s in specs if s.point not in POINTS]
    if unknown:
        # a silent typo would make a recovery drill pass vacuously
        import warnings
        warnings.warn(
            f"MXTPU_FAULT_INJECT: unknown fault point(s) {unknown} "
            f"will never fire (known: {', '.join(POINTS)})",
            RuntimeWarning, stacklevel=2)
    with _lock:
        _specs[:] = specs
        _counts.clear()
        _fired.clear()
        _rng.seed(_seed_from_env() if seed is None else int(seed))
        _active = bool(specs)
    return len(specs)


def configure_from_env() -> int:
    """(Re-)read ``MXTPU_FAULT_INJECT``.  A malformed spec disables
    injection with a warning instead of raising (this runs at import);
    an explicit :func:`configure` still raises on bad grammar."""
    from .. import envs
    try:
        return configure(envs.get("MXTPU_FAULT_INJECT"))
    except ValueError as e:
        import warnings
        warnings.warn(f"MXTPU_FAULT_INJECT ignored — {e}",
                      RuntimeWarning, stacklevel=2)
        configure(None)
        return 0


def clear():
    configure(None)


def active() -> bool:
    """Any un-exhausted fault spec armed?"""
    return _active


def fired() -> List[str]:
    """Repr of every spec that has fired this configuration."""
    with _lock:
        return list(_fired)


def _current_step() -> int:
    from .. import telemetry
    return telemetry.current_step()


def _check(point: str) -> Optional[FaultSpec]:
    """Count an arrival at ``point``; return the spec that fires now
    (consuming one of its ``times``), else None."""
    global _active
    with _lock:
        if not _specs:
            return None
        n = _counts.get(point, 0) + 1
        _counts[point] = n
        hit = None
        for s in _specs:
            if s.point != point or s.exhausted:
                continue
            if s.nth is not None and n != s.nth:
                continue
            if s.step is not None and _current_step() < s.step:
                continue
            if s.prob is not None and _rng.random() >= s.prob:
                # rolled under the lock: the RNG stream is a function
                # of the arrival sequence
                continue
            hit = s
            break
        if hit is not None:
            hit.fired_count += 1
            _fired.append(repr(hit))
        if all(s.exhausted for s in _specs):
            _active = False
        return hit


def _raise(spec: FaultSpec, point: str, **info):
    from .. import telemetry
    telemetry.record_event("fault_injected", point=point,
                           spec=repr(spec), **info)
    telemetry.counter(
        "mxtpu_faults_injected_total",
        "faults fired by the MXTPU_FAULT_INJECT plan").inc()
    raise FaultError(f"injected fault at {point!r} ({spec!r})")


def maybe_fire(point: str, **info):
    """Raise :class:`FaultError` when a spec for ``point`` is due."""
    if not _active:
        return
    spec = _check(point)
    if spec is not None:
        _raise(spec, point, **info)


def on_dispatch(op: str):
    """The pre-launch hook of a dispatch: the ``dispatch`` point.
    Nothing has run yet, so the caller may retry."""
    if not _active:
        return
    spec = _check("dispatch")
    if spec is not None:
        _raise(spec, "dispatch", op=op)


def after_launch(op: str):
    """The post-launch hook of a dispatch: the ``dispatch_post`` point.
    The dispatch already wrote its state in place (a CUDA graph's KV
    pages), so a fault here leaves that state unusable: the caller's
    poison protocol must engage."""
    if not _active:
        return
    spec = _check("dispatch_post")
    if spec is not None:
        _raise(spec, "dispatch_post", op=op)


# arm from the environment at import: a fault plan is a process-level
# choice, and reading it here keeps the hooks free of env lookups
configure_from_env()
