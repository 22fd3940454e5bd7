"""Captured steps: a training step or an inference dispatch replayed
as one CUDA graph a call.

:class:`StepCapture` runs a step *body* — a function of tensors that
returns a tuple of tensors (forward, loss, backward and the optimizer
update of one training step; a serving prefill or decode that writes its
KV pages in place; a whole generation) — as the reference's compiled
programs run one XLA program a call:

* **On the CPU** the body runs as it is: there is no graph.
* **On a CUDA device** the first ``WARMUP`` calls of each *signature*
  (the inputs' shapes, dtypes and device) run the body eagerly on a side
  stream, so every lazy allocation (optimizer states, gradient buffers,
  cuBLAS workspaces, built kernels) happens outside a capture.  The next
  call copies its inputs into static buffers kept for the signature and
  captures the body with ``torch.cuda.graph`` into a private memory pool
  (which holds the step's activations and gradients); the capture runs
  nothing, so that step is then replayed once.  Every later call copies
  its inputs into the static buffers and replays the graph: one launch
  from the host a step.  The outputs are the graph's own buffers, which
  the next replay overwrites.
* **Per-step values are not baked in.**  The caller writes them into
  device tensors before each call (``optimizer.DeviceScalars``); host
  values that the kernels take as arguments (momentum, betas, the AMP
  type, ...) form the caller's ``static_key``, and a signature whose key
  changed is captured again (never replayed with the old values).
* **Random draws advance.**  The ``mx.random`` generator of the device
  (dropout's, the serving sampler's), or the generator the caller
  passes, is registered with the graph
  (``CUDAGraph.register_generator_state``), so every replay draws new
  numbers from its stream, and a ``manual_seed`` on it before a replay
  gives that seed's numbers again.  Reseeding ``mx.random`` (a new
  generator) captures again.
* **One capture a variant.**  A signature keeps one graph; a body that
  comes in several variants of equal input shapes (a bucket's prefill,
  its one-step and its K-step decode) needs one ``StepCapture`` each,
  or every alternation captures again.
* **Launch counts stay true.**  A kernel wrapper counts its launches in
  Python, which a replay does not run.  The counts a capture added are
  taken back and added again at each replay, so every count reads the
  launches the card ran: the captured ones times the replays.
* **A failed capture raises** ``MXNetError``; nothing falls back to the
  eager step quietly.  The garbage collector is off during a capture:
  a dead owner's graph collected then would be destroyed inside the
  capture, which CUDA refuses.
* **Recorded calls** (``run(..., params=...)``, a hybridized block's
  call inside ``autograd.record()``) capture two graphs into one pool:
  the forward, with the tensors autograd saves, and the backward, the
  gradients of the outputs with respect to every input and parameter
  that requires one, from static gradient buffers.  The call returns
  copies of the outputs through a ``torch.autograd.Function`` whose
  forward replays the first graph and whose backward replays the second
  and returns copies of the gradients, so no later call overwrites what
  a caller holds.  One recorded call's activations live in the pool at a
  time: a second call made while the first one's outputs still wait for
  their backward runs eagerly, and a backward whose activations a later
  call overwrote raises.
* :func:`in_body` is true while a body runs in this thread (eagerly, or
  being captured), so a hybridized block called inside another capture
  runs inline instead of starting a capture of its own.

``captures``, ``replays`` (of recorded calls: ``backward_replays``
too) and ``pool_bytes`` (device memory the capture reserved, summed over
the live graphs) say what happened.
"""
from __future__ import annotations

import contextlib
import gc
import threading
import weakref
from typing import Callable, Dict, Sequence, Tuple

import torch

from .base import MXNetError

__all__ = ["StepCapture", "in_body"]

#: eager warm-up calls of a signature before it is captured
WARMUP = 1

# every kernel launch count a replay must credit: module -> counters
_COUNTERS = {
    "flash_attention": ("flash_fwd_launches", "flash_bwd_launches",
                        "flash_bwd_dq_launches", "flash_bwd_dkv_launches",
                        "flash_fwd_tc_launches", "flash_bwd_dq_tc_launches",
                        "flash_bwd_dkv_tc_launches"),
    "rtc": ("rtc_launches",),
}


def _counter_modules():
    from . import rtc
    from .ops import flash_attention
    return {"flash_attention": flash_attention, "rtc": rtc}


def _launch_counts() -> Dict[Tuple[str, str], int]:
    """{(module, counter): launches} of every kernel wrapper."""
    mods = _counter_modules()
    return {(m, n): getattr(mods[m], n) for m, names in _COUNTERS.items()
            for n in names}


def _add_counts(deltas):
    mods = _counter_modules()
    for (m, n), d in deltas.items():
        setattr(mods[m], n, getattr(mods[m], n) + d)


_tls = threading.local()


def in_body() -> bool:
    """Whether a step body runs in this thread now (see the module
    docstring)."""
    return getattr(_tls, "depth", 0) > 0


@contextlib.contextmanager
def _body_scope():
    _tls.depth = getattr(_tls, "depth", 0) + 1
    try:
        yield
    finally:
        _tls.depth -= 1


class _Graph:
    """One captured signature; ``bwd`` and what follows only for a
    recorded call."""

    __slots__ = ("graph", "inputs", "outputs", "static_key", "generator",
                 "credit", "pool_bytes", "bwd", "bwd_credit",
                 "grad_outputs", "grads", "version", "pending")

    def reset(self):
        self.graph.reset()
        if self.bwd is not None:
            self.bwd.reset()

    def busy(self) -> bool:
        """An earlier recorded call's outputs still wait for their
        backward, which reads the activations in the pool."""
        return self.pending is not None and self.pending() is not None


class _Pending:
    """Lives as long as a recorded call's autograd node."""


class _Replayed(torch.autograd.Function):
    """A recorded call: the forward graph's replay, and the backward
    graph's at ``backward``."""

    @staticmethod
    def forward(ctx, cap, g, *tensors):
        for dst, src in zip(g.inputs, tensors):
            dst.copy_(src)
        _add_counts(g.credit)
        g.graph.replay()
        cap.replays += 1
        g.version += 1
        ctx.cap, ctx.g, ctx.version = cap, g, g.version
        ctx.token = _Pending()
        g.pending = weakref.ref(ctx.token)
        outs = tuple(o.detach().clone() for o in g.outputs)
        ctx.mark_non_differentiable(*[o for o, s in zip(outs, g.outputs)
                                      if not s.requires_grad])
        return outs

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, *grads):
        g = ctx.g
        if ctx.version != g.version:
            raise MXNetError(
                "the activations of a captured call were overwritten by a "
                "later call of the same block before this backward; run "
                "backward before calling the block again")
        for buf, grad in zip(g.grad_outputs, grads):
            if buf is not None:
                buf.copy_(grad)
        if g.bwd is not None:
            _add_counts(g.bwd_credit)
            g.bwd.replay()
            ctx.cap.backward_replays += 1
        g.pending = None
        return (None, None) + tuple(None if t is None else t.clone()
                                    for t in g.grads)


class StepCapture:
    """Runs step bodies as CUDA-graph replays (see the module
    docstring).  ``name`` appears in errors."""

    def __init__(self, name: str):
        self.name = name
        self.captures = 0
        self.replays = 0
        self.backward_replays = 0
        self._graphs: Dict[tuple, _Graph] = {}
        self._warmed: Dict[tuple, int] = {}
        self._streams: Dict[torch.device, torch.cuda.Stream] = {}

    @property
    def pool_bytes(self) -> int:
        return sum(g.pool_bytes for g in self._graphs.values())

    def run(self, body: Callable, tensors: Sequence[torch.Tensor],
            static_key=(), generator: torch.Generator = None,
            params: Sequence[torch.Tensor] = None) -> tuple:
        """One step: ``body(*tensors)``, eagerly, captured or replayed
        (see the module docstring).  ``generator`` is the stream the
        body draws from (default: the device's ``mx.random`` one).  With
        ``params`` (the leaf tensors the body reads besides ``tensors``)
        the call is recorded: its outputs are differentiable with respect
        to every tensor and parameter that requires a gradient."""
        dev = tensors[0].device
        if dev.type != "cuda":
            with _body_scope():
                return body(*tensors)
        gen = generator
        if gen is None:
            from . import random as _random
            gen = _random.generator(dev)
        sig = tuple((tuple(t.shape), t.dtype, t.device,
                     params is not None and t.requires_grad)
                    for t in tensors)
        g = self._graphs.get(sig)
        if g is not None and (g.static_key != static_key
                              or g.generator is not gen):
            g.reset()
            del self._graphs[sig]
            g = None
        if g is None:
            warmed = self._warmed.get(sig, 0)
            if warmed < WARMUP:
                self._warmed[sig] = warmed + 1
                return self._eager(body, tensors)
            g = self._graphs[sig] = self._capture(body, tensors, static_key,
                                                  gen, params)
        elif params is not None and g.busy():
            return self._eager(body, tensors)
        if params is not None:
            return _Replayed.apply(self, g, *tensors, *params)
        with torch.no_grad():
            for dst, src in zip(g.inputs, tensors):
                dst.copy_(src)
        _add_counts(g.credit)
        g.graph.replay()
        self.replays += 1
        return g.outputs

    def _stream(self, dev):
        s = self._streams.get(dev)
        if s is None:
            s = self._streams[dev] = torch.cuda.Stream(dev)
        return s

    def _eager(self, body, tensors):
        """A warm-up call: the body on the side stream the capture uses."""
        main = torch.cuda.current_stream(tensors[0].device)
        side = self._stream(tensors[0].device)
        side.wait_stream(main)
        with torch.cuda.stream(side), _body_scope():
            out = body(*tensors)
        main.wait_stream(side)
        return out

    def _capture(self, body, tensors, static_key, gen, params=None):
        dev = tensors[0].device
        stream = self._stream(dev)
        with torch.no_grad():
            inputs = [t.detach().clone().requires_grad_(t.requires_grad)
                      for t in tensors]
        g = _Graph()
        g.graph, g.inputs, g.bwd, g.grads = torch.cuda.CUDAGraph(), inputs, \
            None, ()
        g.graph.register_generator_state(gen)
        g.static_key, g.generator, g.version, g.pending = static_key, gen, \
            0, None
        before = _launch_counts()
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(dev)
        # no garbage collection while capturing: collecting a dead
        # owner's graph destroys it, which is illegal during a capture
        # and invalidates this one
        gc_on = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(g.graph, stream=stream), _body_scope():
                g.outputs = tuple(body(*inputs))
            mid = _launch_counts()
            if params is not None:
                self._capture_backward(g, list(params), stream)
        except Exception as e:
            now = _launch_counts()
            _add_counts({k: v - now[k] for k, v in before.items()})
            raise MXNetError(f"{self.name}: the step could not be captured "
                             f"as a CUDA graph: {e}") from e
        finally:
            if gc_on:
                gc.enable()
        after = _launch_counts()
        g.credit = {k: mid[k] - before[k] for k in mid
                    if mid[k] != before[k]}
        g.bwd_credit = {k: after[k] - mid[k] for k in after
                        if after[k] != mid[k]}
        g.pool_bytes = torch.cuda.memory_reserved(dev) - reserved
        # the capture ran no kernel: its counts come back with the replay
        _add_counts({k: before[k] - after[k] for k in after})
        self.captures += 1
        return g

    @staticmethod
    def _capture_backward(g, params, stream):
        """The backward graph of a recorded call, into the forward's
        pool: the gradients of the outputs that require one, from static
        gradient buffers, with respect to every input and parameter that
        requires one."""
        g.grad_outputs = tuple(torch.empty_like(o) if o.requires_grad
                               else None for o in g.outputs)
        surface = list(g.inputs) + params
        wrt = [t for t in surface if t.requires_grad]
        heads = [o for o in g.outputs if o.requires_grad]
        grads = iter(())
        if heads and wrt:
            g.bwd = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g.bwd, pool=g.graph.pool(),
                                  stream=stream):
                grads = iter(torch.autograd.grad(
                    heads, wrt, [b for b in g.grad_outputs if b is not None],
                    allow_unused=True))
        g.grads = tuple(next(grads) if t.requires_grad and heads else None
                        for t in surface)
