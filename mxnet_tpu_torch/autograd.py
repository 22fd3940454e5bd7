"""Imperative autograd: record / pause scopes, backward, grad, Function.

As the JAX package's ``autograd.py``, on PyTorch's autograd:

* ``record()`` turns recording (and training mode) on for the thread.
  Ops record only inside it: ``invoke`` runs them under
  ``torch.enable_grad()`` there and under ``torch.no_grad()`` elsewhere.
* A leaf is an NDArray with a gradient buffer (``attach_grad``,
  ``mark_variables``, a gluon ``Parameter``), held in a weak registry.
  ``backward`` asks ``torch.autograd.grad`` for the gradient of every
  live leaf (``allow_unused``: a leaf the heads do not reach gets none)
  and writes each one into the leaf's buffer in place: ``"write"``
  overwrites it, ``"add"`` adds to it, ``"null"`` skips it.  A buffer that
  a caller already holds sees the new values; a gluon parameter without
  one yet gets the gradient as its buffer.
* Any other array an op reads while recording becomes a leaf that
  ``grad`` can differentiate against (the JAX package records every op).
  PyTorch computes only the gradients that are asked for.
* ``Function`` is a ``torch.autograd.Function`` underneath.
"""
from __future__ import annotations

import threading
import weakref
from typing import Optional

import torch

from .base import MXNetError

__all__ = ["record", "pause", "train_mode", "predict_mode", "is_recording",
           "is_training", "mark_variables", "backward", "grad",
           "set_recording", "set_training", "Function"]

_state = threading.local()


def is_recording() -> bool:
    return getattr(_state, "recording", False)


def is_training() -> bool:
    return getattr(_state, "training", False)


def set_recording(is_recording: bool) -> bool:
    prev = getattr(_state, "recording", False)
    _state.recording = bool(is_recording)
    return prev


def set_training(train_mode: bool) -> bool:
    prev = getattr(_state, "training", False)
    _state.training = bool(train_mode)
    return prev


class _Scope:
    def __init__(self, recording: Optional[bool], training: Optional[bool]):
        self._recording = recording
        self._training = training

    def __enter__(self):
        if self._recording is not None:
            self._prev_rec = set_recording(self._recording)
        if self._training is not None:
            self._prev_trn = set_training(self._training)
        return self

    def __exit__(self, *exc):
        if self._recording is not None:
            set_recording(self._prev_rec)
        if self._training is not None:
            set_training(self._prev_trn)


def record(train_mode: bool = True) -> _Scope:
    """``with autograd.record():`` — turn on recording (and train mode)."""
    return _Scope(True, train_mode)


def pause(train_mode: bool = False) -> _Scope:
    return _Scope(False, train_mode)


def train_mode() -> _Scope:
    return _Scope(None, True)


def predict_mode() -> _Scope:
    return _Scope(None, False)


# ---------------------------------------------------------------------------
# leaves
# ---------------------------------------------------------------------------


def _leaf_tensor(t: torch.Tensor) -> torch.Tensor:
    """``t`` as a leaf that can require a gradient: ``t`` itself when it
    is one, else a detached alias of its storage."""
    return t if t.grad_fn is None else t.detach()


# id(NDArray) -> NDArray of every live leaf; ``backward`` looks here
# rather than at the graph's nodes, whose Python surface differs between
# PyTorch releases
_leaves = weakref.WeakValueDictionary()


def _make_leaf(arr):
    """Make the NDArray ``arr`` a leaf of the graph that ``backward``
    writes gradients for."""
    t = _leaf_tensor(arr._t)
    if arr.grad_req != "null" and t.is_floating_point():
        t.requires_grad_(True)
    arr._t = t
    _leaves[id(arr)] = arr


def _mark_inputs(tensors):
    """While recording, let every floating-point leaf an op reads take a
    gradient (so ``grad`` can ask for it; nothing is computed unless
    asked)."""
    for t in tensors:
        if not t.requires_grad and t.grad_fn is None \
                and t.is_floating_point():
            t.requires_grad_(True)


def _head_tensors(heads, head_grads):
    from .ndarray.ndarray import NDArray
    hs = [h._t for h in heads]
    gs = []
    for h, g in zip(hs, head_grads):
        if g is None:
            gs.append(torch.ones_like(h))
        else:
            gs.append(g._t if isinstance(g, NDArray) else
                      torch.as_tensor(g, dtype=h.dtype, device=h.device))
    for h in hs:
        if not h.requires_grad:
            raise MXNetError(
                "cannot differentiate an array that was not computed "
                "inside autograd.record() from a leaf")
    return hs, gs


def backward(heads, head_grads=None, retain_graph=False, train_mode=True):
    """Parity: ``autograd.backward(heads, head_grads)``.  Writes each
    reached leaf's gradient into its buffer per its ``grad_req``."""
    from .ndarray.ndarray import NDArray
    heads = heads if isinstance(heads, (list, tuple)) else [heads]
    if head_grads is None:
        head_grads = [None] * len(heads)
    hs, gs = _head_tensors(heads, head_grads)
    targets = [a for a in list(_leaves.values())
               if a.grad_req != "null" and a._t.requires_grad]
    if not targets:
        return
    grads = torch.autograd.grad(hs, [a._t for a in targets], gs,
                                retain_graph=retain_graph,
                                allow_unused=True)
    with torch.no_grad():
        for arr, g in zip(targets, grads):
            if g is None:
                continue
            if arr._grad is None:
                # a copy: autograd may hand one tensor to several leaves
                arr._grad = NDArray(g.clone(
                    memory_format=torch.contiguous_format), ctx=arr._ctx)
            elif arr.grad_req == "add":
                arr._grad._t.add_(g)
            else:
                arr._grad._t.copy_(g)


def grad(heads, variables, head_grads=None, retain_graph=None,
         create_graph=False, train_mode=True):
    """Parity: ``autograd.grad``: the gradients of ``heads`` with respect
    to ``variables``, returned instead of written.  With
    ``create_graph`` they are recorded, so they can be differentiated
    again."""
    from .ndarray.ndarray import NDArray
    heads = heads if isinstance(heads, (list, tuple)) else [heads]
    variables = variables if isinstance(variables, (list, tuple)) \
        else [variables]
    if head_grads is None:
        head_grads = [None] * len(heads)
    hs, gs = _head_tensors(heads, head_grads)
    retain = create_graph if retain_graph is None else retain_graph
    for v in variables:
        if not v._t.requires_grad:
            raise MXNetError("a variable of autograd.grad was not used "
                             "inside autograd.record()")
    out = torch.autograd.grad(hs, [v._t for v in variables], gs,
                              retain_graph=retain,
                              create_graph=create_graph, allow_unused=True)
    return [NDArray(g if g is not None else torch.zeros_like(v._t),
                    ctx=v._ctx) for g, v in zip(out, variables)]


def mark_variables(variables, gradients, grad_reqs="write"):
    """Make ``variables`` leaves whose gradients go into ``gradients``."""
    variables = variables if isinstance(variables, (list, tuple)) \
        else [variables]
    gradients = gradients if isinstance(gradients, (list, tuple)) \
        else [gradients]
    if isinstance(grad_reqs, str):
        grad_reqs = [grad_reqs] * len(variables)
    for v, g, r in zip(variables, gradients, grad_reqs):
        v._grad = g
        v.grad_req = r
        _make_leaf(v)


class _Bridge(torch.autograd.Function):
    """Runs an ``autograd.Function``'s NDArray forward and backward."""

    @staticmethod
    def forward(ctx, fn, *tensors):
        from .ndarray.ndarray import NDArray
        with pause():
            out = fn.forward(*[NDArray(t) for t in tensors])
        ctx.fn = fn
        fn._single = isinstance(out, NDArray)
        return tuple(o._t for o in ((out,) if fn._single else out))

    @staticmethod
    def backward(ctx, *grads):
        from .ndarray.ndarray import NDArray
        with pause():
            gs = ctx.fn.backward(*[NDArray(g) for g in grads])
        gs = gs if isinstance(gs, (list, tuple)) else [gs]
        return (None, *[g._t for g in gs])


class Function:
    """Customizable differentiable function (parity: autograd.Function).

    Subclass and implement ``forward(self, *inputs)`` and
    ``backward(self, *output_grads)`` on NDArrays.
    """

    def __init__(self):
        self._saved = None
        self._single = True

    def save_for_backward(self, *args):
        self._saved = args

    @property
    def saved_tensors(self):
        return self._saved

    def forward(self, *inputs):
        raise NotImplementedError

    def backward(self, *output_grads):
        raise NotImplementedError

    def __call__(self, *inputs):
        from .ndarray.ndarray import NDArray
        if not is_recording():
            with pause(train_mode=is_training()):
                return self.forward(*inputs)
        tensors = [i._t for i in inputs]
        _mark_inputs(tensors)
        outs = _Bridge.apply(self, *tensors)
        ctx = inputs[0].context if inputs else None
        wrapped = [NDArray(o, ctx=ctx) for o in outs]
        return wrapped[0] if self._single else wrapped
