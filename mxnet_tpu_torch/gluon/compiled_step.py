"""``CompiledStep``: the whole gluon training step as one CUDA-graph
replay, as the JAX package's ``gluon/compiled_step.py`` makes it one XLA
dispatch.

``trainer.compile_step(net, loss_fn)`` builds it.  ``step(data, label,
batch_size=None)`` runs ``loss_fn(net(*data), label)`` as inside
``autograd.record()``, its backward (the gradient of the loss's sum, as
``loss.backward()``, written into each parameter's gradient buffer in
place) and the trainer's update with ``rescale_grad = 1 / batch_size``,
and returns the per-sample loss as an NDArray.  ``batch_size`` defaults
to the label's leading dimension.  ``step_multi`` runs K steps over
(K, B, ...) batches or one batch ``repeat=K`` times and returns the
(K, B) losses, those of K ``step()`` calls.

On the card the step body is captured by ``_capture.StepCapture``: one
eager warm-up step a signature, then one graph replay a step.  The
learning rate, ``wd`` and ``rescale_grad`` are the optimizer's device
scalars, so ``set_learning_rate`` and a new ``batch_size`` change the
result and capture nothing new; the attributes baked into the kernels
(momentum, clipping, each parameter's multipliers) are the capture's
static key, and a change captures once more.  On the CPU the same body
runs eagerly.

Paths: ``MXTPU_COMPILED_STEP=0`` runs the eager record -> backward ->
``Trainer.step`` loop (asked for, so not reported).  A step the body
cannot run (an optimizer without a graph-safe update, ``grad_req='add'``,
no trainable parameter) runs that loop too, and the reason is recorded
in :func:`fallback_reports`.  A step that is eligible and fails to
capture raises.  ``last_path`` is ``"compiled"`` (the step body: a
capture or replay on the card, the body itself on the CPU) or
``"eager"``.

Not ported: ``save_signature``, ``warm_start``, ``recover`` and the
elastic hooks (each raises ``NotImplementedError``).
"""
from __future__ import annotations

import functools
import itertools
import threading
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from .. import autograd, envs
from .._capture import StepCapture
from ..base import MXNetError
from ..ndarray.ndarray import NDArray

__all__ = ["CompiledStep", "fallback_reports", "clear_fallback_reports"]

_fallback_log: List[Tuple[str, str]] = []
_fallback_lock = threading.Lock()


def fallback_reports() -> List[Tuple[str, str]]:
    """``[(step name, reason), ...]`` of every ``CompiledStep`` that ran
    the eager loop because it could not run its step body.  The
    ``MXTPU_COMPILED_STEP=0`` escape hatch is not recorded: the user
    asked for the eager loop."""
    with _fallback_lock:
        return list(_fallback_log)


def clear_fallback_reports():
    with _fallback_lock:
        _fallback_log.clear()


class CompiledStep:
    """The training step of ``(net, loss_fn, trainer)`` as one captured
    graph (see the module docstring)."""

    _uid = itertools.count(1)

    def __init__(self, net, loss_fn: Callable, trainer):
        self.net = net
        self.loss_fn = loss_fn
        self.trainer = trainer
        self.name = f"gluon_train_step_{net.name}_{next(CompiledStep._uid)}"
        self.fallback_reason: Optional[str] = None
        self.last_path: Optional[str] = None
        self._params = list(trainer._params)
        self._tr_idx = [i for i, p in enumerate(self._params)
                        if p.grad_req != "null"]
        self._capture = StepCapture(self.name)
        self._ready = False

    @property
    def captures(self):
        return self._capture.captures

    @property
    def replays(self):
        return self._capture.replays

    @property
    def pool_bytes(self):
        return self._capture.pool_bytes

    # -- public API -----------------------------------------------------------
    def step(self, data, label, batch_size=None):
        """One training step; returns the per-sample loss NDArray."""
        args, label = self._coerce(data, label)
        if batch_size is None:
            batch_size = label.shape[0] if label.shape else args[0].shape[0]
        return self._step(args, label, batch_size)

    def step_multi(self, data, label, batch_size=None, repeat=None):
        """K steps over (K, B, ...) ``data`` and ``label``, or over one
        batch ``repeat=K`` times; returns the (K, B) losses."""
        args, label = self._coerce(data, label)
        if repeat is not None:
            k = int(repeat)
            if k <= 0:
                raise MXNetError(f"repeat must be positive, got {repeat}")
            batches = [(args, label)] * k
        else:
            k = args[0].shape[0]
            if label.shape[0] != k:
                raise MXNetError(
                    f"step_multi: label leading dim {label.shape[0]} != "
                    f"data leading dim {k}")
            batches = [([a[i] for a in args], label[i]) for i in range(k)]
        if batch_size is None:
            a0, l0 = batches[0]
            batch_size = l0.shape[0] if l0.shape else (
                a0[0].shape[0] if a0[0].shape else 1)
        losses = [self._step(a, l, batch_size).tensor for a, l in batches]
        return NDArray(torch.stack([t.detach() for t in losses]),
                       ctx=label.context)

    def save_signature(self, path):
        raise NotImplementedError("CompiledStep.save_signature is not "
                                  "ported")

    def warm_start(self, path):
        raise NotImplementedError("CompiledStep.warm_start is not ported")

    def recover(self, manager, step=None):
        raise NotImplementedError("CompiledStep.recover is not ported")

    # -- paths ----------------------------------------------------------------
    def _coerce(self, data, label):
        from .. import ndarray as nd
        ctx = self._params[0].list_ctx()[0] if self._params else None

        def arr(a):
            if isinstance(a, NDArray):
                return a.as_in_context(ctx)
            a = np.asarray(a)
            return nd.array(a, ctx=ctx, dtype=a.dtype)
        args = list(data) if isinstance(data, (list, tuple)) else [data]
        return [arr(a) for a in args], arr(label)

    def _step(self, args, label, batch_size):
        if not envs.get("MXTPU_COMPILED_STEP"):
            return self._eager(args, label, batch_size)
        if self.fallback_reason is None:
            reason = self._eligibility()
            if reason is not None:
                self.fallback_reason = reason
                with _fallback_lock:
                    _fallback_log.append((self.name, reason))
        if self.fallback_reason is not None:
            return self._eager(args, label, batch_size)
        return self._compiled(args, label, batch_size)

    def _eligibility(self) -> Optional[str]:
        """None when the step body can run, else why not."""
        opt = self.trainer._optimizer
        if not opt.capturable:
            return (f"optimizer {type(opt).__name__} has no graph-safe "
                    "update (per-step scalars on the device)")
        if any(p.grad_req == "add" for p in self._params):
            return ("grad_req='add': gradient accumulation across "
                    "backwards has no one-step equivalent")
        if not self._tr_idx:
            return "no trainable parameters"
        return None

    def _eager(self, args, label, batch_size):
        self.last_path = "eager"
        with autograd.record():
            loss = self.loss_fn(self.net(*args), label)
        autograd.backward([loss])
        self.trainer.step(batch_size)
        return loss

    def _setup(self):
        """Optimizer states and gradient buffers, made before any step
        body runs (a captured backward writes into the buffers)."""
        updater = self.trainer._updater
        for i in self._tr_idx:
            p = self._params[i]
            updater._ensure_state(i, p.data())
            p.grad()
        self._ready = True

    def _body(self, n_args, *tensors):
        """One step on ``tensors`` (the inputs, then the label): what a
        graph captures.  The optimizer reads the scalars staged in
        ``_compiled``, the global-norm clip its staged ``rescale_grad``."""
        ctx = self._params[0].list_ctx()[0]
        args = [NDArray(t.detach(), ctx=ctx) for t in tensors[:n_args]]
        label = NDArray(tensors[n_args].detach(), ctx=ctx)
        with autograd.record():
            loss = self.loss_fn(self.net(*args), label)
        autograd.backward([loss])
        states = self.trainer._updater.states
        opt = self.trainer._optimizer
        grads = [self._params[i].grad() for i in self._tr_idx]
        opt.clip_global_grads(grads, opt._scalars.view(
            label.tensor.device, "rescale_grad"))
        opt.apply_multi(
            self._tr_idx, [self._params[i].data() for i in self._tr_idx],
            grads, [states[i] for i in self._tr_idx])
        return (loss.tensor.detach(),)

    def _compiled(self, args, label, batch_size):
        from ..contrib import amp
        if not self._ready:
            self._setup()
        tr = self.trainer
        opt = tr._optimizer
        opt.rescale_grad = tr._scale / batch_size
        # the counts first: Adam's bias correction reads this step's
        for i in self._tr_idx:
            opt._update_count(i)
        opt.stage(label.tensor.device)
        tensors = [a.tensor for a in args] + [label.tensor]
        (loss,) = self._capture.run(
            functools.partial(self._body, len(args)), tensors,
            (len(args), opt.static_key(self._tr_idx), amp.target_dtype()))
        self.last_path = "compiled"
        # a replay's output is the graph's buffer, which the next
        # replay overwrites
        return NDArray(loss.clone(), ctx=label.context)
