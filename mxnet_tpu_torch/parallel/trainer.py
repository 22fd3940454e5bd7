"""``DataParallelTrainer``: the one-device dense path of the JAX
package's ``parallel/trainer.py``.

``step(data, label)`` runs the forward, the loss (the mean of
``loss_fn(block(*data), label)``), the backward (``torch.autograd.grad``
of the loss, never accumulated in ``.grad``) and the optimizer's update
of every trainable parameter, and returns the loss.  The optimizer is
one of the reference's ``_FUSED_RULES``: ``"adam"`` or ``"sgd"`` (with
or without momentum), each one multi-tensor update over every
parameter; NAG, RMSProp, AdamW and AdaGrad are the reference's other
fused rules, each the optimizer's own update over every parameter.  A
block with deferred parameter shapes gets them from one
predict-mode call on the first batch, without recording, as the
reference's ``_setup`` does.  Updates the forward makes in place
(BatchNorm's running statistics, in training mode) happen inside the
step, so the next step and a later call of the block read them.  Given
NDArrays (as ``bench.py`` feeds it), the block and ``loss_fn`` see
NDArrays, recorded as inside ``autograd.record()``, and the loss comes
back as an NDArray on the mesh's context; given tensors or numpy arrays,
they see tensors and the loss is a 0-d tensor.

``fuse_step=True`` makes the step one CUDA-graph replay on the card
(``_capture.StepCapture``): the first step of each input signature runs
eagerly, the next is captured, and every later one replays the graph;
Adam's per-step scalars (the bias-corrected learning rate, ``wd``,
``rescale_grad``) go in through device tensors, so a replay computes
exactly the step an eager call would; the other optimizers' learning
rate, ``wd`` and ``rescale_grad`` likewise.  ``step_multi`` runs K such steps over
(K, B, ...) batches, or over one batch with ``repeat=K``, and returns the
K losses.  ``fuse_step=False`` runs every step eagerly.  On the CPU both
run the same step body eagerly.  A hybridized block runs inline inside
the step (``gluon/block.py``).  Not ported: meshes of more than one
device, gradient compression and sharding plans.  The reference's
RMSProp rule runs the plain update whatever ``centered`` says; the
port's runs the optimizer's own (ROADMAP queue 3, R2).
"""
from __future__ import annotations

import functools
from typing import Callable, NamedTuple

import torch
from torch.nn.parameter import UninitializedParameter

from .. import autograd
from .. import optimizer as opt
from .._capture import StepCapture
from ..base import MXNetError
from ..ndarray.ndarray import NDArray, _ctx_of
from .mesh import make_mesh

__all__ = ["DataParallelTrainer"]


class _Rule(NamedTuple):
    """How a fused step creates an optimizer's states, stages its
    per-step scalars for step ``t`` and updates every parameter."""
    states: Callable
    stage: Callable
    apply: Callable
    static_key: Callable


def _per_tensor_rule():
    """The rule of an optimizer whose update is one op a parameter
    (``optimizer._PerTensor``)."""
    return _Rule(
        lambda o, params: [o.create_tensor_state(p) for p in params],
        lambda o, device, t: o.stage(device, t),
        lambda o, params, grads, states, scalars: o.apply_tensors(
            params, list(grads), states, scalars),
        lambda o: o.static_key(()))


# the reference's _FUSED_RULES (parallel/trainer.py:90-135)
_FUSED_RULES = {
    "Adam": _Rule(
        lambda o, params: [(torch.zeros_like(p), torch.zeros_like(p))
                           for p in params],
        lambda o, device, t: o.stage(device, t),
        lambda o, params, grads, states, scalars: o.apply_tensors(
            params, list(grads), states, scalars),
        lambda o: o.static_key(())),
    "SGD": _Rule(
        lambda o, params: [torch.zeros_like(p) if o.momentum else None
                           for p in params],
        lambda o, device, t: o.stage(device),
        lambda o, params, grads, states, scalars: o.apply_tensors(
            params, list(grads), states, scalars),
        lambda o: o.static_key(())),
    "NAG": _per_tensor_rule(),
    "RMSProp": _per_tensor_rule(),
    "AdamW": _per_tensor_rule(),
    "AdaGrad": _per_tensor_rule(),
}


def _device_of(block):
    """The device of the block's parameters (a deferred one's is the
    device ``initialize`` named)."""
    for p in block.parameters():
        if not isinstance(p, UninitializedParameter):
            return p.device
        deferred = getattr(p, "mx_deferred", None)
        if deferred is not None:
            return torch.device(deferred[1])
    raise MXNetError("the block has no initialized parameters")


class DataParallelTrainer:
    """Trains ``block`` (initialized) on a one-device mesh.

    Args:
      block: the model, an ``nn.Module`` with its parameters on the
        mesh's device.
      loss_fn: ``(outputs, label) -> loss``; the step takes its mean.
      optimizer: the optimizer's name: ``"adam"``, ``"sgd"``, ``"nag"``,
        ``"rmsprop"``, ``"adamw"`` or ``"adagrad"``.
      optimizer_params: its keyword arguments.
      mesh: ``make_mesh({"dp": 1}, devices=[...])``; default: the mesh
        of the block's device.
      fuse_step: the step as one captured graph (see the module
        docstring); required by ``step_multi``.
    """

    def __init__(self, block, loss_fn: Callable, optimizer: str,
                 optimizer_params=None, mesh=None, fuse_step: bool = False):
        self.block = block
        self.loss_fn = loss_fn
        self.optimizer = opt.create(optimizer, **(optimizer_params or {}))
        self._rule = _FUSED_RULES.get(type(self.optimizer).__name__)
        if self._rule is None:
            raise MXNetError(f"optimizer {optimizer!r} has no fused rule "
                             "(the reference's two-phase step for it is "
                             "not ported); DataParallelTrainer has "
                             f"{sorted(r.lower() for r in _FUSED_RULES)}")
        if mesh is None:
            mesh = make_mesh({"dp": 1}, devices=[_device_of(block)])
        if "dp" not in mesh.shape:
            raise MXNetError(f"the mesh {mesh} has no 'dp' axis")
        self.mesh = mesh
        self._params = None
        self.num_update = 0
        self._fuse = bool(fuse_step)
        self._capture = StepCapture("DataParallelTrainer.step")
        self._scalars = None
        if not any(isinstance(p, UninitializedParameter)
                   for p in block.parameters()):
            self._setup()

    def _setup(self):
        """The trainable parameters and the optimizer's states, once
        every parameter shape is known."""
        self._params = [p for p in self.block.parameters()
                        if p.requires_grad]
        if not self._params:
            raise MXNetError("the block has no trainable parameters")
        dev = self.mesh.device
        for p in self._params:
            if p.device != dev:
                raise MXNetError(f"a parameter is on {p.device}, the mesh "
                                 f"on {dev}: initialize the block on the "
                                 "mesh's device")
        self._states = self._rule.states(self.optimizer, self._params)

    def _resolve_shapes(self, data):
        """One predict-mode call without recording, so that every
        deferred parameter shape is known (the reference's ``_setup``)."""
        with autograd.pause(), torch.no_grad():
            self.block(*[None if x is None else NDArray(x)
                         for x in data])
        self._setup()

    @property
    def captures(self):
        """Graphs captured (one a signature, again after a static
        attribute changed)."""
        return self._capture.captures

    @property
    def replays(self):
        """Steps run as a graph replay."""
        return self._capture.replays

    @property
    def pool_bytes(self):
        """Device memory the live graphs reserved."""
        return self._capture.pool_bytes

    def _put(self, x):
        if x is None:
            return None
        if isinstance(x, NDArray):
            x = x.tensor
        return torch.as_tensor(x, device=self.mesh.device)

    def _inputs(self, data, label):
        if not isinstance(data, (tuple, list)):
            data = (data,)
        nd_in = any(isinstance(x, NDArray) for x in (*data, label))
        return [self._put(x) for x in data], self._put(label), nd_in

    def _out(self, loss, nd_in):
        return NDArray(loss, ctx=_ctx_of(loss.device)) if nd_in else loss

    def _body(self, nd_in, given, *tensors):
        """One step on ``tensors`` (the data inputs that are not None, as
        ``given`` marks them, then the label): what a graph captures.
        The update reads the scalars staged in ``_run``."""
        it = iter(tensors)
        data = [next(it) if g else None for g in given]
        label = next(it)
        if nd_in:
            ctx = _ctx_of(label.device)
            with autograd.record():
                loss = self.loss_fn(
                    self.block(*[None if t is None else
                                 NDArray(t.detach(), ctx=ctx)
                                 for t in data]),
                    NDArray(label.detach(), ctx=ctx))
        else:
            with torch.enable_grad():
                loss = self.loss_fn(self.block(*data), label)
        with torch.enable_grad():
            loss = (loss.tensor if isinstance(loss, NDArray)
                    else loss).mean()
            grads = torch.autograd.grad(loss, self._params,
                                        allow_unused=True,
                                        materialize_grads=True)
        self._rule.apply(self.optimizer, self._params, grads, self._states,
                         self._scalars)
        return (loss.detach(),)

    def _run(self, data, label, nd_in):
        """Stage step ``num_update + 1``'s scalars and run the step
        (captured or replayed with ``fuse_step``); returns the loss."""
        from ..contrib import amp
        if self._params is None:
            self._resolve_shapes(data)
        t = self.num_update + 1
        self._scalars = self._rule.stage(self.optimizer, self.mesh.device, t)
        given = tuple(x is not None for x in data)
        tensors = [x for x in data if x is not None] + [label]
        body = functools.partial(self._body, nd_in, given)
        was_training = self.block.training
        self.block.train()
        try:
            if self._fuse:
                (loss,) = self._capture.run(
                    body, tensors, (nd_in, given,
                                    self._rule.static_key(self.optimizer),
                                    amp.target_dtype()))
            else:
                (loss,) = body(*tensors)
        finally:
            self.block.train(was_training)
        self.num_update = t
        return loss

    def step(self, data, label):
        """One training step on the batch; returns the loss (0-d, on the
        device, not synchronised): an NDArray when NDArrays came in."""
        data, label, nd_in = self._inputs(data, label)
        loss = self._run(data, label, nd_in)
        # a replay's output is the graph's buffer, which the next
        # replay overwrites
        return self._out(loss.clone() if self._fuse else loss, nd_in)

    def step_multi(self, data, label, repeat=None):
        """K steps: over (K, B, ...) ``data`` and (K, B, ...) ``label``,
        or over one batch ``repeat=K`` times.  Returns the (K,) losses;
        the result is that of K ``step()`` calls.  Requires
        ``fuse_step=True``."""
        if not self._fuse:
            raise MXNetError("step_multi requires fuse_step=True")
        data, label, nd_in = self._inputs(data, label)
        if repeat is not None:
            k = int(repeat)
            if k <= 0:
                raise MXNetError(f"step_multi: repeat must be positive, "
                                 f"got {repeat}")
            batches = [(data, label)] * k
        else:
            k = label.shape[0]
            if any(x is not None and x.shape[0] != k for x in data):
                raise MXNetError(
                    f"step_multi: the leading dims of data "
                    f"{[None if x is None else tuple(x.shape) for x in data]}"
                    f" and label {tuple(label.shape)} must all be K")
            batches = [([None if x is None else x[i] for x in data],
                        label[i]) for i in range(k)]
        losses = None
        for i, (d, l) in enumerate(batches):
            loss = self._run(d, l, nd_in)
            if losses is None:
                losses = loss.new_empty((k,) + tuple(loss.shape))
            losses[i].copy_(loss)
        return self._out(losses, nd_in)
