"""Optimizers: the reference's ``Optimizer`` registry with ``SGD`` and
``Adam``, and the ``Updater`` that ``gluon.Trainer`` drives (as the JAX
package's ``optimizer/optimizer.py``).  ``DataParallelTrainer`` runs the
same two classes.

``SGD`` runs the ``sgd_update`` / ``sgd_mom_update`` ops on NDArrays with
``out=`` (in place), with ``clip_gradient`` and each gluon Parameter's
``lr_mult``/``wd_mult`` (``param_dict``).  ``update_multi`` updates a set
of parameters at once with ``torch._foreach_*`` multi-tensor operators
(the reference's ``call_fused``): the same arithmetic, a few launches for
the whole set.  Not ported: the other optimizers, multi-precision,
learning-rate schedules.

**Per-step scalars live on the device.**  ``lr``, ``wd``,
``rescale_grad`` and ``-lr * rescale_grad`` (SGD) and the bias-corrected
learning rate, ``wd`` and ``rescale_grad`` (Adam) change between steps, so an update reads them
from a float32 tensor on the weights' device (:class:`DeviceScalars`),
written before the step (one fill a value that changed) and read by the
update's kernels.  A step captured as a CUDA graph therefore replays
with each step's values, and the eager step computes the same thing.
Static attributes (momentum, betas, epsilon, clipping, the multipliers,
whether there is weight decay at all) are the kernels' own arguments:
``static_key`` lists them, and a captured step whose key changed is
captured again.

Adam is the JAX package's ``optimizer.Adam`` with the fused
``adam_update`` rule of its data-parallel trainer.

The bias correction goes on the learning rate,
``lr_t = lr * sqrt(1 - beta2^t) / (1 - beta1^t)``, and the update is

    g = clip(grad * rescale_grad, clip_gradient) + wd * w
    m = beta1 * m + (1 - beta1) * g
    v = beta2 * v + (1 - beta2) * g^2
    w = w - lr_t * m / (sqrt(v) + epsilon)

with epsilon outside the square root (``torch.optim.Adam`` places it
elsewhere).  One call updates every parameter with ``torch._foreach_*``
multi-tensor operators, in place, in passes of at most 2^28 elements
(a Llama-3-8B-wide model's optimizer would otherwise hold two more
copies of its gradients at once).
"""
from __future__ import annotations

import math
from typing import Dict

import torch

from .base import MXNetError

__all__ = ["Optimizer", "SGD", "Adam", "Updater", "DeviceScalars",
           "create", "register", "get_updater", "sgd_multi"]


class DeviceScalars:
    """Named float32 scalars of an update, one tensor on each device.

    ``write(device, values)`` fills the entries whose value changed since
    the last write (nothing in a steady state) and returns 0-d views of
    the tensor, which the update's kernels read.  Values are staged
    before a captured step: a write inside a CUDA-graph capture would
    bake one step's value into the graph, so it raises."""

    def __init__(self, names):
        self.names = tuple(names)
        self._by_device = {}

    def write(self, device, values):
        device = torch.device(device)
        entry = self._by_device.get(device)
        capturing = device.type == "cuda" and \
            torch.cuda.is_current_stream_capturing()
        values = tuple(float(v) for v in values)
        if entry is not None and entry[1] == values:
            return entry[2]
        if capturing:
            raise MXNetError(
                f"the per-step scalars {self.names} changed inside a "
                "captured step: stage them before the capture")
        if entry is None:
            t = torch.zeros(len(values), dtype=torch.float32,
                            device=device)
            entry = [t, (None,) * len(values),
                     tuple(t[i] for i in range(len(values)))]
            self._by_device[device] = entry
        _, old, views = entry
        with torch.no_grad():
            for view, v, o in zip(views, values, old):
                if v != o:
                    view.fill_(v)
        entry[1] = values
        return views


class Optimizer:
    """Base optimizer (parity: ``mx.optimizer.Optimizer``)."""

    opt_registry: Dict[str, type] = {}

    @staticmethod
    def register(klass):
        Optimizer.opt_registry[klass.__name__.lower()] = klass
        return klass

    @staticmethod
    def create_optimizer(name, **kwargs):
        key = str(name).lower()
        if key not in Optimizer.opt_registry:
            raise MXNetError(f"optimizer {name!r} is not ported; options "
                             f"{sorted(Optimizer.opt_registry)}")
        return Optimizer.opt_registry[key](**kwargs)

    def __init__(self, rescale_grad=1.0, wd=0.0, clip_gradient=None,
                 learning_rate=None, param_dict=None):
        self.rescale_grad = rescale_grad
        self.lr = learning_rate if learning_rate is not None else 0.01
        self.wd = wd
        self.clip_gradient = clip_gradient
        self.num_update = 0
        self._index_update_count = {}
        self.param_dict = param_dict if param_dict else {}
        self._scalars = DeviceScalars(("lr", "wd", "rescale_grad",
                                       "neg_lr_rescale"))

    @property
    def learning_rate(self):
        return self.lr

    @learning_rate.setter
    def learning_rate(self, lr):
        self.lr = lr

    def set_learning_rate(self, lr):
        self.lr = lr

    def _update_count(self, index):
        count = self._index_update_count.get(index, 0) + 1
        self._index_update_count[index] = count
        self.num_update = max(count, self.num_update)

    def _clip(self):
        return -1.0 if self.clip_gradient is None else float(
            self.clip_gradient)

    def create_state(self, index, weight):
        return None

    def update(self, index, weight, grad, state):
        raise NotImplementedError

    def update_multi(self, indices, weights, grads, states):
        """Update the parameters ``indices`` together; here one
        ``update`` each, in one call for an optimizer with a
        multi-tensor rule."""
        for i, w, g, s in zip(indices, weights, grads, states):
            self.update(i, w, g, s)

    @property
    def capturable(self):
        """Whether ``update`` is graph-safe: its per-step scalars come
        from :meth:`stage` and nothing of it runs on the host per step
        but the update count (``_update_count``)."""
        return False

    def stage(self, device):
        """Write this step's ``lr``, ``wd``, ``rescale_grad`` and
        ``-lr * rescale_grad`` into the device scalars of ``device``;
        returns their 0-d views."""
        lr, rescale = self.learning_rate, self.rescale_grad
        return self._scalars.write(device, (lr, self.wd, rescale,
                                            -lr * rescale))

    def static_key(self, indices):
        """The attributes baked into the update's kernels, for the
        parameters ``indices``: a captured step whose key changed is
        captured again."""
        mults = tuple((getattr(self.param_dict.get(i), "lr_mult", 1.0),
                       getattr(self.param_dict.get(i), "wd_mult", 1.0))
                      for i in indices)
        return (type(self).__name__, self._clip(), mults)


register = Optimizer.register


@register
class SGD(Optimizer):
    """SGD with momentum (parity: the reference's SGD):
    ``w -= lr * (clip(rescale_grad * g) + wd * w)``, or with momentum
    ``m = momentum * m - lr * (...)``, ``w += m``."""

    def __init__(self, momentum=0.0, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return None
        from .ndarray.ndarray import zeros
        return zeros(weight.shape, ctx=weight.context,
                     dtype=weight.dtype.name)

    @property
    def capturable(self):
        return type(self).update is SGD.update

    def static_key(self, indices):
        return super().static_key(indices) + (self.momentum, self.wd == 0)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        self.apply(index, weight, grad, state)

    def apply(self, index, weight, grad, state):
        """The device side of ``update``: lr, wd and rescale_grad come
        from the device scalars (staged now when they changed), times the
        parameter's multipliers.  Without momentum, clipping, weight
        decay or a learning-rate multiplier it is ``sgd_update``'s fused
        form, ``w += (-lr * rescale_grad) * g``: one kernel, in place."""
        from . import ndarray as nd
        from .ndarray.ndarray import NDArray
        lr, wd, rescale, neg_lr_rescale = self.stage(weight.tensor.device)
        p = self.param_dict.get(index)
        lr_mult, wd_mult = (1.0, 1.0) if p is None else (p.lr_mult,
                                                          p.wd_mult)
        if state is None and self._clip() <= 0 and self.wd == 0 \
                and lr_mult == 1.0:
            with torch.no_grad():
                weight.tensor.addcmul_(grad.tensor, neg_lr_rescale)
            return
        if lr_mult != 1.0:
            lr = lr * lr_mult
        if wd_mult != 1.0:
            wd = wd * wd_mult
        ctx = weight.context
        lr, wd, rescale = (NDArray(t, ctx=ctx) for t in (lr, wd, rescale))
        if state is not None:
            nd.sgd_mom_update(weight, grad, state, lr=lr, wd=wd,
                              momentum=self.momentum, rescale_grad=rescale,
                              clip_gradient=self._clip(),
                              out=[weight, state])
        else:
            nd.sgd_update(weight, grad, lr=lr, wd=wd, rescale_grad=rescale,
                          clip_gradient=self._clip(), out=weight)

    def update_multi(self, indices, weights, grads, states):
        if type(self).update is not SGD.update:
            return super().update_multi(indices, weights, grads, states)
        for i in indices:
            self._update_count(i)
        self.apply_multi(indices, weights, grads, states)

    def apply_multi(self, indices, weights, grads, states):
        """The device side of ``update_multi``: the parameters grouped by
        their (lr_mult, wd_mult), each group one :func:`sgd_multi`."""
        if not indices:
            return
        scalars = self.stage(weights[0].tensor.device)
        groups = {}
        for i, w, g, s in zip(indices, weights, grads, states):
            p = self.param_dict.get(i)
            mults = (1.0, 1.0) if p is None else (p.lr_mult, p.wd_mult)
            groups.setdefault(mults, []).append(
                (w.tensor, g.tensor, None if s is None else s.tensor))
        for mults, members in groups.items():
            ws, gs, ms = zip(*members)
            self.apply_tensors(list(ws), list(gs), list(ms), scalars, mults)

    def apply_tensors(self, weights, grads, moms, scalars, mults=(1.0, 1.0)):
        """:func:`sgd_multi` over tensors with the staged ``scalars``
        (``stage``'s views) times ``mults`` (lr_mult, wd_mult)."""
        lr, wd, rescale, _ = scalars
        if mults[0] != 1.0:
            lr = lr * mults[0]
        if mults[1] != 1.0:
            wd = wd * mults[1]
        sgd_multi(weights, grads, None if moms[0] is None else moms, lr,
                  wd if self.wd else None, rescale, self.momentum,
                  self._clip())


@torch.no_grad()
def sgd_multi(weights, grads, moms, lr, wd, rescale, momentum, clip):
    """SGD on lists of tensors in place, with ``torch._foreach_*``: the
    arithmetic of ``sgd_update``/``sgd_mom_update``,
    ``g = clip(rescale * grad) + wd * w``, then ``w -= lr * g`` or
    ``m = momentum * m - lr * g; w += m``.  ``lr``, ``wd`` and ``rescale``
    are 0-d device tensors (``wd`` None: no weight decay), ``moms`` None
    without momentum, ``clip`` <= 0 for none."""
    g = torch._foreach_mul(grads, rescale)
    if clip > 0:
        torch._foreach_clamp_min_(g, -clip)
        torch._foreach_clamp_max_(g, clip)
    if wd is not None:
        torch._foreach_add_(g, torch._foreach_mul(weights, wd))
    torch._foreach_mul_(g, lr)
    if moms is None:
        torch._foreach_sub_(weights, g)
        return
    torch._foreach_mul_(moms, momentum)
    torch._foreach_sub_(moms, g)
    torch._foreach_add_(weights, moms)


class Updater:
    """Applies an optimizer's update per parameter index, holding the
    states (parity: ``mx.optimizer.Updater``)."""

    def __init__(self, optimizer: Optimizer):
        self.optimizer = optimizer
        self.states = {}

    def __call__(self, index, grad, weight):
        indices = index if isinstance(index, (list, tuple)) else [index]
        grads = grad if isinstance(grad, (list, tuple)) else [grad]
        weights = weight if isinstance(weight, (list, tuple)) else [weight]
        for i, g, w in zip(indices, grads, weights):
            if i not in self.states:
                self.states[i] = self.optimizer.create_state(i, w)
            self.optimizer.update(i, w, g, self.states[i])

    def call_fused(self, indices, grads, weights):
        """Update the parameters ``indices`` together
        (``Optimizer.update_multi``), making any missing state first."""
        for i, w in zip(indices, weights):
            if i not in self.states:
                self.states[i] = self.optimizer.create_state(i, w)
        self.optimizer.update_multi(indices, weights, grads,
                                    [self.states[i] for i in indices])


def get_updater(optimizer: Optimizer) -> Updater:
    return Updater(optimizer)


@register
class Adam(Optimizer):
    """Adam (parity: the reference's ``Adam``), with the bias correction
    on the learning rate: at a parameter's ``t``-th update
    ``lr_t = lr * sqrt(1 - beta2^t) / (1 - beta1^t)`` (times its
    ``lr_mult``), then the module docstring's update.  ``update`` takes
    one parameter; ``update_multi`` (``gluon.Trainer``, ``compile_step``)
    and :meth:`apply_tensors` (``DataParallelTrainer``) update a set in
    one multi-tensor pass, the reference's ``multi_adam_update`` plan.
    ``lazy_update`` is accepted: the port has no row-sparse
    gradients."""

    def __init__(self, learning_rate=None, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, lazy_update=True, **kwargs):
        super().__init__(learning_rate=0.001 if learning_rate is None
                         else learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon
        self.lazy_update = lazy_update
        self._scalars = DeviceScalars(("lr_t", "wd", "rescale_grad"))

    def create_state(self, index, weight):
        """(mean, var), zeros like ``weight`` (an NDArray)."""
        from .ndarray.ndarray import zeros
        return (zeros(weight.shape, ctx=weight.context,
                      dtype=weight.dtype.name),
                zeros(weight.shape, ctx=weight.context,
                      dtype=weight.dtype.name))

    @property
    def capturable(self):
        return type(self).update is Adam.update

    def corrected_lr(self, t):
        """The learning rate with step ``t``'s bias correction."""
        return (self.learning_rate * math.sqrt(1.0 - self.beta2 ** t)
                / (1.0 - self.beta1 ** t))

    def stage(self, device, t=None):
        """Write step ``t``'s corrected learning rate, ``wd`` and
        ``rescale_grad`` into the device scalars of ``device`` (``t``
        defaults to ``num_update``, the step the counts are at); returns
        their 0-d views, which :meth:`apply_tensors` takes."""
        t = self.num_update if t is None else t
        return self._scalars.write(device, (self.corrected_lr(t), self.wd,
                                            self.rescale_grad))

    def static_key(self, indices=()):
        return super().static_key(indices) + (
            self.beta1, self.beta2, self.epsilon, bool(self.wd))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        self._apply_groups([index], [weight], [grad], [state],
                           self._index_update_count[index])

    def update_multi(self, indices, weights, grads, states):
        if type(self).update is not Adam.update:
            return super().update_multi(indices, weights, grads, states)
        for i in indices:
            self._update_count(i)
        counts = {self._index_update_count[i] for i in indices}
        if len(counts) == 1:
            self._apply_groups(indices, weights, grads, states,
                               counts.pop())
            return
        # parameters at different steps: one bias correction each
        for i, w, g, s in zip(indices, weights, grads, states):
            self._apply_groups([i], [w], [g], [s],
                               self._index_update_count[i])

    def apply_multi(self, indices, weights, grads, states):
        """The device side of ``update_multi``, at step ``num_update``:
        the parameters grouped by (lr_mult, wd_mult), each group one
        :meth:`apply_tensors`."""
        self._apply_groups(indices, weights, grads, states, self.num_update)

    def _apply_groups(self, indices, weights, grads, states, t):
        if not indices:
            return
        scalars = self.stage(weights[0].tensor.device, t)
        groups = {}
        for i, w, g, s in zip(indices, weights, grads, states):
            p = self.param_dict.get(i)
            mults = (1.0, 1.0) if p is None else (p.lr_mult, p.wd_mult)
            groups.setdefault(mults, []).append(
                (w.tensor, g.tensor, (s[0].tensor, s[1].tensor)))
        for mults, members in groups.items():
            ws, gs, ss = zip(*members)
            self.apply_tensors(list(ws), list(gs), list(ss), scalars,
                               mults)

    @torch.no_grad()
    def apply_tensors(self, weights, grads, states, scalars,
                      mults=(1.0, 1.0)):
        """The update of parallel lists of weight, gradient and
        (mean, var) tensors, in place, with the per-step ``scalars``
        (the views :meth:`stage` returned) times ``mults`` (lr_mult,
        wd_mult): no host value of the step enters it."""
        if not weights:
            return
        lr_t, wd, rescale = scalars
        if mults[0] != 1.0:
            lr_t = lr_t * mults[0]
        if mults[1] != 1.0:
            wd = wd * mults[1]
        for lo, hi in _spans(weights, _PASS_ELEMENTS):
            self._adam_pass(weights[lo:hi], grads[lo:hi], states[lo:hi],
                            lr_t, wd, rescale)

    def _adam_pass(self, weights, grads, states, lr_t, wd, rescale):
        means = [s[0] for s in states]
        variances = [s[1] for s in states]
        g = torch._foreach_mul(grads, rescale)
        clip = self.clip_gradient
        if clip is not None and clip > 0:
            torch._foreach_clamp_min_(g, -clip)
            torch._foreach_clamp_max_(g, clip)
        if self.wd:
            torch._foreach_add_(g, torch._foreach_mul(weights, wd))
        torch._foreach_mul_(means, self.beta1)
        torch._foreach_add_(means, g, alpha=1.0 - self.beta1)
        torch._foreach_mul_(variances, self.beta2)
        torch._foreach_addcmul_(variances, g, g, value=1.0 - self.beta2)
        # the denominator in g's buffers: g is spent
        denom = g
        torch._foreach_copy_(denom, variances)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.epsilon)
        step = torch._foreach_mul(means, lr_t)
        torch._foreach_div_(step, denom)
        torch._foreach_sub_(weights, step)


#: elements of one multi-tensor pass of Adam (a tensor larger than this
#: is a pass of its own): the pass's temporaries (the scaled gradient,
#: the step) are at most twice this, not twice the model
_PASS_ELEMENTS = 1 << 28


def _spans(tensors, limit):
    """(start, stop) of consecutive runs of ``tensors`` holding at most
    ``limit`` elements each (or one tensor)."""
    spans, lo, n = [], 0, 0
    for i, t in enumerate(tensors):
        if i > lo and n + t.numel() > limit:
            spans.append((lo, i))
            lo, n = i, 0
        n += t.numel()
    if lo < len(tensors):
        spans.append((lo, len(tensors)))
    return spans


def create(name, **kwargs):
    """An optimizer by name: ``"sgd"`` or ``"adam"``."""
    return Optimizer.create_optimizer(name, **kwargs)
