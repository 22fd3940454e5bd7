"""Optimizers: the reference's ``Optimizer`` registry with its eleven
optimizers (``SGD``, ``NAG``, ``Adam``, ``AdamW``, ``AdaGrad``,
``AdaDelta``, ``RMSProp``, ``Ftrl``, ``SignSGD``, ``Signum``, ``LAMB``)
and ``Test``, and the ``Updater`` that ``gluon.Trainer`` drives (as the
JAX package's ``optimizer/optimizer.py``).  ``DataParallelTrainer`` runs
the same classes.

``SGD`` runs the ``sgd_update`` / ``sgd_mom_update`` ops on NDArrays with
``out=`` (in place), with ``clip_gradient`` and each gluon Parameter's
``lr_mult``/``wd_mult`` (``param_dict``).  ``update_multi`` updates a set
of parameters at once with ``torch._foreach_*`` multi-tensor operators
(the reference's ``call_fused``): the same arithmetic, a few launches for
the whole set.  ``lr_scheduler`` (``mx.lr_scheduler``) gives the
learning rate of each update from the update count.

**Multi-precision** (``multi_precision=True``): a float16 weight keeps a
float32 master copy in its state, ``(master, inner state)``
(``create_state_multi_precision``); the update runs on the master with
the gradient in float32 and writes the master's rounding back into the
weight (``update_multi_precision``), the arithmetic of the reference's
``mp_sgd_update``/``mp_sgd_mom_update``.  ``Updater.call_fused`` updates
the whole set in one multi-tensor pass where the reference has a fused
plan for it, and parameter by parameter where its ``_fused_plan``
returns None: multi-precision float16 weights under any optimizer but
SGD, and a set that mixes float16 and other weights
(``_fused_supported``).

The optimizers after SGD and Adam (``_PerTensor``: NAG, AdamW, AdaGrad,
AdaDelta, RMSProp, Ftrl, SignSGD, Signum, Test, and LAMB with its own
multi-tensor pass) update each parameter with the reference's update op
(``ops/optimizer_ops.py``), their per-step scalars staged as device
scalars like Adam's, so ``compile_step`` and
``DataParallelTrainer(fuse_step=True)`` capture them.

**Row-sparse gradients** (``Embedding(sparse_grad=True)``,
``attach_grad(stype="row_sparse")``) take the lazy update when
``lazy_update`` is on (the default): only the rows the gradient touches
(any nonzero) change, weight decay and optimizer state included, through
``sgd_update``/``sgd_mom_update``/``adam_update`` with ``lazy_update``
on that parameter alone (``torch.where`` over the dense buffer, so a
captured step takes it); the dense parameters keep the multi-tensor
pass, as the reference's ``_fused_supported`` takes a row-sparse
gradient out of its fused update.

**Per-step scalars live on the device.**  ``lr`` (the scheduled one too), ``wd``,
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
import pickle
from typing import Dict

import torch

from .base import MXNetError

__all__ = ["Optimizer", "SGD", "NAG", "Adam", "AdamW", "AdaGrad",
           "AdaDelta", "RMSProp", "Ftrl", "SignSGD", "Signum", "LAMB", "Test",
           "Updater", "DeviceScalars", "create", "register", "get_updater",
           "sgd_multi"]


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
    lazy_update = False

    @staticmethod
    def register(klass):
        Optimizer.opt_registry[klass.__name__.lower()] = klass
        return klass

    @staticmethod
    def create_optimizer(name, **kwargs):
        key = str(name).lower()
        if key not in Optimizer.opt_registry:
            raise MXNetError(f"Cannot find optimizer {name!r}; options "
                             f"{sorted(Optimizer.opt_registry)}")
        return Optimizer.opt_registry[key](**kwargs)

    def __init__(self, rescale_grad=1.0, wd=0.0, clip_gradient=None,
                 learning_rate=None, lr_scheduler=None, param_dict=None,
                 multi_precision=False):
        self.rescale_grad = rescale_grad
        self.multi_precision = multi_precision
        self.lr = learning_rate if learning_rate is not None else 0.01
        self.lr_scheduler = lr_scheduler
        if lr_scheduler is not None and learning_rate is not None:
            self.lr_scheduler.base_lr = learning_rate
        self.wd = wd
        self.clip_gradient = clip_gradient
        self.num_update = 0
        self._index_update_count = {}
        self.param_dict = param_dict if param_dict else {}
        self._scalars = DeviceScalars(("lr", "wd", "rescale_grad",
                                       "neg_lr_rescale"))

    @property
    def learning_rate(self):
        """The learning rate of the current update: the scheduler's at
        ``num_update`` when there is one."""
        if self.lr_scheduler is not None:
            return self.lr_scheduler(self.num_update)
        return self.lr

    @learning_rate.setter
    def learning_rate(self, lr):
        self.set_learning_rate(lr)

    def set_learning_rate(self, lr):
        if self.lr_scheduler is not None:
            raise MXNetError("LRScheduler of the optimizer has already been "
                             "defined.")
        self.lr = lr

    def __getstate__(self):
        # the parameters and the device scalars stay behind: Trainer binds
        # the parameters again after a load, and the scalars are made anew
        state = self.__dict__.copy()
        state["param_dict"] = {}
        state["_scalars"] = DeviceScalars(self._scalars.names)
        return state

    def _lazy(self, grad):
        """Whether ``grad`` takes the lazy (touched rows only) update."""
        return self.lazy_update and grad.stype == "row_sparse"

    def _update_count(self, index):
        count = self._index_update_count.get(index, 0) + 1
        self._index_update_count[index] = count
        self.num_update = max(count, self.num_update)

    def _clip(self):
        return -1.0 if self.clip_gradient is None else float(
            self.clip_gradient)

    def create_state(self, index, weight):
        return None

    def _mp(self, weight):
        """Whether ``weight`` (an NDArray) takes the multi-precision
        update: ``multi_precision`` on and a float16 weight."""
        return self.multi_precision and weight.tensor.dtype == torch.float16

    def create_state_multi_precision(self, index, weight):
        """``(float32 master copy, create_state(master))`` for a float16
        weight under ``multi_precision``, else ``create_state``."""
        if self._mp(weight):
            master = weight.astype("float32")
            return (master, self.create_state(index, master))
        return self.create_state(index, weight)

    def update(self, index, weight, grad, state):
        raise NotImplementedError

    def update_multi_precision(self, index, weight, grad, state):
        """``update`` on the float32 master of a multi-precision weight
        (the gradient cast to float32), the master then rounded into the
        weight; ``update`` itself for any other weight."""
        if self._mp(weight):
            master, inner = state
            self.update(index, master, grad.astype("float32"), inner)
            with torch.no_grad():
                weight.tensor.copy_(master.tensor)
        else:
            self.update(index, weight, grad, state)

    def _masters(self, weights, grads, states):
        """The update's operands with each multi-precision weight replaced
        by its float32 master, its gradient by a float32 copy and its
        state by the inner state; and the (weight, master) pairs to copy
        back after the update (:func:`_copy_back`)."""
        ws, gs, ss, back = [], [], [], []
        for w, g, s in zip(weights, grads, states):
            if self._mp(w):
                master, inner = s
                back.append((w, master))
                w, g, s = master, g.astype("float32"), inner
            ws.append(w)
            gs.append(g)
            ss.append(s)
        return ws, gs, ss, back

    #: the reference has a fused multi-precision plan (multi_mp_sgd_*)
    _fused_mp = False

    def _fused_supported(self, weights):
        """Whether ``Updater.call_fused`` may update ``weights`` in one
        multi-tensor pass: the reference's ``_fused_supported`` (no mix
        of float16 and other weights under ``multi_precision``) and a
        fused plan for multi-precision weights (SGD's alone)."""
        mp = [self._mp(w) for w in weights]
        if not any(mp):
            return True
        return all(mp) and self._fused_mp

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

    _fused_mp = True

    def __init__(self, momentum=0.0, lazy_update=True, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.lazy_update = lazy_update

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
        decay, a learning-rate multiplier or a lazy update it is
        ``sgd_update``'s fused form, ``w += (-lr * rescale_grad) * g``: one
        kernel, in place."""
        from . import ndarray as nd
        from .ndarray.ndarray import NDArray
        lr, wd, rescale, neg_lr_rescale = self.stage(weight.tensor.device)
        p = self.param_dict.get(index)
        lr_mult, wd_mult = (1.0, 1.0) if p is None else (p.lr_mult,
                                                          p.wd_mult)
        lazy = self._lazy(grad)
        if state is None and self._clip() <= 0 and self.wd == 0 \
                and lr_mult == 1.0 and not lazy:
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
                              clip_gradient=self._clip(), lazy_update=lazy,
                              out=[weight, state])
        else:
            nd.sgd_update(weight, grad, lr=lr, wd=wd, rescale_grad=rescale,
                          clip_gradient=self._clip(), lazy_update=lazy,
                          out=weight)

    def update_multi(self, indices, weights, grads, states):
        if type(self).update is not SGD.update:
            return super().update_multi(indices, weights, grads, states)
        for i in indices:
            self._update_count(i)
        self.apply_multi(indices, weights, grads, states)

    def apply_multi(self, indices, weights, grads, states):
        """The device side of ``update_multi``: the parameters grouped by
        their (lr_mult, wd_mult), each group one :func:`sgd_multi`; a
        parameter with a lazy update alone through :meth:`apply`; a
        multi-precision one on its float32 master (the reference's
        ``multi_mp_sgd_update``/``multi_mp_sgd_mom_update``)."""
        if not indices:
            return
        weights, grads, states, back = self._masters(weights, grads, states)
        self._apply_multi(indices, weights, grads, states)
        _copy_back(back)

    def _apply_multi(self, indices, weights, grads, states):
        scalars = self.stage(weights[0].tensor.device)
        groups = {}
        for i, w, g, s in zip(indices, weights, grads, states):
            if self._lazy(g):
                self.apply(i, w, g, s)
                continue
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


def _copy_back(pairs):
    """Round each float32 master into its weight, in place."""
    with torch.no_grad():
        for weight, master in pairs:
            weight.tensor.copy_(master.tensor)


class Updater:
    """Applies an optimizer's update per parameter index, holding the
    states (parity: ``mx.optimizer.Updater``)."""

    def __init__(self, optimizer: Optimizer):
        self.optimizer = optimizer
        self.states = {}

    def _ensure_state(self, i, w):
        if i not in self.states:
            self.states[i] = self.optimizer.create_state_multi_precision(
                i, w)

    def __call__(self, index, grad, weight):
        indices = index if isinstance(index, (list, tuple)) else [index]
        grads = grad if isinstance(grad, (list, tuple)) else [grad]
        weights = weight if isinstance(weight, (list, tuple)) else [weight]
        for i, g, w in zip(indices, grads, weights):
            self._ensure_state(i, w)
            self.optimizer.update_multi_precision(i, w, g, self.states[i])

    def get_states(self, dump_optimizer=False):
        """The states (and with ``dump_optimizer`` the optimizer, its
        update counts included) pickled, the arrays as numpy."""
        states = {k: _states_to_np(v) for k, v in self.states.items()}
        return pickle.dumps((states, self.optimizer) if dump_optimizer
                            else states)

    def set_states(self, states, ctx_of=None):
        """Take ``get_states``' bytes.  Each state goes on the context
        ``ctx_of(index)`` (default: the current context), into the
        existing state's arrays in place where their shapes match (a
        captured step reads those)."""
        loaded = pickle.loads(states)
        if isinstance(loaded, tuple) and len(loaded) == 2 and \
                isinstance(loaded[1], Optimizer):
            loaded, self.optimizer = loaded
        for i, st in loaded.items():
            ctx = ctx_of(i) if ctx_of is not None else None
            self.states[i] = _states_from_np(st, ctx, self.states.get(i))

    def call_fused(self, indices, grads, weights):
        """Update the parameters ``indices`` together
        (``Optimizer.update_multi``), making any missing state first; one
        at a time (``update_multi_precision``) where the reference has no
        fused plan for them (``Optimizer._fused_supported``)."""
        for i, w in zip(indices, weights):
            self._ensure_state(i, w)
        if not self.optimizer._fused_supported(weights):
            for i, g, w in zip(indices, grads, weights):
                self.optimizer.update_multi_precision(i, w, g,
                                                      self.states[i])
            return
        self.optimizer.update_multi(indices, weights, grads,
                                    [self.states[i] for i in indices])


def _states_to_np(state):
    from .ndarray.ndarray import NDArray
    if state is None:
        return None
    if isinstance(state, NDArray):
        return ("nd", state.asnumpy())
    if isinstance(state, (list, tuple)):
        return ("tuple", [_states_to_np(s) for s in state])
    return ("raw", state)


def _states_from_np(state, ctx, old=None):
    from .ndarray.ndarray import NDArray, array
    if state is None:
        return None
    kind, val = state
    if kind == "nd":
        new = array(val, ctx=ctx, dtype=val.dtype)
        if isinstance(old, NDArray) and old.shape == new.shape \
                and old.dtype == new.dtype and old.context == new.context:
            with torch.no_grad():
                old._t.copy_(new._t)
            return old
        return new
    if kind == "tuple":
        olds = old if isinstance(old, tuple) and len(old) == len(val) \
            else (None,) * len(val)
        return tuple(_states_from_np(s, ctx, o) for s, o in zip(val, olds))
    return val


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
    one multi-tensor pass, the reference's ``multi_adam_update`` plan;
    a parameter with a row-sparse gradient takes ``adam_update``'s lazy
    form alone (``lazy_update``, on by default).  The step count ``t`` is
    the parameter's, so a row its gradient skips still sees ``t`` rise,
    as in the reference."""

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
        weights, grads, states, back = self._masters(weights, grads, states)
        scalars = self.stage(weights[0].tensor.device, t)
        groups = {}
        for i, w, g, s in zip(indices, weights, grads, states):
            p = self.param_dict.get(i)
            mults = (1.0, 1.0) if p is None else (p.lr_mult, p.wd_mult)
            tensors = (w.tensor, g.tensor, (s[0].tensor, s[1].tensor))
            if self._lazy(g):
                self._apply_lazy(*tensors, scalars, mults)
                continue
            groups.setdefault(mults, []).append(tensors)
        for mults, members in groups.items():
            ws, gs, ss = zip(*members)
            self.apply_tensors(list(ws), list(gs), list(ss), scalars,
                               mults)
        _copy_back(back)

    @torch.no_grad()
    def _apply_lazy(self, weight, grad, state, scalars, mults):
        """``adam_update``'s lazy form on one parameter, in place."""
        from .ops.optimizer_ops import adam_update
        lr_t, wd, rescale = scalars
        new = adam_update(weight, grad, *state, lr_t * mults[0],
                          wd * mults[1], rescale, beta1=self.beta1,
                          beta2=self.beta2, epsilon=self.epsilon,
                          clip_gradient=self._clip(), lazy_update=True)
        for dst, src in zip((weight, *state), new):
            dst.copy_(src)

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


class _PerTensor(Optimizer):
    """An optimizer whose update is the reference's update op, one
    parameter at a time, with its per-step scalars on the device.

    ``_SCALARS`` names the scalars :meth:`host_scalars` computes for step
    ``t``: first the learning rate and ``wd`` (each parameter's
    ``lr_mult`` and ``wd_mult`` scale them), then ``rescale_grad``, then
    any of the subclass's own.  ``_STATES`` is the number of state arrays
    a parameter has, ``_STATIC`` the attributes baked into the update
    (the capture's static key).  ``_rule(w, g, states, *scalars)``
    returns the new weight and states; :meth:`apply_tensors` writes them
    in place."""

    _SCALARS = ("lr", "wd", "rescale_grad")
    _STATES = 1
    _STATIC = ()

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self._scalars = DeviceScalars(self._SCALARS)

    def create_state(self, index, weight):
        from .ndarray.ndarray import zeros
        zs = tuple(zeros(weight.shape, ctx=weight.context,
                         dtype=weight.dtype.name)
                   for _ in range(self._STATES))
        return None if not zs else zs[0] if len(zs) == 1 else zs

    def create_tensor_state(self, weight):
        """The states of a tensor ``weight``, as tensors
        (``DataParallelTrainer``)."""
        return tuple(torch.zeros_like(weight) for _ in range(self._STATES))

    @property
    def capturable(self):
        return type(self).update is _PerTensor.update

    def host_scalars(self, t):
        """The values of ``_SCALARS`` at step ``t``."""
        return (self.learning_rate, self.wd, self.rescale_grad)

    def stage(self, device, t=None):
        """Write step ``t``'s scalars (default: at ``num_update``) into
        the device scalars of ``device``; returns their 0-d views."""
        t = self.num_update if t is None else t
        return self._scalars.write(device, self.host_scalars(t))

    def static_key(self, indices=()):
        return super().static_key(indices) + tuple(
            getattr(self, n) for n in self._STATIC) + (bool(self.wd),)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        self._apply_groups([index], [weight], [grad], [state],
                           self._index_update_count[index])

    def update_multi(self, indices, weights, grads, states):
        for i in indices:
            self._update_count(i)
        by_t = {}
        for j, i in enumerate(indices):
            by_t.setdefault(self._index_update_count[i], []).append(j)
        for t, js in by_t.items():
            self._apply_groups([indices[j] for j in js],
                               [weights[j] for j in js],
                               [grads[j] for j in js],
                               [states[j] for j in js], t)

    def apply_multi(self, indices, weights, grads, states):
        """The device side of ``update_multi``, at step ``num_update``."""
        self._apply_groups(indices, weights, grads, states, self.num_update)

    def _apply_groups(self, indices, weights, grads, states, t):
        if not indices:
            return
        weights, grads, states, back = self._masters(weights, grads, states)
        scalars = self.stage(weights[0].tensor.device, t)
        groups = {}
        for i, w, g, s in zip(indices, weights, grads, states):
            p = self.param_dict.get(i)
            mults = (1.0, 1.0) if p is None else (p.lr_mult, p.wd_mult)
            groups.setdefault(mults, []).append(
                (w.tensor, g.tensor, _state_tensors(s)))
        for mults, members in groups.items():
            ws, gs, ss = zip(*members)
            self.apply_tensors(list(ws), list(gs), list(ss), scalars,
                               mults)
        _copy_back(back)

    @torch.no_grad()
    def apply_tensors(self, weights, grads, states, scalars,
                      mults=(1.0, 1.0)):
        """The update of parallel lists of weight, gradient and state
        tensors (a tuple a parameter), in place, with the staged
        ``scalars`` times ``mults`` (lr_mult, wd_mult)."""
        lr, wd, *rest = scalars
        if mults[0] != 1.0:
            lr = lr * mults[0]
        if mults[1] != 1.0:
            wd = wd * mults[1]
        for w, g, st in zip(weights, grads, states):
            new = self._rule(w, g, tuple(st), lr, wd, *rest)
            for dst, src in zip((w, *st), new):
                dst.copy_(src)

    def _rule(self, weight, grad, states, lr, wd, rescale, *extra):
        raise NotImplementedError


def _state_tensors(state):
    """A parameter's state as a tuple of tensors."""
    from .ndarray.ndarray import NDArray
    if state is None:
        return ()
    if isinstance(state, NDArray):
        return (state.tensor,)
    return tuple(s.tensor for s in state)


def _adam_corrected_lr(o, t):
    """Adam's learning rate with step ``t``'s bias correction."""
    return (o.learning_rate * math.sqrt(1.0 - o.beta2 ** t)
            / (1.0 - o.beta1 ** t))


@register
class NAG(_PerTensor):
    """Nesterov accelerated SGD (``nag_mom_update``)."""

    _STATIC = ("momentum",)

    def __init__(self, momentum=0.0, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum

    def _rule(self, w, g, states, lr, wd, rescale):
        from .ops.optimizer_ops import nag_mom_update
        return nag_mom_update(w, g, states[0], lr, wd, rescale,
                              momentum=self.momentum,
                              clip_gradient=self._clip())


@register
class AdamW(_PerTensor):
    """Adam with decoupled weight decay (``adamw_update``, ``eta`` 1), the
    bias correction on the learning rate as Adam's."""

    _SCALARS = ("lr_t", "wd", "rescale_grad")
    _STATES = 2
    _STATIC = ("beta1", "beta2", "epsilon")

    def __init__(self, learning_rate=None, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate=0.001 if learning_rate is None
                         else learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon

    def host_scalars(self, t):
        return (_adam_corrected_lr(self, t), self.wd, self.rescale_grad)

    def _rule(self, w, g, states, lr_t, wd, rescale):
        from .ops.optimizer_ops import adamw_update
        return adamw_update(w, g, *states, lr_t, 1.0, wd, rescale,
                            beta1=self.beta1, beta2=self.beta2,
                            epsilon=self.epsilon,
                            clip_gradient=self._clip())


@register
class AdaGrad(_PerTensor):
    """AdaGrad (``adagrad_update``)."""

    _STATIC = ("float_stable_eps",)

    def __init__(self, eps=1e-7, **kwargs):
        super().__init__(**kwargs)
        self.float_stable_eps = eps

    def _rule(self, w, g, states, lr, wd, rescale):
        from .ops.optimizer_ops import adagrad_update
        return adagrad_update(w, g, states[0], lr, wd, rescale,
                              epsilon=self.float_stable_eps,
                              clip_gradient=self._clip())


@register
class AdaDelta(_PerTensor):
    """AdaDelta (``adadelta_update``); the learning rate is not used."""

    _STATES = 2
    _STATIC = ("rho", "epsilon")

    def __init__(self, rho=0.9, epsilon=1e-5, **kwargs):
        super().__init__(**kwargs)
        self.rho = rho
        self.epsilon = epsilon

    def _rule(self, w, g, states, lr, wd, rescale):
        from .ops.optimizer_ops import adadelta_update
        return adadelta_update(w, g, *states, wd, rescale, rho=self.rho,
                               epsilon=self.epsilon,
                               clip_gradient=self._clip())


@register
class RMSProp(_PerTensor):
    """RMSProp (``rmsprop_update``); ``centered=True`` is Graves' variant
    (``rmspropalex_update``, states n, g, delta)."""

    _STATIC = ("gamma1", "gamma2", "epsilon", "centered", "clip_weights")

    def __init__(self, learning_rate=None, gamma1=0.9, gamma2=0.9,
                 epsilon=1e-8, centered=False, clip_weights=None, **kwargs):
        super().__init__(learning_rate=0.001 if learning_rate is None
                         else learning_rate, **kwargs)
        self.gamma1 = gamma1
        self.gamma2 = gamma2
        self.centered = centered
        self.epsilon = epsilon
        self.clip_weights = clip_weights
        self._STATES = 3 if centered else 1

    def _rule(self, w, g, states, lr, wd, rescale):
        from .ops.optimizer_ops import rmsprop_update, rmspropalex_update
        cw = -1.0 if self.clip_weights is None else float(self.clip_weights)
        kw = dict(gamma1=self.gamma1, epsilon=self.epsilon,
                  clip_gradient=self._clip(), clip_weights=cw)
        if self.centered:
            return rmspropalex_update(w, g, *states, lr, wd, rescale,
                                      gamma2=self.gamma2, **kw)
        return rmsprop_update(w, g, states[0], lr, wd, rescale, **kw)


@register
class Ftrl(_PerTensor):
    """FTRL-proximal (``ftrl_update``, states z and n)."""

    _STATES = 2
    _STATIC = ("lamda1", "beta")

    def __init__(self, lamda1=0.01, learning_rate=None, beta=1.0, **kwargs):
        super().__init__(learning_rate=0.1 if learning_rate is None
                         else learning_rate, **kwargs)
        self.lamda1 = lamda1
        self.beta = beta

    def _rule(self, w, g, states, lr, wd, rescale):
        from .ops.optimizer_ops import ftrl_update
        return ftrl_update(w, g, *states, lr, wd, rescale,
                           lamda1=self.lamda1, beta=self.beta,
                           clip_gradient=self._clip())


@register
class SignSGD(_PerTensor):
    """SGD on the gradient's sign (``signsgd_update``), no state."""

    _STATES = 0

    def __init__(self, learning_rate=None, **kwargs):
        super().__init__(learning_rate=0.01 if learning_rate is None
                         else learning_rate, **kwargs)

    def _rule(self, w, g, states, lr, wd, rescale):
        from .ops.optimizer_ops import signsgd_update
        return (signsgd_update(w, g, lr, wd, rescale,
                               clip_gradient=self._clip()),)


@register
class Signum(_PerTensor):
    """Signum: the sign of a momentum (``signum_update``)."""

    _STATIC = ("momentum", "wd_lh")

    def __init__(self, learning_rate=None, momentum=0.9, wd_lh=0.0,
                 **kwargs):
        super().__init__(learning_rate=0.01 if learning_rate is None
                         else learning_rate, **kwargs)
        self.momentum = momentum
        self.wd_lh = wd_lh

    def _rule(self, w, g, states, lr, wd, rescale):
        from .ops.optimizer_ops import signum_update
        return signum_update(w, g, states[0], lr, wd, rescale,
                             momentum=self.momentum,
                             clip_gradient=self._clip(), wd_lh=self.wd_lh)


@register
class Test(_PerTensor):
    """The reference's test optimizer: ``w -= lr (rescale g + wd w)``
    (``sgd_update``), with a zero state it never reads."""

    def _rule(self, w, g, states, lr, wd, rescale):
        from .ops.optimizer_ops import sgd_update
        return (sgd_update(w, g, lr, wd, rescale,
                           clip_gradient=self._clip()),)


@register
class LAMB(_PerTensor):
    """LAMB (You et al. 2019): Adam's moments, the direction
    ``m^ / (sqrt(v^) + epsilon) + wd w`` (bias-corrected at the
    parameter's step ``t`` when ``bias_correction``), and a step of
    ``lr * trust`` along it, trust = ||w|| / ||direction|| where both are
    positive (else 1), clamped to ``lower_bound``/``upper_bound``: the
    reference's ``lamb_update_phase1``/``_phase2`` and
    ``multi_lamb_update``.  A set of parameters is one multi-tensor pass
    (``torch._foreach_*``, the norms by ``_foreach_norm``); the step's
    ``1 - beta^t`` are device scalars beside ``lr``, ``wd`` and
    ``rescale_grad``."""

    _SCALARS = ("lr", "wd", "rescale_grad", "bias1", "bias2")
    _STATES = 2
    _STATIC = ("beta1", "beta2", "epsilon", "lower_bound", "upper_bound",
               "bias_correction")

    def __init__(self, learning_rate=None, beta1=0.9, beta2=0.999,
                 epsilon=1e-6, lower_bound=None, upper_bound=None,
                 bias_correction=True, **kwargs):
        super().__init__(learning_rate=0.001 if learning_rate is None
                         else learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon
        self.lower_bound = lower_bound
        self.upper_bound = upper_bound
        self.bias_correction = bias_correction

    def host_scalars(self, t):
        from .ops.optimizer_ops import _bias_denominator
        return (self.learning_rate, self.wd, self.rescale_grad,
                _bias_denominator(self.beta1, t),
                _bias_denominator(self.beta2, t))

    @torch.no_grad()
    def apply_tensors(self, weights, grads, states, scalars,
                      mults=(1.0, 1.0)):
        lr, wd, rescale, bias1, bias2 = scalars
        if mults[0] != 1.0:
            lr = lr * mults[0]
        if mults[1] != 1.0:
            wd = wd * mults[1]
        for lo, hi in _spans(weights, _PASS_ELEMENTS):
            self._lamb_pass(weights[lo:hi], grads[lo:hi], states[lo:hi], lr,
                            wd, rescale, bias1, bias2)

    def _lamb_pass(self, weights, grads, states, lr, wd, rescale, bias1,
                   bias2):
        from .ops.optimizer_ops import _trust_ratio
        means = [s[0] for s in states]
        variances = [s[1] for s in states]
        g = torch._foreach_mul(grads, rescale)
        clip = self._clip()
        if clip > 0:
            torch._foreach_clamp_min_(g, -clip)
            torch._foreach_clamp_max_(g, clip)
        torch._foreach_mul_(means, self.beta1)
        torch._foreach_add_(means, g, alpha=1.0 - self.beta1)
        torch._foreach_mul_(variances, self.beta2)
        torch._foreach_addcmul_(variances, g, g, value=1.0 - self.beta2)
        m, v = means, variances
        if self.bias_correction:
            m = torch._foreach_div(means, bias1)
            v = torch._foreach_div(variances, bias2)
        denom = torch._foreach_sqrt(v)
        torch._foreach_add_(denom, self.epsilon)
        direction = torch._foreach_div(m, denom)
        if self.wd:
            torch._foreach_add_(direction, torch._foreach_mul(weights, wd))
        trust = _trust_ratio(torch.stack(torch._foreach_norm(weights)),
                             torch.stack(torch._foreach_norm(direction)),
                             self.lower_bound, self.upper_bound)
        torch._foreach_mul_(direction, list((-lr * trust).unbind(0)))
        torch._foreach_add_(weights, direction)


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
    """An optimizer by its registered name (``"sgd"``, ``"lamb"``, ...)."""
    return Optimizer.create_optimizer(name, **kwargs)
