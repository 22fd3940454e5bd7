"""Optimizers: the reference's ``Optimizer`` registry with ``SGD`` and the
``Updater`` that ``gluon.Trainer`` drives (as the JAX package's
``optimizer/optimizer.py``), and Adam for ``DataParallelTrainer``.

``SGD`` runs the ``sgd_update`` / ``sgd_mom_update`` ops on NDArrays with
``out=`` (in place), ``lr``, ``wd`` and ``rescale_grad`` as scalars, with
``clip_gradient`` and each gluon Parameter's ``lr_mult``/``wd_mult``
(``param_dict``).  Not ported: the other optimizers, multi-precision,
learning-rate schedules.

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
multi-tensor operators, in place.
"""
from __future__ import annotations

import math
from typing import Dict

import torch

from .base import MXNetError

__all__ = ["Optimizer", "SGD", "Adam", "Updater", "create", "register",
           "get_updater"]


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

    @property
    def learning_rate(self):
        return self.lr

    def set_learning_rate(self, lr):
        self.lr = lr

    def _update_count(self, index):
        count = self._index_update_count.get(index, 0) + 1
        self._index_update_count[index] = count
        self.num_update = max(count, self.num_update)

    def _get_lr(self, index):
        p = self.param_dict.get(index)
        return self.learning_rate * (p.lr_mult if p is not None else 1.0)

    def _get_wd(self, index):
        p = self.param_dict.get(index)
        return self.wd * (p.wd_mult if p is not None else 1.0)

    def _clip(self):
        return -1.0 if self.clip_gradient is None else float(
            self.clip_gradient)

    def create_state(self, index, weight):
        return None

    def update(self, index, weight, grad, state):
        raise NotImplementedError


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

    def update(self, index, weight, grad, state):
        from . import ndarray as nd
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        if state is not None:
            nd.sgd_mom_update(weight, grad, state, lr=lr, wd=wd,
                              momentum=self.momentum,
                              rescale_grad=self.rescale_grad,
                              clip_gradient=self._clip(),
                              out=[weight, state])
        else:
            nd.sgd_update(weight, grad, lr=lr, wd=wd,
                          rescale_grad=self.rescale_grad,
                          clip_gradient=self._clip(), out=weight)


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


def get_updater(optimizer: Optimizer) -> Updater:
    return Updater(optimizer)


class Adam:
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, wd=0.0, rescale_grad=1.0,
                 clip_gradient=None):
        self.learning_rate = learning_rate
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon
        self.wd = wd
        self.rescale_grad = rescale_grad
        self.clip_gradient = clip_gradient

    def create_state(self, weight):
        """(mean, var), zeros like ``weight``."""
        return (torch.zeros_like(weight), torch.zeros_like(weight))

    def corrected_lr(self, t):
        """The learning rate with step ``t``'s bias correction."""
        return (self.learning_rate * math.sqrt(1.0 - self.beta2 ** t)
                / (1.0 - self.beta1 ** t))

    @torch.no_grad()
    def update(self, weights, grads, states, t):
        """Step ``t`` (from 1) for parallel lists of weights, gradients
        and (mean, var) states; weights and states change in place."""
        if not weights:
            return
        means = [s[0] for s in states]
        variances = [s[1] for s in states]
        g = torch._foreach_mul(grads, self.rescale_grad)
        clip = self.clip_gradient
        if clip is not None and clip > 0:
            torch._foreach_clamp_min_(g, -clip)
            torch._foreach_clamp_max_(g, clip)
        if self.wd:
            torch._foreach_add_(g, weights, alpha=self.wd)
        torch._foreach_mul_(means, self.beta1)
        torch._foreach_add_(means, g, alpha=1.0 - self.beta1)
        torch._foreach_mul_(variances, self.beta2)
        torch._foreach_addcmul_(variances, g, g, value=1.0 - self.beta2)
        denom = torch._foreach_sqrt(variances)
        torch._foreach_add_(denom, self.epsilon)
        step = torch._foreach_mul(means, self.corrected_lr(t))
        torch._foreach_div_(step, denom)
        torch._foreach_sub_(weights, step)


Optimizer.opt_registry["adam"] = Adam


def create(name, **kwargs):
    """An optimizer by name: ``"sgd"`` (an ``Optimizer``, for
    ``gluon.Trainer``) or ``"adam"`` (for ``DataParallelTrainer``)."""
    return Optimizer.create_optimizer(name, **kwargs)
