"""Adam, as the JAX package's ``optimizer.Adam`` with the fused
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

import torch

from .base import MXNetError

__all__ = ["Adam", "create"]


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


_REGISTRY = {"adam": Adam}


def create(name, **kwargs):
    """An optimizer by name (``"adam"``)."""
    key = str(name).lower()
    if key not in _REGISTRY:
        raise MXNetError(f"optimizer {name!r} is not ported; options "
                         f"{sorted(_REGISTRY)}")
    return _REGISTRY[key](**kwargs)
