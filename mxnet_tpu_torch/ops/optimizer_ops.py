"""Update operators, as the JAX package's ``ops/optimizer_ops.py``:
``sgd_update``, ``sgd_mom_update``, ``adam_update`` and
``clip_by_global_norm``.

Each returns the updated tensors; ``invoke`` writes them into ``out=``
in place.  ``lr``, ``wd`` and ``rescale_grad`` are scalar attrs: Python
numbers, or 0-d tensors on the weight's device (the optimizer's device
scalars, which a captured step reads afresh at each replay).  With
Python numbers, no clipping and no weight decay, ``sgd_update`` is one
fused ``w + (-lr * rescale_grad) * g``.
"""
from __future__ import annotations

import numbers

import torch

from .registry import register


def _prep_grad(grad, rescale_grad, clip_gradient, wd=None, weight=None):
    g = grad * rescale_grad
    if clip_gradient is not None and clip_gradient > 0:
        g = torch.clamp(g, -clip_gradient, clip_gradient)
    if wd is not None:
        g = g + wd * weight
    return g


def _row_mask(grad):
    """Rows a (row-sparse) gradient touches: any nonzero in the row (a
    row that was looked up but whose gradient is exactly zero is not
    touched).  The lazy update leaves the other rows alone: no weight
    decay, no decay of their optimizer state.  A fixed-shape mask over
    the dense buffer, so a captured step can take it."""
    m = torch.any((grad != 0).reshape(grad.shape[0], -1), dim=1)
    return m.reshape((-1,) + (1,) * (grad.dim() - 1))


@register("sgd_update", num_inputs=2,
          scalar_attrs=("lr", "wd", "rescale_grad"))
def sgd_update(weight, grad, lr, wd, rescale_grad=1.0, *,
               clip_gradient=-1.0, lazy_update=False):
    numbers_only = all(isinstance(s, numbers.Number)
                       for s in (lr, wd, rescale_grad))
    if numbers_only and (clip_gradient is None or clip_gradient <= 0) \
            and wd == 0 and not lazy_update:
        return torch.add(weight, grad, alpha=-lr * rescale_grad)
    new_w = weight - lr * _prep_grad(grad, rescale_grad, clip_gradient, wd,
                                     weight)
    if lazy_update:
        return torch.where(_row_mask(grad), new_w, weight)
    return new_w


@register("sgd_mom_update", num_inputs=3,
          scalar_attrs=("lr", "wd", "rescale_grad"), num_outputs=2)
def sgd_mom_update(weight, grad, mom, lr, wd, rescale_grad=1.0, *,
                   momentum=0.0, clip_gradient=-1.0, lazy_update=False):
    g = _prep_grad(grad, rescale_grad, clip_gradient, wd, weight)
    new_mom = momentum * mom - lr * g
    if lazy_update:
        mask = _row_mask(grad)
        new_mom = torch.where(mask, new_mom, mom)
        return torch.where(mask, weight + new_mom, weight), new_mom
    return weight + new_mom, new_mom


@register("adam_update", num_inputs=4,
          scalar_attrs=("lr", "wd", "rescale_grad"), num_outputs=3)
def adam_update(weight, grad, mean, var, lr, wd, rescale_grad=1.0, *,
                beta1=0.9, beta2=0.999, epsilon=1e-8, clip_gradient=-1.0,
                lazy_update=False):
    """Adam with the bias correction already on ``lr``:
    ``m = beta1 m + (1 - beta1) g``, ``v = beta2 v + (1 - beta2) g^2``,
    ``w -= lr m / (sqrt(v) + epsilon)``; lazily, only the touched rows of
    ``w``, ``m`` and ``v`` change."""
    g = _prep_grad(grad, rescale_grad, clip_gradient, wd, weight)
    new_mean = beta1 * mean + (1.0 - beta1) * g
    new_var = beta2 * var + (1.0 - beta2) * torch.square(g)
    w = weight - lr * new_mean / (torch.sqrt(new_var) + epsilon)
    if lazy_update:
        mask = _row_mask(grad)
        return (torch.where(mask, w, weight),
                torch.where(mask, new_mean, mean),
                torch.where(mask, new_var, var))
    return w, new_mean, new_var


def global_norm_scale(arrays, max_norm):
    """(the global 2-norm of ``arrays``, accumulated in float32, and
    ``min(1, max_norm / (norm + 1e-8))``)."""
    total = sum(torch.sum(torch.square(a.float())) for a in arrays)
    norm = torch.sqrt(total)
    return norm, torch.clamp(max_norm / (norm + 1e-8), max=1.0)


@register("clip_by_global_norm", num_inputs=None, num_outputs=-1,
          scalar_attrs=("max_norm",), scalar_ref_input=None)
def clip_by_global_norm(*arrays):
    """Every array scaled so that their global 2-norm is at most
    ``max_norm`` (the trailing scalar), then the norm before the clip:
    one op over all arrays (``gluon.utils.clip_global_norm``)."""
    *arrs, max_norm = arrays
    norm, scale = global_norm_scale(arrs, max_norm)
    return tuple(a * scale.to(a.dtype) for a in arrs) + (norm,)
