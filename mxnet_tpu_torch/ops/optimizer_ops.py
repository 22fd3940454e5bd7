"""SGD update operators, as the JAX package's ``ops/optimizer_ops.py``
(``sgd_update``, ``sgd_mom_update``).

Each returns the updated tensors; ``invoke`` writes them into ``out=``
in place.  ``lr``, ``wd`` and ``rescale_grad`` are scalar attrs: Python
numbers, never copied to the device.  With no clipping and no weight
decay, ``sgd_update`` is one fused ``w + (-lr * rescale_grad) * g``.
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
    """Rows a (row-sparse) gradient touches: any nonzero in the row.  The
    lazy update leaves the other rows alone, no weight decay included."""
    m = torch.any((grad != 0).reshape(grad.shape[0], -1), dim=1)
    return m.reshape((-1,) + (1,) * (grad.dim() - 1))


@register("sgd_update", num_inputs=2,
          scalar_attrs=("lr", "wd", "rescale_grad"))
def sgd_update(weight, grad, lr, wd, rescale_grad=1.0, *,
               clip_gradient=-1.0, lazy_update=False):
    plain = (clip_gradient is None or clip_gradient <= 0) and wd == 0 \
        and not lazy_update
    if plain and isinstance(lr, numbers.Number) \
            and isinstance(rescale_grad, numbers.Number):
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
