"""The plain operators of the Llama and BERT paths, in PyTorch.

Dense layers run :func:`fully_connected` (``F.linear``, weight (out, in)
as in the JAX package's FullyConnected).  ``fully_connected`` and
:func:`dot` honour ``contrib.amp``.  Dropout draws its keep-mask from the
device's ``mx.random`` generator (or one the caller passes)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..contrib import amp

__all__ = ["silu", "rms_norm", "dot", "take", "embedding",
           "cache_update", "fully_connected", "activation", "gelu",
           "layer_norm", "dropout", "log_softmax", "pick"]


def silu(data):
    return F.silu(data)


def rms_norm(data, gamma, eps=1e-6):
    """x * rsqrt(mean(x^2) + eps) * gamma over the last axis, in the
    input type."""
    ms = torch.mean(torch.square(data), dim=-1, keepdim=True)
    return data * torch.rsqrt(ms + eps) * gamma


def dot(a, b, transpose_a=False, transpose_b=False):
    """Contract the last axis of a with the first axis of b."""
    a, b = amp.cast_inputs("dot", a, b)
    if transpose_a:
        a = a.t()
    if transpose_b:
        b = b.t()
    return torch.tensordot(a, b, dims=1)


def take(a, indices, axis=0):
    """Gather along ``axis`` with indices clipped into range (tokens and
    positions are float32 in this package: cast to long here)."""
    idx = indices.to(device=a.device).long().clamp(0, a.shape[axis] - 1)
    return torch.index_select(a, axis, idx.reshape(-1)).reshape(
        a.shape[:axis] + tuple(indices.shape) + a.shape[axis + 1:])


def embedding(data, weight):
    """Rows of ``weight`` for (float32 or integer) token ids."""
    return F.embedding(data.to(device=weight.device).long(), weight)


def cache_update(cache, new, offset=0):
    """Write ``new`` (B, S, ...) into ``cache`` (B, C, ...) IN PLACE at
    position ``offset`` along axis 1, cast to the cache's type.

    ``offset`` is a number or 0-d tensor (one position for every row),
    or a (B,) tensor placing each row at its own position (S == 1, the
    per-slot decode).  Like a dynamic-update-slice, the start clamps so
    the update fits in the cache."""
    c, s = cache.shape[1], new.shape[1]
    new = new.to(cache.dtype)
    if torch.is_tensor(offset) and offset.dim():
        if s != 1:
            raise ValueError("per-row cache_update writes one position")
        idx = offset.to(cache.device).long().clamp(0, c - 1)
        rows = torch.arange(cache.shape[0], device=cache.device)
        cache[rows, idx] = new[:, 0]
        return cache
    start = min(max(int(offset), 0), c - s)
    cache[:, start:start + s] = new
    return cache


def fully_connected(data, weight, bias=None, flatten=True):
    """``data @ weight.T + bias``, weight (num_hidden, in_units);
    ``flatten`` folds every axis after the first into one."""
    data, weight, bias = amp.cast_inputs("FullyConnected", data, weight,
                                         bias)
    if flatten and data.dim() > 2:
        data = data.reshape(data.shape[0], -1)
    return F.linear(data, weight, bias)


_ACTIVATIONS = {"relu": torch.relu, "sigmoid": torch.sigmoid,
                "tanh": torch.tanh, "softrelu": F.softplus}


def activation(data, act_type="relu"):
    """``Activation(act_type=...)``: relu, sigmoid, tanh or softrelu."""
    if act_type not in _ACTIVATIONS:
        raise ValueError(f"unknown act_type {act_type!r}; options "
                         f"{sorted(_ACTIVATIONS)}")
    return _ACTIVATIONS[act_type](data)


def gelu(data):
    """Exact (erf) GELU: ``LeakyReLU(act_type="gelu")``."""
    return F.gelu(data)


def layer_norm(data, gamma, beta, eps=1e-5):
    """Normalise over the last axis, then ``* gamma + beta``.  Data of
    another type than gamma (bf16 under AMP) is normalised in its own
    type and promoted by the f32 gamma, as in the reference."""
    shape = data.shape[-1:]
    if data.dtype == gamma.dtype:
        return F.layer_norm(data, shape, gamma, beta, eps)
    return F.layer_norm(data, shape, eps=eps) * gamma + beta


def dropout(data, p=0.5, training=False, generator=None):
    """Zero each element with probability ``p`` and scale the kept ones
    by ``1 / (1 - p)``; the identity when not training.  The keep-mask
    comes from ``generator``, by default the device's ``mx.random``
    stream."""
    if not training or p <= 0.0:
        return data
    if generator is None:
        from .. import random as _random
        generator = _random.generator(data.device)
    keep = torch.rand(data.shape, generator=generator,
                      device=data.device) < 1.0 - p
    return torch.where(keep, data / (1.0 - p), 0.0)


def log_softmax(data, axis=-1):
    return F.log_softmax(data, dim=axis)


def pick(data, index, axis=-1, keepdims=False):
    """``data`` at ``index`` along ``axis``, the index clipped into
    range (labels are float32 class ids)."""
    axis = axis % data.dim()
    idx = index.to(data.device).long().clamp(0, data.shape[axis] - 1)
    out = torch.gather(data, axis, idx.unsqueeze(axis))
    return out if keepdims else out.squeeze(axis)
