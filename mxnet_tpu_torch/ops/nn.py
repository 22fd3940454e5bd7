"""The plain operators of the Llama, BERT and MLP paths, in PyTorch.

Dense layers run :func:`fully_connected` (``F.linear``, weight (out, in)
as in the JAX package's FullyConnected).  ``fully_connected`` and
:func:`dot` honour ``contrib.amp``.  Dropout draws its keep-mask from the
device's ``mx.random`` generator (or one the caller passes).

The MLP's ops are also registered under the JAX package's names
(``FullyConnected``, ``Activation``, ``softmax``, ``log_softmax``,
``softmax_cross_entropy``, ``Dropout``, ``identity``, ``BlockGrad``), so
``mx.nd`` and ``invoke`` reach these same functions."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..contrib import amp
from .registry import alias, register

__all__ = ["silu", "rms_norm", "dot", "take", "embedding",
           "cache_update", "fully_connected", "activation", "gelu",
           "layer_norm", "dropout", "softmax", "log_softmax", "pick",
           "softmax_cross_entropy"]


def silu(data):
    return F.silu(data)


def rms_norm(data, gamma, eps=1e-6):
    """x * rsqrt(mean(x^2) + eps) * gamma over the last axis, in the
    input type."""
    ms = torch.mean(torch.square(data), dim=-1, keepdim=True)
    return data * torch.rsqrt(ms + eps) * gamma


def dot(a, b, *, transpose_a=False, transpose_b=False):
    """Contract the last axis of a with the first axis of b; a transpose
    reverses every axis."""
    a, b = amp.cast_inputs("dot", a, b)
    if transpose_a:
        a = a.permute(*range(a.dim() - 1, -1, -1))
    if transpose_b:
        b = b.permute(*range(b.dim() - 1, -1, -1))
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


@register("FullyConnected", num_inputs=None)
def _fully_connected_op(data, weight, *rest, num_hidden=0, no_bias=False,
                        flatten=True):
    return fully_connected(data, weight, None if no_bias else rest[0],
                           flatten=flatten)


_ACTIVATIONS = {"relu": torch.relu, "sigmoid": torch.sigmoid,
                "tanh": torch.tanh, "softrelu": F.softplus,
                "softsign": F.softsign, "log_sigmoid": F.logsigmoid,
                "mish": F.mish, "relu6": lambda x: torch.clamp(x, 0.0, 6.0)}


def activation(data, act_type="relu"):
    """``Activation(act_type=...)``: relu, sigmoid, tanh, softrelu,
    softsign, log_sigmoid, mish or relu6."""
    if act_type not in _ACTIVATIONS:
        raise ValueError(f"unknown act_type {act_type!r}; options "
                         f"{sorted(_ACTIVATIONS)}")
    return _ACTIVATIONS[act_type](data)


@register("Activation")
def _activation_op(data, *, act_type="relu"):
    return activation(data, act_type)


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


def dropout(data, p=0.5, training=False, generator=None, axes=()):
    """Zero each element with probability ``p`` and scale the kept ones
    by ``1 / (1 - p)``; the identity when not training.  ``axes`` share
    one draw along each named axis.  The keep-mask comes from
    ``generator``, by default the device's ``mx.random`` stream."""
    if not training or p <= 0.0:
        return data
    if generator is None:
        from .. import random as _random
        generator = _random.generator(data.device)
    shape = tuple(1 if i in axes else n for i, n in enumerate(data.shape))
    keep = torch.rand(shape, generator=generator,
                      device=data.device) < 1.0 - p
    return torch.where(keep, data / (1.0 - p), 0.0)


@register("Dropout")
def _dropout_op(data, *, p=0.5, mode="training", axes=(), training=False,
                generator=None):
    return dropout(data, p=p, training=training, generator=generator,
                   axes=tuple(axes))


@register("softmax", num_inputs=None)
def softmax(data, *rest, axis=-1, temperature=None, use_length=False):
    """Softmax along ``axis``; with ``use_length`` the positions at or
    past each row's length (the second input) get probability 0."""
    if temperature is not None and temperature != 1.0:
        data = data / temperature
    if use_length and rest:
        steps = torch.arange(data.shape[axis], device=data.device)
        shape = [1] * data.dim()
        shape[axis] = data.shape[axis]
        mask = steps.reshape(shape) < rest[0].long().unsqueeze(axis)
        out = F.softmax(data.masked_fill(~mask, float("-inf")), dim=axis)
        return out.masked_fill(~mask, 0.0)
    return F.softmax(data, dim=axis)


@register("log_softmax")
def log_softmax(data, *, axis=-1, temperature=None):
    if temperature is not None and temperature != 1.0:
        data = data / temperature
    return F.log_softmax(data, dim=axis)


def pick(data, index, axis=-1, keepdims=False):
    """``data`` at ``index`` along ``axis``, the index clipped into
    range (labels are float32 class ids)."""
    axis = axis % data.dim()
    idx = index.to(data.device).long().clamp(0, data.shape[axis] - 1)
    out = torch.gather(data, axis, idx.unsqueeze(axis))
    return out if keepdims else out.squeeze(axis)


@register("softmax_cross_entropy", num_inputs=2)
def softmax_cross_entropy(data, label):
    """The summed cross-entropy of the rows of ``data`` against class
    ``label``s."""
    return -torch.sum(pick(log_softmax(data, axis=-1), label, axis=-1))


@register("identity")
def identity(data):
    return data


@register("BlockGrad")
def block_grad(data):
    return data.detach()


alias("stop_gradient", "BlockGrad")
