"""The plain operators of the Llama, BERT, MLP and ResNet paths, in
PyTorch.

Dense layers run :func:`fully_connected` (``F.linear``, weight (out, in)
as in the JAX package's FullyConnected).  ``fully_connected``,
:func:`convolution` and :func:`dot` run float32 inputs in the AMP type
under ``contrib.amp``.  Dropout draws its keep-mask from the
device's ``mx.random`` generator (or one the caller passes).
:func:`chunked_softmax_ce` is the large-vocabulary cross-entropy of the
Llama loss: the head streamed in slabs, never the whole logits.

The ops are also registered under the JAX package's names
(``FullyConnected``, ``Convolution``, ``Deconvolution``, ``Pooling``,
``BatchNorm``, ``Activation``, ``LeakyReLU``, ``gelu_tanh``,
``RMSNorm``, ``LayerNorm``, ``InstanceNorm``, ``GroupNorm``, ``silu``,
``Embedding``, ``softmax``, ``log_softmax``, ``softmax_cross_entropy``,
``chunked_softmax_ce``, ``chunked_softmax_ce_bias``, ``Dropout``,
``identity``, ``BlockGrad``),
so ``mx.nd`` and ``invoke`` reach these same functions.  The layout is
NCHW (NCW, NCDHW), the reference's."""
from __future__ import annotations

import math
import warnings

import numpy as np
import torch
import torch.nn.functional as F

from ..base import MXNetError
from ..contrib import amp
from . import quantization_ops as _q
from .registry import alias, register

__all__ = ["silu", "rms_norm", "dot", "take", "embedding",
           "cache_update", "fully_connected", "convolution",
           "deconvolution", "pooling", "batch_norm", "update_moving_stats",
           "activation", "leaky_relu", "gelu", "gelu_tanh", "layer_norm",
           "instance_norm", "group_norm", "dropout", "softmax",
           "log_softmax", "pick",
           "softmax_cross_entropy", "chunked_softmax_ce",
           "chunked_softmax_ce_bias"]


@register("silu")
def silu(data):
    return F.silu(data)


def rms_norm(data, gamma, eps=1e-6, axis=-1):
    """x * rsqrt(mean(x^2) + eps) * gamma over ``axis``, in the input
    type promoted by gamma's (a bf16 input with the f32 gamma gives f32,
    as in the reference)."""
    ms = torch.mean(torch.square(data), dim=axis, keepdim=True)
    return data * torch.rsqrt(ms + eps) * gamma


@register("RMSNorm", num_inputs=2)
def _rms_norm_op(data, gamma, *, axis=-1, eps=1e-6):
    return rms_norm(data, gamma, eps=eps, axis=axis)


def dot(a, b, *, transpose_a=False, transpose_b=False):
    """Contract the last axis of a with the first axis of b; a transpose
    reverses every axis.  Two int8 operands give the int32 product
    (``quantization_ops.int8_mm``)."""
    a, b = amp.cast_inputs("dot", a, b)
    if transpose_a:
        a = a.permute(*range(a.dim() - 1, -1, -1))
    if transpose_b:
        b = b.permute(*range(b.dim() - 1, -1, -1))
    if _q.both_int8(a, b):
        return _q.int8_tensordot(a, b)
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


@register("embedding", num_inputs=2)
def _embedding_op(data, weight, *, input_dim=0, output_dim=0,
                  dtype="float32", sparse_grad=False):
    return embedding(data, weight)


alias("Embedding", "embedding")


def cache_update(cache, new, offset=0):
    """Write ``new`` (B, S, ...) into ``cache`` (B, C, ...) IN PLACE at
    ``offset`` along axis 1, cast to the cache's type, and return
    ``cache``.  ``offset`` is a number or a 0-d tensor (one position for
    every row), or a (B,) tensor (each row at its own position, the
    per-slot decode).  As ``lax.dynamic_update_slice``: a negative offset
    counts from the end, then the start is clamped into [0, C - S] so
    that the update fits.  A tensor offset stays on the device (no host
    read)."""
    c, s = cache.shape[1], new.shape[1]
    new = new.to(cache.dtype)
    if not torch.is_tensor(offset):
        off = int(offset)
        start = min(max(off + c if off < 0 else off, 0), c - s)
        cache[:, start:start + s] = new
        return cache
    off = offset.to(device=cache.device).long()
    start = torch.where(off < 0, off + c, off).clamp(0, c - s)
    steps = torch.arange(s, device=cache.device)
    if off.dim():
        rows = torch.arange(cache.shape[0], device=cache.device)[:, None]
        cache[rows, start.reshape(-1, 1) + steps] = new
    else:
        cache.index_copy_(1, start + steps, new)
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


# -- convolution, pooling, batch normalisation (reference ops/nn.py:332-513)

_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}


def _ntuple(value, n, default):
    return tuple(int(v) for v in value) if value else (default,) * n


class _ieee_f32:
    """cuDNN without TF32 inside the block, whatever the caller set in
    ``torch.backends.cudnn.allow_tf32`` (PyTorch's default is True):
    float32 operands get float32 math, the kernel numerics contract."""

    def __enter__(self):
        self._prev = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        torch.backends.cudnn.allow_tf32 = self._prev


class _Convolution(torch.autograd.Function):
    """``F.conv{1,2,3}d``, or with ``transposed`` ``F.conv_transpose{1,2,3}d``
    (its ``output_padding`` ``out_pad``), whose forward and backward both
    run without TF32 (PyTorch's own backward would read the caller's flag
    again)."""

    @staticmethod
    def forward(ctx, data, weight, bias, stride, pad, dilate, groups,
                transposed, out_pad):
        ctx.save_for_backward(data, weight)
        ctx.conf = (stride, pad, dilate, groups, transposed, out_pad,
                    None if bias is None else list(bias.shape))
        with _ieee_f32():
            if transposed:
                return _CONV_T[len(stride)](data, weight, bias, stride, pad,
                                            out_pad, groups, dilate)
            return _CONV[len(stride)](data, weight, bias, stride, pad,
                                      dilate, groups)

    @staticmethod
    def backward(ctx, grad):
        data, weight = ctx.saved_tensors
        stride, pad, dilate, groups, transposed, out_pad, bias_shape = \
            ctx.conf
        need = ctx.needs_input_grad
        with _ieee_f32():
            gx, gw, gb = torch.ops.aten.convolution_backward(
                grad, data, weight, bias_shape, stride, pad, dilate,
                transposed, out_pad if transposed else [0] * len(stride),
                groups,
                [need[0], need[1], bias_shape is not None and need[2]])
        return gx, gw, gb, None, None, None, None, None, None


def convolution(data, weight, bias=None, *, stride=(), pad=(), dilate=(),
                num_group=1):
    """Cross-correlation of ``data`` (N, C, *spatial) with ``weight``
    (num_filter, C / num_group, *kernel), 1-, 2- or 3-D, with symmetric
    zero padding ``pad``, plus ``bias``.  A library call (cuDNN on the
    card), as XLA generated it in the reference.  int8 ``data`` and
    ``weight`` give the exact int32 result (im2col and the int8 GEMM,
    ``quantization_ops.int8_convolution``), as the reference's int8 rule."""
    n = weight.dim() - 2
    data, weight, bias = amp.cast_inputs("Convolution", data, weight, bias)
    if _q.both_int8(data, weight):
        out = _q.int8_convolution(data, weight, _ntuple(stride, n, 1),
                                  _ntuple(pad, n, 0), _ntuple(dilate, n, 1),
                                  int(num_group))
        return out if bias is None else out + bias.reshape(
            (1, -1) + (1,) * n)
    return _Convolution.apply(data, weight, bias, _ntuple(stride, n, 1),
                              _ntuple(pad, n, 0), _ntuple(dilate, n, 1),
                              int(num_group), False, None)


@register("Convolution", num_inputs=None)
def _convolution_op(data, weight, *rest, kernel=(), stride=(), dilate=(),
                    pad=(), num_filter=0, num_group=1, no_bias=False,
                    layout=None, workspace=0, cudnn_tune=None,
                    cudnn_off=False):
    return convolution(data, weight, None if no_bias else rest[0],
                       stride=stride, pad=pad, dilate=dilate,
                       num_group=num_group)


_CONV_T = {1: F.conv_transpose1d, 2: F.conv_transpose2d,
           3: F.conv_transpose3d}


def deconvolution(data, weight, bias=None, *, stride=(), pad=(), dilate=(),
                  adj=(), num_group=1, target_shape=()):
    """The transposed convolution: the gradient of ``Convolution`` with
    respect to its input, for ``weight`` (C_in, num_filter / num_group,
    *kernel), PyTorch's own layout.  The output's spatial size is
    ``(x - 1) * stride - 2 * pad + (kernel - 1) * dilate + 1 + adj``;
    ``adj`` must be below ``stride`` (``ValueError``, as the reference).
    A ``target_shape`` overrides ``pad`` and ``adj``: the full output is
    cropped to it, ``ceil(total / 2)`` at the low end and
    ``floor(total / 2)`` at the high end (the reference's
    ``deconvolution-inl.h`` arithmetic), which PyTorch's symmetric
    ``padding`` cannot express, so that case runs unpadded and is
    sliced.  A library call (cuDNN on the card), with TF32 off."""
    n = weight.dim() - 2
    stride = _ntuple(stride, n, 1)
    dilate = _ntuple(dilate, n, 1)
    pad = _ntuple(pad, n, 0)
    adj = _ntuple(adj, n, 0)
    for i in range(n):
        if adj[i] >= stride[i]:
            raise ValueError(f"Deconvolution: adj[{i}]={adj[i]} must be < "
                             f"stride[{i}]={stride[i]}")
    data, weight, bias = amp.cast_inputs("Deconvolution", data, weight,
                                         bias)
    groups = int(num_group)
    if not target_shape:
        return _Convolution.apply(data, weight, bias, stride, pad, dilate,
                                  groups, True, adj)
    full = _Convolution.apply(data, weight, bias, stride, (0,) * n, dilate,
                              groups, True, (0,) * n)
    crop = []
    for i, size in enumerate(int(t) for t in target_shape):
        total = full.shape[2 + i] - size
        if total < 0:
            raise ValueError(
                f"Deconvolution: target_shape {tuple(target_shape)} "
                f"unreachable with kernel/stride/dilate along axis {i} "
                f"(needs total pad {total})")
        lo = (total + 1) // 2
        crop.append(slice(lo, lo + size))
    return full[(slice(None), slice(None), *crop)]


@register("Deconvolution", num_inputs=None)
def _deconvolution_op(data, weight, *rest, kernel=(), stride=(), dilate=(),
                      pad=(), adj=(), num_filter=0, num_group=1,
                      no_bias=True, layout=None, target_shape=(),
                      workspace=0, cudnn_tune=None, cudnn_off=False):
    if num_filter and num_filter != weight.shape[1] * num_group:
        raise MXNetError(f"Deconvolution: num_filter {num_filter} does not "
                         f"match the weight {tuple(weight.shape)} over "
                         f"{num_group} groups")
    bias = rest[0] if not no_bias and rest else None
    return deconvolution(data, weight, bias, stride=stride, pad=pad,
                         dilate=dilate, adj=adj, num_group=num_group,
                         target_shape=target_shape)


def _pool_pads(sizes, kernel, stride, pad, convention):
    """(low, high) padding of each spatial axis, as the reference's
    arithmetic (``ops/nn.py:446-462``): "full" widens the high side until
    the ceil-sized output's last window fits (PyTorch's ``ceil_mode``
    would drop a last window that starts in the padding), "same" pads
    ``ceil(x / stride)`` windows' worth, the odd element high."""
    pads = []
    for x, k, s, p in zip(sizes, kernel, stride, pad):
        lo = hi = p
        if convention == "full":
            out = -(-(x + 2 * p - k) // s) + 1
            hi += max((out - 1) * s + k - (x + 2 * p), 0)
        elif convention == "same":
            need = max((-(-x // s) - 1) * s + k - x, 0)
            lo, hi = need // 2, need - need // 2
        elif convention != "valid":
            raise ValueError(f"unknown pooling_convention {convention!r}")
        pads.append((lo, hi))
    return pads


def _window_sum(x, kernel, stride):
    """The sum over each window (no padding)."""
    if len(kernel) == 1:
        return F.avg_pool2d(x.unsqueeze(2), (1,) + kernel, (1,) + stride,
                            divisor_override=1).squeeze(2)
    pool = F.avg_pool2d if len(kernel) == 2 else F.avg_pool3d
    return pool(x, kernel, stride, divisor_override=1)


_MAX_POOL = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}


@register("Pooling")
def pooling(data, *, kernel=(), pool_type="max", global_pool=False,
            stride=(), pad=(), pooling_convention="valid",
            count_include_pad=True, cudnn_off=False, layout=None):
    """Max, average, sum or L2 (``lp``) pooling over ``kernel`` windows,
    or over the whole of each channel with ``global_pool`` (max, else the
    mean).  Output sizes follow the reference's conventions exactly
    (:func:`_pool_pads`)."""
    n = data.dim() - 2
    if global_pool:
        axes = tuple(range(2, data.dim()))
        return data.amax(axes, keepdim=True) if pool_type == "max" \
            else data.mean(axes, keepdim=True)
    kernel = tuple(int(k) for k in kernel)
    stride = _ntuple(stride, n, 1)
    pads = _pool_pads(data.shape[2:], kernel, stride, _ntuple(pad, n, 0),
                      pooling_convention)
    flat = [v for lo, hi in reversed(pads) for v in (lo, hi)]
    if pool_type == "max":
        if all(lo == hi and 2 * lo <= k for (lo, hi), k in zip(pads, kernel)):
            return _MAX_POOL[n](data, kernel, stride,
                                [lo for lo, _ in pads])
        return _MAX_POOL[n](F.pad(data, flat, value=float("-inf")), kernel,
                            stride)
    if pool_type not in ("avg", "sum", "lp"):
        raise ValueError(f"unknown pool_type {pool_type!r}")
    x = data * data if pool_type == "lp" else data
    s = _window_sum(F.pad(x, flat) if any(flat) else x, kernel, stride)
    if pool_type == "sum":
        return s
    if pool_type == "lp":
        return torch.sqrt(s)
    if count_include_pad:
        return s / float(math.prod(kernel))
    ones = torch.ones((1, 1) + tuple(data.shape[2:]), dtype=data.dtype,
                      device=data.device)
    return s / _window_sum(F.pad(ones, flat), kernel, stride)


@register("BatchNorm", num_inputs=5, num_outputs=3)
def batch_norm(data, gamma, beta, moving_mean, moving_var, *, eps=1e-5,
               momentum=0.9, fix_gamma=True, use_global_stats=False,
               output_mean_var=False, axis=1, cudnn_off=False,
               training=False, group=None):
    """Returns (out, mean, var): the batch's mean and **biased** variance
    over every axis but ``axis`` when ``training`` (and not
    ``use_global_stats``), else the moving ones, and
    ``out = (data - mean) / sqrt(var + eps) * gamma + beta`` (gamma taken
    as 1 with ``fix_gamma``, and then it gets no gradient).  Data of
    another type than gamma (bf16 under AMP, with f32 gamma) is promoted,
    as the reference's arithmetic promotes it.  With a process ``group``
    (a dp>1 trainer's step, ``SyncBatchNorm`` across ranks) the training
    statistics are the global batch's: the sum and the count, then the
    sum of squared deviations, are summed over the group (differentiably)
    before normalising.  No gradient flows into the moving statistics.
    They are the caller's to update (:func:`update_moving_stats`): the op
    stays pure, and PyTorch's own update (unbiased, momentum ``1 - m``)
    is never used."""
    x = data.to(torch.promote_types(data.dtype, gamma.dtype))
    ax = axis % x.dim()
    if ax != 1:
        x = x.movedim(ax, 1)
    weight = None if fix_gamma else gamma
    if training and not use_global_stats and group is not None:
        out, mean, var = _group_batch_norm(x, weight, beta, eps, group)
    elif training and not use_global_stats:
        out, mean, invstd = torch.native_batch_norm(
            x, weight, beta, None, None, True, 0.0, eps)
        var = (invstd.detach().pow(-2) - eps).clamp_min_(0.0)
        mean = mean.detach()
    else:
        out, _, _ = torch.native_batch_norm(
            x, weight, beta, moving_mean.detach(), moving_var.detach(),
            False, 0.0, eps)
        mean, var = moving_mean, moving_var
    if ax != 1:
        out = out.movedim(1, ax)
    return out, mean, var


def _group_batch_norm(x, weight, beta, eps, group):
    """Batch normalisation of channel-first ``x`` over the batch of every
    rank of ``group`` (``jnp.mean``/``jnp.var`` of the global batch):
    returns (out, mean, biased var), the statistics detached."""
    from ..parallel.collectives import _Axis, _PSum
    ax = _Axis.of_group(group)
    dims = [0] + list(range(2, x.dim()))
    c = x.shape[1]
    count = torch.full((1,), float(x.numel() // c), dtype=x.dtype,
                       device=x.device)
    tot = _PSum.apply(torch.cat([x.sum(dims), count]), ax)
    shape = (1, c) + (1,) * (x.dim() - 2)
    n = tot[c]
    mean = tot[:c] / n
    centred = x - mean.reshape(shape)
    var = _PSum.apply(centred.square().sum(dims), ax) / n
    out = centred * torch.rsqrt(var + eps).reshape(shape)
    if weight is not None:
        out = out * weight.reshape(shape)
    if beta is not None:
        out = out + beta.reshape(shape)
    return out, mean.detach(), var.detach()


@torch.no_grad()
def update_moving_stats(moving_mean, moving_var, mean, var, momentum):
    """``moving = momentum * moving + (1 - momentum) * batch`` in place,
    for the mean and the (biased) variance: the reference's update of
    its auxiliary states, outside the tape."""
    for moving, batch in ((moving_mean, mean), (moving_var, var)):
        moving.mul_(momentum).add_(batch.to(moving.dtype) * (1.0 - momentum))


class _ReLU6(torch.autograd.Function):
    """``clamp(x, 0, 6)`` in one pass; the gradient passes whole inside
    (0, 6), half at exactly 0 or 6 (as the JAX package's ``jnp.clip``
    passes it) and not at all outside."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return x.clamp(0.0, 6.0)

    @staticmethod
    def backward(ctx, grad):
        x, = ctx.saved_tensors
        return grad * (0.25 * (1 + x.sign()) * (1 + (6 - x).sign()))


_relu6 = _ReLU6.apply


_ACTIVATIONS = {"relu": torch.relu, "sigmoid": torch.sigmoid,
                "tanh": torch.tanh, "softrelu": F.softplus,
                "softsign": F.softsign, "log_sigmoid": F.logsigmoid,
                "mish": F.mish, "relu6": _relu6}


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


_SELU_ALPHA, _SELU_SCALE = 1.6732632423543772, 1.0507009873554805


@register("LeakyReLU", num_inputs=None)
def leaky_relu(data, *rest, act_type="leaky", slope=0.25, lower_bound=0.125,
               upper_bound=0.334):
    """The reference's ``LeakyReLU`` family: ``leaky`` (``slope`` below
    0), ``elu`` (``slope * (exp(x) - 1)`` below 0), ``selu`` (the
    reference's two constants), ``gelu`` (exact, erf), ``prelu`` (a
    learned slope, the second input: one a channel of axis 1 when it has
    more than one element) and ``rrelu`` (the mean slope
    ``(lower_bound + upper_bound) / 2``, as the reference always uses)."""
    if act_type == "leaky":
        return F.leaky_relu(data, float(slope))
    if act_type == "elu":
        return torch.where(data > 0, data, slope * (torch.exp(data) - 1.0))
    if act_type == "selu":
        return _SELU_SCALE * torch.where(
            data > 0, data, _SELU_ALPHA * (torch.exp(data) - 1.0))
    if act_type == "gelu":
        return gelu(data)
    if act_type == "prelu":
        gamma = rest[0]
        if data.dim() > 1 and gamma.numel() > 1:
            gamma = gamma.reshape((1, -1) + (1,) * (data.dim() - 2))
        return torch.where(data > 0, data, gamma * data)
    if act_type == "rrelu":
        return torch.where(data > 0, data,
                           (lower_bound + upper_bound) / 2.0 * data)
    raise ValueError(f"unknown act_type {act_type}")


def gelu(data):
    """Exact (erf) GELU: ``LeakyReLU(act_type="gelu")``."""
    return F.gelu(data)


@register("gelu_tanh")
def gelu_tanh(data):
    """GELU's tanh approximation."""
    return F.gelu(data, approximate="tanh")


def layer_norm(data, gamma, beta, eps=1e-5):
    """Normalise over the last axis, then ``* gamma + beta``.  Data of
    another type than gamma (bf16 under AMP) is normalised in its own
    type and promoted by the f32 gamma, as in the reference."""
    shape = data.shape[-1:]
    if data.dtype == gamma.dtype:
        return F.layer_norm(data, shape, gamma, beta, eps)
    return F.layer_norm(data, shape, eps=eps) * gamma + beta


@register("LayerNorm", num_inputs=3)
def _layer_norm_op(data, gamma, beta, *, axis=-1, eps=1e-5,
                   output_mean_var=False):
    ax = axis % data.dim()
    if ax == data.dim() - 1:
        return layer_norm(data, gamma, beta, eps)
    return layer_norm(data.movedim(ax, -1), gamma, beta, eps).movedim(-1, ax)


@register("InstanceNorm", num_inputs=3)
def instance_norm(data, gamma, beta, *, eps=1e-3):
    """(N, C, *spatial) normalised per sample and channel over the
    spatial axes (biased variance), then ``* gamma + beta`` per channel.
    The op's default ``eps`` is the reference's 1e-3; the layer passes
    its own (1e-5)."""
    return F.instance_norm(data, weight=gamma, bias=beta, eps=eps)


@register("GroupNorm", num_inputs=3)
def group_norm(data, gamma, beta, *, num_groups=1, eps=1e-5,
               output_mean_var=False):
    """(N, C, ...) normalised per sample over ``num_groups`` groups of
    channels; gamma and beta are one a **group**, shape (num_groups,),
    the reference's layout (``group_norm.cc``), spread over each group's
    channels here."""
    per = data.shape[1] // num_groups
    return F.group_norm(data, num_groups,
                        gamma.repeat_interleave(per),
                        beta.repeat_interleave(per), eps)


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


@register("softmin")
def softmin(data, *, axis=-1):
    return F.softmax(-data, dim=axis)


@register("SoftmaxActivation")
def softmax_activation(data, *, mode="instance"):
    """Softmax over the channels (axis 1) or over each instance's
    features (all but axis 0)."""
    if mode == "channel":
        return F.softmax(data, dim=1)
    return F.softmax(data.reshape(data.shape[0], -1), dim=-1).reshape(
        data.shape)


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


# -- the chunked (streaming) softmax cross-entropy (reference ops/nn.py:192-324)

class _ieee_f32_matmul:
    """cuBLAS without TF32 inside the block, whatever the caller set in
    ``torch.backends.cuda.matmul.allow_tf32``: the slab products of a
    float32 head get float32 math."""

    def __enter__(self):
        self._prev = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32 = self._prev


class _IeeeFn(torch.autograd.Function):
    """``fn(*tensors)`` as one node whose forward and backward both run
    with TF32 off in cuBLAS and cuDNN, whatever the caller set (the
    backward of a plain op would read the caller's flags again)."""

    @staticmethod
    def forward(ctx, fn, *tensors):
        ctx.set_materialize_grads(False)
        with torch.enable_grad(), _ieee_f32_matmul(), _ieee_f32():
            leaves = [t.detach().requires_grad_(t.requires_grad)
                      for t in tensors]
            out = fn(*leaves)
        outs = out if isinstance(out, tuple) else (out,)
        ctx.leaves, ctx.outs = leaves, outs
        detached = tuple(o.detach() for o in outs)
        return detached if isinstance(out, tuple) else detached[0]

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, *grads):
        leaves, outs = ctx.leaves, ctx.outs
        ctx.leaves = ctx.outs = None
        pairs = [(o, g) for o, g in zip(outs, grads)
                 if g is not None and o.requires_grad]
        wrt = [t for t in leaves if t.requires_grad]
        if not pairs or not wrt:
            return (None,) * (1 + len(leaves))
        with _ieee_f32_matmul(), _ieee_f32():
            got = iter(torch.autograd.grad(
                [o for o, _ in pairs], wrt, [g for _, g in pairs],
                allow_unused=True))
        return (None,) + tuple(next(got) if t.requires_grad else None
                               for t in leaves)


def ieee_f32(fn, *tensors):
    """``fn(*tensors)`` with float32 products in float32 on the card
    (TF32 off in cuBLAS and cuDNN), in the forward and, when a gradient
    is recorded, in the backward."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return _IeeeFn.apply(fn, *tensors)
    with _ieee_f32_matmul(), _ieee_f32():
        return fn(*tensors)


def _slabs(v, chunk):
    """(start, stop) of each vocabulary slab: ``ceil(v / chunk)`` slabs
    re-balanced to ``ceil(v / n)`` rows each, as the reference splits
    them (Llama-3's 128256 rows at chunk 8192: 16 slabs of 8016).  The
    last slab stops at ``v``: the reference's padded rows are -inf
    logits, which add nothing to the normalizer."""
    chunk = int(min(chunk, v))
    if chunk <= 0:
        raise MXNetError(f"chunked_softmax_ce: chunk must be positive, "
                         f"got {chunk}")
    n = -(-v // chunk)
    chunk = -(-v // n)
    return [(lo, min(lo + chunk, v)) for lo in range(0, v, chunk)]


class _ChunkedCE(torch.autograd.Function):
    """Per-row ``logsumexp(h W^T + b) - (h W^T + b)[label]`` over the
    vocabulary slabs, carrying the online (max, sum-exp, label logit).
    Only ``hidden``, ``weight``, ``bias``, ``label`` and the per-row
    log-normalizer are saved; the backward recomputes each slab's logits
    (the reference's ``jax.checkpoint`` on the slab body), so no (N, V)
    tensor outlives a slab.  Logits are float32; the products run in
    the promoted type of ``hidden`` and ``weight`` (float32 for the
    Llama head, without TF32)."""

    @staticmethod
    def forward(ctx, hidden, weight, bias, label, chunk):
        n = hidden.shape[0]
        v = weight.shape[0]
        ct = torch.promote_types(hidden.dtype, weight.dtype)
        h = hidden.to(ct)
        lbl = label.to(device=hidden.device).long().reshape(-1)
        dev = hidden.device
        m = torch.full((n,), float("-inf"), dtype=torch.float32, device=dev)
        s = torch.zeros((n,), dtype=torch.float32, device=dev)
        lab = torch.zeros((n,), dtype=torch.float32, device=dev)
        slabs = _slabs(v, chunk)
        with torch.no_grad(), _ieee_f32_matmul():
            for lo, hi in slabs:
                logits = _slab_logits(h, weight, bias, lo, hi, ct)
                idx = lbl - lo
                inside = (idx >= 0) & (idx < hi - lo)
                picked = logits.gather(
                    1, idx.clamp(0, hi - lo - 1)[:, None])[:, 0]
                lab = lab + torch.where(inside, picked, 0.0)
                m_new = torch.maximum(m, logits.amax(dim=1))
                # in place: one slab of logits alive at a time
                s = s * torch.exp(m - m_new) + logits.sub_(
                    m_new[:, None]).exp_().sum(dim=1)
                m = m_new
        lse = m + torch.log(s)
        ctx.save_for_backward(hidden, weight, bias, label, lse)
        ctx.slabs = slabs
        return lse - lab

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad):
        hidden, weight, bias, label, lse = ctx.saved_tensors
        need_h, need_w, need_b = ctx.needs_input_grad[:3]
        ct = torch.promote_types(hidden.dtype, weight.dtype)
        h = hidden.to(ct)
        lbl = label.to(device=hidden.device).long().reshape(-1)
        g = grad.float()[:, None]
        dh = torch.zeros(hidden.shape, dtype=torch.float32,
                         device=hidden.device) if need_h else None
        dw = torch.empty(weight.shape, dtype=ct,
                         device=weight.device) if need_w else None
        db = torch.empty(bias.shape, dtype=torch.float32,
                         device=bias.device) if need_b else None
        with _ieee_f32_matmul():
            for lo, hi in ctx.slabs:
                dl = _slab_logits(h, weight, bias, lo, hi, ct).sub_(
                    lse[:, None]).exp_()
                idx = lbl - lo
                inside = (idx >= 0) & (idx < hi - lo)
                # softmax minus the one-hot of the label (rows whose
                # label lies in another slab subtract 0)
                dl.scatter_add_(1, idx.clamp(0, hi - lo - 1)[:, None],
                                -inside.float()[:, None])
                dl.mul_(g)
                dlc = dl.to(ct)
                if need_h:
                    dh.add_(torch.mm(dlc, weight[lo:hi].to(ct)).float())
                if need_w:
                    torch.mm(dlc.t(), h, out=dw[lo:hi])
                if need_b:
                    db[lo:hi] = dl.sum(dim=0)
        return (None if dh is None else dh.to(hidden.dtype),
                None if dw is None else dw.to(weight.dtype),
                None if db is None else db.to(bias.dtype), None, None)


def _slab_logits(h, weight, bias, lo, hi, ct):
    """float32 logits of the vocabulary rows ``lo:hi`` for ``h``."""
    logits = torch.mm(h, weight[lo:hi].to(ct).t()).float()
    if bias is not None:
        logits = logits + bias[lo:hi].float()
    return logits


def _chunked_ce(hidden, weight, bias, label, chunk, axis_name):
    if axis_name is None:
        return _ChunkedCE.apply(hidden, weight, bias, label, int(chunk))
    return _vocab_sharded_ce(hidden, weight, bias, label, chunk, axis_name)


def _vocab_sharded_ce(hidden, weight, bias, label, chunk, axis_name):
    """The loss of a vocabulary whose rows are split over ``axis_name``
    (rank i holds rows [i V_l, (i+1) V_l)): this rank's slabs give its
    log-normalizer (the slab walk with no label inside) and its label
    logits (one row of ``weight`` a token, 0 for a label another rank
    holds); one max and one sum over the group assemble the loss, the
    same on every rank.  ``hidden``'s gradient is summed over the ranks
    (it is used by each), the loss's cotangent passes through the sum
    (one copy of the loss), as the JAX function's inside ``shard_map``."""
    from ..parallel import collectives as col
    ax = col._axis(axis_name)
    h = col._CopyToAxis.apply(hidden, ax)
    v = weight.shape[0]
    lbl = label.to(device=hidden.device).long().reshape(-1) - ax.index * v
    lse = _ChunkedCE.apply(h, weight, bias, torch.full_like(lbl, -1),
                           int(chunk))
    inside = (lbl >= 0) & (lbl < v)
    idx = lbl.clamp(0, v - 1)
    ct = torch.promote_types(hidden.dtype, weight.dtype)
    picked = (h.to(ct) * weight[idx].to(ct)).sum(dim=-1).float()
    if bias is not None:
        picked = picked + bias[idx].float()
    lab = torch.where(inside, picked, torch.zeros_like(picked))
    m = col._all_reduce(lse.detach(), ax, "max")
    s, lab = col._PSumReplicated.apply(
        torch.stack([torch.exp(lse - m), lab]), ax)
    return m + torch.log(s) - lab


@register("chunked_softmax_ce", num_inputs=3)
def chunked_softmax_ce(hidden, weight, label, *, chunk=8192,
                       axis_name=None):
    """Streaming large-vocabulary cross-entropy: per row,
    ``logsumexp(hidden @ weight.T) - (hidden @ weight.T)[label]`` without
    the (N, V) logits: the head is walked in slabs of about ``chunk``
    rows, and the backward recomputes each slab, so activation memory
    is O(N * chunk).  ``hidden`` (N, U); ``weight`` (V, U), the tied
    embedding or the head (both take gradients); ``label`` (N,) class
    ids.  Returns the per-row loss (N,), float32.  With ``axis_name``
    (an axis of the current mesh, tensor parallel) ``weight`` is this
    rank's vocabulary shard (V/tp, U), the ranks tiling the rows in
    order, and ``label`` holds global ids: the same slab walk runs on
    each shard and one max and one sum over the axis assemble the loss
    (``parallel.collectives.vocab_parallel_softmax_ce`` is the one-slab
    case).  The bias of ``chunked_softmax_ce_bias`` is then this rank's
    (V/tp,) shard."""
    return _chunked_ce(hidden, weight, None, label, chunk, axis_name)


@register("chunked_softmax_ce_bias", num_inputs=4)
def chunked_softmax_ce_bias(hidden, weight, bias, label, *, chunk=8192,
                            axis_name=None):
    """:func:`chunked_softmax_ce` with a per-vocabulary-row logit bias
    (``hidden @ weight.T + bias``), which takes a gradient too."""
    return _chunked_ce(hidden, weight, bias, label, chunk, axis_name)


@register("identity")
def identity(data):
    return data


@register("MakeLoss")
def make_loss(data, *, grad_scale=1.0, valid_thresh=0.0,
              normalization="null"):
    """The identity, as in the JAX package: its gradient is the head's,
    and ``grad_scale`` is not applied (upstream's gradient is
    ``grad_scale`` whatever the head's; ROADMAP queue 3, R9)."""
    return data


class _SoftmaxOutput(torch.autograd.Function):
    """Softmax forward; the backward is the implicit cross-entropy
    gradient ``(prob - one_hot(label)) * grad_scale`` (not the softmax
    Jacobian), as the reference's ``softmax_output.cc``."""

    @staticmethod
    def forward(ctx, data, label, axis, conf):
        prob = torch.softmax(data, dim=axis)
        ctx.save_for_backward(prob, label)
        ctx.axis, ctx.conf = axis, conf
        return prob

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad):
        prob, label = ctx.saved_tensors
        axis = ctx.axis
        grad_scale, ignore_label, use_ignore, normalization, out_grad, \
            smooth_alpha = ctx.conf
        k = prob.shape[axis]
        li = label.to(torch.int32)
        shape = [1] * prob.dim()
        shape[axis] = k
        classes = torch.arange(k, device=prob.device).reshape(shape)
        onehot = (li.unsqueeze(axis) == classes).to(prob.dtype)
        if smooth_alpha:
            onehot = onehot * (1.0 - smooth_alpha) + smooth_alpha / k
        g = prob - onehot
        keep = li != int(ignore_label)
        if use_ignore:
            g = g * keep.unsqueeze(axis).to(prob.dtype)
        if normalization == "batch":
            g = g / prob.shape[0]
        elif normalization == "valid":
            if use_ignore:
                g = g / torch.clamp(keep.sum().to(prob.dtype), min=1.0)
            else:
                g = g / float(math.prod(label.shape))
        g = g * grad_scale
        if out_grad:
            g = g * grad
        return g, None, None, None


@register("SoftmaxOutput", num_inputs=2)
def softmax_output(data, label, *, grad_scale=1.0, ignore_label=-1.0,
                   use_ignore=False, multi_output=False,
                   preserve_shape=False, normalization="null",
                   out_grad=False, smooth_alpha=0.0):
    """The legacy fused softmax with the cross-entropy gradient: softmax
    over the last axis (axis 1 with ``multi_output``) forward, ``(prob -
    one_hot(label)) * grad_scale`` backward, ``ignore_label`` rows zeroed
    with ``use_ignore``, divided by the batch (``"batch"``) or the valid
    labels (``"valid"``), the one-hot smoothed by ``smooth_alpha``."""
    axis = 1 if multi_output else data.dim() - 1
    return _SoftmaxOutput.apply(
        data, label, axis, (grad_scale, ignore_label, use_ignore,
                            normalization, out_grad, smooth_alpha))


@register("BlockGrad")
def block_grad(data):
    return data.detach()


alias("stop_gradient", "BlockGrad")


# -- mixed precision (reference ops/nn.py:649-670) ----------------------------

@register("amp_cast")
def amp_cast(data, *, dtype="float16"):
    """``data`` in ``dtype``."""
    from ..base import torch_dtype
    return data.to(torch_dtype(dtype))


@register("amp_multicast", num_inputs=None, num_outputs=-1)
def amp_multicast(*data, num_outputs=1, cast_narrow=False):
    """Every input in the widest of their types (the narrowest with
    ``cast_narrow``)."""
    dtypes = [d.dtype for d in data]
    if cast_narrow:
        to = min(dtypes, key=lambda t: t.itemsize)
    else:
        to = dtypes[0]
        for t in dtypes[1:]:
            to = torch.promote_types(to, t)
    return tuple(d.to(to) for d in data)


@register("all_finite", num_inputs=None)
def all_finite(*arrays, init_output=True):
    """1.0 (float32) when no element of any array is inf or NaN, else
    0.0: one device value, read on the host by the loss scaler."""
    ok = torch.stack([torch.isfinite(a).all() for a in arrays]).all()
    return ok.float()


alias("multi_all_finite", "all_finite")


# -- the vision group (reference ops/nn.py:543-552, :577-610, :699-827) ------

def linear_resize_weights(m, n):
    """jax.image's (m, n) weights of a linear resize from ``m`` to ``n``
    samples (``compute_weight_mat`` with the triangle kernel: half-pixel
    centres, the kernel widened by the scale when shrinking, so that a
    shrink is antialiased, and each output's weights normalised over the
    taps inside the input), as a float32 numpy array."""
    f32 = np.float32
    inv_scale = f32(1.0 / (n / m))
    kernel_scale = max(inv_scale, f32(1.0))
    sample = (np.arange(n, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = np.abs(sample[None, :] - np.arange(m, dtype=f32)[:, None]) \
        / kernel_scale
    w = np.maximum(f32(0.0), f32(1.0) - np.abs(x))
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample >= -0.5) & (sample <= m - 0.5)
    return np.where(inside[None, :], w, f32(0.0)).astype(f32)


#: (kind, m, n, dtype, device) -> the map's matrix on the device, made once
_MAPS = {}


def _axis_map(kind, m, n, dtype, device):
    """The (n, m) matrix of a linear map from ``m`` samples to ``n``
    along one axis: ``"resize"`` (jax.image's linear weights) or
    ``"pool"`` (adaptive average pooling's floor/ceil windows), in
    ``dtype`` on ``device``, made once a key (so a captured graph reads
    the same tensor at every replay)."""
    key = (kind, m, n, dtype, device)
    mat = _MAPS.get(key)
    if mat is None:
        if kind == "resize":
            w = linear_resize_weights(m, n).T
        else:
            w = np.zeros((n, m), np.float32)
            for i in range(n):
                lo, hi = (i * m) // n, -(-((i + 1) * m) // n)
                w[i, lo:hi] = 1.0 / (hi - lo)
        mat = _MAPS[key] = torch.from_numpy(np.ascontiguousarray(w)).to(
            device=device, dtype=dtype)
    return mat


class _Separable(torch.autograd.Function):
    """``a @ x @ b`` over the last two axes of ``x`` (``a`` (H', H) or
    None for the identity, ``b`` (W, W') or None), the two products in
    the cheaper order, forward and backward without TF32: a float32 input
    gets float32 products."""

    @staticmethod
    def forward(ctx, x, a, b):
        ctx.save_for_backward(a, b)
        return _separable(x, a, b)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad):
        a, b = ctx.saved_tensors
        return _separable(grad, None if a is None else a.t(),
                          None if b is None else b.t()), None, None


def _separable(x, a, b):
    with _ieee_f32_matmul():
        if a is None:
            return torch.matmul(x, b)
        if b is None:
            return torch.matmul(a, x)
        (h2, h), (w, w2) = a.shape, b.shape
        if h2 * h * w + h2 * w * w2 <= h * w * w2 + h2 * h * w2:
            return torch.matmul(torch.matmul(a, x), b)
        return torch.matmul(a, torch.matmul(x, b))


def _separable_map(data, kind, th, tw):
    """``data`` (N, C, H, W) through ``kind``'s linear map to (th, tw).
    An axis whose size stays is left alone, as ``jax.image.resize``
    skips it: either map is the identity there."""
    h, w = data.shape[-2:]
    a = None if h == th else _axis_map(kind, h, th, data.dtype, data.device)
    b = None if w == tw else \
        _axis_map(kind, w, tw, data.dtype, data.device).t()
    if a is None and b is None:
        return data
    return _Separable.apply(data, a, b)


@register("BilinearResize2D")
def bilinear_resize_2d(data, *, height=0, width=0, scale_height=None,
                       scale_width=None, mode="size"):
    """``jax.image.resize(..., "linear")`` of (N, C, H, W) to (height,
    width), or to ``int(H * scale_height)`` etc.: two products with
    jax.image's weight matrices (:func:`linear_resize_weights`), exact
    in both directions and antialiased when it shrinks. ``mode`` is
    accepted and, as in the reference, not read."""
    h, w = data.shape[2], data.shape[3]
    th = height if height else int(h * scale_height)
    tw = width if width else int(w * scale_width)
    return _separable_map(data, "resize", int(th), int(tw))


@register("UpSampling", num_inputs=None)
def upsampling(data, *rest, scale=1, sample_type="nearest", num_args=1,
               num_filter=0, multi_input_mode="concat", workspace=0):
    """``nearest`` repeats each pixel ``scale`` times along H and W;
    ``bilinear`` is :func:`bilinear_resize_2d` to ``scale`` times the
    size. The bilinear weight input, when given, is ignored with a
    warning, as in the reference (its fixed ``init.Bilinear`` kernel)."""
    if sample_type == "nearest":
        return data.repeat_interleave(scale, dim=2).repeat_interleave(
            scale, dim=3)
    if sample_type != "bilinear":
        raise NotImplementedError(
            f"UpSampling sample_type {sample_type!r}: only 'nearest' "
            "and 'bilinear' exist (reference upsampling.cc)")
    if rest:
        warnings.warn(
            "UpSampling(bilinear): the weight input is ignored — this "
            "op implements the FIXED bilinear kernel (init.Bilinear); "
            "for a learned upsampling filter use Conv2DTranspose")
    h, w = data.shape[2], data.shape[3]
    return _separable_map(data, "resize", h * scale, w * scale)


@register("L2Normalization")
def l2_normalization(data, *, eps=1e-10, mode="instance"):
    """``data / sqrt(sum(data^2) + eps)`` over every axis but the first
    (``instance``), the channels (``channel``) or the spatial axes
    (``spatial``)."""
    if mode == "instance":
        axes = tuple(range(1, data.dim()))
    elif mode == "channel":
        axes = (1,)
    else:
        axes = tuple(range(2, data.dim()))
    return data / torch.sqrt(
        torch.sum(torch.square(data), dim=axes, keepdim=True) + eps)


@register("LRN")
def lrn(data, *, nsize=5, alpha=1e-4, beta=0.75, knorm=2.0):
    """Local response normalization across channels:
    ``x / (knorm + alpha / nsize * sum_window(x^2))^beta``, the window
    ``nsize`` channels centred on each, zero outside."""
    half = nsize // 2
    sq = F.pad(torch.square(data).movedim(1, -1), (half, half)).movedim(
        -1, 1)
    c = data.shape[1]
    ssum = sq[:, 0:c]
    for i in range(1, nsize):
        ssum = ssum + sq[:, i:i + c]
    return data / torch.pow(knorm + alpha / nsize * ssum, beta)


def _unit_grid(n, dtype, device):
    """``n`` points evenly from -1 to 1, as ``jnp.linspace(-1, 1, n)``."""
    return torch.linspace(-1.0, 1.0, n, dtype=dtype, device=device)


@register("GridGenerator")
def grid_generator(data, *, transform_type="affine", target_shape=(0, 0)):
    """``affine``: ``data`` (N, 6) is θ, and the output (N, 2, H, W) is θ
    applied to the [-1, 1] grid of ``target_shape`` (x then y rows).
    ``warp``: ``data`` (N, 2, H, W) is a flow in pixels, added to the
    identity grid of its own size in normalized units."""
    if transform_type == "affine":
        h, w = int(target_shape[0]), int(target_shape[1])
        ys = _unit_grid(h, torch.float32, data.device)
        xs = _unit_grid(w, torch.float32, data.device)
        gy, gx = torch.meshgrid(ys, xs, indexing="ij")
        theta = data.reshape(-1, 2, 3, 1, 1)
        return theta[:, :, 0] * gx + theta[:, :, 1] * gy + theta[:, :, 2]
    fh, fw = data.shape[2], data.shape[3]
    gy, gx = torch.meshgrid(_unit_grid(fh, data.dtype, data.device),
                            _unit_grid(fw, data.dtype, data.device),
                            indexing="ij")
    ident = torch.stack([gx, gy], dim=0)[None]
    flow = torch.stack([data[:, 0] * (2.0 / max(fw - 1, 1)),
                        data[:, 1] * (2.0 / max(fh - 1, 1))], dim=1)
    return ident + flow


@register("BilinearSampler", num_inputs=2)
def bilinear_sampler(data, grid):
    """``data`` (N, C, H, W) sampled bilinearly at ``grid`` (N, 2, Ho, Wo)
    in [-1, 1] (x then y; -1 and 1 the centres of the edge pixels), zero
    outside the image."""
    n, c, h, w = data.shape
    gx = (grid[:, 0] + 1.0) * (w - 1) / 2.0
    gy = (grid[:, 1] + 1.0) * (h - 1) / 2.0
    x0 = torch.floor(gx)
    y0 = torch.floor(gy)
    wx = gx - x0
    wy = gy - y0
    rows = torch.arange(n, device=data.device).reshape(n, 1, 1)

    def at(yi, xi):
        inb = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        yc = yi.clamp(0, h - 1).long()
        xc = xi.clamp(0, w - 1).long()
        vals = data[rows, :, yc, xc].movedim(-1, 1)       # (N, C, Ho, Wo)
        return torch.where(inb[:, None], vals, 0.0)

    out = (at(y0, x0) * ((1 - wx) * (1 - wy))[:, None]
           + at(y0, x0 + 1) * (wx * (1 - wy))[:, None]
           + at(y0 + 1, x0) * ((1 - wx) * wy)[:, None]
           + at(y0 + 1, x0 + 1) * (wx * wy)[:, None])
    return out.to(data.dtype)


@register("SpatialTransformer", num_inputs=2)
def spatial_transformer(data, loc, *, target_shape=(0, 0),
                        transform_type="affine", sampler_type="bilinear",
                        cudnn_off=False):
    """The affine spatial transformer: :func:`grid_generator` then
    :func:`bilinear_sampler`."""
    grid = grid_generator(loc, transform_type=transform_type,
                          target_shape=target_shape)
    return bilinear_sampler(data, grid.to(data.dtype))


@register("Correlation", num_inputs=2)
def correlation(data1, data2, *, kernel_size=1, max_displacement=1,
                stride1=1, stride2=1, pad_size=0, is_multiply=True):
    """FlowNet's correlation: for each displacement (dy, dx) in steps of
    ``stride2`` up to ``max_displacement``, the channel mean of
    ``data1 * shifted(data2)`` (or of ``|data1 - shifted(data2)|``
    without ``is_multiply``), averaged over a ``kernel_size`` window;
    reads past the padded image are zero, and the border where the
    windows fall off is cropped (H + 2 pad - 2 (d + kernel_size // 2))."""
    if stride1 != 1:
        raise NotImplementedError("Correlation: stride1 != 1")
    d, p = max_displacement, pad_size
    radius = kernel_size // 2
    x1 = F.pad(data1, (p, p, p, p))
    x2 = F.pad(data2, (p + d,) * 4)
    h, w = x1.shape[2], x1.shape[3]
    outs = []
    for dy in range(-d, d + 1, stride2):
        for dx in range(-d, d + 1, stride2):
            sh = x2[:, :, d + dy:d + dy + h, d + dx:d + dx + w]
            prod = x1 * sh if is_multiply else torch.abs(x1 - sh)
            m = torch.mean(prod, dim=1, keepdim=True)
            if kernel_size > 1:
                m = _window_sum(F.pad(m, (radius,) * 4),
                                (kernel_size,) * 2, (1, 1)) \
                    / float(kernel_size * kernel_size)
            outs.append(m[:, 0])
    out = torch.stack(outs, dim=1)
    border = d + radius
    if border:
        out = out[:, :, border:h - border, border:w - border]
    return out


@register("Crop", num_inputs=None)
def crop(data, *rest, offset=(0, 0), h_w=(0, 0), num_args=1,
         center_crop=False):
    """``data`` cut to ``h_w`` (or, with ``num_args=2``, to the second
    input's H and W) at ``offset``, or centred."""
    if rest and num_args == 2:
        th, tw = rest[0].shape[2], rest[0].shape[3]
    else:
        th, tw = int(h_w[0]), int(h_w[1])
    h, w = data.shape[2], data.shape[3]
    if center_crop:
        oy, ox = (h - th) // 2, (w - tw) // 2
    else:
        oy, ox = int(offset[0]), int(offset[1])
    return data[:, :, oy:oy + th, ox:ox + tw]


# -- the deformable convolutions (reference ops/nn.py:840-960) -----------------

def _deform_bilinear(data_g, y, x):
    """``data_g`` (B, dg, Cg, H, W) sampled at the pixel coordinates ``y``
    and ``x`` (B, dg, K, Ho, Wo), zero outside -> (B, dg, Cg, K, Ho, Wo):
    four corner gathers (their backward is a scatter-add, atomic on the
    card) weighted bilinearly."""
    b, dg, cg, h, w = data_g.shape
    flat = data_g.reshape(b, dg, cg, h * w)

    def corner(yi, xi):
        inb = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        yc = yi.clamp(0, h - 1).long()
        xc = xi.clamp(0, w - 1).long()
        idx = (yc * w + xc).reshape(b, dg, 1, -1).expand(b, dg, cg, -1)
        vals = torch.gather(flat, 3, idx).reshape((b, dg, cg)
                                                  + tuple(yi.shape[2:]))
        return torch.where(inb[:, :, None], vals, 0.0)

    y0 = torch.floor(y)
    x0 = torch.floor(x)
    wy = (y - y0)[:, :, None]
    wx = (x - x0)[:, :, None]
    return (corner(y0, x0) * (1 - wy) * (1 - wx)
            + corner(y0, x0 + 1) * (1 - wy) * wx
            + corner(y0 + 1, x0) * wy * (1 - wx)
            + corner(y0 + 1, x0 + 1) * wy * wx)


def _deform_conv(data, offset, weight, rest, mask, kernel, stride, dilate,
                 pad, num_group, num_deformable_group, no_bias):
    """The deformable convolution, v1 (``mask`` None) or v2: the sampled
    patches (B, C, K, Ho, Wo) from the corner gathers (times the mask),
    then one product over (C, K) a group."""
    kh, kw = kernel
    sh, sw = tuple(stride) if stride else (1, 1)
    dh, dw = tuple(dilate) if dilate else (1, 1)
    ph, pw = tuple(pad) if pad else (0, 0)
    b, c, h, w = data.shape
    dg = num_deformable_group
    k = kh * kw
    ho = (h + 2 * ph - ((kh - 1) * dh + 1)) // sh + 1
    wo = (w + 2 * pw - ((kw - 1) * dw + 1)) // sw + 1
    dev = data.device
    ys = torch.arange(ho, device=dev) * sh - ph
    xs = torch.arange(wo, device=dev) * sw - pw
    ry = torch.repeat_interleave(torch.arange(kh, device=dev) * dh, kw)
    rx = (torch.arange(kw, device=dev) * dw).repeat(kh)
    base_y = (ry[:, None, None] + ys[None, :, None]).float()
    base_x = (rx[:, None, None] + xs[None, None, :]).float()
    off = offset.reshape(b, dg, k, 2, ho, wo).float()
    y = base_y[None, None] + off[:, :, :, 0]
    x = base_x[None, None] + off[:, :, :, 1]
    patches = _deform_bilinear(data.reshape(b, dg, c // dg, h, w).float(),
                               y, x)
    if mask is not None:
        patches = patches * mask.reshape(b, dg, 1, k, ho, wo).float()
    patches = patches.reshape(b, c, k, ho, wo).to(data.dtype)
    ng = num_group
    o = weight.shape[0]
    cg, og = c // ng, o // ng
    # (g, og, cg * K) by (g, cg * K, B * Ho * Wo)
    pg = patches.reshape(b, ng, cg * k, ho * wo).permute(1, 2, 0, 3) \
        .reshape(ng, cg * k, b * ho * wo)
    wt = weight.reshape(ng, og, cg * k)
    out = ieee_f32(torch.bmm, wt, pg).reshape(ng, og, b, ho, wo) \
        .permute(2, 0, 1, 3, 4).reshape(b, o, ho, wo)
    if not no_bias:
        out = out + rest[0].reshape(1, -1, 1, 1)
    return out


@register("_contrib_DeformableConvolution", num_inputs=None)
def deformable_convolution(data, offset, weight, *rest, kernel=(),
                           stride=(), dilate=(), pad=(), num_filter=0,
                           num_group=1, num_deformable_group=1,
                           no_bias=False, workspace=0, layout=None):
    """Deformable convolution v1 (reference
    ``src/operator/contrib/deformable_convolution.cc``): each kernel tap
    samples the input at its place plus a learned offset, bilinearly,
    zero outside.  ``offset`` is (B, 2 * dg * kh * kw, Ho, Wo), (y, x)
    pairs a tap, taps row-major, a deformable group after another."""
    return _deform_conv(data, offset, weight, rest, None, kernel, stride,
                        dilate, pad, num_group, num_deformable_group,
                        no_bias)


@register("_contrib_ModulatedDeformableConvolution", num_inputs=None)
def modulated_deformable_convolution(data, offset, mask, weight, *rest,
                                     kernel=(), stride=(), dilate=(),
                                     pad=(), num_filter=0, num_group=1,
                                     num_deformable_group=1,
                                     no_bias=False, workspace=0,
                                     layout=None):
    """Deformable convolution v2 (reference
    ``modulated_deformable_convolution.cc``): v1's offsets and a per-tap
    modulation ``mask`` (B, dg * kh * kw, Ho, Wo), already through its
    sigmoid, scaling every sampled value."""
    return _deform_conv(data, offset, weight, rest, mask, kernel, stride,
                        dilate, pad, num_group, num_deformable_group,
                        no_bias)
