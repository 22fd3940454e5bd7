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

import torch
import torch.nn.functional as F

from ..base import MXNetError
from ..contrib import amp
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


@register("embedding", num_inputs=2)
def _embedding_op(data, weight, *, input_dim=0, output_dim=0,
                  dtype="float32", sparse_grad=False):
    return embedding(data, weight)


alias("Embedding", "embedding")


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
    card), as XLA generated it in the reference."""
    n = weight.dim() - 2
    data, weight, bias = amp.cast_inputs("Convolution", data, weight, bias)
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
               training=False):
    """Returns (out, mean, var): the batch's mean and **biased** variance
    over every axis but ``axis`` when ``training`` (and not
    ``use_global_stats``), else the moving ones, and
    ``out = (data - mean) / sqrt(var + eps) * gamma + beta`` (gamma taken
    as 1 with ``fix_gamma``, and then it gets no gradient).  Data of
    another type than gamma (bf16 under AMP, with f32 gamma) is promoted,
    as the reference's arithmetic promotes it.  No gradient flows into the
    moving statistics.  They are the caller's to update (:func:`update_moving_stats`): the op stays
    pure, and PyTorch's own update (unbiased, momentum ``1 - m``) is
    never used."""
    x = data.to(torch.promote_types(data.dtype, gamma.dtype))
    ax = axis % x.dim()
    if ax != 1:
        x = x.movedim(ax, 1)
    weight = None if fix_gamma else gamma
    if training and not use_global_stats:
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


@torch.no_grad()
def update_moving_stats(moving_mean, moving_var, mean, var, momentum):
    """``moving = momentum * moving + (1 - momentum) * batch`` in place,
    for the mean and the (biased) variance: the reference's update of
    its auxiliary states, outside the tape."""
    for moving, batch in ((moving_mean, mean), (moving_var, var)):
        moving.mul_(momentum).add_(batch.to(moving.dtype) * (1.0 - momentum))


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
    if axis_name is not None:
        raise MXNetError("chunked_softmax_ce: axis_name (a vocabulary "
                         "sharded over a tensor-parallel axis) is not "
                         "ported")
    return _ChunkedCE.apply(hidden, weight, bias, label, int(chunk))


@register("chunked_softmax_ce", num_inputs=3)
def chunked_softmax_ce(hidden, weight, label, *, chunk=8192,
                       axis_name=None):
    """Streaming large-vocabulary cross-entropy: per row,
    ``logsumexp(hidden @ weight.T) - (hidden @ weight.T)[label]`` without
    the (N, V) logits: the head is walked in slabs of about ``chunk``
    rows, and the backward recomputes each slab, so activation memory
    is O(N * chunk).  ``hidden`` (N, U); ``weight`` (V, U), the tied
    embedding or the head (both take gradients); ``label`` (N,) class
    ids.  Returns the per-row loss (N,), float32."""
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
