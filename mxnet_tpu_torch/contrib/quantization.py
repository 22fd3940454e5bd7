"""Int8 quantization, as the JAX package's ``contrib/quantization.py``
(the reference's ``contrib.quantization``).

Symmetric int8 with min/max or entropy (KL) calibration over a
calibration iterator, and ``quantize_model``, which maps a net's
``Dense`` and ``Conv2D`` layers to int8 layers: the input quantized per
tensor on the device, the weights per output channel once, the product
in int8 with int32 accumulation (``dot`` and ``Convolution`` on int8
operands: cuBLASLt's int8 GEMM on the card, ``ops/quantization_ops.py``),
then one rescale to float32.  A ``BatchNorm`` that follows a ``Conv2D``
in a ``(Hybrid)Sequential`` is folded into the conv's weights first.

The port's layers take and give tensors inside a call, so the int8
layers and the calibration hooks work on tensors; the calibration itself
is the JAX package's numpy code.  The dynamic range of an uncalibrated
layer stays on the device (no host read a forward).
"""
from __future__ import annotations

import numpy as np
import torch

from ..base import MXNetError
from ..ndarray.ndarray import NDArray, array
from ..ops import nn as _ops
from ..ops import quantization_ops as _q

__all__ = ["quantize_array", "dequantize_array", "calib_minmax",
           "calib_entropy", "quantize_model", "quantize_net",
           "QuantizedDense", "QuantizedConv", "QuantizedNet"]


def _host(a):
    """``a`` (an NDArray, a tensor or array-like) as a numpy array."""
    if isinstance(a, NDArray):
        return a.asnumpy()
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def quantize_array(arr, min_range=None, max_range=None, axis=None):
    """Symmetric int8 quantization -> (q_int8 NDArray, scale), on
    ``arr``'s context.  With ``axis``, one scale for each index of that
    axis (channel-wise weights): ``scale`` is then a float32 array of
    that axis' length."""
    a = _host(arr)
    ctx = arr.context if isinstance(arr, NDArray) else None
    if axis is not None:
        red = tuple(i for i in range(a.ndim) if i != axis)
        amax = np.max(np.abs(a), axis=red)
        scale = np.where(amax > 0, amax / 127.0, 1.0)
        shape = [1] * a.ndim
        shape[axis] = -1
        q = np.clip(np.round(a / scale.reshape(shape)), -127,
                    127).astype(np.int8)
        return array(q, ctx=ctx, dtype="int8"), scale.astype(np.float32)
    amax = float(np.max(np.abs(a))) if max_range is None else \
        max(abs(min_range), abs(max_range))
    scale = amax / 127.0 if amax > 0 else 1.0
    q = np.clip(np.round(a / scale), -127, 127).astype(np.int8)
    return array(q, ctx=ctx, dtype="int8"), scale


def dequantize_array(q, scale):
    return q.astype("float32") * scale


def calib_minmax(arrays):
    """Min/max calibration thresholds over a stream of arrays."""
    lo, hi = np.inf, -np.inf
    for a in arrays:
        v = _host(a)
        lo = min(lo, float(v.min()))
        hi = max(hi, float(v.max()))
    return lo, hi


def calib_entropy(arrays, num_bins=2048, num_quantized_bins=255):
    """KL-divergence (entropy) calibration threshold, the reference's
    default mode: the threshold whose int8 reconstruction of the
    histogram (clipped mass folded into the last bin) diverges least.
    Exact zeros (ReLU's dead mass) carry no information about the scale
    and are left out."""
    vals = np.concatenate([np.abs(_host(a)).ravel() for a in arrays])
    amax = float(vals.max()) if vals.size else 1.0
    if amax == 0:
        return 0.0, 0.0
    vals = vals[vals > 0]
    hist, edges = np.histogram(vals, bins=num_bins, range=(0, amax))
    best_kl, best_t = np.inf, amax
    for i in range(num_quantized_bins, num_bins + 1, 16):
        t = edges[i]
        raw = hist[:i].astype(np.float64)
        p = raw.copy()
        p[-1] += hist[i:].sum()
        if p.sum() == 0:
            continue
        # the int8 reconstruction: each of the 255 groups of bins (the
        # last takes the remainder) spreads its mass over its non-empty
        # bins.  The counts are integers, so the group sums are exact in
        # any order: the same q as the reference's loop over the groups.
        nm = i // num_quantized_bins
        starts = np.arange(num_quantized_bins) * nm
        sizes = np.diff(np.append(starts, i))
        mass = np.add.reduceat(raw, starts)
        nz = np.add.reduceat((raw > 0).astype(np.int64), starts)
        level = np.divide(mass, nz, out=np.zeros_like(mass), where=nz > 0)
        q = np.where(raw > 0, np.repeat(level, sizes), 0.0)
        if q.sum() == 0:
            continue
        pn = _smooth(p / p.sum())
        qn = _smooth(q / q.sum())
        kl = float(np.sum(pn * np.log(pn / qn)))
        if kl < best_kl:
            best_kl, best_t = kl, t
    return -best_t, best_t


def _smooth(d, eps=1e-4):
    """Give empty bins a little mass (the reference's
    ``_smooth_distribution``), so a support mismatch costs a finite KL."""
    is_zero = d == 0
    n_zero = int(is_zero.sum())
    n_nonzero = d.size - n_zero
    if n_zero == 0 or n_nonzero == 0:
        return d
    out = d.copy()
    out[is_zero] = eps
    out[~is_zero] = np.maximum(out[~is_zero] - eps * n_zero / n_nonzero,
                               eps)
    return out


def _quantize_act(x, scale=None):
    """Per-tensor int8 quantization of the tensor ``x`` on its device ->
    (int8 tensor, scale): ``scale`` the calibrated one (a 0-d float32
    tensor on ``x``'s device), else the input's own range.  The division
    is by a device tensor, a true division on the CPU and the card alike
    (a Python number on the card is a multiplication by its reciprocal,
    which rounds a code the other way now and then)."""
    if scale is None:
        scale = torch.clamp(torch.max(torch.abs(x)), min=1e-30) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


class _Int8Layer:
    """The calibrated range of an int8 layer's input (``_calib``, (lo, hi)
    or None) and its scale as a device tensor, made when the range is
    set."""

    def _set_calib(self, calib, device):
        self._device = device
        self._calib = calib

    @property
    def _calib(self):
        return self._calib_range

    @_calib.setter
    def _calib(self, calib):
        self._calib_range = calib
        self._x_scale = None
        if calib is not None:
            r = max(abs(float(calib[0])), abs(float(calib[1])))
            self._x_scale = torch.tensor(r / 127.0 if r > 0 else 1.0,
                                         dtype=torch.float32,
                                         device=self._device)


def _activation(layer):
    """The layer's fused activation as a function of a tensor, or None."""
    act = getattr(layer, "act", None)
    if act is not None:
        return act
    name = getattr(layer, "_act", None)
    if name is None:
        return None
    return lambda t: _ops.activation(t, name)


class QuantizedDense(_Int8Layer):
    """A ``Dense`` layer's int8 forward (inference only): int8 weights
    with one scale an output row, the input quantized at each call."""

    def __init__(self, dense, calib_range=None):
        w = dense.weight.data()
        self.wq, self.w_scale = quantize_array(w, axis=0)
        dev = w.tensor.device
        # (in, out): the int8 GEMM's right operand, made once
        self._wq_t = self.wq.tensor.t().contiguous()
        self._w_scale_t = torch.from_numpy(
            self.w_scale.reshape(1, -1)).to(dev)
        self.bias = dense.bias.data() if dense.bias is not None else None
        self._act = _activation(dense)
        self._flatten = getattr(dense, "_flatten", True)
        self._set_calib(calib_range, dev)

    @torch.no_grad()
    def __call__(self, x):
        if self._flatten and x.dim() > 2:
            x = x.reshape(x.shape[0], -1)
        xq, x_scale = _quantize_act(x, self._x_scale)
        k = xq.shape[-1]
        out = _q.int8_mm(xq.reshape(-1, k), self._wq_t).reshape(
            tuple(xq.shape[:-1]) + (self._wq_t.shape[1],))
        out = out.float() * self._w_scale_t * x_scale
        if self.bias is not None:
            out = out + self.bias.tensor
        if self._act is not None:
            out = self._act(out)
        return out


class QuantizedConv(_Int8Layer):
    """A ``Conv2D`` layer's int8 forward (inference only), with the
    following ``BatchNorm`` (``fold_bn``) folded into its weights and bias
    before the weights are quantized, one scale an output channel; the
    int8 convolution accumulates in int32, then one rescale by
    ``w_scale * x_scale`` restores float32."""

    def __init__(self, conv, calib_range=None, fold_bn=None):
        wd = conv.weight.data()
        w = wd.asnumpy()
        bias = conv.bias.data().asnumpy() if conv.bias is not None \
            else None
        if fold_bn is not None:
            g = fold_bn.gamma.data().asnumpy()
            if fold_bn._kwargs.get("fix_gamma"):
                # scale=False: the live op uses ones, not the stored gamma
                g = np.ones_like(g)
            b = fold_bn.beta.data().asnumpy()
            mu = fold_bn.running_mean.data().asnumpy()
            var = fold_bn.running_var.data().asnumpy()
            eps = fold_bn._kwargs.get("eps", 1e-5)
            s = g / np.sqrt(var + eps)
            w = w * s.reshape(-1, 1, 1, 1)
            bias = ((bias if bias is not None else 0.0) - mu) * s + b
        self.wq, self.w_scale = quantize_array(array(w, ctx=wd.context),
                                               axis=0)
        dev = wd.tensor.device
        self._w_scale_t = torch.from_numpy(
            self.w_scale.reshape(1, -1, 1, 1)).to(dev)
        self.bias = array(bias, ctx=wd.context) if bias is not None \
            else None
        self._act = _activation(conv)
        self._conv = dict(conv._conv)
        self._set_calib(calib_range, dev)

    @torch.no_grad()
    def __call__(self, x):
        xq, x_scale = _quantize_act(x, self._x_scale)
        out = _ops.convolution(xq, self.wq.tensor, None, **self._conv)
        out = out.float() * self._w_scale_t * x_scale
        if self.bias is not None:
            out = out + self.bias.tensor.reshape(1, -1, 1, 1)
        if self._act is not None:
            out = self._act(out)
        return out


def _walk(block):
    yield block
    for child in block._child_blocks():
        yield from _walk(child)


def quantize_model(net, calib_data=None, calib_mode="naive",
                   num_calib_batches=None, quantized_dtype="int8"):
    """Map the ``Dense`` and ``Conv2D`` layers of the un-hybridized
    ``net`` to int8 layers: ``{block: int8 callable}`` (a folded
    ``BatchNorm`` maps to the identity).  With ``calib_data`` (an
    iterator of input batches) each layer's input range is calibrated:
    ``"naive"`` (min/max) or ``"entropy"`` (KL); a layer without a range
    takes its range from each call's input."""
    from ..gluon import nn as gnn
    if quantized_dtype != "int8":
        raise MXNetError("only int8 quantization is supported")
    # a hybridized net replays its captured graph: the hooks and the
    # int8 layers would be bypassed
    if any(getattr(b, "_active", False) for b in _walk(net)):
        raise MXNetError(
            "quantize_model requires an un-hybridized net (the cached "
            "graph bypasses the int8 layer swap); call "
            "net.hybridize(False) first")
    targets = [b for b in _walk(net)
               if isinstance(b, (gnn.Dense, gnn.Conv2D))]
    calib = {}
    if calib_data is not None:
        taps = {id(d): [] for d in targets}
        hooks = []
        for d in targets:
            def mk(d):
                def hook(block, inputs):
                    taps[id(d)].append(inputs[0].detach())
                return hook
            hooks.append(d.register_forward_pre_hook(mk(d)))
        for i, batch in enumerate(calib_data):
            if num_calib_batches is not None and i >= num_calib_batches:
                break
            net(batch if isinstance(batch, NDArray) else batch[0])
        for h in hooks:
            h.detach()
        for d in targets:
            xs = taps[id(d)]
            if not xs:
                continue             # not reached: dynamic ranges
            calib[id(d)] = (calib_minmax(xs) if calib_mode == "naive"
                            else calib_entropy(xs))
    pairs = _conv_bn_pairs(net)
    layer_map = {}
    for d in targets:
        if isinstance(d, gnn.Dense):
            layer_map[d] = QuantizedDense(d, calib.get(id(d)))
        else:
            # a fused activation runs before the BatchNorm: no fold then
            bn = pairs.get(d) if getattr(d, "act", None) is None \
                else None
            layer_map[d] = QuantizedConv(d, calib.get(id(d)), fold_bn=bn)
            if bn is not None:
                layer_map[bn] = _bn_identity
    return layer_map


def _bn_identity(x):
    return x


def _conv_bn_pairs(net):
    """``{Conv2D: BatchNorm}`` for each Conv2D followed by a channel-axis
    BatchNorm in a ``(Hybrid)Sequential``, the only containers whose
    order is their dataflow."""
    from ..gluon import nn as gnn
    pairs = {}
    for block in _walk(net):
        if not isinstance(block, (gnn.HybridSequential, gnn.Sequential)):
            continue
        kids = list(block._child_blocks())
        for a, b in zip(kids, kids[1:]):
            if isinstance(a, gnn.Conv2D) and isinstance(b, gnn.BatchNorm) \
                    and getattr(b, "_axis", 1) == 1:
                pairs[a] = b
    return pairs


class QuantizedNet:
    """The int8 net: while called, each mapped layer's ``forward`` is its
    int8 callable, so the original (un-hybridized) net runs end to end
    with int8 ``Dense`` and ``Conv2D`` products."""

    def __init__(self, net, layer_map):
        self.net = net
        self.layer_map = layer_map

    def __call__(self, x):
        saved = {}
        try:
            for blk, q in self.layer_map.items():
                saved[blk] = blk.__dict__.get("forward")
                blk.forward = q
            return self.net(x)
        finally:
            for blk, prev in saved.items():
                if prev is None:
                    blk.__dict__.pop("forward", None)
                else:
                    blk.forward = prev


def quantize_net(net, calib_data=None, calib_mode="naive",
                 num_calib_batches=None, quantized_dtype="int8"):
    """Calibrate and quantize ``net``: a runnable :class:`QuantizedNet`
    (the reference's calibrate -> swap int8 layers -> infer flow)."""
    return QuantizedNet(net, quantize_model(
        net, calib_data=calib_data, calib_mode=calib_mode,
        num_calib_batches=num_calib_batches,
        quantized_dtype=quantized_dtype))
