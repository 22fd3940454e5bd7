"""Int8 quantization operators and the int8 products, as the JAX
package's ``ops/quantization_ops.py`` and its int8 rule for ``dot``,
``batch_dot`` and ``Convolution`` (``_int8_acc``).

``_contrib_quantize``, ``_contrib_dequantize`` and ``_contrib_requantize``
are symmetric int8 against the signed range, with min and max as
one-element float32 arrays (the reference's layout for threading a
calibration through a graph).  ``torch.round`` rounds half to even, as
``jnp.round`` does.

An int8 x int8 product accumulates in int32 and returns int32, exactly:
:func:`int8_mm` is the one route.  On a CUDA tensor it is cuBLASLt's int8
GEMM through ``torch._int_mm`` (the way a float GEMM stays a library
call); that call wants more than 16 rows and inner and outer sizes that
are multiples of 8, so the operands are padded with zeros (exact) and the
result sliced: M to a multiple of 32, K and N to multiples of 16 (on an
H100, cuBLASLt refused M of 17, 24 or 40 with N above 16 and K up to 96,
and took every M, K, N so padded that was tried; ``chip_smoke.py``'s
``int8_parity`` phase tries such a grid again on each run).
There is no float route and no fallback: a CUDA product
without ``torch._int_mm`` raises.  On the CPU ``torch._int_mm`` is exact
at any size.  ``int_mm_launches`` counts the CUDA launches.
:func:`int8_convolution` is im2col in int8 (views through
``Tensor.unfold``, one copy into the GEMM's row-major layout), then
:func:`int8_mm`.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..base import MXNetError
from .registry import register

__all__ = ["quantize", "dequantize", "requantize", "int8_mm",
           "int8_tensordot", "int8_batch_matmul", "int8_convolution",
           "both_int8"]

_INT8_MAX = 127.0
_INT32_MAX = float(2 ** 31 - 1)

#: ``torch._int_mm`` launches on the card (the int8 GEMMs)
int_mm_launches = 0
#: the card's operands are padded to these multiples: rows (M), and the
#: inner and outer sizes (K, N)
INT_MM_ROWS = 32
INT_MM_COLS = 16


def both_int8(a, b):
    """Whether an ``a`` by ``b`` product takes the int8 route."""
    return a.dtype == torch.int8 and b.dtype == torch.int8


def _ceil_to(n, m):
    return -(-n // m) * m


def int8_mm(a, b):
    """(M, K) int8 by (K, N) int8 as (M, N) int32, exact."""
    global int_mm_launches
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise MXNetError(f"int8_mm: shapes {tuple(a.shape)} and "
                         f"{tuple(b.shape)} do not multiply")
    m, k = a.shape
    n = b.shape[1]
    if m == 0 or n == 0 or k == 0:
        return torch.zeros((m, n), dtype=torch.int32, device=a.device)
    if a.device.type != "cuda":
        return torch._int_mm(a.contiguous(), b.contiguous())
    if not hasattr(torch, "_int_mm"):
        raise MXNetError("this PyTorch has no torch._int_mm: the int8 "
                         "product on the card has no other route")
    mp, kp, np_ = (_ceil_to(m, INT_MM_ROWS), _ceil_to(k, INT_MM_COLS),
                   _ceil_to(n, INT_MM_COLS))
    if (mp, kp) != (m, k):
        a = F.pad(a, (0, kp - k, 0, mp - m))
    if (kp, np_) != (k, n):
        b = F.pad(b, (0, np_ - n, 0, kp - k))
    out = torch._int_mm(a.contiguous(), b.contiguous())
    int_mm_launches += 1
    return out[:m, :n] if (mp, np_) != (m, n) else out


def int8_tensordot(a, b):
    """The last axis of ``a`` contracted with the first of ``b`` (the
    ``dot`` rule), int8 in, int32 out."""
    k = a.shape[-1]
    out = int8_mm(a.reshape(-1, k), b.reshape(k, -1))
    return out.reshape(tuple(a.shape[:-1]) + tuple(b.shape[1:]))


def int8_batch_matmul(a, b):
    """``matmul`` of int8 ``a`` (..., M, K) and ``b`` (..., K, N), the
    batch axes broadcast: one int8 GEMM a batch entry."""
    if a.dim() < 2 or b.dim() < 2:
        raise MXNetError("batch_dot of int8 operands needs 2 or more axes "
                         "each")
    if a.dim() == 2 and b.dim() == 2:
        return int8_mm(a, b)
    batch = torch.broadcast_shapes(a.shape[:-2], b.shape[:-2])
    a3 = a.expand(batch + a.shape[-2:]).reshape(-1, *a.shape[-2:])
    b3 = b.expand(batch + b.shape[-2:]).reshape(-1, *b.shape[-2:])
    out = torch.stack([int8_mm(x, y) for x, y in zip(a3, b3)])
    return out.reshape(batch + (a.shape[-2], b.shape[-1]))


def int8_convolution(data, weight, stride, pad, dilate, groups=1):
    """Cross-correlation of int8 ``data`` (N, C, *spatial) with int8
    ``weight`` (O, C / groups, *kernel), symmetric zero padding, int32
    out (N, O, *out): im2col in int8, then :func:`int8_mm` a group."""
    n_sp = weight.dim() - 2
    kernel = tuple(weight.shape[2:])
    if any(pad):
        pads = []
        for p in reversed(pad):
            pads += [p, p]
        data = F.pad(data, pads)
    cols = data
    for i in range(n_sp):
        span = (kernel[i] - 1) * dilate[i] + 1
        cols = cols.unfold(2 + i, span, stride[i])
        if dilate[i] > 1:
            idx = [slice(None)] * cols.dim()
            idx[-1] = slice(None, None, dilate[i])
            cols = cols[tuple(idx)]
    # cols: (N, C, *out, *kernel) -> rows (N * prod(out)) of (C, *kernel)
    nb, c = cols.shape[:2]
    out_sp = tuple(cols.shape[2:2 + n_sp])
    order = (0, *range(2, 2 + n_sp), 1, *range(2 + n_sp, 2 + 2 * n_sp))
    cols = cols.permute(order)
    o = weight.shape[0]
    cg, og = c // groups, o // groups
    kk = math.prod(kernel)
    outs = []
    for g in range(groups):
        a = cols[..., g * cg:(g + 1) * cg, *([slice(None)] * n_sp)]
        a = a.reshape(-1, cg * kk)
        w = weight[g * og:(g + 1) * og].reshape(og, cg * kk)
        outs.append(int8_mm(a, w.t()))
    out = outs[0] if groups == 1 else torch.cat(outs, dim=1)
    out = out.reshape(nb, *out_sp, o)
    return out.permute(0, n_sp + 1, *range(1, n_sp + 1)).contiguous()


# -- the registry's quantization ops (reference quantize-inl.h,
#    dequantize-inl.h, requantize-inl.h) --------------------------------------

def _real_range(min_r, max_r):
    return torch.maximum(min_r.abs().max(), max_r.abs().max()).float()


@register("_contrib_quantize", num_inputs=3, num_outputs=3)
def quantize(data, min_range, max_range, *, out_type="int8"):
    """float32 -> (int8, min_out, max_out), symmetric against
    max(|min_range|, |max_range|)."""
    if out_type != "int8":
        raise ValueError("only int8 quantization is supported")
    r = _real_range(min_range, max_range)
    scale = torch.where(r > 0, _INT8_MAX / torch.clamp(r, min=1e-30),
                        torch.ones_like(r))
    q = torch.clamp(torch.round(data.float() * scale), -_INT8_MAX,
                    _INT8_MAX).to(torch.int8)
    return q, (-r).reshape(1), r.reshape(1)


@register("_contrib_dequantize", num_inputs=3)
def dequantize(data, min_range, max_range, *, out_type="float32"):
    if out_type != "float32":
        raise ValueError("only float32 dequantization is supported")
    r = _real_range(min_range, max_range)
    return data.float() * (r / _INT8_MAX)


@register("_contrib_requantize", num_inputs=3, num_outputs=3)
def requantize(data, min_range, max_range, *, min_calib_range=None,
               max_calib_range=None):
    """int32 accumulator -> (int8, min_out, max_out).  ``data``'s real
    value is ``data * real_range / (2^31 - 1)``.  With a calibrated range
    the rescale is static; otherwise it comes from the data (on the
    device).  A half-given calibration pair raises."""
    if (min_calib_range is None) != (max_calib_range is None):
        raise ValueError(
            "requantize: min_calib_range and max_calib_range must be "
            "given together (a half-supplied pair would silently fall "
            "back to dynamic ranges)")
    in_scale = _real_range(min_range, max_range) / _INT32_MAX
    real = data.float() * in_scale
    if min_calib_range is not None:
        out_r = max(abs(np.float32(min_calib_range)),
                    abs(np.float32(max_calib_range)), np.float32(1e-30))
        q = torch.round(real * float(np.float32(_INT8_MAX) / out_r))
        out_r = torch.full((1,), float(out_r), device=data.device)
    else:
        out_r = torch.clamp(real.abs().max(), min=1e-30).reshape(1)
        q = torch.round(real * (_INT8_MAX / out_r))
    q = torch.clamp(q, -_INT8_MAX, _INT8_MAX).to(torch.int8)
    return q, -out_r, out_r
