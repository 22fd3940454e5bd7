"""Attention operators: scaled dot-product attention with its dispatch
to the flash kernel, and rotary position embedding.

``dot_product_attention`` sends every call the flash kernel can take
(:func:`_flash_viable`) to :func:`~.flash_attention.flash_attention`,
and every other call (the one-token decode step, a query-dependent
mask, unaligned lengths) to :func:`sdpa_plain`.  Both routes are
differentiable, the flash route through the backward kernels.

Both are also registered ops (``mx.nd.dot_product_attention``,
``mx.nd.rope``) with the JAX package's signatures, for the
``hybrid_forward(F, ...)`` of the Llama blocks.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..base import MXNetError
from .registry import register

__all__ = ["dot_product_attention", "sdpa_plain", "rope"]

_NEG = -1e30


def _causal_band(s_q, s_k, window, device=None):
    """Causal mask, optionally banded: query i keeps keys in
    (i+off-window, i+off] with off = s_k - s_q (sliding window)."""
    ones = torch.ones((s_q, s_k), dtype=torch.bool, device=device)
    cm = torch.tril(ones, diagonal=s_k - s_q)
    if window is not None:
        cm &= ~torch.tril(ones, diagonal=s_k - s_q - int(window))
    return cm


def _round_scale(scale, dtype):
    """``scale`` rounded to ``dtype`` as ``torch.tensor(scale,
    dtype=dtype).item()`` rounds it (through float32, to nearest even),
    but on the host alone: a torch op here would be a host sync inside a
    captured body."""
    if dtype == torch.float64:
        return float(scale)
    f = np.float32(scale)
    if dtype == torch.bfloat16:
        bits = int(f.view(np.uint32))
        bits = (bits + 0x7FFF + ((bits >> 16) & 1)) & 0xFFFF0000
        return float(np.uint32(bits).view(np.float32))
    if dtype == torch.float16:
        return float(np.float16(f))
    return float(f)


def sdpa_plain(q, k, v, mask, scale, causal, window=None):
    """Plain attention over the (B, S, H, D) layout.

    Grouped-query attention is native: query heads are grouped per KV
    head in the einsum, with no repeated K/V.  The scores stay in the
    input type (the scale is cast to it), only the softmax runs in f32,
    and the probabilities are cast to the value type.  Masked logits
    are -1e30."""
    ct = torch.promote_types(q.dtype, k.dtype)
    qc, kc = q.to(ct), k.to(ct)
    # the scale rounded to the compute type, as a host number: a device
    # scalar built from a Python float would cost a blocking copy
    scale = _round_scale(scale, ct)
    neg = _NEG
    b, s_q, h, d = q.shape
    s_k, kv = k.shape[1], k.shape[2]
    if kv != h:
        g = h // kv
        qg = qc.reshape(b, s_q, kv, g, d)
        logits = torch.einsum("bqcgd,bkcd->bcgqk", qg, kc) * scale
        if causal:
            cm = _causal_band(s_q, s_k, window, q.device)
            logits = torch.where(cm[None, None, None], logits, neg)
        if mask is not None:
            m = mask.to(device=q.device, dtype=torch.bool)
            if m.dim() == 2:          # (S_q, S_k) broadcast form
                m = m[None, None]
            if m.shape[1] == 1:
                m = m[:, :, None]                     # (B,1,1,Sq,Sk)
            else:
                m = m.reshape(m.shape[0], kv, g, m.shape[2], m.shape[3])
            logits = torch.where(m, logits, neg)
        probs = torch.softmax(logits.float(), dim=-1)
        out = torch.einsum("bcgqk,bkcd->bqcgd", probs.to(v.dtype), v)
        return out.reshape(b, s_q, h, d).to(q.dtype)
    logits = torch.einsum("bqhd,bkhd->bhqk", qc, kc) * scale
    if causal:
        cm = _causal_band(s_q, s_k, window, q.device)
        logits = torch.where(cm[None, None], logits, neg)
    if mask is not None:
        logits = torch.where(mask.to(device=q.device, dtype=torch.bool),
                             logits, neg)
    probs = torch.softmax(logits.float(), dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype),
                        v).to(q.dtype)


def _flash_viable(q, k, v):
    """Shapes the flash kernel takes: both lengths multiples of 128,
    head dim a multiple of 8 up to 256, whole head groups, and one
    dtype of float32, bfloat16 or float16 (the reference's test does not
    look at the dtype; the kernels take these three)."""
    if q.shape[2] % k.shape[2]:
        return False  # ragged head grouping
    if q.dtype not in (torch.float32, torch.bfloat16, torch.float16) \
            or k.dtype != q.dtype or v.dtype != q.dtype:
        return False
    d = q.shape[-1]
    return (d % 8 == 0 and d <= 256 and q.shape[1] % 128 == 0
            and k.shape[1] % 128 == 0)


def dot_product_attention(query, key, value, mask=None, scale=None,
                          causal=False, window=None):
    """Multi-head scaled dot-product attention.

    Inputs are (batch, seq, heads, head_dim); K/V may carry fewer heads
    than Q (grouped-query attention).  ``mask`` is an optional boolean
    (batch, 1|heads, seq_q, seq_k) mask, or a (batch, seq_k) key-padding
    mask.  Causal masking is end-aligned.  ``window`` applies a
    sliding-window band to the causal mask (needs ``causal=True``).
    Under ``contrib.amp`` float32 inputs run in the AMP type.
    Returns (batch, seq_q, heads, head_dim)."""
    from ..contrib import amp
    from .flash_attention import _as_key_padding, _flash_apply, _window_arg
    if _any_dtensor(query, key, value, mask):
        return _on_local_heads(query, key, value, mask, scale, causal,
                               window)
    query, key, value = amp.cast_inputs("dot_product_attention", query,
                                        key, value)
    # validated once, for both routes: the plain path must not run a
    # band the kernel would reject
    window = _window_arg(window, causal, key.shape[1],
                         "dot_product_attention")
    d = query.shape[-1]
    s = scale if scale is not None else 1.0 / math.sqrt(d)
    kmask = _as_key_padding(mask, batch=query.shape[0],
                            s_k=key.shape[1], s_q=query.shape[1])
    if (mask is None or kmask is not None) \
            and _flash_viable(query, key, value):
        return _flash_apply(query, key, value, kmask, s, causal, window)
    if kmask is not None and mask.dim() == 2:
        mask = mask.reshape(mask.shape[0], 1, 1, mask.shape[1])
    return sdpa_plain(query, key, value, mask, s, causal, window=window)


def _any_dtensor(*ts):
    # a DTensor is a torch.Tensor subclass: a plain tensor is ruled out
    # without importing torch.distributed
    if all(t is None or type(t) is torch.Tensor for t in ts):
        return False
    from torch.distributed.tensor import DTensor
    return any(isinstance(t, DTensor) for t in ts)


def _on_local_heads(query, key, value, mask, scale, causal, window):
    """Attention of ``DTensor`` inputs (a sharded layout of
    ``DataParallelTrainer``): each rank runs the kernels on its own batch
    rows and heads, the dimensions the layout may shard; q, k and v
    sharded anywhere else (or unlike each other) are gathered first.
    The output is sharded as the inputs were."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    ref = next(t for t in (query, key, value, mask)
               if isinstance(t, DTensor))
    dm = ref.device_mesh

    def as_dt(t):
        return t if isinstance(t, DTensor) else DTensor.from_local(
            t, dm, [Replicate()] * dm.ndim)

    q, k, v = as_dt(query), as_dt(key), as_dt(value)
    want = []
    for i in range(dm.ndim):
        pl = q.placements[i]
        keep = isinstance(pl, Shard) and pl.dim in (0, 2) and \
            k.placements[i] == pl and v.placements[i] == pl
        want.append(pl if keep else Replicate())
    q, k, v = (t.redistribute(dm, want) for t in (q, k, v))
    m = None
    if mask is not None:
        m = as_dt(mask)
        per_head = m.dim() == 4 and m.shape[1] == q.shape[2] > 1
        m = m.redistribute(dm, [
            Shard(0) if w == Shard(0) else
            Shard(1) if w == Shard(2) and per_head else Replicate()
            for w in want]).to_local()
    out = dot_product_attention(q.to_local(), k.to_local(), v.to_local(),
                                m, scale=scale, causal=causal,
                                window=window)
    return DTensor.from_local(out, dm, want)


@register("dot_product_attention", num_inputs=None)
def _dot_product_attention_op(query, key, value, *rest, num_heads=1,
                              scale=None, causal=False, use_mask=False,
                              flash=True, window=None):
    """The registered op: the mask is the fourth input when
    ``use_mask``.  ``flash=False`` is not ported: on the card a call the
    kernel takes runs the kernel."""
    if not flash:
        raise MXNetError("dot_product_attention(flash=False) is not "
                         "ported: a call the flash kernel takes runs it")
    mask = rest[0] if use_mask and rest else None
    return dot_product_attention(query, key, value, mask, scale=scale,
                                 causal=causal, window=window)


@register("rope", num_inputs=1, scalar_attrs=("offset",),
          scalar_ref_input=None)
def _rope_op(x, offset=0, *, base=10000.0):
    return rope(x, offset, base=base)


def rope(x, offset=0, base=10000.0):
    """Rotary position embedding over (B, S, H, D): rotates ADJACENT
    feature pairs (x[..., 0::2], x[..., 1::2]) by position-dependent
    angles.  ``offset`` shifts positions: a number, a 0-d tensor, or a
    (B,) tensor giving each batch row its own position."""
    s, d = x.shape[1], x.shape[-1]
    dev = x.device
    base_pos = torch.arange(s, dtype=torch.float32, device=dev)
    # Python numbers enter as float32 scalars of the ops: no device
    # tensor is built from the host (a blocking copy)
    if torch.is_tensor(offset):
        off = offset.to(device=dev, dtype=torch.float32)
    else:
        off = float(offset)
    if torch.is_tensor(off) and off.dim():
        pos = base_pos[None, :] + off.reshape(-1, 1)        # (B, S)
    else:
        pos = (base_pos + off)[None, :]                     # (1, S)
    inv = torch.pow(float(base),
                    -torch.arange(0, d, 2, dtype=torch.float32,
                                  device=dev) / float(d))
    ang = pos[..., None] * inv                              # (B|1, S, D/2)
    cos = torch.cos(ang)[:, :, None, :].to(x.dtype)
    sin = torch.sin(ang)[:, :, None, :].to(x.dtype)
    x1 = x[..., 0::2]
    x2 = x[..., 1::2]
    r1 = x1 * cos - x2 * sin
    r2 = x1 * sin + x2 * cos
    return torch.stack([r1, r2], dim=-1).reshape(x.shape)


# -- the interleaved self-attention products (reference transformer.cc) --------

def _heads(qkv, heads):
    s, b, e3 = qkv.shape
    return qkv.reshape(s, b, heads, 3, e3 // 3 // heads)


@register("interleaved_matmul_selfatt_qk", num_inputs=1)
def interleaved_matmul_selfatt_qk(queries_keys_values, *, heads=1):
    """(S, B, 3 E) with Q, K and V interleaved a head -> the scaled scores
    (B * heads, S, S), float32 products without TF32 on the card."""
    from .nn import ieee_f32
    s, b, e3 = queries_keys_values.shape
    d = e3 // 3 // heads

    def f(x):
        qkv = _heads(x, heads)
        scores = torch.einsum("sbhd,tbhd->bhst", qkv[:, :, :, 0],
                              qkv[:, :, :, 1])
        return (scores * (1.0 / math.sqrt(d))).reshape(b * heads, s, s)
    return ieee_f32(f, queries_keys_values)


@register("interleaved_matmul_selfatt_valatt", num_inputs=2)
def interleaved_matmul_selfatt_valatt(queries_keys_values, attention, *,
                                      heads=1):
    """The attention (B * heads, S, S) applied to the interleaved V ->
    (S, B, E)."""
    from .nn import ieee_f32
    s, b, e3 = queries_keys_values.shape

    def f(x, att):
        v = _heads(x, heads)[:, :, :, 2]
        out = torch.einsum("bhst,tbhd->sbhd", att.reshape(b, heads, s, s),
                           v)
        return out.reshape(s, b, e3 // 3)
    return ieee_f32(f, queries_keys_values, attention)
