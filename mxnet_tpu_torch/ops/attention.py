"""Attention operators: scaled dot-product attention with its dispatch
to the flash kernel, and rotary position embedding.

``dot_product_attention`` sends every call the flash kernel can take
(:func:`_flash_viable`) to :func:`~.flash_attention.flash_attention`,
and every other call (the one-token decode step, a query-dependent
mask, unaligned lengths) to :func:`sdpa_plain`.  Both routes are
differentiable, the flash route through the backward kernels.
"""
from __future__ import annotations

import math

import torch

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
    scale = torch.tensor(scale, dtype=ct).item()
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
    dtype of float32 or bfloat16."""
    if q.shape[2] % k.shape[2]:
        return False  # ragged head grouping
    if q.dtype not in (torch.float32, torch.bfloat16) \
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
