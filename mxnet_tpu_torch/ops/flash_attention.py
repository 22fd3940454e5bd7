"""Flash-attention forward: a hand-written Hopper kernel
(``csrc/flash_fwd.cu``) and its plain PyTorch version.

The kernel streams K/V tiles through shared memory with an online
softmax and never writes the (S_q, S_k) score matrix to device memory.
:func:`flash_fwd` launches it for CUDA tensors and runs
:func:`flash_attention_plain` for CPU tensors; a CUDA tensor it cannot
take raises, it never falls back.  ``flash_fwd_launches`` counts kernel
launches, so a run can show that its attention went through the kernel.

Layout is (B, S, H, D) in and out.  Grouped-query attention is native:
K/V may carry fewer heads than Q, and query head h reads KV head
``h // (H // KV)``, so no repeated K/V is materialised.
"""
from __future__ import annotations

import ctypes
import math

import torch

from ..base import MXNetError

__all__ = ["flash_attention", "flash_attention_plain", "flash_fwd"]

#: kernel launches since the count was last set to 0 (plain-path calls
#: do not count)
flash_fwd_launches = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_NEG = -1e30
_kernel_fn = None


def _kernel():
    """(C function, block_q, block_k); builds the library at first use."""
    global _kernel_fn
    if _kernel_fn is None:
        from .._kernels import load
        lib = load("flash_fwd")
        fn = lib.mxtpu_flash_fwd
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
                       + [ctypes.c_longlong] * 9
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                          ctypes.c_void_p])
        for tile in (lib.mxtpu_flash_fwd_block_q,
                     lib.mxtpu_flash_fwd_block_k):
            tile.restype, tile.argtypes = ctypes.c_int, []
        _kernel_fn = (fn, lib.mxtpu_flash_fwd_block_q(),
                      lib.mxtpu_flash_fwd_block_k())
    return _kernel_fn


def flash_attention_plain(q, k, v, scale, causal=False, kmask=None,
                          window=None, want_lse=False):
    """The kernel's arithmetic in plain PyTorch, as one key tile:
    f32 scores, masked entries -1e30, ``p = exp(s - max)`` summed
    unrounded, P cast to the value type before ``P.V``, divided by the
    sum at the end.  Returns ``(out, lse)``; ``lse`` is (B*H, S_q) f32
    or None."""
    b, s_q, h, d = q.shape
    s_k, kv = k.shape[1], k.shape[2]
    g = h // kv
    qf = q.float().reshape(b, s_q, kv, g, d)
    s = torch.einsum("bqcgd,bkcd->bcgqk", qf, k.float()) * float(scale)
    if causal:
        from .attention import _causal_band
        keep = _causal_band(s_q, s_k, window, q.device)
        s = s.masked_fill(~keep, _NEG)
    if kmask is not None:
        km = (kmask.to(q.device) > 0).reshape(b, 1, 1, 1, s_k)
        s = s.masked_fill(~km, _NEG)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    p_op = p.to(v.dtype).float()
    o = torch.einsum("bcgqk,bkcd->bcgqd", p_op, v.float()) / l
    out = o.permute(0, 3, 1, 2, 4).reshape(b, s_q, h, d).to(q.dtype)
    lse = None
    if want_lse:
        lse = (m + torch.log(l)).reshape(b * h, s_q)
    return out, lse


def _check(q, k, v, kmask):
    dev = q.device
    for name, t in (("k", k), ("v", v)):
        if t.device != dev:
            raise MXNetError(f"flash_fwd: {name} on {t.device}, q on "
                             f"{dev}")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise MXNetError(
            "flash_fwd: q, k, v must share one dtype of float32 or "
            f"bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise MXNetError(
            f"flash_fwd: want q (B,S_q,H,D), k = v (B,S_k,KV,D); got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, s_q, h, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or h % k.shape[2]:
        raise MXNetError(
            f"flash_fwd: q {tuple(q.shape)} and k {tuple(k.shape)} "
            "disagree on batch or head dim, or H % KV != 0")
    if d % 8 or not 8 <= d <= 256:
        raise MXNetError(f"flash_fwd: head dim {d} must be a multiple "
                         "of 8 in [8, 256]")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise MXNetError(f"flash_fwd: {name}'s last dim must be "
                             "contiguous")
    if kmask is not None and tuple(kmask.shape) != (b, k.shape[1]):
        raise MXNetError(f"flash_fwd: kmask {tuple(kmask.shape)} must be "
                         f"(B, S_k) = {(b, k.shape[1])}")


def flash_fwd(q, k, v, scale, causal=False, kmask=None, window=None,
              want_lse=False):
    """One flash forward: the kernel for CUDA tensors, the plain version
    for CPU tensors.  Returns ``(out (B,S_q,H,D), lse (B*H,S_q) f32 or
    None)``.  ``window`` is None or a positive int (needs ``causal``)."""
    global flash_fwd_launches
    _check(q, k, v, kmask)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, scale, causal=causal,
                                     kmask=kmask, window=window,
                                     want_lse=want_lse)
    if q.device.type != "cuda":
        raise MXNetError(f"flash_fwd: no kernel for device {q.device}")
    fn, block_q, block_k = _kernel()
    b, s_q, h, d = q.shape
    s_k, kv = k.shape[1], k.shape[2]
    if s_q % block_q or s_k % block_k:
        raise MXNetError(
            f"flash_fwd: S_q={s_q} must be a multiple of {block_q} and "
            f"S_k={s_k} of {block_k}")
    out = torch.empty((b, s_q, h, d), dtype=q.dtype, device=q.device)
    lse = (torch.empty((b * h, s_q), dtype=torch.float32,
                       device=q.device) if want_lse else None)
    km = None
    if kmask is not None:
        km = kmask.to(device=q.device, dtype=torch.float32).contiguous()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                lse.data_ptr() if lse is not None else None,
                km.data_ptr() if km is not None else None,
                _DTYPE_CODES[q.dtype], b, h, kv, s_q, s_k, d,
                q.stride(0), q.stride(1), q.stride(2),
                k.stride(0), k.stride(1), k.stride(2),
                v.stride(0), v.stride(1), v.stride(2),
                float(scale), int(bool(causal)), int(window or 0), stream)
    if rc != 0:
        raise MXNetError(f"flash_fwd kernel launch failed: cudaError_t "
                         f"{rc} (q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"{q.dtype})")
    flash_fwd_launches += 1
    return out, lse


class _FlashFwd(torch.autograd.Function):
    """Forward-only for now: the backward kernels are still to port."""

    @staticmethod
    def forward(ctx, q, k, v, kmask, scale, causal, window):
        out, _ = flash_fwd(q, k, v, scale, causal=causal, kmask=kmask,
                           window=window)
        return out

    @staticmethod
    def backward(ctx, grad):
        raise MXNetError(
            "flash backward (K2/K3) is not ported yet; see ROADMAP")


def _window_arg(window, causal, s_k, who):
    """The sliding-window width, checked: None, or a positive int with
    ``causal``.  A band at least ``s_k`` wide is plain causal (None)."""
    if window is None:
        return None
    window = int(window)
    if not causal:
        raise MXNetError(f"{who}: window= requires causal=True (sliding "
                         "window is a banded causal mask)")
    if window <= 0:
        raise MXNetError(f"{who}: window must be positive, got {window}")
    return None if window >= s_k else window


def _as_key_padding(mask, batch=None, s_k=None, s_q=None):
    """(B, 1, 1, S_k) and (B, S_k) masks depend only on key position:
    the kernel takes those.  Anything query- or head-dependent returns
    None (plain path).  The result is broadcast to ``batch`` rows.

    A 2-D mask whose shape reads both as (B, S_k) key padding and as an
    (S_q, S_k) attention matrix (B == S_q > 1) is ambiguous and raises:
    reshape it to (B, 1, 1, S_k) or (1, 1, S_q, S_k)."""
    if mask is None:
        return None
    km = None
    if mask.dim() == 2:
        if batch is not None and s_k is not None and \
                tuple(mask.shape) == (batch, s_k):
            if s_q is not None and batch == s_q and batch > 1:
                raise MXNetError(
                    f"ambiguous 2-D attention mask {tuple(mask.shape)}: "
                    f"with batch == S_q == {batch} it reads equally as "
                    "(B, S_k) key padding or an (S_q, S_k) attention "
                    "matrix. Pass kmask=/reshape((B, 1, 1, S_k)) for "
                    "key padding, or reshape((1, 1, S_q, S_k)) for "
                    "attention-matrix semantics.")
            km = mask
    elif mask.dim() == 4 and mask.shape[1] == 1 and mask.shape[2] == 1:
        km = mask.reshape(mask.shape[0], mask.shape[3])
    if km is None:
        return None
    if batch is not None and km.shape[0] == 1 and batch > 1:
        km = km.expand((batch,) + tuple(km.shape[1:]))
    if batch is not None and km.shape[0] != batch:
        return None
    return km


def flash_attention(q, k, v, mask=None, scale=None, causal=False,
                    kmask=None, window=None):
    """Flash attention, (B, S, H, D) in and out.

    Key-padding masks ((B, 1, 1, S_k) or (B, S_k)) run inside the
    kernel; a query-dependent mask takes the plain path.  ``kmask``
    passes an already-normalised (B, S_k) key-padding mask.
    ``window``: sliding-window width, query i attends keys
    (i+off-W, i+off]; needs ``causal=True``.  The kernel skips
    out-of-band key tiles."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    window = _window_arg(window, causal, k.shape[1], "flash_attention")
    if kmask is None and mask is not None:
        kmask = _as_key_padding(mask, batch=q.shape[0], s_k=k.shape[1],
                                s_q=q.shape[1])
        if kmask is None:
            from .attention import sdpa_plain
            return sdpa_plain(q, k, v, mask, scale, causal, window=window)
    return _FlashFwd.apply(q, k, v, kmask, float(scale), bool(causal),
                           window)
