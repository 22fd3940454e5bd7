"""Flash attention: hand-written Hopper kernels for the forward
(``csrc/flash_fwd.cu``) and the backward (``csrc/flash_bwd.cu``), and
their plain PyTorch versions.

The forward streams K/V tiles through shared memory with an online
softmax and never writes the (S_q, S_k) score matrix to device memory;
it saves the per-row log-sum-exp when a gradient is needed.  The
backward recomputes the scores from it: one kernel for Delta and dQ,
one for dK and dV.  :func:`flash_fwd` and :func:`flash_bwd` launch the
kernels for CUDA tensors and run :func:`flash_attention_plain` and
:func:`flash_bwd_plain` for CPU tensors; a CUDA tensor the kernels
cannot take raises, they never fall back.

The library picks each kernel's route by dtype: bf16 and float16 run
the forward, the dQ pass and the dK/dV pass on the tensor cores
(mma.sync, f32 accumulation), f32 on the CUDA cores in f32 FMAs (the
tensor cores would take f32 only as TF32, which the kernel contract
forbids).  The float16 route rounds P (and in the backward dS) to
float16 for the tensor cores where the JAX package keeps them in f32: at
most 2^-11 relative on each element, and the plain versions round the
same way.  ``flash_fwd_launches`` and
``flash_bwd_launches`` count kernel launches (one dQ and dK/dV pair per
backward launch), ``flash_bwd_dq_launches`` and
``flash_bwd_dkv_launches`` each backward kernel's own, and
``flash_fwd_tc_launches``, ``flash_bwd_dq_tc_launches`` and
``flash_bwd_dkv_tc_launches`` those that took the tensor-core route
(bf16 and float16 alike), so a run can show which kernels its attention
went through.

Layout is (B, S, H, D) in and out.  Grouped-query attention is native:
K/V may carry fewer heads than Q, and query head h reads KV head
``h // (H // KV)``, so no repeated K/V is materialised.
"""
from __future__ import annotations

import ctypes
import math

import torch

from ..base import MXNetError

__all__ = ["flash_attention", "flash_attention_plain", "flash_fwd",
           "flash_bwd", "flash_bwd_plain"]

#: kernel launches since the count was last set to 0 (plain-path calls
#: do not count)
flash_fwd_launches = 0
#: backward launches, each one dQ and one dK/dV kernel, since the count
#: was last set to 0 (plain-path calls do not count)
flash_bwd_launches = 0
#: launches of K2 (dQ) and of K3 (dK, dV) alone, by their wrappers
flash_bwd_dq_launches = 0
flash_bwd_dkv_launches = 0
#: the forward's, K2's and K3's launches that took the tensor-core route
flash_fwd_tc_launches = 0
flash_bwd_dq_tc_launches = 0
flash_bwd_dkv_tc_launches = 0

#: S_q and S_k must be multiples of these for the kernels: the largest
#: tiles of either route (the libraries export the same numbers)
FWD_BLOCK_Q = FWD_BLOCK_K = 64
BWD_BLOCK_Q = BWD_BLOCK_K = 64

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_NEG = -1e30
_fwd_lib = None
_bwd_lib = None


def _int_fns(lib, *names):
    for name in names:
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_int] if name.endswith("_tc") else []


def _bind_fwd(lib):
    """Declare the C signatures of the forward's library."""
    fn = lib.mxtpu_flash_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
                   + [ctypes.c_longlong] * 9
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                      ctypes.c_void_p])
    _int_fns(lib, "mxtpu_flash_fwd_block_q", "mxtpu_flash_fwd_block_k",
             "mxtpu_flash_fwd_tc")
    return lib


def _bind_bwd(lib):
    """Declare the C signatures of the backward's library."""
    tail = ([ctypes.c_int] * 7 + [ctypes.c_longlong] * 15
            + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    dq, dkv = lib.mxtpu_flash_bwd_dq, lib.mxtpu_flash_bwd_dkv
    dq.restype = dkv.restype = ctypes.c_int
    dq.argtypes = [ctypes.c_void_p] * 9 + tail
    dkv.argtypes = [ctypes.c_void_p] * 10 + tail
    _int_fns(lib, "mxtpu_flash_bwd_block_q", "mxtpu_flash_bwd_block_k",
             "mxtpu_flash_bwd_dq_tc", "mxtpu_flash_bwd_dkv_tc")
    return lib


def _kernel():
    """The forward's library (``mxtpu_flash_fwd`` and its tile and
    route queries), built at first use."""
    global _fwd_lib
    if _fwd_lib is None:
        from .._kernels import load
        _fwd_lib = _bind_fwd(load("flash_fwd"))
    return _fwd_lib


def _bwd_kernels():
    """The backward's library (``mxtpu_flash_bwd_dq``,
    ``mxtpu_flash_bwd_dkv`` and their tile and route queries), built at
    first use."""
    global _bwd_lib
    if _bwd_lib is None:
        from .._kernels import load
        _bwd_lib = _bind_bwd(load("flash_bwd"))
    return _bwd_lib


def _check_tiles(s_q, s_k, block_q, block_k, who):
    if s_q % block_q or s_k % block_k:
        raise MXNetError(
            f"{who}: S_q={s_q} must be a multiple of {block_q} and "
            f"S_k={s_k} of {block_k}")


def _aligned(t, dims=3):
    """``t`` as the tensor-core kernels read it, 16 bytes at a time: a
    16-byte aligned pointer and its first ``dims`` strides multiples of
    8 elements.  A tensor that is not is copied to a fresh contiguous
    one; the kernels never read around it."""
    if t.data_ptr() % 16 or any(s % 8 for s in t.stride()[:dims]):
        return t.clone(memory_format=torch.contiguous_format)
    return t


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
    keep = _keep(b, s_q, s_k, causal, kmask, window, q.device)
    if keep is not None:
        s = s.masked_fill(~keep, _NEG)
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


def _keep(b, s_q, s_k, causal, kmask, window, device):
    """The (B, 1, 1, S_q, S_k) mask of visible pairs (causal band,
    window, key padding), or None when every pair is visible."""
    keep = None
    if causal:
        from .attention import _causal_band
        keep = _causal_band(s_q, s_k, window, device)
    if kmask is not None:
        km = (kmask.to(device) > 0).reshape(b, 1, 1, 1, s_k)
        keep = km if keep is None else keep & km
    return keep


def _delta(g, out):
    """Delta = rowsum(dO * O) in float32, as (B*H, S_q).  The JAX package
    computes it outside its kernels; on the card K2 computes it for its
    own query rows and hands it to K3."""
    b, s_q, h, _ = g.shape
    return torch.einsum("bqhd,bqhd->bhq", g.float(),
                        out.float()).reshape(b * h, s_q)


def flash_bwd_plain(q, k, v, out, lse, g, scale, causal=False, kmask=None,
                    window=None):
    """The backward kernels' arithmetic in plain PyTorch, as one tile:
    ``P = exp(scale*QK^T - lse)`` with masked entries exactly 0,
    ``dS = P * (dO V^T - Delta)``, and P and dS rounded to the input type
    before ``P^T dO``, ``dS K`` and ``dS^T Q`` (f32 accumulation).  K/V
    gradients are summed over each group of query heads.  Returns
    ``(dq, dk, dv)`` in the input type."""
    b, s_q, h, d = q.shape
    s_k, kv = k.shape[1], k.shape[2]
    grp = h // kv
    scale = float(scale)
    qf = q.float().reshape(b, s_q, kv, grp, d)
    gf = g.float().reshape(b, s_q, kv, grp, d)
    kf, vf = k.float(), v.float()
    s = torch.einsum("bqcgd,bkcd->bcgqk", qf, kf) * scale
    p = torch.exp(s - lse.reshape(b, kv, grp, s_q, 1))
    keep = _keep(b, s_q, s_k, causal, kmask, window, q.device)
    if keep is not None:
        p = torch.where(keep, p, 0.0)
    dp = torch.einsum("bqcgd,bkcd->bcgqk", gf, vf)
    ds = p * (dp - _delta(g, out).reshape(b, kv, grp, s_q, 1))

    def op(t):                 # an operand, rounded to the input type
        return t.to(q.dtype).float()

    dq = torch.einsum("bcgqk,bkcd->bqcgd", op(ds), kf) * scale
    dk = torch.einsum("bcgqk,bqcgd->bkcd", op(ds), qf) * scale
    dv = torch.einsum("bcgqk,bqcgd->bkcd", op(p), gf)
    return (dq.reshape(b, s_q, h, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def _check(q, k, v, kmask, who="flash_fwd"):
    dev = q.device
    for name, t in (("k", k), ("v", v)):
        if t.device != dev:
            raise MXNetError(f"{who}: {name} on {t.device}, q on {dev}")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise MXNetError(
            f"{who}: q, k, v must share one dtype of float32, "
            f"bfloat16 or float16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise MXNetError(
            f"{who}: want q (B,S_q,H,D), k = v (B,S_k,KV,D); got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, s_q, h, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or h % k.shape[2]:
        raise MXNetError(
            f"{who}: q {tuple(q.shape)} and k {tuple(k.shape)} "
            "disagree on batch or head dim, or H % KV != 0")
    if d % 8 or not 8 <= d <= 256:
        raise MXNetError(f"{who}: head dim {d} must be a multiple "
                         "of 8 in [8, 256]")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise MXNetError(f"{who}: {name}'s last dim must be "
                             "contiguous")
    if kmask is not None and tuple(kmask.shape) != (b, k.shape[1]):
        raise MXNetError(f"{who}: kmask {tuple(kmask.shape)} must be "
                         f"(B, S_k) = {(b, k.shape[1])}")


def flash_fwd(q, k, v, scale, causal=False, kmask=None, window=None,
              want_lse=False):
    """One flash forward: the kernel for CUDA tensors, the plain version
    for CPU tensors.  Returns ``(out (B,S_q,H,D), lse (B*H,S_q) f32 or
    None)``.  ``window`` is None or a positive int (needs ``causal``).
    On the card S_q and S_k must be multiples of ``FWD_BLOCK_Q`` and
    ``FWD_BLOCK_K`` (64) for either dtype."""
    global flash_fwd_launches, flash_fwd_tc_launches
    _check(q, k, v, kmask)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, scale, causal=causal,
                                     kmask=kmask, window=window,
                                     want_lse=want_lse)
    if q.device.type != "cuda":
        raise MXNetError(f"flash_fwd: no kernel for device {q.device}")
    _check_tiles(q.shape[1], k.shape[1], FWD_BLOCK_Q, FWD_BLOCK_K,
                 "flash_fwd")
    lib = _kernel()
    tc = bool(lib.mxtpu_flash_fwd_tc(_DTYPE_CODES[q.dtype]))
    if tc:
        q, k, v = _aligned(q), _aligned(k), _aligned(v)
    b, s_q, h, d = q.shape
    out = torch.empty((b, s_q, h, d), dtype=q.dtype, device=q.device)
    lse = (torch.empty((b * h, s_q), dtype=torch.float32,
                       device=q.device) if want_lse else None)
    km = None
    if kmask is not None:
        km = kmask.to(device=q.device, dtype=torch.float32).contiguous()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.mxtpu_flash_fwd(
            *_fwd_args(q, k, v, out, lse, km, scale, causal, window), stream)
    if rc != 0:
        raise MXNetError(f"flash_fwd kernel launch failed: cudaError_t "
                         f"{rc} (q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"{q.dtype})")
    flash_fwd_launches += 1
    flash_fwd_tc_launches += tc
    return out, lse


def _fwd_args(q, k, v, out, lse, km, scale, causal, window):
    """``mxtpu_flash_fwd``'s arguments but the stream."""
    b, s_q, h, d = q.shape
    return (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr() if lse is not None else None,
            km.data_ptr() if km is not None else None,
            _DTYPE_CODES[q.dtype], b, h, k.shape[2], s_q, k.shape[1], d,
            q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            float(scale), int(bool(causal)), int(window or 0))


def _bwd_args(q, k, v, out, g, scale, causal, window):
    """The shape, stride and mask arguments both backward kernels take,
    after the dtype code."""
    b, s_q, h, d = q.shape
    return (b, h, k.shape[2], s_q, k.shape[1], d,
            q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            out.stride(0), out.stride(1), out.stride(2),
            g.stride(0), g.stride(1), g.stride(2),
            float(scale), int(bool(causal)), int(window or 0))


def _launched(rc, who, q):
    if rc != 0:
        raise MXNetError(f"{who} kernel launch failed: cudaError_t {rc} "
                         f"(q {tuple(q.shape)}, {q.dtype})")


def _bwd_dq(q, k, v, out, g, lse, km, scale, causal, window):
    """Launch K2 alone: returns dQ (B, S_q, H, D) and the Delta
    (B*H, S_q) f32 it computed on the way, which K3 reads."""
    global flash_bwd_dq_launches, flash_bwd_dq_tc_launches
    lib = _bwd_kernels()
    tc = bool(lib.mxtpu_flash_bwd_dq_tc(_DTYPE_CODES[q.dtype]))
    if tc:
        q, k, v, out, g = (_aligned(t) for t in (q, k, v, out, g))
        lse = _aligned(lse, 0)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    delta = torch.empty(lse.shape, dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.mxtpu_flash_bwd_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            g.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            km.data_ptr() if km is not None else None, dq.data_ptr(),
            _DTYPE_CODES[q.dtype],
            *_bwd_args(q, k, v, out, g, scale, causal, window), stream)
    _launched(rc, "flash_bwd (dQ)", q)
    flash_bwd_dq_launches += 1
    flash_bwd_dq_tc_launches += tc
    return dq, delta


def _bwd_dkv(q, k, v, out, g, lse, delta, km, scale, causal, window):
    """Launch K3 alone: dK, dV (B, S_k, KV, D), summed over each group
    of query heads.  ``delta`` is the one K2 wrote."""
    global flash_bwd_dkv_launches, flash_bwd_dkv_tc_launches
    lib = _bwd_kernels()
    tc = bool(lib.mxtpu_flash_bwd_dkv_tc(_DTYPE_CODES[q.dtype]))
    if tc:
        q, k, v, g = (_aligned(t) for t in (q, k, v, g))
        lse, delta = _aligned(lse, 0), _aligned(delta, 0)
    dk = torch.empty(k.shape, dtype=k.dtype, device=q.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.mxtpu_flash_bwd_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            g.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            km.data_ptr() if km is not None else None, dk.data_ptr(),
            dv.data_ptr(), _DTYPE_CODES[q.dtype],
            *_bwd_args(q, k, v, out, g, scale, causal, window), stream)
    _launched(rc, "flash_bwd (dK, dV)", q)
    flash_bwd_dkv_launches += 1
    flash_bwd_dkv_tc_launches += tc
    return dk, dv


def _bwd_inputs(q, k, v, out, lse, g, kmask):
    """Check the backward's inputs; returns dO and O with a contiguous
    last dimension (copied only when it is not) and the (B, S_k) f32
    key mask, as the kernels read them."""
    _check(q, k, v, kmask, who="flash_bwd")
    b, s_q, h, _ = q.shape
    for name, t in (("out", out), ("grad", g)):
        if tuple(t.shape) != tuple(q.shape) or t.dtype != q.dtype \
                or t.device != q.device:
            raise MXNetError(
                f"flash_bwd: {name} {tuple(t.shape)} {t.dtype} on "
                f"{t.device} must match q {tuple(q.shape)} {q.dtype} on "
                f"{q.device}")
    if tuple(lse.shape) != (b * h, s_q) or lse.dtype != torch.float32 \
            or lse.device != q.device or not lse.is_contiguous():
        raise MXNetError(
            f"flash_bwd: lse {tuple(lse.shape)} {lse.dtype} must be a "
            f"contiguous (B*H, S_q) = {(b * h, s_q)} float32 tensor on "
            f"{q.device}")
    if g.stride(3) != 1:
        g = g.contiguous()
    if out.stride(3) != 1:
        out = out.contiguous()
    km = None
    if kmask is not None:
        km = kmask.to(device=q.device, dtype=torch.float32).contiguous()
    return out, g, km


def flash_bwd(q, k, v, out, lse, g, scale, causal=False, kmask=None,
              window=None):
    """One flash backward: K2 (Delta and dQ), then K3 (dK, dV) for CUDA
    tensors, the plain version for CPU tensors.  ``out`` and ``lse`` are
    the forward's output and (B*H, S_q) log-sum-exp, ``g`` the gradient
    of ``out``.  Returns ``(dq, dk, dv)`` in the input type.  On the card
    S_q and S_k must be multiples of ``BWD_BLOCK_Q`` and ``BWD_BLOCK_K``
    (64) for either dtype."""
    global flash_bwd_launches
    out, g, km = _bwd_inputs(q, k, v, out, lse, g, kmask)
    if q.device.type == "cpu":
        return flash_bwd_plain(q, k, v, out, lse, g, scale, causal=causal,
                               kmask=km, window=window)
    if q.device.type != "cuda":
        raise MXNetError(f"flash_bwd: no kernel for device {q.device}")
    _check_tiles(q.shape[1], k.shape[1], BWD_BLOCK_Q, BWD_BLOCK_K,
                 "flash_bwd")
    dq, delta = _bwd_dq(q, k, v, out, g, lse, km, scale, causal, window)
    dk, dv = _bwd_dkv(q, k, v, out, g, lse, delta, km, scale, causal,
                      window)
    flash_bwd_launches += 1
    return dq, dk, dv


class _FlashFwd(torch.autograd.Function):
    """K1 forward; K2 and K3 backward.  ``want_lse`` (a gradient will be
    taken) makes the forward write the log-sum-exp the backward needs;
    the no-grad serving path skips it."""

    @staticmethod
    def forward(ctx, q, k, v, kmask, scale, causal, window, want_lse):
        out, lse = flash_fwd(q, k, v, scale, causal=causal, kmask=kmask,
                             window=window, want_lse=want_lse)
        if want_lse:
            ctx.save_for_backward(q, k, v, out, lse, kmask)
            ctx.attrs = (scale, causal, window)
        return out

    @staticmethod
    def backward(ctx, grad):
        if not hasattr(ctx, "attrs"):
            raise MXNetError("flash attention backward without a saved "
                             "LSE: the forward ran with no input that "
                             "requires grad")
        q, k, v, out, lse, kmask = ctx.saved_tensors
        scale, causal, window = ctx.attrs
        dq, dk, dv = flash_bwd(q, k, v, out, lse, grad, scale,
                               causal=causal, kmask=kmask, window=window)
        return dq, dk, dv, None, None, None, None, None


def _flash_apply(q, k, v, kmask, scale, causal, window):
    """``_FlashFwd`` with the LSE written only when a gradient is
    needed: grad mode on and an input that requires grad."""
    want_lse = torch.is_grad_enabled() and (
        q.requires_grad or k.requires_grad or v.requires_grad)
    return _FlashFwd.apply(q, k, v, kmask, float(scale), bool(causal),
                           window, want_lse)


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
    return _flash_apply(q, k, v, kmask, scale, causal, window)
