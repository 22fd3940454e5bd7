"""Ring attention: attention with the sequence split over the ranks of a
mesh axis (``sp``), as the JAX package's ``parallel/ring_attention.py``.

Each rank keeps its block of the queries and passes its K/V block round
the axis's ring (``collectives.ppermute``), ``n`` steps for ``n`` ranks,
accumulating a grouped-query online softmax in float32 (the query heads
grouped under their KV head, so only the KV heads travel); with
``causal`` a query at global position i sees the keys at positions <= i.
The whole ring is differentiable: the permutes' backward sends the K/V
cotangents back along the ring.  It is plain PyTorch, as the JAX
function is XLA einsums outside any Pallas kernel.

:func:`ring_attention` takes and returns the global (B, S, H, D) arrays,
the same on every rank of the axis, as the JAX function's do: each rank
attends its own sequence block and the blocks are gathered back, so a
model that runs whole on every rank (``LlamaModel(attn_impl="ring")``)
runs only its attention split over ``sp``.
"""
from __future__ import annotations

import math

import torch

from ..base import MXNetError
from . import collectives as col
from .mesh import current_mesh

__all__ = ["ring_attention", "ring_attention_sharded"]


def _ring_attention_local(q, k, v, ax, scale, causal):
    """This rank's block: q (B, Sq_l, H, D); k/v (B, Sk_l, KV, D) with
    KV dividing H."""
    n, my = ax.n, ax.index
    b, sq, h, d = q.shape
    kv = k.shape[2]
    g = h // kv
    qg = q.to(torch.float32).reshape(b, sq, kv, g, d)
    m = torch.full((b, sq, kv, g, 1), float("-inf"), dtype=torch.float32,
                   device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros(qg.shape, dtype=torch.float32, device=q.device)
    perm = [(i, (i + 1) % n) for i in range(n)]
    k_cur, v_cur = k, v
    for i in range(n):
        src = (my - i) % n            # the block held came from src
        s = torch.einsum("bqcgd,bkcd->bqcgk", qg,
                         k_cur.to(torch.float32)) * scale
        if causal:
            sk = k_cur.shape[1]
            q_pos = my * sq + torch.arange(sq, device=q.device)
            k_pos = src * sk + torch.arange(sk, device=q.device)
            allowed = (q_pos[:, None] >= k_pos[None, :])[None, :, None,
                                                           None, :]
            s = torch.where(allowed, s, torch.full_like(s, -1e30))
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l = alpha * l + p.sum(dim=-1, keepdim=True)
        acc = alpha * acc + torch.einsum("bqcgk,bkcd->bqcgd", p,
                                         v_cur.to(torch.float32))
        m = m_new
        if i + 1 < n:
            k_cur = col.ppermute(k_cur, ax, perm)
            v_cur = col.ppermute(v_cur, ax, perm)
    return (acc / l).reshape(q.shape).to(q.dtype)


class _SeqBlock(torch.autograd.Function):
    """This rank's block of a global tensor's sequence (dim 1); the
    backward gathers every rank's block gradient (the whole tensor's
    gradient, as one copy of the computation has it)."""

    @staticmethod
    def forward(ctx, t, ax):
        ctx.ax = ax
        n = t.shape[1] // ax.n
        return t[:, ax.index * n:(ax.index + 1) * n].contiguous()

    @staticmethod
    def backward(ctx, g):
        rows = col._gather_rows(g.contiguous(), ctx.ax)
        return torch.cat(list(rows.unbind(0)), dim=1), None


class _GatherSeq(torch.autograd.Function):
    """Every rank's block along the sequence; the backward keeps this
    rank's block of the cotangent (the same on every rank)."""

    @staticmethod
    def forward(ctx, t, ax):
        ctx.ax, ctx.n = ax, t.shape[1]
        rows = col._gather_rows(t.contiguous(), ax)
        return torch.cat(list(rows.unbind(0)), dim=1)

    @staticmethod
    def backward(ctx, g):
        i, n = ctx.ax.index, ctx.n
        return g[:, i * n:(i + 1) * n].contiguous(), None


def _resolve(plan, mesh, axis):
    from .planner import resolve_plan_axis
    mesh, axis = resolve_plan_axis(plan, mesh, axis, "sp_axis")
    return mesh if mesh is not None else current_mesh(), axis


def ring_attention(q, k, v, mesh=None, axis="sp", scale=None,
                   causal=False, plan=None):
    """Ring attention over ``axis`` of ``mesh`` (default the current
    mesh; ``plan`` supplies both, the axis being ``plan.sp_axis``).
    q (B, S, H, D), k/v (B, S, KV, D) with KV dividing H, each the same
    on every rank of the axis; S divides by the axis's size.  Returns
    (B, S, H, D), the same on every rank."""
    mesh, axis = _resolve(plan, mesh, axis)
    if axis not in mesh.shape:
        raise MXNetError(f"mesh has no axis {axis!r}")
    ax = col._axis(axis, mesh)
    if q.shape[1] % ax.n:
        raise MXNetError(
            f"sequence length {q.shape[1]} not divisible by mesh axis "
            f"{axis!r} size {ax.n}")
    if q.shape[2] % k.shape[2]:
        raise MXNetError(
            f"query heads {q.shape[2]} not a multiple of KV heads "
            f"{k.shape[2]}")
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    ql, kl, vl = (_SeqBlock.apply(t, ax) for t in (q, k, v))
    out = _ring_attention_local(ql, kl, vl, ax, float(scale), causal)
    return _GatherSeq.apply(out, ax)


def ring_attention_sharded(q_nd, k_nd, v_nd, mesh=None, axis="sp",
                           scale=None, causal=False, plan=None):
    """:func:`ring_attention` on NDArrays (or tensors), recorded like any
    op.  It cannot run inside a captured graph (a hybridized block's
    ``CachedOp``, a captured step): its collectives and the host-side
    ring schedule belong to an eager call."""
    from .. import _capture
    from ..ndarray.ndarray import NDArray
    if _capture.in_body():
        raise MXNetError(
            "ring attention cannot run inside a captured graph (a "
            "hybridized block's CachedOp or a captured step); call the "
            "block unhybridized")
    ctx = q_nd.context if isinstance(q_nd, NDArray) else None
    t = [x.tensor if isinstance(x, NDArray) else x
         for x in (q_nd, k_nd, v_nd)]
    out = ring_attention(*t, mesh=mesh, axis=axis, scale=scale,
                         causal=causal, plan=plan)
    return NDArray(out, ctx=ctx) if ctx is not None else out
