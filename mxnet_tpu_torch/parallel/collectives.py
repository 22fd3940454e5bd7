"""Collectives over the mesh's process group, as the JAX package's
``parallel/collectives.py``.

The JAX functions run inside ``shard_map`` with an ``axis_name``; here
each rank calls them on its own tensor and ``axis_name`` names an axis of
the current mesh (``set_mesh``; None: every rank), whose group carries
the call: NCCL for a card's tensors, gloo for the CPU's
(``parallel/mesh.py``).  A mesh axis of one rank without a process group
is the identity.  Every function takes torch tensors or NDArrays (and
returns the same kind).

* ``psum``, ``pmean``, ``all_gather``, ``reduce_scatter``, ``ppermute``,
  ``all_to_all``: ``lax``'s, with the same axis arguments.  ``psum`` and
  ``pmean`` are differentiable (the backward sums the cotangents over
  the group), which a global-batch BatchNorm needs.
* ``allreduce(values)``: the sum (or mean) of this rank's values and
  every other rank's, one result a value.
* ``quantized_psum``: the int8 all-reduce in two phases, int8
  ``all_to_all`` of absmax-scaled chunks, then the requantized partial
  sums' int8 ``all_gather``, with a straight-through gradient (psum).
  ``quantized_reduce_scatter`` is its first phase.  ``twobit_psum`` packs
  four ternary codes a byte for the first phase, gathers the int8
  partial sums and returns the new residual.  Rounding is half to even,
  as ``jnp.round``.
* ``*_many`` variants take a list of tensors and run one collective a
  phase for all of them, each tensor quantized, padded and chunked
  exactly as alone (the trainer's buckets).
* ``vocab_parallel_softmax_ce``, ``sharded_weight_update`` and
  ``sharded_update_state_init``: the tensor-parallel loss and the ZeRO
  update over one rank's flat slice.

``collective_calls``, ``collective_payload_bytes`` (the bytes of the
buffer each rank hands in or gets out: an all-reduce's input, an
all-gather's output) and ``collective_wire_bytes`` (what a ring moves a
rank: ``2 p (n-1)/n`` for an all-reduce, ``p (n-1)/n`` for the others,
``p`` for a permute) count every call; a captured step's replays are
credited with what its capture counted (``_capture``).
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from ..base import MXNetError
from .mesh import current_mesh

__all__ = ["vocab_parallel_softmax_ce",
           "psum", "pmean", "all_gather", "ppermute", "all_to_all",
           "allreduce", "reduce_scatter", "quantized_psum",
           "quantized_reduce_scatter", "twobit_psum",
           "quantized_psum_many", "quantized_reduce_scatter_many",
           "twobit_psum_many", "sharded_weight_update",
           "sharded_update_state_init", "reset_counts", "counts"]

collective_calls = 0
collective_payload_bytes = 0
collective_wire_bytes = 0


def reset_counts():
    global collective_calls, collective_payload_bytes, collective_wire_bytes
    collective_calls = collective_payload_bytes = collective_wire_bytes = 0


def counts():
    """{"calls", "payload_bytes", "wire_bytes"} since the last reset."""
    return {"calls": collective_calls,
            "payload_bytes": collective_payload_bytes,
            "wire_bytes": collective_wire_bytes}


def _count(kind, nbytes, n):
    global collective_calls, collective_payload_bytes, collective_wire_bytes
    collective_calls += 1
    collective_payload_bytes += int(nbytes)
    if kind == "all_reduce":
        wire = 2 * nbytes * (n - 1) // n
    elif kind == "ppermute":
        wire = nbytes
    else:
        wire = nbytes * (n - 1) // n
    collective_wire_bytes += int(wire)


class _Axis:
    """The group, size and this rank's index of a mesh axis."""

    __slots__ = ("group", "n", "index")

    def __init__(self, axis_name, mesh=None):
        mesh = mesh if mesh is not None else current_mesh()
        self.group = mesh.group(axis_name)
        self.n = mesh.axis_size(axis_name)
        self.index = mesh.axis_index(axis_name)

    @classmethod
    def of_group(cls, group):
        """The axis of a whole process group."""
        import torch.distributed as dist
        self = cls.__new__(cls)
        self.group = group
        self.n = dist.get_world_size(group)
        self.index = dist.get_rank(group)
        return self

    def check(self, t):
        """A card's tensor needs NCCL, the CPU's gloo."""
        import torch.distributed as dist
        backend = str(dist.get_backend(self.group)).lower()
        want = "nccl" if t.is_cuda else "gloo"
        if want not in backend:
            raise MXNetError(f"a {t.device.type} tensor cannot go over the "
                             f"{backend!r} process group (it needs "
                             f"{want!r})")


def _axis(axis_name, mesh=None):
    """``axis_name`` resolved on ``mesh`` (default: the current mesh); an
    ``_Axis`` passes through."""
    return axis_name if isinstance(axis_name, _Axis) else \
        _Axis(axis_name, mesh)


def _unwrap(x):
    from ..ndarray.ndarray import NDArray
    if isinstance(x, NDArray):
        return x._t, x.context
    return x, None


def _rewrap(t, ctx):
    if ctx is None:
        return t
    from ..ndarray.ndarray import NDArray
    return NDArray(t, ctx=ctx)


def _nbytes(t):
    return t.numel() * t.element_size()


# -- the raw collectives (this rank's part; no autograd) -------------------

def _all_reduce_(t, ax, op="sum"):
    """``t`` (contiguous) reduced over the axis in place."""
    import torch.distributed as dist
    if ax.group is None:
        return t
    ax.check(t)
    _count("all_reduce", _nbytes(t), ax.n)
    dist.all_reduce(t, op=dist.ReduceOp.MAX if op == "max"
                    else dist.ReduceOp.SUM, group=ax.group)
    return t


def _all_reduce(t, ax, op="sum"):
    """A reduced copy of ``t`` over the axis."""
    return _all_reduce_(t.clone(memory_format=torch.contiguous_format), ax,
                        op)


def _gather_rows(t, ax):
    """(n, *t.shape): every member's ``t``, in axis order."""
    import torch.distributed as dist
    t = t.contiguous()
    out = t.new_empty((ax.n,) + tuple(t.shape))
    if ax.group is None:
        out[0].copy_(t)
        return out
    ax.check(t)
    _count("all_gather", _nbytes(out), ax.n)
    fn = getattr(dist, "all_gather_single", None) or \
        dist.all_gather_into_tensor
    fn(out.view(-1), t.view(-1), group=ax.group)
    return out


def _scatter_rows(t, ax):
    """Member i gets the group's sum of row i of ``t`` (n, ...)."""
    import torch.distributed as dist
    t = t.contiguous()
    if ax.group is None:
        return t[0].clone()
    ax.check(t)
    out = t.new_empty(tuple(t.shape[1:]))
    _count("reduce_scatter", _nbytes(t), ax.n)
    fn = getattr(dist, "reduce_scatter_single", None) or \
        dist.reduce_scatter_tensor
    fn(out.view(-1), t.view(-1), group=ax.group)
    return out


def _exchange_rows(t, ax):
    """All-to-all over rows: (n, ...) in, row j of the result is member
    j's row for this member."""
    import torch.distributed as dist
    t = t.contiguous()
    if ax.group is None:
        return t.clone()
    ax.check(t)
    out = torch.empty_like(t)
    _count("all_to_all", _nbytes(t), ax.n)
    dist.all_to_all_single(out.view(-1), t.view(-1), group=ax.group)
    return out


class _PSum(torch.autograd.Function):
    """The sum over the axis; its backward sums the cotangents too."""

    @staticmethod
    def forward(ctx, t, ax):
        ctx.ax = ax
        return _all_reduce(t, ax)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.ax), None


class _PSumReplicated(torch.autograd.Function):
    """The sum over the axis of a value whose result every rank then
    uses identically (one loss, not one a rank): the cotangent passes
    through, as JAX's psum transposes for an axis-invariant result."""

    @staticmethod
    def forward(ctx, t, ax):
        return _all_reduce(t, ax)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyToAxis(torch.autograd.Function):
    """Identity forward, sum over the axis backward: a replicated input
    whose every rank's use contributes to its gradient (Megatron's
    ``f``)."""

    @staticmethod
    def forward(ctx, t, ax):
        ctx.ax = ax
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.ax), None


def psum(x, axis_name=None):
    t, c = _unwrap(x)
    return _rewrap(_PSum.apply(t, _axis(axis_name)), c)


def pmean(x, axis_name=None):
    t, c = _unwrap(x)
    ax = _axis(axis_name)
    return _rewrap(_PSum.apply(t, ax) / ax.n, c)


def all_gather(x, axis_name=None, axis=0, tiled=True):
    """Every member's ``x`` along ``axis`` in axis order: concatenated
    (``tiled``) or stacked on a new axis."""
    t, c = _unwrap(x)
    ax = _axis(axis_name)
    rows = _gather_rows(t, ax)
    axis = axis % (t.dim() + (0 if tiled else 1)) if t.dim() else 0
    if not tiled:
        return _rewrap(rows.movedim(0, axis), c)
    out = torch.cat(list(rows.unbind(0)), dim=axis)
    return _rewrap(out, c)


def reduce_scatter(x, axis_name=None, *, scatter_dimension=0,
                   tiled=False):
    """Member i gets the group's sum of slice i of ``x`` along
    ``scatter_dimension`` (``lax.psum_scatter``): that dim must be n and
    goes (``tiled=False``), or is cut into n (``tiled=True``)."""
    t, c = _unwrap(x)
    ax = _axis(axis_name)
    d = scatter_dimension % t.dim()
    moved = t.movedim(d, 0)
    if tiled:
        if moved.shape[0] % ax.n:
            raise MXNetError(f"reduce_scatter: dim {d} of {tuple(t.shape)}"
                             f" does not divide by {ax.n}")
        moved = moved.reshape((ax.n, moved.shape[0] // ax.n)
                              + tuple(moved.shape[1:]))
    elif moved.shape[0] != ax.n:
        raise MXNetError(f"reduce_scatter: dim {d} of {tuple(t.shape)} "
                         f"must be the axis size {ax.n}")
    out = _scatter_rows(moved, ax)
    return _rewrap(out.movedim(0, d) if tiled else out, c)


def _ppermute(t, ax, perm):
    """``t`` sent along ``perm``'s (src, dst) pairs; a member nothing is
    sent to gets zeros."""
    import torch.distributed as dist
    t = t.contiguous()
    out = torch.zeros_like(t)
    if ax.group is None:
        for s, d in perm:
            if s == d == 0:
                out.copy_(t)
        return out
    ax.check(t)
    ranks = dist.get_process_group_ranks(ax.group)
    ops = []
    for s, d in perm:
        if s == ax.index:
            if d == ax.index:
                out.copy_(t)
                continue
            _count("ppermute", _nbytes(t), ax.n)
            ops.append(dist.P2POp(dist.isend, t, ranks[d], ax.group))
        if d == ax.index and s != ax.index:
            ops.append(dist.P2POp(dist.irecv, out, ranks[s], ax.group))
    if ops:
        for w in dist.batch_isend_irecv(ops):
            w.wait()
    return out


class _PPermute(torch.autograd.Function):
    """A permute whose backward sends the cotangents back along the
    inverse pairs (``lax.ppermute``'s transpose)."""

    @staticmethod
    def forward(ctx, t, ax, perm):
        ctx.ax, ctx.perm = ax, perm
        return _ppermute(t, ax, perm)

    @staticmethod
    def backward(ctx, g):
        return _ppermute(g, ctx.ax, [(d, s) for s, d in ctx.perm]), \
            None, None


def ppermute(x, axis_name, perm):
    """``lax.ppermute``: member ``src`` sends to ``dst`` for each pair of
    ``perm``; a member nothing is sent to gets zeros.  Differentiable:
    the cotangents go back along the inverse pairs."""
    t, c = _unwrap(x)
    perm = [(int(s), int(d)) for s, d in perm]
    return _rewrap(_PPermute.apply(t, _axis(axis_name), perm), c)


def all_to_all(x, axis_name, split_axis, concat_axis, tiled=True):
    """``lax.all_to_all``: ``x`` cut into n chunks along ``split_axis``,
    chunk j to member j; the chunks received are concatenated along
    ``concat_axis`` in member order (``tiled=False``: the split axis is n
    and goes, and the received chunks stack on a new ``concat_axis``)."""
    t, c = _unwrap(x)
    ax = _axis(axis_name)
    sa = split_axis % t.dim()
    if t.shape[sa] % ax.n:
        raise MXNetError(f"all_to_all: dim {sa} of {tuple(t.shape)} does "
                         f"not divide by {ax.n}")
    rows = torch.stack(t.chunk(ax.n, dim=sa))
    got = _exchange_rows(rows, ax)
    if tiled:
        out = torch.cat(list(got.unbind(0)), dim=concat_axis % t.dim())
    else:
        parts = [g.squeeze(sa) for g in got.unbind(0)]
        out = torch.stack(parts, dim=concat_axis % (t.dim()))
    return _rewrap(out, c)


def allreduce(values, axis="dp", mesh=None, op="sum"):
    """The sum (``op="mean"``: the mean over the values of every rank) of
    this rank's ``values`` (NDArrays or tensors, one a local context) and
    every other rank's on the mesh axis; returns one result a value, on
    its context."""
    if op not in ("sum", "mean"):
        raise MXNetError(f"allreduce: unsupported op {op!r}")
    if not values:
        raise MXNetError("allreduce: no values")
    ts = [_unwrap(v) for v in values]
    root = ts[0][0]
    local = root.clone()
    for t, _ in ts[1:]:
        local = local + t.to(root.device)
    ax = _axis(axis, mesh)
    total = _all_reduce(local, ax)
    if op == "mean":
        total = total / (len(values) * ax.n)
    return [_rewrap(total.to(t.device, copy=True), cx) for t, cx in ts]


# -- the quantized exchanges ----------------------------------------------

_QMAX = 127.0


def _layout(sizes, n, multiple=1):
    """(chunk, offset) of each flat size padded to n chunks, each chunk a
    multiple of ``multiple``, laid side by side in an (n, C) buffer."""
    chunks, offs, off = [], [], 0
    for s in sizes:
        c = -(-s // n)
        c += (-c) % multiple
        chunks.append(c)
        offs.append(off)
        off += c
    return chunks, offs, off


def _rows(flats, n, chunks, offs, total, dtype):
    """The (n, C) buffer: tensor p's flat, zero-padded to n * chunk_p, in
    columns [off_p, off_p + chunk_p)."""
    buf = flats[0].new_zeros((n, total), dtype=dtype)
    for f, c, o in zip(flats, chunks, offs):
        seg, size = buf[:, o:o + c], f.numel()
        full = size // c
        seg[:full] = f[:full * c].view(full, c)
        if full * c < size:
            seg[full, :size - full * c] = f[full * c:]
    return buf


def _sum_rows(x):
    """Row 0 + row 1 + ... in that order (the reduction order of the
    JAX package's ``jnp.sum(axis=0)`` on the CPU)."""
    acc = x[0]
    for j in range(1, x.shape[0]):
        acc = acc + x[j]
    return acc


def _scale(seg, dim=None):
    """absmax / 127 of ``seg`` (along ``dim``, kept), at least 1e-20."""
    top = seg.abs().amax() if dim is None else \
        seg.abs().amax(dim=dim, keepdim=True)
    return (top / _QMAX).clamp_min(1e-20)


def _codes(seg, scale):
    return torch.clamp(torch.round(seg / scale), -_QMAX, _QMAX).to(
        torch.int8)


def _q_reduce(flats, ax):
    """Phase 1: each tensor's chunks quantized (each row of its segment
    against that row's absmax), exchanged, and this member's chunk
    dequantized and summed.  Returns (part (C,) f32, chunks, offsets)."""
    n = ax.n
    chunks, offs, total = _layout([f.numel() for f in flats], n)
    buf = _rows(flats, n, chunks, offs, total, torch.float32)
    q = torch.empty_like(buf, dtype=torch.int8)
    scales = []
    for c, o in zip(chunks, offs):
        s = _scale(buf[:, o:o + c], dim=1)
        q[:, o:o + c] = _codes(buf[:, o:o + c], s)
        scales.append(s)
    qx = _exchange_rows(q, ax)
    sx = _exchange_rows(torch.cat(scales, dim=1), ax)
    part = torch.empty(total, dtype=torch.float32, device=buf.device)
    for p, (c, o) in enumerate(zip(chunks, offs)):
        part[o:o + c] = _sum_rows(qx[:, o:o + c].to(torch.float32)
                                  * sx[:, p:p + 1])
    return part, chunks, offs


def _qpsum_many(ts, ax):
    flats = [t.reshape(-1).to(torch.float32) for t in ts]
    part, chunks, offs = _q_reduce(flats, ax)
    # phase 2: requantize each tensor's partial sum, int8 all-gather
    q2 = torch.empty_like(part, dtype=torch.int8)
    s2 = []
    for c, o in zip(chunks, offs):
        s = _scale(part[o:o + c])
        q2[o:o + c] = _codes(part[o:o + c], s)
        s2.append(s)
    allq = _gather_rows(q2, ax)
    alls = _gather_rows(torch.stack(s2), ax)
    outs = []
    for p, (t, c, o) in enumerate(zip(ts, chunks, offs)):
        full = allq[:, o:o + c].to(torch.float32) * alls[:, p:p + 1]
        outs.append(full.reshape(-1)[:t.numel()].reshape(t.shape)
                    .to(t.dtype))
    return outs


class _QPSum(torch.autograd.Function):
    """The int8 all-reduce; straight through (psum) backward."""

    @staticmethod
    def forward(ctx, ax, *ts):
        ctx.ax = ax
        return tuple(_qpsum_many(list(ts), ax))

    @staticmethod
    def backward(ctx, *gs):
        return (None,) + tuple(_all_reduce(g, ctx.ax) for g in gs)


def quantized_psum_many(xs: Sequence, axis_name=None, *, bits=8):
    """:func:`quantized_psum` of each of ``xs``, one collective a phase."""
    if bits != 8:
        raise MXNetError(f"quantized_psum: bits must be 8, got {bits}")
    pairs = [_unwrap(x) for x in xs]
    outs = _QPSum.apply(_axis(axis_name), *[t for t, _ in pairs])
    return [_rewrap(o, c) for o, (_, c) in zip(outs, pairs)]


def quantized_psum(x, axis_name=None, *, bits=8):
    """The int8-wire all-reduce: (1) ``x``'s flat, padded to n chunks,
    each chunk scaled by its absmax / 127 and rounded to int8, goes by
    ``all_to_all`` with its f32 scale; each member dequantizes and sums
    its chunk; (2) the partial sum, requantized against its own absmax,
    goes by int8 ``all_gather``.  Wire about 2 bytes an element against
    an f32 ring's 8.  Its gradient is the psum's (straight through)."""
    return quantized_psum_many([x], axis_name, bits=bits)[0]


def quantized_reduce_scatter_many(xs: Sequence, axis_name=None, *,
                                  bits=8):
    """:func:`quantized_reduce_scatter` of each of ``xs`` in one exchange:
    returns this member's f32 sum of each tensor's chunk."""
    if bits != 8:
        raise MXNetError(
            f"quantized_reduce_scatter: bits must be 8, got {bits}")
    pairs = [_unwrap(x) for x in xs]
    flats = [t.reshape(-1).to(torch.float32) for t, _ in pairs]
    part, chunks, offs = _q_reduce(flats, _axis(axis_name))
    return [_rewrap(part[o:o + c], cx)
            for (o, c), (_, cx) in zip(zip(offs, chunks), pairs)]


def quantized_reduce_scatter(x, axis_name=None, *, bits=8):
    """The int8-wire reduce-scatter (:func:`quantized_psum`'s first
    phase): member i gets the f32 sum of chunk i of the zero-padded flat
    ``x``, shape ``(padded / n,)``."""
    return quantized_reduce_scatter_many([x], axis_name, bits=bits)[0]


def _ternary(g, threshold):
    """{-1, 0, 1} as int8: the sign of ``g`` where ``|g| >= threshold``."""
    return (g >= threshold).to(torch.int8) - (g <= -threshold).to(torch.int8)


def twobit_psum_many(xs: Sequence, axis_name=None, *, threshold=0.5,
                     residuals=None):
    """:func:`twobit_psum` of each of ``xs`` (with its residual), one
    collective a phase.  Returns (sums, new residuals)."""
    pairs = [_unwrap(x) for x in xs]
    ts = [t for t, _ in pairs]
    if residuals is None:
        residuals = [None] * len(ts)
    ax = _axis(axis_name)
    n = ax.n
    gs = [t if r is None else t + _unwrap(r)[0]
          for t, r in zip(ts, residuals)]
    codes = [_ternary(g, threshold) for g in gs]
    chunks, offs, total = _layout([c.numel() for c in codes], n, 4)
    buf = _rows([c.reshape(-1) for c in codes], n, chunks, offs, total,
                torch.int8)
    # phase 1: {-1, 0, 1} + 1 packed four to a byte
    u = (buf + 1).to(torch.uint8).reshape(n, -1, 4)
    packed = u[..., 0] | (u[..., 1] << 2) | (u[..., 2] << 4) | \
        (u[..., 3] << 6)
    px = _exchange_rows(packed, ax)
    quads = torch.stack([(px >> s) & 0x3 for s in (0, 2, 4, 6)], dim=-1)
    cx = quads.reshape(n, -1).to(torch.int32) - 1
    # partial sums lie in [-n, n]: exact in int8 while n <= 127
    part = cx.sum(dim=0).to(torch.int8 if n <= 127 else torch.int32)
    allp = _gather_rows(part, ax).to(torch.float32)
    sums, new_res = [], []
    for (t, cxt), g, c, o, code in zip(pairs, gs, chunks, offs, codes):
        flat = allp[:, o:o + c].reshape(-1)[:t.numel()] * threshold
        sums.append(_rewrap(flat.reshape(t.shape).to(t.dtype), cxt))
        new_res.append(_rewrap(g - code.to(g.dtype) * threshold, cxt))
    return sums, new_res


def twobit_psum(x, axis_name=None, *, threshold=0.5, residual=None):
    """The 2-bit all-reduce with error feedback: ``g = x + residual``
    snapped to {-t, 0, t}; the codes, packed four a byte, go by
    ``all_to_all``; each member sums its chunk's codes and int8
    ``all_gather``s the sums.  Wire about 1.25 bytes an element.  Returns
    ``(sum, new_residual)``; the caller keeps the residual."""
    sums, res = twobit_psum_many([x], axis_name, threshold=threshold,
                                 residuals=[residual])
    return sums[0], res[0]


def vocab_parallel_softmax_ce(hidden, w_local, label, axis_name, chunk=None):
    """The softmax cross-entropy of logits whose vocabulary rows are
    split over ``axis_name`` (rank i holds rows [i V_l, (i+1) V_l) of the
    (V, U) head): ``hidden`` (N, U), ``w_local`` (V_l, U), ``label`` (N,).
    One max and one sum over the group; the (N, V) logits never exist.
    Returns the per-row loss (N,), f32, the same on every rank; its
    gradient is that of one copy of the loss: ``w_local``'s is this
    rank's rows', ``hidden``'s is summed over the ranks, as the JAX
    function's inside ``shard_map``.  ``chunk`` streams the local slab:
    ``chunked_softmax_ce(axis_name=)``, whose activations are
    O(N * chunk), with the same two collectives."""
    if chunk is not None:
        from ..ops.nn import _chunked_ce
        h, c = _unwrap(hidden)
        return _rewrap(_chunked_ce(h, _unwrap(w_local)[0], None,
                                   _unwrap(label)[0], chunk,
                                   _axis(axis_name)), c)
    h, c = _unwrap(hidden)
    w, _ = _unwrap(w_local)
    lbl, _ = _unwrap(label)
    ax = _axis(axis_name)
    h = _CopyToAxis.apply(h, ax)
    v_local = w.shape[0]
    logits = torch.matmul(h.to(torch.float32), w.to(torch.float32).t())
    m = _all_reduce(logits.detach().amax(dim=1), ax, "max")
    idx = lbl.to(torch.int64) - ax.index * v_local
    in_range = (idx >= 0) & (idx < v_local)
    picked = torch.gather(logits, 1,
                          idx.clamp(0, v_local - 1)[:, None])[:, 0]
    s, lab = _PSumReplicated.apply(torch.stack(
        [torch.exp(logits - m[:, None]).sum(dim=1),
         torch.where(in_range, picked, torch.zeros_like(picked))]), ax)
    return _rewrap(m + torch.log(s) - lab, c)


def _flat_slice(param, n):
    size = param.numel()
    chunk = -(-size // n)
    flat = param.reshape(-1).to(torch.float32)
    if chunk * n != size:
        flat = torch.cat([flat, flat.new_zeros(chunk * n - size)])
    return flat, size, chunk


def sharded_weight_update(param, grad, states, update_fn, axis_name, *,
                          grad_reduce="scatter"):
    """The ZeRO update of one parameter over one rank's flat slice:
    the gradient reduced onto the slice (``"scatter"``: one
    reduce-scatter; ``"local"``: ``grad`` is already reduced, the slice
    is cut out; a callable: ``(padded flat) -> slice``), ``update_fn(
    p_slice, g_slice, *states) -> (new_p_slice, new_states)`` on the f32
    slices, and the new slices all-gathered (in the parameter's type)
    into the parameter.  Flats are zero-padded to a multiple of n.
    Returns ``(new_param, new_states)``."""
    p, c = _unwrap(param)
    g, _ = _unwrap(grad)
    ax = _axis(axis_name)
    n = ax.n
    gflat, size, chunk = _flat_slice(g, n)
    if grad_reduce == "scatter":
        g_slice = _scatter_rows(gflat.view(n, chunk), ax)
    elif grad_reduce == "local":
        g_slice = gflat[ax.index * chunk:(ax.index + 1) * chunk]
    elif callable(grad_reduce):
        g_slice = grad_reduce(gflat)
    else:
        raise MXNetError(
            f"sharded_weight_update: grad_reduce must be 'scatter', "
            f"'local', or a callable, got {grad_reduce!r}")
    pflat, _, _ = _flat_slice(p, n)
    p_slice = pflat[ax.index * chunk:(ax.index + 1) * chunk]
    new_p, new_states = update_fn(p_slice, g_slice,
                                  *[_unwrap(s)[0] for s in states])
    rows = _gather_rows(new_p.to(p.dtype), ax)
    new = rows.reshape(-1)[:size].reshape(p.shape)
    return _rewrap(new, c), tuple(new_states)


def sharded_update_state_init(param, n_states, axis_name_size):
    """``n_states`` f32 zero slices of this rank's ``(padded / n,)`` part
    of ``param`` (the JAX function's ``(n, chunk)`` rows, one row a
    rank)."""
    p, _ = _unwrap(param)
    size = p.numel()
    chunk = -(-size // int(axis_name_size))
    return tuple(torch.zeros((chunk,), dtype=torch.float32, device=p.device)
                 for _ in range(n_states))
