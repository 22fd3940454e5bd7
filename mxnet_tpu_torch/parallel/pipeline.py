"""Pipeline parallelism over the ranks of a mesh axis (``pp``), as the
JAX package's ``parallel/pipeline.py``: GPipe (:func:`pipeline_apply`)
and the one-forward-one-backward schedule
(:func:`pipeline_value_and_grad`).

Stage ``p`` is rank ``p`` of the axis's sub-group and runs
``stage_fn(params_p, x_mb)``.  The schedules are the JAX package's,
round for round: in GPipe's round ``t`` stage ``p`` works on microbatch
``t - p``; in 1F1B's round ``r`` it forwards microbatch ``r - p`` and
backwards microbatch ``r - 2(n-1) + p``, so the last stage runs each
backward right after its forward, and a stage holds the inputs of at
most ``2(n-1)+1`` microbatches (the backward recomputes the stage's
forward from its stashed input).  Activations go to the next stage and
their cotangents to the one before with ``collectives.ppermute`` once a
round, every rank taking part (an idle stage sends zeros).  The loss is
the mean over the microbatches of ``loss_fn(out_mb, y_mb)``, the same on
every rank.

Stacked parameters: a pytree (dicts, lists, tuples) whose leaves carry
a leading stage dimension.  A leaf of leading size ``n`` (the axis's
size) is the whole stack, the same on every rank: the rank takes its own
stage (and, with ``param_specs``, its shard of the dimensions the spec
names), and the gradients come back whole, gathered over the ranks.  A
leaf of leading size 1 is already this rank's stage (and shard), and so
is its gradient (on an axis of one rank, every leaf is).
``param_specs`` (a pytree of ``PartitionSpec``s like
the leaves) composes tensor parallelism: each spec's leading entry is
the stage axis, and ``stage_fn`` closes the other axes with the
collectives itself (``llama_spmd`` uses Megatron's pair: the identity
whose backward sums over ``tp`` before a column-parallel product, the
sum whose cotangent passes through after a row-parallel one).  With
those, a leaf replicated over such an axis already holds its whole
gradient on every rank, so ``grad_reduce_axes`` is only checked against
the mesh.
"""
from __future__ import annotations

import torch
from torch.utils import _pytree as pytree

from ..base import MXNetError
from . import collectives as col
from .mesh import current_mesh

__all__ = ["pipeline_apply", "pipeline_value_and_grad"]


def _resolve_plan(plan, mesh, axis):
    from .planner import resolve_plan_axis
    mesh, axis = resolve_plan_axis(plan, mesh, axis, "pp_axis")
    return mesh if mesh is not None else current_mesh(), axis


def _entries(entry):
    return (entry,) if isinstance(entry, str) else tuple(entry or ())


def _local(leaf, spec, mesh, n):
    """This rank's stage (and shard) of a whole stacked leaf."""
    out = leaf[col._axis(spec[0], mesh).index if leaf.shape[0] == n > 1
               else 0]
    for d, entry in enumerate(tuple(spec)[1:]):
        for ax in _entries(entry):
            a = col._axis(ax, mesh)
            size = out.shape[d] // a.n
            out = out.narrow(d, a.index * size, size)
    return out.unsqueeze(0)


def _whole(grad, spec, mesh):
    """A rank's stage gradient (1, ...) gathered back to the whole stack:
    every sharded dimension over its axis, the stage dimension last."""
    g = grad
    for d, entry in reversed(list(enumerate(tuple(spec)[1:]))):
        for ax in reversed(_entries(entry)):
            g = col.all_gather(g, col._axis(ax, mesh), axis=d + 1)
    return col.all_gather(g, col._axis(spec[0], mesh), axis=0)


def _prepare(fname, stacked_params, x, n_microbatches, mesh, axis,
             y=None, param_specs=None):
    """Shared checks and this rank's parameters: returns (axis, leaves'
    local stages, treedef, whole?, specs)."""
    if axis not in mesh.shape:
        raise MXNetError(f"mesh has no axis {axis!r}")
    ax = col._axis(axis, mesh)
    n = ax.n
    leaves, tree = pytree.tree_flatten(stacked_params)
    heads = [l.shape[0] for l in leaves]
    whole = [h == n > 1 for h in heads]
    if any(h not in (n, 1) for h in heads):
        raise MXNetError(
            f"{fname}: stacked param leading dims {heads} must equal the "
            f"{axis!r} axis size {n} (or 1: this rank's stage)")
    if x.shape[0] % n_microbatches:
        raise MXNetError(
            f"batch {x.shape[0]} not divisible by n_microbatches "
            f"{n_microbatches}")
    if y is not None and y.shape[0] != x.shape[0]:
        raise MXNetError(
            f"{fname}: y batch {y.shape[0]} != x batch {x.shape[0]}")
    if param_specs is None:
        specs = [(axis,)] * len(leaves)
    else:
        specs = pytree.tree_leaves(
            param_specs, is_leaf=lambda s: isinstance(s, tuple))
        if len(specs) != len(leaves):
            raise MXNetError(f"{fname}: param_specs has {len(specs)} "
                             f"leaves, stacked_params {len(leaves)}")
        for s in specs:
            if not len(s) or s[0] != axis:
                raise MXNetError(
                    f"param_specs leaf {s} must shard the leading stage "
                    f"dim over {axis!r}")
    local = [(_local(l, s, mesh, n) if w else l)[0]
             for l, s, w in zip(leaves, specs, whole)]
    return ax, local, tree, whole, specs


def _microbatches(t, m):
    return t.reshape((m, t.shape[0] // m) + tuple(t.shape[1:]))


def pipeline_apply(stage_fn, stacked_params, x, n_microbatches,
                   mesh=None, axis="pp", param_specs=None, plan=None):
    """Apply the ``n`` stages as a GPipe pipeline: ``stage_fn(params_p,
    x_mb) -> y_mb`` (the same shape), ``x`` (batch, ...) cut into
    ``n_microbatches`` along dim 0.  Returns (batch, ...), the same on
    every rank.  Differentiable with respect to ``x`` and the stacked
    parameters: the backward runs the schedule in reverse, each stage
    recomputing its forward from the inputs it stashed and sending the
    cotangents to the stage before.  ``plan`` supplies the mesh and the
    stage axis (``plan.pp_axis``)."""
    mesh, axis = _resolve_plan(plan, mesh, axis)
    leaves, tree = pytree.tree_flatten(stacked_params)
    _prepare("pipeline_apply", stacked_params, x, n_microbatches, mesh,
             axis, param_specs=param_specs)
    return _GPipe.apply(
        (stage_fn, tree, mesh, axis, param_specs, n_microbatches), x,
        *leaves)


class _GPipe(torch.autograd.Function):
    """The GPipe schedule, and its reverse as the backward."""

    @staticmethod
    def forward(ctx, conf, x, *leaves):
        stage_fn, tree, mesh, axis, param_specs, m = conf
        ax, local, _, whole, specs = _prepare(
            "pipeline_apply", pytree.tree_unflatten(list(leaves), tree), x,
            m, mesh, axis, param_specs=param_specs)
        params = pytree.tree_unflatten(local, tree)
        n, p = ax.n, ax.index
        xs = _microbatches(x, m)
        perm = [(i, (i + 1) % n) for i in range(n)]
        carry = torch.zeros_like(xs[0])
        ys = [torch.zeros_like(xs[0]) for _ in range(m)]
        stash = {}
        for t in range(m + n - 1):
            mb = t - p
            out = torch.zeros_like(xs[0])
            if 0 <= mb < m:
                stash[mb] = xs[mb] if p == 0 else carry
                out = stage_fn(params, stash[mb])
                if p == n - 1:
                    ys[mb] = out
            carry = col._ppermute(out, ax, perm)
        # only the last stage holds results: one sum makes them every
        # rank's
        ys = col._all_reduce(torch.stack(ys), ax)
        ctx.conf, ctx.ax, ctx.whole, ctx.specs = conf, ax, whole, specs
        ctx.local, ctx.stash, ctx.x_shape = local, stash, x.shape
        return ys.reshape(x.shape)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        stage_fn, tree, mesh, _axis, _specs, m = ctx.conf
        ax, n = ctx.ax, ctx.ax.n
        p = ax.index
        gs = _microbatches(g, m)
        perm_bwd = [((i + 1) % n, i) for i in range(n)]
        leaves = [t.detach() for t in ctx.local]
        acc = [torch.zeros(t.shape, dtype=torch.float32, device=t.device)
               for t in leaves]
        dxs = [torch.zeros_like(gs[0]) for _ in range(m)]
        bcarry = torch.zeros_like(gs[0])
        for u in range(m + n - 1):
            mb = m + n - 2 - u - p
            dx = torch.zeros_like(gs[0])
            if 0 <= mb < m:
                cot = gs[mb] if p == n - 1 else bcarry
                with torch.enable_grad():
                    lp = [t.detach().requires_grad_() for t in leaves]
                    xin = ctx.stash.pop(mb).detach().requires_grad_()
                    out = stage_fn(pytree.tree_unflatten(lp, tree), xin)
                    got = torch.autograd.grad(out, lp + [xin],
                                              cot.to(out.dtype),
                                              allow_unused=True,
                                              materialize_grads=True)
                for a, d in zip(acc, got[:-1]):
                    a.add_(d.to(torch.float32))
                dx = got[-1]
                if p == 0:
                    dxs[mb] = dx
            bcarry = col._ppermute(dx, ax, perm_bwd)
        # the input's gradient is stage 0's: one sum gives it every rank
        gx = col._all_reduce(torch.stack(dxs), ax).reshape(ctx.x_shape)
        grads = []
        for a, t, w, s in zip(acc, leaves, ctx.whole, ctx.specs):
            a = a.to(t.dtype)[None]
            grads.append(_whole(a, s, mesh) if w else a)
        return (None, gx, *grads)


def pipeline_value_and_grad(stage_fn, stacked_params, x, y, loss_fn,
                            n_microbatches, mesh=None, axis="pp",
                            param_specs=None, grad_reduce_axes=None,
                            plan=None):
    """One 1F1B training step: ``(loss, grads)``, the mean over the
    microbatches of ``loss_fn(out_mb, y_mb)`` and its gradient with
    respect to the stacked parameters (in their form: whole or this
    rank's stage; float32 accumulation, returned in the parameters'
    type).  ``x``, ``y`` (batch, ...) are cut into ``n_microbatches``.
    ``param_specs`` and ``grad_reduce_axes``: see the module docstring;
    ``plan`` supplies the mesh and the stage axis."""
    mesh, axis = _resolve_plan(plan, mesh, axis)
    ax, local, tree, whole, specs = _prepare(
        "pipeline_value_and_grad", stacked_params, x, n_microbatches,
        mesh, axis, y=y, param_specs=param_specs)
    for a in (grad_reduce_axes or ()):
        if a and a not in mesh.shape:
            raise MXNetError(f"grad_reduce_axes names {a!r}, not an axis "
                             f"of {dict(mesh.shape)}")
    n, p, m = ax.n, ax.index, n_microbatches
    xs, ys = _microbatches(x, m), _microbatches(y, m)
    perm_fwd = [(i, (i + 1) % n) for i in range(n)]
    perm_bwd = [((i + 1) % n, i) for i in range(n)]
    leaves = [l.detach() for l in local]
    params = pytree.tree_unflatten(leaves, tree)
    mb_zero = torch.zeros_like(xs[0])
    fcarry = bcarry = mb_zero
    stash, dys = {}, {}
    grad_acc = [torch.zeros(l.shape, dtype=torch.float32, device=l.device)
                for l in leaves]
    loss_acc = torch.zeros((), dtype=torch.float32, device=x.device)
    last = p == n - 1
    for r in range(m + 2 * (n - 1)):
        # forward half-round
        f = r - p
        out = mb_zero
        if 0 <= f < m:
            x_in = xs[f] if p == 0 else fcarry
            stash[f] = x_in
            with torch.no_grad():
                out = stage_fn(params, x_in)
            if last:
                with torch.enable_grad():
                    o = out.detach().requires_grad_()
                    loss_mb = loss_fn(o, ys[f])
                    (dys[f],) = torch.autograd.grad(loss_mb, o)
                loss_acc = loss_acc + loss_mb.detach().to(torch.float32)
        fcarry = col.ppermute(out, ax, perm_fwd)
        # backward half-round: recompute the stage from its input
        b = r - 2 * (n - 1) + p
        dx = mb_zero
        if 0 <= b < m:
            cot = dys.pop(b) if last else bcarry
            with torch.enable_grad():
                lp = [l.requires_grad_() for l in
                      (t.detach() for t in leaves)]
                xin = stash.pop(b).detach().requires_grad_(p > 0)
                out_b = stage_fn(pytree.tree_unflatten(lp, tree), xin)
                wrt = lp + ([xin] if p > 0 else [])
                got = torch.autograd.grad(out_b, wrt, cot.to(out_b.dtype),
                                          allow_unused=True,
                                          materialize_grads=True)
            for acc, g in zip(grad_acc, got[:len(lp)]):
                acc.add_(g.to(torch.float32))
            if p > 0:
                dx = got[-1]
        bcarry = col.ppermute(dx, ax, perm_bwd)
    loss = col._all_reduce(loss_acc, ax) / m
    grads = []
    for g, l, w, s in zip(grad_acc, leaves, whole, specs):
        g = (g / m).to(l.dtype)[None]
        grads.append(_whole(g, s, mesh) if w else g)
    return loss, pytree.tree_unflatten(grads, tree)
