"""Tensor operators of the imperative path, as the JAX package's
``ops/tensor.py``: creation, elementwise (unary, scalar, broadcast),
reductions, ``dot``/``batch_dot`` and the shape and indexing ops.

Each op is a plain function on ``torch.Tensor``s with MXNet's names,
attributes and numerics: comparisons return 0/1 in the input's type,
``argmax``/``argmin`` return float32, reductions keep an integer type,
``reshape`` takes the magic codes 0/-1/-2/-3/-4 and ``dot`` contracts the
last axis of ``a`` with the first of ``b``.  Ops that return a view of an
input are copied by ``invoke`` (MXNet's ops return new arrays); only
``NDArray.reshape`` and basic indexing keep the view.

Not ported yet (ROADMAP queue 1 item 3): ``linalg_*``, sort/argsort/topk,
the ``Sequence*`` ops, ``scatter_nd``/``gather_nd``, ``pad``, the
``_contrib_*`` ops and the rest of the JAX module.
"""
from __future__ import annotations

import builtins
import functools
from typing import Tuple

import torch
import torch.nn.functional as F

from ..base import MXNetError, torch_dtype
from . import nn as _nn
from .registry import alias, register

# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def _norm_axis(axis, ndim, exclude=False):
    """Normalize MXNet reduce axis attr (None/int/tuple, exclude flag)."""
    if axis is None or axis == ():
        axes = tuple(range(ndim))
    elif isinstance(axis, int):
        axes = (axis % ndim,)
    else:
        axes = tuple(a % ndim for a in axis)
    if exclude:
        axes = tuple(a for a in range(ndim) if a not in axes)
    return axes


# ---------------------------------------------------------------------------
# creation (no tensor inputs; ``invoke`` passes the context's device)
# ---------------------------------------------------------------------------


@register("_zeros", num_inputs=0, wrap_ctx=True)
def _zeros(*, shape=(), dtype="float32", device=None):
    return torch.zeros(tuple(shape), dtype=torch_dtype(dtype), device=device)


@register("_ones", num_inputs=0, wrap_ctx=True)
def _ones(*, shape=(), dtype="float32", device=None):
    return torch.ones(tuple(shape), dtype=torch_dtype(dtype), device=device)


@register("_full", num_inputs=0, wrap_ctx=True)
def _full(*, shape=(), value=0.0, dtype="float32", device=None):
    return torch.full(tuple(shape), value, dtype=torch_dtype(dtype),
                      device=device)


@register("_arange", num_inputs=0, wrap_ctx=True)
def _arange(*, start=0.0, stop=None, step=1.0, repeat=1, dtype="float32",
            device=None):
    if stop is None:
        start, stop = 0.0, start
    out = torch.arange(start, stop, step, dtype=torch.float64,
                       device=device).to(torch_dtype(dtype))
    if repeat != 1:
        out = torch.repeat_interleave(out, repeat)
    return out


@register("_eye", num_inputs=0, wrap_ctx=True)
def _eye(*, N=0, M=0, k=0, dtype="float32", device=None):
    m = M if M else N
    out = torch.zeros((N, m), dtype=torch_dtype(dtype), device=device)
    rows = torch.arange(builtins.max(0, -k), builtins.min(N, m - k),
                        device=device)
    out[rows, rows + k] = 1
    return out


@register("zeros_like")
def zeros_like(data):
    return torch.zeros_like(data)


@register("ones_like")
def ones_like(data):
    return torch.ones_like(data)


# ---------------------------------------------------------------------------
# elementwise unary
# ---------------------------------------------------------------------------

def _cbrt(x):
    return torch.sign(x) * torch.abs(x).pow(1.0 / 3.0)


_UNARY = {
    "abs": torch.abs, "sign": torch.sign, "rint": torch.round,
    "ceil": torch.ceil, "floor": torch.floor, "trunc": torch.trunc,
    "fix": torch.trunc, "square": torch.square, "sqrt": torch.sqrt,
    "rsqrt": torch.rsqrt, "cbrt": _cbrt,
    "exp": torch.exp, "log": torch.log, "log10": torch.log10,
    "log2": torch.log2, "log1p": torch.log1p, "expm1": torch.expm1,
    "sin": torch.sin, "cos": torch.cos, "tan": torch.tan,
    "arcsin": torch.asin, "arccos": torch.acos, "arctan": torch.atan,
    "sinh": torch.sinh, "cosh": torch.cosh, "tanh": torch.tanh,
    "arcsinh": torch.asinh, "arccosh": torch.acosh, "arctanh": torch.atanh,
    "erf": torch.special.erf, "erfinv": torch.special.erfinv,
    "gamma": lambda x: torch.exp(torch.lgamma(x)),
    "gammaln": torch.lgamma,
    "negative": torch.neg, "reciprocal": torch.reciprocal,
    "logical_not": lambda x: (x == 0).to(x.dtype),
    "sigmoid": torch.sigmoid,
    "softsign": F.softsign,
    "relu": torch.relu,
    "round": torch.round,
    "rcbrt": lambda x: 1.0 / _cbrt(x),
    "degrees": torch.rad2deg,
    "radians": torch.deg2rad,
}

for _name, _fn in _UNARY.items():
    register(_name)(functools.partial(lambda x, _f=None: _f(x), _f=_fn))


@register("_copy")
def _copy(x):
    return x.clone()


@register("cast")
def cast(x, *, dtype="float32"):
    return x.to(torch_dtype(dtype))


@register("clip", scalar_attrs=("a_min", "a_max"))
def clip(x, a_min, a_max):
    return torch.clamp(x, a_min, a_max)


# ---------------------------------------------------------------------------
# scalar arithmetic: the scalar stays a Python number (PyTorch keeps the
# tensor's type for it, as MXNet does), so no host->device copy is made
# ---------------------------------------------------------------------------

def _as_type(mask, like):
    return mask.to(like.dtype)


_SCALAR_BIN = {
    "_plus_scalar": lambda x, s: x + s,
    "_minus_scalar": lambda x, s: x - s,
    "_rminus_scalar": lambda x, s: s - x,
    "_mul_scalar": lambda x, s: x * s,
    "_div_scalar": lambda x, s: x / s,
    "_rdiv_scalar": lambda x, s: s / x,
    "_mod_scalar": lambda x, s: torch.remainder(x, s),
    "_rmod_scalar": lambda x, s: torch.remainder(torch.full_like(x, s), x),
    "_power_scalar": lambda x, s: torch.pow(x, s),
    "_rpower_scalar": lambda x, s: torch.pow(s, x),
    "_maximum_scalar": lambda x, s: torch.clamp(x, min=s),
    "_minimum_scalar": lambda x, s: torch.clamp(x, max=s),
    "_equal_scalar": lambda x, s: _as_type(x == s, x),
    "_not_equal_scalar": lambda x, s: _as_type(x != s, x),
    "_greater_scalar": lambda x, s: _as_type(x > s, x),
    "_greater_equal_scalar": lambda x, s: _as_type(x >= s, x),
    "_lesser_scalar": lambda x, s: _as_type(x < s, x),
    "_lesser_equal_scalar": lambda x, s: _as_type(x <= s, x),
}

for _name, _fn in _SCALAR_BIN.items():
    register(_name, num_inputs=1, scalar_attrs=("scalar",))(
        functools.partial(lambda x, scalar, _f=None: _f(x, scalar),
                          _f=_fn))


# ---------------------------------------------------------------------------
# broadcast binary
# ---------------------------------------------------------------------------

_BROADCAST_BIN = {
    "broadcast_add": torch.add,
    "broadcast_sub": torch.sub,
    "broadcast_mul": torch.mul,
    "broadcast_div": torch.true_divide,
    "broadcast_mod": torch.remainder,
    "broadcast_power": torch.pow,
    "broadcast_maximum": torch.maximum,
    "broadcast_minimum": torch.minimum,
    "broadcast_hypot": torch.hypot,
    "broadcast_equal": lambda a, b: _as_type(a == b, a),
    "broadcast_not_equal": lambda a, b: _as_type(a != b, a),
    "broadcast_greater": lambda a, b: _as_type(a > b, a),
    "broadcast_greater_equal": lambda a, b: _as_type(a >= b, a),
    "broadcast_lesser": lambda a, b: _as_type(a < b, a),
    "broadcast_lesser_equal": lambda a, b: _as_type(a <= b, a),
    "broadcast_logical_and": lambda a, b: _as_type(
        torch.logical_and(a, b), a),
    "broadcast_logical_or": lambda a, b: _as_type(torch.logical_or(a, b), a),
    "broadcast_logical_xor": lambda a, b: _as_type(
        torch.logical_xor(a, b), a),
}

for _name, _fn in _BROADCAST_BIN.items():
    register(_name, num_inputs=2)(
        functools.partial(lambda a, b, _f=None: _f(a, b), _f=_fn))

# same-shape elementwise variants, MXNet internal names
for _name, _fn in [("elemwise_add", torch.add), ("elemwise_sub", torch.sub),
                   ("elemwise_mul", torch.mul),
                   ("elemwise_div", torch.true_divide)]:
    register(_name, num_inputs=2)(
        functools.partial(lambda a, b, _f=None: _f(a, b), _f=_fn))

alias("power", "broadcast_power")
alias("logical_and", "broadcast_logical_and")
alias("logical_or", "broadcast_logical_or")
alias("logical_xor", "broadcast_logical_xor")


# ---------------------------------------------------------------------------
# reductions: attrs axis (int or tuple), keepdims, exclude; an integer
# input keeps its type (no NumPy-style upcast), as in the JAX package
# ---------------------------------------------------------------------------

def _sum(x, axes, keepdims):
    return torch.sum(x, dim=axes, keepdim=keepdims, dtype=x.dtype)


def _mean(x, axes, keepdims):
    if not x.is_floating_point():
        x = x.to(torch.float32)
    return torch.mean(x, dim=axes, keepdim=keepdims)


def _prod(x, axes, keepdims):
    for a in sorted(axes, reverse=True):
        x = torch.prod(x, dim=a, keepdim=keepdims, dtype=x.dtype)
    return x


_REDUCE = {
    "sum": _sum,
    "mean": _mean,
    "prod": _prod,
    "max": lambda x, axes, keepdims: torch.amax(x, dim=axes,
                                                keepdim=keepdims),
    "min": lambda x, axes, keepdims: torch.amin(x, dim=axes,
                                                keepdim=keepdims),
    "nansum": lambda x, axes, keepdims: torch.nansum(x, dim=axes,
                                                     keepdim=keepdims),
    "nanprod": lambda x, axes, keepdims: _prod(
        torch.where(torch.isnan(x), torch.ones_like(x), x), axes, keepdims),
}


def _make_reduce(fn):
    def fcompute(data, *, axis=None, keepdims=False, exclude=False):
        axes = _norm_axis(axis, data.ndim, exclude)
        if not axes:
            return data
        return fn(data, axes, keepdims)
    return fcompute


for _name, _fn in _REDUCE.items():
    register(_name)(_make_reduce(_fn))

alias("sum_axis", "sum")


@register("norm")
def norm(data, *, ord=2, axis=None, keepdims=False):
    axes = _norm_axis(axis, data.ndim)
    if ord == 1:
        return torch.sum(torch.abs(data), dim=axes, keepdim=keepdims)
    return torch.sqrt(torch.sum(torch.square(data), dim=axes,
                                keepdim=keepdims))


@register("argmax")
def argmax(data, *, axis=None, keepdims=False):
    """Indices as float32, as MXNet returns them."""
    return torch.argmax(data, dim=axis, keepdim=keepdims).to(torch.float32)


@register("argmin")
def argmin(data, *, axis=None, keepdims=False):
    return torch.argmin(data, dim=axis, keepdim=keepdims).to(torch.float32)


# ---------------------------------------------------------------------------
# matrix products and shapes
# ---------------------------------------------------------------------------

register("dot", num_inputs=2)(_nn.dot)


@register("batch_dot", num_inputs=2)
def batch_dot(a, b, *, transpose_a=False, transpose_b=False):
    if transpose_a:
        a = torch.swapaxes(a, -1, -2)
    if transpose_b:
        b = torch.swapaxes(b, -1, -2)
    return torch.matmul(a, b)


def _reshape_target(shape_attr: Tuple[int, ...], src: Tuple[int, ...],
                    reverse=False):
    """Implement MXNet reshape magic codes 0, -1, -2, -3, -4."""
    if reverse:
        shape_attr = tuple(reversed(shape_attr))
        src = tuple(reversed(src))
    out = []
    src_i = 0
    i = 0
    attr = list(shape_attr)
    while i < len(attr):
        d = attr[i]
        if d == 0:
            out.append(src[src_i]); src_i += 1
        elif d == -1:
            out.append(-1); src_i += 1
        elif d == -2:
            out.extend(src[src_i:]); src_i = len(src)
        elif d == -3:
            out.append(src[src_i] * src[src_i + 1]); src_i += 2
        elif d == -4:
            d1, d2 = attr[i + 1], attr[i + 2]
            cur = src[src_i]; src_i += 1
            if d1 == -1:
                d1 = cur // d2
            if d2 == -1:
                d2 = cur // d1
            out.extend([d1, d2]); i += 2
        else:
            out.append(d); src_i += 1
        i += 1
    if reverse:
        out = list(reversed(out))
    return tuple(out)


@register("reshape")
def reshape(data, *, shape=(), reverse=False):
    return torch.reshape(data, _reshape_target(tuple(shape),
                                               tuple(data.shape), reverse))


alias("Reshape", "reshape")


@register("transpose")
def transpose(data, *, axes=()):
    axes = tuple(axes) if axes else tuple(range(data.ndim - 1, -1, -1))
    return data.permute(axes)


@register("expand_dims")
def expand_dims(data, *, axis=0):
    return torch.unsqueeze(data, axis)


@register("squeeze")
def squeeze(data, *, axis=None):
    if axis is None:
        return torch.squeeze(data)
    return torch.squeeze(data, axis)


@register("flatten")
def flatten(data):
    return torch.reshape(data, (data.shape[0], -1))


alias("Flatten", "flatten")


@register("broadcast_to")
def broadcast_to(data, *, shape=()):
    # MXNet semantics: 0 in the target shape keeps the source dim
    tgt = tuple(s if t == 0 else t for t, s in zip(shape, data.shape)) \
        if len(shape) == data.ndim else tuple(shape)
    return data.expand(tgt)


@register("broadcast_axis")
def broadcast_axis(data, *, axis=(), size=()):
    axes = (axis,) if isinstance(axis, int) else tuple(axis)
    sizes = (size,) if isinstance(size, int) else tuple(size)
    tgt = list(data.shape)
    for a, s in zip(axes, sizes):
        tgt[a] = s
    return data.expand(tuple(tgt))


@register("broadcast_like", num_inputs=2)
def broadcast_like(lhs, rhs):
    return lhs.expand(tuple(rhs.shape))


def _index(data, slices):
    """``data[slices]`` for Python slices, including negative steps
    (which PyTorch's indexing does not take)."""
    if all(s.step is None or s.step > 0 for s in slices):
        return data[tuple(slices)]
    out = data
    for axis, s in enumerate(slices):
        idx = torch.arange(*s.indices(out.shape[axis]), device=data.device)
        out = torch.index_select(out, axis, idx)
    return out


@register("slice")
def slice_op(data, *, begin=(), end=(), step=()):
    nd = data.ndim
    begin = tuple(begin) + (None,) * (nd - len(begin))
    end = tuple(end) + (None,) * (nd - len(end))
    step = tuple(step) + (None,) * (nd - len(step)) if step else (None,) * nd
    return _index(data, [builtins.slice(b, e, s)
                         for b, e, s in zip(begin, end, step)])


@register("slice_axis")
def slice_axis(data, *, axis=0, begin=0, end=None):
    idx = [builtins.slice(None)] * data.ndim
    idx[axis] = builtins.slice(begin, end)
    return data[tuple(idx)]


@register("_slice_basic")
def _slice_basic(x, *, key=()):
    """Basic indexing (``NDArray.__getitem__``): per-axis entries
    ('s', start, stop, step), ('i', index), ('e',) for Ellipsis or ('n',)
    for None.  The result is a view of ``x``."""
    def dec(e):
        if e[0] == "s":
            if e[3] is not None and e[3] < 0:
                raise MXNetError("basic indexing with a negative step is "
                                 "not supported; use nd.slice")
            return builtins.slice(e[1], e[2], e[3])
        if e[0] == "e":
            return Ellipsis
        if e[0] == "n":
            return None
        return int(e[1])

    return x[tuple(dec(e) for e in key)]


@register("concat", num_inputs=None)
def concat(*args, dim=1):
    return torch.cat(args, dim=dim)


alias("Concat", "concat")


@register("stack", num_inputs=None)
def stack(*args, axis=0):
    return torch.stack(args, dim=axis)


@register("split", num_outputs=-1)
def split(data, *, num_outputs=1, axis=1, squeeze_axis=False):
    n = data.shape[axis]
    if n % num_outputs:
        raise MXNetError(f"split: axis {axis} of size {n} does not divide "
                         f"into {num_outputs} outputs")
    parts = torch.split(data, n // num_outputs, dim=axis)
    if squeeze_axis:
        parts = [torch.squeeze(p, axis) for p in parts]
    return tuple(parts)


alias("SliceChannel", "split")


def _wrap_or_clip(indices, n, mode):
    idx = indices.long()
    if mode == "wrap":
        return torch.remainder(idx, n)
    if mode == "clip":
        return idx.clamp(0, n - 1)
    raise MXNetError(f"mode {mode!r}: use 'clip' or 'wrap'")


@register("take", num_inputs=2)
def take(a, indices, *, axis=0, mode="clip"):
    axis = axis % a.ndim
    idx = _wrap_or_clip(indices, a.shape[axis], mode)
    return torch.index_select(a, axis, idx.reshape(-1)).reshape(
        a.shape[:axis] + tuple(indices.shape) + a.shape[axis + 1:])


@register("pick", num_inputs=2)
def pick(data, index, *, axis=-1, keepdims=False, mode="clip"):
    if mode == "wrap":
        index = torch.remainder(index.long(), data.shape[axis])
    elif mode != "clip":
        raise MXNetError(f"pick: mode {mode!r}: use 'clip' or 'wrap'")
    return _nn.pick(data, index, axis=axis, keepdims=keepdims)


@register("one_hot")
def one_hot(indices, *, depth=0, on_value=1.0, off_value=0.0,
            dtype="float32"):
    """Rows of ``off_value`` with ``on_value`` at each index; an index out
    of [0, depth) gives a row of ``off_value``."""
    idx = indices.long()
    valid = (idx >= 0) & (idx < depth)
    hot = F.one_hot(torch.where(valid, idx, 0), depth) * valid[..., None]
    return (hot.to(torch_dtype(dtype)) * (on_value - off_value)
            + off_value)


@register("tile")
def tile(data, *, reps=()):
    return torch.tile(data, tuple(reps))


@register("repeat")
def repeat(data, *, repeats=1, axis=None):
    if axis is None:
        return torch.repeat_interleave(data.reshape(-1), repeats)
    return torch.repeat_interleave(data, repeats, dim=axis)


@register("where", num_inputs=3)
def where(condition, x, y):
    return torch.where(condition != 0, x, y)


@register("swapaxes")
def swapaxes(data, *, dim1=0, dim2=0):
    return torch.swapaxes(data, dim1, dim2)


alias("SwapAxis", "swapaxes")
