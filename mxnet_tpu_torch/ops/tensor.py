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

The ordering ops keep the JAX package's order among equal elements:
``topk`` puts the lower index first (``lax.top_k``), a descending
``sort``/``argsort`` is the flip of the stable ascending order (the higher
index first).  ``_cache_update`` clamps its offset as
``lax.dynamic_update_slice`` does, and ``nd._cache_update(..., out=cache)``
writes in place.

Not ported yet (ROADMAP queue 1 item 2.7): ``linalg_*``, ``khatri_rao``,
the interleaved attention products, and the sampling, mixture-of-experts
and quantization ``_contrib_*`` ops (the detection ops are in
``ops/det.py``).
"""
from __future__ import annotations

import builtins
import functools
from typing import Tuple

import torch
import torch.nn.functional as F

from ..base import MXNetError, torch_dtype
from ..contrib import amp
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
    """``matmul`` over the last two axes; int8 operands give the exact
    int32 product."""
    a, b = amp.cast_inputs("batch_dot", a, b)
    if transpose_a:
        a = torch.swapaxes(a, -1, -2)
    if transpose_b:
        b = torch.swapaxes(b, -1, -2)
    if _nn._q.both_int8(a, b):
        return _nn._q.int8_batch_matmul(a, b)
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


@register("add_n", num_inputs=None)
def add_n(*arrays):
    """The element-wise sum of the arrays (``ElementWiseSum``)."""
    out = arrays[0]
    for a in arrays[1:]:
        out = out + a
    return out


alias("ElementWiseSum", "add_n")


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


@register("depth_to_space")
def depth_to_space(data, *, block_size=1):
    """(N, C, H, W) to (N, C / b^2, H b, W b), the block taken from the
    channels in the reference's DCR order: channel ``(i b + j) C / b^2 +
    c`` goes to pixel offset (i, j) of channel c (``F.pixel_shuffle``'s
    CRD order differs)."""
    n, c, h, w = data.shape
    b = block_size
    x = data.reshape(n, b, b, c // (b * b), h, w).permute(0, 3, 4, 1, 5, 2)
    return x.reshape(n, c // (b * b), h * b, w * b)


@register("space_to_depth")
def space_to_depth(data, *, block_size=1):
    """The inverse of :func:`depth_to_space`: each b x b block of pixels
    into b^2 channel groups, block offset first."""
    n, c, h, w = data.shape
    b = block_size
    x = data.reshape(n, c, h // b, b, w // b, b).permute(0, 3, 5, 1, 2, 4)
    return x.reshape(n, c * b * b, h // b, w // b)


# -- sequence ops (reference ``src/operator/sequence_*.cc``) ------------------

def _valid_steps(data, seqlen, axis):
    """(T, B) or (B, T) boolean: step t of row b lies inside its length,
    shaped to broadcast over ``data``."""
    steps = torch.arange(data.shape[axis], device=data.device)
    lens = seqlen.to(device=data.device).long()
    mask = steps[:, None] < lens[None, :] if axis == 0 else \
        steps[None, :] < lens[:, None]
    return mask.reshape(mask.shape + (1,) * (data.dim() - 2))


@register("SequenceMask", num_inputs=None)
def sequence_mask(data, *rest, use_sequence_length=False, value=0.0,
                  axis=0):
    """Steps at or past each row's length set to ``value``."""
    if not use_sequence_length:
        return data
    return torch.where(_valid_steps(data, rest[0], axis), data,
                       torch.full((), value, dtype=data.dtype,
                                  device=data.device))


@register("SequenceReverse", num_inputs=None)
def sequence_reverse(data, *rest, use_sequence_length=False, axis=0):
    """Time-major (T, B, ...) data with each row's first ``length``
    steps reversed; the padding stays where it is."""
    if not use_sequence_length:
        return torch.flip(data, dims=(0,))
    lens = rest[0].to(device=data.device).long()
    steps = torch.arange(data.shape[0], device=data.device)[:, None]
    idx = torch.where(steps < lens[None, :], lens[None, :] - 1 - steps,
                      steps)                                  # (T, B)
    batch = torch.arange(data.shape[1], device=data.device)[None, :]
    return data[idx, batch]


# -- padding (reference ``ops/tensor.py`` ``pad``) -----------------------------

_PAD_MODES = {"constant": "constant", "edge": "replicate",
              "reflect": "reflect"}


@register("pad")
def pad(data, *, mode="constant", pad_width=(), constant_value=0.0):
    """Pad each axis by the (before, after) pair ``pad_width`` gives for
    it, first axis first (``F.pad`` takes them last axis first):
    ``constant`` with ``constant_value``, ``edge`` (the border value
    repeated, PyTorch's ``replicate``) or ``reflect`` (mirrored without
    the border).  PyTorch pads the last one, two or three axes only in
    the last two modes, so there the pairs of every axis before those
    must be 0."""
    if mode not in _PAD_MODES:
        raise MXNetError(f"pad: mode {mode!r}; options "
                         f"{sorted(_PAD_MODES)}")
    pw = [int(v) for v in pad_width]
    if len(pw) != 2 * data.dim():
        raise MXNetError(f"pad: pad_width has {len(pw)} values for "
                         f"{data.dim()} axes; it needs a pair an axis")
    pairs = [(pw[2 * i], pw[2 * i + 1]) for i in range(data.dim())]
    padded = [i for i, p in enumerate(pairs) if p != (0, 0)]
    if not padded:
        return data.clone()
    if mode == "constant":
        flat = [v for p in reversed(pairs) for v in p]
        return F.pad(data, flat, value=constant_value)
    k = data.dim() - padded[0]          # the trailing axes PyTorch pads
    if k > 3:
        raise MXNetError(f"pad: mode {mode!r} pads at most the last three "
                         f"axes; pad_width {tuple(pw)} pads axis "
                         f"{padded[0]} of {data.dim()}")
    lead = data.shape[:data.dim() - k]
    x = data.reshape((1, -1) + tuple(data.shape[data.dim() - k:]))
    flat = [v for p in reversed(pairs[data.dim() - k:]) for v in p]
    out = F.pad(x, flat, mode=_PAD_MODES[mode])
    return out.reshape(tuple(lead) + tuple(out.shape[2:]))


alias("Pad", "pad")


# -- ordering (reference ``src/operator/tensor/ordering_op.cc``) --------------
# torch.sort(stable=True) keeps equal elements in their input order, so
# the first k of a descending stable sort are lax.top_k's (the lower index
# first among ties); a descending sort or argsort is the flip of the stable
# ascending one (the higher index first), as in the JAX package.

@register("sort")
def sort(data, *, axis=-1, is_ascend=True):
    out = torch.sort(data, dim=axis, stable=True).values
    return out if is_ascend else torch.flip(out, dims=(axis,))


@register("argsort")
def argsort(data, *, axis=-1, is_ascend=True, dtype="float32"):
    idx = torch.argsort(data, dim=axis, stable=True)
    if not is_ascend:
        idx = torch.flip(idx, dims=(axis,))
    return idx.to(torch_dtype(dtype))


@register("topk", num_outputs=-1)
def topk(data, *, axis=-1, k=1, ret_typ="indices", is_ascend=False,
         dtype="float32"):
    """The ``k`` largest (``is_ascend``: smallest) along ``axis``, best
    first: values, indices (as ``dtype``) or both."""
    vals, idx = torch.sort(data, dim=axis, descending=not is_ascend,
                           stable=True)
    vals, idx = vals.narrow(axis, 0, k), idx.narrow(axis, 0, k)
    if ret_typ == "value":
        return vals
    if ret_typ == "both":
        return vals, idx.to(torch_dtype(dtype))
    return idx.to(torch_dtype(dtype))


@register("argmax_channel")
def argmax_channel(data):
    return torch.argmax(data, dim=1).to(torch.float32)


# -- shape, sequence and triangle ops --------------------------------------------

@register("slice_like", num_inputs=2)
def slice_like(data, shape_like, *, axes=()):
    axes = tuple(axes) if axes else tuple(range(shape_like.dim()))
    idx = [builtins.slice(None)] * data.dim()
    for a in axes:
        idx[a] = builtins.slice(0, shape_like.shape[a])
    return data[tuple(idx)]


@register("SequenceLast", num_inputs=None)
def sequence_last(data, *rest, use_sequence_length=False, axis=0):
    """Each row's last valid step along ``axis``; a length of 0 reads
    the last step and one past the end is clamped to it, as the JAX
    package's gather."""
    if not use_sequence_length:
        return data.select(axis, -1)
    data_t = torch.movedim(data, axis, 0)
    n = data_t.shape[0]
    last = _wrap_negative(rest[0].to(device=data.device).long() - 1, n)
    return data_t[last.clamp(0, n - 1),
                  torch.arange(data_t.shape[1], device=data.device)]


@register("reverse")
def reverse(data, *, axis=()):
    axes = (axis,) if isinstance(axis, int) else tuple(axis)
    return torch.flip(data, dims=axes)


alias("flip", "reverse")


@register("roll")
def roll(data, *, shift=0, axis=None):
    shift = tuple(shift) if isinstance(shift, (tuple, list)) else shift
    axis = tuple(axis) if isinstance(axis, (tuple, list)) else axis
    return torch.roll(data, shift, dims=axis)


@register("tril")
def tril(data, *, k=0):
    return torch.tril(data, diagonal=k)


@register("triu")
def triu(data, *, k=0):
    return torch.triu(data, diagonal=k)


@register("diag")
def diag(data, *, k=0):
    if data.dim() == 1:
        return torch.diag(data, k)
    return torch.diagonal(data, offset=k, dim1=-2, dim2=-1)


def _keep_int(x):
    """The dtype that keeps an integer input's type through a sum (the
    JAX package's, without x64); None for floating inputs."""
    return None if x.is_floating_point() else x.dtype


@register("trace")
def trace(data, *, offset=0, axis1=0, axis2=1):
    diag_ = torch.diagonal(data, offset=offset, dim1=axis1, dim2=axis2)
    return torch.sum(diag_, dim=-1, dtype=_keep_int(data))


def _cumulative(fn, a, axis, dtype):
    x = a if axis is not None else a.reshape(-1)
    out = fn(x, dim=axis if axis is not None else 0, dtype=_keep_int(a))
    return out.to(torch_dtype(dtype)) if dtype else out


@register("cumsum")
def cumsum(a, *, axis=None, dtype=None):
    return _cumulative(torch.cumsum, a, axis, dtype)


@register("cumprod")
def cumprod(a, *, axis=None, dtype=None):
    return _cumulative(torch.cumprod, a, axis, dtype)


@register("square_sum")
def square_sum(data, *, axis=None, keepdims=False, exclude=False):
    axes = _norm_axis(axis, data.dim(), exclude)
    return torch.sum(torch.square(data), dim=axes, keepdim=keepdims)


@register("log_sum_exp")
def log_sum_exp(data, *, axis=None, keepdims=False):
    axes = _norm_axis(axis, data.dim())
    return torch.logsumexp(data, dim=axes, keepdim=keepdims)


# -- gathers and scatters (reference ``indexing_op.cc``) -------------------------

def _wrap_negative(idx, size):
    return torch.where(idx < 0, idx + size, idx)


@register("gather_nd", num_inputs=2)
def gather_nd(data, indices):
    """``data[indices[0], indices[1], ...]``: a negative index counts
    from the end and one out of range is clamped, as JAX's gather."""
    idx = indices.long()
    return data[tuple(_wrap_negative(i, n).clamp(0, n - 1)
                      for i, n in zip(idx, data.shape))]


register("gather_nd_raw", num_inputs=2)(gather_nd)


@register("scatter_nd", num_inputs=2)
def scatter_nd(data, indices, *, shape=()):
    """Zeros of ``shape`` with ``data``'s items at the coordinates
    ``indices`` (M, N...) gives.  Where several items share a
    coordinate the last one is written and only it takes the gradient,
    and an item out of range is dropped, as JAX's scatter on the CPU."""
    shape = tuple(shape)
    idx = indices.long()
    m = idx.shape[0]
    dims = shape[:m]
    coords = [_wrap_negative(i, n) for i, n in zip(idx, dims)]
    ok = functools.reduce(torch.logical_and,
                          [(c >= 0) & (c < n) for c, n in zip(coords, dims)])
    cells = 1
    lin = torch.zeros_like(coords[0])
    for c, n in zip(coords, dims):
        lin = lin * n + c.clamp(0, n - 1)
        cells *= n
    lin, ok = lin.reshape(-1), ok.reshape(-1)
    order = torch.arange(lin.numel(), device=lin.device)
    last = torch.full((cells,), -1, dtype=torch.long, device=lin.device)
    last = last.scatter_reduce(0, lin[ok], order[ok], "amax")
    win = ok & (last[lin] == order)
    items = data.reshape((lin.numel(),) + shape[m:])
    out = torch.zeros((cells,) + shape[m:], dtype=data.dtype,
                      device=data.device)
    return out.index_put((lin[win],), items[win]).reshape(shape)


@register("batch_take", num_inputs=2)
def batch_take(a, indices):
    """``a[i, indices[i]]`` for each row of ``a`` (N, K): a negative
    index counts from the end, one out of range reads NaN (JAX's
    ``take_along_axis`` fill)."""
    n = a.shape[1]
    idx = _wrap_negative(indices.long(), n)
    out = a.gather(1, idx.clamp(0, n - 1)[:, None])[:, 0]
    if a.is_floating_point():
        out = torch.where((idx >= 0) & (idx < n), out,
                          torch.full((), float("nan"), dtype=a.dtype,
                                     device=a.device))
    return out


@register("ravel_multi_index")
def ravel_multi_index(data, *, shape=()):
    """(N, M) coordinate rows -> (M,) flat indices, in ``data``'s type."""
    idx = data.long()
    strides = [1] * len(shape)
    for i in range(len(shape) - 2, -1, -1):
        strides[i] = strides[i + 1] * int(shape[i + 1])
    flat = sum(idx[i] * s for i, s in enumerate(strides))
    return flat.to(data.dtype)


@register("unravel_index")
def unravel_index(data, *, shape=()):
    """(M,) flat indices -> (N, M) coordinate rows, in ``data``'s type;
    an index past the end reads the last coordinate and one below -1 the
    first, as ``jnp.unravel_index``."""
    rest = data.long()
    coords = [None] * len(shape)
    for i in range(len(shape) - 1, -1, -1):
        rest, coords[i] = (torch.div(rest, int(shape[i]),
                                     rounding_mode="floor"),
                           torch.remainder(rest, int(shape[i])))
    coords = [torch.where(rest > 0, int(s) - 1,
                          torch.where(rest < -1, 0, c))
              for s, c in zip(shape, coords)]
    return torch.stack(coords).to(data.dtype)


# -- _cache_update: the decode step's KV-cache write ----------------------------

@register("_cache_update", num_inputs=2, scalar_attrs=("offset",),
          scalar_ref_input=None)
def _cache_update(cache, new, offset=0):
    """``cache`` with ``new`` written at ``offset`` along axis 1 (see
    ``ops.nn.cache_update``), as a new array; ``nd._cache_update(cache,
    new, offset, out=cache)`` writes the cache in place."""
    return _nn.cache_update(cache.clone(), new, offset)


# -- creation and elementwise ------------------------------------------------------

@register("linspace", num_inputs=0, wrap_ctx=True)
def linspace(*, start=0.0, stop=1.0, num=50, endpoint=True,
             dtype="float32", device=None):
    n = int(num)
    out = torch.linspace(start, stop, n if endpoint else n + 1,
                         dtype=torch.float64, device=device)
    return out[:n].to(torch_dtype(dtype))


@register("logspace", num_inputs=0, wrap_ctx=True)
def logspace(*, start=0.0, stop=1.0, num=50, endpoint=True, base=10.0,
             dtype="float32", device=None):
    exps = linspace(start=start, stop=stop, num=num, endpoint=endpoint,
                    dtype="float64", device=device)
    return torch.pow(float(base), exps).to(torch_dtype(dtype))


@register("hard_sigmoid")
def hard_sigmoid(data, *, alpha=0.2, beta=0.5):
    return torch.clamp(alpha * data + beta, 0.0, 1.0)


@register("digamma")
def digamma(data):
    return torch.special.digamma(data)


@register("smooth_l1")
def smooth_l1(data, *, scalar=1.0):
    """The reference's smooth L1: quadratic below 1 / scalar**2."""
    s2 = scalar * scalar
    a = torch.abs(data)
    return torch.where(a < 1.0 / s2, 0.5 * s2 * data * data, a - 0.5 / s2)


# -- nd.contrib (reference ``src/operator/contrib/``) -----------------------------

@register("_contrib_arange_like")
def arange_like(data, *, start=0.0, step=1.0, repeat=1, axis=None):
    """``start + step * (i // repeat)`` over ``data``'s elements (or the
    length of ``axis``), in ``data``'s type."""
    n = data.numel() if axis is None else data.shape[axis]
    ramp = torch.div(torch.arange(n, device=data.device), repeat,
                     rounding_mode="floor").to(torch.float32)
    out = (start + step * ramp).to(data.dtype)
    return out.reshape(data.shape) if axis is None else out


@register("_contrib_index_array")
def index_array(data, *, axes=None):
    """Each element's index (int32), (*data.shape, len(axes))."""
    grids = torch.meshgrid(*[torch.arange(s, device=data.device)
                             for s in data.shape], indexing="ij")
    sel = range(data.dim()) if axes is None else axes
    return torch.stack([grids[a] for a in sel], dim=-1).to(torch.int32)


@register("_contrib_AdaptiveAvgPooling2D", num_inputs=1)
def adaptive_avg_pooling(data, *, output_size=()):
    """(N, C, H, W) average-pooled to ``output_size`` (one int, a pair, or
    () for 1 x 1), output i's window along an axis of n inputs being
    ``floor(i n / o)`` to ``ceil((i + 1) n / o)``, the reference's
    windows: one product with each axis's window-mean matrix."""
    if not output_size:
        oh = ow = 1
    elif isinstance(output_size, int):
        oh = ow = int(output_size)
    elif len(output_size) == 1:
        oh = ow = int(output_size[0])
    else:
        oh, ow = int(output_size[0]), int(output_size[1])
    return _nn._separable_map(data, "pool", oh, ow)


@register("_contrib_index_copy", num_inputs=3)
def index_copy(old, index, new):
    """``old`` with the rows of ``new`` at ``index`` along axis 0, as a
    new array."""
    idx = _wrap_negative(index.long(), old.shape[0])
    return old.index_put((idx,), new.to(old.dtype))


# ---------------------------------------------------------------------------
# the linalg family and khatri_rao (reference la_op.cc, krprod.cc): float32
# products in float32 on the card (no TF32), forward and backward
# ---------------------------------------------------------------------------

def _t(a):
    return torch.swapaxes(a, -1, -2)


@register("linalg_gemm2", num_inputs=2)
def linalg_gemm2(a, b, *, transpose_a=False, transpose_b=False, alpha=1.0):
    """``alpha * op(a) @ op(b)`` over the last two axes."""
    a, b = amp.cast_inputs("linalg_gemm2", a, b)
    if transpose_a:
        a = _t(a)
    if transpose_b:
        b = _t(b)
    return alpha * _nn.ieee_f32(torch.matmul, a, b)


@register("linalg_potrf")
def linalg_potrf(a):
    """The lower Cholesky factor, batched (the input symmetrized, as
    ``jnp.linalg.cholesky``)."""
    return _nn.ieee_f32(lambda x: torch.linalg.cholesky((x + _t(x)) / 2), a)


@register("linalg_potri")
def linalg_potri(a):
    """``inv(L @ L.T)`` from the lower Cholesky factor ``L`` (its lower
    triangle read)."""
    def f(x):
        eye = torch.eye(x.shape[-1], dtype=x.dtype,
                        device=x.device).expand(x.shape)
        linv = torch.linalg.solve_triangular(x, eye, upper=False)
        return torch.matmul(_t(linv), linv)
    return _nn.ieee_f32(f, a)


@register("linalg_syrk")
def linalg_syrk(a, *, transpose=False, alpha=1.0):
    """``alpha * a.T @ a`` (``transpose``) or ``alpha * a @ a.T``."""
    def f(x):
        return torch.matmul(_t(x), x) if transpose \
            else torch.matmul(x, _t(x))
    return alpha * _nn.ieee_f32(f, a)


@register("linalg_trmm", num_inputs=2)
def linalg_trmm(a, b, *, transpose=False, rightside=False, lower=True,
                alpha=1.0):
    """``alpha * op(tri(a)) @ b`` (or ``b @ op(tri(a))`` with
    ``rightside``), ``tri`` the lower or upper triangle."""
    def f(x, y):
        tri = torch.tril(x) if lower else torch.triu(x)
        if transpose:
            tri = _t(tri)
        return torch.matmul(y, tri) if rightside else torch.matmul(tri, y)
    return alpha * _nn.ieee_f32(f, a, b)


@register("linalg_trsm", num_inputs=2)
def linalg_trsm(a, b, *, transpose=False, rightside=False, lower=True,
                alpha=1.0):
    """Solve ``op(A) X = alpha B`` (or ``X op(A) = alpha B`` with
    ``rightside``) for triangular ``A``; ``op(A)`` is ``A.T`` with
    ``transpose``."""
    def f(x, y):
        if rightside:
            # X op(A) = alpha B  ->  op(A).T X.T = alpha B.T
            opat = x if transpose else _t(x)
            low = lower if transpose else not lower
            return _t(torch.linalg.solve_triangular(opat, _t(alpha * y),
                                                    upper=not low))
        opa = _t(x) if transpose else x
        low = (not lower) if transpose else lower
        return torch.linalg.solve_triangular(opa, alpha * y, upper=not low)
    return _nn.ieee_f32(f, a, b)


@register("linalg_gelqf", num_outputs=2)
def linalg_gelqf(a):
    """The LQ factorization ``A = L Q``, Q with orthonormal rows: returns
    (L, Q), the JAX package's order."""
    def f(x):
        q, r = torch.linalg.qr(_t(x), mode="reduced")
        return _t(r), _t(q)
    return _nn.ieee_f32(f, a)


@register("linalg_sumlogdiag")
def linalg_sumlogdiag(a):
    """The sum of the logs of the diagonal, batched."""
    return torch.sum(torch.log(torch.diagonal(a, dim1=-2, dim2=-1)), dim=-1)


@register("khatri_rao", num_inputs=None)
def khatri_rao(*mats):
    """The column-wise Kronecker product: (r_i, k) inputs to
    (prod r_i, k)."""
    out = mats[0]
    for m in mats[1:]:
        out = (out[:, None, :] * m[None, :, :]).reshape(-1, out.shape[-1])
    return out
