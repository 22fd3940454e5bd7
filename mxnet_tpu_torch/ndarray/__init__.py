"""``mx.nd``: NDArray and every registered operator as a function.

As the JAX package's ``ndarray/__init__.py``: the functions are generated
from the op registry, as the reference generates its op stubs.  Tensor
arguments are the leading positional arguments (NDArrays); operator
attributes follow positionally (scalar attrs first, then the rest in
declaration order) or as keywords; every op takes ``out=``, and ops with
no tensor input take ``ctx=``.  ``BatchNorm`` updates the moving
statistics it is given, in place, when training, and
``_cache_update(..., out=cache)`` writes the cache in place.
``nd.contrib`` holds the control-flow ops (``foreach``, ``while_loop``,
``cond``) and every op, a ``_contrib_`` one without its prefix, and
``nd.sparse`` the row_sparse and csr arrays.  ``nd.save``/``nd.load``
write and read the JAX package's files (and read the reference's dmlc
``.params`` files).  ``nd.RNN`` raises ``NotImplementedError`` as in the
JAX package.
"""
from __future__ import annotations

import sys

from .. import ops  # noqa: F401  (registers every op)
from ..ops.registry import OpDef, get_op, list_ops
from .ndarray import (NDArray, arange, array, concatenate, empty, eye, full,
                      invoke, load, load_buffer, moveaxis, ones, save,
                      waitall, zeros)

_mod = sys.modules[__name__]


def _make_wrapper(opname: str, op: OpDef):
    ordered_attrs = tuple(op.scalar_attrs) + tuple(op.attr_names)

    def fn(*args, **kwargs):
        out = kwargs.pop("out", None)
        ctx = kwargs.pop("ctx", None)
        kwargs.pop("name", None)
        inputs = []
        attr_pos = []
        for a in args:
            if isinstance(a, NDArray):
                inputs.append(a)
            else:
                attr_pos.append(a)
        if len(attr_pos) > len(ordered_attrs):
            raise TypeError(f"{opname}: too many positional arguments")
        for name, val in zip(ordered_attrs, attr_pos):
            if name in kwargs:
                raise TypeError(f"{opname}: got multiple values for {name}")
            kwargs[name] = val
        return invoke(op, inputs, out=out, ctx=ctx, **kwargs)

    fn.__name__ = opname
    fn.__qualname__ = opname
    fn.__doc__ = op.doc
    return fn


def _generate(target_mod):
    for opname in list_ops():
        fn = _CUSTOM.get(opname)
        setattr(target_mod, opname,
                fn if fn is not None else _make_wrapper(opname,
                                                        get_op(opname)))


# ---------------------------------------------------------------------------
# ops that need frontend logic (mode flags, scalar-or-array operands)
# ---------------------------------------------------------------------------


def Dropout(data, p=0.5, mode="training", axes=(), **kwargs):
    """Parity: nd.Dropout.  Active in training mode (or ``mode="always"``);
    the mask comes from the device's ``mx.random`` stream."""
    from .. import autograd
    from .. import random as _rnd
    training = autograd.is_training() or mode == "always"
    if not training or p <= 0.0:
        return invoke(get_op("identity"), [data])
    return invoke(get_op("Dropout"), [data], p=p, mode=mode,
                  axes=tuple(axes), training=True,
                  generator=_rnd.generator(data.context.device))


def BatchNorm(data, gamma, beta, moving_mean, moving_var, eps=1e-5,
              momentum=0.9, fix_gamma=True, use_global_stats=False,
              output_mean_var=False, axis=1, **kwargs):
    """Parity: nd.BatchNorm.  In training mode (``autograd.is_training()``
    and not ``use_global_stats``) it normalises by the batch's statistics
    and then updates ``moving_mean`` and ``moving_var`` in place, outside
    the tape: ``m * moving + (1 - m) * batch`` with the biased variance."""
    from .. import autograd
    from ..ops.nn import update_moving_stats
    training = autograd.is_training() and not use_global_stats
    out, mean, var = invoke(get_op("BatchNorm"),
                            [data, gamma, beta, moving_mean, moving_var],
                            eps=eps, momentum=momentum, fix_gamma=fix_gamma,
                            use_global_stats=use_global_stats, axis=axis,
                            training=training)
    if training:
        update_moving_stats(moving_mean._t, moving_var._t, mean._t, var._t,
                            momentum)
    return (out, mean, var) if output_mean_var else out


def maximum(lhs, rhs, out=None):
    """Parity: nd.maximum — scalar or array operands."""
    if isinstance(lhs, NDArray) and isinstance(rhs, NDArray):
        return invoke(get_op("broadcast_maximum"), [lhs, rhs], out=out)
    if isinstance(lhs, NDArray):
        return invoke(get_op("_maximum_scalar"), [lhs], scalar=rhs, out=out)
    if isinstance(rhs, NDArray):
        return invoke(get_op("_maximum_scalar"), [rhs], scalar=lhs, out=out)
    return max(lhs, rhs)


def minimum(lhs, rhs, out=None):
    """Parity: nd.minimum — scalar or array operands."""
    if isinstance(lhs, NDArray) and isinstance(rhs, NDArray):
        return invoke(get_op("broadcast_minimum"), [lhs, rhs], out=out)
    if isinstance(lhs, NDArray):
        return invoke(get_op("_minimum_scalar"), [lhs], scalar=rhs, out=out)
    if isinstance(rhs, NDArray):
        return invoke(get_op("_minimum_scalar"), [rhs], scalar=lhs, out=out)
    return min(lhs, rhs)


def _cache_update(cache, new, offset=0, out=None, **kwargs):
    """Parity: nd._cache_update.  ``out=cache`` (the decode step's call,
    outside ``autograd.record()``) writes ``new`` into the cache's own
    storage; anything else runs the op, which makes a new array."""
    from .. import autograd
    from ..ops.nn import cache_update
    if out is not None and out._t is cache._t \
            and not autograd.is_recording():
        cache_update(cache._t, new._t,
                     offset._t if isinstance(offset, NDArray) else offset)
        return out
    return invoke(get_op("_cache_update"), [cache, new], out=out,
                  offset=offset)


_CUSTOM = {"BatchNorm": BatchNorm, "Dropout": Dropout, "maximum": maximum,
           "minimum": minimum, "_cache_update": _cache_update}

_generate(_mod)

from . import contrib, random, sparse  # noqa: E402

__all__ = ["NDArray", "array", "empty", "zeros", "ones", "full", "arange",
           "eye", "concatenate", "waitall", "invoke", "contrib", "random",
           "sparse", "moveaxis", "save", "load", "load_buffer"]
