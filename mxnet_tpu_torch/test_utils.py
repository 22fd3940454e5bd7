"""Test utilities, as the JAX package's ``test_utils.py``: the per-dtype
tolerance table, ``assert_almost_equal``, random arrays and
``check_numeric_gradient`` (central differences, the universal backward
oracle), on the port's NDArrays."""
from __future__ import annotations

from typing import Callable

import numpy as np

from .context import Context, current_context

__all__ = ["default_context", "set_default_context", "assert_almost_equal",
           "rand_ndarray", "check_numeric_gradient"]

_default = [None]

# per-dtype (rtol, atol), the reference's tolerance table
_TOLS = {
    "float16": (1e-2, 1e-2),
    "bfloat16": (1e-2, 1e-2),
    "float32": (1e-4, 1e-5),
    "float64": (1e-6, 1e-7),
}


def default_context() -> Context:
    return _default[0] if _default[0] is not None else current_context()


def set_default_context(ctx: Context):
    _default[0] = ctx


def _tol(*dtypes):
    """The loosest (rtol, atol) of ``dtypes``; (1e-4, 1e-5) for types not
    in the table."""
    rtol, atol = 0.0, 0.0
    for d in dtypes:
        r, a = _TOLS.get(np.dtype(d).name, (1e-4, 1e-5))
        rtol, atol = max(rtol, r), max(atol, a)
    return rtol, atol


def _np(x):
    from .ndarray.ndarray import NDArray
    return x.asnumpy() if isinstance(x, NDArray) else np.asarray(x)


def assert_almost_equal(a, b, rtol=None, atol=None, names=("a", "b")):
    a_np, b_np = _np(a), _np(b)
    r, t = _tol(a_np.dtype, b_np.dtype)
    np.testing.assert_allclose(
        a_np.astype("f8"), b_np.astype("f8"),
        rtol=rtol if rtol is not None else r,
        atol=atol if atol is not None else t,
        err_msg=f"{names[0]} != {names[1]}")


def rand_ndarray(shape, ctx=None, dtype="float32", scale=1.0):
    from .ndarray.ndarray import array
    data = np.random.uniform(-scale, scale, size=shape).astype(dtype)
    return array(data, ctx=ctx or default_context(), dtype=dtype)


def check_numeric_gradient(f: Callable, inputs, eps=1e-3, rtol=1e-2,
                           atol=1e-3):
    """Autograd gradients of ``sum(f(*inputs))`` (NDArrays in, NDArray
    out) against central differences."""
    from . import autograd
    from .ndarray import sum as nd_sum

    inputs = list(inputs)
    for x in inputs:
        if x.grad is None:
            x.attach_grad()
    with autograd.record():
        loss = nd_sum(f(*inputs))
    loss.backward()
    analytic = [x.grad.asnumpy() for x in inputs]

    for xi, x in enumerate(inputs):
        x_np = x.asnumpy().astype("f8")
        num = np.zeros_like(x_np)
        flat, num_flat = x_np.reshape(-1), num.reshape(-1)
        for i in range(flat.size):
            orig = flat[i]
            vals = []
            for v in (orig + eps, orig - eps):
                flat[i] = v
                x[:] = x_np.astype(x.dtype)
                vals.append(nd_sum(f(*inputs)).asscalar())
            flat[i] = orig
            x[:] = x_np.astype(x.dtype)
            num_flat[i] = (vals[0] - vals[1]) / (2 * eps)
        np.testing.assert_allclose(analytic[xi], num, rtol=rtol, atol=atol,
                                   err_msg=f"gradient mismatch on input "
                                           f"{xi}")
