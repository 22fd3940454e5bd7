"""Parity helper for the port's tests: one callable run through both
packages on the same numpy inputs, value and gradient compared.

``fn(F, *arrays)`` is written once against an ``mx.nd``-like namespace
``F``; it runs as ``fn(mxnet_tpu.nd, ...)`` on the JAX package's NDArrays
and as ``fn(mxnet_tpu_torch.nd, ...)`` on the port's, both on the CPU.
The gradient is that of ``sum(out * w)`` for a fixed ramp ``w``, with
respect to every floating-point input.
"""
import numpy as np

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx


def _ramp(shape):
    n = int(np.prod(shape)) if shape else 1
    return np.linspace(-1.0, 1.0, n, dtype="float32").reshape(shape)


def run(pkg, fn, arrays, grad=True):
    """(outputs, input gradients) of ``fn`` in ``pkg`` (``jmx`` or
    ``tmx``), as numpy arrays."""
    F, ag, ctx = pkg.nd, pkg.autograd, pkg.cpu()
    xs = [F.array(a, ctx=ctx, dtype=a.dtype) for a in arrays]
    diff = [x for x, a in zip(xs, arrays) if a.dtype.kind == "f"] \
        if grad else []
    for x in diff:
        x.attach_grad()
    if not diff:
        out = fn(F, *xs)
        outs = out if isinstance(out, (list, tuple)) else [out]
        return [o.asnumpy() for o in outs], []
    with ag.record():
        out = fn(F, *xs)
        outs = out if isinstance(out, (list, tuple)) else [out]
        loss = None
        for o in outs:
            term = (o * F.array(_ramp(o.shape), ctx=ctx)).sum()
            loss = term if loss is None else loss + term
    loss.backward()
    return [o.asnumpy() for o in outs], [x.grad.asnumpy() for x in diff]


def check(fn, arrays, rtol=1e-5, atol=1e-6, grad=True, dtype=True):
    """Run ``fn`` in both packages; outputs (and dtypes) and gradients
    must agree to ``rtol``/``atol``.  Returns the port's outputs."""
    arrays = [np.asarray(a) for a in arrays]
    j_out, j_grad = run(jmx, fn, arrays, grad)
    t_out, t_grad = run(tmx, fn, arrays, grad)
    assert len(j_out) == len(t_out)
    for j, t in zip(j_out, t_out):
        if dtype:
            assert j.dtype == t.dtype, (j.dtype, t.dtype)
        assert j.shape == t.shape, (j.shape, t.shape)
        np.testing.assert_allclose(t.astype("f8"), j.astype("f8"),
                                   rtol=rtol, atol=atol)
    for j, t in zip(j_grad, t_grad):
        np.testing.assert_allclose(t, j, rtol=rtol, atol=atol)
    return t_out
