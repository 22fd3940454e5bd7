"""The port's ``Convolution``, ``Pooling`` and ``BatchNorm`` against the
JAX package's ops, value and gradient.

Both packages take the same numpy inputs (seeded) and the same
attributes through their registries; the gradients are those of
``sum(out * w)`` for a fixed numpy ``w``, by ``jax.vjp`` on the JAX op
and PyTorch's autograd on the port's.  Tolerances are the per-dtype ones
of ``mxnet_tpu/test_utils.py``: float32 rtol 1e-4, atol 1e-5; bfloat16
rtol = atol = 1e-2.

* Convolution: 1-, 2- and 3-D, stride, pad, dilate, groups, with and
  without bias.
* Pooling: max, avg (with and without ``count_include_pad``), sum and lp
  under the valid, full and same conventions, at shapes where "full"
  keeps a last window that starts in the right padding (PyTorch's
  ``ceil_mode`` would drop it) and "same" pads asymmetrically; global
  max and average.
* BatchNorm: training (batch statistics) and predict (moving ones),
  ``fix_gamma``, ``use_global_stats``, a channel axis other than 1, the
  moving-statistics update of ``nd.BatchNorm`` (biased variance,
  momentum 0.9) and a bfloat16 input with float32 gamma and beta (both
  promote to float32).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu.ops.registry import get_op as jax_op
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, nd
from mxnet_tpu_torch.ops.registry import get_op as port_op

F32 = dict(rtol=1e-4, atol=1e-5)
BF16 = dict(rtol=1e-2, atol=1e-2)


def _head(shape, seed=9):
    return np.random.RandomState(seed).uniform(-1, 1, shape).astype("f4")


def _jax_run(name, arrays, attrs, diff):
    """The JAX op's first output and the gradients of sum(out * w) with
    respect to the inputs ``diff`` marks."""
    fn = jax_op(name).fcompute

    def f(*xs):
        it = iter(xs)
        args = [jnp.asarray(next(it)) if d else jnp.asarray(a)
                for a, d in zip(arrays, diff)]
        out = fn(*args, **attrs)
        return out[0] if isinstance(out, tuple) else out
    primals = [a for a, d in zip(arrays, diff) if d]

    @jax.jit          # the op and its gradient in one compiled program
    def run(*primals):
        out, vjp = jax.vjp(f, *primals)
        return out, vjp(jnp.asarray(_head(out.shape)).astype(out.dtype))
    out, grads = run(*primals)
    return np.asarray(out.astype(jnp.float32)), \
        [np.asarray(g.astype(jnp.float32)) for g in grads]


def _port_run(name, arrays, attrs, diff):
    fn = port_op(name).fcompute
    ts = [torch.from_numpy(np.ascontiguousarray(a)).requires_grad_(d)
          for a, d in zip(arrays, diff)]
    out = fn(*ts, **attrs)
    out = out[0] if isinstance(out, tuple) else out
    grads = torch.autograd.grad(out, [t for t in ts if t.requires_grad],
                                torch.from_numpy(_head(tuple(out.shape)))
                                .to(out.dtype))
    return out.detach().float().numpy(), [g.float().numpy() for g in grads]


def _check(name, arrays, attrs, diff, tol=F32):
    want, want_g = _jax_run(name, arrays, attrs, diff)
    got, got_g = _port_run(name, arrays, attrs, diff)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **tol)
    for g, w in zip(got_g, want_g):
        np.testing.assert_allclose(g, w, **tol)
    return got


# -- Convolution ------------------------------------------------------------------

CONV_CASES = {
    "2d": ((2, 4, 9, 9), (6, 4, 3, 3), dict(kernel=(3, 3))),
    "2d_stride_pad": ((2, 4, 9, 8), (6, 4, 3, 3),
                      dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1))),
    "2d_dilate": ((2, 4, 11, 11), (6, 4, 3, 3),
                  dict(kernel=(3, 3), dilate=(2, 2), pad=(2, 2))),
    "2d_groups": ((2, 4, 8, 8), (6, 2, 3, 3),
                  dict(kernel=(3, 3), num_group=2, pad=(1, 1))),
    "2d_no_bias_7x7_stride2": ((2, 3, 16, 16), (8, 3, 7, 7),
                               dict(kernel=(7, 7), stride=(2, 2),
                                    pad=(3, 3), no_bias=True)),
    "2d_1x1_stride2": ((2, 8, 7, 7), (4, 8, 1, 1),
                       dict(kernel=(1, 1), stride=(2, 2), no_bias=True)),
    "1d": ((2, 4, 11), (5, 4, 3), dict(kernel=(3,), stride=(2,), pad=(1,))),
    "3d": ((1, 2, 5, 6, 7), (3, 2, 3, 3, 3), dict(kernel=(3, 3, 3),
                                                  pad=(1, 1, 1))),
}


@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_convolution_matches_jax(case):
    dshape, wshape, attrs = CONV_CASES[case]
    rng = np.random.RandomState(0)
    data = rng.randn(*dshape).astype("f4")
    weight = (rng.randn(*wshape) * 0.2).astype("f4")
    attrs = dict(attrs, num_filter=wshape[0])
    arrays = [data, weight]
    if not attrs.get("no_bias"):
        arrays.append(rng.randn(wshape[0]).astype("f4"))
    _check("Convolution", arrays, attrs, [True] * len(arrays))


# -- Pooling ----------------------------------------------------------------------

POOL_SHAPES = {
    # "full" keeps a last window that lies in the padding (x=5, k=2, s=2,
    # p=1: 4 windows, PyTorch's ceil_mode gives 3) and "same" pads 1+2
    "k2_s2_p1": ((2, 3, 5, 7), dict(kernel=(2, 3), stride=(2, 2),
                                    pad=(1, 1))),
    # the ResNet stem's pool
    "k3_s2_p1": ((2, 3, 9, 8), dict(kernel=(3, 3), stride=(2, 2),
                                    pad=(1, 1))),
    "k3_s3_p0": ((1, 2, 10, 11), dict(kernel=(3, 3), stride=(3, 3))),
}
POOL_KINDS = [("max", True), ("avg", True), ("avg", False), ("sum", True)]


@pytest.mark.parametrize("convention", ["valid", "full", "same"])
@pytest.mark.parametrize("kind", POOL_KINDS,
                         ids=lambda k: f"{k[0]}{'' if k[1] else '_nopad'}")
@pytest.mark.parametrize("shape", sorted(POOL_SHAPES))
def test_pooling_matches_jax(shape, kind, convention):
    dshape, attrs = POOL_SHAPES[shape]
    pool_type, include = kind
    x = np.random.RandomState(1).randn(*dshape).astype("f4")
    attrs = dict(attrs, pool_type=pool_type, pooling_convention=convention,
                 count_include_pad=include)
    _check("Pooling", [x], attrs, [True])


@pytest.mark.parametrize("convention", ["valid", "full", "same"])
def test_lp_pooling_matches_jax(convention):
    x = np.random.RandomState(2).randn(2, 3, 9, 8).astype("f4")
    attrs = dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1), pool_type="lp",
                 pooling_convention=convention)
    _check("Pooling", [x], attrs, [True])


def test_full_convention_keeps_the_window_in_the_padding():
    """PyTorch's ceil_mode drops it; the reference does not."""
    x = np.random.RandomState(3).randn(1, 1, 5, 5).astype("f4")
    attrs = dict(kernel=(2, 2), stride=(2, 2), pad=(1, 1), pool_type="max",
                 pooling_convention="full")
    out = _check("Pooling", [x], attrs, [True])
    assert out.shape == (1, 1, 4, 4)
    ceil = torch.nn.functional.max_pool2d(torch.from_numpy(x), 2, 2, 1,
                                          ceil_mode=True)
    assert tuple(ceil.shape) == (1, 1, 3, 3)
    assert np.isneginf(out[0, 0, -1]).all()


@pytest.mark.parametrize("pool_type", ["max", "avg"])
def test_global_pooling_matches_jax(pool_type):
    x = np.random.RandomState(4).randn(2, 5, 7, 6).astype("f4")
    _check("Pooling", [x], dict(kernel=(1, 1), global_pool=True,
                                pool_type=pool_type), [True])


# -- BatchNorm --------------------------------------------------------------------

def _bn_inputs(shape, axis=1, seed=5):
    rng = np.random.RandomState(seed)
    c = shape[axis]
    return [(rng.randn(*shape) * 3 + 1.5).astype("f4"),
            rng.uniform(0.5, 1.5, c).astype("f4"),
            rng.randn(c).astype("f4"),
            rng.randn(c).astype("f4"),
            rng.uniform(0.5, 2.0, c).astype("f4")]


@pytest.mark.parametrize("training", [True, False], ids=["train", "predict"])
@pytest.mark.parametrize("fix_gamma", [False, True])
@pytest.mark.parametrize("use_global_stats", [False, True])
def test_batch_norm_matches_jax(training, fix_gamma, use_global_stats):
    arrays = _bn_inputs((4, 3, 5, 6))
    attrs = dict(eps=1e-5, fix_gamma=fix_gamma,
                 use_global_stats=use_global_stats, training=training)
    diff = [True, not fix_gamma, True, False, False]
    _check("BatchNorm", arrays, attrs, diff)
    want = jax_op("BatchNorm").fcompute(*map(jnp.asarray, arrays), **attrs)
    got = port_op("BatchNorm").fcompute(*map(torch.from_numpy, arrays),
                                        **attrs)
    for g, w in zip(got[1:], want[1:]):        # the mean and the variance
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **F32)


@pytest.mark.parametrize("training", [True, False], ids=["train", "predict"])
def test_batch_norm_channel_axis_matches_jax(training):
    arrays = _bn_inputs((4, 6, 3), axis=-1)
    _check("BatchNorm", arrays, dict(axis=-1, fix_gamma=False,
                                     training=training),
           [True, True, True, False, False])


def test_batch_norm_bf16_data_with_f32_gamma_promotes():
    arrays = _bn_inputs((4, 3, 5, 6))
    attrs = dict(fix_gamma=False, training=True)
    fn = jax_op("BatchNorm").fcompute
    want = fn(jnp.asarray(arrays[0]).astype(jnp.bfloat16),
              *map(jnp.asarray, arrays[1:]), **attrs)[0]
    got = port_op("BatchNorm").fcompute(
        torch.from_numpy(arrays[0]).to(torch.bfloat16),
        *map(torch.from_numpy, arrays[1:]), **attrs)[0]
    assert want.dtype == jnp.float32 and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **BF16)


@pytest.mark.parametrize("use_global_stats", [False, True])
def test_nd_batch_norm_updates_moving_stats_as_jax(use_global_stats):
    """Two training-mode calls of ``nd.BatchNorm`` in each package: the
    outputs, and the moving mean and (biased) variance after each."""
    arrays = _bn_inputs((8, 4, 3, 3))
    kw = dict(momentum=0.9, fix_gamma=False,
              use_global_stats=use_global_stats)
    jarr = [jmx.nd.array(a) for a in arrays]
    tarr = [nd.array(a, ctx=mx.cpu()) for a in arrays]
    for step in range(2):
        x = (arrays[0] * (step + 1)).astype("f4")
        with jmx.autograd.record():
            want = jmx.nd.BatchNorm(jmx.nd.array(x), *jarr[1:], **kw)
        with autograd.record():
            got = nd.BatchNorm(nd.array(x, ctx=mx.cpu()), *tarr[1:], **kw)
        np.testing.assert_allclose(got.asnumpy(), want.asnumpy(), **F32)
        for t, j in zip(tarr[3:], jarr[3:]):
            np.testing.assert_allclose(t.asnumpy(), j.asnumpy(), **F32)
    moved = not np.allclose(tarr[3].asnumpy(), arrays[3])
    assert moved != use_global_stats
    # predict mode reads the moving statistics and leaves them alone
    before = tarr[3].asnumpy()
    got = nd.BatchNorm(nd.array(arrays[0], ctx=mx.cpu()), *tarr[1:], **kw)
    want = jmx.nd.BatchNorm(jmx.nd.array(arrays[0]), *jarr[1:], **kw)
    np.testing.assert_allclose(got.asnumpy(), want.asnumpy(), **F32)
    np.testing.assert_array_equal(tarr[3].asnumpy(), before)


def test_amp_casts_convolution_to_bf16():
    from mxnet_tpu_torch.contrib import amp
    x = torch.randn(2, 3, 8, 8)
    w = torch.randn(4, 3, 3, 3)
    amp.init("bfloat16")
    try:
        out = port_op("Convolution").fcompute(x, w, kernel=(3, 3),
                                              num_filter=4, no_bias=True)
    finally:
        amp._deinit()
    assert out.dtype == torch.bfloat16
    want = torch.nn.functional.conv2d(x.bfloat16().float(),
                                      w.bfloat16().float())
    np.testing.assert_allclose(out.float().numpy(), want.numpy(), **BF16)
