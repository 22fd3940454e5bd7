"""The port's ``mx.autograd`` and ``mx.random`` against the JAX package's
semantics (``tests/test_autograd.py``, ``tests/test_random_stats.py``).

Gradients are compared with the JAX package on the same numpy inputs
(float32, rtol 1e-5).  The samplers draw from other generators than the
JAX package's keys, so they are held to their distributions with the
moment and KS thresholds of ``test_random_stats.py``, and Dropout to its
keep rate, scaling and mode switch.
"""
import numpy as np
import pytest
from scipy import stats

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, nd
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.test_utils import assert_almost_equal, \
    check_numeric_gradient, rand_ndarray, set_default_context

import torch_parity

CPU = mx.cpu()


def _a(x, **kw):
    return nd.array(np.asarray(x, "f4"), ctx=CPU, **kw)


def test_scopes():
    assert not autograd.is_recording() and not autograd.is_training()
    with autograd.record():
        assert autograd.is_recording() and autograd.is_training()
        with autograd.pause():
            assert not autograd.is_recording()
            assert not autograd.is_training()
        with autograd.predict_mode():
            assert not autograd.is_training()
    with autograd.record(train_mode=False):
        assert autograd.is_recording() and not autograd.is_training()
    with autograd.train_mode():
        assert autograd.is_training()
    assert autograd.set_recording(True) is False
    assert autograd.set_recording(False) is True
    assert autograd.set_training(True) is False
    assert autograd.set_training(False) is True


GRADS = {
    "chain": (lambda F, x: F.exp(x) * 2 + x, [[0.5, -0.5]]),
    "reuse": (lambda F, x: x * x + x * 2, [[3.0, -1.0]]),
    "two_leaves": (lambda F, a, b: a * b + a, [[2.0], [3.0]]),
    "matmul": (lambda F, a, b: F.dot(a, b),
               [np.random.RandomState(0).rand(2, 3),
                np.random.RandomState(1).rand(3, 4)]),
    "softmax": (lambda F, x: F.softmax(x, axis=-1) ** 2,
                [np.random.RandomState(2).rand(3, 5)]),
    "split": (lambda F, x: F.split(x, num_outputs=2, axis=1)[1] * 2,
              [np.arange(4.0).reshape(1, 4)]),
    "basic_index": (lambda F, x: x[:, :2] * x[:, 1:3],
                    [np.arange(6.0).reshape(2, 3)]),
    "ellipsis_newaxis": (lambda F, x: x[..., 0] * 2 + x[:, None].sum(),
                         [np.arange(8.0).reshape(2, 4)]),
    "block_grad": (lambda F, x: F.BlockGrad(x * 3) * x, [[2.0]]),
}


@pytest.mark.parametrize("name", sorted(GRADS))
def test_gradients_match_the_jax_package(name):
    fn, arrays = GRADS[name]
    torch_parity.check(fn, [np.asarray(a, "f4") for a in arrays],
                       rtol=1e-5)


def test_head_grads_and_sum_head():
    x = _a([1.0, 2.0])
    x.attach_grad()
    with autograd.record():
        y = x * x
    y.backward(out_grad=_a([10.0, 100.0]))
    np.testing.assert_allclose(x.grad.asnumpy(), [20.0, 400.0])
    with autograd.record():
        loss = nd.sum(x * 3)
    loss.backward()
    np.testing.assert_allclose(x.grad.asnumpy(), [3.0, 3.0])


def test_grad_req_write_add_null():
    x = _a([1.0, 2.0])
    x.attach_grad()
    held = x.grad
    for _ in range(2):
        with autograd.record():
            y = 2 * x
        y.backward()
    np.testing.assert_allclose(held.asnumpy(), [2.0, 2.0])   # overwritten
    a = _a([1.0, 2.0])
    a.attach_grad(grad_req="add")
    for _ in range(2):
        with autograd.record():
            y = 2 * a
        y.backward()
    np.testing.assert_allclose(a.grad.asnumpy(), [4.0, 4.0])
    n = _a([1.0])
    n.attach_grad(grad_req="null")
    with autograd.record():
        y = n * 5 + x
    y.backward()
    np.testing.assert_allclose(n.grad.asnumpy(), [0.0])
    with pytest.raises(MXNetError, match="grad_req"):
        n.attach_grad(grad_req="sometimes")


def test_ops_outside_record_build_no_graph():
    x = _a([1.0, 2.0])
    x.attach_grad()
    y = x * 2
    assert y.tensor.grad_fn is None and not y.tensor.requires_grad
    with pytest.raises(MXNetError, match="record"):
        y.backward()


def test_inplace_writes_raise_while_recording():
    x = nd.ones((2,), ctx=CPU)
    x.attach_grad()
    with autograd.record():
        with pytest.raises(MXNetError):
            x += 1
        with pytest.raises(MXNetError):
            x[0] = 5.0
        with pytest.raises(MXNetError, match="out"):
            nd.exp(x, out=x)
        with pytest.raises(MXNetError, match="advanced indexing"):
            x[nd.array([0.0, 1.0], ctx=CPU)]
    x += 1          # allowed outside
    np.testing.assert_allclose(x.asnumpy(), [2.0, 2.0])


def test_detach_cuts_the_graph():
    x = _a([2.0])
    x.attach_grad()
    with autograd.record():
        z = (x * 3).detach() * x
    z.backward()
    np.testing.assert_allclose(x.grad.asnumpy(), [6.0])


def test_grad_api_and_create_graph():
    """First and second derivatives of x^3 + sin(x), as the JAX package
    computes them."""
    xs = np.array([0.5, 1.5, -2.0], "f4")
    out = {}
    for name, pkg in (("jax", jmx), ("port", mx)):
        x = pkg.nd.array(xs, ctx=pkg.cpu())
        x.attach_grad()
        with pkg.autograd.record():
            y = x * x * x + pkg.nd.sin(x)
            (g,) = pkg.autograd.grad(y, [x], create_graph=True)
            z = g.sum()
        z.backward()
        out[name] = (g.asnumpy(), x.grad.asnumpy())
    np.testing.assert_allclose(out["port"][0], 3 * xs ** 2 + np.cos(xs),
                               rtol=1e-5)
    np.testing.assert_allclose(out["port"][1], 6 * xs - np.sin(xs),
                               rtol=1e-5)
    for a, b in zip(out["port"], out["jax"]):
        np.testing.assert_allclose(a, b, rtol=1e-5)
    # a variable never used inside record() has no gradient to give
    w = _a([1.0])
    with autograd.record():
        y = _a([2.0]) * 3
    with pytest.raises(MXNetError):
        autograd.grad(y, [w])


def test_mark_variables():
    x = _a([1.0, 2.0])
    g = nd.zeros((2,), ctx=CPU)
    autograd.mark_variables([x], [g], grad_reqs="add")
    for _ in range(3):
        with autograd.record():
            y = x * x
        y.backward()
    np.testing.assert_allclose(g.asnumpy(), [6.0, 12.0])


def test_custom_function_matches_the_jax_package():
    def make(pkg):
        F = pkg.nd

        class Sigmoid(pkg.autograd.Function):
            def forward(self, x):
                y = F.sigmoid(x)
                self.save_for_backward(y)
                return y

            def backward(self, dy):
                (y,) = self.saved_tensors
                return dy * y * (1 - y) * 2     # deliberately doubled
        return Sigmoid()

    xs = np.array([0.0, 1.0, -3.0], "f4")
    got = {}
    for name, pkg in (("jax", jmx), ("port", mx)):
        x = pkg.nd.array(xs, ctx=pkg.cpu())
        x.attach_grad()
        f = make(pkg)
        with pkg.autograd.record():
            y = f(x) * 3
        y.backward()
        got[name] = (y.asnumpy(), x.grad.asnumpy())
        assert isinstance(f(x), pkg.nd.NDArray)     # outside record too
    s = 1 / (1 + np.exp(-xs))
    np.testing.assert_allclose(got["port"][1], 6 * s * (1 - s), rtol=1e-5)
    for a, b in zip(got["port"], got["jax"]):
        np.testing.assert_allclose(a, b, rtol=1e-5)


def test_check_numeric_gradient():
    rng = np.random.RandomState(0)
    x = nd.array(rng.rand(3, 4).astype("f4") + 0.5, ctx=CPU)
    check_numeric_gradient(lambda a: nd.log(a) * nd.tanh(a), [x])
    assert_almost_equal(x, x.asnumpy())
    with pytest.raises(AssertionError):
        assert_almost_equal(x, x.asnumpy() + 1e-3)
    # the per-dtype table: float16 compares at 1e-2
    h = x.astype("float16")
    assert_almost_equal(h, x.asnumpy() * (1 + 5e-3))
    set_default_context(CPU)
    try:
        r = rand_ndarray((4, 5), scale=0.5)
    finally:
        set_default_context(None)
    assert r.context == CPU and np.abs(r.asnumpy()).max() <= 0.5
    check_numeric_gradient(lambda a: nd.softmax(a) * a, [r])


# -- dropout and the samplers, by their statistics ------------------------------


def test_dropout_statistics_and_mode():
    x = nd.ones((1000, 1000), ctx=CPU)
    assert np.array_equal(nd.Dropout(x, p=0.3).asnumpy(), x.asnumpy())
    with autograd.record():
        y = nd.Dropout(x, p=0.3).asnumpy()
    assert abs((y != 0).mean() - 0.7) < 0.01
    np.testing.assert_allclose(y[y != 0], 1 / 0.7, rtol=1e-6)
    z = nd.Dropout(x, p=0.5, mode="always").asnumpy()
    assert abs((z != 0).mean() - 0.5) < 0.01
    a = nd.Dropout(nd.ones((64, 100), ctx=CPU), p=0.5, mode="always",
                   axes=(0,)).asnumpy()
    assert (a == a[:1]).all()          # one draw shared along axis 0
    mx.random.seed(3)
    b = nd.Dropout(x, p=0.5, mode="always").asnumpy()
    mx.random.seed(3)
    c = nd.Dropout(x, p=0.5, mode="always").asnumpy()
    assert np.array_equal(b, c)


def test_dropout_layer_follows_autograd_training():
    from mxnet_tpu_torch.gluon import nn
    layer = nn.Dropout(0.5)
    x = nd.ones((200, 200), ctx=CPU)
    layer.train()
    assert np.array_equal(layer(x).asnumpy(), x.asnumpy())
    with autograd.record():
        y = layer(x)
    assert abs((y.asnumpy() != 0).mean() - 0.5) < 0.02
    with autograd.record(train_mode=False):
        assert np.array_equal(layer(x).asnumpy(), x.asnumpy())


N = 200_000


def _moments(a, mean, std, tol=0.02):
    got_m, got_s = float(a.mean()), float(a.std())
    assert abs(got_m - mean) < tol * max(1.0, abs(mean) + std), \
        (got_m, mean)
    assert abs(got_s - std) < tol * max(1.0, std) + 0.02, (got_s, std)


def test_uniform_and_normal():
    mx.random.seed(42)
    a = nd.random.uniform(low=-2.0, high=3.0, shape=(N,), ctx=CPU).asnumpy()
    assert a.dtype == np.float32
    assert a.min() >= -2.0 and a.max() < 3.0
    _moments(a, 0.5, 5.0 / np.sqrt(12))
    assert stats.kstest((a + 2.0) / 5.0, "uniform")[1] > 1e-4
    b = nd.random.normal(loc=1.5, scale=2.0, shape=(N,), ctx=CPU).asnumpy()
    _moments(b, 1.5, 2.0)
    assert stats.kstest((b - 1.5) / 2.0, "norm")[1] > 1e-4
    c = mx.random.randn(4, 5, ctx=CPU)
    assert c.shape == (4, 5)


def test_gamma_exponential_poisson_bernoulli():
    mx.random.seed(2)
    alpha, beta, lam = 3.0, 2.0, 2.5
    g = nd.random.gamma(alpha=alpha, beta=beta, shape=(N,),
                        ctx=CPU).asnumpy()
    _moments(g, alpha * beta, np.sqrt(alpha) * beta, tol=0.03)
    e = nd.random.exponential(scale=1.0 / lam, shape=(N,),
                              ctx=CPU).asnumpy()
    _moments(e, 1.0 / lam, 1.0 / lam, tol=0.03)
    p = nd.random.poisson(lam=lam, shape=(N,), ctx=CPU).asnumpy()
    _moments(p, lam, np.sqrt(lam), tol=0.03)
    assert (p == np.round(p)).all() and (p >= 0).all()
    b = nd.random.bernoulli(prob=0.3, shape=(N,), ctx=CPU).asnumpy()
    assert abs(b.mean() - 0.3) < 0.01 and set(np.unique(b)) <= {0.0, 1.0}


def test_randint_multinomial_shuffle():
    mx.random.seed(4)
    r = nd.random.randint(-3, 7, shape=(N,), ctx=CPU).asnumpy()
    assert r.dtype == np.int32 and r.min() == -3 and r.max() == 6
    probs = nd.array(np.asarray([[0.1, 0.2, 0.3, 0.4]], "f4"), ctx=CPU)
    draws = mx.random.multinomial(probs, shape=50_000).asnumpy().ravel()
    freq = np.bincount(draws.astype(int), minlength=4) / draws.size
    np.testing.assert_allclose(freq, [0.1, 0.2, 0.3, 0.4], atol=0.01)
    assert mx.random.multinomial(probs[0]).shape == ()
    x = nd.arange(1000, ctx=CPU)
    y = mx.random.shuffle(x).asnumpy()
    np.testing.assert_array_equal(np.sort(y), np.arange(1000))
    assert np.abs(y - np.arange(1000)).max() > 0


def test_seed_reproducibility_and_out():
    mx.random.seed(7)
    a = nd.random.normal(shape=(64,), ctx=CPU).asnumpy()
    mx.random.seed(7)
    b = nd.random.normal(shape=(64,), ctx=CPU).asnumpy()
    np.testing.assert_array_equal(a, b)
    c = nd.random.normal(shape=(64,), ctx=CPU).asnumpy()
    assert np.abs(a - c).max() > 1e-6
    out = nd.zeros((3, 3), ctx=CPU)
    t = out.tensor
    nd.random.uniform(2.0, 3.0, out=out)
    assert out.tensor is t and out.asnumpy().min() >= 2.0
