"""The port's Parameter plumbing against the JAX package's, beside
``tests/test_gluon.py``'s cases: ``DeferredInitializationError``,
``gluon.Constant`` (alone and a block's), parameter sharing through
``params=`` (one layer's, and a whole net's), and ``Parameter.cast`` /
``Block.cast`` with BatchNorm staying float32.  Values are compared with
the JAX package's at float32's tolerance (``mxnet_tpu/test_utils.py``:
rtol 1e-4, atol 1e-5) and casts exactly.
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu import gluon as jgluon
from mxnet_tpu import nd as jnd
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, gluon, nd
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon import nn

CPU = mx.cpu()
TOL = dict(rtol=1e-4, atol=1e-5)


def test_deferred_parameter_raises_until_the_first_call():
    net = nn.Dense(3)
    net.initialize(ctx=CPU)
    p = next(iter(net.collect_params().values()))
    with pytest.raises(gluon.DeferredInitializationError):
        p.data()
    assert issubclass(gluon.DeferredInitializationError, MXNetError)
    net(nd.ones((2, 5), ctx=CPU))
    assert p.data().shape == (3, 5)
    jp = jgluon.Parameter("weight", shape=(4, 0), allow_deferred_init=True)
    jp.initialize()
    with pytest.raises(jgluon.DeferredInitializationError):
        jp.data()


def test_constant_parameter_matches_jax():
    """The reference's case, and a constant that is a block's own."""
    jc = jgluon.Constant("const", jnd.array([[1.0, 2.0]]))
    jc.initialize()
    c = gluon.Constant("const", nd.array([[1.0, 2.0]], ctx=CPU))
    c.initialize(ctx=CPU)
    assert c.grad_req == jc.grad_req == "null"
    assert c.name == "const"
    np.testing.assert_array_equal(c.data().asnumpy(), jc.data().asnumpy())
    with pytest.raises(MXNetError, match="no gradient"):
        c.grad_req = "write"
    assert gluon.Constant("ints", [1, 2]).value.dtype == np.float32

    class Shift(gluon.HybridBlock):
        def __init__(self, **kw):
            super().__init__(**kw)
            self.shift = self.params.get_constant("shift", [[0.5, -1.0]])
            self.dense = nn.Dense(2, in_units=2)

        def hybrid_forward(self, F, x, shift):
            return self.dense(x) + shift

    net = Shift()
    net.initialize(ctx=CPU)
    names = list(net.collect_params().keys())
    assert names[0].endswith("shift")
    const = net.collect_params()[names[0]]
    assert isinstance(const, gluon.Constant) and const.grad_req == "null"
    x = nd.array(np.ones((3, 2), "f4"), ctx=CPU)
    with autograd.record():
        y = net(x)
    y.backward()
    dense = [p for n, p in net.collect_params().items() if "dense" in n]
    want = net.dense(x).asnumpy() + np.array([[0.5, -1.0]], "f4")
    np.testing.assert_allclose(y.asnumpy(), want, **TOL)
    tr = gluon.Trainer(net.collect_params(), "sgd", {"learning_rate": 0.1})
    tr.step(3)
    np.testing.assert_array_equal(const.data().asnumpy(), [[0.5, -1.0]])
    assert all(p.grad_req == "write" for p in dense)


def test_share_parameters_matches_jax():
    """The reference's case: a Dense built with another's ``params``
    computes the same function; in one net the shared weight is one
    parameter whose gradient sums over both uses, as the JAX package's."""
    rng = np.random.RandomState(0)
    w = rng.randn(4, 4).astype("f4") * 0.5
    b = rng.randn(4).astype("f4")
    x = rng.rand(2, 4).astype("f4")

    def run(pkg, gl, ctx):
        kw = {} if ctx is None else {"ctx": ctx}
        net = gl.nn.HybridSequential(prefix="share_")
        with net.name_scope():
            d1 = gl.nn.Dense(4, in_units=4, activation="tanh")
            d2 = gl.nn.Dense(4, in_units=4, params=d1.params)
            net.add(d1, d2)
        net.initialize(**kw)
        params = net.collect_params()
        assert list(params.keys()) == ["share_dense0_weight",
                                       "share_dense0_bias"]
        params["share_dense0_weight"].set_data(pkg.nd.array(w, **kw))
        params["share_dense0_bias"].set_data(pkg.nd.array(b, **kw))
        xx = pkg.nd.array(x, **kw)
        np.testing.assert_allclose(d1(xx).asnumpy(),
                                   np.tanh(x @ w.T + b), **TOL)
        with pkg.autograd.record():
            y = (net(xx) ** 2).sum()
        y.backward()
        return (y.asnumpy(), params["share_dense0_weight"].grad().asnumpy(),
                params["share_dense0_bias"].grad().asnumpy())
    want = run(jmx, jgluon, None)
    got = run(mx, gluon, CPU)
    for g, wnt in zip(got, want):
        np.testing.assert_allclose(g, wnt, **TOL)


def test_share_a_whole_net():
    """``params=net1.collect_params()``: the second net's children take
    the first net's parameter names and tensors; an update through one
    trainer moves both nets; the parameters count once."""
    class Net(gluon.HybridBlock):
        def __init__(self, **kw):
            super().__init__(**kw)
            with self.name_scope():
                self.fc1 = nn.Dense(5, in_units=3, activation="relu")
                self.fc2 = nn.Dense(2, in_units=5)

        def hybrid_forward(self, F, x):
            return self.fc2(self.fc1(x))

    net1 = Net(prefix="siamese_")
    net2 = Net(params=net1.collect_params())
    net1.initialize(mx.init.Xavier(), ctx=CPU)
    assert list(net2.collect_params().keys()) == \
        list(net1.collect_params().keys())
    assert all(a is b for a, b in zip(net1.collect_params().values(),
                                      net2.collect_params().values()))
    assert len(list(net2.parameters())) == 4
    x = nd.array(np.random.RandomState(1).randn(4, 3).astype("f4"), ctx=CPU)
    np.testing.assert_array_equal(net1(x).asnumpy(), net2(x).asnumpy())
    tr = gluon.Trainer(net2.collect_params(), "sgd", {"learning_rate": 0.5})
    before = net1(x).asnumpy()
    with autograd.record():
        loss = net2(x).sum()
    loss.backward()
    tr.step(4)
    after = net1(x).asnumpy()
    assert not np.allclose(before, after)
    np.testing.assert_array_equal(after, net2(x).asnumpy())
    with pytest.raises(MXNetError, match="cannot share"):
        nn.Dense(3, in_units=7, params=net1.fc1.params)


def test_cast_matches_jax():
    """``Block.cast``: a Dense's weights in float16 hold the JAX package's
    float16 values; BatchNorm's parameters and statistics stay float32
    (the reference's BatchNorm.cast); a hybridized net captures again and
    computes in float16; a cast back restores float32."""
    rng = np.random.RandomState(2)
    w = rng.randn(3, 4).astype("f4")
    jd = jgluon.nn.Dense(3, in_units=4)
    jd.initialize()
    jd.weight.set_data(jnd.array(w))
    jd.cast("float16")
    net = nn.HybridSequential()
    d = nn.Dense(3, in_units=4)
    bn = nn.BatchNorm(in_channels=3)
    net.add(d, bn)
    net.initialize(ctx=CPU)
    next(iter(d.collect_params().values())).set_data(nd.array(w, ctx=CPU))
    net.hybridize()
    x = nd.array(rng.randn(5, 4).astype("f4"), ctx=CPU)
    assert net(x).dtype == np.float32
    net.cast("float16")
    dp = list(d.collect_params().values())
    assert [p.dtype for p in dp] == ["float16", "float16"]
    np.testing.assert_array_equal(dp[0].data().asnumpy(),
                                  jd.weight.data().asnumpy())
    assert {p.dtype for p in bn.collect_params().values()} == {"float32"}
    assert str(jd.weight.data().dtype) == "float16"
    out = d(x.astype("float16"))
    assert out.dtype == np.float16
    with autograd.record():
        y = d(x.astype("float16")).sum()
    y.backward()
    assert dp[0].grad().dtype == np.float16
    net.cast("float32")
    assert [p.dtype for p in dp] == ["float32", "float32"]
    assert net(x).dtype == np.float32
