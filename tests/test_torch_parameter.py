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


# -- the reference's parameter surface (ROADMAP queue 3, F7, F8, F13) --------------

def _dense_pair(prefix="fd_"):
    """A JAX Dense and the port's, with the JAX weights."""
    jmx.random.seed(1)
    jd = jgluon.nn.Dense(3, in_units=4, prefix=prefix)
    jd.initialize()
    td = nn.Dense(3, in_units=4, prefix=prefix)
    td.initialize(ctx=CPU)
    td.weight.set_data(jd.weight.data().asnumpy())
    td.bias.set_data(jd.bias.data().asnumpy())
    return jd, td


def test_block_parameter_attribute_is_the_parameter():
    """F7: ``net.weight`` is the gluon Parameter in both packages: data(),
    grad(), set_data(), lr_mult; a layer without a bias has ``bias`` None;
    the sharing block's attribute is the owner's Parameter."""
    jd, td = _dense_pair()
    for d in (jd, td):
        assert d.weight.name == "fd_weight" and d.weight.shape == (3, 4)
    assert isinstance(td.weight, gluon.Parameter)
    assert td.weight is td.collect_params()["fd_weight"]
    np.testing.assert_array_equal(td.weight.data().asnumpy(),
                                  jd.weight.data().asnumpy())
    x = np.random.RandomState(2).rand(5, 4).astype("f4")
    for pkg, d in ((jmx, jd), (mx, td)):
        kw = {"ctx": CPU} if pkg is mx else {}
        xa = pkg.nd.array(x, **kw)
        with pkg.autograd.record():
            y = d(xa).sum()
        y.backward()
    np.testing.assert_allclose(td.weight.grad().asnumpy(),
                               jd.weight.grad().asnumpy(), **TOL)
    td.weight.lr_mult = 0.5
    assert td.collect_params()["fd_weight"].lr_mult == 0.5
    td.weight.set_data(np.ones((3, 4), "f4"))
    assert td._tensor("weight").detach().sum().item() == 12
    assert nn.Dense(2, use_bias=False).bias is None
    assert jgluon.nn.Dense(2, use_bias=False).bias is None
    shared = nn.Dense(3, in_units=4, params=td.collect_params())
    assert shared.weight is td.weight


def test_params_get_keeps_the_multipliers():
    """F8: ROADMAP's case: one SGD step (lr 1, wd 0.5, gradient 1) on
    ``params.get("w", lr_mult=2.0, wd_mult=0.0)`` gives w = -1.0 in both
    packages."""
    got = {}
    for pkg, gl, lib in (("jax", jgluon, jmx), ("port", gluon, mx)):
        class Net(gl.HybridBlock):
            def __init__(self):
                super().__init__(prefix="f8_")
                with self.name_scope():
                    self.w = self.params.get(
                        "w", shape=(2, 3), init=lib.init.One(),
                        lr_mult=2.0, wd_mult=0.0)

            def hybrid_forward(self, F, x, w):
                return x * w

        net = Net()
        kw = {"ctx": CPU} if pkg == "port" else {}
        net.initialize(**kw)
        p = net.collect_params()["f8_w"]
        assert (p.lr_mult, p.wd_mult) == (2.0, 0.0)
        trainer = gl.Trainer(net.collect_params(), "sgd",
                             {"learning_rate": 1.0, "wd": 0.5})
        x = lib.nd.ones((2, 3), **kw)
        with lib.autograd.record():
            y = net(x).sum()
        y.backward()
        trainer.step(1)
        got[pkg] = p.data().asnumpy()
    np.testing.assert_allclose(got["port"], got["jax"])
    np.testing.assert_allclose(got["port"], np.full((2, 3), -1.0))


def test_standalone_parameter_and_parameter_dict():
    """F8 and F13: ``Parameter(name, shape=...)`` stands alone
    (initialize, data, grad, reset_ctx); ``ParameterDict(prefix,
    shared=)`` makes and shares parameters; its initialize, save, load
    and reset_ctx; ``Parameter.var`` names what it waits for."""
    p = gluon.Parameter("w", shape=(3,), init=mx.init.One(), lr_mult=3.0)
    jp = jgluon.Parameter("w", shape=(3,), init=jmx.init.One(), lr_mult=3.0)
    p.initialize(ctx=CPU)
    jp.initialize()
    np.testing.assert_array_equal(p.data().asnumpy(), jp.data().asnumpy())
    assert p.grad().shape == (3,) and p.lr_mult == 3.0 and \
        p.grad_req == "write"
    p.initialize(init=mx.init.Zero(), ctx=CPU)       # placed: unchanged
    assert p.data().asnumpy().sum() == 3
    p.initialize(init=mx.init.Constant(2.0), ctx=CPU, force_reinit=True)
    assert p.data().asnumpy().tolist() == [2.0, 2.0, 2.0]
    p.reset_ctx(CPU)
    assert p.list_ctx() == [CPU]
    nd_ = gluon.Parameter("n", shape=(2,), differentiable=False)
    assert nd_.grad_req == "null"
    with pytest.raises(NotImplementedError, match="item 8"):
        p.var()
    base = gluon.ParameterDict("b_")
    a = base.get("a", shape=(2, 2), init=mx.init.One())
    child = gluon.ParameterDict("b_", shared=base)
    assert child.get("a") is a
    jbase = jgluon.ParameterDict("b_")
    jbase.get("a", shape=(2, 2), init=jmx.init.One())
    for d, kw in ((base, {"ctx": CPU}), (jbase, {})):
        d.get("c", shape=(3,))
        d.initialize(mx.init.Zero() if d is base else jmx.init.Zero(), **kw)
    assert sorted(base.keys()) == sorted(jbase.keys()) == ["b_a", "b_c"]
    for name in base.keys():
        np.testing.assert_array_equal(base[name].data().asnumpy(),
                                      jbase[name].data().asnumpy())
    base.reset_ctx(CPU)


def test_collect_params_initialize_save_load(tmp_path):
    """F13: ``net.collect_params().initialize(...)``, ``save`` and
    ``load`` (the JAX package's file read by the port), ``Block.reset_ctx``,
    ``Block.summary`` and ``HybridBlock.infer_type``."""
    def make(g):
        net = g.nn.HybridSequential(prefix="f13_")
        with net.name_scope():
            net.add(g.nn.Dense(4, in_units=3), g.nn.Dense(2, in_units=4))
        return net

    jnet, tnet = make(jgluon), make(gluon)
    jmx.random.seed(4)
    jnet.collect_params().initialize(jmx.init.Xavier())
    tnet.collect_params().initialize(mx.init.Xavier(), ctx=CPU)
    for p in tnet.collect_params().values():
        assert p.data().context == CPU
    assert float(np.abs(tnet[1].bias.data().asnumpy()).sum()) == 0
    path = str(tmp_path / "f13.params")
    jnet.collect_params().save(path, strip_prefix="f13_")
    tnet.collect_params().load(path, ctx=CPU, restore_prefix="f13_")
    for k, p in jnet.collect_params().items():
        np.testing.assert_array_equal(
            tnet.collect_params()[k].data().asnumpy(), p.data().asnumpy())
    tpath = str(tmp_path / "port.params")
    tnet.collect_params().save(tpath)
    jnet2 = make(jgluon)
    jnet2.collect_params().load(tpath)
    x = np.random.RandomState(0).rand(2, 3).astype("f4")
    np.testing.assert_allclose(tnet(nd.array(x, ctx=CPU)).asnumpy(),
                               jnet2(jnd.array(x)).asnumpy(), **TOL)
    tnet.reset_ctx(CPU)
    tnet.infer_type(nd.array(x, ctx=CPU))
    tnet.summary(nd.array(x, ctx=CPU))
    with pytest.raises(MXNetError, match="missing"):
        make(gluon).collect_params().load(path, ctx=CPU)
