"""The port's imperative gluon path against the JAX package's: parameter
names, ``Parameter``/``ParameterDict``, Blocks called with NDArrays, and
``bench_mlp_train``'s loop (record -> backward -> ``Trainer("sgd").step``)
for 3 steps from the same weights, losses and weights to 1e-4 relative.

Weights go over with ``models.load_jax_gluon_params`` (by name).
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, gluon, models, nd
from mxnet_tpu_torch.base import MXNetError

CPU = mx.cpu()


def _mlp(pkg, widths, prefix="mlp_"):
    nn = pkg.gluon.nn
    net = nn.HybridSequential(prefix=prefix)
    with net.name_scope():
        for i, (a, b) in enumerate(zip(widths[:-1], widths[1:])):
            last = i == len(widths) - 2
            net.add(nn.Dense(b, activation=None if last else "relu",
                             in_units=a))
    net.initialize(pkg.init.Xavier(), ctx=pkg.cpu())
    return net


def test_parameter_names_are_the_reference_names():
    def build(pkg):
        nn = pkg.gluon.nn
        net = nn.HybridSequential(prefix="net_")
        with net.name_scope():
            net.add(nn.Dense(4, in_units=3), nn.Dense(2, in_units=4,
                                                      use_bias=False))
            inner = nn.Sequential()
            with inner.name_scope():
                inner.add(nn.Dense(3, in_units=2),
                          nn.LayerNorm(in_channels=3))
            net.add(inner, nn.Embedding(5, 3), nn.Dropout(0.1))
        return net
    j, t = build(jmx), build(mx)
    assert list(t.collect_params().keys()) == list(j.collect_params().keys())
    assert t.prefix == "net_" and t.name == "net"
    assert list(t.collect_params("net_dense.*").keys()) == \
        ["net_dense0_weight", "net_dense0_bias", "net_dense1_weight"]
    # the default numbering: a scope of its own numbers from 0
    a, b = mx.gluon.nn.Dense(2, in_units=2), mx.gluon.nn.Dense(2, in_units=2)
    assert a.prefix != b.prefix and a.prefix.startswith("dense")


def test_parameter_surface():
    net = _mlp(mx, (3, 4, 2))
    p = net.collect_params()["mlp_dense0_weight"]
    assert p.shape == (4, 3) and p.dtype == "float32"
    d = p.data()
    assert isinstance(d, nd.NDArray) and d is p.data()
    assert d.tensor is net[0].weight        # the module's own tensor
    g = p.grad()
    assert g.shape == (4, 3) and g.asnumpy().sum() == 0
    p.set_data(np.ones((4, 3), "f4"))
    assert net[0].weight.detach().sum().item() == 12
    with pytest.raises(MXNetError, match="shape"):
        p.set_data(np.ones((3, 4), "f4"))
    with pytest.raises(MXNetError, match="context"):
        p.data(mx.gpu(0))
    x = nd.array(np.ones((2, 3), "f4"), ctx=CPU)
    with autograd.record():
        y = net(x).sum()
    y.backward()
    assert g.asnumpy().sum() != 0                # the held buffer updated
    net.collect_params().zero_grad()
    assert g.asnumpy().sum() == 0
    p.grad_req = "null"
    assert not net[0].weight.requires_grad
    with pytest.raises(MXNetError, match="null"):
        p.grad()
    with autograd.record():
        y = net(x).sum()
    y.backward()                                 # skips the null one
    q = net.collect_params()["mlp_dense1_weight"]
    assert q.grad().asnumpy().sum() != 0
    fresh = mx.gluon.nn.Dense(2, in_units=3)
    with pytest.raises(MXNetError, match="not been initialized"):
        fresh.collect_params()[fresh.prefix + "weight"].data()
    lazy = mx.gluon.nn.Dense(2)                  # in_units deferred
    w = lazy.collect_params()[lazy.prefix + "weight"]
    assert w.shape == (2, 0)
    lazy.initialize(ctx=CPU)
    with pytest.raises(MXNetError, match="deferred"):
        w.data()
    assert lazy(x).shape == (2, 2) and w.shape == (2, 3)


def test_grad_req_add_accumulates_over_backwards():
    net = _mlp(mx, (3, 2))
    net.collect_params().setattr("grad_req", "add")
    x = nd.array(np.ones((2, 3), "f4"), ctx=CPU)
    grads = []
    for _ in range(2):
        with autograd.record():
            y = net(x).sum()
        y.backward()
        grads.append(net.collect_params()["mlp_dense0_bias"].grad()
                     .asnumpy().copy())
    np.testing.assert_allclose(grads[1], 2 * grads[0])


def test_block_calls_with_ndarrays_and_tensors():
    net = _mlp(mx, (3, 4, 2))
    x = np.random.RandomState(0).rand(5, 3).astype("f4")
    out_nd = net(nd.array(x, ctx=CPU))
    out_t = net(torch.from_numpy(x))
    assert isinstance(out_nd, nd.NDArray) and isinstance(out_t,
                                                         torch.Tensor)
    np.testing.assert_array_equal(out_nd.asnumpy(), out_t.detach().numpy())
    assert out_nd.tensor.grad_fn is None         # nothing recorded outside
    net.hybridize()
    np.testing.assert_array_equal(net(nd.array(x, ctx=CPU)).asnumpy(),
                                  out_nd.asnumpy())
    loss = gluon.loss.SoftmaxCrossEntropyLoss()
    assert isinstance(loss(out_nd, nd.array([0, 1, 1, 0, 1], ctx=CPU)),
                      nd.NDArray)


def test_hybrid_block_called_with_tensors_passes_its_modes_on():
    """A HybridBlock called with tensors wraps them in NDArrays for its
    hybrid_forward: the blocks and mx.nd ops there inherit the call's grad
    mode and training mode (they used to take autograd's, off, so the
    output had no grad_fn and dropout never ran), and the caller's tensor
    is not marked as requiring a gradient."""
    class Wrap(gluon.HybridBlock):
        def __init__(self, **kw):
            super().__init__(**kw)
            with self.name_scope():
                self.dense = gluon.nn.Dense(3, in_units=4)
                self.drop = gluon.nn.Dropout(0.5)

        def hybrid_forward(self, F, x):
            return self.drop(F.Activation(self.dense(x), act_type="tanh")
                             + 1.0)

    net = Wrap().initialize(ctx=CPU, seed=0)
    x = torch.from_numpy(np.random.RandomState(0).randn(64, 4).astype("f4"))
    bare = gluon.nn.Dense(3, in_units=4).initialize(ctx=CPU, seed=0)
    with torch.enable_grad():
        y = net(x)
        assert bare(x).requires_grad
    assert y.requires_grad and not x.requires_grad
    y.sum().backward()
    assert net.dense.weight.grad is not None
    assert float(net.dense.weight.grad.abs().sum()) > 0
    mx.random.seed(0)
    big = torch.ones(4096, 4)
    kept = (net(big) != 0).float().mean().item()
    assert abs(kept - 0.5) < 0.05                  # dropout ran
    net.eval()
    assert bool((net(big) != 0).all())             # and not in eval()
    with torch.no_grad():
        assert not net(x).requires_grad


def test_hybrid_forward_block_matches_the_jax_package():
    """A user HybridBlock with its own parameter and hybrid_forward(F,
    ...), copied over by name."""
    def make(pkg):
        class Scaled(pkg.gluon.HybridBlock):
            def __init__(self, **kw):
                super().__init__(**kw)
                with self.name_scope():
                    self.scale = self.params.get("scale", shape=(4,),
                                                 init="ones")
                    self.dense = pkg.gluon.nn.Dense(4, in_units=3)

            def hybrid_forward(self, F, x, scale):
                return F.relu(self.dense(x)) * scale + F.sum(x)
        net = Scaled(prefix="scaled_")
        net.initialize(pkg.init.Xavier(), ctx=pkg.cpu())
        return net
    jnet, tnet = make(jmx), make(mx)
    params = {k: v.data().asnumpy() for k, v in
              jnet.collect_params().items()}
    assert sorted(params) == sorted(tnet.collect_params().keys())
    models.load_jax_gluon_params(tnet, params, jnet.prefix)
    x = np.random.RandomState(1).rand(2, 3).astype("f4")
    out = {}
    for name, pkg, net in (("jax", jmx, jnet), ("port", mx, tnet)):
        xx = pkg.nd.array(x, ctx=pkg.cpu())
        with pkg.autograd.record():
            y = net(xx)
        y.backward()
        out[name] = (y.asnumpy(), net.collect_params()["scaled_scale"]
                     .grad().asnumpy())
    for a, b in zip(out["port"], out["jax"]):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


def _train(pkg, net, x, y, opt_params, steps=3):
    trainer = pkg.gluon.Trainer(net.collect_params(), "sgd", opt_params,
                                kvstore=None)
    loss_fn = pkg.gluon.loss.SoftmaxCrossEntropyLoss()
    xx, yy = pkg.nd.array(x, ctx=pkg.cpu()), pkg.nd.array(y, ctx=pkg.cpu())
    losses = []
    for _ in range(steps):
        with pkg.autograd.record():
            loss = loss_fn(net(xx), yy)
        loss.backward()
        trainer.step(x.shape[0])
        losses.append(float(loss.mean().asscalar()))
    return losses, [p.data().asnumpy() for p in
                    net.collect_params().values()]


@pytest.mark.parametrize("case", ["sgd", "momentum_wd_clip", "full_width"])
def test_mlp_training_matches_the_jax_package(case):
    """bench_mlp_train's loop, 3 steps from the same weights; the full
    width (784-1024-1024-10, batch 512) too."""
    widths, b = ((784, 1024, 1024, 10), 512) if case == "full_width" \
        else ((20, 16, 16, 10), 32)
    opt = {"learning_rate": 0.05}
    if case == "momentum_wd_clip":
        opt.update(momentum=0.9, wd=1e-3, clip_gradient=0.01)
    rng = np.random.RandomState(0)
    x = rng.rand(b, widths[0]).astype("f4")
    y = rng.randint(0, widths[-1], b).astype("f4")
    jnet, tnet = _mlp(jmx, widths), _mlp(mx, widths)
    jnet.hybridize()
    tnet.hybridize()
    models.load_jax_gluon_params(
        tnet, {k: v.data().asnumpy()
               for k, v in jnet.collect_params().items()}, jnet.prefix)
    jl, jw = _train(jmx, jnet, x, y, opt)
    tl, tw = _train(mx, tnet, x, y, opt)
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert tl[-1] < tl[0]
    for a, c in zip(tw, jw):
        assert np.abs(a - c).max() <= 1e-4 * np.abs(c).max()


def test_trainer_surface_and_checks():
    net = _mlp(mx, (3, 2))
    params = net.collect_params()
    tr = gluon.Trainer(params, "sgd", {"learning_rate": 0.5})
    assert tr.learning_rate == 0.5
    tr.set_learning_rate(0.25)
    assert tr.optimizer.learning_rate == 0.25
    before = params["mlp_dense0_weight"].data().asnumpy().copy()
    params["mlp_dense0_weight"].grad_req = "null"
    x = nd.array(np.ones((4, 3), "f4"), ctx=CPU)
    with autograd.record():
        y = net(x).sum()
    y.backward()
    tr.step(4)
    np.testing.assert_array_equal(params["mlp_dense0_weight"].data()
                                  .asnumpy(), before)
    with pytest.raises(MXNetError, match="kvstore"):
        gluon.Trainer(params, "sgd", kvstore="dist_sync")
    assert isinstance(gluon.Trainer(params, "adam").optimizer,
                      mx.optimizer.Adam)
    assert isinstance(gluon.Trainer(params, "lamb").optimizer,
                      mx.optimizer.LAMB)
    with pytest.raises(MXNetError, match="Cannot find optimizer"):
        gluon.Trainer(params, "nadam")
    with pytest.raises(ValueError):
        gluon.Trainer([1, 2], "sgd")
    o = mx.optimizer.SGD(learning_rate=0.1)
    assert gluon.Trainer(params, o).optimizer is o


def test_load_jax_gluon_params_checks():
    jnet, tnet = _mlp(jmx, (3, 2)), _mlp(mx, (3, 2))
    params = {k: v.data().asnumpy() for k, v in
              jnet.collect_params().items()}
    models.load_jax_gluon_params(tnet, params, "mlp_")
    np.testing.assert_array_equal(
        tnet.collect_params()["mlp_dense0_bias"].data().asnumpy(),
        params["mlp_dense0_bias"])
    with pytest.raises(MXNetError, match="prefix"):
        models.load_jax_gluon_params(tnet, params, "other_")
    with pytest.raises(MXNetError, match="missing"):
        models.load_jax_gluon_params(
            tnet, {"mlp_dense0_weight": params["mlp_dense0_weight"]},
            "mlp_")
    with pytest.raises(MXNetError, match="shape"):
        models.load_jax_gluon_params(
            tnet, dict(params, mlp_dense0_bias=np.zeros(5, "f4")), "mlp_")
    with pytest.raises(MXNetError, match="does not have"):
        models.load_jax_gluon_params(
            tnet, dict(params, mlp_extra=np.zeros(1, "f4")), "mlp_")
