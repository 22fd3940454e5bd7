"""The port's ``hybridize()`` (the CachedOp) and deferred parameter
shapes, against the JAX package.

Ports of the reference's hybridize and deferred-shape cases
(``tests/test_gluon.py``: ``test_parameter_deferred``,
``test_dense_deferred_and_flatten``, ``test_hybridize_consistency``,
``test_hybridize_grad_consistency``, ``test_batchnorm_running_stats``,
``test_batchnorm_numerics``, ``test_conv_pool_hybrid``): the JAX block
and the port's are built under one prefix, the JAX weights carried
across by ``models.load_jax_gluon_params``, and outputs, gradients and
running statistics compared at the float32 tolerances of
``mxnet_tpu/test_utils.py`` (rtol 1e-4, atol 1e-5).  On the CPU a
hybridized call runs the block as it is, so the port's own cases hold
what a replay on the card depends on:

* a later call does not overwrite an earlier call's output (a replay
  writes the graph's buffers; here a stand-in for ``StepCapture.run``
  returns buffers that each call overwrites, as a replay does);
* ``set_data`` and a new ``initialize`` after a call are read by the
  next call;
* one cache entry a (input shapes, dtypes, training, recording) key;
* inside ``DataParallelTrainer(fuse_step=True)`` and
  ``Trainer.compile_step`` a hybridized block runs inline: the step body
  runs the very ops (under a ``TorchDispatchMode``) of the same step
  with the block not hybridized, and the CachedOp is never consulted.
"""
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import _capture, autograd, gluon, models, nd, parallel
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon import nn

CPU = mx.cpu()
F32 = dict(rtol=1e-4, atol=1e-5)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **F32)


def _twins(build, x):
    """The JAX block and the port's, built by ``build(pkg)`` under one
    prefix, the port's holding the JAX block's weights (both called once
    on ``x`` first, which sets the deferred shapes)."""
    jnet = build(jmx)
    jnet.initialize(jmx.init.Xavier())
    jnet(jmx.nd.array(x))
    tnet = build(mx)
    tnet.initialize(mx.init.Xavier(), ctx=CPU, seed=1)
    tnet(nd.array(x, ctx=CPU))
    models.load_jax_gluon_params(
        tnet, {k: p.data().asnumpy()
               for k, p in jnet.collect_params().items()}, jnet.prefix)
    return jnet, tnet


def _mlp(pkg):
    net = pkg.gluon.nn.HybridSequential(prefix="mlp_")
    with net.name_scope():
        net.add(pkg.gluon.nn.Dense(16, activation="relu"),
                pkg.gluon.nn.Dense(8, activation="tanh"),
                pkg.gluon.nn.Dense(4))
    return net


def _conv_net(pkg):
    nn_ = pkg.gluon.nn
    net = nn_.HybridSequential(prefix="cnn_")
    with net.name_scope():
        net.add(nn_.Conv2D(8, 3, padding=1, activation="relu"),
                nn_.MaxPool2D(2),
                nn_.Conv2D(16, 3, padding=1),
                nn_.BatchNorm(),
                nn_.Activation("relu"),
                nn_.GlobalAvgPool2D(),
                nn_.Flatten(),
                nn_.Dense(10))
    return net


# -- deferred shapes --------------------------------------------------------------

def test_parameter_deferred():
    blk = gluon.Block(prefix="blk_")
    p = blk.params.get("weight", shape=(4, 0), allow_deferred_init=True)
    assert p.shape == (4, 0)
    with pytest.raises(MXNetError, match="allow_deferred_init"):
        blk.params.get("other", shape=(4, 0))
    blk.initialize(ctx=CPU)
    with pytest.raises(MXNetError, match="deferred"):
        p.data()
    with pytest.raises(MXNetError, match="incompatible"):
        p.shape = (5, 7)
    p.shape = (4, 7)
    p._finish_deferred_init()
    assert p.data().shape == (4, 7)
    assert p.list_ctx() == [CPU]


def test_dense_deferred_and_flatten():
    x = np.random.RandomState(0).rand(4, 3, 2).astype("f4")
    for flatten, wshape, yshape in ((True, (5, 6), (4, 5)),
                                    (False, (5, 2), (4, 3, 5))):
        jnet, tnet = _twins(
            lambda pkg: pkg.gluon.nn.Dense(5, flatten=flatten,
                                           prefix="dense_"), x)
        assert tnet.weight.shape == wshape
        y = tnet(nd.array(x, ctx=CPU))
        assert y.shape == yshape
        _close(y.asnumpy(), jnet(jmx.nd.array(x)).asnumpy())


def test_deferred_init_uses_initialize_generator_and_device():
    """A deferred parameter is made on initialize's device from its
    generator: two nets from one seed draw the same weights."""
    x = nd.array(np.ones((2, 3), "f4"), ctx=CPU)
    nets = []
    for _ in range(2):
        net = nn.Dense(4, prefix="d_")
        net.initialize(mx.init.Xavier(), ctx=CPU, seed=3)
        net(x)
        nets.append(net)
    assert nets[0].weight.device.type == "cpu"
    assert torch.equal(nets[0].weight, nets[1].weight)
    with pytest.raises(MXNetError, match="initialize"):
        nn.Dense(4)(x)


# -- hybridize against the JAX package --------------------------------------------

def test_hybridize_consistency():
    x = np.random.RandomState(0).rand(5, 12).astype("f4")
    jnet, tnet = _twins(_mlp, x)
    y_imp = tnet(nd.array(x, ctx=CPU)).asnumpy()
    tnet.hybridize()
    y_hyb = tnet(nd.array(x, ctx=CPU)).asnumpy()
    jnet.hybridize()
    _close(y_imp, y_hyb)
    _close(y_hyb, jnet(jmx.nd.array(x)).asnumpy())


def test_hybridize_grad_consistency():
    x = np.random.RandomState(1).rand(4, 6).astype("f4")
    jnet, tnet = _twins(_mlp, x)

    def grads(pkg, net):
        xx = pkg.nd.array(x) if pkg is jmx else nd.array(x, ctx=CPU)
        with pkg.autograd.record():
            y = net(xx)
            loss = (y * y).sum()
        loss.backward()
        return {k[len(net.prefix):]: p.grad().asnumpy().copy()
                for k, p in net.collect_params().items()}

    g_imp = grads(mx, tnet)
    tnet.hybridize()
    g_hyb = grads(mx, tnet)
    jnet.hybridize()
    g_jax = grads(jmx, jnet)
    for k in g_imp:
        _close(g_imp[k], g_hyb[k])
        _close(g_hyb[k], g_jax[k])


def test_batchnorm_running_stats():
    x = (np.random.RandomState(2).rand(4, 3, 2, 2) * 5 + 2).astype("f4")
    jnet, tnet = _twins(
        lambda pkg: pkg.gluon.nn.BatchNorm(in_channels=3, prefix="bn_"), x)
    tnet.hybridize()
    jnet.hybridize()
    for _ in range(2):
        with autograd.record():
            tnet(nd.array(x, ctx=CPU))
        with jmx.autograd.record():
            jnet(jmx.nd.array(x))
    rm = tnet.collect_params()["bn_running_mean"].data().asnumpy()
    assert not np.allclose(rm, 0)            # the moving mean moved
    for name in ("bn_running_mean", "bn_running_var"):
        _close(tnet.collect_params()[name].data().asnumpy(),
               jnet.collect_params()[name].data().asnumpy())
    # predict mode reads the running statistics, as the JAX block does
    y_eval = tnet(nd.array(x, ctx=CPU))
    assert y_eval.shape == x.shape
    _close(y_eval.asnumpy(), jnet(jmx.nd.array(x)).asnumpy())
    assert tnet.collect_params()["bn_running_var"].grad_req == "null"


def test_batchnorm_numerics():
    net = nn.BatchNorm(in_channels=4, momentum=0.9, epsilon=1e-5)
    net.initialize(ctx=CPU)
    net.hybridize()
    x_np = np.random.RandomState(3).rand(8, 4, 3, 3).astype("float32")
    with autograd.record():
        y = net(nd.array(x_np, ctx=CPU))
    mean = x_np.mean(axis=(0, 2, 3), keepdims=True)
    var = x_np.var(axis=(0, 2, 3), keepdims=True)
    expected = (x_np - mean) / np.sqrt(var + 1e-5)
    np.testing.assert_allclose(y.asnumpy(), expected, rtol=1e-3, atol=1e-4)


def test_conv_pool_hybrid():
    x = np.random.RandomState(4).rand(2, 3, 16, 16).astype("f4")
    jnet, tnet = _twins(_conv_net, x)
    y_imp = tnet(nd.array(x, ctx=CPU)).asnumpy()
    tnet.hybridize()
    y_hyb = tnet(nd.array(x, ctx=CPU)).asnumpy()
    assert y_hyb.shape == (2, 10)
    _close(y_imp, y_hyb)
    jnet.hybridize()
    _close(y_hyb, jnet(jmx.nd.array(x)).asnumpy())
    assert tnet.collect_params()["cnn_conv2d0_weight"].shape == (8, 3, 3, 3)


# -- the port's own cases ---------------------------------------------------------

def _replay_like(real):
    """A stand-in for ``StepCapture.run`` whose unrecorded calls return
    one set of buffers that every call overwrites, as a replay does."""
    bufs = {}

    def run(cap, body, tensors, static_key=(), generator=None,
            params=None):
        if params is not None:
            return real(cap, body, tensors, static_key, generator, params)
        outs = body(*tensors)
        mine = bufs.setdefault(id(cap), [torch.empty_like(o) for o in outs])
        for b, o in zip(mine, outs):
            b.copy_(o)
        return tuple(mine)
    return run


def test_earlier_output_is_not_overwritten(monkeypatch):
    monkeypatch.setattr(_capture.StepCapture, "run",
                        _replay_like(_capture.StepCapture.run))
    rng = np.random.RandomState(5)
    x1, x2 = rng.rand(2, 3, 8, 8).astype("f4"), rng.rand(2, 3, 8, 8)
    net = _conv_net(mx)
    net.initialize(mx.init.Xavier(), ctx=CPU, seed=2)
    want1 = net(nd.array(x1, ctx=CPU)).asnumpy()
    net.hybridize()
    y1 = net(nd.array(x1, ctx=CPU))
    y2 = net(nd.array(x2.astype("f4"), ctx=CPU))
    np.testing.assert_array_equal(y1.asnumpy(), want1)
    assert not np.array_equal(y1.asnumpy(), y2.asnumpy())


def test_set_data_and_reinitialize_after_a_call_are_seen():
    x = nd.array(np.random.RandomState(6).rand(3, 5).astype("f4"), ctx=CPU)
    net = _mlp(mx)
    net.initialize(mx.init.Xavier(), ctx=CPU, seed=4)
    net.hybridize()
    y0 = net(x).asnumpy()
    w = net.collect_params()["mlp_dense2_weight"]
    w.set_data(w.data().asnumpy() * 2)
    b = net.collect_params()["mlp_dense2_bias"]
    b.set_data(np.ones(b.shape, "f4"))
    y1 = net(x).asnumpy()
    h = net[:2](x)                              # the hidden activations
    _close(y1, (h.asnumpy() @ w.data().asnumpy().T) + 1.0)
    assert not np.allclose(y0, y1)
    net.initialize(mx.init.Xavier(), ctx=CPU, seed=8)
    y2 = net(x).asnumpy()
    net2 = _mlp(mx)
    net2.initialize(mx.init.Xavier(), ctx=CPU, seed=4)
    net2(x)
    net2.initialize(mx.init.Xavier(), ctx=CPU, seed=8)
    _close(y2, net2(x).asnumpy())


def test_one_cache_entry_per_key():
    net = _conv_net(mx)
    net.initialize(mx.init.Xavier(), ctx=CPU, seed=2)
    rng = np.random.RandomState(7)
    xa = nd.array(rng.rand(2, 3, 8, 8).astype("f4"), ctx=CPU)
    xb = nd.array(rng.rand(3, 3, 8, 8).astype("f4"), ctx=CPU)
    net(xa)                                      # sets the deferred shapes
    net.hybridize()
    for _ in range(2):
        for x in (xa, xb):
            net(x)                               # predict, not recording
            with autograd.record():
                net(x)                           # training, recording
            with autograd.record(train_mode=False):
                net(x)                           # predict, recording
            with autograd.train_mode():
                net(x)                           # training, not recording
    op = net._cached_op
    assert len(op) == 8
    keys = {(k[0][0][0], k[2], k[3]) for k in op._entries}
    assert keys == {(s, t, r) for s in ((2, 3, 8, 8), (3, 3, 8, 8))
                    for t in (False, True) for r in (False, True)}
    assert op.captures == op.replays == op.pool_bytes == 0   # no graph here
    net.hybridize()                              # a new CachedOp
    assert net._cached_op is None


_SYNCS = (torch.ops.aten._local_scalar_dense, torch.ops.aten.nonzero)


class _Ops(TorchDispatchMode):
    """Records every op of a step body with its non-tensor arguments."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func.overloadpacket in _SYNCS:
            raise AssertionError(f"host sync in the step body: {func}")
        self.ops.append((str(func), tuple(
            a for a in args if isinstance(a, (int, float, bool, str)))))
        return func(*args, **kwargs)


def _step_ops(owner, run):
    """The ops of ``owner``'s step body during ``run()``."""
    body = owner._body
    seen = []

    def recorded(*args):
        with _Ops() as mode:
            out = body(*args)
        seen.append(mode.ops)
        return out
    owner._body = recorded
    run()
    return seen


@pytest.mark.parametrize("owner", ["DataParallelTrainer", "compile_step"])
def test_hybridized_block_runs_inline_in_a_captured_step(owner):
    """The step bodies of a hybridized and an unhybridized twin run the
    same ops and reach the same weights and running statistics; the
    hybridized block's CachedOp is never consulted; neither owner
    captures anything here (the CPU), nor does the block."""
    rng = np.random.RandomState(8)
    x = rng.rand(4, 3, 8, 8).astype("f4")
    y = rng.randint(0, 10, 4).astype("f4")
    results = []
    for hybrid in (False, True):
        net = _conv_net(mx)
        net.initialize(mx.init.Xavier(), ctx=CPU, seed=2)
        net(nd.array(x, ctx=CPU))
        if hybrid:
            net.hybridize()
        sce = gluon.loss.SoftmaxCrossEntropyLoss()
        xx, yy = nd.array(x, ctx=CPU), nd.array(y, ctx=CPU)
        if owner == "DataParallelTrainer":
            step = parallel.DataParallelTrainer(
                net, sce, "sgd", {"learning_rate": 0.1, "momentum": 0.9},
                fuse_step=True)
        else:
            trainer = gluon.Trainer(net.collect_params(), "sgd",
                                    {"learning_rate": 0.1,
                                     "momentum": 0.9})
            step = trainer.compile_step(net, sce)
        seen = _step_ops(step, lambda: [step.step(xx, yy)
                                        for _ in range(2)])
        assert not _capture.in_body()
        assert step.captures == 0
        results.append((seen, {k: p.data().asnumpy() for k, p in
                               net.collect_params().items()}, net))
    (ops0, w0, _), (ops1, w1, hnet) = results
    assert len(ops0[0]) > 50 and ops0 == ops1
    for k in w0:
        np.testing.assert_array_equal(w0[k], w1[k])
    assert hnet._cached_op is None
    # the hybridized block called by itself afterwards: its CachedOp
    hnet(nd.array(x, ctx=CPU))
    assert len(hnet._cached_op) == 1


def test_deferred_parameters_get_gradients():
    """A deferred parameter is a leaf of the gluon loop's backward from
    the call that makes it: every trainable parameter of a net whose
    shapes came from its first call gets a gradient."""
    x = nd.array(np.random.RandomState(9).rand(2, 3, 8, 8).astype("f4"),
                 ctx=CPU)
    net = _conv_net(mx)
    net.initialize(mx.init.Xavier(), ctx=CPU, seed=2)
    net.hybridize()
    with autograd.record():
        loss = net(x).sum()
    loss.backward()
    for name, p in net.collect_params().items():
        if p.grad_req != "null":
            assert np.abs(p.grad().asnumpy()).max() > 0, name
