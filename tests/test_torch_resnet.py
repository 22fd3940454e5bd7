"""The port's vision model zoo (the ResNets) against the JAX package's.

As ``tests/test_model_zoo.py`` (``test_resnets``,
``test_resnet_full_size_and_hybridize``, ``test_get_model_unknown``,
``test_pretrained_is_documented_gap``, ``test_resnet_trains_one_step``),
with the JAX model as the oracle: each pair of models is built under one
prefix, called once on the same input (which sets the deferred shapes),
and the JAX weights, running statistics included, are carried across by
``models.load_jax_gluon_params``.  Outputs, weights and running
statistics are compared at the float32 tolerances of
``mxnet_tpu/test_utils.py`` (rtol 1e-4, atol 1e-5), losses too.

* resnet18_v1 and resnet18_v2 (``thumbnail=True``, 10 classes, batch 2,
  32 x 32): predict mode, and a training-mode forward with the running
  statistics after it, hybridized and not;
* one BottleneckV1 and one BottleneckV2 block (resnet50's first,
  downsampling) the same way;
* 3 SGD steps (learning rate 0.1, momentum 0.9, wd 1e-4, batch 4,
  16 x 16) of the hybridized resnet18_v1 through
  ``DataParallelTrainer(fuse_step=True)`` against the JAX package's
  ``DataParallelTrainer`` (eager), and through the gluon loop (record,
  backward, ``Trainer.step``) against the JAX gluon loop: the losses,
  then every weight and running statistic.
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu import parallel as jparallel
from mxnet_tpu.gluon.model_zoo import vision as jvision
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, gluon, models, nd, parallel
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon.model_zoo import vision

CPU = mx.cpu()
F32 = dict(rtol=1e-4, atol=1e-5)


def _close(got, want, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               err_msg=what, **F32)


def _pair(build_jax, build_port, x):
    """(JAX block, port block) with the JAX weights in the port's."""
    jnet = build_jax()
    jnet.initialize(jmx.init.Xavier())
    jnet(jmx.nd.array(x))
    tnet = build_port()
    tnet.initialize(mx.init.Xavier(), ctx=CPU, seed=0)
    tnet(nd.array(x, ctx=CPU))
    models.load_jax_gluon_params(tnet, _values(jnet), jnet.prefix)
    return jnet, tnet


def _values(net):
    return {k: p.data().asnumpy() for k, p in net.collect_params().items()}


def _assert_params_equal(tnet, jnet):
    want = _values(jnet)
    for k, v in _values(tnet).items():
        _close(v, want[k], k)


# -- get_model ------------------------------------------------------------------------

NAMES = [f"resnet{d}_v{v}" for v in (1, 2) for d in (18, 34, 50, 101, 152)]


@pytest.mark.parametrize("name", NAMES)
def test_get_model_builds_the_reference_structure(name):
    """Every ResNet builds with the reference's parameter names, in the
    reference's order, and the same shapes where they are known before
    the first call."""
    jnet = jvision.get_model(name, classes=10, prefix="net_")
    tnet = vision.get_model(name, classes=10, prefix="net_")
    jparams, tparams = jnet.collect_params(), tnet.collect_params()
    assert list(tparams.keys()) == list(jparams.keys())
    for k, p in tparams.items():
        want = jparams[k].shape
        assert p.shape == tuple(0 if s is None else s for s in want), k


def test_get_model_unknown():
    with pytest.raises(MXNetError, match="not supported"):
        vision.get_model("resnet999")
    with pytest.raises(MXNetError, match="depth"):
        vision.get_resnet(1, 20)


def test_pretrained_raises():
    with pytest.raises(MXNetError, match="network access"):
        vision.get_model("resnet18_v1", pretrained=True)


# -- the forward against the JAX models ---------------------------------------------

def _forward_checks(jnet, tnet, x, hybridize):
    if hybridize:
        jnet.hybridize()
        tnet.hybridize()
    # predict mode
    _close(tnet(nd.array(x, ctx=CPU)).asnumpy(),
           jnet(jmx.nd.array(x)).asnumpy(), "predict")
    # a training-mode forward, then the running statistics
    with autograd.record():
        got = tnet(nd.array(x, ctx=CPU))
    with jmx.autograd.record():
        want = jnet(jmx.nd.array(x))
    _close(got.asnumpy(), want.asnumpy(), "train")
    _assert_params_equal(tnet, jnet)


@pytest.mark.parametrize("hybridize", [False, True], ids=["eager", "hybrid"])
@pytest.mark.parametrize("name", ["resnet18_v1", "resnet18_v2"])
def test_resnet18_matches_jax(name, hybridize):
    x = np.random.RandomState(0).rand(2, 3, 32, 32).astype("f4")
    jnet, tnet = _pair(
        lambda: jvision.get_model(name, classes=10, thumbnail=True,
                                  prefix="net_"),
        lambda: vision.get_model(name, classes=10, thumbnail=True,
                                 prefix="net_"), x)
    _forward_checks(jnet, tnet, x, hybridize)


@pytest.mark.parametrize("hybridize", [False, True], ids=["eager", "hybrid"])
@pytest.mark.parametrize("version", [1, 2])
def test_resnet50_bottleneck_matches_jax(version, hybridize):
    """resnet50's first block of stage 2: 256 -> 512 channels, stride 2,
    downsampled."""
    x = np.random.RandomState(1).rand(2, 256, 8, 8).astype("f4")

    def build(pkg, zoo):
        # a block makes its layers outside its own name scope, as the
        # reference's do: an outer scope gives them names both packages
        # count alike
        outer = pkg.gluon.nn.HybridSequential(prefix="blk_")
        with outer.name_scope():
            outer.add(getattr(zoo, f"BottleneckV{version}")(
                512, 2, True, in_channels=256, prefix=""))
        return outer
    jnet, tnet = _pair(lambda: build(jmx, jvision), lambda: build(mx, vision),
                       x)
    _forward_checks(jnet, tnet, x, hybridize)


# -- training against the JAX package ----------------------------------------------

OPT = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}


def _train_pair():
    rng = np.random.RandomState(2)
    x = rng.rand(4, 3, 16, 16).astype("f4")
    y = rng.randint(0, 10, 4).astype("f4")
    jnet, tnet = _pair(
        lambda: jvision.get_model("resnet18_v1", classes=10, thumbnail=True,
                                  prefix="net_"),
        lambda: vision.get_model("resnet18_v1", classes=10, thumbnail=True,
                                 prefix="net_"), x)
    jnet.hybridize()
    tnet.hybridize()
    return jnet, tnet, x, y


def test_three_sgd_steps_through_data_parallel_trainer_match_jax():
    jnet, tnet, x, y = _train_pair()
    jsce = jmx.gluon.loss.SoftmaxCrossEntropyLoss()
    jdpt = jparallel.DataParallelTrainer(
        jnet, lambda out, label: jsce(out, label).mean(), "sgd", OPT,
        mesh=jparallel.make_mesh({"dp": 1}), fuse_step=False)
    want = [float(jdpt.step(jmx.nd.array(x), jmx.nd.array(y)).asnumpy())
            for _ in range(3)]
    sce = gluon.loss.SoftmaxCrossEntropyLoss()
    dpt = parallel.DataParallelTrainer(
        tnet, lambda out, label: sce(out, label).mean(), "sgd", OPT,
        fuse_step=True)
    got = [float(dpt.step(nd.array(x, ctx=CPU),
                          nd.array(y, ctx=CPU)).asnumpy())
           for _ in range(3)]
    _close(got, want, "losses")
    assert got[2] < got[0]
    _assert_params_equal(tnet, jnet)


def test_three_sgd_steps_through_the_gluon_loop_match_jax():
    jnet, tnet, x, y = _train_pair()
    losses = []
    for pkg, net, arr in ((jmx, jnet, jmx.nd.array),
                          (mx, tnet, lambda a: nd.array(a, ctx=CPU))):
        trainer = pkg.gluon.Trainer(net.collect_params(), "sgd", OPT,
                                    kvstore=None)
        sce = pkg.gluon.loss.SoftmaxCrossEntropyLoss()
        run = []
        for _ in range(3):
            with pkg.autograd.record():
                loss = sce(net(arr(x)), arr(y))
            loss.backward()
            trainer.step(4)
            run.append(loss.asnumpy())
        losses.append(run)
    want, got = losses
    for g, w in zip(got, want):
        _close(g, w, "losses")
    assert got[2].mean() < got[0].mean()
    _assert_params_equal(tnet, jnet)


def test_data_parallel_trainer_resolves_deferred_shapes_first():
    """As resnet_bench.py drives it: get_model, initialize, hybridize and
    the trainer before any call.  The first step makes the deferred
    parameters by one predict-mode call (the running statistics stay
    put until the step itself), so the losses equal those of a twin
    whose shapes a predict-mode call set before its trainer was built."""
    rng = np.random.RandomState(3)
    x = nd.array(rng.rand(4, 3, 16, 16).astype("f4"), ctx=CPU)
    y = nd.array(rng.randint(0, 10, 4).astype("f4"), ctx=CPU)
    runs = []
    for call_first in (False, True):
        net = vision.get_model("resnet18_v1", classes=10, thumbnail=True)
        net.initialize(mx.init.Xavier(), ctx=CPU, seed=4)
        net.hybridize()
        if call_first:
            net(x)
        sce = gluon.loss.SoftmaxCrossEntropyLoss()
        dpt = parallel.DataParallelTrainer(
            net, lambda out, label: sce(out, label).mean(), "sgd", OPT,
            fuse_step=True)
        runs.append([float(dpt.step(x, y).asnumpy()) for _ in range(2)])
        assert all(not p._deferred for p in net.collect_params().values())
    assert runs[0] == runs[1]
    assert np.isfinite(runs[0]).all()
