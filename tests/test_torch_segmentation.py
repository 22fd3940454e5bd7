"""``models/segmentation.py`` against the JAX package on the CPU.

``FCN`` and ``DeepLabV3`` at ``fcn_tiny``'s and ``deeplab_tiny``'s
widths (thumbnail resnet18, 3 classes; dropout 0, so that both packages
run the same function) take 3 hybridized SGD-momentum steps through the
gluon loop (``autograd.record``, ``SoftmaxSegLoss``, ``backward``,
``Trainer.step``) at batch 8 and the recipe's lr 1e-3 from the JAX
model's weights, carried by name.  The JAX package runs them eagerly:
its per-op compiles of the shared backbone then serve both nets in one
process.  ``SegmentationMetric`` equals the JAX metric on the same
labels and predictions, given as NDArrays or as numpy arrays, and
``SoftmaxSegLoss`` equals the JAX loss in value and gradient.
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import gluon, models, nd
from mxnet_tpu_torch.base import MXNetError

import torch_parity

CPU = mx.cpu()


def blob_batch(n, size, seed):
    """example/segmentation_fcn.py's images: a bright square (class 1)
    and a tinted circle (class 2) on noise, with a -1 ("ignore") band
    around the square."""
    rng = np.random.RandomState(seed)
    x = rng.rand(n, 3, size, size).astype("f4") * 0.1
    y = np.zeros((n, size, size), "f4")
    yy, xx = np.mgrid[0:size, 0:size]
    for i in range(n):
        cx, cy = rng.randint(8, size - 8, 2)
        sq = (np.abs(yy - cy) < 4) & (np.abs(xx - cx) < 4)
        band = (np.abs(yy - cy) < 5) & (np.abs(xx - cx) < 5) & ~sq
        x[i, :, sq] += 0.8
        y[i][sq] = 1
        y[i][band] = -1
        cx2, cy2 = rng.randint(6, size - 6, 2)
        circ = (yy - cy2) ** 2 + (xx - cx2) ** 2 < 9
        x[i, 1, circ] += 0.5
        y[i][circ] = 2
    return x, y


def _net(pkg, kind):
    """fcn_tiny's or deeplab_tiny's widths with dropout 0."""
    seg = pkg.models.segmentation
    backbone = pkg.gluon.model_zoo.vision.resnet18_v1(classes=10,
                                                      thumbnail=True)
    if kind == "fcn":
        return seg.FCN(3, backbone, c3_channels=256, c4_channels=512,
                       dropout=0.0)
    return seg.DeepLabV3(3, backbone, c3_channels=256, c4_channels=512,
                         aspp_channels=32, dropout=0.0)


def _loop(pkg, net, batches, ctx, dtype="float32", first=None):
    """3 steps of the gluon loop; ``first()`` runs after the first
    forward (the deferred shapes are made), before its backward."""
    trainer = pkg.gluon.Trainer(net.collect_params(), "sgd",
                                {"learning_rate": 1e-3, "momentum": 0.9,
                                 "wd": 1e-4})
    loss_fn = pkg.models.SoftmaxSegLoss(aux_weight=0.5)
    losses = []
    for x, y in batches:
        x = pkg.nd.array(x, ctx=ctx, dtype=dtype)
        y = pkg.nd.array(y, ctx=ctx, dtype=dtype)
        with pkg.autograd.record():
            loss = loss_fn(net(x), y)
        if first is not None:
            first()
            first = None
        loss.backward()
        trainer.step(x.shape[0])
        losses.append(float(loss.asnumpy().ravel()[0]))
    return losses


def _strip(name):
    return models.convert._unnumbered(name, "parameter")


def _values(net):
    return {_strip(k): p.data().asnumpy().astype("f8")
            for k, p in net.collect_params().items()}


def _port(kind, start, x, dtype="float32"):
    net = _net(mx, kind)
    net.initialize(mx.init.Xavier(), ctx=CPU)
    net.hybridize()
    net(nd.array(x, ctx=CPU))
    models.load_jax_gluon_params(net, start)
    if dtype != "float32":
        net.cast(dtype)
    return net


@pytest.mark.parametrize("kind", ["fcn", "deeplab"])
def test_three_sgd_steps_match_jax(kind):
    """Losses and weights are held within the larger of 1e-4 (relative)
    and 4x the port's own float32-vs-float64 distance (the rule of the
    card's parity phases).  The floor holds every leaf but the BatchNorm
    betas (and one running mean): these end near 2e-5 from 0 after 3
    steps at lr 1e-3, and their gradients, sums over 8192 pixels that
    nearly cancel, part float32 from float64 by ~1 % of that.  Here the
    worst leaf sits at 0.3 of its limit.  With other initial weights the
    rule can fail on a beta where the JAX package's float32 run parts
    from the float64 result by up to ~1e-6 while the port's stays within
    ~1e-8 (the port's float64 run equals the JAX package's to ~1e-12)."""
    batches = [blob_batch(8, 32, s) for s in range(3)]
    jmx.random.seed(0)
    jnet = _net(jmx, kind)
    jnet.initialize(jmx.init.Xavier())
    start = {}

    def weights_at_start():
        # the deferred shapes are made by the first forward, which also
        # moves the running statistics: theirs at the start are the
        # initializer's, 0 and 1
        for k, v in jnet.collect_params().items():
            start[k] = v.data().asnumpy()
            if k.endswith(("running_mean", "running_var")):
                start[k] = np.full_like(start[k],
                                        float(k.endswith("var")))

    jl = _loop(jmx, jnet, batches, jmx.cpu(), first=weights_at_start)
    net = _port(kind, start, batches[0][0])
    # each parameter once, in the JAX order, under the same names but
    # for the blocks' numbers
    tnames = list(net.collect_params().keys())
    assert len(tnames) == len(set(tnames)) == len(start)
    assert [_strip(n) for n in tnames] == [_strip(n) for n in start]
    tl = _loop(mx, net, batches, CPU)
    net64 = _port(kind, start, batches[0][0], "float64")
    l64 = _loop(mx, net64, batches, CPU, "float64")
    for got, want, ref in zip(tl, jl, l64):
        assert abs(got - want) <= max(1e-4 * abs(want),
                                      4 * abs(got - ref)), (tl, jl, l64)
    want, got, ref = _values(jnet), _values(net), _values(net64)
    for name in got:
        scale = max(np.linalg.norm(want[name]), 1e-3)
        own = np.linalg.norm(got[name] - ref[name])
        assert np.linalg.norm(got[name] - want[name]) <= max(
            1e-4 * scale, 4 * own), name
    x = nd.array(batches[0][0], ctx=CPU)
    pred = net.predict(x)
    assert pred.shape == (8, 32, 32)
    np.testing.assert_array_equal(
        pred.asnumpy(), net(x)[0].asnumpy().argmax(axis=1))
    # it learns: the first batch's loss, in training mode as at step 1,
    # is lower after the 3 steps (each step sees another batch, so the
    # per-step losses need not fall at lr 1e-3)
    with mx.autograd.record():
        again = models.SoftmaxSegLoss(aux_weight=0.5)(
            net(x), nd.array(batches[0][1], ctx=CPU))
    assert float(again.asnumpy()[0]) < tl[0], (again, tl)


def test_segmentation_metric_matches_jax():
    from mxnet_tpu.models.segmentation import SegmentationMetric as JMetric
    rng = np.random.RandomState(3)
    jm, tm, hm = JMetric(4), models.SegmentationMetric(4), \
        models.SegmentationMetric(4)
    for _ in range(3):
        label = rng.randint(-1, 4, (2, 9, 7)).astype("f4")
        pred = rng.randint(0, 4, (2, 9, 7)).astype("f4")
        jm.update(jmx.nd.array(label), jmx.nd.array(pred))
        tm.update([nd.array(label, ctx=CPU)], [nd.array(pred, ctx=CPU)])
        hm.update(label, pred)
    assert tm.get_name_value() == jm.get_name_value()
    assert hm.get_name_value() == jm.get_name_value()
    assert tm.num_inst == jm.num_inst == hm.num_inst
    np.testing.assert_array_equal(tm._cm, jm._cm)
    tm.reset()
    assert tm._cm.sum() == 0 and tm.get()[1] == [0.0, 0.0]


def test_softmax_seg_loss_matches_jax():
    x, y = blob_batch(2, 20, 5)
    logits = np.random.RandomState(5).randn(2, 3, 20, 20).astype("f4")
    aux = np.random.RandomState(6).randn(2, 3, 20, 20).astype("f4")

    def loss(F, a, b, label):
        pkg = jmx if F is jmx.nd else mx
        return pkg.models.SoftmaxSegLoss(aux_weight=0.5)((a, b), label)

    torch_parity.check(loss, [logits, aux, y])
    # float64 stays float64, as in the JAX package with x64 on
    got = loss(nd, *(nd.array(a, ctx=CPU, dtype="float64")
                     for a in (logits, aux, y)))
    assert got.dtype == np.float64


def test_truncate_features_keeps_the_stages():
    from mxnet_tpu_torch.gluon.model_zoo import vision
    from mxnet_tpu_torch.models.feature import truncate_features
    net = vision.resnet50_v1()
    blocks = truncate_features(net)
    assert len(blocks) == 8          # stem conv, BN, relu, pool, 4 stages
    assert blocks[-1] is list(net.features._child_blocks())[-2]
    tiny = gluon.nn.HybridSequential()
    tiny.features = gluon.nn.HybridSequential()
    tiny.features.add(gluon.nn.Conv2D(4, 3), gluon.nn.GlobalAvgPool2D())
    with pytest.raises(MXNetError, match="shallow"):
        truncate_features(tiny)
    tiny.features = gluon.nn.HybridSequential()
    tiny.features.add(gluon.nn.Conv2D(4, 3), gluon.nn.Dense(3),
                      gluon.nn.Conv2D(4, 3), gluon.nn.Conv2D(4, 3))
    with pytest.raises(MXNetError, match="Dense"):
        truncate_features(tiny)


def test_backbone_blocks_have_a_second_parent():
    """The zoo net keeps its blocks; the FCN lists their parameters once,
    under the zoo net's prefix, and the aux head's output is stage 3's."""
    from mxnet_tpu_torch.gluon.model_zoo import vision
    zoo = vision.resnet18_v1(classes=10, thumbnail=True)
    net = models.FCN(3, zoo, 256, 512, aux=False)
    names = list(net.collect_params().keys())
    own = [n for n in names if n.startswith(zoo.prefix)]
    assert own and len(names) == len(set(names))
    assert all(n in zoo.collect_params() for n in own)
    assert not any("dense" in n for n in own)
    net.initialize(mx.init.Xavier(), ctx=CPU)
    out = net(nd.array(blob_batch(1, 32, 0)[0], ctx=CPU))
    assert not isinstance(out, (tuple, list)) and out.shape == (1, 3, 32, 32)
