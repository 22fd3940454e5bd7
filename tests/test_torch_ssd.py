"""``models/ssd.py`` against the JAX package on the CPU:
``example/ssd_train.py``'s loop (``ssd_tiny``, MultiBoxTarget inside the
record, MultiBoxLoss, Adam) takes 3 steps from the JAX model's weights,
carried by name, in both packages: losses and every weight to 1e-4.  The
JAX net is hybridized for the loop (its eager ops would each compile, with
their gradients, on the first step); MultiBoxTarget and the loss run
eagerly, as the example runs them.
"""
import numpy as np

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import nd

CPU = mx.cpu()


def _ssd_batch(rng, n, size=32):
    imgs = np.zeros((n, 3, size, size), "f4")
    labels = np.zeros((n, 1, 5), "f4")
    for i in range(n):
        x1, y1 = rng.randint(0, size // 2, 2)
        w = rng.randint(size // 4, size // 2)
        imgs[i, :, y1:y1 + w, x1:x1 + w] = 1.0
        labels[i, 0] = [0.0, x1 / size, y1 / size, (x1 + w) / size,
                        (y1 + w) / size]
    return imgs, labels


def _ssd_steps(pkg, net, batches, ctx, steps=3):
    from_pkg = pkg.nd
    trainer = pkg.gluon.Trainer(net.collect_params(), "adam",
                                {"learning_rate": 3e-3})
    loss_fn = pkg.models.MultiBoxLoss()
    losses = []
    for imgs, labels in batches[:steps]:
        x = from_pkg.array(imgs, ctx=ctx)
        y = from_pkg.array(labels, ctx=ctx)
        with pkg.autograd.record():
            anchors, cls_preds, loc_preds = net(x)
            loc_t, loc_m, cls_t = from_pkg._contrib_MultiBoxTarget(
                anchors, y, cls_preds)
            loss = loss_fn(cls_preds, cls_t, loc_preds, loc_t, loc_m)
        loss.backward()
        trainer.step(len(imgs))
        losses.append(float(loss.asnumpy().ravel()[0]))
    det_out = from_pkg._contrib_MultiBoxDetection(
        from_pkg.softmax(cls_preds, axis=1), loc_preds, anchors)
    return losses, det_out.asnumpy()


def test_ssd_tiny_three_adam_steps_match_jax():
    """ssd_tiny's forward, MultiBoxTarget, MultiBoxLoss and 3 Adam steps
    from the JAX model's weights (carried by name) in both packages."""
    from mxnet_tpu import models as jmodels
    from mxnet_tpu_torch import models
    rng = np.random.RandomState(0)
    batches = [_ssd_batch(rng, 4) for _ in range(3)]
    jmx.random.seed(0)
    jnet = jmodels.ssd_tiny(num_classes=1, prefix="ssd_")
    jnet.initialize(jmx.init.Xavier())
    jnet(jmx.nd.array(batches[0][0]))
    start = {k: v.data().asnumpy() for k, v in
             jnet.collect_params().items()}
    net = models.ssd_tiny(num_classes=1, prefix="ssd_")
    net.initialize(mx.init.Xavier(), ctx=CPU)
    net(nd.array(batches[0][0], ctx=CPU))
    models.load_jax_gluon_params(net, start, jax_prefix="ssd_")
    assert list(net.collect_params().keys()) == list(start)
    jnet.hybridize()
    jl, jdet = _ssd_steps(jmx, jnet, batches, jmx.cpu())
    tl, tdet = _ssd_steps(mx, net, batches, CPU)
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    for name, p in net.collect_params().items():
        want = jnet.collect_params()[name].data().asnumpy()
        got = p.data().asnumpy()
        assert np.linalg.norm(got - want) <= 1e-4 * max(
            np.linalg.norm(want), 1e-6), name
    # MultiBoxDetection of the trained net: every row kept (a class id and
    # a score in (0, 1]) or all -1; the op itself is held above
    assert tdet.shape == jdet.shape
    kept = tdet[..., 0] >= 0
    assert kept.any() and (tdet[~kept] == -1).all()
    assert (tdet[kept][:, 1] > 0).all() and (tdet[kept][:, 1] <= 1).all()
