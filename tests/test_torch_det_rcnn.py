"""``models/rcnn.py`` against the JAX package on the CPU.

* ``_encode_deltas``/``_apply_deltas``: ``tests/test_rcnn.py``'s round
  trip and clip, and seeded boxes, in both packages;
* the anchors (the constant parameter) and their IoU with a GT equal to
  anchor 40 (``tests/test_rcnn.py``), exactly;
* faster_rcnn_tiny's forward from the JAX model's weights (carried by
  name) on a batch whose objectness logits are well apart: the RPN's
  outputs and the head's at the float32 tolerances of
  ``mxnet_tpu/test_utils.py`` (rtol 1e-4, atol 1e-5), the proposals
  (``topk``'s indices) exactly; ``decode`` of those outputs;
* (FasterRCNNLoss and 3 Adam steps: ``test_torch_det_rcnn_train.py``).
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu.models import rcnn as jrcnn
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import nd
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.models import rcnn

from torch_zoo import CPU, close, pair


def _batch(rng, n, size=64):
    imgs = np.zeros((n, 3, size, size), "f4")
    labels = np.zeros((n, 1, 5), "f4")
    for i in range(n):
        x1, y1 = rng.randint(0, size // 2, 2)
        w = rng.randint(size // 4, size // 2)
        imgs[i, :, y1:y1 + w, x1:x1 + w] = 1.0
        labels[i, 0] = [0.0, x1 / size, y1 / size, (x1 + w) / size,
                        (y1 + w) / size]
    return imgs, labels


def _both(fn, *arrays):
    """fn(nd, *arrays) in each package: (port's, JAX's) as numpy."""
    out = []
    for pkg, zoo in ((mx, rcnn), (jmx, jrcnn)):
        xs = [pkg.nd.array(a, ctx=pkg.cpu()) for a in arrays]
        out.append(fn(pkg.nd, zoo, *xs).asnumpy())
    return out


def test_deltas_round_trip_and_clip_match_jax():
    src = np.array([[[4., 4., 20., 28.]]], "f4")
    dst = np.array([[[8., 2., 30., 26.]]], "f4")
    got, want = _both(lambda F, z, s, d: z._apply_deltas(
        F, s, z._encode_deltas(F, s, d), 64), src, dst)
    close(got, want)
    np.testing.assert_allclose(got, dst, rtol=1e-5, atol=1e-4)
    got, want = _both(lambda F, z, s, d: z._apply_deltas(F, s, d, 64),
                      np.array([[[0., 0., 60., 60.]]], "f4"),
                      np.array([[[2.0, 2.0, 3.9, 3.9]]], "f4"))
    close(got, want)
    assert got.min() >= 0.0 and got.max() <= 64.0
    rng = np.random.RandomState(1)
    corners = np.sort(rng.rand(2, 2, 8, 2, 2).astype("f4") * 64, axis=-2)
    src, dst = (c.transpose(0, 2, 1, 3).reshape(2, 8, 4)[..., [0, 2, 1, 3]]
                for c in corners)
    got, want = _both(lambda F, z, s, d: z._encode_deltas(F, s, d), src,
                      dst)
    close(got, want)


def test_anchors_and_their_iou_match_jax():
    net = rcnn.faster_rcnn_tiny(num_classes=2)
    jnet = jrcnn.faster_rcnn_tiny(num_classes=2)
    np.testing.assert_array_equal(net._anchors_np, jnet._anchors_np)
    assert net.num_anchors == jnet.num_anchors == 3 * 64
    net.initialize(mx.init.Xavier(), ctx=CPU)
    np.testing.assert_array_equal(net.anchors_c.data(CPU).asnumpy(),
                                  net._anchors_np)
    a0 = net._anchors_np[40] / 64.0
    labels = np.array([[[1, a0[0], a0[1], a0[2], a0[3]]]], "f4")
    got, want = _both(lambda F, z, anc, lab: F.contrib.box_iou(
        anc, lab[:, :, 1:] * 64.0), net._anchors_np[None], labels)
    np.testing.assert_array_equal(got, want)
    assert got.max() == 1.0 and got.argmax() == 40
    with pytest.raises(MXNetError):
        rcnn.FasterRCNN(2, image_size=60)


def _pair(x):
    return pair(lambda: jrcnn.faster_rcnn_tiny(num_classes=2,
                                               prefix="rcnn_"),
                lambda: rcnn.faster_rcnn_tiny(num_classes=2,
                                              prefix="rcnn_"), x)


def test_forward_proposals_and_decode_match_jax():
    x, _ = _batch(np.random.RandomState(2), 2)
    x += np.random.RandomState(3).rand(*x.shape).astype("f4") * 0.5
    jnet, tnet = _pair(x)
    # spread the objectness logits apart: the RPN bias of each anchor
    # shape by 2, so the top K ranks no two near-equal scores
    for net in (jnet, tnet):
        bias = net.rpn_obj.bias
        bias.set_data(bias.data() * 0 + np.array([0.0, 2.0, 4.0], "f4"))
    jout = [o.asnumpy() for o in jnet(jmx.nd.array(x))]
    tout = [o.asnumpy() for o in tnet(nd.array(x, ctx=CPU))]
    obj = jout[0]
    top = np.sort(obj, axis=-1)[:, ::-1][:, :17]
    assert (np.abs(np.diff(top, axis=-1)) > 1e-4).all()   # well apart
    for name, g, w in zip(("obj", "deltas", "proposals", "cls", "box"),
                          tout, jout):
        assert g.shape == w.shape, name
        close(g, w, name)
    assert tout[2].shape == (2, 16, 4)
    jdec = jnet.decode(tuple(jmx.nd.array(o) for o in jout)).asnumpy()
    tdec = tnet.decode(tuple(nd.array(o, ctx=CPU) for o in jout)).asnumpy()
    close(tdec, jdec, "decode")
