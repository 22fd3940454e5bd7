"""``models/yolo.py`` against the JAX package on the CPU.

* ``build_targets`` on ``tests/test_yolo.py``'s cases (one centred GT, a
  padded row, two GTs on one slot whose classes differ, two GTs on two
  slots) and on a seeded batch of 8 padded rows an image: the objectness
  slots and class ids exactly, the regression targets at the float32
  tolerances of ``mxnet_tpu/test_utils.py`` (rtol 1e-4, atol 1e-5);
* ``decode`` of ``tests/test_yolo.py``'s hand-made head (one slot on)
  and of a seeded head whose scores are well apart;
* (the forward and 3 Adam steps: ``test_torch_det_yolo_train.py``).
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu.models import yolo as jyolo
import mxnet_tpu_torch as mx
from mxnet_tpu_torch.models import yolo

from torch_zoo import close

CASES = {
    "single": (2, [[[1, 0.25, 0.25, 0.75, 0.75]]]),
    "padded": (2, [[[-1, 0.2, 0.2, 0.6, 0.6]]]),
    "colliding": (3, [[[2, 0.25, 0.25, 0.75, 0.75],
                       [0, 0.25, 0.25, 0.75, 0.75]]]),
    "two_slots": (2, [[[0, 0.05, 0.05, 0.30, 0.30],
                       [1, 0.55, 0.55, 0.95, 0.95]]]),
}


def _batch(rng, n, size=32, rows=1):
    """Bright squares on black, one GT row each, padded to ``rows``."""
    imgs = np.zeros((n, 3, size, size), "f4")
    labels = np.full((n, rows, 5), -1.0, "f4")
    for i in range(n):
        x1, y1 = rng.randint(0, size // 2, 2)
        w = rng.randint(size // 4, size // 2)
        imgs[i, :, y1:y1 + w, x1:x1 + w] = 1.0
        labels[i, 0] = [0.0, x1 / size, y1 / size, (x1 + w) / size,
                        (y1 + w) / size]
    return imgs, labels


def _targets(pkg, zoo, classes, labels):
    net = zoo.yolo3_tiny(num_classes=classes)
    arr = pkg.nd.array(np.asarray(labels, "f4"), ctx=pkg.cpu())
    return [t.asnumpy() for t in zoo.build_targets(net, arr, arr.context)]


def _check_targets(classes, labels):
    want = _targets(jmx, jyolo, classes, labels)
    got = _targets(mx, yolo, classes, labels)
    np.testing.assert_array_equal(got[0], want[0])          # objectness
    np.testing.assert_array_equal(got[5] * got[0], want[5] * want[0])
    for g, w in zip(got, want):
        close(g, w)
    return got


@pytest.mark.parametrize("case", list(CASES))
def test_build_targets_matches_jax(case):
    classes, labels = CASES[case]
    got = _check_targets(classes, labels)
    want_pos = {"single": 1, "padded": 0, "colliding": 1, "two_slots": 2}
    assert got[0].sum() == want_pos[case]
    if case == "colliding":
        assert got[5][0, got[0][0].argmax()] == 2.0   # the lowest-index GT


def test_build_targets_of_a_padded_batch_match_jax():
    """8 GT rows an image, 1-8 of them real, seeded boxes of 2-28
    pixels (several share slots)."""
    rng = np.random.RandomState(7)
    labels = np.full((6, 8, 5), -1.0, "f4")
    for i in range(6):
        for j in range(rng.randint(1, 9)):
            x1, y1 = rng.rand(2) * 0.8
            w, h = 0.05 + rng.rand(2) * 0.8
            labels[i, j] = [rng.randint(0, 3), x1, y1, min(x1 + w, 1.0),
                            min(y1 + h, 1.0)]
    got = _check_targets(3, labels)
    assert got[0].sum() > 6


def _decode(pkg, zoo, preds, **kw):
    net = zoo.yolo3_tiny(num_classes=2)
    return net.decode(pkg.nd.array(preds, ctx=pkg.cpu()), **kw).asnumpy()


def test_decode_matches_jax():
    """``tests/test_yolo.py``'s hand-made head, then a seeded head whose
    objectness logits are 0.5 apart (no near-ties for box_nms)."""
    n = yolo.yolo3_tiny(num_classes=2).num_slots
    preds = np.full((1, n, 7), -20.0, "f4")
    preds[0, 5, :4] = 0.0
    preds[0, 5, 4:6] = 20.0
    got = _decode(mx, yolo, preds, conf_thresh=0.5)
    close(got, _decode(jmx, jyolo, preds, conf_thresh=0.5))
    assert (got[0, :, 0] >= 0).sum() == 1
    rng = np.random.RandomState(3)
    preds = rng.randn(2, n, 7).astype("f4")
    preds[:, :, 4] = rng.permutation(2 * n).reshape(2, n) * 0.5 - 30
    got = _decode(mx, yolo, preds)
    close(got, _decode(jmx, jyolo, preds))
    assert (got[..., 0] >= 0).sum() > 4
