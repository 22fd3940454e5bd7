"""``models/pose.py`` against the JAX package on the CPU.

* ``gaussian_heatmaps`` (numpy in both packages): equal arrays;
* simple_pose_tiny (SimplePose over the thumbnail resnet18, two stride-2
  deconvolutions) from the JAX model's weights, carried by name: the
  heatmaps (32 x 32 inputs, 16 x 16 heatmaps) at the float32 tolerances
  of ``mxnet_tpu/test_utils.py`` (rtol 1e-4, atol 1e-5) and ``predict``'s
  keypoints (each heatmap's argmax, here well apart from its runner-up)
  exactly;
* ``PoseHeatmapLoss`` with invisible keypoints and ``PCKMetric`` on
  ``tests/test_pose.py``'s cases, in both packages;
* (3 Adam steps: ``test_torch_det_pose_train.py``).
"""
import numpy as np

import mxnet_tpu as jmx
from mxnet_tpu.models import pose as jpose
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import nd
from mxnet_tpu_torch.models import pose

from torch_zoo import CPU, close, pair

K = 2   # the square's top-left and bottom-right corners


def _scene_batch(n, size=32, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.rand(n, 3, size, size).astype("f4") * 0.1
    kp = np.zeros((n, K, 3), "f4")
    for i in range(n):
        x1, y1 = rng.randint(2, size // 2, 2)
        w = rng.randint(size // 4, size // 2 - 2)
        x[i, :, y1:y1 + w, x1:x1 + w] += 0.9
        kp[i, 0] = [x1 / size, y1 / size, 1]
        kp[i, 1] = [(x1 + w) / size, (y1 + w) / size, 1]
    kp[0, 1, 2] = 0          # one invisible keypoint
    return x, kp


def test_gaussian_heatmaps_match_jax():
    _, kp = _scene_batch(4)
    for size, sigma in ((16, 1.5), (64, 2.0)):
        got = pose.gaussian_heatmaps(kp, size, sigma=sigma)
        np.testing.assert_array_equal(
            got, jpose.gaussian_heatmaps(kp, size, sigma=sigma))
    assert got[0, 1].sum() == 0.0 and got.shape == (4, K, 64, 64)


def _pair_tiny(x):
    return pair(lambda: jpose.simple_pose_tiny(num_keypoints=K),
                lambda: pose.simple_pose_tiny(num_keypoints=K), x,
                one_prefix=False)


def test_forward_and_predict_match_jax():
    x, _ = _scene_batch(2)
    jnet, tnet = _pair_tiny(x)
    hm = tnet(nd.array(x, ctx=CPU)).asnumpy()
    jhm = jnet(jmx.nd.array(x)).asnumpy()
    assert hm.shape == (2, K, 16, 16)
    close(hm, jhm, "heatmaps")
    top = np.sort(jhm.reshape(2, K, -1), axis=-1)
    assert (top[..., -1] - top[..., -2] > 1e-4).all()   # argmax well apart
    got = tnet.predict(nd.array(x, ctx=CPU)).asnumpy()
    np.testing.assert_array_equal(got,
                                  jnet.predict(jmx.nd.array(x)).asnumpy())
    assert got.shape == (2, K, 2)


def test_heatmap_loss_and_pck_match_jax():
    kp = np.zeros((1, 2, 3), "f4")
    kp[0, 0] = [0.5, 0.5, 1]
    kp[0, 1] = [0.5, 0.5, 0]      # invisible
    tgt = pose.gaussian_heatmaps(kp, 8)
    pred = np.random.RandomState(1).rand(1, 2, 8, 8).astype("f4")
    losses = []
    for pkg, zoo in ((mx, pose), (jmx, jpose)):
        args = [pkg.nd.array(a, ctx=pkg.cpu())
                for a in (pred, tgt, kp[:, :, 2])]
        losses.append(float(zoo.PoseHeatmapLoss()(*args).asnumpy()))
    close(losses[0], losses[1], "loss")
    # error on the invisible channel counts nothing
    pred2 = pred.copy()
    pred2[0, 1] = 99.0
    args = [nd.array(a, ctx=CPU) for a in (pred2, tgt, kp[:, :, 2])]
    close(float(pose.PoseHeatmapLoss()(*args).asnumpy()), losses[0])
    labels = np.array([[[0.5, 0.5, 1], [0.2, 0.2, 1], [0.9, 0.9, 0]]], "f4")
    preds = np.array([[[0.55, 0.5], [0.5, 0.5], [0.0, 0.0]]], "f4")
    got, want = pose.PCKMetric(0.1), jpose.PCKMetric(0.1)
    got.update(nd.array(labels, ctx=CPU), nd.array(preds, ctx=CPU))
    want.update(labels, preds)
    assert got.get() == want.get() == ("PCK@0.1", 0.5)
