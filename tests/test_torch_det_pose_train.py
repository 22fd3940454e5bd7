"""simple_pose_tiny trained in both packages on the CPU: 3 Adam steps
(2e-3, as ``tests/test_pose.py``) with the port's net hybridized, under
``torch_zoo.hold_trajectory``'s rule: in float64 the losses and weights
equal the JAX package's to rtol 1e-6; in float32 the port's distance to
its float64 run is within the larger of 1e-4 and 4 times the JAX
package's own (both packages' third float32 loss is ~4e-4 from
float64's here); then PCK@0.15 of both nets on a fresh batch.  A file of
its own, so that the JAX package's two compilations of the step run
beside the other detector tests.
"""
import mxnet_tpu as jmx
from mxnet_tpu.models import pose as jpose
import mxnet_tpu_torch as mx
from mxnet_tpu_torch.models import pose

from test_torch_det_pose import K, _pair_tiny, _scene_batch
from torch_zoo import hold_trajectory, trajectories


def test_three_adam_steps_match_jax():
    batches = []
    for step in range(3):
        x, kp = _scene_batch(8, seed=step)
        batches.append((x, pose.gaussian_heatmaps(kp, 16), kp[:, :, 2]))
    jnet, tnet = _pair_tiny(batches[0][0])
    zoo = {"jax": jpose, "port": pose}
    runs = trajectories(
        lambda: pose.simple_pose_tiny(num_keypoints=K), jnet, tnet,
        batches[0][0], batches,
        lambda z, n, x, t, v: zoo[z].PoseHeatmapLoss()(n(x), t, v), 2e-3)
    hold_trajectory(runs)
    x, kp = _scene_batch(16, seed=777)
    pck = []
    for pkg, zoo, net in ((mx, pose, tnet), (jmx, jpose, jnet)):
        m = zoo.PCKMetric(threshold=0.15)
        m.update(kp, net.predict(pkg.nd.array(x, ctx=pkg.cpu())))
        pck.append(m.get()[1])
    assert 0.0 <= pck[0] <= 1.0
    assert abs(pck[0] - pck[1]) <= 1.0 / 32
