"""yolo3_tiny trained in both packages on the CPU: the forward,
YOLOv3Loss and 3 Adam steps (2e-3, as ``tests/test_yolo.py``) from the
JAX model's weights, carried by name, the port's net hybridized, under
``torch_zoo.hold_trajectory``'s rule: in float64 the losses and weights
equal the JAX package's to rtol 1e-6; in float32 the port's distance to
its float64 run is within the larger of 1e-4 and 4 times the JAX
package's own.  Then both trained nets' detections.  A file of its own,
so that the JAX package's two compilations of the step run beside the
other detector tests.
"""
import numpy as np

import mxnet_tpu as jmx
from mxnet_tpu.models import yolo as jyolo
from mxnet_tpu_torch import nd
from mxnet_tpu_torch.models import yolo

from test_torch_det_yolo import _batch
from torch_zoo import CPU, close, hold_trajectory, pair, trajectories


def test_three_adam_steps_match_jax():
    rng = np.random.RandomState(0)
    batches = [_batch(rng, 8, rows=2) for _ in range(3)]
    jnet, tnet = pair(lambda: jyolo.yolo3_tiny(num_classes=2,
                                               prefix="yolo_"),
                      lambda: yolo.yolo3_tiny(num_classes=2,
                                              prefix="yolo_"),
                      batches[0][0])
    close(tnet(nd.array(batches[0][0], ctx=CPU)).asnumpy(),
          jnet(jmx.nd.array(batches[0][0])).asnumpy(), "forward")
    zoo = {"jax": jyolo, "port": yolo}
    runs = trajectories(
        lambda: yolo.yolo3_tiny(num_classes=2, prefix="yolo_"), jnet, tnet,
        batches[0][0], batches,
        lambda z, n, x, y: zoo[z].YOLOv3Loss(n)(n(x), y), 2e-3,
        prepare=lambda n: n._layout_nd(jmx.cpu()))
    hold_trajectory(runs)
    # the trained nets' detections on the last batch
    x = batches[-1][0]
    jdet = jnet.decode(jnet(jmx.nd.array(x))).asnumpy()
    tdet = tnet.decode(tnet(nd.array(x, ctx=CPU))).asnumpy()
    assert tdet.shape == jdet.shape == (8, tnet.num_slots, 6)
    kept = tdet[..., 0] >= 0
    assert kept.any() and (tdet[~kept] == -1).all()
