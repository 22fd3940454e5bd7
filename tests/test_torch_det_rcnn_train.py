"""faster_rcnn_tiny trained in both packages on the CPU:
FasterRCNNLoss and 3 Adam steps (1e-3, as ``tests/test_rcnn.py``) with
the port's net hybridized (its captured call holds ``topk`` and
``ROIAlign``), under ``torch_zoo.hold_trajectory``'s rule: in float64
the losses and weights equal the JAX package's to rtol 1e-6; in float32
the port's distance to its float64 run is within the larger of 1e-4 and
4 times the JAX package's own.  (After one float32 forward the JAX
package is 5.7e-5 from float64 on the RPN's objectness and 3.4e-4 on the
head's deltas, the port 2.7e-6; after three steps its BatchNorm offsets
are up to 5e-3 away.)  The proposal set is the same in every run: the
16th and 17th objectness logits stay more than 1e-4 apart in every step.
A file of its own, so that the JAX package's two compilations of the
step run beside the other detector tests.
"""
import numpy as np

from mxnet_tpu.models import rcnn as jrcnn
from mxnet_tpu_torch import nd
from mxnet_tpu_torch.models import rcnn

from test_torch_det_rcnn import _batch, _pair
from torch_zoo import CPU, hold_trajectory, trajectories


def test_three_hybridized_adam_steps_match_jax():
    rng = np.random.RandomState(0)
    batches = [_batch(rng, 4) for _ in range(3)]
    jnet, tnet = _pair(batches[0][0])
    gaps = []

    def loss_of(zoo, net, x, y):
        outs = net(x)
        loss = {"jax": jrcnn, "port": rcnn}[zoo].FasterRCNNLoss(net)(outs, y)
        return loss, outs[0]

    def observe(scores):
        top = np.sort(scores, axis=-1)[:, ::-1]
        gaps.append(float((top[:, 15] - top[:, 16]).min()))
    runs = trajectories(
        lambda: rcnn.faster_rcnn_tiny(num_classes=2, prefix="rcnn_"), jnet,
        tnet, batches[0][0], batches, loss_of, 1e-3, observe=observe)
    assert min(gaps) > 1e-4, gaps
    hold_trajectory(runs)
    det = tnet.decode(tnet(nd.array(batches[0][0], ctx=CPU))).asnumpy()
    assert det.shape == (4, 16, 6)
    kept = det[..., 0] >= 0
    assert (det[~kept] == -1).all()
