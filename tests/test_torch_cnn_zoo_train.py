"""The port's MobileNets against the JAX package's in training mode, on
the CPU, from the same weights (carried by name): a training-mode
forward of mobilenet0.25 and mobilenetv2_0.25 at 224 x 224 (their
BatchNorms over enough values a channel for float32 to hold the
tolerance), batch 2, 10 classes, then every running statistic it
moved, at the float32 tolerances of ``mxnet_tpu/test_utils.py`` (rtol
1e-4, atol 1e-5).  VGG's and DenseNet's training forward is held with
their gradients on narrow instances (``test_torch_cnn_zoo_grads_a.py``,
``test_torch_cnn_zoo_grads_b.py``)."""
import numpy as np
import pytest

from mxnet_tpu.gluon.model_zoo import vision as jvision
from mxnet_tpu_torch.gluon.model_zoo import vision

from torch_zoo import check_forward, pair

CASES = [("mobilenet0.25", 224), ("mobilenetv2_0.25", 224)]


@pytest.mark.parametrize("name,size", CASES, ids=[c[0] for c in CASES])
def test_training_forward_matches_jax(name, size):
    x = np.random.RandomState(size).rand(2, 3, size, size).astype("f4")
    jnet, tnet = pair(
        lambda: jvision.get_model(name, classes=10, prefix="net_"),
        lambda: vision.get_model(name, classes=10, prefix="net_"), x)
    check_forward(jnet, tnet, x)
