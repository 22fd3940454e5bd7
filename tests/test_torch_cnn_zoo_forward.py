"""The port's vision nets against the JAX package's forward in predict
mode, on the CPU, from the same weights (carried by name): one net of
each family, batch 2, at the smallest input it admits (32 x 32 for VGG,
224 x 224 for the others), 10 classes, at the float32 tolerances of
``mxnet_tpu/test_utils.py`` (rtol 1e-4, atol 1e-5).  densenet121's is
``test_torch_cnn_zoo_densenet.py``'s, the MobileNets' training-mode
forward ``test_torch_cnn_zoo_train.py``'s, Inception v3's blocks
``test_torch_cnn_zoo_inception.py``'s."""
import numpy as np
import pytest

from mxnet_tpu.gluon.model_zoo import vision as jvision
from mxnet_tpu_torch.gluon.model_zoo import vision

from torch_zoo import check_forward, pair

CASES = [("vgg11", 32), ("vgg11_bn", 32), ("alexnet", 224),
         ("squeezenet1.0", 224), ("squeezenet1.1", 224),
         ("mobilenet0.25", 224), ("mobilenetv2_0.25", 224)]


@pytest.mark.parametrize("name,size", CASES, ids=[c[0] for c in CASES])
def test_predict_matches_jax(name, size):
    x = np.random.RandomState(size).rand(2, 3, size, size).astype("f4")
    jnet, tnet = pair(
        lambda: jvision.get_model(name, classes=10, prefix="net_"),
        lambda: vision.get_model(name, classes=10, prefix="net_"), x)
    check_forward(jnet, tnet, x, train=False)
