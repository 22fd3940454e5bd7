"""Gradients of the port's SqueezeNet and DenseNet against the JAX
package's, on the CPU, from the same weights (carried by name):
SqueezeNet 1.1 (the fire modules and ``ceil_mode`` pools 1.0 shares)
and DenseNet(8, 4, [2, 2]) (two dense blocks, one transition, the 7 x 7
average pool) at 64 x 64, batch 2, 10 classes, dropout off.  The
training-mode gradient of sum(out * ramp) for every parameter, then the
running statistics that forward moved, at the float32 tolerances of
``mxnet_tpu/test_utils.py`` (rtol 1e-4, atol 1e-5)."""
import numpy as np
import pytest

from mxnet_tpu.gluon.model_zoo import vision as jvision
from mxnet_tpu_torch.gluon.model_zoo import vision

from torch_zoo import check_grads, pair

CASES = {"squeezenet1.1": lambda z: z.SqueezeNet("1.1", classes=10,
                                                 prefix="net_"),
         "densenet": lambda z: z.DenseNet(8, 4, [2, 2], classes=10,
                                          prefix="net_")}


@pytest.mark.parametrize("case", list(CASES))
def test_gradients_match_jax(case):
    build = CASES[case]
    x = np.random.RandomState(64).rand(2, 3, 64, 64).astype("f4")
    jnet, tnet = pair(lambda: build(jvision), lambda: build(vision), x)
    check_grads(jnet, tnet, x)
