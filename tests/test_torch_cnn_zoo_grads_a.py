"""Gradients of the port's VGG and AlexNet against the JAX package's, on
the CPU, from the same weights (carried by name): VGG([1, 1], [8, 16])
with and without BatchNorm at 32 x 32 and AlexNet at 64 x 64 (the
smallest input its three pools admit), batch 2, 10 classes, dropout off.
The training-mode gradient of sum(out * ramp) for every parameter, then
the running statistics that forward moved, at the float32 tolerances of
``mxnet_tpu/test_utils.py`` (rtol 1e-4, atol 1e-5)."""
import numpy as np
import pytest

from mxnet_tpu.gluon.model_zoo import vision as jvision
from mxnet_tpu_torch.gluon.model_zoo import vision

from torch_zoo import check_grads, pair

CASES = {"vgg": (lambda z: z.VGG([1, 1], [8, 16], classes=10,
                                  prefix="net_"), 32),
         "vgg_bn": (lambda z: z.VGG([1, 1], [8, 16], classes=10,
                                     batch_norm=True, prefix="net_"), 32),
         "alexnet": (lambda z: z.AlexNet(classes=10, prefix="net_"), 64)}


@pytest.mark.parametrize("case", list(CASES))
def test_gradients_match_jax(case):
    build, size = CASES[case]
    x = np.random.RandomState(size).rand(2, 3, size, size).astype("f4")
    jnet, tnet = pair(lambda: build(jvision), lambda: build(vision), x)
    check_grads(jnet, tnet, x)
