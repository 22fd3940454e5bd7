"""Inception v3's blocks in the port against the JAX package's, on the
CPU, from the same weights (carried by name): each of the A-E blocks
(``_make_A`` .. ``_make_D``, ``_InceptionE``, under their prefixes)
inside one outer block, batch 2, 16 input channels, at a small spatial
size (8 x 8; 9 x 9 for the stride-2 B and D).  The predict-mode output,
then the training-mode gradient of sum(out * ramp) for every parameter
and the running statistics that forward moved, at the float32
tolerances of ``mxnet_tpu/test_utils.py`` (rtol 1e-4, atol 1e-5).  The
whole net runs only at 299 x 299 (the JAX package's own test marks it
slow): here the port's at batch 1, its output's shape and finiteness,
and its parameter names are ``test_torch_cnn_zoo_names.py``'s."""
import numpy as np
import pytest

from mxnet_tpu.gluon import nn as jnn
from mxnet_tpu.gluon.model_zoo.vision import inception as jinception
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import nd
from mxnet_tpu_torch.gluon import nn
from mxnet_tpu_torch.gluon.model_zoo import vision
from mxnet_tpu_torch.gluon.model_zoo.vision import inception

from torch_zoo import CPU, check_forward, check_grads, pair

# (block, the function that makes it, spatial size, output channels)
BLOCKS = [
    ("A", lambda z: z._make_A(32, "A1_"), 8, 64 + 64 + 96 + 32),
    ("B", lambda z: z._make_B("B_"), 9, 384 + 96 + 16),
    ("C", lambda z: z._make_C(128, "C1_"), 8, 4 * 192),
    ("D", lambda z: z._make_D("D_"), 9, 320 + 192 + 16),
    ("E", lambda z: z._InceptionE(prefix="E1_"), 8, 320 + 768 + 768 + 192),
]


def _outer(layers, build, zoo):
    outer = layers.HybridSequential(prefix="net_")
    with outer.name_scope():
        outer.add(build(zoo))
    return outer


@pytest.mark.parametrize("build,size,channels", [b[1:] for b in BLOCKS],
                         ids=[b[0] for b in BLOCKS])
def test_block_matches_jax(build, size, channels):
    x = np.random.RandomState(size).randn(2, 16, size, size).astype("f4")
    jnet, tnet = pair(lambda: _outer(jnn, build, jinception),
                      lambda: _outer(nn, build, inception), x)
    out = tnet(nd.array(x, ctx=CPU))
    assert out.shape[1] == channels
    check_forward(jnet, tnet, x, train=False)
    check_grads(jnet, tnet, x)


def test_inception_v3_runs_at_299():
    net = vision.get_model("inceptionv3", classes=10)
    net.initialize(mx.init.Xavier(), ctx=CPU, seed=0)
    x = np.random.RandomState(0).rand(1, 3, 299, 299).astype("f4")
    out = net(nd.array(x, ctx=CPU)).asnumpy()
    assert out.shape == (1, 10) and np.isfinite(out).all()
