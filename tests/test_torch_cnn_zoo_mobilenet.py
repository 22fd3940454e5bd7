"""Gradients of the port's MobileNets against the JAX package's, on the
CPU, from the same weights (carried by name), at the float32 tolerances
of ``mxnet_tpu/test_utils.py`` (rtol 1e-4, atol 1e-5):

* MobileNet(0.25) at 64 x 64, batch 2: the gradient of sum(out * ramp)
  for every parameter in predict mode.  In training mode its 27
  BatchNorms normalise over as few as 8 values a channel (2 x 2 maps,
  batch 2), and the two packages' float32 gradients part by ~5e-4
  there; the training-mode BatchNorm of these nets is held at 224 x 224
  in ``test_torch_cnn_zoo_train.py``.
* MobileNetV2's LinearBottleneck (1x1 expansion, depthwise 3x3, linear
  projection; with the shortcut at stride 1, without at stride 2) in
  training mode (the whole MobileNetV2(0.25)'s forward is
  ``test_torch_cnn_zoo_forward.py``'s and ``test_torch_cnn_zoo_train.py``'s).
  relu6's gradient at exactly 0 and 6 is half, as the JAX package's
  ``jnp.clip`` gives it (ROADMAP F18).
* The hybridized port net (a ``CachedOp``; on the CPU the block runs as
  it is) against itself unhybridized.
"""
import numpy as np
import pytest

from mxnet_tpu.gluon import nn as jnn
from mxnet_tpu.gluon.model_zoo import vision as jvision
import mxnet_tpu_torch as mx
from mxnet_tpu_torch.gluon import nn
from mxnet_tpu_torch.gluon.model_zoo import vision

from torch_zoo import CPU, check_grads, close, pair


def test_predict_mode_gradients_match_jax():
    x = np.random.RandomState(64).rand(2, 3, 64, 64).astype("f4")
    jnet, tnet = pair(
        lambda: jvision.MobileNet(0.25, classes=10, prefix="net_"),
        lambda: vision.MobileNet(0.25, classes=10, prefix="net_"), x)
    check_grads(jnet, tnet, x, train=False)


@pytest.mark.parametrize("stride,in_c,c", [(1, 8, 8), (2, 8, 16)],
                         ids=["shortcut", "stride2"])
def test_linear_bottleneck_gradients_match_jax(stride, in_c, c):
    def build(zoo, layers):
        outer = layers.HybridSequential(prefix="blk_")
        with outer.name_scope():
            outer.add(zoo.LinearBottleneck(in_c, c, 6, stride))
        return outer
    x = np.random.RandomState(stride).randn(2, in_c, 8, 8).astype("f4")
    jnet, tnet = pair(lambda: build(jvision.mobilenet, jnn),
                      lambda: build(vision, nn), x)
    assert tnet[0].use_shortcut == (stride == 1)
    check_grads(jnet, tnet, x)


def test_relu6_passes_half_the_gradient_at_its_bounds():
    """F18: relu6's gradient at exactly 0 and 6 is 0.5, as the JAX
    package's (the port's was 1)."""
    import mxnet_tpu as jmx
    x = np.array([-1.0, 0.0, 3.0, 6.0, 7.0], "f4")
    grads = []
    for pkg in (jmx, mx):
        a = pkg.nd.array(x, ctx=pkg.cpu())
        a.attach_grad()
        with pkg.autograd.record():
            y = pkg.nd.Activation(a, act_type="relu6")
        y.backward()
        grads.append(a.grad.asnumpy())
    np.testing.assert_array_equal(grads[1], grads[0])
    np.testing.assert_array_equal(grads[1], [0.0, 0.5, 1.0, 0.5, 0.0])


def test_hybridized_net_matches_itself():
    """MobileNetV2(0.25): the hybridized net's predict-mode output, then
    its training-mode gradients, against the same net unhybridized."""
    x = mx.nd.array(np.random.RandomState(5).rand(2, 3, 64, 64)
                    .astype("f4"), ctx=CPU)
    net = vision.MobileNetV2(0.25, classes=10)
    net.initialize(mx.init.Xavier(), ctx=CPU, seed=5)

    def grads():
        with mx.autograd.record():
            loss = (net(x) ** 2).sum()
        loss.backward()
        return [p.grad().asnumpy() for p in net.collect_params().values()
                if p.grad_req != "null"]
    want = net(x).asnumpy()
    net.hybridize()
    close(net(x).asnumpy(), want, "hybridized predict")
    net.hybridize(False)
    want_g = grads()
    net.hybridize()
    for g, w in zip(grads(), want_g):
        close(g, w, "hybridized gradient")
