"""The port's densenet121 against the JAX package's forward in predict
mode, on the CPU, from the same weights (carried by name): batch 2 at
224 x 224 (the final 7 x 7 average pool's input), 10 classes, at the
float32 tolerances of ``mxnet_tpu/test_utils.py`` (rtol 1e-4, atol
1e-5); and the place of DenseNet's dropout.  A narrow DenseNet's
gradients are ``test_torch_cnn_zoo_grads_b.py``'s."""
import numpy as np

from mxnet_tpu.gluon.model_zoo import vision as jvision
from mxnet_tpu_torch.gluon.model_zoo import vision

from torch_zoo import check_forward, pair


def test_densenet121_predict_matches_jax():
    x = np.random.RandomState(224).rand(2, 3, 224, 224).astype("f4")
    jnet, tnet = pair(
        lambda: jvision.get_model("densenet121", classes=10, prefix="net_"),
        lambda: vision.get_model("densenet121", classes=10, prefix="net_"),
        x)
    check_forward(jnet, tnet, x, train=False)


def test_densenet_dropout_keeps_its_place():
    """DenseNet(dropout=) puts a Dropout at the end of each dense layer,
    as the JAX package does: the same blocks in the same order."""
    def kinds(net):
        return [type(b).__name__ for b in net.features[4][0].body]
    jnet = jvision.DenseNet(8, 4, [2, 2], dropout=0.2, classes=10)
    tnet = vision.DenseNet(8, 4, [2, 2], dropout=0.2, classes=10)
    assert kinds(tnet) == [type(b).__name__ for b in
                           jnet.features._children["4"]._children["0"]
                           .body._children.values()]
    assert kinds(tnet)[-1] == "Dropout"
