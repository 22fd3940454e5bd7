"""The port's ``vision.get_model`` against the JAX package's: all 34
names build with the JAX net's parameter names, in its order, with its
shapes where they are known before the first call, and as many; an
unknown name or depth raises; ``pretrained=True`` loads
``<root>/<name>.params`` for one net of each family the ResNets' test
(``test_torch_resnet.py``) does not cover, from a file the JAX package
writes with ``save_parameters``, and gives the JAX net's outputs (float32
tolerances of ``mxnet_tpu/test_utils.py``)."""
import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu.gluon.model_zoo import vision as jvision
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import nd
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon.model_zoo import vision

from torch_zoo import CPU, close

NAMES = sorted(jvision._models)


def test_the_registry_holds_the_reference_names():
    assert len(NAMES) == 34
    assert sorted(vision._models) == NAMES


@pytest.mark.parametrize("name", [n for n in NAMES
                                  if not n.startswith("resnet")])
def test_get_model_builds_the_reference_structure(name):
    jnet = jvision.get_model(name, classes=10, prefix="net_")
    tnet = vision.get_model(name, classes=10, prefix="net_")
    jparams, tparams = jnet.collect_params(), tnet.collect_params()
    assert list(tparams.keys()) == list(jparams.keys())
    assert len(tparams) == len(jparams)
    for k, p in tparams.items():
        want = jparams[k].shape
        assert p.shape == tuple(0 if s is None else s for s in want), k
        assert p.grad_req == jparams[k].grad_req, k


def test_unknown_names_and_depths_raise():
    with pytest.raises(MXNetError, match="not supported"):
        vision.get_model("vgg12")
    with pytest.raises(MXNetError, match="depth"):
        vision.get_vgg(12)
    with pytest.raises(MXNetError, match="depth"):
        vision.get_densenet(100)
    with pytest.raises(MXNetError, match="version"):
        vision.get_squeezenet("1.2")


# (name, input size, keyword arguments) of one net a family; the
# ResNets' pretrained test is test_torch_resnet.py's
PRETRAINED = [("vgg11_bn", 32, {}), ("alexnet", 224, {}),
              ("squeezenet1.1", 224, {}), ("mobilenet0.25", 224, {}),
              ("mobilenetv2_0.25", 224, {})]


@pytest.mark.parametrize("name,size,kw", PRETRAINED,
                         ids=[p[0] for p in PRETRAINED])
def test_pretrained_loads_the_local_store(name, size, kw, tmp_path):
    jmx.random.seed(19)
    jnet = jvision.get_model(name, classes=10, **kw)
    jnet.initialize(jmx.init.Xavier())
    x = np.random.RandomState(19).rand(1, 3, size, size).astype("f4")
    want = jnet(jmx.nd.array(x)).asnumpy()
    jnet.save_parameters(str(tmp_path / f"{name}.params"))
    tnet = vision.get_model(name, pretrained=True, root=str(tmp_path),
                            ctx=CPU, classes=10, **kw)
    close(tnet(nd.array(x, ctx=CPU)).asnumpy(), want, name)
    with pytest.raises(MXNetError, match="not found"):
        vision.get_model(name, pretrained=True, root=str(tmp_path / "no"))


@pytest.mark.parametrize("name,size", [("densenet121", 224),
                                       ("inceptionv3", 299)])
def test_pretrained_round_trip_of_the_deepest_nets(name, size, tmp_path):
    """DenseNet and Inception v3 from a file the port writes (the JAX
    nets need a call at their full input size to make their parameters;
    the JAX package's own test marks Inception's slow, and the forward
    tests hold the port's DenseNet to the JAX one): the loaded net gives
    the saved net's outputs, and the file's names (attribute paths) are
    those the JAX net saves under."""
    x = np.random.RandomState(20).rand(1, 3, size, size).astype("f4")
    net = vision.get_model(name, classes=10)
    net.initialize(mx.init.Xavier(), ctx=CPU, seed=20)
    want = net(nd.array(x, ctx=CPU)).asnumpy()
    net.save_parameters(str(tmp_path / f"{name}.params"))
    loaded = vision.get_model(name, pretrained=True, root=str(tmp_path),
                              ctx=CPU, classes=10)
    close(loaded(nd.array(x, ctx=CPU)).asnumpy(), want, name)
    with mx.cpu():
        saved = mx.nd.load(str(tmp_path / f"{name}.params"))
    jnet = jvision.get_model(name, classes=10)
    assert sorted(saved) == sorted(jnet._collect_params_with_prefix())
