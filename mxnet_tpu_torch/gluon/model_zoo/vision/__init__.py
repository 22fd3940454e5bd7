"""``gluon.model_zoo.vision``, as the JAX package's: ``get_model`` over
its 34 names, the ResNets (v1 and v2, 18 to 152 layers), VGG (11 to 19,
with and without BatchNorm), AlexNet, DenseNet (121 to 201), SqueezeNet
(1.0, 1.1), Inception v3 and MobileNet v1 and v2 at four widths each.
``pretrained=True`` loads ``<root>/<name>.params`` from the local store
(``model_zoo.model_store``); nothing is downloaded."""
from ....base import MXNetError
from .alexnet import AlexNet, alexnet
from .densenet import (DenseNet, densenet121, densenet161, densenet169,
                       densenet201, get_densenet)
from .inception import Inception3, inception_v3
from .mobilenet import (LinearBottleneck, MobileNet, MobileNetV2,
                        get_mobilenet, get_mobilenet_v2, mobilenet0_5,
                        mobilenet0_25, mobilenet0_75, mobilenet1_0,
                        mobilenet_v2_0_5, mobilenet_v2_0_25,
                        mobilenet_v2_0_75, mobilenet_v2_1_0)
from .resnet import (BasicBlockV1, BasicBlockV2, BottleneckV1, BottleneckV2,
                     ResNetV1, ResNetV2, get_resnet, resnet18_v1,
                     resnet18_v2, resnet34_v1, resnet34_v2, resnet50_v1,
                     resnet50_v2, resnet101_v1, resnet101_v2, resnet152_v1,
                     resnet152_v2)
from .squeezenet import SqueezeNet, get_squeezenet, squeezenet1_0, \
    squeezenet1_1
from .vgg import (VGG, get_vgg, vgg11, vgg11_bn, vgg13, vgg13_bn, vgg16,
                  vgg16_bn, vgg19, vgg19_bn)

__all__ = ["get_model", "get_resnet", "ResNetV1", "ResNetV2",
           "BasicBlockV1", "BasicBlockV2", "BottleneckV1", "BottleneckV2",
           "resnet18_v1", "resnet34_v1", "resnet50_v1", "resnet101_v1",
           "resnet152_v1", "resnet18_v2", "resnet34_v2", "resnet50_v2",
           "resnet101_v2", "resnet152_v2",
           "VGG", "get_vgg", "vgg11", "vgg13", "vgg16", "vgg19", "vgg11_bn",
           "vgg13_bn", "vgg16_bn", "vgg19_bn",
           "AlexNet", "alexnet",
           "DenseNet", "get_densenet", "densenet121", "densenet161",
           "densenet169", "densenet201",
           "SqueezeNet", "get_squeezenet", "squeezenet1_0", "squeezenet1_1",
           "Inception3", "inception_v3",
           "MobileNet", "MobileNetV2", "LinearBottleneck", "get_mobilenet",
           "get_mobilenet_v2", "mobilenet1_0", "mobilenet0_75",
           "mobilenet0_5", "mobilenet0_25", "mobilenet_v2_1_0",
           "mobilenet_v2_0_75", "mobilenet_v2_0_5", "mobilenet_v2_0_25"]

_models = {
    "resnet18_v1": resnet18_v1, "resnet34_v1": resnet34_v1,
    "resnet50_v1": resnet50_v1, "resnet101_v1": resnet101_v1,
    "resnet152_v1": resnet152_v1, "resnet18_v2": resnet18_v2,
    "resnet34_v2": resnet34_v2, "resnet50_v2": resnet50_v2,
    "resnet101_v2": resnet101_v2, "resnet152_v2": resnet152_v2,
    "vgg11": vgg11, "vgg13": vgg13, "vgg16": vgg16, "vgg19": vgg19,
    "vgg11_bn": vgg11_bn, "vgg13_bn": vgg13_bn, "vgg16_bn": vgg16_bn,
    "vgg19_bn": vgg19_bn,
    "alexnet": alexnet,
    "densenet121": densenet121, "densenet161": densenet161,
    "densenet169": densenet169, "densenet201": densenet201,
    "squeezenet1.0": squeezenet1_0, "squeezenet1.1": squeezenet1_1,
    "inceptionv3": inception_v3,
    "mobilenet1.0": mobilenet1_0, "mobilenet0.75": mobilenet0_75,
    "mobilenet0.5": mobilenet0_5, "mobilenet0.25": mobilenet0_25,
    "mobilenetv2_1.0": mobilenet_v2_1_0,
    "mobilenetv2_0.75": mobilenet_v2_0_75,
    "mobilenetv2_0.5": mobilenet_v2_0_5,
    "mobilenetv2_0.25": mobilenet_v2_0_25,
}


def get_model(name, **kwargs):
    """The model ``name`` (parity: ``vision.get_model``), built with
    ``kwargs`` (``classes``, ``pretrained``, ``root``, ``ctx``, ...)."""
    name = name.lower()
    if name not in _models:
        raise MXNetError(f"Model {name!r} is not supported. Available: "
                         f"{sorted(_models)}")
    return _models[name](**kwargs)
