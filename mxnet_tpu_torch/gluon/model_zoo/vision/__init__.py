"""``gluon.model_zoo.vision``, as the JAX package's: ``get_model`` over the
ResNets (v1 and v2, 18 to 152 layers).  The other families (VGG,
AlexNet, DenseNet, SqueezeNet, Inception, MobileNet) are not ported yet
(ROADMAP), and ``pretrained=True`` raises: the repository holds no
weights and the port has no network access."""
from ....base import MXNetError
from .resnet import (BasicBlockV1, BasicBlockV2, BottleneckV1, BottleneckV2,
                     ResNetV1, ResNetV2, get_resnet, resnet18_v1,
                     resnet18_v2, resnet34_v1, resnet34_v2, resnet50_v1,
                     resnet50_v2, resnet101_v1, resnet101_v2, resnet152_v1,
                     resnet152_v2)

__all__ = ["get_model", "get_resnet", "ResNetV1", "ResNetV2",
           "BasicBlockV1", "BasicBlockV2", "BottleneckV1", "BottleneckV2",
           "resnet18_v1", "resnet34_v1", "resnet50_v1", "resnet101_v1",
           "resnet152_v1", "resnet18_v2", "resnet34_v2", "resnet50_v2",
           "resnet101_v2", "resnet152_v2"]

_models = {
    "resnet18_v1": resnet18_v1, "resnet34_v1": resnet34_v1,
    "resnet50_v1": resnet50_v1, "resnet101_v1": resnet101_v1,
    "resnet152_v1": resnet152_v1, "resnet18_v2": resnet18_v2,
    "resnet34_v2": resnet34_v2, "resnet50_v2": resnet50_v2,
    "resnet101_v2": resnet101_v2, "resnet152_v2": resnet152_v2,
}


def get_model(name, **kwargs):
    """The model ``name`` (parity: ``vision.get_model``), built with
    ``kwargs`` (``classes``, ``thumbnail``, ...)."""
    name = name.lower()
    if name not in _models:
        raise MXNetError(f"Model {name!r} is not supported. Available: "
                         f"{sorted(_models)}")
    return _models[name](**kwargs)
