"""Backbone feature truncation shared by the dense-prediction heads
(segmentation): strip a zoo classification net's ``features`` down to
its convolutional stages, as the JAX package's ``models/feature.py``."""
from __future__ import annotations

from ..base import MXNetError

_HEAD_LAYERS = ("GlobalAvgPool2D", "Flatten", "Dropout", "Dense")


def truncate_features(zoo_net, reject_dense=True):
    """Return the conv-stage blocks of ``zoo_net.features``.

    Trailing classifier layers (global pool / flatten / dropout, and
    Dense when ``reject_dense`` is False) are stripped.  With
    ``reject_dense`` True, a Dense inside the remaining features
    (vgg/alexnet-style) raises: those backbones flatten mid-stream and
    cannot provide spatial taps."""
    blocks = list(zoo_net.features._child_blocks())
    strip = _HEAD_LAYERS if not reject_dense else _HEAD_LAYERS[:-1]
    while blocks and blocks[-1].__class__.__name__ in strip:
        blocks = blocks[:-1]
    if len(blocks) < 3:
        raise MXNetError("backbone too shallow for dense prediction")
    if reject_dense and any(
            b.__class__.__name__ == "Dense" for b in blocks):
        raise MXNetError(
            "backbone features contain Dense layers (vgg/alexnet "
            "style); dense-prediction taps need a fully-convolutional "
            "backbone such as the resnet/mobilenet/densenet zoos")
    return blocks
