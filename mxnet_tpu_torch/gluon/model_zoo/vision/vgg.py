"""VGG 11, 13, 16 and 19, with and without BatchNorm, as the JAX
package's ``gluon/model_zoo/vision/vgg.py``: the same layers under the
same parameter names.  Every convolution and Dense leaves its input size
to the first call, as the reference does."""
from __future__ import annotations

from ....base import MXNetError
from ...block import HybridBlock
from ... import nn

__all__ = ["VGG", "vgg11", "vgg13", "vgg16", "vgg19", "vgg11_bn",
           "vgg13_bn", "vgg16_bn", "vgg19_bn", "get_vgg"]


class VGG(HybridBlock):
    """``layers[i]`` 3x3 convolutions of ``filters[i]`` channels (each
    with BN when ``batch_norm``) and ReLU, then a 2x2 max pool, a stage
    each; two Dense(4096)-ReLU-Dropout(0.5); Dense to ``classes``."""

    def __init__(self, layers, filters, classes=1000, batch_norm=False,
                 **kwargs):
        super().__init__(**kwargs)
        if len(layers) != len(filters):
            raise MXNetError(f"{len(layers)} stages need {len(layers)} "
                             f"filter counts, got {len(filters)}")
        with self.name_scope():
            self.features = self._make_features(layers, filters,
                                                batch_norm)
            for _ in range(2):
                self.features.add(nn.Dense(4096, activation="relu",
                                           weight_initializer="normal",
                                           bias_initializer="zeros"))
                self.features.add(nn.Dropout(rate=0.5))
            self.output = nn.Dense(classes, weight_initializer="normal",
                                   bias_initializer="zeros")

    @staticmethod
    def _make_features(layers, filters, batch_norm):
        featurizer = nn.HybridSequential(prefix="")
        for i, num in enumerate(layers):
            for _ in range(num):
                featurizer.add(nn.Conv2D(filters[i], kernel_size=3,
                                         padding=1))
                if batch_norm:
                    featurizer.add(nn.BatchNorm())
                featurizer.add(nn.Activation("relu"))
            featurizer.add(nn.MaxPool2D(strides=2))
        return featurizer

    def forward(self, x):
        return self.output(self.features(x))


vgg_spec = {11: ([1, 1, 2, 2, 2], [64, 128, 256, 512, 512]),
            13: ([2, 2, 2, 2, 2], [64, 128, 256, 512, 512]),
            16: ([2, 2, 3, 3, 3], [64, 128, 256, 512, 512]),
            19: ([2, 2, 4, 4, 4], [64, 128, 256, 512, 512])}


def get_vgg(num_layers, pretrained=False, ctx=None, root=None, **kwargs):
    """VGG of ``num_layers`` layers; ``kwargs`` go to the net
    (``classes``, ``batch_norm``).  ``pretrained=True`` loads
    ``<root>/vgg<N>[_bn].params`` (``model_store``) on ``ctx``."""
    if num_layers not in vgg_spec:
        raise MXNetError(f"invalid vgg depth {num_layers}; options are "
                         f"{sorted(vgg_spec)}")
    layers, filters = vgg_spec[num_layers]
    net = VGG(layers, filters, **kwargs)
    if pretrained:
        from ..model_store import load_pretrained
        bn = "_bn" if kwargs.get("batch_norm") else ""
        load_pretrained(net, f"vgg{num_layers}{bn}", root=root, ctx=ctx)
    return net


def vgg11(**kwargs):
    return get_vgg(11, **kwargs)


def vgg13(**kwargs):
    return get_vgg(13, **kwargs)


def vgg16(**kwargs):
    return get_vgg(16, **kwargs)


def vgg19(**kwargs):
    return get_vgg(19, **kwargs)


def vgg11_bn(**kwargs):
    return get_vgg(11, batch_norm=True, **kwargs)


def vgg13_bn(**kwargs):
    return get_vgg(13, batch_norm=True, **kwargs)


def vgg16_bn(**kwargs):
    return get_vgg(16, batch_norm=True, **kwargs)


def vgg19_bn(**kwargs):
    return get_vgg(19, batch_norm=True, **kwargs)
