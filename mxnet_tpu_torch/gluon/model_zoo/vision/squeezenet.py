"""SqueezeNet 1.0 and 1.1, as the JAX package's
``gluon/model_zoo/vision/squeezenet.py``: fire modules (a 1x1 squeeze,
then 1x1 and 3x3 expands concatenated), max pools with ``ceil_mode``,
a 1x1 convolution head; the same parameter names, input sizes deferred
to the first call."""
from __future__ import annotations

from ....base import MXNetError
from ...block import HybridBlock
from ... import nn

__all__ = ["SqueezeNet", "squeezenet1_0", "squeezenet1_1",
           "get_squeezenet"]


def _make_fire_conv(channels, kernel_size, padding=0):
    out = nn.HybridSequential(prefix="")
    out.add(nn.Conv2D(channels, kernel_size, padding=padding))
    out.add(nn.Activation("relu"))
    return out


def _make_fire(squeeze_channels, expand1x1_channels, expand3x3_channels):
    out = nn.HybridSequential(prefix="")
    out.add(_make_fire_conv(squeeze_channels, 1))
    paths = nn.HybridConcatenate(axis=1)
    paths.add(_make_fire_conv(expand1x1_channels, 1))
    paths.add(_make_fire_conv(expand3x3_channels, 3, 1))
    out.add(paths)
    return out


# (stem channels, stem kernel, then "pool" or a fire module's widths)
_SPEC = {
    "1.0": (96, 7, [(16, 64, 64), (16, 64, 64), (32, 128, 128), "pool",
                    (32, 128, 128), (48, 192, 192), (48, 192, 192),
                    (64, 256, 256), "pool", (64, 256, 256)]),
    "1.1": (64, 3, [(16, 64, 64), (16, 64, 64), "pool", (32, 128, 128),
                    (32, 128, 128), "pool", (48, 192, 192), (48, 192, 192),
                    (64, 256, 256), (64, 256, 256)]),
}


class SqueezeNet(HybridBlock):
    """A strided stem convolution, ReLU, 3x3/2 max pool (``ceil_mode``),
    the version's fire modules and pools, Dropout(0.5); the head is a
    1x1 convolution to ``classes``, ReLU, global average pool,
    Flatten."""

    def __init__(self, version, classes=1000, **kwargs):
        super().__init__(**kwargs)
        if version not in _SPEC:
            raise MXNetError(f"unsupported SqueezeNet version {version}")
        stem, kernel, body = _SPEC[version]
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            self.features.add(nn.Conv2D(stem, kernel_size=kernel,
                                        strides=2))
            self.features.add(nn.Activation("relu"))
            self.features.add(nn.MaxPool2D(3, 2, ceil_mode=True))
            for item in body:
                self.features.add(nn.MaxPool2D(3, 2, ceil_mode=True)
                                  if item == "pool" else _make_fire(*item))
            self.features.add(nn.Dropout(0.5))

            self.output = nn.HybridSequential(prefix="")
            self.output.add(nn.Conv2D(classes, kernel_size=1))
            self.output.add(nn.Activation("relu"))
            self.output.add(nn.GlobalAvgPool2D())
            self.output.add(nn.Flatten())

    def forward(self, x):
        return self.output(self.features(x))


def get_squeezenet(version, pretrained=False, ctx=None, root=None,
                   **kwargs):
    """SqueezeNet ``version`` ("1.0" or "1.1"); ``pretrained=True``
    loads ``<root>/squeezenet<version>.params`` (``model_store``) on
    ``ctx``."""
    net = SqueezeNet(version, **kwargs)
    if pretrained:
        from ..model_store import load_pretrained
        load_pretrained(net, f"squeezenet{version}", root=root, ctx=ctx)
    return net


def squeezenet1_0(**kwargs):
    return get_squeezenet("1.0", **kwargs)


def squeezenet1_1(**kwargs):
    return get_squeezenet("1.1", **kwargs)
