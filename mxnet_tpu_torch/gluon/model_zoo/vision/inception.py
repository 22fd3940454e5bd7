"""Inception v3, as the JAX package's
``gluon/model_zoo/vision/inception.py``: the stem, the A-E blocks under
their prefixes (``A1_`` .. ``E2_``), an 8x8 average pool, Dropout and a
Dense head at 299 x 299; the same parameter names, input sizes deferred
to the first call."""
from __future__ import annotations

import torch

from ...block import HybridBlock
from ... import nn

__all__ = ["Inception3", "inception_v3"]


def _make_basic_conv(**kwargs):
    out = nn.HybridSequential(prefix="")
    out.add(nn.Conv2D(use_bias=False, **kwargs))
    out.add(nn.BatchNorm(epsilon=0.001))
    out.add(nn.Activation("relu"))
    return out


def _make_branch(use_pool, *conv_settings):
    """An optional pool ("avg": 3x3/1 padded, "max": 3x3/2) and basic
    convolutions of (channels, kernel, stride, padding) each, a None
    stride or padding left at the layer's default."""
    out = nn.HybridSequential(prefix="")
    if use_pool == "avg":
        out.add(nn.AvgPool2D(pool_size=3, strides=1, padding=1))
    elif use_pool == "max":
        out.add(nn.MaxPool2D(pool_size=3, strides=2))
    for channels, kernel, stride, padding in conv_settings:
        kwargs = {"channels": channels, "kernel_size": kernel}
        if stride is not None:
            kwargs["strides"] = stride
        if padding is not None:
            kwargs["padding"] = padding
        out.add(_make_basic_conv(**kwargs))
    return out


def _make_A(pool_features, prefix):
    out = nn.HybridConcatenate(axis=1, prefix=prefix)
    with out.name_scope():
        out.add(_make_branch(None, (64, 1, None, None)))
        out.add(_make_branch(None, (48, 1, None, None),
                             (64, 5, None, 2)))
        out.add(_make_branch(None, (64, 1, None, None),
                             (96, 3, None, 1), (96, 3, None, 1)))
        out.add(_make_branch("avg", (pool_features, 1, None, None)))
    return out


def _make_B(prefix):
    out = nn.HybridConcatenate(axis=1, prefix=prefix)
    with out.name_scope():
        out.add(_make_branch(None, (384, 3, 2, None)))
        out.add(_make_branch(None, (64, 1, None, None),
                             (96, 3, None, 1), (96, 3, 2, None)))
        out.add(_make_branch("max"))
    return out


def _make_C(channels_7x7, prefix):
    out = nn.HybridConcatenate(axis=1, prefix=prefix)
    with out.name_scope():
        out.add(_make_branch(None, (192, 1, None, None)))
        out.add(_make_branch(None, (channels_7x7, 1, None, None),
                             (channels_7x7, (1, 7), None, (0, 3)),
                             (192, (7, 1), None, (3, 0))))
        out.add(_make_branch(None, (channels_7x7, 1, None, None),
                             (channels_7x7, (7, 1), None, (3, 0)),
                             (channels_7x7, (1, 7), None, (0, 3)),
                             (channels_7x7, (7, 1), None, (3, 0)),
                             (192, (1, 7), None, (0, 3))))
        out.add(_make_branch("avg", (192, 1, None, None)))
    return out


def _make_D(prefix):
    out = nn.HybridConcatenate(axis=1, prefix=prefix)
    with out.name_scope():
        out.add(_make_branch(None, (192, 1, None, None),
                             (320, 3, 2, None)))
        out.add(_make_branch(None, (192, 1, None, None),
                             (192, (1, 7), None, (0, 3)),
                             (192, (7, 1), None, (3, 0)),
                             (192, 3, 2, None)))
        out.add(_make_branch("max"))
    return out


class _InceptionE(HybridBlock):
    """The E block: two of its branches fan out into concatenated 1x3
    and 3x1 pairs."""

    def __init__(self, prefix=None, **kwargs):
        super().__init__(prefix=prefix, **kwargs)
        with self.name_scope():
            self.branch1 = _make_branch(None, (320, 1, None, None))
            self.branch2_stem = _make_basic_conv(channels=384,
                                                 kernel_size=1)
            self.branch2_a = _make_basic_conv(channels=384,
                                              kernel_size=(1, 3),
                                              padding=(0, 1))
            self.branch2_b = _make_basic_conv(channels=384,
                                              kernel_size=(3, 1),
                                              padding=(1, 0))
            self.branch3_stem = nn.HybridSequential(prefix="")
            self.branch3_stem.add(_make_basic_conv(channels=448,
                                                   kernel_size=1))
            self.branch3_stem.add(_make_basic_conv(channels=384,
                                                   kernel_size=3,
                                                   padding=1))
            self.branch3_a = _make_basic_conv(channels=384,
                                              kernel_size=(1, 3),
                                              padding=(0, 1))
            self.branch3_b = _make_basic_conv(channels=384,
                                              kernel_size=(3, 1),
                                              padding=(1, 0))
            self.branch_pool = _make_branch("avg", (192, 1, None, None))

    def forward(self, x):
        b2 = self.branch2_stem(x)
        b3 = self.branch3_stem(x)
        return torch.cat([self.branch1(x), self.branch2_a(b2),
                          self.branch2_b(b2), self.branch3_a(b3),
                          self.branch3_b(b3), self.branch_pool(x)], dim=1)


class Inception3(HybridBlock):
    """The stem (five basic convolutions, two 3x3/2 max pools), A1-A3,
    B, C1-C4, D, E1-E2, an 8x8 average pool, Dropout(0.5), Dense to
    ``classes``; 299 x 299 inputs."""

    def __init__(self, classes=1000, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            self.features.add(_make_basic_conv(channels=32, kernel_size=3,
                                               strides=2))
            self.features.add(_make_basic_conv(channels=32,
                                               kernel_size=3))
            self.features.add(_make_basic_conv(channels=64, kernel_size=3,
                                               padding=1))
            self.features.add(nn.MaxPool2D(pool_size=3, strides=2))
            self.features.add(_make_basic_conv(channels=80,
                                               kernel_size=1))
            self.features.add(_make_basic_conv(channels=192,
                                               kernel_size=3))
            self.features.add(nn.MaxPool2D(pool_size=3, strides=2))
            self.features.add(_make_A(32, "A1_"))
            self.features.add(_make_A(64, "A2_"))
            self.features.add(_make_A(64, "A3_"))
            self.features.add(_make_B("B_"))
            self.features.add(_make_C(128, "C1_"))
            self.features.add(_make_C(160, "C2_"))
            self.features.add(_make_C(160, "C3_"))
            self.features.add(_make_C(192, "C4_"))
            self.features.add(_make_D("D_"))
            self.features.add(_InceptionE(prefix="E1_"))
            self.features.add(_InceptionE(prefix="E2_"))
            self.features.add(nn.AvgPool2D(pool_size=8))
            self.features.add(nn.Dropout(0.5))
            self.output = nn.Dense(classes)

    def forward(self, x):
        return self.output(self.features(x))


def inception_v3(pretrained=False, ctx=None, root=None, **kwargs):
    """Inception v3; ``pretrained=True`` loads
    ``<root>/inceptionv3.params`` (``model_store``) on ``ctx``."""
    net = Inception3(**kwargs)
    if pretrained:
        from ..model_store import load_pretrained
        load_pretrained(net, "inceptionv3", root=root, ctx=ctx)
    return net
