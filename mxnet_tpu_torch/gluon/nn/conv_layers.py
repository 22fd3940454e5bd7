"""Convolution and pooling layers, as the JAX package's
``gluon/nn/conv_layers.py``: ``Conv1D``/``Conv2D``/``Conv3D``,
``MaxPool2D``, ``AvgPool2D`` and ``GlobalAvgPool2D``, NCW/NCHW/NCDHW.

A convolution's weight is (channels, in_channels / groups, *kernel), as
the reference lays it out, so a by-name copy moves it over unchanged;
``in_channels=0`` defers that size to the first call.  The transposed
convolutions are not ported (ROADMAP).
"""
from __future__ import annotations

from ...initializer import param
from ...ops import nn as ops
from ..block import HybridBlock
from .activations import Activation

__all__ = ["Conv1D", "Conv2D", "Conv3D", "MaxPool2D", "AvgPool2D",
           "GlobalAvgPool2D"]


def _tuple(value, n):
    return (int(value),) * n if isinstance(value, int) else \
        tuple(int(v) for v in value)


class _Conv(HybridBlock):
    """``act(Convolution(x, weight, bias))`` over ``len(kernel_size)``
    spatial axes."""

    def __init__(self, channels, kernel_size, strides, padding, dilation,
                 groups, in_channels=0, activation=None, use_bias=True,
                 weight_initializer=None, bias_initializer="zeros",
                 prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._channels = channels
        self._groups = groups
        self._kernel = kernel_size
        self._conv = {"stride": strides, "pad": padding,
                      "dilate": dilation, "num_group": groups}
        self.weight = param(channels, in_channels // groups, *kernel_size,
                            init=weight_initializer)
        self.bias = param(channels, init=bias_initializer) if use_bias \
            else None
        if activation is not None:
            with self.name_scope():
                self.act = Activation(activation, prefix=activation + "_")
        else:
            self.act = None

    def infer_shape(self, x):
        self._gluon_param("weight").shape = (
            self._channels, x.shape[1] // self._groups) + self._kernel

    def forward(self, x):
        out = ops.convolution(x, self.weight, self.bias, **self._conv)
        return out if self.act is None else self.act(out)


class Conv1D(_Conv):
    def __init__(self, channels, kernel_size, strides=1, padding=0,
                 dilation=1, groups=1, layout="NCW", activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, prefix=None,
                 params=None):
        assert layout == "NCW", "Only NCW layout is supported"
        super().__init__(channels, _tuple(kernel_size, 1),
                         _tuple(strides, 1), _tuple(padding, 1),
                         _tuple(dilation, 1), groups, in_channels,
                         activation, use_bias, weight_initializer,
                         bias_initializer, prefix=prefix, params=params)


class Conv2D(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1),
                 padding=(0, 0), dilation=(1, 1), groups=1, layout="NCHW",
                 activation=None, use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, prefix=None,
                 params=None):
        assert layout == "NCHW", "Only NCHW layout is supported"
        super().__init__(channels, _tuple(kernel_size, 2),
                         _tuple(strides, 2), _tuple(padding, 2),
                         _tuple(dilation, 2), groups, in_channels,
                         activation, use_bias, weight_initializer,
                         bias_initializer, prefix=prefix, params=params)


class Conv3D(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1, 1),
                 padding=(0, 0, 0), dilation=(1, 1, 1), groups=1,
                 layout="NCDHW", activation=None, use_bias=True,
                 weight_initializer=None, bias_initializer="zeros",
                 in_channels=0, prefix=None, params=None):
        assert layout == "NCDHW", "Only NCDHW layout is supported"
        super().__init__(channels, _tuple(kernel_size, 3),
                         _tuple(strides, 3), _tuple(padding, 3),
                         _tuple(dilation, 3), groups, in_channels,
                         activation, use_bias, weight_initializer,
                         bias_initializer, prefix=prefix, params=params)


class _Pooling(HybridBlock):
    """``Pooling`` with the reference's arguments; ``ceil_mode`` is the
    "full" convention."""

    def __init__(self, pool_size, strides, padding, ceil_mode, global_pool,
                 pool_type, count_include_pad=True, prefix=None,
                 params=None):
        super().__init__(prefix=prefix, params=params)
        self._kwargs = {
            "kernel": pool_size,
            "stride": pool_size if strides is None else strides,
            "pad": padding, "global_pool": global_pool,
            "pool_type": pool_type, "count_include_pad": count_include_pad,
            "pooling_convention": "full" if ceil_mode else "valid"}

    def _alias(self):
        return "pool"

    def forward(self, x):
        return ops.pooling(x, **self._kwargs)


class MaxPool2D(_Pooling):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout="NCHW", ceil_mode=False, prefix=None, params=None):
        assert layout == "NCHW", "Only NCHW layout is supported"
        super().__init__(_tuple(pool_size, 2),
                         None if strides is None else _tuple(strides, 2),
                         _tuple(padding, 2), ceil_mode, False, "max",
                         prefix=prefix, params=params)


class AvgPool2D(_Pooling):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout="NCHW", ceil_mode=False, count_include_pad=True,
                 prefix=None, params=None):
        assert layout == "NCHW", "Only NCHW layout is supported"
        super().__init__(_tuple(pool_size, 2),
                         None if strides is None else _tuple(strides, 2),
                         _tuple(padding, 2), ceil_mode, False, "avg",
                         count_include_pad, prefix=prefix, params=params)


class GlobalAvgPool2D(_Pooling):
    def __init__(self, layout="NCHW", prefix=None, params=None):
        assert layout == "NCHW", "Only NCHW layout is supported"
        super().__init__((1, 1), None, (0, 0), False, True, "avg",
                         prefix=prefix, params=params)
