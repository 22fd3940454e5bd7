"""Convolution, pooling and padding layers, as the JAX package's
``gluon/nn/conv_layers.py``: ``Conv1D/2D/3D``, ``Conv1D/2D/3DTranspose``,
``MaxPool1D/2D/3D``, ``AvgPool1D/2D/3D``, the global max and average
pools and ``ReflectionPad2D``, NCW/NCHW/NCDHW.

A convolution's weight is (channels, in_channels / groups, *kernel) and
a transposed convolution's (in_channels, channels / groups, *kernel), as
the reference lays them out (the second is PyTorch's own), so a by-name
copy moves them over unchanged; ``in_channels=0`` defers that size to
the first call.  A transposed convolution runs the ``Deconvolution`` op
with ``output_padding`` as its ``adj``.
"""
from __future__ import annotations

from ...initializer import param
from ...ops import nn as ops
from ...ops import tensor as tensor_ops
from ..block import HybridBlock
from .activations import Activation

__all__ = ["Conv1D", "Conv2D", "Conv3D", "Conv1DTranspose",
           "Conv2DTranspose", "Conv3DTranspose", "MaxPool1D", "MaxPool2D",
           "MaxPool3D", "AvgPool1D", "AvgPool2D", "AvgPool3D",
           "GlobalMaxPool1D", "GlobalMaxPool2D", "GlobalMaxPool3D",
           "GlobalAvgPool1D", "GlobalAvgPool2D", "GlobalAvgPool3D",
           "ReflectionPad2D"]

_LAYOUTS = {1: "NCW", 2: "NCHW", 3: "NCDHW"}


def _tuple(value, n):
    return (int(value),) * n if isinstance(value, int) else \
        tuple(int(v) for v in value)


class _Conv(HybridBlock):
    """``act(Convolution(x, weight, bias))`` over ``len(kernel_size)``
    spatial axes; with ``_transposed`` (``_ConvTranspose``)
    ``Deconvolution`` and the weight's first two axes swapped."""

    _transposed = False

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
        self.weight = param(*self._weight_shape(in_channels),
                            init=weight_initializer)
        self.bias = param(channels, init=bias_initializer) if use_bias \
            else None
        if activation is not None:
            with self.name_scope():
                self.act = Activation(activation, prefix=activation + "_")
        else:
            self.act = None

    def _weight_shape(self, in_channels):
        if self._transposed:
            return (in_channels, self._channels // self._groups) \
                + self._kernel
        return (self._channels, in_channels // self._groups) + self._kernel

    def infer_shape(self, x):
        self._gluon_param("weight").shape = self._weight_shape(x.shape[1])

    def forward(self, x):
        op = ops.deconvolution if self._transposed else ops.convolution
        out = op(x, self._tensor("weight"), self._tensor("bias"),
                 **self._conv)
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


class _ConvTranspose(_Conv):
    """``act(Deconvolution(x, weight, bias))``, ``output_padding`` its
    ``adj``; the weight is (in_channels, channels / groups, *kernel)."""

    _transposed = True

    def __init__(self, channels, kernel_size, strides, padding,
                 output_padding, dilation, groups, layout, in_channels=0,
                 activation=None, use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", prefix=None, params=None):
        n = len(kernel_size)
        assert layout == _LAYOUTS[n], \
            f"Only {_LAYOUTS[n]} layout is supported"
        super().__init__(channels, kernel_size, strides, padding, dilation,
                         groups, in_channels, activation, use_bias,
                         weight_initializer, bias_initializer,
                         prefix=prefix, params=params)
        self._conv["adj"] = output_padding


class Conv1DTranspose(_ConvTranspose):
    def __init__(self, channels, kernel_size, strides=1, padding=0,
                 output_padding=0, dilation=1, groups=1, layout="NCW",
                 activation=None, use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, prefix=None,
                 params=None):
        super().__init__(channels, _tuple(kernel_size, 1),
                         _tuple(strides, 1), _tuple(padding, 1),
                         _tuple(output_padding, 1), _tuple(dilation, 1),
                         groups, layout, in_channels, activation, use_bias,
                         weight_initializer, bias_initializer,
                         prefix=prefix, params=params)


class Conv2DTranspose(_ConvTranspose):
    def __init__(self, channels, kernel_size, strides=(1, 1),
                 padding=(0, 0), output_padding=(0, 0), dilation=(1, 1),
                 groups=1, layout="NCHW", activation=None, use_bias=True,
                 weight_initializer=None, bias_initializer="zeros",
                 in_channels=0, prefix=None, params=None):
        super().__init__(channels, _tuple(kernel_size, 2),
                         _tuple(strides, 2), _tuple(padding, 2),
                         _tuple(output_padding, 2), _tuple(dilation, 2),
                         groups, layout, in_channels, activation, use_bias,
                         weight_initializer, bias_initializer,
                         prefix=prefix, params=params)


class Conv3DTranspose(_ConvTranspose):
    def __init__(self, channels, kernel_size, strides=(1, 1, 1),
                 padding=(0, 0, 0), output_padding=(0, 0, 0),
                 dilation=(1, 1, 1), groups=1, layout="NCDHW",
                 activation=None, use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, prefix=None,
                 params=None):
        super().__init__(channels, _tuple(kernel_size, 3),
                         _tuple(strides, 3), _tuple(padding, 3),
                         _tuple(output_padding, 3), _tuple(dilation, 3),
                         groups, layout, in_channels, activation, use_bias,
                         weight_initializer, bias_initializer,
                         prefix=prefix, params=params)


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


class _MaxPool(_Pooling):
    def __init__(self, n, pool_size, strides, padding, layout, ceil_mode,
                 prefix, params):
        assert layout == _LAYOUTS[n], f"Only {_LAYOUTS[n]} layout is supported"
        super().__init__(_tuple(pool_size, n),
                         None if strides is None else _tuple(strides, n),
                         _tuple(padding, n), ceil_mode, False, "max",
                         prefix=prefix, params=params)


class _AvgPool(_Pooling):
    def __init__(self, n, pool_size, strides, padding, layout, ceil_mode,
                 count_include_pad, prefix, params):
        assert layout == _LAYOUTS[n], f"Only {_LAYOUTS[n]} layout is supported"
        super().__init__(_tuple(pool_size, n),
                         None if strides is None else _tuple(strides, n),
                         _tuple(padding, n), ceil_mode, False, "avg",
                         count_include_pad, prefix=prefix, params=params)


class _GlobalPool(_Pooling):
    def __init__(self, n, pool_type, layout, prefix, params):
        assert layout == _LAYOUTS[n], f"Only {_LAYOUTS[n]} layout is supported"
        super().__init__((1,) * n, None, (0,) * n, False, True, pool_type,
                         prefix=prefix, params=params)


class MaxPool1D(_MaxPool):
    def __init__(self, pool_size=2, strides=None, padding=0, layout="NCW",
                 ceil_mode=False, prefix=None, params=None):
        super().__init__(1, pool_size, strides, padding, layout, ceil_mode,
                         prefix, params)


class MaxPool2D(_MaxPool):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout="NCHW", ceil_mode=False, prefix=None, params=None):
        super().__init__(2, pool_size, strides, padding, layout, ceil_mode,
                         prefix, params)


class MaxPool3D(_MaxPool):
    def __init__(self, pool_size=(2, 2, 2), strides=None, padding=0,
                 layout="NCDHW", ceil_mode=False, prefix=None, params=None):
        super().__init__(3, pool_size, strides, padding, layout, ceil_mode,
                         prefix, params)


class AvgPool1D(_AvgPool):
    def __init__(self, pool_size=2, strides=None, padding=0, layout="NCW",
                 ceil_mode=False, count_include_pad=True, prefix=None,
                 params=None):
        super().__init__(1, pool_size, strides, padding, layout, ceil_mode,
                         count_include_pad, prefix, params)


class AvgPool2D(_AvgPool):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout="NCHW", ceil_mode=False, count_include_pad=True,
                 prefix=None, params=None):
        super().__init__(2, pool_size, strides, padding, layout, ceil_mode,
                         count_include_pad, prefix, params)


class AvgPool3D(_AvgPool):
    def __init__(self, pool_size=(2, 2, 2), strides=None, padding=0,
                 layout="NCDHW", ceil_mode=False, count_include_pad=True,
                 prefix=None, params=None):
        super().__init__(3, pool_size, strides, padding, layout, ceil_mode,
                         count_include_pad, prefix, params)


class GlobalMaxPool1D(_GlobalPool):
    def __init__(self, layout="NCW", prefix=None, params=None):
        super().__init__(1, "max", layout, prefix, params)


class GlobalMaxPool2D(_GlobalPool):
    def __init__(self, layout="NCHW", prefix=None, params=None):
        super().__init__(2, "max", layout, prefix, params)


class GlobalMaxPool3D(_GlobalPool):
    def __init__(self, layout="NCDHW", prefix=None, params=None):
        super().__init__(3, "max", layout, prefix, params)


class GlobalAvgPool1D(_GlobalPool):
    def __init__(self, layout="NCW", prefix=None, params=None):
        super().__init__(1, "avg", layout, prefix, params)


class GlobalAvgPool2D(_GlobalPool):
    def __init__(self, layout="NCHW", prefix=None, params=None):
        super().__init__(2, "avg", layout, prefix, params)


class GlobalAvgPool3D(_GlobalPool):
    def __init__(self, layout="NCDHW", prefix=None, params=None):
        super().__init__(3, "avg", layout, prefix, params)


class ReflectionPad2D(HybridBlock):
    """Mirror-pad the last two axes of (N, C, H, W) by ``padding`` (an
    int for all four sides, or the ``pad`` op's 8-value ``pad_width``)."""

    def __init__(self, padding=0, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        if isinstance(padding, int):
            padding = (0, 0, 0, 0, padding, padding, padding, padding)
        assert len(padding) == 8
        self._padding = tuple(padding)

    def forward(self, x):
        return tensor_ops.pad(x, mode="reflect", pad_width=self._padding)
