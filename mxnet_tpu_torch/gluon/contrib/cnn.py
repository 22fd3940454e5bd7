"""``gluon.contrib.cnn``: the deformable convolution layer, as the JAX
package's (reference ``python/mxnet/gluon/contrib/cnn/conv_layers.py``)."""
from __future__ import annotations

from ..block import HybridBlock
from ..nn.conv_layers import Conv2D

__all__ = ["DeformableConvolution"]


def _pair(v):
    return (v,) * 2 if isinstance(v, int) else tuple(v)


class DeformableConvolution(HybridBlock):
    """2-D deformable convolution (v1): an inner ``Conv2D`` predicts each
    tap's sampling offset, and the main kernel samples the input
    bilinearly there (``_contrib_DeformableConvolution``).  The offset
    branch starts at zero, so the layer starts as a plain convolution."""

    def __init__(self, channels, kernel_size=(3, 3), strides=(1, 1),
                 padding=(0, 0), dilation=(1, 1), groups=1,
                 num_deformable_group=1, in_channels=0, use_bias=True,
                 weight_initializer=None, bias_initializer="zeros",
                 offset_use_bias=True, activation=None, prefix=None,
                 params=None):
        super().__init__(prefix=prefix, params=params)
        ks, strides = _pair(kernel_size), _pair(strides)
        padding, dilation = _pair(padding), _pair(dilation)
        self._channels = channels
        self._kwargs = {
            "kernel": ks, "stride": strides, "pad": padding,
            "dilate": dilation, "num_filter": channels,
            "num_group": groups,
            "num_deformable_group": num_deformable_group,
            "no_bias": not use_bias}
        with self.name_scope():
            self.offset_conv = Conv2D(
                2 * num_deformable_group * ks[0] * ks[1], ks,
                strides=strides, padding=padding, dilation=dilation,
                in_channels=in_channels, use_bias=offset_use_bias,
                weight_initializer="zeros", bias_initializer="zeros",
                prefix="offset_")
            self.weight = self.params.get(
                "weight", shape=(channels,
                                 in_channels // groups if in_channels
                                 else 0) + ks,
                init=weight_initializer, allow_deferred_init=True)
            self.bias = self.params.get(
                "bias", shape=(channels,), init=bias_initializer,
                allow_deferred_init=True) if use_bias else None
            if activation is not None:
                from ..nn.activations import Activation
                self.act = Activation(activation)
            else:
                self.act = None

    def infer_shape(self, x):
        groups = self._kwargs["num_group"]
        self.weight.shape = (self._channels, x.shape[1] // groups) + \
            self._kwargs["kernel"]

    def hybrid_forward(self, F, x, weight, bias=None):
        offset = self.offset_conv(x)
        op = getattr(F, "_contrib_DeformableConvolution")
        if bias is None:
            out = op(x, offset, weight, **self._kwargs)
        else:
            out = op(x, offset, weight, bias, **self._kwargs)
        return self.act(out) if self.act is not None else out
