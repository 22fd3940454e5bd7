"""Sequential containers and Dense, Embedding, LayerNorm and Dropout, as
the JAX package's ``gluon/nn/basic_layers.py``.

Parameters keep the reference's names and layouts (Dense weight
(units, in_units), Embedding weight (input_dim, output_dim), LayerNorm
gamma/beta) so a by-name copy moves values over unchanged.  ``in_units``
must be given: deferred shapes are not ported.
"""
from __future__ import annotations

from torch import nn

from ...base import MXNetError, torch_dtype
from ...initializer import param
from ...ops import nn as ops
from ..block import Block, HybridBlock

__all__ = ["Sequential", "HybridSequential", "Dense", "Embedding",
           "LayerNorm", "Dropout"]


class Sequential(Block):
    """Stack of Blocks run one after the other."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)

    def add(self, *blocks):
        for block in blocks:
            self.add_module(str(len(self._modules)), block)
        return self

    def forward(self, x):
        for block in self._modules.values():
            x = block(x)
        return x

    def __len__(self):
        return len(self._modules)

    def __getitem__(self, key):
        layers = list(self._modules.values())
        if isinstance(key, slice):
            net = type(self)(prefix=self._prefix)
            return net.add(*layers[key])
        return layers[key]

    def __iter__(self):
        return iter(self._modules.values())


class HybridSequential(HybridBlock):
    """Stack of HybridBlocks run one after the other."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)

    add = Sequential.add
    forward = Sequential.forward
    __len__ = Sequential.__len__
    __getitem__ = Sequential.__getitem__
    __iter__ = Sequential.__iter__


def _param(*shape, init=None, dtype="float32"):
    p = param(*shape, init=init)
    dt = torch_dtype(dtype)
    if dt != p.dtype:
        p = nn.Parameter(p.to(dt))
        p.mx_init = init
    return p


class Dense(HybridBlock):
    """``act(x @ weight.T + bias)``; ``flatten`` folds every axis after
    the first."""

    def __init__(self, units, activation=None, use_bias=True, flatten=True,
                 dtype="float32", weight_initializer=None,
                 bias_initializer="zeros", in_units=0, prefix=None,
                 params=None):
        super().__init__(prefix=prefix, params=params)
        if not in_units:
            raise MXNetError("Dense: in_units must be given (deferred "
                             "shape inference is not ported)")
        self._flatten = flatten
        self._act = activation
        self.weight = _param(units, in_units, init=weight_initializer,
                             dtype=dtype)
        self.bias = _param(units, init=bias_initializer, dtype=dtype) \
            if use_bias else None

    def forward(self, x):
        out = ops.fully_connected(x, self.weight, self.bias,
                                  flatten=self._flatten)
        if self._act is not None:
            out = ops.activation(out, self._act)
        return out


class Embedding(HybridBlock):
    """Index -> row lookup; ids may be float32, as in the reference."""

    def __init__(self, input_dim, output_dim, dtype="float32",
                 weight_initializer=None, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self.weight = _param(input_dim, output_dim, init=weight_initializer,
                             dtype=dtype)

    def forward(self, x):
        return ops.embedding(x, self.weight)


class LayerNorm(HybridBlock):
    """Layer normalisation over the last axis with gamma and beta."""

    def __init__(self, in_channels, epsilon=1e-5, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._eps = epsilon
        self.gamma = param(in_channels, init="ones")
        self.beta = param(in_channels, init="zeros")

    def forward(self, x):
        return ops.layer_norm(x, self.gamma, self.beta, eps=self._eps)


class Dropout(HybridBlock):
    """Dropout at ``rate``, active only in training mode (with NDArrays,
    ``autograd.is_training()``)."""

    def __init__(self, rate, axes=(), prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._rate = rate
        self._axes = tuple(axes)

    def forward(self, x):
        return ops.dropout(x, p=self._rate, training=self._training_mode(),
                           axes=self._axes)
