"""Dense, Embedding, LayerNorm and Dropout, as the JAX package's
``gluon/nn/basic_layers.py``.

Parameters keep the reference's names and layouts (Dense weight
(units, in_units), Embedding weight (input_dim, output_dim), LayerNorm
gamma/beta) so a by-name copy moves values over unchanged.  ``in_units``
must be given: deferred shapes are not ported.
"""
from __future__ import annotations

from ...base import MXNetError
from ...initializer import param
from ...ops import nn as ops
from ..block import Block

__all__ = ["Dense", "Embedding", "LayerNorm", "Dropout"]


class Dense(Block):
    """``act(x @ weight.T + bias)``; ``flatten`` folds every axis after
    the first."""

    def __init__(self, units, activation=None, use_bias=True, flatten=True,
                 in_units=0, weight_initializer=None,
                 bias_initializer="zeros"):
        super().__init__()
        if not in_units:
            raise MXNetError("Dense: in_units must be given (deferred "
                             "shape inference is not ported)")
        self._flatten = flatten
        self._act = activation
        self.weight = param(units, in_units, init=weight_initializer)
        self.bias = param(units, init=bias_initializer) if use_bias \
            else None

    def forward(self, x):
        out = ops.fully_connected(x, self.weight, self.bias,
                                  flatten=self._flatten)
        if self._act is not None:
            out = ops.activation(out, self._act)
        return out


class Embedding(Block):
    """Index -> row lookup; ids may be float32, as in the reference."""

    def __init__(self, input_dim, output_dim, weight_initializer=None):
        super().__init__()
        self.weight = param(input_dim, output_dim, init=weight_initializer)

    def forward(self, x):
        return ops.embedding(x, self.weight)


class LayerNorm(Block):
    """Layer normalisation over the last axis with gamma and beta."""

    def __init__(self, in_channels, epsilon=1e-5):
        super().__init__()
        self._eps = epsilon
        self.gamma = param(in_channels, init="ones")
        self.beta = param(in_channels, init="zeros")

    def forward(self, x):
        return ops.layer_norm(x, self.gamma, self.beta, eps=self._eps)


class Dropout(Block):
    """Dropout at ``rate``, active only in training mode."""

    def __init__(self, rate):
        super().__init__()
        self._rate = rate

    def forward(self, x):
        return ops.dropout(x, p=self._rate, training=self.training)
