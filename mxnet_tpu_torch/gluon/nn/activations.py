"""The ``Activation`` layer, as the JAX package's
``gluon/nn/activations.py``."""
from __future__ import annotations

from ...ops import nn as ops
from ..block import HybridBlock

__all__ = ["Activation"]


class Activation(HybridBlock):
    """A named activation (``ops.nn.activation``'s: relu, sigmoid, tanh,
    softrelu, softsign, log_sigmoid, mish, relu6); named after it
    (``relu0_``), as in the reference."""

    def __init__(self, activation, prefix=None, params=None):
        self._act_type = activation
        super().__init__(prefix=prefix, params=params)

    def _alias(self):
        return self._act_type

    def forward(self, x):
        return ops.activation(x, self._act_type)
