"""Activation layers, as the JAX package's ``gluon/nn/activations.py``:
``Activation``, ``LeakyReLU``, ``PReLU``, ``ELU``, ``SELU``, ``GELU``,
``Swish`` and ``SiLU``, over the ``LeakyReLU`` op family
(``ops.nn.leaky_relu``).  ``PReLU``'s learned slope is the parameter
``alpha``, (in_channels,), filled by ``Constant(0.25)`` by default."""
from __future__ import annotations

import torch

from ...initializer import Constant, param
from ...ops import nn as ops
from ..block import HybridBlock

__all__ = ["Activation", "LeakyReLU", "PReLU", "ELU", "SELU", "GELU",
           "Swish", "SiLU"]


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


class LeakyReLU(HybridBlock):
    """``x`` above 0, ``alpha * x`` below."""

    def __init__(self, alpha, prefix=None, params=None):
        assert alpha >= 0, "Slope coefficient for LeakyReLU must be >= 0."
        super().__init__(prefix=prefix, params=params)
        self._alpha = alpha

    def forward(self, x):
        return ops.leaky_relu(x, act_type="leaky", slope=self._alpha)


class PReLU(HybridBlock):
    """Leaky ReLU with a learned slope, one a channel (axis 1)."""

    def __init__(self, alpha_initializer=None, in_channels=1, prefix=None,
                 params=None):
        super().__init__(prefix=prefix, params=params)
        self.alpha = param(in_channels, init=alpha_initializer
                           if alpha_initializer is not None
                           else Constant(0.25))

    def forward(self, x):
        return ops.leaky_relu(x, self._tensor("alpha"), act_type="prelu")


class ELU(HybridBlock):
    """``x`` above 0, ``alpha * (exp(x) - 1)`` below."""

    def __init__(self, alpha=1.0, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._alpha = alpha

    def forward(self, x):
        return ops.leaky_relu(x, act_type="elu", slope=self._alpha)


class SELU(HybridBlock):
    def forward(self, x):
        return ops.leaky_relu(x, act_type="selu")


class GELU(HybridBlock):
    """Exact (erf) GELU, or its tanh approximation with
    ``approximation="tanh"``."""

    def __init__(self, approximation="erf", prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._approx = approximation

    def forward(self, x):
        if self._approx == "tanh":
            return ops.gelu_tanh(x)
        return ops.leaky_relu(x, act_type="gelu")


class Swish(HybridBlock):
    """``x * sigmoid(beta * x)`` (``silu`` when ``beta`` is 1)."""

    def __init__(self, beta=1.0, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._beta = beta

    def forward(self, x):
        if self._beta == 1.0:
            return ops.silu(x)
        return x * torch.sigmoid(self._beta * x)


class SiLU(HybridBlock):
    def forward(self, x):
        return ops.silu(x)
