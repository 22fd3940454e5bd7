"""Weight initializers, as the JAX package's ``initializer.py``: Xavier,
Normal, Uniform, Zero, One and Constant, drawn from a ``torch.Generator`` on the
parameter's device.

Name dispatch is the reference's: a parameter named ``*bias`` or
``*beta`` gets zeros, ``*gamma`` ones, any other the initializer's
weight rule.  A parameter that carries its own initializer (the
``mx_init`` attribute :func:`param` sets) bypasses the dispatch, as a
per-parameter ``init=`` does in the reference.  The draws differ from
the JAX package's numpy draws for the same seed.

A shape with a 0 in it is deferred: :func:`param` makes a
``torch.nn.parameter.UninitializedParameter``, which :func:`fill` skips;
the block fills it at its first call, once the shape is known
(``gluon/block.py``).
"""
from __future__ import annotations

import math

import torch
from torch import nn
from torch.nn.parameter import UninitializedParameter

from .base import MXNetError

__all__ = ["Initializer", "Xavier", "Normal", "Uniform", "Zero", "One",
           "Constant", "create", "param"]


class Initializer:
    """Fill a parameter tensor in place, by its name."""

    def __call__(self, name, arr, generator):
        if name.endswith("bias") or name.endswith("beta"):
            arr.zero_()
        elif name.endswith("gamma"):
            arr.fill_(1.0)
        else:
            self.init_weight(name, arr, generator)

    def init_weight(self, name, arr, generator):
        raise NotImplementedError(
            f"{type(self).__name__} must implement init_weight")


class Zero(Initializer):
    def init_weight(self, name, arr, generator):
        arr.zero_()


class One(Initializer):
    def init_weight(self, name, arr, generator):
        arr.fill_(1.0)


class Constant(Initializer):
    """Every element ``value`` (a number, or an array that broadcasts to
    the parameter's shape)."""

    def __init__(self, value=0.0):
        self.value = value

    def init_weight(self, name, arr, generator):
        arr.copy_(torch.as_tensor(self.value, dtype=arr.dtype)
                  .expand(arr.shape))


class Uniform(Initializer):
    def __init__(self, scale=0.07):
        self.scale = scale

    def init_weight(self, name, arr, generator):
        arr.uniform_(-self.scale, self.scale, generator=generator)


class Normal(Initializer):
    def __init__(self, sigma=0.01):
        self.sigma = sigma

    def init_weight(self, name, arr, generator):
        arr.normal_(0.0, self.sigma, generator=generator)


class Xavier(Initializer):
    """Xavier/Glorot, uniform over the average fan:
    U(-s, s) with s = sqrt(magnitude / ((fan_in + fan_out) / 2)).  The
    reference's gaussian draw and in/out fans are not ported."""

    def __init__(self, magnitude=3):
        self.magnitude = float(magnitude)

    def init_weight(self, name, arr, generator):
        shape = arr.shape
        if len(shape) < 2:
            raise MXNetError(
                f"Xavier requires >=2D weight, got {tuple(shape)} for {name}")
        hw = float(math.prod(shape[2:])) if len(shape) > 2 else 1.0
        factor = (shape[1] * hw + shape[0] * hw) / 2.0
        scale = math.sqrt(self.magnitude / factor)
        arr.uniform_(-scale, scale, generator=generator)


_REGISTRY = {"xavier": Xavier, "normal": Normal, "uniform": Uniform,
             "zero": Zero, "zeros": Zero, "one": One, "ones": One,
             "constant": Constant}


def create(init) -> Initializer:
    """An initializer from an instance, a registered name or None (the
    reference's default, ``Uniform()``)."""
    if isinstance(init, Initializer):
        return init
    if init is None:
        return Uniform()
    name = str(init).lower()
    if name not in _REGISTRY:
        raise MXNetError(f"unknown initializer {init!r}; choices: "
                         f"{sorted(_REGISTRY)}")
    return _REGISTRY[name]()


def param(*shape, init=None, dtype=torch.float32, requires_grad=True):
    """A parameter of ``shape`` on the ``meta`` device (no memory until
    the block is initialized), with its own initializer when ``init`` is
    given.  A 0 in ``shape`` leaves that size to the first call: the
    parameter is then an ``UninitializedParameter`` whose ``mx_shape``
    holds the known sizes."""
    shape = tuple(int(s) for s in shape)
    if 0 in shape:
        p = UninitializedParameter(requires_grad=requires_grad, dtype=dtype)
        p.mx_shape = shape
    else:
        p = nn.Parameter(torch.empty(*shape, device="meta", dtype=dtype),
                         requires_grad=requires_grad)
    p.mx_init = init
    return p


@torch.no_grad()
def fill_one(name, p, init, generator):
    """Fill the parameter ``p`` (named ``name``) in place: its own
    initializer, else ``init`` with name dispatch."""
    own = getattr(p, "mx_init", None)
    if own is not None:
        create(own).init_weight(name, p, generator)
    else:
        create(init)(name, p, generator)


def fill(module, init, generator):
    """Fill every parameter of ``module`` whose shape is known."""
    for name, p in module.named_parameters():
        if not isinstance(p, UninitializedParameter):
            fill_one(name, p, init, generator)
