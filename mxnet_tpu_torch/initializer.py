"""Weight initializers, as the JAX package's ``initializer.py``: Zero, One,
Constant, Uniform, Normal, Orthogonal, Xavier (uniform or gaussian, over
the in, out or average fan), MSRAPrelu, Bilinear, LSTMBias and Mixed,
drawn from a ``torch.Generator`` on the parameter's device; ``register``
adds one under its lower-cased class name, ``create`` makes one by name,
and ``InitDesc`` is a name with attributes.

Name dispatch is the reference's: a parameter named ``*bias`` or
``*beta`` gets zeros, ``*gamma`` ones, ``*running_mean``,
``*moving_mean``, ``*moving_inv_var``, ``*moving_avg``, ``*min`` and
``*max`` zeros, ``*running_var`` and ``*moving_var`` ones, any other the
initializer's weight rule.  A parameter that carries its own initializer
(the ``mx_init`` attribute :func:`param` sets) bypasses the dispatch, as
a per-parameter ``init=`` does in the reference.  The draws differ from
the JAX package's numpy draws for the same seed; the deterministic
initializers give the same values.

A shape with a 0 in it is deferred: :func:`param` makes a
``torch.nn.parameter.UninitializedParameter``, which :func:`fill` skips;
the block fills it at its first call, once the shape is known
(``gluon/block.py``).
"""
from __future__ import annotations

import math
import re

import numpy as np
import torch
from torch import nn
from torch.nn.parameter import UninitializedParameter

from .base import MXNetError

__all__ = ["Initializer", "Zero", "One", "Constant", "Uniform", "Normal",
           "Orthogonal", "Xavier", "MSRAPrelu", "Bilinear", "LSTMBias",
           "Mixed", "InitDesc", "register", "create", "param"]

_REGISTRY = {}

# name suffixes filled with a constant whatever the initializer (the
# reference's dispatch, in its order)
_BY_SUFFIX = (("bias", 0.0), ("gamma", 1.0), ("beta", 0.0),
              ("running_mean", 0.0), ("moving_mean", 0.0),
              ("running_var", 1.0), ("moving_var", 1.0),
              ("moving_inv_var", 0.0), ("moving_avg", 0.0), ("min", 0.0),
              ("max", 0.0))


def register(klass):
    """Class decorator: ``create`` finds ``klass`` by its lower-cased
    name."""
    _REGISTRY[klass.__name__.lower()] = klass
    return klass


class InitDesc(str):
    """A parameter's name with its attributes (parity: ``InitDesc``)."""

    def __new__(cls, name, attrs=None, global_init=None):
        ret = super().__new__(cls, name)
        ret.attrs = attrs or {}
        ret.global_init = global_init
        return ret


class Initializer:
    """Fill a parameter tensor in place, by its name."""

    def __call__(self, name, arr, generator):
        name = str(name)
        for suffix, value in _BY_SUFFIX:
            if name.endswith(suffix):
                arr.fill_(value)
                return
        self.init_weight(name, arr, generator)

    def init_weight(self, name, arr, generator):
        raise NotImplementedError(
            f"{type(self).__name__} must implement init_weight")


@register
class Zero(Initializer):
    def init_weight(self, name, arr, generator):
        arr.zero_()


@register
class One(Initializer):
    def init_weight(self, name, arr, generator):
        arr.fill_(1.0)


@register
class Constant(Initializer):
    """Every element ``value`` (a number, or an array that broadcasts to
    the parameter's shape)."""

    def __init__(self, value=0.0):
        self.value = value

    def init_weight(self, name, arr, generator):
        arr.copy_(torch.as_tensor(self.value, dtype=arr.dtype)
                  .expand(arr.shape))


@register
class Uniform(Initializer):
    def __init__(self, scale=0.07):
        self.scale = scale

    def init_weight(self, name, arr, generator):
        arr.uniform_(-self.scale, self.scale, generator=generator)


@register
class Normal(Initializer):
    def __init__(self, sigma=0.01):
        self.sigma = sigma

    def init_weight(self, name, arr, generator):
        arr.normal_(0.0, self.sigma, generator=generator)


@register
class Orthogonal(Initializer):
    """An orthonormal basis of a (rows, rest) draw (uniform in [-1, 1] or,
    with ``rand_type="normal"``, standard normal), times ``scale``."""

    def __init__(self, scale=1.414, rand_type="uniform"):
        self.scale = scale
        self.rand_type = rand_type

    def init_weight(self, name, arr, generator):
        nout = arr.shape[0]
        nin = math.prod(arr.shape[1:])
        tmp = torch.empty(nout, nin, device=arr.device, dtype=torch.float64)
        if self.rand_type == "uniform":
            tmp.uniform_(-1.0, 1.0, generator=generator)
        else:
            tmp.normal_(0.0, 1.0, generator=generator)
        u, _, v = torch.linalg.svd(tmp, full_matrices=False)
        q = u if u.shape == tmp.shape else v
        arr.copy_((self.scale * q).reshape(arr.shape))


@register
class Xavier(Initializer):
    """Xavier/Glorot: ``rnd_type`` "uniform" U(-s, s) or "gaussian"
    N(0, s), s = sqrt(magnitude / fan), the fan by ``factor_type``: "in",
    "out" or "avg" (their mean); a fan counts the receptive field of a
    convolution's kernel."""

    def __init__(self, rnd_type="uniform", factor_type="avg", magnitude=3):
        self.rnd_type = rnd_type
        self.factor_type = factor_type
        self.magnitude = float(magnitude)

    def init_weight(self, name, arr, generator):
        shape = arr.shape
        if len(shape) < 2:
            raise MXNetError(
                f"Xavier requires >=2D weight, got {tuple(shape)} for {name}")
        hw = float(math.prod(shape[2:])) if len(shape) > 2 else 1.0
        fans = {"in": shape[1] * hw, "out": shape[0] * hw,
                "avg": (shape[1] * hw + shape[0] * hw) / 2.0}
        if self.factor_type not in fans:
            raise MXNetError(f"bad factor_type {self.factor_type}")
        scale = math.sqrt(self.magnitude / fans[self.factor_type])
        if self.rnd_type == "uniform":
            arr.uniform_(-scale, scale, generator=generator)
        elif self.rnd_type == "gaussian":
            arr.normal_(0.0, scale, generator=generator)
        else:
            raise MXNetError(f"bad rnd_type {self.rnd_type}")


@register
class MSRAPrelu(Xavier):
    """He et al.'s gaussian for PReLU nets: Xavier's gaussian with
    magnitude 2 / (1 + slope^2)."""

    def __init__(self, factor_type="avg", slope=0.25):
        super().__init__("gaussian", factor_type, 2.0 / (1.0 + slope ** 2))


@register
class Bilinear(Initializer):
    """The bilinear upsampling kernel of a (C, 1, k, k) Deconvolution
    weight."""

    def init_weight(self, name, arr, generator):
        shape = arr.shape
        f = np.ceil(shape[3] / 2.0)
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        i = np.arange(math.prod(shape))
        x, y = i % shape[3], (i // shape[3]) % shape[2]
        weight = ((1 - np.abs(x / f - c)) * (1 - np.abs(y / f - c))
                  ).astype("float32")
        arr.copy_(torch.from_numpy(weight.reshape(tuple(shape))))


@register
class LSTMBias(Initializer):
    """An LSTM's (4 * hidden) bias: the forget gate's quarter
    ``forget_bias``, the other gates' 0 (the fused layout i, f, g, o)."""

    def __init__(self, forget_bias=1.0):
        self.forget_bias = forget_bias

    def init_weight(self, name, arr, generator):
        arr.zero_()
        n = arr.shape[0] // 4
        arr[n:2 * n] = self.forget_bias


@register
class Mixed(Initializer):
    """The initializer of the first regular expression that matches the
    parameter's name from its start (parity: ``mx.init.Mixed``)."""

    def __init__(self, patterns, initializers):
        if len(patterns) != len(initializers):
            raise MXNetError("patterns and initializers length mismatch")
        self.map = [(re.compile(p), create(i))
                    for p, i in zip(patterns, initializers)]

    def __call__(self, name, arr, generator):
        for pat, init in self.map:
            if pat.match(str(name)):
                init(name, arr, generator)
                return
        raise MXNetError(
            f"Parameter {name} did not match any pattern; add '.*' default")


_REGISTRY.update(zeros=Zero, ones=One)


def create(init, **kwargs) -> Initializer:
    """An initializer from an instance, a registered name (made with
    ``kwargs``) or None (the reference's default, ``Uniform()``)."""
    if isinstance(init, Initializer):
        return init
    if init is None:
        return Uniform()
    name = str(init).lower()
    if name not in _REGISTRY:
        raise MXNetError(f"unknown initializer {init!r}; choices: "
                         f"{sorted(_REGISTRY)}")
    return _REGISTRY[name](**kwargs)


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


def fill(module, init, generator, names=None):
    """Fill every parameter of ``module`` whose shape is known (a tensor
    the module shares from another block is that block's to fill), by
    its name in ``names`` (``{id(tensor): name}``), else its attribute
    path."""
    names = names or {}
    for name, p in nn.Module.named_parameters(module):
        if not isinstance(p, UninitializedParameter):
            fill_one(names.get(id(p), name), p, init, generator)
