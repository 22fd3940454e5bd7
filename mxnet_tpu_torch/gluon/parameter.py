"""Gluon ``Parameter`` and ``ParameterDict``, as the JAX package's
``gluon/parameter.py``.

A port Block keeps its weights as ``nn.Parameter`` attributes (so the
PyTorch module, its ``state_dict`` and the tensor-level paths are
unchanged).  A ``Parameter`` is the gluon view of one of them: it is
named ``block.prefix + attribute`` (the reference's name for the same
construction, e.g. ``hybridsequential0_dense0_weight``), and its
``data()`` is an NDArray over that very tensor, so an update through
either is seen by both.  ``grad()`` is the gradient buffer ``backward``
writes (``grad_req`` ``"write"``) or adds to (``"add"``); ``"null"``
turns the tensor's gradient off.

Not ported: deferred shapes (a shape must be known at construction),
several contexts per parameter, ``Constant``, ``save``/``load`` and a
parameter-by-parameter ``initialize`` (``Block.initialize`` places and
fills the whole block).
"""
from __future__ import annotations

import weakref
from collections import OrderedDict
from typing import Optional

import numpy as np
import torch
from torch import nn

from .. import autograd, initializer
from ..base import MXNetError, torch_dtype
from ..context import Context
from ..ndarray.ndarray import NDArray, _ctx_of

__all__ = ["Parameter", "ParameterDict"]


class Parameter:
    """The gluon view of the ``nn.Parameter`` ``attr`` of ``block``."""

    def __init__(self, block, attr: str, grad_req="write", lr_mult=1.0,
                 wd_mult=1.0):
        self._block = weakref.ref(block)
        self._attr = attr
        self.name = block.prefix + attr
        self.lr_mult = lr_mult
        self.wd_mult = wd_mult
        self._grad_req = "null"
        self._nd = None
        self.grad_req = grad_req

    def __repr__(self):
        return (f"Parameter {self.name} (shape={self.shape}, "
                f"dtype={self.dtype})")

    # -- the tensor ----------------------------------------------------------
    @property
    def _tensor(self) -> nn.Parameter:
        block = self._block()
        if block is None:
            raise MXNetError(f"the block of Parameter {self.name!r} is gone")
        return block._parameters[self._attr]

    @property
    def shape(self):
        return tuple(self._tensor.shape)

    @property
    def dtype(self):
        return str(self._tensor.dtype).replace("torch.", "")

    @property
    def init(self):
        return getattr(self._tensor, "mx_init", None)

    # -- grad_req ------------------------------------------------------------
    @property
    def grad_req(self):
        return self._grad_req

    @grad_req.setter
    def grad_req(self, req):
        if req not in ("write", "add", "null"):
            raise MXNetError(f"grad_req must be write, add or null, got "
                             f"{req!r}")
        self._grad_req = req
        t = self._tensor
        if t.is_floating_point():
            t.requires_grad_(req != "null")
        if self._nd is not None and self._nd._t is t:
            self._bind(t)

    def _bind(self, t):
        """The NDArray over ``t``, a leaf of the autograd graph.  Its
        gradient buffer is made by the first ``grad()`` or ``backward``
        (a model that is only served never holds one)."""
        nd_ = self._nd
        if nd_ is None or nd_._t is not t:
            nd_ = self._nd = NDArray(t, ctx=_ctx_of(t.device))
        nd_.grad_req = self._grad_req
        if self._grad_req == "null" or (
                nd_._grad is not None and nd_._grad._t.shape != t.shape):
            nd_._grad = None
        autograd._leaves[id(nd_)] = nd_
        return nd_

    # -- accessors -----------------------------------------------------------
    def data(self, ctx: Optional[Context] = None):
        """The NDArray over the parameter's tensor."""
        t = self._tensor
        if t.is_meta:
            raise MXNetError(
                f"Parameter {self.name!r} has not been initialized. You "
                "should initialize parameters with Block.initialize() "
                "before use.")
        nd_ = self._nd if self._nd is not None and self._nd._t is t \
            else self._bind(t)
        if ctx is not None and ctx.device != t.device:
            raise MXNetError(f"Parameter {self.name!r} was not initialized "
                             f"on context {ctx}; it lives on "
                             f"{nd_.context}")
        return nd_

    def list_data(self):
        return [self.data()]

    def grad(self, ctx: Optional[Context] = None):
        """The gradient buffer (``backward`` writes into it in place)."""
        if self._grad_req == "null":
            raise MXNetError(f"Cannot get gradient array for Parameter "
                             f"{self.name!r} because grad_req='null'")
        nd_ = self.data(ctx)
        if nd_._grad is None:
            nd_._grad = NDArray(torch.zeros_like(nd_._t.detach()),
                                ctx=nd_._ctx)
        return nd_._grad

    def list_grad(self):
        return [self.grad()]

    def list_ctx(self):
        return [self.data().context]

    def zero_grad(self):
        """Zero the gradient buffer in place."""
        if self._grad_req != "null" and self._nd is not None \
                and self._nd._grad is not None:
            self._nd._grad._t.zero_()

    def set_data(self, data):
        """Copy ``data`` (an NDArray or array-like) into the parameter in
        place: the tensor, its NDArray and its gradient buffer stay."""
        dst = self.data()._t
        src = data._t if isinstance(data, NDArray) else \
            torch.from_numpy(np.array(data))
        if tuple(src.shape) != tuple(dst.shape):
            raise MXNetError(f"set_data: shape {tuple(src.shape)} does not "
                             f"match Parameter {self.name!r} "
                             f"{tuple(dst.shape)}")
        with torch.no_grad():
            dst.copy_(src)


class ParameterDict:
    """Ordered, prefix-scoped dict of Parameters (parity: ParameterDict).
    ``block.params`` can also make new parameters with ``get``."""

    def __init__(self, prefix="", owner=None):
        self._prefix = prefix
        self._params = OrderedDict()
        self._owner = weakref.ref(owner) if owner is not None else None

    @property
    def prefix(self):
        return self._prefix

    def __repr__(self):
        s = "\n".join(f"  {v}" for v in self._params.values())
        return f"ParameterDict {self._prefix} (\n{s}\n)"

    def __getitem__(self, key):
        return self._params[key]

    def __contains__(self, key):
        return key in self._params

    def __iter__(self):
        return iter(self._params)

    def __len__(self):
        return len(self._params)

    def items(self):
        return self._params.items()

    def keys(self):
        return self._params.keys()

    def values(self):
        return self._params.values()

    def update(self, other):
        for k, v in other.items():
            if k in self._params and self._params[k] is not v:
                raise MXNetError(f"Cannot update self with other because "
                                 f"they have different Parameters with the "
                                 f"same name {k!r}")
            self._params[k] = v

    def get(self, name, shape=None, dtype="float32", init=None,
            grad_req="write", allow_deferred_init=False, **kwargs):
        """The parameter ``prefix + name``; on a block's own ``params`` it
        is made (on the ``meta`` device, until ``initialize``) when it
        does not exist yet."""
        full = self._prefix + name
        if full in self._params:
            return self._params[full]
        owner = self._owner() if self._owner is not None else None
        if owner is None:
            raise MXNetError(f"no Parameter {full!r}, and this dict belongs "
                             "to no block that could make it")
        if shape is None or any(int(s) <= 0 for s in shape):
            raise MXNetError(f"Parameter {full!r}: shape {shape} is not "
                             "fully known (deferred shapes are not ported)")
        p = initializer.param(*shape, init=init)
        if torch_dtype(dtype) != p.dtype:
            p = nn.Parameter(p.to(torch_dtype(dtype)))
            p.mx_init = init
        owner.register_parameter(name, p)
        param = owner._gluon_param(name)
        param.grad_req = grad_req
        return param

    def zero_grad(self):
        for p in self.values():
            p.zero_grad()

    def setattr(self, name, value):
        for p in self.values():
            setattr(p, name, value)
