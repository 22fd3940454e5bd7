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

A shape with a 0 in it is deferred, as in the reference
(``allow_deferred_init``; the port's layers defer ``in_units`` and
``in_channels`` given as 0): the tensor is a
``torch.nn.parameter.UninitializedParameter`` until the block's first
call, where the layer's ``infer_shape`` completes the shape from the
input and the parameter is made on the device ``initialize`` named and
filled by its initializer (:meth:`Parameter._finish_deferred_init`).
Until then ``data()`` raises.

``grad_stype="row_sparse"`` (``Embedding(sparse_grad=True)``) makes the
gradient buffer a ``RowSparseNDArray``, so the optimizers update only
the rows its gradient touches; a parameter asked for twice through
``ParameterDict.get`` keeps ``"row_sparse"`` if either asks for it.

``cast(dtype)`` puts a new tensor of ``dtype`` in the block's place
(its values rounded); a ``Constant`` holds a fixed value and takes no
gradient, on its own (``Constant(name, value)``, placed by its
``initialize``) or as a block's (``block.params.get_constant``).

Not ported: several contexts per parameter, ``save``/``load`` of a
``ParameterDict`` and a parameter-by-parameter ``initialize`` of a
block's parameters (``Block.initialize`` places and fills the whole
block).
"""
from __future__ import annotations

import weakref
from collections import OrderedDict
from typing import Optional

import numpy as np
import torch
from torch import nn
from torch.nn.parameter import UninitializedParameter

from .. import autograd, initializer
from ..base import MXNetError, torch_dtype
from ..context import Context
from ..ndarray.ndarray import NDArray, _ctx_of, _grad_buffer

__all__ = ["Parameter", "ParameterDict", "Constant",
           "DeferredInitializationError"]


class DeferredInitializationError(MXNetError):
    """A parameter's data was asked for before its first call made it
    (its shape had a 0 in it)."""


class Parameter:
    """The gluon view of the ``nn.Parameter`` ``attr`` of ``block``.
    ``grad_req`` defaults to ``"write"`` for a tensor that requires a
    gradient and ``"null"`` for one that does not (running statistics)."""

    def __init__(self, block, attr: str, grad_req=None, lr_mult=1.0,
                 wd_mult=1.0, grad_stype="default"):
        self._block = weakref.ref(block)
        self._attr = attr
        self.name = block._param_prefix + attr
        self.lr_mult = lr_mult
        self.wd_mult = wd_mult
        self._grad_req = "null"
        self._grad_stype = grad_stype
        self._nd = None
        if grad_req is None:
            grad_req = "write" if self._tensor.requires_grad else "null"
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
    def _deferred(self) -> bool:
        return isinstance(self._tensor, UninitializedParameter)

    @property
    def shape(self):
        """The shape; a deferred size reads 0 until the first call."""
        t = self._tensor
        return t.mx_shape if isinstance(t, UninitializedParameter) \
            else tuple(t.shape)

    @shape.setter
    def shape(self, new_shape):
        """Complete a deferred shape (a layer's ``infer_shape``): every
        size given at construction must stay."""
        new_shape = tuple(int(s) for s in new_shape)
        old = self.shape
        if len(old) != len(new_shape) or any(
                o not in (0, n) for o, n in zip(old, new_shape)):
            raise MXNetError(f"Parameter {self.name!r}: shape {new_shape} "
                             f"is incompatible with {old}")
        if self._deferred:
            self._tensor.mx_shape = new_shape

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
            t.requires_grad = req != "null"
        if self._nd is not None and self._nd._t is t:
            self._bind(t)

    @property
    def grad_stype(self):
        """The gradient's storage type: ``"default"`` or ``"row_sparse"``."""
        return self._grad_stype

    @grad_stype.setter
    def grad_stype(self, stype):
        if stype not in ("default", "row_sparse"):
            raise MXNetError(f"grad_stype must be default or row_sparse, "
                             f"got {stype!r}")
        self._grad_stype = stype
        nd_ = self._nd
        if nd_ is not None and nd_._grad is not None and \
                nd_._grad.stype != stype:
            # a buffer made before the stype was asked for takes it now
            old = nd_._grad
            nd_._grad = _grad_buffer(nd_, stype)
            nd_._grad._t.copy_(old._t)

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
        if self._grad_stype != "default" and self._grad_req != "null" \
                and nd_._grad is None:
            # typed now: backward would otherwise make a dense buffer
            nd_._grad = _grad_buffer(nd_, self._grad_stype)
        autograd._leaves[id(nd_)] = nd_
        return nd_

    # -- accessors -----------------------------------------------------------
    def data(self, ctx: Optional[Context] = None):
        """The NDArray over the parameter's tensor."""
        t = self._tensor
        if getattr(t, "mx_deferred", None) is not None:
            raise DeferredInitializationError(
                f"Parameter {self.name!r} has not been initialized yet "
                "because initialization was deferred. Actual "
                "initialization happens during the first forward pass.")
        if t.is_meta or isinstance(t, UninitializedParameter):
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
            nd_._grad = _grad_buffer(nd_, self._grad_stype)
        return nd_._grad

    def list_grad(self):
        return [self.grad()]

    def list_ctx(self):
        deferred = getattr(self._tensor, "mx_deferred", None)
        if deferred is not None:
            return [_ctx_of(deferred[1])]
        return [self.data().context]

    def _finish_deferred_init(self):
        """Make a deferred parameter whose shape is now complete, on the
        device ``initialize`` named, and fill it with its initializer
        (the reference's ``_finish_deferred_init``)."""
        t = self._tensor
        if not isinstance(t, UninitializedParameter):
            return
        if 0 in t.mx_shape:
            raise MXNetError(
                f"Cannot initialize Parameter {self.name!r} because it "
                f"has invalid shape: {t.mx_shape}. Please specify "
                "in_units, in_channels, etc for `Block`s.")
        deferred = getattr(t, "mx_deferred", None)
        if deferred is None:
            raise MXNetError(
                f"Parameter {self.name!r} has not been initialized. You "
                "should initialize parameters with Block.initialize() "
                "before use.")
        init, device, generator = deferred
        t.materialize(t.mx_shape, device=device)
        del t.mx_deferred
        initializer.fill_one(self.name, t, init, generator)
        self._bind(t)          # a leaf that backward writes gradients for

    def zero_grad(self):
        """Zero the gradient buffer in place."""
        if self._grad_req != "null" and self._nd is not None \
                and self._nd._grad is not None:
            self._nd._grad._t.zero_()

    def _load_init(self, data, ctx=None, cast_dtype=False):
        """Take the loaded numpy ``data``: in place when the parameter is
        placed on ``ctx`` with the file's type (or ``cast_dtype``), else
        as a new tensor on ``ctx`` (default: its device, or the current
        context for one not placed yet) in the file's type."""
        from ..context import current_context
        from ..ndarray.ndarray import array
        shape = self.shape
        if 0 not in shape and tuple(shape) != tuple(data.shape):
            raise MXNetError(f"Failed loading Parameter {self.name!r} from "
                             f"saved params: shape incompatible expected "
                             f"{shape} vs saved {tuple(data.shape)}")
        t = self._tensor
        placed = not t.is_meta and not isinstance(t, UninitializedParameter)
        if ctx is None:
            ctx = _ctx_of(t.device) if placed else current_context()
        dtype = t.dtype if cast_dtype else torch_dtype(data.dtype)
        src = array(data, ctx=ctx, dtype=dtype)._t
        if placed and t.dtype == dtype and t.device == src.device:
            with torch.no_grad():
                t.copy_(src)
            return
        new = nn.Parameter(src, requires_grad=t.requires_grad)
        if getattr(t, "mx_init", None) is not None:
            new.mx_init = t.mx_init
        self._block()._parameters[self._attr] = new
        self._bind(new)

    def cast(self, dtype):
        """A tensor of ``dtype`` in the parameter's place (parity:
        ``Parameter.cast``): the values rounded, a new gradient buffer; a
        parameter not made yet gets the type for when it is."""
        dtype = torch_dtype(dtype)
        t = self._tensor
        if t.dtype == dtype:
            return
        if isinstance(t, UninitializedParameter):
            new = UninitializedParameter(requires_grad=t.requires_grad,
                                         dtype=dtype)
            for key in ("mx_shape", "mx_deferred"):
                if hasattr(t, key):
                    setattr(new, key, getattr(t, key))
        else:
            new = nn.Parameter(t.detach().to(dtype),
                               requires_grad=t.requires_grad)
        if getattr(t, "mx_init", None) is not None:
            new.mx_init = t.mx_init
        self._block()._parameters[self._attr] = new
        if self._nd is not None:
            self._nd._grad = None
        if not t.is_meta and not isinstance(new, UninitializedParameter):
            self._bind(new)

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


class _Holder(nn.Module):
    """The module that holds a standalone Constant's tensor."""

    prefix = _param_prefix = ""


class Constant(Parameter):
    """A parameter that holds ``value`` and takes no gradient (parity:
    ``gluon.Constant``).  ``Constant(name, value)`` stands alone and is
    placed by :meth:`initialize`; ``block.params.get_constant(name,
    value)`` makes one of the block's, which the block's ``initialize``
    places."""

    def __init__(self, name, value, _block=None, _attr=None):
        value = _constant_value(value)
        if _block is None:
            _block, _attr = _Holder(), "value"
            _block.register_parameter("value", _constant_tensor(value))
            self._holder = _block          # a Parameter holds its block weakly
        self.value = value
        super().__init__(_block, _attr, grad_req="null")
        self.name = name

    @property
    def grad_req(self):
        return "null"

    @grad_req.setter
    def grad_req(self, req):
        if req != "null":
            raise MXNetError(f"Constant {self.name!r} takes no gradient: "
                             f"grad_req stays 'null', not {req!r}")
        Parameter.grad_req.fset(self, req)

    def initialize(self, init=None, ctx=None, default_init=None,
                   force_reinit=False):
        """Place a standalone constant on ``ctx`` (default: the current
        context) with its value."""
        from ..context import current_context
        holder = getattr(self, "_holder", None)
        if holder is None:
            raise MXNetError(f"Constant {self.name!r} belongs to a block: "
                             "the block's initialize places it")
        t = self._tensor
        if not t.is_meta and not force_reinit:
            return
        dev = (ctx or current_context()).device
        new = nn.Parameter(torch.as_tensor(self.value, device=dev),
                           requires_grad=False)
        holder._parameters["value"] = new
        self._bind(new)


def _constant_value(value):
    """``value`` as a numpy array: float32 for lists, numbers and float64
    arrays, an array's or NDArray's own type otherwise."""
    if isinstance(value, NDArray):
        value = value.asnumpy()
    elif not hasattr(value, "dtype"):          # lists and numbers
        value = np.asarray(value, dtype="float32")
    value = np.asarray(value)
    return value.astype("float32") if value.dtype == np.float64 else value


def _constant_tensor(value):
    """A ``meta`` parameter that ``initialize`` fills with ``value``."""
    return initializer.param(*value.shape,
                             init=initializer.Constant(value),
                             dtype=torch_dtype(value.dtype),
                             requires_grad=False)


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
            grad_req="write", allow_deferred_init=False,
            grad_stype="default", **kwargs):
        """The parameter ``prefix + name``; on a block's own ``params`` it
        is made (on the ``meta`` device, until ``initialize``) when it
        does not exist yet.  A ``grad_stype="row_sparse"`` asked of an
        existing parameter types its gradient row-sparse."""
        full = self._prefix + name
        if full in self._params:
            param = self._params[full]
            if grad_stype == "row_sparse":
                param.grad_stype = grad_stype
            return param
        owner = self._owner() if self._owner is not None else None
        if owner is None:
            raise MXNetError(f"no Parameter {full!r}, and this dict belongs "
                             "to no block that could make it")
        if shape is None or any(int(s) < 0 for s in shape) or (
                0 in tuple(shape) and not allow_deferred_init):
            raise MXNetError(f"Parameter {full!r}: shape {shape} is not "
                             "fully known and allow_deferred_init is off")
        p = initializer.param(*shape, init=init, dtype=torch_dtype(dtype),
                              requires_grad=grad_req != "null")
        owner.register_parameter(name, p)
        param = owner._gluon_param(name)
        param.grad_req = grad_req
        param.grad_stype = grad_stype
        return param

    def get_constant(self, name, value=None):
        """The constant ``prefix + name``; on a block's own ``params`` it
        is made from ``value`` when it does not exist yet."""
        full = self._prefix + name
        if full in self._params:
            return self._params[full]
        owner = self._owner() if self._owner is not None else None
        if owner is None or value is None:
            raise MXNetError(f"no Constant {full!r}, and "
                             + ("no value to make it from" if value is None
                                else "this dict belongs to no block that "
                                "could make it"))
        value = _constant_value(value)
        owner.register_parameter(name, _constant_tensor(value))
        const = owner._gluon_params[name] = Constant(full, value,
                                                     _block=owner,
                                                     _attr=name)
        return const

    def zero_grad(self):
        for p in self.values():
            p.zero_grad()

    def setattr(self, name, value):
        for p in self.values():
            setattr(p, name, value)
