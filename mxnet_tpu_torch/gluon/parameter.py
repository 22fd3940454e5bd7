"""Gluon ``Parameter`` and ``ParameterDict``, as the JAX package's
``gluon/parameter.py``.

A port Block keeps its weights as ``nn.Parameter``s in ``nn.Module``'s
own storage (so the PyTorch module, its ``state_dict`` and the
tensor-level paths are unchanged).  A ``Parameter`` is the gluon view of
one of them, and the block's attribute of that name
(``dense.weight``): it is named ``block.prefix + attribute`` (the
reference's name for the same construction, e.g.
``hybridsequential0_dense0_weight``), and its ``data()`` is an NDArray
over that very tensor, so an update through either is seen by both; a
layer's ``forward`` reads the tensor with ``block._tensor(attribute)``.
``Parameter(name, shape=...)`` stands alone, as in the reference: a
small holder module keeps its tensor.  ``grad()`` is the gradient buffer
``backward`` writes (``grad_req`` ``"write"``) or adds to (``"add"``);
``"null"`` turns the tensor's gradient off.

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

``Parameter.initialize`` and ``ParameterDict.initialize`` place and fill
parameter by parameter, as the reference (``Block.initialize`` places
and fills the whole block at once).

``initialize(ctx=[c0, c1, ...])`` keeps one copy a context: the block's
tensor on ``c0`` and a replica (an ``nn.Parameter`` the block keeps in
``_mx_replicas``) on each other context, equal at the start.
``data(ctx)``/``grad(ctx)`` choose a copy, ``list_data``, ``list_grad``
and ``list_ctx`` list them, and a block called with NDArrays on context
``c`` computes with the copies on ``c`` (``Block._tensor``), so each
context's ``backward`` fills its own copy's gradient (the kvstore sums
them).  Not ported: ``Parameter.var`` (it needs ``mx.symbol``).
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

# the blocks that hold copies of a parameter on several contexts (a
# hybridized call checks its tree only while this is not empty)
_REPLICATED = weakref.WeakSet()


class DeferredInitializationError(MXNetError):
    """A parameter's data was asked for before its first call made it
    (its shape had a 0 in it)."""


class Parameter:
    """A gluon parameter: ``Parameter(name, shape=..., ...)`` stands alone
    (the reference's constructor; ``initialize`` places and fills it), and
    a block's parameter attribute is the view of that block's
    ``nn.Parameter`` (:meth:`_of`).  ``grad_req`` defaults to
    ``"write"``; a view's to ``"write"`` for a tensor that requires a
    gradient and ``"null"`` for one that does not (running statistics).
    ``differentiable=False`` fixes it at ``"null"``."""

    def __init__(self, name, grad_req="write", shape=None, dtype="float32",
                 lr_mult=1.0, wd_mult=1.0, init=None,
                 allow_deferred_init=False, differentiable=True,
                 stype="default", grad_stype="default"):
        if shape is None:
            t = UninitializedParameter(dtype=torch_dtype(dtype))
            t.mx_shape, t.mx_init = None, init
        else:
            if isinstance(shape, int):
                shape = (shape,)
            t = initializer.param(*shape, init=init, dtype=torch_dtype(dtype))
        self._holder = _Holder()           # a Parameter holds its block weakly
        self._holder.register_parameter("value", t)
        self.allow_deferred_init = allow_deferred_init
        self._setup(self._holder, "value", name, grad_req, lr_mult, wd_mult,
                    grad_stype, differentiable, stype)

    @classmethod
    def _of(cls, block, attr, grad_req=None):
        """The view of ``block``'s parameter attribute ``attr``, named
        ``block.prefix + attr``."""
        self = cls.__new__(cls)
        self.allow_deferred_init = True
        self._setup(block, attr, block._param_prefix + attr, grad_req)
        return self

    def _setup(self, block, attr, name, grad_req, lr_mult=1.0, wd_mult=1.0,
               grad_stype="default", differentiable=True, stype="default"):
        self._block = weakref.ref(block)
        self._attr = attr
        self.name = name
        self.lr_mult = lr_mult
        self.wd_mult = wd_mult
        self._differentiable = differentiable
        self._stype = stype
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
        if old is None:
            self._tensor.mx_shape = new_shape
            return
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

    @init.setter
    def init(self, init):
        self._tensor.mx_init = init

    @property
    def stype(self):
        return self._stype

    @property
    def differentiable(self):
        return self._differentiable

    # -- grad_req ------------------------------------------------------------
    @property
    def grad_req(self):
        return self._grad_req

    @grad_req.setter
    def grad_req(self, req):
        if req not in ("write", "add", "null"):
            raise MXNetError(f"grad_req must be write, add or null, got "
                             f"{req!r}")
        if not self._differentiable:
            req = "null"
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
        reps = self._replicas()
        if reps is not None and ctx is not None and ctx != reps[0][0]:
            copy = reps[1].get(ctx)
            if copy is None:
                raise MXNetError(f"Parameter {self.name!r} was not "
                                 f"initialized on context {ctx}. It was "
                                 f"only initialized on {reps[0]}.")
            return self._replica_nd(ctx, copy)
        if ctx is not None and ctx.device != t.device:
            raise MXNetError(f"Parameter {self.name!r} was not initialized "
                             f"on context {ctx}; it lives on "
                             f"{nd_.context}")
        return nd_

    def list_data(self):
        return [self.data(c) for c in self.list_ctx()]

    # -- copies on several contexts -------------------------------------------
    def _replicas(self):
        """(contexts, {context: tensor}) of a parameter placed on several
        contexts (the first context's tensor is the block's), else
        None."""
        block = self._block()
        table = block.__dict__.get("_mx_replicas") if block is not None \
            else None
        return table.get(self._attr) if table else None

    def _replica_nd(self, ctx, t):
        """The NDArray over the replica ``t`` on ``ctx``, a leaf of the
        autograd graph with its own gradient buffer."""
        cache = self.__dict__.setdefault("_rep_nds", {})
        nd_ = cache.get(ctx)
        if nd_ is None or nd_._t is not t:
            nd_ = cache[ctx] = NDArray(t, ctx=ctx)
        nd_.grad_req = self._grad_req
        if self._grad_req == "null":
            nd_._grad = None
        autograd._leaves[id(nd_)] = nd_
        return nd_

    def _place_replicas(self, ctxs):
        """Copies of the placed tensor on ``ctxs[1:]`` (none for one
        context)."""
        block = self._block()
        table = block.__dict__.setdefault("_mx_replicas", {})
        self.__dict__.pop("_rep_nds", None)
        if len(ctxs) <= 1:
            table.pop(self._attr, None)
            if not table:
                _REPLICATED.discard(block)
            return
        _REPLICATED.add(block)
        t = self._tensor
        copies = OrderedDict(
            (c, nn.Parameter(t.detach().to(c.device, copy=True),
                             requires_grad=t.requires_grad))
            for c in ctxs[1:])
        table[self._attr] = (list(ctxs), copies)
        for c, copy in copies.items():
            self._replica_nd(c, copy)

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
        return [self.grad(c) for c in self.list_ctx()]

    def list_ctx(self):
        reps = self._replicas()
        if reps is not None:
            return list(reps[0])
        deferred = getattr(self._tensor, "mx_deferred", None)
        if deferred is not None:
            ctxs = getattr(self._tensor, "mx_ctxs", None)
            return list(ctxs) if ctxs else [_ctx_of(deferred[1])]
        return [self.data().context]

    def _finish_deferred_init(self):
        """Make a deferred parameter whose shape is now complete, on the
        device ``initialize`` named, and fill it with its initializer
        (the reference's ``_finish_deferred_init``)."""
        t = self._tensor
        if not isinstance(t, UninitializedParameter):
            return
        if t.mx_shape is None or 0 in t.mx_shape:
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
        ctxs = getattr(t, "mx_ctxs", None)
        t.materialize(t.mx_shape, device=device)
        del t.mx_deferred
        _fill(self.name, t, init, generator)
        self._bind(t)          # a leaf that backward writes gradients for
        if ctxs:
            self._place_replicas(ctxs)

    def _replace(self, new):
        """Put the tensor ``new`` in the parameter's place (its
        initializer kept) and bind it."""
        t = self._tensor
        if getattr(t, "mx_init", None) is not None:
            new.mx_init = t.mx_init
        self._block()._parameters[self._attr] = new
        if self._nd is not None:
            self._nd._grad = None
        self._bind(new)

    def initialize(self, init=None, ctx=None, default_init=None,
                   force_reinit=False):
        """Place the parameter on ``ctx`` (default: the current context)
        and fill it, as the reference: ``init`` if given, else its own
        initializer, else ``default_init`` (``Uniform()``) by name.  A
        placed parameter stays as it is unless ``force_reinit``; one whose
        shape is not known yet is made at the first call (or raises
        without ``allow_deferred_init``)."""
        from .. import random as _random
        from ..context import current_context
        t = self._tensor
        placed = not t.is_meta and not isinstance(t, UninitializedParameter)
        if (placed or getattr(t, "mx_deferred", None) is not None) \
                and not force_reinit:
            return
        ctxs = list(ctx) if isinstance(ctx, (list, tuple)) else None
        if ctxs is not None:
            if not ctxs:
                raise MXNetError(f"Parameter {self.name!r}: no context")
            ctx = ctxs[0]
        dev = (ctx or current_context()).device
        if default_init is None:
            default_init = initializer.Uniform()
        chosen = default_init if init is None else _Explicit(init)
        gen = _random.generator(dev)
        shape = self.shape
        if shape is None or 0 in shape:      # made at the first call
            if not self.allow_deferred_init:
                raise MXNetError(f"Cannot initialize Parameter {self.name!r} "
                                 f"because it has invalid shape: {shape}.")
            t.mx_deferred = (chosen, dev, gen)
            t.mx_ctxs = ctxs if ctxs and len(ctxs) > 1 else None
            return
        new = nn.Parameter(torch.empty(shape, dtype=t.dtype, device=dev),
                           requires_grad=t.requires_grad)
        new.mx_init = getattr(t, "mx_init", None)
        _fill(self.name, new, chosen, gen)
        self._replace(new)
        self._place_replicas(ctxs or [])

    def reset_ctx(self, ctx):
        """Move the parameter to ``ctx`` (its values kept); a deferred
        one is made there at the first call.  A list of contexts keeps a
        copy on each."""
        ctxs = list(ctx) if isinstance(ctx, (list, tuple)) else [ctx]
        ctx = ctxs[0]
        t = self._tensor
        deferred = getattr(t, "mx_deferred", None)
        if deferred is not None:
            t.mx_deferred = (deferred[0], ctx.device, deferred[2])
            t.mx_ctxs = ctxs if len(ctxs) > 1 else None
            return
        if t.is_meta or isinstance(t, UninitializedParameter):
            raise MXNetError(f"Cannot reset context for Parameter "
                             f"{self.name!r} because it has not been "
                             "initialized.")
        if t.device != torch.device(ctx.device):
            self._replace(nn.Parameter(t.detach().to(ctx.device),
                                       requires_grad=t.requires_grad))
        self._place_replicas(ctxs)

    def var(self):
        """The symbol variable of the parameter: ``mx.symbol`` is not
        ported yet (ROADMAP queue 1 item 8)."""
        raise NotImplementedError(
            f"Parameter.var ({self.name!r}) needs mx.symbol, which the "
            "port does not have yet (ROADMAP queue 1 item 8)")

    def zero_grad(self):
        """Zero the gradient buffers in place (one a context)."""
        if self._grad_req == "null":
            return
        for nd_ in (self._nd, *self.__dict__.get("_rep_nds", {}).values()):
            if nd_ is not None and nd_._grad is not None:
                nd_._grad._t.zero_()

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
            reps = self._replicas()
            for copy in (reps[1].values() if reps else ()):
                copy.copy_(src)


class _Explicit:
    """An initializer given to ``Parameter.initialize`` itself: it wins
    over the parameter's own, without the dispatch by name."""

    def __init__(self, init):
        self.init = initializer.create(init)


def _fill(name, t, init, generator):
    """Fill ``t`` in place: an explicit initializer, else the tensor's
    own, else ``init`` by name."""
    if isinstance(init, _Explicit):
        with torch.no_grad():
            init.init.init_weight(name, t, generator)
    else:
        initializer.fill_one(name, t, init, generator)


class _Holder(nn.Module):
    """The module that holds a standalone Parameter's or Constant's
    tensor."""

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
        self.allow_deferred_init = False
        self._setup(_block, _attr, name, "null", differentiable=False)

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
        """Place the constant on ``ctx`` (default: the current context)
        with its value; ``init`` and ``default_init`` are ignored."""
        Parameter.initialize(self, None, ctx, None, force_reinit)


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

    def __init__(self, prefix="", shared=None, *, owner=None):
        self._prefix = prefix
        self._params = OrderedDict()
        self._shared = shared
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

    def _get_impl(self, full):
        if full in self._params:
            return self._params[full]
        if self._shared is not None and full in self._shared._params:
            self._params[full] = self._shared._params[full]
            return self._params[full]
        return None

    def get(self, name, shape=None, dtype="float32", init=None,
            grad_req="write", allow_deferred_init=False,
            grad_stype="default", lr_mult=1.0, wd_mult=1.0,
            differentiable=True, stype="default"):
        """The parameter ``prefix + name`` (here or in ``shared``), made
        when it does not exist yet: on a block's own ``params`` as the
        block's (on the ``meta`` device until ``initialize``), else as a
        standalone ``Parameter``.  A ``grad_stype="row_sparse"`` asked of
        an existing parameter types its gradient row-sparse."""
        full = self._prefix + name
        param = self._get_impl(full)
        if param is not None:
            if grad_stype == "row_sparse":
                param.grad_stype = grad_stype
            return param
        owner = self._owner() if self._owner is not None else None
        if owner is None:
            param = self._params[full] = Parameter(
                full, grad_req=grad_req, shape=shape, dtype=dtype,
                lr_mult=lr_mult, wd_mult=wd_mult, init=init,
                allow_deferred_init=allow_deferred_init,
                differentiable=differentiable, stype=stype,
                grad_stype=grad_stype)
            return param
        if shape is None or any(int(s) < 0 for s in shape) or (
                0 in tuple(shape) and not allow_deferred_init):
            raise MXNetError(f"Parameter {full!r}: shape {shape} is not "
                             "fully known and allow_deferred_init is off")
        p = initializer.param(*shape, init=init, dtype=torch_dtype(dtype),
                              requires_grad=grad_req != "null"
                              and differentiable)
        owner.register_parameter(name, p)
        param = owner._gluon_param(name)
        param._differentiable = differentiable
        param._stype = stype
        param.grad_req = grad_req
        param.grad_stype = grad_stype
        param.lr_mult, param.wd_mult = lr_mult, wd_mult
        return param

    def get_constant(self, name, value=None):
        """The constant ``prefix + name``; on a block's own ``params`` it
        is made from ``value`` when it does not exist yet."""
        full = self._prefix + name
        param = self._get_impl(full)
        if param is not None:
            return param
        if value is None:
            raise MXNetError(f"no Constant {full!r}, and no value to make "
                             "it from")
        owner = self._owner() if self._owner is not None else None
        if owner is None:
            param = self._params[full] = Constant(full, value)
            return param
        value = _constant_value(value)
        owner.register_parameter(name, _constant_tensor(value))
        const = owner._gluon_params[name] = Constant(full, value,
                                                     _block=owner,
                                                     _attr=name)
        return const

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False):
        """Place and fill every parameter not placed yet (all of them
        with ``force_reinit``): its own initializer, else ``init``
        (default ``Uniform()``) by name."""
        if init is None:
            init = initializer.Uniform()
        for p in self.values():
            p.initialize(None, ctx, init, force_reinit=force_reinit)

    def zero_grad(self):
        for p in self.values():
            p.zero_grad()

    def reset_ctx(self, ctx):
        for p in self.values():
            p.reset_ctx(ctx)

    def save(self, filename, strip_prefix=""):
        """``nd.save`` of the parameters by name, ``strip_prefix`` taken
        off each."""
        from .. import ndarray as nd
        arg_dict = {}
        for param in self.values():
            if not param.name.startswith(strip_prefix):
                raise MXNetError(
                    f"Prefix {strip_prefix!r} is to be striped before "
                    f"saving, but Parameter {param.name!r} does not start "
                    "with it.")
            arg_dict[param.name[len(strip_prefix):]] = param.data()
        nd.save(filename, arg_dict)

    def load(self, filename, ctx=None, allow_missing=False,
             ignore_extra=False, restore_prefix="", cast_dtype=False):
        """Load a :meth:`save` file, ``restore_prefix`` put before each
        name."""
        from ..ndarray.ndarray import _load_numpy
        with open(filename, "rb") as f:
            arg_dict = _load_numpy(f, filename)
        arg_dict = {restore_prefix + k: v for k, v in arg_dict.items()}
        if not allow_missing:
            for name in self.keys():
                if name not in arg_dict:
                    raise MXNetError(f"Parameter {name!r} is missing in "
                                     f"file {filename!r}")
        for name, data in arg_dict.items():
            if name not in self._params:
                if not ignore_extra:
                    raise MXNetError(
                        f"Parameter {name!r} loaded from file {filename!r} "
                        "is not present in this ParameterDict")
                continue
            self._params[name]._load_init(data, ctx, cast_dtype=cast_dtype)

    def setattr(self, name, value):
        for p in self.values():
            setattr(p, name, value)
