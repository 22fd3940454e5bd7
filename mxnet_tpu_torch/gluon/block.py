"""``Block`` and ``HybridBlock``: ``nn.Module``s with the reference's
gluon surface.

* **Names.**  Every Block gets the reference's prefix: its class name,
  lowercased, numbered per scope (``dense0_``), and inside a parent's
  ``name_scope()`` prefixed by the parent's (``hybridsequential0_dense0_``).
  ``collect_params()`` returns a ``ParameterDict`` of the block's and its
  children's parameters under those names (``gluon/parameter.py``).
* **Initialization.**  Layers make their parameters on the ``meta``
  device (no memory); ``initialize(init, ctx=...)`` places the whole tree
  on the context's device and fills it there from a seeded generator, so
  a large model is drawn on the card directly.
* **Calls.**  Called with ``torch.Tensor``s, a Block is a plain module
  (the BERT and serving paths): it records as PyTorch's grad mode says,
  and its training mode (for Dropout) is ``nn.Module.training``.  Called
  with NDArrays, it runs the same ``forward`` on their tensors and
  returns NDArrays: it records for autograd only inside
  ``autograd.record()``, and its training mode is
  ``autograd.is_training()``.  Either way the outermost call sets the
  modes for everything it reaches: a block called inside another one's
  call, with tensors or NDArrays (a ``hybrid_forward`` over the outer
  call's tensors), inherits the outer call's grad and training mode, and
  so do the ``mx.nd`` ops it runs.
* **HybridBlock.**  ``hybridize()`` is accepted and the block runs
  eagerly: the captured-graph CachedOp is not ported (ROADMAP queue 1
  item 4).  A subclass may write ``hybrid_forward(F, x, **params)`` on
  NDArrays, as in the reference (``F`` is ``mx.nd``).
"""
from __future__ import annotations

import re
import threading

import torch
from torch import nn

from .. import autograd, initializer
from ..base import MXNetError
from ..context import current_context
from ..ndarray.ndarray import NDArray, _ctx_of
from .parameter import Parameter, ParameterDict

__all__ = ["Block", "HybridBlock"]

_naming = threading.local()
_mode = threading.local()


class _BlockScope:
    """Name manager: gives blocks unique prefixes (parity: _BlockScope)."""

    _counters = {}

    def __init__(self, block):
        self._block = block
        self._counter = {}
        self._old_scope = None

    @staticmethod
    def create(prefix, hint):
        current = getattr(_naming, "current", None)
        if current is None:
            if prefix is None:
                count = _BlockScope._counters.setdefault(hint, 0)
                prefix = f"{hint}{count}_"
                _BlockScope._counters[hint] += 1
            return prefix
        if prefix is None:
            count = current._counter.setdefault(hint, 0)
            prefix = f"{hint}{count}_"
            current._counter[hint] += 1
        return current._block.prefix + prefix

    def __enter__(self):
        if self._block._empty_prefix:
            return self
        self._old_scope = getattr(_naming, "current", None)
        _naming.current = self
        return self

    def __exit__(self, *exc):
        if self._block._empty_prefix:
            return
        _naming.current = self._old_scope


def _wrap(out, ctx):
    """Tensors in ``out`` (nested in tuples and lists) as NDArrays."""
    if isinstance(out, torch.Tensor):
        return NDArray(out, ctx=ctx)
    if isinstance(out, (tuple, list)):
        return type(out)(_wrap(o, ctx) for o in out)
    return out


def _unwrap(out):
    if isinstance(out, NDArray):
        return out._t
    if isinstance(out, (tuple, list)):
        return type(out)(_unwrap(o) for o in out)
    return out


class Block(nn.Module):
    """Base of the port's gluon layers and models."""

    def __init__(self, prefix=None, params=None):
        super().__init__()
        if params is not None:
            raise MXNetError("sharing parameters through params= is not "
                             "ported")
        self._empty_prefix = prefix == ""
        self._prefix = _BlockScope.create(prefix, self._alias())
        self._name = self._prefix[:-1] if self._prefix.endswith("_") \
            else self._prefix
        self._scope = _BlockScope(self)
        self._gluon_params = {}

    def _alias(self):
        return self.__class__.__name__.lower()

    def __setattr__(self, name, value):
        if isinstance(value, Parameter):
            # ``self.w = self.params.get("w", ...)``: ``get`` registered
            # the tensor under ``name`` already
            if value._block() is not self or value._attr != name:
                raise MXNetError(f"assign a block's own Parameter under its "
                                 f"own name ({value._attr!r}), not "
                                 f"{name!r}")
            return
        super().__setattr__(name, value)

    # -- names and parameters ------------------------------------------------
    @property
    def prefix(self):
        return self._prefix

    @property
    def name(self):
        return self._name

    def name_scope(self):
        """``with block.name_scope():`` — children made inside get this
        block's prefix in front of theirs."""
        return self._scope

    def _gluon_param(self, attr) -> Parameter:
        p = self._gluon_params.get(attr)
        if p is None:
            p = self._gluon_params[attr] = Parameter(self, attr)
        return p

    def _child_blocks(self, module=None):
        for child in (module or self).children():
            if isinstance(child, Block):
                yield child
            else:
                yield from self._child_blocks(child)

    @property
    def params(self) -> ParameterDict:
        """This block's own parameters (not its children's)."""
        ret = ParameterDict(self._prefix, owner=self)
        for attr in self._parameters:
            p = self._gluon_param(attr)
            ret._params[p.name] = p
        return ret

    def collect_params(self, select=None) -> ParameterDict:
        """This block's and its children's parameters, by name;
        ``select`` is a regex the names must match."""
        ret = ParameterDict(self._prefix)
        pattern = re.compile(select) if select else None
        for name, p in self.params.items():
            if pattern is None or pattern.match(name):
                ret._params[name] = p
        for child in self._child_blocks():
            ret.update(child.collect_params(select=select))
        return ret

    def zero_grad(self):
        self.collect_params().zero_grad()

    # -- initialization ------------------------------------------------------
    def initialize(self, init=None, ctx=None, seed=None):
        """Place every parameter on ``ctx`` (default: the current context,
        ``gpu(0)``, which raises without a card) and fill it: a
        parameter's own initializer, else ``init`` (default ``Uniform()``)
        by name.  Draws come from ``seed``, or from the device's
        ``mx.random`` generator when None.  Returns ``self``."""
        from .. import random as _random
        dev = (ctx or current_context()).device
        own = {n: p.mx_init for n, p in self.named_parameters()
               if getattr(p, "mx_init", None) is not None}
        self.to_empty(device=dev)
        for name, p in self.named_parameters():
            if name in own:
                p.mx_init = own[name]
        if seed is None:
            gen = _random.generator(dev)
        else:
            gen = torch.Generator(device=dev)
            gen.manual_seed(int(seed))
        initializer.fill(self, init, gen)
        for p in self.collect_params().values():
            p.data()
        return self

    # -- calls ---------------------------------------------------------------
    def _training_mode(self) -> bool:
        """Training mode for this call: ``autograd.is_training()`` inside
        a call with NDArrays, else ``nn.Module.training``."""
        override = getattr(_mode, "training", None)
        return self.training if override is None else override

    def __call__(self, *args, **kwargs):
        nested = getattr(_mode, "training", None) is not None
        if not any(isinstance(a, NDArray) for a in args):
            if nested:
                return super().__call__(*args, **kwargs)
            return self._outermost(self.training, torch.is_grad_enabled(),
                                   args, kwargs)
        ctx = next(a for a in args if isinstance(a, NDArray)).context
        tensors = [_unwrap(a) for a in args]
        if nested:
            return _wrap(super().__call__(*tensors, **kwargs), ctx)
        recording = autograd.is_recording()
        if recording:
            autograd._mark_inputs([t for t in tensors
                                   if isinstance(t, torch.Tensor)])
        return _wrap(self._outermost(autograd.is_training(), recording,
                                     tensors, kwargs), ctx)

    def _outermost(self, training, grad, args, kwargs):
        """The outermost block call: ``training`` and ``grad`` are the
        training and grad mode of every block and ``mx.nd`` op it
        reaches."""
        _mode.training = training
        try:
            with autograd._Scope(grad, training), \
                    torch.set_grad_enabled(grad):
                return super().__call__(*args, **kwargs)
        finally:
            _mode.training = None

    def hybridize(self, active=True, **kwargs):
        """Passed down to the children; every block runs eagerly."""
        for child in self._child_blocks():
            child.hybridize(active, **kwargs)


class HybridBlock(Block):
    """A block that may be hybridized.  ``hybridize()`` is accepted and
    the block runs eagerly (no captured graph yet)."""

    def forward(self, *args):
        """Runs ``hybrid_forward(mx.nd, *inputs, **params)`` on NDArrays
        over the input tensors and the parameters.  An input that takes
        no gradient goes in as an alias of its storage, so a recording op
        marks the alias and never the caller's tensor."""
        from .. import ndarray as nd
        t = next((a for a in args if isinstance(a, torch.Tensor)), None)
        ctx = _ctx_of(t.device) if t is not None else None
        params = {attr: self._gluon_param(attr).data()
                  for attr in self._parameters}
        inputs = [a.detach() if isinstance(a, torch.Tensor)
                  and not a.requires_grad else a for a in args]
        out = self.hybrid_forward(nd, *_wrap(inputs, ctx), **params)
        return _unwrap(out)

    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError
