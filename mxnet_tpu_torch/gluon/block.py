"""``Block`` and ``HybridBlock``: ``nn.Module``s with the reference's
gluon surface.

* **Names.**  Every Block gets the reference's prefix: its class name,
  lowercased, numbered per scope (``dense0_``), and inside a parent's
  ``name_scope()`` prefixed by the parent's (``hybridsequential0_dense0_``).
  ``collect_params()`` returns a ``ParameterDict`` of the block's and its
  children's parameters under those names (``gluon/parameter.py``).
* **Sharing.**  ``params=`` (another block's ``params`` or
  ``collect_params()``) names this block's parameters, and those of the
  children made in its ``name_scope()``, after that dict's prefix, as the
  reference does; a parameter whose name the dict holds is not made
  again: the block reads the owner's tensor (one tensor, so a gradient
  sums over both uses and an update moves both), and its gluon
  ``Parameter`` is the owner's.  The owner's ``initialize`` places and
  fills it; ``parameters()`` yields it once.
* **Initialization.**  Layers make their parameters on the ``meta``
  device (no memory); ``initialize(init, ctx=...)`` places the whole tree
  on the context's device and fills it there from a seeded generator, so
  a large model is drawn on the card directly.  A parameter whose shape
  has a 0 in it (``in_units=0``, ``in_channels=0``) is deferred: at the
  block's first call its ``infer_shape`` completes the shape from the
  input, and the parameter is made and filled then, with the
  initializer and generator ``initialize`` was given.
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
* **HybridBlock.**  ``hybridize()`` gives the block a :class:`CachedOp`:
  its outermost calls run as CUDA-graph replays, one a call (see
  :class:`CachedOp`).  Called inside another captured step
  (``DataParallelTrainer(fuse_step=True)``, ``Trainer.compile_step``,
  a serving dispatch), during its capture or its eager warm-up, a
  hybridized block runs inline, as the reference inlines a CachedOp
  into the program it traces.  A subclass may write
  ``hybrid_forward(F, x, **params)`` on NDArrays, as in the reference
  (``F`` is ``mx.nd``).
"""
from __future__ import annotations

import contextlib
import functools
import math
import re
import threading

import torch
from torch import nn
from torch.nn.parameter import UninitializedParameter

from .. import _capture, autograd, initializer
from ..base import MXNetError
from ..context import current_context
from ..ndarray.ndarray import NDArray, _ctx_of
from .parameter import _REPLICATED, Parameter, ParameterDict

__all__ = ["Block", "HybridBlock", "CachedOp", "inline_calls"]

_naming = threading.local()
_mode = threading.local()


@contextlib.contextmanager
def inline_calls():
    """Blocks called inside run as plain modules, as inside another
    block's call: no CachedOp of their own, in predict mode (or the
    enclosing call's mode), with the caller's grad mode.  For a model's
    tensor methods that call its blocks one by one (the Llama serving
    methods ``prefill`` and ``decode_step``)."""
    prev = getattr(_mode, "training", None)
    if prev is None:
        _mode.training = False
    try:
        yield
    finally:
        _mode.training = prev


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
        self._empty_prefix = prefix == ""
        current = getattr(_naming, "current", None)
        self._prefix = _BlockScope.create(prefix, self._alias())
        # the prefix of this block's parameter names and the dict of
        # shared parameters (params=), as the reference's _BlockScope
        if params is not None:
            self._param_prefix, self._shared = params.prefix, params
        elif current is not None:
            parent = current._block
            self._param_prefix = parent._param_prefix + \
                self._prefix[len(parent.prefix):]
            self._shared = parent._shared
        else:
            self._param_prefix, self._shared = self._prefix, None
        self._name = self._prefix[:-1] if self._prefix.endswith("_") \
            else self._prefix
        self._scope = _BlockScope(self)
        self._gluon_params = {}
        self._shared_attrs = {}

    def _alias(self):
        return self.__class__.__name__.lower()

    def _share(self, attr, param, made):
        """Read ``param`` (another block's) as this block's ``attr`` in
        place of ``made``, the tensor the layer made for it."""
        want = made.mx_shape if isinstance(made, UninitializedParameter) \
            else tuple(made.shape)
        have = param.shape
        if len(want) != len(have) or any(
                w not in (0, h) and h != 0 for w, h in zip(want, have)):
            raise MXNetError(f"cannot share Parameter {param.name!r} of "
                             f"shape {have} as {attr!r} of shape {want}")
        self._shared_attrs[attr] = param

    def __getattr__(self, name):
        """A parameter attribute is its gluon ``Parameter`` (``None`` for
        a parameter the layer does not have, a bias without a bias), as
        in the reference; :meth:`_tensor` is its tensor."""
        d = self.__dict__
        shared = d.get("_shared_attrs")
        if shared and name in shared:
            return shared[name]
        params = d.get("_parameters")
        if params is not None and name in params:
            return None if params[name] is None else self._gluon_param(name)
        return super().__getattr__(name)

    def _tensor(self, attr):
        """The tensor of parameter ``attr`` (the one ``nn.Module`` holds,
        or the sharing block's), or ``None`` where the layer has none:
        what a ``forward`` computes with."""
        params = self.__dict__["_parameters"]
        if attr in params:
            reps = self.__dict__.get("_mx_replicas")
            if reps and attr in reps:
                # a parameter on several contexts: this call's copy
                ctx = getattr(_mode, "ctx", None)
                copy = reps[attr][1].get(ctx) if ctx is not None else None
                if copy is not None:
                    return copy
            return params[attr]
        shared = self._shared_attrs.get(attr)
        if shared is not None:
            return shared._block()._tensor(shared._attr)
        if attr in self.__dict__ and self.__dict__[attr] is None:
            return None                # ``self.bias = None``: no bias
        raise AttributeError(f"{type(self).__name__} has no parameter "
                             f"{attr!r}")

    def _param_attrs(self):
        """This block's parameter attributes: its own, then those it
        shares from another block."""
        return (*self._parameters, *self._shared_attrs)

    def named_parameters(self, prefix="", recurse=True,
                         remove_duplicate=True):
        """``nn.Module``'s, then the tensors this block and the blocks
        below it share from others (``params=``), each tensor once."""
        seen = set()
        for name, p in super().named_parameters(prefix, recurse,
                                                remove_duplicate):
            seen.add(id(p))
            yield name, p
        mods = self.named_modules(prefix=prefix) if recurse \
            else [(prefix, self)]
        for mname, m in mods:
            for attr, param in getattr(m, "_shared_attrs", {}).items():
                t = param._tensor
                if id(t) not in seen:
                    seen.add(id(t))
                    yield (f"{mname}." if mname else "") + attr, t

    def cast(self, dtype):
        """Cast every parameter of this block and its children to
        ``dtype`` (parity: ``Block.cast``); a hybridized block captures
        again."""
        for child in self._child_blocks():
            child.cast(dtype)
        for attr in self._parameters:
            self._gluon_param(attr).cast(dtype)

    def __setattr__(self, name, value):
        shared = self.__dict__.get("_shared")
        if shared is not None and isinstance(value, nn.Parameter) and \
                self._param_prefix + name in shared:
            self._share(name, shared[self._param_prefix + name], value)
            return
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
        shared = self._shared_attrs.get(attr)
        if shared is not None:
            return shared
        p = self._gluon_params.get(attr)
        if p is None:
            p = self._gluon_params[attr] = Parameter._of(self, attr)
        return p

    def register_child(self, block, name=None):
        """Make ``block`` a child under ``name`` (default: its position),
        as assigning it to an attribute does."""
        self.add_module(str(len(self._modules)) if name is None else name,
                        block)

    def _child_blocks(self):
        for _, child in self._named_child_blocks():
            yield child

    def _named_child_blocks(self, module=None, path=""):
        """(name, block) of the child Blocks, a name being the attribute
        path through any plain modules between them."""
        module = self if module is None else module
        for name, child in module.named_children():
            if isinstance(child, Block):
                yield path + name, child
            else:
                yield from self._named_child_blocks(child,
                                                    f"{path}{name}.")

    @property
    def params(self) -> ParameterDict:
        """This block's own parameters (not its children's), those it
        shares included."""
        ret = ParameterDict(self._param_prefix, owner=self)
        for attr in self._param_attrs():
            p = self._gluon_param(attr)
            ret._params[p.name] = p
        return ret

    def collect_params(self, select=None) -> ParameterDict:
        """This block's and its children's parameters, by name;
        ``select`` is a regex the names must match."""
        ret = ParameterDict(self._param_prefix)
        pattern = re.compile(select) if select else None
        for name, p in self.params.items():
            if pattern is None or pattern.match(name):
                ret._params[name] = p
        for child in self._child_blocks():
            ret.update(child.collect_params(select=select))
        return ret

    def zero_grad(self):
        self.collect_params().zero_grad()

    def reset_ctx(self, ctx):
        """Move every parameter to ``ctx`` (a deferred one is made there
        at the first call)."""
        self.collect_params().reset_ctx(ctx)

    def register_forward_pre_hook(self, hook, **kwargs):
        """``hook(block, inputs)`` before each call, the inputs as the
        block's ``forward`` gets them (tensors); the handle's
        ``detach()`` removes it, as the reference's."""
        return _HookHandle(super().register_forward_pre_hook(hook, **kwargs))

    def register_forward_hook(self, hook, **kwargs):
        """``hook(block, inputs, output)`` after each call; the handle's
        ``detach()`` removes it."""
        return _HookHandle(super().register_forward_hook(hook, **kwargs))

    def summary(self, *inputs):
        """Print each block's output shapes and parameter count for a
        call with ``inputs``, as the reference's ``summary``."""
        rows, hooks = {}, []

        def register(block):
            if not isinstance(block, Block):
                return

            def hook(blk, _, outputs):
                outs = outputs if isinstance(outputs, (list, tuple)) \
                    else [outputs]
                rows[f"{blk.__class__.__name__}-{len(rows) + 1}"] = (
                    tuple(tuple(getattr(o, "shape", ())) for o in outs),
                    sum(math.prod(p.shape) for p in blk.params.values()
                        if p.shape))
            hooks.append(block.register_forward_hook(hook))

        self.apply(register)
        try:
            self(*inputs)
            print(f"{'Layer':<30}{'Output Shape':<30}{'Params':<15}")
            print("-" * 75)
            for key, (shapes, nparams) in rows.items():
                print(f"{key:<30}{str(shapes):<30}{nparams:<15}")
            print("-" * 75)
            print(f"Total params: {sum(n for _, n in rows.values())}")
        finally:
            for h in hooks:
                h.detach()

    # -- saving and loading --------------------------------------------------
    def _collect_params_with_prefix(self, prefix=""):
        """{attribute path: Parameter}: ``"0.weight"``, ``"encoder.weight"``,
        the reference's keys of a ``.params`` file."""
        if prefix:
            prefix += "."
        ret = {prefix + attr: self._gluon_param(attr)
               for attr in self._param_attrs()}
        for name, child in self._named_child_blocks():
            ret.update(child._collect_params_with_prefix(prefix + name))
        return ret

    def save_parameters(self, filename, deduplicate=False):
        """Every parameter, keyed by its attribute path, in ``nd.save``'s
        file (the JAX package's bytes for the same weights)."""
        from .. import ndarray as nd
        arg_dict, seen = {}, set()
        for key, param in self._collect_params_with_prefix().items():
            if deduplicate and id(param) in seen:
                continue
            seen.add(id(param))
            arg_dict[key] = param.data()
        nd.save(filename, arg_dict)

    def load_parameters(self, filename, ctx=None, allow_missing=False,
                        ignore_extra=False, cast_dtype=False,
                        dtype_source="current"):
        """Load a ``save_parameters`` file (the port's, the JAX package's,
        or the reference's dmlc file, whose ``arg:``/``aux:`` prefixes go),
        keyed by attribute path or by full parameter name.  A parameter
        not placed yet is made on ``ctx`` (default: the current context)
        from the file; a placed one takes the values in place."""
        from ..ndarray.ndarray import _load_numpy
        with open(filename, "rb") as f:
            loaded = _load_numpy(f, filename)
        if not isinstance(loaded, dict):
            raise MXNetError(f"file {filename!r} holds an unnamed NDArray "
                             "list, not named parameters")
        loaded = {(k[4:] if k.startswith(("arg:", "aux:")) else k): v
                  for k, v in loaded.items()}
        params = self._collect_params_with_prefix()
        if not loaded and not params:
            return
        by_name = {p.name: p for p in self.collect_params().values()}
        if any(k in by_name and k not in params for k in loaded) or (
                not any("." in k for k in loaded)
                and any("." in k for k in params)):
            # saved under full parameter names
            targets = by_name
        else:
            targets = params
            if not allow_missing:
                for name in params:
                    if name not in loaded:
                        raise MXNetError(
                            f"Parameter {name!r} is missing in file "
                            f"{filename!r}, which contains parameters: "
                            f"{sorted(loaded)[:10]}")
        for name, value in loaded.items():
            if name not in targets:
                if not ignore_extra:
                    raise MXNetError(f"Parameter {name!r} loaded from file "
                                     f"{filename!r} is not present in this "
                                     "Block")
                continue
            targets[name]._load_init(value, ctx, cast_dtype=cast_dtype)

    # -- initialization ------------------------------------------------------
    def initialize(self, init=None, ctx=None, seed=None):
        """Place every parameter on ``ctx`` (default: the current context,
        ``gpu(0)``, which raises without a card) and fill it: a
        parameter's own initializer, else ``init`` (default ``Uniform()``)
        by name.  Draws come from ``seed``, or from the device's
        ``mx.random`` generator when None.  A deferred parameter is made
        and filled at the first call.  With a list of contexts every
        parameter keeps a copy on each (``Parameter.list_ctx``).  Returns
        ``self``."""
        from .. import random as _random
        ctxs = list(ctx) if isinstance(ctx, (list, tuple)) else None
        if ctxs is not None:
            ctx = ctxs[0]
        dev = (ctx or current_context()).device
        # this tree's own tensors: a shared one is its owner's to place
        own = {n: p.mx_init for n, p in nn.Module.named_parameters(self)
               if getattr(p, "mx_init", None) is not None}
        deferred = [(m, n, p) for m in self.modules()
                    for n, p in m._parameters.items()
                    if isinstance(p, UninitializedParameter)]
        for m, n, _ in deferred:         # to_empty cannot take them
            m._parameters[n] = None
        try:
            self.to_empty(device=dev)
        finally:
            for m, n, p in deferred:
                m._parameters[n] = p
        for name, p in nn.Module.named_parameters(self):
            if name in own:
                p.mx_init = own[name]
        if seed is None:
            gen = _random.generator(dev)
        else:
            gen = torch.Generator(device=dev)
            gen.manual_seed(int(seed))
        # the initializer sees each parameter's gluon name, as in the
        # reference (Mixed matches on it)
        names = {id(p._tensor): p.name
                 for p in self.collect_params().values()}
        initializer.fill(self, init, gen, names)
        for _, _, p in deferred:
            p.mx_deferred = (init, dev, gen)
            p.mx_ctxs = ctxs if ctxs and len(ctxs) > 1 else None
        for p in self.collect_params().values():
            if not p._deferred:
                p.data()
                p._place_replicas(ctxs or [])
        return self

    def infer_shape(self, *args):
        """Complete the deferred parameter shapes from the first call's
        input tensors (layers with deferred parameters override it)."""
        raise MXNetError(
            f"Cannot infer shapes of deferred-initialized parameters for "
            f"{self.name!r}: layer does not implement infer_shape(). "
            "Specify in_units/in_channels explicitly.")

    def _finish_deferred(self, args):
        """The first call with deferred parameters: infer their shapes
        from ``args`` and make them."""
        self.infer_shape(*[_unwrap(a) for a in args])
        for attr, p in self._parameters.items():
            if isinstance(p, UninitializedParameter):
                self._gluon_param(attr)._finish_deferred_init()

    # -- calls ---------------------------------------------------------------
    def _training_mode(self) -> bool:
        """Training mode for this call: ``autograd.is_training()`` inside
        a call with NDArrays, else ``nn.Module.training``."""
        override = getattr(_mode, "training", None)
        return self.training if override is None else override

    def __call__(self, *args, **kwargs):
        if any(isinstance(p, UninitializedParameter)
               for p in self._parameters.values()):
            self._finish_deferred(args)
        nested = getattr(_mode, "training", None) is not None
        nds = [a for a in (*args, *kwargs.values()) if isinstance(a, NDArray)]
        if not nds:
            if nested:
                return super().__call__(*args, **kwargs)
            return self._outermost(self.training, torch.is_grad_enabled(),
                                   args, kwargs)
        ctx = nds[0].context
        tensors = [_unwrap(a) for a in args]
        kwargs = {k: _unwrap(v) for k, v in kwargs.items()}
        if nested:
            return _wrap(super().__call__(*tensors, **kwargs), ctx)
        recording = autograd.is_recording()
        if recording:
            autograd._mark_inputs([t for t in (*tensors, *kwargs.values())
                                   if isinstance(t, torch.Tensor)])
        _mode.ctx = ctx
        try:
            return _wrap(self._outermost(autograd.is_training(), recording,
                                         tensors, kwargs), ctx)
        finally:
            _mode.ctx = None

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
        """Passed down to the children (a HybridBlock among them runs
        its outermost calls as graph replays)."""
        for child in self._child_blocks():
            child.hybridize(active, **kwargs)


class _HookHandle:
    """A hook's handle: ``detach()`` (the reference's name) or
    ``remove()`` takes the hook off."""

    def __init__(self, handle):
        self._handle = handle

    def detach(self):
        self._handle.remove()

    remove = detach


class HybridBlock(Block):
    """A block that may be hybridized: after ``hybridize()`` its
    outermost calls go through a :class:`CachedOp`."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._active = False
        self._cached_op = None

    def hybridize(self, active=True, static_alloc=False, static_shape=False,
                  **kwargs):
        """Turn the captured calls on (or off with ``active=False``) for
        this block and its children.  ``static_alloc`` and
        ``static_shape`` are accepted: a captured graph has both."""
        self._active = bool(active)
        self._cached_op = None
        super().hybridize(active, static_alloc=static_alloc,
                          static_shape=static_shape, **kwargs)

    def cast(self, dtype):
        self._cached_op = None
        super().cast(dtype)

    def _outermost(self, training, grad, args, kwargs):
        if not self._active or _capture.in_body() or (_REPLICATED and any(
                m in _REPLICATED for m in self.modules())):
            # a graph holds one copy of each parameter: a block on
            # several contexts runs inline
            return super()._outermost(training, grad, args, kwargs)
        if self._cached_op is None:
            self._cached_op = CachedOp(self)
        return self._cached_op(training, grad, args, kwargs)

    def infer_type(self, *args):
        """Types need no inference here: a parameter has its type from
        construction or ``cast`` (the reference's is a no-op too)."""

    def forward(self, *args):
        """Runs ``hybrid_forward(mx.nd, *inputs, **params)`` on NDArrays
        over the input tensors and the parameters.  An input that takes
        no gradient goes in as an alias of its storage, so a recording op
        marks the alias and never the caller's tensor."""
        from .. import ndarray as nd
        t = next((a for a in args if isinstance(a, torch.Tensor)), None)
        ctx = _ctx_of(t.device) if t is not None else None
        call_ctx = getattr(_mode, "ctx", None)
        params = {attr: self._gluon_param(attr).data(
            call_ctx if self._gluon_param(attr)._replicas() else None)
                  for attr in self._param_attrs()}
        inputs = [a.detach() if isinstance(a, torch.Tensor)
                  and not a.requires_grad else a for a in args]
        out = self.hybrid_forward(nd, *_wrap(inputs, ctx), **params)
        return _unwrap(out)

    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError


_TENSOR = object()       # an input position that holds a tensor


def _flatten(out):
    """(tensors, tree) of a block's output: a tensor, or tuples and
    lists of them."""
    if isinstance(out, torch.Tensor):
        return [out], None
    if isinstance(out, (tuple, list)):
        leaves, trees = [], []
        for o in out:
            sub, tree = _flatten(o)
            leaves += sub
            trees.append((len(sub), tree))
        return leaves, (type(out), trees)
    raise MXNetError(f"a hybridized block returned {type(out).__name__}; "
                     "it may return tensors and tuples or lists of them")


def _unflatten(tree, leaves):
    if tree is None:
        return leaves[0]
    kind, trees = tree
    out, i = [], 0
    for n, sub in trees:
        out.append(_unflatten(sub, leaves[i:i + n]))
        i += n
    return kind(out)


class CachedOp:
    """The captured calls of a hybridized block, as the reference's
    CachedOp (``gluon/block.py:476-613``) caches one compiled program a
    key.

    One entry, a ``_capture.StepCapture``, for each key: the input
    tensors' shapes, dtypes and devices (and, recording, whether they
    require a gradient), the non-tensor arguments, the training mode, whether the
    call records (``autograd.record()``, or PyTorch's grad mode for a
    call with tensors) and the AMP type.  On the card an entry's first
    call runs eagerly, its second is captured and every later call is
    one graph replay; a recorded call replays a forward graph and, at
    ``backward``, a backward graph (see ``_capture``).  The parameters'
    storage, dtypes, shapes and ``requires_grad`` are the entry's static
    key: ``initialize`` or a ``cast`` that puts new tensors in place
    captures again, while ``set_data`` (a copy into the same storage) is
    read by the next replay.  Updates a training-mode call makes in
    place (BatchNorm's running statistics) are replayed with it.  A
    replay's outputs are the graph's own buffers, so the caller gets
    copies, which a later call leaves alone.  On the CPU the block runs
    as it is.  A call with keyword arguments, or one whose block still
    has deferred parameters (the first call), runs inline."""

    def __init__(self, block):
        self.block = block
        self.name = f"cachedop_{block.name}"
        self._entries = {}
        self._trees = {}

    @property
    def captures(self):
        return sum(c.captures for c in self._entries.values())

    @property
    def replays(self):
        return sum(c.replays for c in self._entries.values())

    @property
    def backward_replays(self):
        return sum(c.backward_replays for c in self._entries.values())

    @property
    def pool_bytes(self):
        return sum(c.pool_bytes for c in self._entries.values())

    def __len__(self):
        return len(self._entries)

    def __call__(self, training, grad, args, kwargs):
        from ..contrib import amp
        block = self.block
        params = list(block.parameters())
        consts = tuple(_TENSOR if isinstance(a, torch.Tensor) else a
                       for a in args)
        try:
            hash(consts)
        except TypeError:
            consts = None
        if kwargs or consts is None or _TENSOR not in consts or any(
                isinstance(p, UninitializedParameter) for p in params):
            return Block._outermost(block, training, grad, args, kwargs)
        tensors = [a for a in args if isinstance(a, torch.Tensor)]
        key = (tuple((tuple(t.shape), t.dtype, t.device,
                      grad and t.requires_grad) for t in tensors),
               consts, training, grad, amp.target_dtype())
        cap = self._entries.get(key)
        if cap is None:
            cap = self._entries[key] = _capture.StepCapture(self.name)
        static = tuple((t.data_ptr(), t.dtype, tuple(t.shape),
                        t.requires_grad)
                       for t in (*params, *block.buffers()))
        outs = cap.run(functools.partial(self._body, key), tensors, static,
                       params=params if grad else None)
        if not grad:
            # a replay's outputs are the graph's buffers
            outs = [o.clone() for o in outs]
        return _unflatten(self._trees[key], outs)

    def _body(self, key, *tensors):
        _, consts, training, grad, _ = key
        it = iter(tensors)
        args = [next(it) if c is _TENSOR else c for c in consts]
        leaves, self._trees[key] = _flatten(
            Block._outermost(self.block, training, grad, args, {}))
        return tuple(leaves)
