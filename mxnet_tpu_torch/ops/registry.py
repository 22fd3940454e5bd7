"""Operator registry, as the JAX package's ``ops/registry.py``.

An op is a plain function ``fcompute(*tensors, *scalars, **attrs)`` on
``torch.Tensor``s.  ``invoke`` (``ndarray/ndarray.py``) runs it; PyTorch's
autograd differentiates it while ``autograd.record()`` is on.  Every op
registered here is a function of the ``mx.nd`` namespace, generated from
the registry as the reference generates its op stubs.
"""
from __future__ import annotations

import inspect
from typing import Callable, Dict, Optional, Sequence

__all__ = ["OpDef", "register", "get_op", "list_ops", "alias",
           "validate_opdef"]


class OpDef:
    """One operator.

    Attributes:
      name: canonical op name (MXNet spelling, e.g. ``broadcast_add``).
      fcompute: function ``(*tensors, *scalars, **attrs) -> tensor | tuple``.
      num_inputs: fixed arity or None for variadic (e.g. ``concat``).
      num_outputs: number of outputs (>=2 means fcompute returns a tuple).
      scalar_attrs: names of attrs that hold numeric values (a learning
        rate, a scalar operand).  fcompute receives them as trailing
        positional arguments, as Python numbers (never copied to the
        device) or as the tensor of an NDArray the caller passed.
      scalar_ref_input: index of the tensor input whose dtype anchors the
        scalar attrs (e.g. `int_array + 1` stays int); None means no tensor
        input is an anchor.  PyTorch's rule for Python scalars already keeps
        the tensor's type, so the port only validates it.
      wrap_ctx: init-style op with no tensor inputs (zeros/ones/...);
        frontend must supply ctx/dtype.
    """

    __slots__ = ("name", "fcompute", "num_inputs", "num_outputs",
                 "scalar_attrs", "wrap_ctx", "doc", "attr_names",
                 "scalar_ref_input", "input_names", "scalar_defaults")

    def __init__(self, name: str, fcompute: Callable,
                 num_inputs: Optional[int], num_outputs: int,
                 scalar_attrs: Sequence[str], wrap_ctx: bool,
                 scalar_ref_input: Optional[int] = 0):
        self.name = name
        self.fcompute = fcompute
        self.num_inputs = num_inputs
        self.num_outputs = num_outputs
        self.scalar_attrs = tuple(scalar_attrs)
        self.scalar_ref_input = scalar_ref_input
        self.wrap_ctx = wrap_ctx
        self.doc = fcompute.__doc__ or ""
        try:
            sig = inspect.signature(fcompute)
            self.attr_names = tuple(
                p.name for p in sig.parameters.values()
                if p.kind == p.KEYWORD_ONLY)
            # positional params = tensor-input names (then scalar attrs)
            pos = [p.name for p in sig.parameters.values()
                   if p.kind in (p.POSITIONAL_ONLY,
                                 p.POSITIONAL_OR_KEYWORD)]
            n_scal = len(self.scalar_attrs)
            self.input_names = tuple(pos[:len(pos) - n_scal]) \
                if n_scal else tuple(pos)
            # signature defaults for scalar attrs: lets the frontend
            # fill OMITTED scalars positionally so a partial kwarg set
            # can never misbind (e.g. t provided but wd omitted)
            self.scalar_defaults = {
                p.name: p.default
                for p in sig.parameters.values()
                if p.name in self.scalar_attrs
                and p.default is not inspect.Parameter.empty}
        except (TypeError, ValueError):
            self.attr_names = ()
            self.input_names = ()
            self.scalar_defaults = {}


_REGISTRY: Dict[str, OpDef] = {}
_ALIASES: Dict[str, str] = {}


def _signature_facts(fcompute: Callable):
    """(positional param names, has *args, has **kwargs), or None when the
    callable defeats introspection (C builtins)."""
    try:
        sig = inspect.signature(fcompute)
    except (TypeError, ValueError):
        return None
    params = list(sig.parameters.values())
    pos = [p.name for p in params
           if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)]
    has_varpos = any(p.kind == p.VAR_POSITIONAL for p in params)
    has_varkw = any(p.kind == p.VAR_KEYWORD for p in params)
    return pos, has_varpos, has_varkw


def validate_opdef(op: OpDef):
    """Contract checks between an OpDef and its fcompute signature.

    Returns a list of ``(kind, message)`` violations (empty = valid),
    where ``kind`` is one of ``"arity"``, ``"scalar_attrs"``,
    ``"scalar_ref_input"``, ``"num_outputs"`` — a stable tag the static
    analyzer maps to its rule IDs (never dispatch on the prose).
    ``register()`` raises on any.
    """
    problems = []
    if op.num_outputs == 0 or op.num_outputs < -1:
        problems.append((
            "num_outputs",
            f"num_outputs must be >= 1 (or -1 for dynamic), got "
            f"{op.num_outputs}"))
    ns = len(op.scalar_attrs)
    if ns and op.scalar_ref_input is not None:
        if op.num_inputs is not None and not \
                (0 <= op.scalar_ref_input < op.num_inputs):
            problems.append((
                "scalar_ref_input",
                f"scalar_ref_input={op.scalar_ref_input} out of bounds "
                f"for num_inputs={op.num_inputs}"))
    facts = _signature_facts(op.fcompute)
    if facts is None:
        return problems
    pos, has_varpos, _ = facts
    if not has_varpos:
        # scalar attrs bind POSITIONALLY after the tensor inputs: the
        # trailing positional params must carry exactly these names, or
        # scalar_defaults lookup and named-input mapping silently miss
        if ns:
            trailing = tuple(pos[len(pos) - ns:]) if len(pos) >= ns else ()
            if trailing != tuple(op.scalar_attrs):
                problems.append((
                    "scalar_attrs",
                    f"scalar_attrs {tuple(op.scalar_attrs)} must name the "
                    f"trailing positional params, got {trailing}"))
        if op.num_inputs is not None and len(pos) != op.num_inputs + ns:
            problems.append((
                "arity",
                f"fcompute has {len(pos)} positional params; expected "
                f"num_inputs ({op.num_inputs}) + scalar_attrs ({ns})"))
    return problems


def register(name: str, num_inputs: Optional[int] = 1, num_outputs: int = 1,
             scalar_attrs: Sequence[str] = (), wrap_ctx: bool = False,
             scalar_ref_input: Optional[int] = 0):
    """Decorator: register ``fcompute`` as operator ``name``.

    Fails fast on contract violations (see ``validate_opdef``): a bad
    ``scalar_ref_input`` or a ``scalar_attrs`` name that does not match
    the fcompute signature would otherwise surface much later as a wrong
    value silently bound to the wrong parameter.
    """

    def deco(fn: Callable) -> Callable:
        if name in _REGISTRY:
            raise ValueError(f"op {name!r} registered twice")
        op = OpDef(name, fn, num_inputs, num_outputs,
                   scalar_attrs, wrap_ctx, scalar_ref_input)
        problems = validate_opdef(op)
        if problems:
            raise ValueError(
                f"op {name!r} registration invalid: "
                + "; ".join(msg for _, msg in problems))
        _REGISTRY[name] = op
        return fn

    return deco


def alias(new_name: str, existing: str):
    """Register a second public name for an existing op (e.g. relu)."""
    _ALIASES[new_name] = existing


def get_op(name: str) -> OpDef:
    name = _ALIASES.get(name, name)
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"operator {name!r} is not registered") from None


def list_ops():
    return sorted(set(_REGISTRY) | set(_ALIASES))
