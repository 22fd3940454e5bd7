"""Load a JAX-package Llama parameter dict into this package's module.

The JAX package names parameters by auto-numbered block prefixes, e.g.
``llamamodel0_layer3_attn_q_weight`` or ``llamaforcausallm1_head_weight``.
:func:`load_jax_params` strips the prefix and maps the structural
suffix onto the module's own names.  Dense weights are (out, in) on
both sides, so values copy over unchanged.
"""
from __future__ import annotations

import re
from typing import Dict

import numpy as np
import torch

from ..base import MXNetError

__all__ = ["load_jax_params", "jax_name_to_torch"]

_PREFIX = re.compile(r"^(?:llamamodel|llamaforcausallm)\d+_")
_RULES = [
    (re.compile(r"^embed_weight$"), "model.embed.weight"),
    (re.compile(r"^layer(\d+)_innorm_gamma$"),
     "model.layers.{0}.input_norm.gamma"),
    (re.compile(r"^layer(\d+)_postnorm_gamma$"),
     "model.layers.{0}.post_norm.gamma"),
    (re.compile(r"^layer(\d+)_attn_([qkvo])_weight$"),
     "model.layers.{0}.attn.{1}_proj.weight"),
    (re.compile(r"^layer(\d+)_mlp_(gate|up|down)_weight$"),
     "model.layers.{0}.mlp.{1}_proj.weight"),
    (re.compile(r"^finalnorm_gamma$"), "model.final_norm.gamma"),
    (re.compile(r"^head_weight$"), "lm_head.weight"),
]


def jax_name_to_torch(name: str) -> str:
    """The module's parameter name for a JAX-package parameter name."""
    suffix = _PREFIX.sub("", name, count=1)
    for pat, fmt in _RULES:
        m = pat.match(suffix)
        if m:
            return fmt.format(*m.groups())
    raise MXNetError(f"unrecognised Llama parameter name {name!r}")


@torch.no_grad()
def load_jax_params(lm, params: Dict[str, np.ndarray]):
    """Copy ``{jax_name: array}`` into ``lm`` (a ``LlamaForCausalLM``),
    cast to the module's dtype, on its device.  Raises ``MXNetError``
    on a missing, extra or wrong-shape name."""
    own = dict(lm.named_parameters())
    seen = {}
    for name, value in params.items():
        tname = jax_name_to_torch(name)
        if tname not in own:
            raise MXNetError(f"{name!r} maps to {tname!r}, which this "
                             "model does not have")
        if tname in seen:
            raise MXNetError(f"{name!r} and {seen[tname]!r} both map to "
                             f"{tname!r}")
        seen[tname] = name
        arr = np.asarray(value)
        if tuple(arr.shape) != tuple(own[tname].shape):
            raise MXNetError(
                f"{name!r}: shape {tuple(arr.shape)} does not match "
                f"{tname!r} {tuple(own[tname].shape)}")
    missing = sorted(set(own) - set(seen))
    if missing:
        raise MXNetError(f"parameters missing from the dict: {missing}")
    for tname, name in seen.items():
        p = own[tname]
        p.copy_(torch.from_numpy(np.array(params[name])).to(
            device=p.device, dtype=p.dtype))
    return lm
