"""Load a JAX-package parameter dict into this package's modules.

The JAX package names parameters by auto-numbered block prefixes, e.g.
``llamamodel0_layer3_attn_q_weight``, ``llamaforcausallm1_head_weight``
or ``bertmodel0_enc_layer0_multiheadattention0_query_weight``.
:func:`load_jax_params` (Llama) and :func:`load_jax_bert_params` (BERT)
strip the prefix and map the structural suffix onto the module's own
names.  Dense weights are (out, in) on both sides, so values copy over
unchanged.
"""
from __future__ import annotations

import re
from typing import Dict

import numpy as np
import torch

from ..base import MXNetError

__all__ = ["load_jax_params", "jax_name_to_torch", "load_jax_bert_params",
           "jax_bert_name_to_torch", "load_jax_gluon_params"]

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


def load_jax_params(lm, params: Dict[str, np.ndarray]):
    """Copy ``{jax_name: array}`` into ``lm`` (a ``LlamaForCausalLM``),
    cast to the module's dtype, on its device.  Raises ``MXNetError``
    on a missing, extra or wrong-shape name."""
    return _copy_by_name(lm, params, jax_name_to_torch)


# BERT: the JAX names of a BERTModel's parameters, after the
# ``bertmodel<N>_`` prefix.  Each encoder cell's LayerNorms are numbered
# in creation order: layernorm0 is ``layer_norm_att``, layernorm1
# ``layer_norm_ffn``; the model's own layernorm0 is the embedding norm.
_BERT_MODEL = re.compile(r"^bertmodel\d+_")
_BERT_RULES = [
    (re.compile(r"^word_embed_weight$"), "word_embed.weight"),
    (re.compile(r"^type_embed_weight$"), "token_type_embed.weight"),
    (re.compile(r"^position_embed$"), "position_embed"),
    (re.compile(r"^layernorm0_(gamma|beta)$"), "embed_layer_norm.{0}"),
    (re.compile(r"^enc_layer(\d+)_multiheadattention\d+_"
                r"(query|key|value|out)_(weight|bias)$"),
     "encoder.layers.{0}.attention.{1}_proj.{2}"),
    (re.compile(r"^enc_layer(\d+)_positionwiseffn\d+_ffn([12])_"
                r"(weight|bias)$"),
     "encoder.layers.{0}.ffn.ffn_{1}.{2}"),
    (re.compile(r"^enc_layer(\d+)_layernorm0_(gamma|beta)$"),
     "encoder.layers.{0}.layer_norm_att.{1}"),
    (re.compile(r"^enc_layer(\d+)_layernorm1_(gamma|beta)$"),
     "encoder.layers.{0}.layer_norm_ffn.{1}"),
    (re.compile(r"^pooler_(weight|bias)$"), "pooler.{0}"),
]
# ...and a BERTForPretrain's own heads, after ``bertforpretrain<N>_``
_BERT_PRETRAIN = re.compile(r"^bertforpretrain\d+_")
_BERT_HEAD_RULES = [
    (re.compile(r"^mlm_bias$"), "mlm_bias"),
    (re.compile(r"^mlm_dense_(weight|bias)$"), "mlm_dense.{0}"),
    (re.compile(r"^layernorm0_(gamma|beta)$"), "mlm_norm.{0}"),
    (re.compile(r"^nsp_(weight|bias)$"), "nsp_classifier.{0}"),
]


def _match(rules, suffix):
    for pat, fmt in rules:
        m = pat.match(suffix)
        if m:
            return fmt.format(*m.groups())
    return None


def jax_bert_name_to_torch(name: str, pretrain: bool = True) -> str:
    """The module's parameter name for a JAX-package BERT parameter
    name: of a ``BERTForPretrain`` (``pretrain``), else of a
    ``BERTModel``."""
    out = None
    if _BERT_MODEL.match(name):
        out = _match(_BERT_RULES, _BERT_MODEL.sub("", name, count=1))
        if out is not None and pretrain:
            out = "bert." + out
    elif pretrain and _BERT_PRETRAIN.match(name):
        out = _match(_BERT_HEAD_RULES, _BERT_PRETRAIN.sub("", name, count=1))
    if out is None:
        raise MXNetError(f"unrecognised BERT parameter name {name!r}")
    return out


def load_jax_bert_params(model, params: Dict[str, np.ndarray]):
    """Copy ``{jax_name: array}`` into ``model`` (a ``BERTModel`` or
    ``BERTForPretrain``, initialized), cast to its dtype, on its device.
    The JAX model's deferred Dense shapes must be set: take the dict
    after one forward.  Raises ``MXNetError`` on a missing, extra,
    unknown or wrong-shape name."""
    from .bert import BERTForPretrain
    pretrain = isinstance(model, BERTForPretrain)
    return _copy_by_name(
        model, params, lambda n: jax_bert_name_to_torch(n, pretrain))


_BLOCK_PREFIX = re.compile(r"^([^_]*?)\d*_(.*)$")


def _unnumbered(name: str, what: str):
    """(block alias, rest) of a parameter name, the number of its
    leading block prefix taken off: ``llamamodel3_layer0_attn_q_weight``
    -> (``llamamodel``, ``layer0_attn_q_weight``), ``mlp_dense0_bias``
    -> (``mlp``, ``dense0_bias``)."""
    m = _BLOCK_PREFIX.match(name)
    if m is None:
        raise MXNetError(f"{what} {name!r} has no block prefix")
    return m.groups()


def load_jax_gluon_params(block, params: Dict[str, np.ndarray],
                          jax_prefix: str = None):
    """Copy a JAX gluon block's parameters into the port's ``block`` (a
    gluon ``Block``, initialized) by name.  ``params`` is
    ``{name: array}`` from the JAX block's ``collect_params()``.

    Each name is matched to the port's ``collect_params()`` name that is
    the same with the number of its leading block prefix taken off, so a
    model whose parameters sit under several top-level blocks (a
    ``LlamaForCausalLM``: ``llamamodel<N>_...`` and, untied,
    ``llamaforcausallm<N>_head_weight``) maps whatever the numbers in
    either process.  With ``jax_prefix`` (the JAX block's ``prefix``)
    every name must also start with it.  Raises ``MXNetError`` on a
    missing, extra, unknown or wrong-shape name, and on two port names
    that differ only in their block numbers."""
    own = block.collect_params()
    by_key = {}
    for tname in own.keys():
        key = _unnumbered(tname, "port parameter")
        if key in by_key:
            raise MXNetError(f"{tname!r} and {by_key[key]!r} differ only "
                             "in their block numbers")
        by_key[key] = tname
    mapped = {}
    for name, value in params.items():
        if jax_prefix is not None and not name.startswith(jax_prefix):
            raise MXNetError(f"{name!r} does not start with the prefix "
                             f"{jax_prefix!r}")
        tname = by_key.get(_unnumbered(name, "parameter"))
        if tname is None or tname not in own:
            raise MXNetError(f"{name!r} maps to {tname!r}, which this "
                             "block does not have")
        arr = np.asarray(value)
        if tuple(arr.shape) != own[tname].shape:
            raise MXNetError(f"{name!r}: shape {tuple(arr.shape)} does not "
                             f"match {tname!r} {own[tname].shape}")
        mapped[tname] = arr
    missing = sorted(set(own.keys()) - set(mapped))
    if missing:
        raise MXNetError(f"parameters missing from the dict: {missing}")
    for tname, arr in mapped.items():
        own[tname].set_data(np.ascontiguousarray(arr))
    return block


@torch.no_grad()
def _copy_by_name(module, params, to_torch):
    """Copy ``{jax_name: array}`` into ``module``'s parameters, named by
    ``to_torch(jax_name)``; raises on a missing, extra or wrong-shape
    name."""
    own = dict(module.named_parameters())
    seen = {}
    for name, value in params.items():
        tname = to_torch(name)
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
    return module
