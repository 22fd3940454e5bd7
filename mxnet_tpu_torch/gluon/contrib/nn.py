"""Transformer blocks, as the JAX package's ``gluon/contrib/nn.py``:
``MultiHeadAttention``, ``PositionwiseFFN``, the post-/pre-LN
``TransformerEncoderCell`` and ``TransformerEncoder``.

They are ``HybridBlock``s that take ``prefix=`` and ``params=``, and
their children carry the reference's prefixes, so ``collect_params()``
names equal the JAX package's (``multiheadattention0_query_weight``,
``layer0_positionwiseffn0_ffn1_bias``, ...).  The attribute paths stay
``query_proj``, ``layers.{i}.attention``, ... .

Attention is ``dot_product_attention``: aligned lengths run the flash
kernels on the card, forward and backward; a query-dependent 4-D mask
(a decoder's causal mask) takes the plain path, as the reference's takes
XLA's.  ``remat=True`` recomputes
each layer in the backward with ``torch.utils.checkpoint``; the
recomputation replays the dropout draws of the device's ``mx.random``
generator.
``scan_layers=True`` is accepted and runs the layers unrolled: eager
PyTorch has no compiled program whose size a scan would cut.
"""
from __future__ import annotations

import contextlib

import torch
from torch import nn as tnn
from torch.utils.checkpoint import checkpoint

from ... import random as _random
from ...base import MXNetError
from ...ops import nn as ops
from ...ops.attention import dot_product_attention
from ..block import HybridBlock
from ..nn import Dense, Dropout, LayerNorm

__all__ = ["MultiHeadAttention", "PositionwiseFFN",
           "TransformerEncoderCell", "TransformerEncoder"]


class MultiHeadAttention(HybridBlock):
    """Multi-head self/cross attention (units == num_heads * head_dim).
    ``in_units`` (default ``units``) is the width of query, key and
    value."""

    def __init__(self, units, num_heads, dropout=0.0, use_bias=True,
                 in_units=None, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        if units % num_heads:
            raise MXNetError(f"units {units} not divisible by num_heads "
                             f"{num_heads}")
        self._units = units
        self._num_heads = num_heads
        in_units = in_units or units
        kw = dict(flatten=False, use_bias=use_bias)
        with self.name_scope():
            self.query_proj = Dense(units, in_units=in_units,
                                    prefix="query_", **kw)
            self.key_proj = Dense(units, in_units=in_units, prefix="key_",
                                  **kw)
            self.value_proj = Dense(units, in_units=in_units,
                                    prefix="value_", **kw)
            self.out_proj = Dense(units, in_units=units, prefix="out_", **kw)
            self.drop = Dropout(dropout) if dropout else None

    def forward(self, query, key=None, value=None, mask=None):
        if key is None:
            key = query
        if value is None:
            value = key
        b, s_q = query.shape[0], query.shape[1]
        s_k = key.shape[1]
        h = self._num_heads
        d = self._units // h
        q = self.query_proj(query).reshape(b, s_q, h, d)
        k = self.key_proj(key).reshape(b, s_k, h, d)
        v = self.value_proj(value).reshape(b, s_k, h, d)
        out = dot_product_attention(q, k, v, mask)
        out = self.out_proj(out.reshape(b, s_q, self._units))
        if self.drop is not None:
            out = self.drop(out)
        return out


class PositionwiseFFN(HybridBlock):
    def __init__(self, units, hidden_size, dropout=0.0, activation="gelu",
                 prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        with self.name_scope():
            self.ffn_1 = Dense(hidden_size, flatten=False, in_units=units,
                               prefix="ffn1_")
            self.ffn_2 = Dense(units, flatten=False, in_units=hidden_size,
                               prefix="ffn2_")
            self.drop = Dropout(dropout) if dropout else None
        self._activation = activation

    def forward(self, x):
        h = self.ffn_1(x)
        if self._activation == "gelu":
            h = ops.gelu(h)
        else:
            h = ops.activation(h, self._activation)
        h = self.ffn_2(h)
        if self.drop is not None:
            h = self.drop(h)
        return h


class TransformerEncoderCell(HybridBlock):
    """Pre/post-LN encoder layer (BERT uses post-LN, the default)."""

    def __init__(self, units, hidden_size, num_heads, dropout=0.0,
                 activation="gelu", pre_norm=False, prefix=None,
                 params=None):
        super().__init__(prefix=prefix, params=params)
        self._pre_norm = pre_norm
        with self.name_scope():
            self.attention = MultiHeadAttention(units, num_heads,
                                                dropout=dropout)
            self.ffn = PositionwiseFFN(units, hidden_size, dropout=dropout,
                                       activation=activation)
            self.layer_norm_att = LayerNorm(units)
            self.layer_norm_ffn = LayerNorm(units)
            self.drop = Dropout(dropout) if dropout else None

    def forward(self, x, mask=None):
        if self._pre_norm:
            x = x + self.attention(self.layer_norm_att(x), None, None, mask)
            return x + self.ffn(self.layer_norm_ffn(x))
        att = self.attention(x, None, None, mask)
        if self.drop is not None:
            att = self.drop(att)
        x = self.layer_norm_att(x + att)
        return self.layer_norm_ffn(x + self.ffn(x))


class TransformerEncoder(HybridBlock):
    """A stack of encoder cells, named ``layer{i}_`` as in the reference.
    ``remat=True`` checkpoints each layer when a gradient is being
    recorded: its activations are recomputed in the backward instead of
    stored.  ``scan_layers=True`` runs unrolled (see the module
    docstring)."""

    def __init__(self, units, hidden_size, num_layers, num_heads,
                 dropout=0.0, activation="gelu", pre_norm=False,
                 remat=False, scan_layers=False, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._remat = remat
        del scan_layers          # accepted; the layers run unrolled
        with self.name_scope():
            self.layers = tnn.ModuleList(
                TransformerEncoderCell(units, hidden_size, num_heads,
                                       dropout=dropout,
                                       activation=activation,
                                       pre_norm=pre_norm,
                                       prefix=f"layer{i}_")
                for i in range(num_layers))

    def forward(self, x, mask=None):
        remat = self._remat and torch.is_grad_enabled()
        for layer in self.layers:
            if remat:
                x = checkpoint(layer, x, mask, use_reentrant=False,
                               context_fn=_replay_rng(x.device))
            else:
                x = layer(x, mask)
        return x


def _replay_rng(device):
    """A ``checkpoint`` ``context_fn``: the recomputation runs from the
    generator state the forward started from (so dropout draws the same
    masks), and the generator then goes back to where it was."""
    def context_fn():
        gen = _random.generator(device)
        start = gen.get_state()

        @contextlib.contextmanager
        def replay():
            now = gen.get_state()
            gen.set_state(start)
            try:
                yield
            finally:
                gen.set_state(now)
        return contextlib.nullcontext(), replay()
    return context_fn
