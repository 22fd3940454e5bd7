"""BERT, as the JAX package's ``models/bert.py``.

``BERTModel`` = embeddings (word + position + token type) -> N post-LN
encoder layers -> pooler.  ``BERTForPretrain`` adds the masked-LM head,
decoded with the word-embedding matrix (tied), and the next-sentence
head.  Encoder attention runs ``dot_product_attention``, so s128-aligned
batches take the flash kernels on the card, forward and backward.

Models are built on the ``meta`` device; ``initialize(init, ctx=...)``
places and fills them (the reference's ``model.initialize``).  Token
ids, types, positions and lengths are float32, as in the reference.
"""
from __future__ import annotations

import torch

from ..base import MXNetError
from ..gluon.block import Block
from ..gluon.contrib.nn import TransformerEncoder
from ..gluon.nn import Dense, Dropout, Embedding, LayerNorm
from ..initializer import param
from ..ops import nn as ops

__all__ = ["BERTModel", "BERTForPretrain", "bert_base", "bert_small",
           "bert_large", "get_bert"]


class BERTModel(Block):
    def __init__(self, vocab_size=30522, units=768, hidden_size=3072,
                 num_layers=12, num_heads=12, max_length=512,
                 type_vocab_size=2, dropout=0.1, remat=False,
                 scan_layers=False):
        super().__init__()
        self._units = units
        self.vocab_size = vocab_size
        self.word_embed = Embedding(vocab_size, units)
        self.token_type_embed = Embedding(type_vocab_size, units)
        self.position_embed = param(max_length, units, init="normal")
        self.embed_layer_norm = LayerNorm(units)
        self.embed_dropout = Dropout(dropout) if dropout else None
        self.encoder = TransformerEncoder(
            units, hidden_size, num_layers, num_heads, dropout=dropout,
            activation="gelu", remat=remat, scan_layers=scan_layers)
        self.pooler = Dense(units, activation="tanh", in_units=units,
                            flatten=False)

    def forward(self, inputs, token_types, valid_length=None):
        """Returns ``(seq (B, S, units), pooled (B, units))``.
        ``valid_length`` (B,) masks the padded keys of each row."""
        b, s = inputs.shape[0], inputs.shape[1]
        x = self.word_embed(inputs) + self.token_type_embed(token_types)
        x = x + self.position_embed[:s].unsqueeze(0)
        x = self.embed_layer_norm(x)
        if self.embed_dropout is not None:
            x = self.embed_dropout(x)
        mask = None
        if valid_length is not None:
            # (B, 1, 1, S) key-padding mask, as float32 0/1
            steps = torch.arange(s, dtype=torch.float32, device=x.device)
            vl = valid_length.to(device=x.device, dtype=torch.float32)
            mask = (steps[None, :] < vl[:, None]).float().reshape(b, 1, 1, s)
        seq = self.encoder(x, mask)
        pooled = self.pooler(seq[:, 0].reshape(b, -1))
        return seq, pooled


class BERTForPretrain(Block):
    """MLM + NSP pretraining heads over :class:`BERTModel`.

    Returns ``(mlm_scores (B*M, vocab), nsp_scores (B, 2))``.
    ``decode_mlm=False`` skips the tied decode and returns ``(hidden
    (B*M, units), nsp_scores, word_weight, mlm_bias)`` for a caller
    that fuses decode and cross-entropy."""

    def __init__(self, bert: BERTModel, decode_mlm=True):
        super().__init__()
        units = bert._units
        self._decode_mlm = bool(decode_mlm)
        self.bert = bert
        self.mlm_dense = Dense(units, in_units=units, flatten=False)
        self.mlm_norm = LayerNorm(units)
        self.mlm_bias = param(bert.vocab_size, init="zeros")
        self.nsp_classifier = Dense(2, in_units=units)

    def forward(self, inputs, token_types, valid_length, masked_positions):
        seq, pooled = self.bert(inputs, token_types, valid_length)
        h = self.mlm_dense(_gather_positions(seq, masked_positions))
        h = self.mlm_norm(ops.gelu(h))
        word_w = self.bert.word_embed.weight
        nsp_scores = self.nsp_classifier(pooled)
        h2 = h.reshape(-1, h.shape[-1])
        if not self._decode_mlm:
            return h2, nsp_scores, word_w, self.mlm_bias
        mlm_scores = ops.dot(h2, word_w, transpose_b=True) + self.mlm_bias
        return mlm_scores, nsp_scores


def _gather_positions(seq, positions):
    """seq (B, S, U), positions (B, M) -> (B, M, U); positions clip into
    range."""
    b, s, u = seq.shape
    m = positions.shape[1]
    offset = torch.arange(b, dtype=torch.float32,
                          device=seq.device).reshape(b, 1) * s
    idx = (positions.to(seq.device).float() + offset).reshape(-1)
    return ops.take(seq.reshape(b * s, u), idx, axis=0).reshape(b, m, u)


_BERT_SPECS = {
    "bert_small": dict(units=256, hidden_size=1024, num_layers=4,
                       num_heads=4),
    "bert_base": dict(units=768, hidden_size=3072, num_layers=12,
                      num_heads=12),
    "bert_large": dict(units=1024, hidden_size=4096, num_layers=24,
                       num_heads=16),
}


def get_bert(name, vocab_size=30522, max_length=512, dropout=0.1,
             **kwargs):
    """The named configuration's :class:`BERTModel` (on ``meta``)."""
    if name not in _BERT_SPECS:
        raise MXNetError(f"unknown bert config {name!r}; options "
                         f"{sorted(_BERT_SPECS)}")
    spec = dict(_BERT_SPECS[name])
    spec.update(kwargs)
    return BERTModel(vocab_size=vocab_size, max_length=max_length,
                     dropout=dropout, **spec)


def bert_base(**kwargs):
    return get_bert("bert_base", **kwargs)


def bert_small(**kwargs):
    return get_bert("bert_small", **kwargs)


def bert_large(**kwargs):
    return get_bert("bert_large", **kwargs)
