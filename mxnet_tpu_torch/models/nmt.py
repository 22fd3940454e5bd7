"""Transformer NMT and beam search, as the JAX package's ``models/nmt.py``
(GluonNLP's ``transformer_en_de_512`` and ``BeamSearchSampler``).

* **Teacher forcing.**  ``TransformerNMT`` is a HybridBlock: after
  ``hybridize()`` its call (encoder, decoder and tied head) is one
  CachedOp replay, forward and backward.  Every attention masks keys by
  the valid lengths, a (B, 1, 1, S) mask that reaches
  ``dot_product_attention`` as key padding, so at aligned lengths the
  encoder's self-attention, the decoder's causal self-attention and the
  cross-attention all run the flash kernels (K1 forward; K2 and K3 in the
  backward).
* **Incremental decode.**  Per-layer self-attention K/V caches written in
  place at the step's offset (``nd._cache_update(..., out=cache)``), the
  cross-attention's K/V projected from the encoder memory once at
  ``init_decode``; the one-token step attends through the plain path.
  The decode methods run their blocks inline and record only inside
  ``autograd.record()``.
* **Beam search.**  ``BeamSearchSampler`` expands the scores and takes
  the top 2K of each row's K·V candidates on the device (``nd.topk``:
  the lower index first among equal scores, as ``lax.top_k``); the
  (B, 2K) winners come to the host for the EOS and finished
  bookkeeping, and the states are reordered by the survivors' parents.
  Given NDArrays it takes and returns NDArrays, as the reference;
  given tensors (``LlamaForCausalLM.generate_beam``), tensors.
"""
from __future__ import annotations

import numpy as np
import torch

from ..base import MXNetError
from ..gluon import nn
from ..gluon.block import HybridBlock
from ..gluon.contrib.nn import TransformerEncoder
from ..ndarray.ndarray import NDArray
from ..ops.tensor import topk
from .forecast import _predict

__all__ = ["TransformerNMT", "TransformerDecoderCell", "BeamSearchScorer",
           "BeamSearchSampler", "get_nmt", "nmt_tiny",
           "transformer_en_de_512"]


def _sinusoid_table(max_len, units):
    """Vaswani et al.'s fixed position encodings (max_len, units),
    computed in float64 and stored as float32."""
    pos = np.arange(max_len, dtype=np.float64)[:, None]
    dim = np.arange(units // 2, dtype=np.float64)[None, :]
    ang = pos / np.power(10000.0, 2.0 * dim / units)
    table = np.zeros((max_len, units), dtype=np.float32)
    table[:, 0::2] = np.sin(ang)
    table[:, 1::2] = np.cos(ang)
    return table


class _DecoderAttention(HybridBlock):
    """Self- or cross-attention with its projections in the open, so
    the decode path can cache K/V."""

    def __init__(self, units, num_heads, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        if units % num_heads:
            raise MXNetError(f"units {units} % num_heads {num_heads}")
        self._h = num_heads
        self._d = units // num_heads
        self._units = units
        with self.name_scope():
            self.q_proj = nn.Dense(units, flatten=False, in_units=units,
                                   prefix="q_")
            self.k_proj = nn.Dense(units, flatten=False, in_units=units,
                                   prefix="k_")
            self.v_proj = nn.Dense(units, flatten=False, in_units=units,
                                   prefix="v_")
            self.o_proj = nn.Dense(units, flatten=False, in_units=units,
                                   prefix="o_")

    def _split(self, x):
        return x.reshape((x.shape[0], x.shape[1], self._h, self._d))

    def hybrid_forward(self, F, query, key, value, mask=None,
                       causal=False):
        b, s_q = query.shape[0], query.shape[1]
        q = self._split(self.q_proj(query))
        k = self._split(self.k_proj(key))
        v = self._split(self.v_proj(value))
        if mask is not None:
            out = F.dot_product_attention(q, k, v, mask, causal=causal,
                                          use_mask=True)
        else:
            out = F.dot_product_attention(q, k, v, causal=causal)
        return self.o_proj(out.reshape((b, s_q, self._units)))

    def project_kv(self, memory):
        """Encoder memory -> (K, V) in (B, S, H, D), once a translation."""
        return (self._split(self.k_proj(memory)),
                self._split(self.v_proj(memory)))

    def step_self(self, x, cache_k, cache_v, offset, mask):
        """One token's self-attention against the KV cache, which it
        writes in place at ``offset``."""
        from .. import ndarray as nd
        b = x.shape[0]
        q = self._split(self.q_proj(x))
        nd._cache_update(cache_k, self._split(self.k_proj(x)),
                         offset=offset, out=cache_k)
        nd._cache_update(cache_v, self._split(self.v_proj(x)),
                         offset=offset, out=cache_v)
        out = nd.dot_product_attention(q, cache_k, cache_v, mask,
                                       use_mask=True)
        return self.o_proj(out.reshape((b, 1, self._units)))

    def step_cross(self, x, mem_k, mem_v, mask=None):
        """One token's cross-attention against the projected memory."""
        from .. import ndarray as nd
        b = x.shape[0]
        q = self._split(self.q_proj(x))
        if mask is not None:
            out = nd.dot_product_attention(q, mem_k, mem_v, mask,
                                           use_mask=True)
        else:
            out = nd.dot_product_attention(q, mem_k, mem_v)
        return self.o_proj(out.reshape((b, 1, self._units)))


class TransformerDecoderCell(HybridBlock):
    """Post-LN decoder layer: self-attention, cross-attention, FFN, a
    residual around each (Vaswani et al.'s layout)."""

    def __init__(self, units, hidden_size, num_heads, dropout=0.0,
                 activation="relu", prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        with self.name_scope():
            self.self_attn = _DecoderAttention(units, num_heads,
                                               prefix="self_")
            self.cross_attn = _DecoderAttention(units, num_heads,
                                                prefix="cross_")
            self.ffn_1 = nn.Dense(hidden_size, flatten=False,
                                  in_units=units, prefix="ffn1_")
            self.ffn_2 = nn.Dense(units, flatten=False,
                                  in_units=hidden_size, prefix="ffn2_")
            self.norm_self = nn.LayerNorm(in_channels=units)
            self.norm_cross = nn.LayerNorm(in_channels=units)
            self.norm_ffn = nn.LayerNorm(in_channels=units)
            self.drop = nn.Dropout(dropout) if dropout else None
        self._activation = activation

    def _ffn(self, F, x):
        h = F.Activation(self.ffn_1(x), act_type=self._activation)
        h = self.ffn_2(h)
        return self.drop(h) if self.drop is not None else h

    def hybrid_forward(self, F, x, memory, tgt_mask=None, mem_mask=None):
        att = self.self_attn(x, x, x, tgt_mask, True)
        if self.drop is not None:
            att = self.drop(att)
        x = self.norm_self(x + att)
        att = self.cross_attn(x, memory, memory, mem_mask, False)
        if self.drop is not None:
            att = self.drop(att)
        x = self.norm_cross(x + att)
        return self.norm_ffn(x + self._ffn(F, x))

    def step(self, x, cache_k, cache_v, offset, self_mask, mem_k, mem_v,
             mem_mask):
        from .. import ndarray as nd
        x = self.norm_self(x + self.self_attn.step_self(
            x, cache_k, cache_v, offset, self_mask))
        x = self.norm_cross(x + self.cross_attn.step_cross(
            x, mem_k, mem_v, mem_mask))
        return self.norm_ffn(x + self._ffn(nd, x))


class TransformerNMT(HybridBlock):
    """Encoder-decoder transformer for sequence-to-sequence tasks.

    GluonNLP's conventions: token 0 may serve as PAD and the caller gives
    the BOS/EOS ids; the call is the teacher-forcing pass, (B, T,
    tgt_vocab) logits; ``translate`` is beam search through the cached
    incremental decoder.  ``share_embed`` makes the target embedding the
    source's block, and ``tie_output`` (the default) reads the target
    embedding as the output projection, so with both one weight is read
    three times and its gradient is the sum of the three."""

    def __init__(self, src_vocab_size, tgt_vocab_size=None, units=512,
                 hidden_size=2048, num_layers=6, num_heads=8,
                 max_length=512, dropout=0.1, activation="relu",
                 share_embed=False, tie_output=True, prefix=None,
                 params=None):
        super().__init__(prefix=prefix, params=params)
        if share_embed and tgt_vocab_size not in (None, src_vocab_size):
            raise MXNetError("share_embed requires equal vocabularies")
        tgt_vocab_size = tgt_vocab_size or src_vocab_size
        self.src_vocab_size = src_vocab_size
        self.tgt_vocab_size = tgt_vocab_size
        self._units = units
        self._scale = float(np.sqrt(units))
        self._tied = tie_output
        self._num_layers = num_layers
        self._heads = num_heads
        with self.name_scope():
            self.src_embed = nn.Embedding(src_vocab_size, units,
                                          prefix="src_embed_")
            self.tgt_embed = (self.src_embed if share_embed else
                              nn.Embedding(tgt_vocab_size, units,
                                           prefix="tgt_embed_"))
            self.pos_table = self.params.get_constant(
                "pos_table", _sinusoid_table(max_length, units))
            self.encoder = TransformerEncoder(
                units, hidden_size, num_layers, num_heads,
                dropout=dropout, activation=activation, prefix="enc_")
            self.decoder_cells = []
            for i in range(num_layers):
                cell = TransformerDecoderCell(
                    units, hidden_size, num_heads, dropout=dropout,
                    activation=activation, prefix=f"dec{i}_")
                self.register_child(cell, f"dec{i}")
                self.decoder_cells.append(cell)
            if not tie_output:
                self.out_proj = nn.Dense(tgt_vocab_size, flatten=False,
                                         use_bias=False, in_units=units,
                                         prefix="out_")

    def _pos_table(self, ctx):
        return self._gluon_param("pos_table").data(ctx)

    def _table_rows(self):
        """Rows of the position table: the longest sequence."""
        return self._gluon_param("pos_table").shape[0]

    # -- masks ---------------------------------------------------------------

    @staticmethod
    def _key_mask(F, valid_length, s, ctx):
        """(B,) valid lengths -> (B, 1, 1, S) key mask (1 keeps a key)."""
        steps = F.arange(0, s, ctx=ctx)
        m = F.broadcast_lesser(
            F.expand_dims(steps, axis=0),
            F.expand_dims(valid_length.astype("float32"), axis=1))
        return F.expand_dims(F.expand_dims(m, axis=1), axis=1)

    # -- teacher forcing -----------------------------------------------------

    def _embed(self, F, embed, tokens, pos_table=None):
        if pos_table is None:
            pos_table = self._pos_table(tokens.context)
        pos = F.slice_axis(pos_table, axis=0, begin=0, end=tokens.shape[1])
        return embed(tokens) * self._scale + F.expand_dims(pos, axis=0)

    def _head(self, F, h):
        if self._tied:
            w = self.tgt_embed._gluon_param("weight").data(h.context)
            b, s, u = h.shape
            return F.dot(h.reshape((b * s, u)), w, transpose_b=True) \
                .reshape((b, s, self.tgt_vocab_size))
        return self.out_proj(h)

    def encode(self, src, src_valid=None):
        from .. import ndarray as nd
        x = self._embed(nd, self.src_embed, src)
        mask = None
        if src_valid is not None:
            mask = self._key_mask(nd, src_valid, src.shape[1], src.context)
        return self.encoder(x, mask)

    def hybrid_forward(self, F, src, tgt, src_valid=None, tgt_valid=None,
                       pos_table=None):
        x = self._embed(F, self.src_embed, src, pos_table)
        src_mask = None
        if src_valid is not None:
            src_mask = self._key_mask(F, src_valid, src.shape[1],
                                      src.context)
        memory = self.encoder(x, src_mask)
        y = self._embed(F, self.tgt_embed, tgt, pos_table)
        tgt_mask = None
        if tgt_valid is not None:
            tgt_mask = self._key_mask(F, tgt_valid, tgt.shape[1],
                                      tgt.context)
        for cell in self.decoder_cells:
            y = cell(y, memory, tgt_mask, src_mask)
        return self._head(F, y)

    def loss(self, src, tgt_in, tgt_out, src_valid=None, tgt_valid=None,
             label_smoothing=0.1):
        """Label-smoothed cross entropy (Vaswani et al.'s eps = 0.1),
        averaged over the valid target positions; a scalar."""
        from .. import ndarray as nd
        logits = self(src, tgt_in, src_valid, tgt_valid)
        b, t, v = logits.shape
        logp = nd.log_softmax(logits.reshape((b * t, v)), axis=-1)
        lbl = tgt_out.reshape((-1,)).astype("int32")
        nll = -nd.pick(logp, lbl, axis=-1)
        smooth = -nd.mean(logp, axis=-1)
        per_tok = (1.0 - label_smoothing) * nll + label_smoothing * smooth
        if tgt_valid is not None:
            steps = nd.arange(0, t, ctx=src.context).reshape((1, t))
            keep = (steps < tgt_valid.astype("float32").reshape((b, 1))) \
                .astype("float32").reshape((-1,))
            return nd.sum(per_tok * keep) / nd.sum(keep)
        return nd.mean(per_tok)

    # -- incremental decode --------------------------------------------------

    @_predict
    def init_decode(self, memory, max_len, src_valid=None):
        """The decode state: each layer's empty self-attention caches
        (``states``, which beam search reorders), the cross-attention's
        projected K/V (``mem_kvs``, the same for every step and beam
        order) and the memory's key mask."""
        from .. import ndarray as nd
        if max_len > self._table_rows():
            raise MXNetError(
                f"max_len {max_len} exceeds the position table "
                f"({self._table_rows()} rows; raise max_length)")
        b = memory.shape[0]
        h, d = self._heads, self._units // self._heads
        states, mem_kvs = [], []
        for cell in self.decoder_cells:
            states.append([nd.zeros((b, max_len, h, d), ctx=memory.context)
                           for _ in range(2)])
            mem_kvs.append(cell.cross_attn.project_kv(memory))
        mem_mask = None
        if src_valid is not None:
            mem_mask = self._key_mask(nd, src_valid, memory.shape[1],
                                      memory.context)
        return states, mem_kvs, mem_mask

    @_predict
    def decode_step(self, tok, states, mem_kvs, offset, mem_mask=None):
        """tok (B, 1) -> log-probs (B, tgt_vocab); the caches in
        ``states`` are written in place.  The position row is taken with
        an index uploaded from the host, as the reference's dynamic
        ``take``."""
        from .. import ndarray as nd
        ctx = tok.context
        pos_idx = nd.array(np.array([offset], np.float32), ctx=ctx)
        pos = nd.take(self._pos_table(ctx), pos_idx, axis=0)
        x = self.tgt_embed(tok) * self._scale + nd.expand_dims(pos, axis=0)
        max_len = states[0][0].shape[1]
        self_mask = (nd.arange(max_len, ctx=ctx) <= float(offset)) \
            .reshape((1, 1, 1, max_len))
        for cell, (ck, cv), (mk, mv) in zip(self.decoder_cells, states,
                                            mem_kvs):
            x = cell.step(x, ck, cv, offset, self_mask, mk, mv, mem_mask)
        logits = self._head(nd, x).reshape((x.shape[0],
                                            self.tgt_vocab_size))
        return nd.log_softmax(logits, axis=-1)

    def translate(self, src, bos_id, eos_id, src_valid=None, beam_size=4,
                  max_len=None, alpha=1.0):
        """Beam-search translation -> (samples (B, K, L), scores (B, K),
        lengths (B, K)) on the source's context; samples start with BOS
        and end with EOS when one was produced.  ``max_len`` (default
        2 S + 8) is capped by the position table."""
        from .. import ndarray as nd
        max_len = min(max_len or (2 * src.shape[1] + 8), self._table_rows())
        memory = self.encode(src, src_valid)
        sampler = BeamSearchSampler(
            beam_size=beam_size, eos_id=eos_id,
            scorer=BeamSearchScorer(alpha=alpha), max_length=max_len)
        b = src.shape[0]
        sv_t = None if src_valid is None else _tile_rows(src_valid,
                                                         beam_size)
        states, mem_kvs, mem_mask = self.init_decode(
            _tile_rows(memory, beam_size), max_len, sv_t)

        def decoder(tok, step_idx, st):
            return (self.decode_step(tok, st, mem_kvs, step_idx, mem_mask),
                    st)

        start = nd.full((b * beam_size, 1), float(bos_id), ctx=src.context)
        return sampler(decoder, start, states, batch_size=b)


def _tile_rows(x, k):
    """(B, ...) -> (B*K, ...), each row repeated K times."""
    from .. import ndarray as nd
    return nd.repeat(x, repeats=k, axis=0)


class BeamSearchScorer:
    """Google-NMT length-penalized score (Wu et al. 2016), the
    GluonNLP default: score = logprob_sum / ((K + len) / (K + 1)) **
    alpha."""

    def __init__(self, alpha=1.0, K=5.0):
        self.alpha = float(alpha)
        self.K = float(K)

    def __call__(self, log_probs, length):
        lp = ((self.K + length) / (self.K + 1.0)) ** self.alpha
        return log_probs / lp


class BeamSearchSampler:
    """Beam search over an incremental decoder.

    ``decoder(tok, step_idx, states) -> (log_probs (B*K, V), states)``
    with ``states`` any nest (lists, tuples) of arrays whose leading
    axis is the flat beam axis B*K; after each step the sampler reorders
    that axis by the surviving beams' parents.  Returns ``(samples (B,
    K, L), scores (B, K), lengths (B, K))`` as float32 arrays on the
    start tokens' device, best first; samples start with the start
    token and are padded with ``eos_id``.  With NDArray start tokens the
    decoder is given NDArrays and everything returned is an NDArray on
    their context; with tensors, tensors.
    """

    def __init__(self, beam_size, eos_id, scorer=None, max_length=64):
        self.beam_size = int(beam_size)
        self.eos_id = int(eos_id)
        self.scorer = scorer or BeamSearchScorer()
        self.max_length = int(max_length)

    def __call__(self, decoder, start_tokens, states, batch_size):
        b, k = batch_size, self.beam_size
        if start_tokens.shape[0] != b * k:
            raise MXNetError(
                f"start_tokens leading axis {start_tokens.shape[0]} != "
                f"batch_size*beam_size {b * k}")
        ctx = start_tokens.context if isinstance(start_tokens, NDArray) \
            else None
        start = start_tokens._t if ctx is not None else start_tokens
        dev = start.device

        def as_caller(t):
            return NDArray(t, ctx=ctx) if ctx is not None else t
        # beam 0 of each batch row is live; the rest start at -inf so
        # the first expansion seeds distinct hypotheses from beam 0
        logp_sum = np.full((b, k), -np.inf, np.float64)
        logp_sum[:, 0] = 0.0
        hist = start.cpu().numpy().astype(np.int64).reshape(b, k, 1)
        alive = np.ones((b, k), bool)
        lengths = np.ones((b, k), np.int64)   # counts the start token
        cur = start_tokens
        finished = [[] for _ in range(b)]     # (score, token_list)

        for step in range(self.max_length - 1):
            logp, states = decoder(cur, step, states)  # (B*K, V)
            if isinstance(logp, NDArray):
                logp = logp._t
            v = logp.shape[-1]
            # dead beams carry -inf sums: a finite floor keeps the add
            # free of NaN (whose top-k order is unspecified), and the
            # -1e29 filter below drops their children
            floor = np.maximum(logp_sum, -1e30).reshape(-1, 1)
            cand = logp + torch.as_tensor(floor.astype(np.float32),
                                          device=dev)
            # top-2K of each row's K*V candidates, so EOS picks never
            # starve the live-beam quota
            n_top = min(2 * k, k * v)
            top_scores, top_idx = topk(cand.reshape(b, k * v), k=n_top,
                                       ret_typ="both")
            ts = top_scores.cpu().numpy().astype(np.float64)
            ti = top_idx.cpu().numpy().astype(np.int64)

            new_logp = np.full((b, k), -np.inf, np.float64)
            new_alive = np.zeros((b, k), bool)
            new_len = np.ones((b, k), np.int64)
            parent = np.zeros((b, k), np.int64)
            next_tok = np.zeros((b, k), np.int64)
            for i in range(b):
                slot = 0
                for j in range(n_top):
                    if slot == k:
                        break
                    if ts[i, j] <= -1e29:
                        continue
                    pj, tj = divmod(int(ti[i, j]), v)
                    seq_len = lengths[i, pj] + 1
                    if tj == self.eos_id:
                        seq = np.concatenate([hist[i, pj], [self.eos_id]])
                        finished[i].append(
                            (self.scorer(ts[i, j], float(seq_len)), seq))
                        continue
                    new_logp[i, slot] = ts[i, j]
                    new_alive[i, slot] = True
                    new_len[i, slot] = seq_len
                    parent[i, slot] = pj
                    next_tok[i, slot] = tj
                    slot += 1
            logp_sum, alive, lengths = new_logp, new_alive, new_len
            if not alive.any():
                break
            flat_parent = (parent + np.arange(b)[:, None] * k).reshape(-1)
            hist = np.concatenate(
                [hist[np.arange(b)[:, None], parent], next_tok[:, :, None]],
                axis=-1)
            if step < self.max_length - 2:
                # the last iteration's reorder would never be read
                states = _gather_states(
                    states, torch.as_tensor(flat_parent, device=dev))
                cur = as_caller(torch.as_tensor(
                    next_tok.reshape(b * k, 1).astype(np.float32),
                    device=dev))

        # close out the beams still alive at max length
        for i in range(b):
            for j in range(k):
                if alive[i, j]:
                    finished[i].append(
                        (self.scorer(logp_sum[i, j], float(lengths[i, j])),
                         hist[i, j]))
            if not finished[i]:   # degenerate: everything pruned
                finished[i].append((-np.inf, hist[i, 0]))

        # pad and sort each batch row, best first
        max_out = max(len(seq) for row in finished for _, seq in row)
        samples = np.full((b, k, max_out), self.eos_id, np.int64)
        scores = np.full((b, k), -np.inf, np.float64)
        lens = np.zeros((b, k), np.int64)
        for i in range(b):
            best = sorted(finished[i], key=lambda t: -t[0])[:k]
            for j, (sc, seq) in enumerate(best):
                samples[i, j, :len(seq)] = seq
                scores[i, j] = sc
                lens[i, j] = len(seq)
        return tuple(as_caller(torch.as_tensor(a.astype(np.float32),
                                               device=dev))
                     for a in (samples, scores, lens))


def _gather_states(states, idx):
    """Reorder the leading (flat beam) axis of every tensor or NDArray in
    a nest by the index tensor ``idx``."""
    if isinstance(states, NDArray):
        return NDArray(torch.index_select(states._t, 0, idx),
                       ctx=states.context)
    if torch.is_tensor(states):
        return torch.index_select(states, 0, idx)
    if isinstance(states, (list, tuple)):
        out = [_gather_states(s, idx) for s in states]
        return out if isinstance(states, list) else tuple(out)
    return states


_NMT_SPECS = {
    # the test size (trains in seconds on the CPU)
    "nmt_tiny": dict(units=32, hidden_size=64, num_layers=2,
                     num_heads=2, max_length=64, dropout=0.0),
    # GluonNLP's WMT en-de base configuration (Vaswani et al. 2017's base)
    "transformer_en_de_512": dict(units=512, hidden_size=2048,
                                  num_layers=6, num_heads=8,
                                  max_length=512, dropout=0.1),
}


def get_nmt(name, src_vocab_size, tgt_vocab_size=None, **kwargs):
    if name not in _NMT_SPECS:
        raise MXNetError(f"unknown nmt config {name!r}; options "
                         f"{sorted(_NMT_SPECS)}")
    spec = dict(_NMT_SPECS[name])
    spec.update(kwargs)
    return TransformerNMT(src_vocab_size, tgt_vocab_size, **spec)


def nmt_tiny(src_vocab_size, **kwargs):
    return get_nmt("nmt_tiny", src_vocab_size, **kwargs)


def transformer_en_de_512(src_vocab_size, **kwargs):
    return get_nmt("transformer_en_de_512", src_vocab_size, **kwargs)
