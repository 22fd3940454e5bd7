"""Llama-family decoder-only LMs as gluon HybridBlocks.

* The blocks are the JAX package's (``models/llama.py``): RMSNorm,
  RoPE (adjacent feature pairs) and grouped-query attention in
  ``hybrid_forward(F, ...)`` over the registered ops (``F.RMSNorm``,
  ``F.rope``, ``F.dot_product_attention``, ``F.silu``), Dense layers
  without bias, and the reference's parameter names under
  ``collect_params()`` (``llamamodel0_layer0_attn_q_weight``, ...).  On
  the card attention reaches the flash kernels: the forward (K1) and,
  when it records, the backward (K2, K3).
* ``get_llama`` builds the structure on the ``meta`` device (no
  memory), and ``LlamaForCausalLM(model)`` leaves it there, as the
  reference's constructor makes no weights: ``initialize(init, ctx=...)``
  places and fills them, as gluon does.  ``LlamaForCausalLM(model,
  ctx=..., dtype=...)`` places it on ``ctx`` at once and fills it from the
  context's seeded generator (Normal(0, 0.02), unit norm gains), the
  serving entry point, so the full Llama-3-8B geometry is made on the
  card directly.
* Training is the reference's gluon loop: ``hybridize()``,
  ``gluon.Trainer(net.collect_params(), "adam", ...)``, ``net.loss(tokens)``
  inside ``autograd.record()``, ``backward()``, ``trainer.step(B)``.  The
  hybridized ``LlamaModel`` is one CUDA-graph replay a recorded call and
  one at its backward; :meth:`LlamaForCausalLM.loss` streams the head
  through ``chunked_softmax_ce`` around it, eagerly.
* Serving: ``prefill``, ``decode_step`` and the ``generate`` family are
  tensor methods over the same blocks, run inline (no CachedOp of their
  own).  KV caches are (B, C, KV, D) tensors updated IN PLACE.
  ``generate`` samples on the host, one decode step a token;
  given NDArrays, the ``generate`` family returns NDArrays on the
  prompt's context, as the reference does (tensors for tensors);
  ``generate_fused`` runs the whole generation as one CUDA-graph replay
  a call; ``generate_beam`` is beam search over the same cache
  (``nmt.BeamSearchSampler``), eagerly.

Tokens are float32 ids, as in the JAX package; they are cast to long
at the embedding and gather.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from .._capture import StepCapture
from ..base import MXNetError, torch_dtype
from ..context import current_context
from ..gluon.block import HybridBlock, inline_calls
from ..gluon.nn import Dense, Embedding
from ..initializer import param
from ..ndarray.ndarray import NDArray, _ctx_of
from ..ops.attention import dot_product_attention, rope
from ..ops.nn import cache_update, dot, take
from ..ops.random_ops import pick_tokens

__all__ = ["LlamaModel", "LlamaForCausalLM", "RMSNormBlock",
           "get_llama", "llama_tiny", "llama3_8b"]


def _dense(out_units, in_units, prefix):
    return Dense(out_units, flatten=False, use_bias=False,
                 in_units=in_units, prefix=prefix)


def _inline(method):
    """A serving method: the blocks it calls run inline."""
    @functools.wraps(method)
    def wrapper(*args, **kwargs):
        with inline_calls():
            return method(*args, **kwargs)
    return wrapper


class RMSNormBlock(HybridBlock):
    """RMSNorm with learned gamma (op ``RMSNorm``); Llama's eps is 1e-5."""

    def __init__(self, units, eps=1e-5, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._eps = eps
        self.gamma = param(units, init="ones")

    def hybrid_forward(self, F, x, gamma=None):
        return F.RMSNorm(x, gamma, eps=self._eps)


class _LlamaAttention(HybridBlock):
    def __init__(self, units, num_heads, num_kv_heads, rope_base,
                 attn_impl="sdpa", sp_axis="sp", sliding_window=None,
                 prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        if units % num_heads:
            raise MXNetError(f"units {units} % num_heads {num_heads}")
        if num_heads % num_kv_heads:
            raise MXNetError("num_heads must be a multiple of "
                             "num_kv_heads (GQA groups)")
        if sliding_window is not None and attn_impl == "ring":
            raise MXNetError(
                "sliding_window with attn_impl='ring' is not "
                "supported: the band already caps per-query compute "
                "at O(W) — use the sdpa/flash path, or ring WITHOUT "
                "a window for full-causal sequence parallelism")
        self._impl = attn_impl
        self._sp_axis = sp_axis
        self._h = num_heads
        self._kv = num_kv_heads
        self._d = units // num_heads
        self._base = rope_base
        self._window = sliding_window
        with self.name_scope():
            self.q_proj = _dense(num_heads * self._d, units, "q_")
            self.k_proj = _dense(num_kv_heads * self._d, units, "k_")
            self.v_proj = _dense(num_kv_heads * self._d, units, "v_")
            self.o_proj = _dense(units, num_heads * self._d, "o_")

    def hybrid_forward(self, F, x):
        b, s = x.shape[0], x.shape[1]
        h, kv, d = self._h, self._kv, self._d
        q = F.rope(self.q_proj(x).reshape((b, s, h, d)), base=self._base)
        k = F.rope(self.k_proj(x).reshape((b, s, kv, d)), base=self._base)
        v = self.v_proj(x).reshape((b, s, kv, d))
        if self._impl == "ring":
            # the sequence split over the sp axis, KV heads round the ring
            from ..parallel.ring_attention import ring_attention_sharded
            out = ring_attention_sharded(q, k, v, axis=self._sp_axis,
                                         causal=True)
        else:
            # GQA is native in the attention op (grouped heads)
            out = F.dot_product_attention(q, k, v, causal=True,
                                          window=self._window)
        return self.o_proj(out.reshape((b, s, h * d)))

    def _qkv(self, x, offset=0):
        b, s = x.shape[0], x.shape[1]
        h, kv, d = self._h, self._kv, self._d
        q = rope(self.q_proj(x).reshape(b, s, h, d), offset, self._base)
        k = rope(self.k_proj(x).reshape(b, s, kv, d), offset, self._base)
        v = self.v_proj(x).reshape(b, s, kv, d)
        return q, k, v

    def prefill(self, x, cache_k, cache_v, perm=None):
        """Prompt pass: full causal attention that also writes K/V for
        every prompt position into the caches, in place.  A cache
        SHORTER than the prompt is the rolling (sliding-window) buffer:
        the prompt's tail is written through ``perm``, so slot j holds
        the newest position p = j (mod C)."""
        b, s = x.shape[0], x.shape[1]
        q, k, v = self._qkv(x)
        if perm is None:
            cache_update(cache_k, k, 0)
            cache_update(cache_v, v, 0)
        else:
            cache_update(cache_k, take(k, perm, axis=1), 0)
            cache_update(cache_v, take(v, perm, axis=1), 0)
        out = dot_product_attention(q, k, v, causal=True,
                                    window=self._window)
        return self.o_proj(out.reshape(b, s, self._h * self._d))

    def step(self, x, cache_k, cache_v, offset, mask, slot=None):
        """Incremental decode: x (B, 1, units), caches (B, C, KV, D)
        written in place.  ``offset`` is the absolute position (drives
        RoPE); ``slot`` the cache write index (``offset % C`` for a
        rolling buffer, else ``offset``)."""
        b = x.shape[0]
        q, k_t, v_t = self._qkv(x, offset)
        cache_update(cache_k, k_t, offset if slot is None else slot)
        cache_update(cache_v, v_t, offset if slot is None else slot)
        out = dot_product_attention(q, cache_k, cache_v, mask)
        return self.o_proj(out.reshape(b, 1, self._h * self._d))


class _LlamaMLP(HybridBlock):
    """SwiGLU feed-forward: down(silu(gate(x)) * up(x))."""

    def __init__(self, units, hidden, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        with self.name_scope():
            self.gate_proj = _dense(hidden, units, "gate_")
            self.up_proj = _dense(hidden, units, "up_")
            self.down_proj = _dense(units, hidden, "down_")

    def hybrid_forward(self, F, x):
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class _LlamaLayer(HybridBlock):
    def __init__(self, units, hidden, num_heads, num_kv_heads, rope_base,
                 attn_impl="sdpa", sp_axis="sp", sliding_window=None,
                 prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        with self.name_scope():
            self.input_norm = RMSNormBlock(units, prefix="innorm_")
            self.attn = _LlamaAttention(units, num_heads, num_kv_heads,
                                        rope_base, attn_impl=attn_impl,
                                        sp_axis=sp_axis,
                                        sliding_window=sliding_window,
                                        prefix="attn_")
            self.post_norm = RMSNormBlock(units, prefix="postnorm_")
            self.mlp = _LlamaMLP(units, hidden, prefix="mlp_")

    def hybrid_forward(self, F, x):
        x = x + self.attn(self.input_norm(x))
        return x + self.mlp(self.post_norm(x))

    def prefill(self, x, cache_k, cache_v, perm=None):
        x = x + self.attn.prefill(self.input_norm(x), cache_k, cache_v,
                                  perm=perm)
        return x + self.mlp(self.post_norm(x))

    def step(self, x, cache_k, cache_v, offset, mask, slot=None):
        x = x + self.attn.step(self.input_norm(x), cache_k, cache_v,
                               offset, mask, slot=slot)
        return x + self.mlp(self.post_norm(x))


class LlamaModel(HybridBlock):
    """The decoder stack, built on the ``meta`` device:
    :class:`LlamaForCausalLM` places it on its context."""

    def __init__(self, vocab_size, units, hidden, num_layers, num_heads,
                 num_kv_heads=None, rope_base=10000.0, attn_impl="sdpa",
                 sp_axis="sp", sliding_window=None, prefix=None,
                 params=None):
        super().__init__(prefix=prefix, params=params)
        num_kv_heads = num_kv_heads or num_heads
        self._units = units
        self.vocab_size = vocab_size
        self.sliding_window = sliding_window
        with self.name_scope():
            self.embed = Embedding(vocab_size, units, prefix="embed_")
            self.layers = torch.nn.ModuleList(
                _LlamaLayer(units, hidden, num_heads, num_kv_heads,
                            rope_base, attn_impl=attn_impl,
                            sp_axis=sp_axis, sliding_window=sliding_window,
                            prefix=f"layer{i}_")
                for i in range(num_layers))
            self.final_norm = RMSNormBlock(units, prefix="finalnorm_")

    def hybrid_forward(self, F, tokens):
        x = self.embed(tokens)
        for layer in self.layers:
            x = layer(x)
        return self.final_norm(x)


class LlamaForCausalLM(HybridBlock):
    """LM head over :class:`LlamaModel`.

    Without ``ctx`` the weights stay on the ``meta`` device (no memory)
    until ``initialize`` places and fills them, as in the reference.
    With ``ctx`` they are placed there at construction and filled from
    the context's generator (``mx.random.seed``): Normal(0, 0.02) and
    unit norm gains.  ``dtype`` is the weights' type.
    ``tie_embeddings=True`` shares the embedding matrix with the head
    (Llama-3.2-1B/3B); Llama-3-8B uses an untied head
    (``tie_embeddings=False``), a Dense named ``head_``."""

    def __init__(self, model: LlamaModel, tie_embeddings=True, ctx=None,
                 dtype="float32", prefix=None, params=None):
        if not all(p.is_meta for p in model.parameters()):
            raise MXNetError("LlamaForCausalLM places a model built by "
                             "get_llama (on the meta device); this one "
                             "already holds weights")
        super().__init__(prefix=prefix, params=params)
        self._tied = tie_embeddings
        with self.name_scope():
            self.model = model
            if not tie_embeddings:
                self.lm_head = _dense(model.vocab_size, model._units,
                                      "head_")
        # generate_fused: one StepCapture a signature, one generator a
        # device (reseeded each call)
        self._fused = {}
        self._fused_gens = {}
        self.to(dtype=torch_dtype(dtype))
        if ctx is not None:
            self.to_empty(device=ctx.device)
            self._fill_normal(0.02, None)

    @property
    def device(self) -> torch.device:
        return self.model.embed._tensor("weight").device

    def initialize(self, init=None, ctx=None, seed=None, std=None):
        """Gluon's ``initialize``: every weight placed on ``ctx`` and
        filled by ``init`` (by name: ``mx.init.Xavier()`` as in the
        reference's training script), from ``seed`` or the device's
        ``mx.random`` generator.  ``ctx`` defaults to where the model is,
        or, for a model still on the ``meta`` device, the current context
        (``gpu(0)``, which raises without a card).  With ``std`` instead,
        the fill of construction: Normal(0, std) weights and unit norm
        gains, where the model is (a model still on ``meta`` is placed on
        the current context first).  Returns ``self``."""
        placed = self.device.type != "meta"
        if std is not None:
            if init is not None or ctx is not None:
                raise MXNetError("initialize: std= takes neither init nor "
                                 "ctx")
            if not placed:
                self.to_empty(device=current_context().device)
            self._fill_normal(std, seed)
            return self
        if ctx is None and placed:
            ctx = _ctx_of(self.device)
        return super().initialize(init, ctx=ctx, seed=seed)

    @torch.no_grad()
    def _fill_normal(self, std, seed):
        """Normal(0, std) weights and unit norm gains, drawn on the
        model's device from ``seed`` (or the device's ``mx.random``
        generator when None)."""
        from .. import random as _random
        if seed is None:
            gen = _random.generator(self.device)
        else:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(int(seed))
        for name, p in self.named_parameters():
            if name.endswith("gamma"):
                p.fill_(1.0)
            else:
                p.normal_(0.0, std, generator=gen)

    def _tokens(self, tokens):
        if self.device.type == "meta":
            raise MXNetError(
                f"{self.name}: the weights have not been initialized; call "
                "initialize(init, ctx=...) (or construct with ctx=)")
        if isinstance(tokens, NDArray):
            tokens = tokens.tensor
        if not torch.is_tensor(tokens):
            tokens = torch.as_tensor(np.asarray(tokens, np.float32))
        return tokens.to(self.device)

    def _head_weight(self):
        """The (V, U) head matrix as the NDArray of its Parameter: the
        tied embedding or the untied head's Dense weight (one place for
        the branch: the forward, the serving head and the loss)."""
        block = self.model.embed if self._tied else self.lm_head
        return block._gluon_param("weight").data()

    def forward(self, tokens):
        return super().forward(self._tokens(tokens))

    def hybrid_forward(self, F, tokens):
        h = self.model(tokens)
        if self._tied:
            b, s, u = h.shape
            return F.dot(h.reshape((b * s, u)), self._head_weight(),
                         transpose_b=True).reshape(
                             (b, s, self.model.vocab_size))
        return self.lm_head(h)

    def loss(self, tokens, vocab_chunk=None):
        """Next-token cross-entropy over ``tokens`` (B, S): the mean over
        the B * (S - 1) predictions of positions ``:-1`` against the
        labels ``tokens[:, 1:]``, a 0-d NDArray.

        ``vocab_chunk`` (and, when None, any vocabulary of 32768 or more,
        with slabs of 8192) streams the head through
        ``chunked_softmax_ce``: the (N, V) logits are never made (2.1 GB
        in float32 at Llama-3-8B's 128256 and 4096 tokens) and the
        backward recomputes each slab.  Otherwise the full logits go
        through ``SoftmaxCrossEntropyLoss``.  Hybridized, the model's
        call is one CUDA-graph replay (and one at ``backward``); the
        head and the loss run around it."""
        from .. import ndarray as nd
        from ..gluon.loss import SoftmaxCrossEntropyLoss
        if not isinstance(tokens, NDArray):
            tokens = NDArray(self._tokens(tokens), ctx=_ctx_of(self.device))
        v = self.model.vocab_size
        if vocab_chunk is None and v >= 32768:
            vocab_chunk = 8192
        labels = nd.slice_axis(tokens, axis=1, begin=1,
                               end=None).reshape((-1,))
        if vocab_chunk:
            h = self.model(tokens)                          # (B, S, U)
            hid = nd.slice_axis(h, axis=1, begin=0,
                                end=-1).reshape((-1, self.model._units))
            return nd.chunked_softmax_ce(hid, self._head_weight(), labels,
                                         chunk=int(vocab_chunk)).mean()
        logits = self(tokens)
        pred = nd.slice_axis(logits, axis=1, begin=0,
                             end=-1).reshape((-1, v))
        return SoftmaxCrossEntropyLoss()(pred, labels).mean()

    @staticmethod
    def _check_cache_dtype(dtype):
        """KV caches must be floating: an integer cache would truncate
        every K/V write."""
        if not torch_dtype(dtype).is_floating_point:
            raise MXNetError(
                f"KV cache dtype must be floating, got {dtype!r} "
                "(an int cache truncates every K/V write)")

    def _rolling_cache_len(self, max_len, rolling):
        if not rolling:
            return max_len
        w = self.model.sliding_window
        if w is None:
            raise MXNetError(
                "rolling=True requires a model with sliding_window "
                "set (Mistral-style)")
        return min(int(w), max_len)

    def init_cache(self, batch_size, max_len, ctx=None, rolling=False,
                   dtype="float32"):
        """Zeroed per-layer KV caches (B, C, KV, D) on ``ctx`` (default:
        the model's device).  ``rolling=True`` (sliding-window models)
        allocates C = min(sliding_window, max_len): positions wrap via
        ``offset % C``."""
        self._check_cache_dtype(dtype)
        dev = self.device if ctx is None else ctx.device
        cache_len = self._rolling_cache_len(max_len, rolling)
        caches = []
        for layer in self.model.layers:
            a = layer.attn
            shp = (batch_size, cache_len, a._kv, a._d)
            caches.append((torch.zeros(shp, dtype=torch_dtype(dtype),
                                       device=dev),
                           torch.zeros(shp, dtype=torch_dtype(dtype),
                                       device=dev)))
        return caches

    def _head(self, h):
        """LM-head projection to (N, vocab)."""
        if self._tied:
            return dot(h.reshape(-1, self.model._units),
                       self.model.embed._tensor("weight"), transpose_b=True)
        return self.lm_head(h).reshape(-1, self.model.vocab_size)

    @_inline
    @torch.no_grad()
    def prefill(self, tokens, caches, last_pos=None):
        """Prompt pass filling the caches; returns the last position's
        logits (B, vocab).  ``last_pos`` (B,) reads each row's logits at
        its own last real token (right-padded prompts) through a one-hot
        contraction over positions."""
        tokens = self._tokens(tokens)
        dev = tokens.device
        x = self.model.embed(tokens)
        s = tokens.shape[1]
        c = caches[0][0].shape[1]
        perm = None
        if s > c:
            # rolling buffer shorter than the prompt: slot j holds the
            # newest position p = j (mod C); one permutation for all
            # layers
            start = s - c
            j = torch.arange(c, dtype=torch.float32, device=dev)
            perm = start + torch.remainder(j - start, c)
        for layer, (ck, cv) in zip(self.model.layers, caches):
            x = layer.prefill(x, ck, cv, perm=perm)
        h = self.model.final_norm(x)
        if last_pos is None:
            return self._head(h[:, -1:])
        b = tokens.shape[0]
        pos = torch.arange(s, dtype=torch.float32, device=dev).reshape(1, s)
        lp = torch.as_tensor(last_pos, device=dev).float().reshape(-1, 1)
        onehot = ((pos <= lp) & (pos >= lp)).to(h.dtype)      # (B, S)
        sel = (h * onehot.reshape(b, s, 1)).sum(dim=1)
        return self._head(sel.reshape(b, 1, self.model._units))

    @_inline
    @torch.no_grad()
    def decode_step(self, token, caches, offset):
        """One incremental step: token (B, 1) -> logits (B, vocab).

        ``offset`` is a number / 0-d tensor (one shared position) or a
        (B,) tensor giving every row its own absolute position (the
        continuous-batching shape: RoPE, the cache write and the
        validity mask all specialise per row)."""
        x = self.model.embed(self._tokens(token))
        max_len = caches[0][0].shape[1]
        pos = torch.arange(max_len, dtype=torch.float32, device=x.device)
        w = self.model.sliding_window
        if torch.is_tensor(offset) and offset.dim() == 1:
            return self._decode_step_slots(
                x, caches, offset.to(device=x.device, dtype=torch.float32),
                pos, w, max_len)
        off = float(offset)
        slot = None
        if w is not None and max_len <= int(w):
            # rolling buffer holding exactly the window: every written
            # slot is inside the band, so validity is "written yet"
            slot = off % float(max_len)
            mask = pos <= off
        else:
            mask = pos <= off
            if w is not None:
                mask = mask & (pos > off - float(w))
        mask = mask.reshape(1, 1, 1, max_len)
        for layer, (ck, cv) in zip(self.model.layers, caches):
            x = layer.step(x, ck, cv, off, mask, slot=slot)
        return self._head(self.model.final_norm(x))

    def _decode_step_slots(self, x, caches, off, pos, w, max_len):
        """Per-slot decode: ``off`` is (B,) absolute positions.  Rows are
        independent in attention, so one slot's stale cache (an evicted
        request) never reaches another's logits."""
        b = x.shape[0]
        posr = pos.reshape(1, max_len)
        offv = off.reshape(-1, 1)
        slot = None
        if w is not None and max_len <= int(w):
            slot = torch.remainder(off, float(max_len))
            mask = posr <= offv
        else:
            mask = posr <= offv
            if w is not None:
                mask = mask & (posr > offv - float(w))
        mask = mask.reshape(b, 1, 1, max_len)
        for layer, (ck, cv) in zip(self.model.layers, caches):
            x = layer.step(x, ck, cv, off, mask, slot=slot)
        return self._head(self.model.final_norm(x))

    @torch.no_grad()
    def generate(self, tokens, max_new_tokens, temperature=0.0,
                 top_k=0, seed=0, rolling=False, cache_dtype="float32"):
        """Autoregressive generation with a KV cache.

        tokens: (B, S) prompt.  Greedy when ``temperature=0``; else
        softmax sampling with optional top-k truncation, drawn on the
        host from ``np.random.RandomState(seed)``.  ``rolling=True``
        (sliding-window models) bounds the cache at O(W).  Returns the
        (B, S + max_new_tokens) float32 tokens: an NDArray on the
        prompt's context for an NDArray prompt, else a tensor on the
        model's device."""
        like = tokens
        tokens = self._tokens(tokens)
        dev = tokens.device
        b, s = tokens.shape
        max_len = s + max_new_tokens
        caches = self.init_cache(b, max_len, rolling=rolling,
                                 dtype=cache_dtype)
        rng = np.random.RandomState(seed)
        out_tokens = [tokens.float().cpu().numpy()]
        logits = self.prefill(tokens, caches)
        for step_i in range(max_new_tokens):
            # float64 softmax: float32 normalization residue can make
            # np.random.choice reject the distribution
            lg = logits.float().cpu().numpy().astype(np.float64)
            if temperature and temperature > 0:
                lg = lg / temperature
                if top_k and top_k > 0:
                    kk = min(int(top_k), lg.shape[-1])
                    kth = np.sort(lg, axis=-1)[:, -kk][:, None]
                    lg = np.where(lg < kth, -np.inf, lg)
                p = np.exp(lg - lg.max(-1, keepdims=True))
                p /= p.sum(-1, keepdims=True)
                nxt = np.stack([rng.choice(p.shape[1], p=p[i])
                                for i in range(b)])
            else:
                nxt = lg.argmax(-1)
            host_tok = nxt.astype("float32").reshape(b, 1)
            out_tokens.append(host_tok)
            if step_i < max_new_tokens - 1:   # last logits never read
                logits = self.decode_step(
                    torch.as_tensor(host_tok, device=dev), caches,
                    s + step_i)
        return _like(like, torch.as_tensor(
            np.concatenate(out_tokens, axis=1), device=dev))

    @torch.no_grad()
    def generate_beam(self, tokens, max_new_tokens, beam_size=4,
                      eos_id=None, alpha=1.0):
        """Beam search over the KV-cache decoder, eagerly: one decode
        step a beam step, the beams' bookkeeping on the host
        (:class:`~.nmt.BeamSearchSampler`).  The prompt is prefilled
        once per batch row and the caches repeated per beam (row-major,
        the sampler's ``i * beam + j`` layout).  ``eos_id=None`` runs
        every beam the full ``max_new_tokens``.  Returns ``(sequences
        (B, beam, S + <=N), scores (B, beam))``, best first, the sequences
        starting with the prompt: NDArrays on the prompt's context for an
        NDArray prompt, else tensors on the model's device."""
        from .nmt import BeamSearchSampler, BeamSearchScorer
        like = tokens
        tokens = self._tokens(tokens)
        dev = tokens.device
        b, s = tokens.shape
        k = int(beam_size)
        caches_b = self.init_cache(b, s + max_new_tokens)
        self.prefill(tokens, caches_b)
        caches = [(ck.repeat_interleave(k, dim=0),
                   cv.repeat_interleave(k, dim=0)) for ck, cv in caches_b]
        last = tokens[:, -1:].repeat_interleave(k, dim=0)

        def decoder(tok, step_idx, states):
            # step 0 writes position s-1 again with the same K/V and
            # gives the prefill's logits: no special first step
            lg = self.decode_step(tok, states, s - 1 + step_idx)
            return torch.log_softmax(lg.float(), dim=-1), states

        sampler = BeamSearchSampler(
            beam_size=k, eos_id=-1 if eos_id is None else int(eos_id),
            scorer=BeamSearchScorer(alpha=alpha),
            max_length=max_new_tokens + 1)
        samples, scores, _ = sampler(decoder, last, caches, b)
        # the samples start with the (repeated) last prompt token
        samp = samples.cpu().numpy().astype(np.int64)[:, :, 1:]
        prompt = tokens.cpu().numpy().astype(np.int64)
        out = np.concatenate([np.repeat(prompt[:, None], k, axis=1), samp],
                             axis=2)
        return (_like(like, torch.as_tensor(out.astype("f4"), device=dev)),
                _like(like, scores))

    @torch.no_grad()
    def generate_fused(self, tokens, max_new_tokens, temperature=0.0,
                       top_k=0, seed=0, rolling=False,
                       cache_dtype="float32"):
        """The whole generation as one CUDA-graph replay a call.

        Same contract as :meth:`generate`: the prefill (the flash kernel
        once a layer for an aligned prompt) and ``max_new_tokens - 1``
        decode steps at the static positions ``s + i``, every token
        picked on the device (``ops.random_ops.pick_tokens``: argmax, or
        Gumbel-max over the temperature-scaled, top-k truncated logits,
        drawn from this model's generator reseeded with ``seed`` at each
        call, so a seed gives the same tokens at every call; other draws
        than :meth:`generate`'s host stream).  One graph a signature
        ``(b, s, max_new_tokens, sampling, top_k when sampling, rolling,
        cache_dtype, dtype)``; the temperature is an input of the graph.
        On the CPU the same body runs eagerly.  Returns new (B, S +
        max_new_tokens) float32 tokens: an NDArray on the prompt's
        context for an NDArray prompt, else a tensor."""
        like = tokens
        tokens = self._tokens(tokens)
        if max_new_tokens <= 0:
            return _like(like, tokens.clone())
        dev = tokens.device
        b, s = tokens.shape
        n = int(max_new_tokens)
        sample = bool(temperature and temperature > 0)
        # top_k shapes the graph only when sampling
        kk = min(int(top_k), self.model.vocab_size) \
            if (top_k and sample) else 0
        # both raise on a bad argument before anything is captured
        self._check_cache_dtype(cache_dtype)
        self._rolling_cache_len(s + n, rolling)
        key = (b, s, n, sample, kk, bool(rolling), str(cache_dtype),
               str(tokens.dtype))
        cap = self._fused.get(key)
        if cap is None:
            cap = self._fused[key] = StepCapture(f"generate_fused{key}")
        gen = self._fused_gens.get(dev)
        if gen is None:
            gen = self._fused_gens[dev] = torch.Generator(device=dev)
        gen.manual_seed(int(seed))
        temp = torch.full((1,), float(temperature or 1.0),
                          dtype=torch.float32, device=dev)
        (out,) = cap.run(functools.partial(self._fused_body, key, gen),
                         [tokens, temp], generator=gen)
        # the graph's buffer is the next call's: hand out a copy
        return _like(like, out.clone())

    def _fused_body(self, key, gen, tokens, temp):
        b, s, n, sample, kk, rolling, cache_dtype, _ = key
        caches = self.init_cache(b, s + n, rolling=rolling,
                                 dtype=cache_dtype)

        def pick(logits):
            if sample:
                nxt = pick_tokens(logits, temp, kk, gen)
            else:
                nxt = torch.argmax(logits, dim=-1)
            return nxt.to(tokens.dtype).reshape(b, 1)

        tok = pick(self.prefill(tokens, caches))
        out = [tokens, tok]
        for i in range(n - 1):
            tok = pick(self.decode_step(tok, caches, s + i))
            out.append(tok)
        return (torch.cat(out, dim=1),)


def _like(prompt, out):
    """``out`` as the generation functions return it: an NDArray on the
    context of an NDArray ``prompt`` (the reference's return type), else
    the tensor itself."""
    if isinstance(prompt, NDArray):
        return NDArray(out.to(prompt.context.device), ctx=prompt.context)
    return out


_LLAMA_SPECS = {
    # test-size config
    "llama_tiny": dict(units=64, hidden=176, num_layers=2, num_heads=4,
                       num_kv_heads=2, rope_base=10000.0),
    # Llama-3-8B geometry (vocab passed by the caller; 128256 upstream)
    "llama3_8b": dict(units=4096, hidden=14336, num_layers=32,
                      num_heads=32, num_kv_heads=8,
                      rope_base=500000.0),
    # sliding-window test config: a band of 32 positions
    "mistral_tiny": dict(units=64, hidden=176, num_layers=2,
                         num_heads=4, num_kv_heads=2,
                         rope_base=10000.0, sliding_window=32),
    # Mistral-7B-v0.1 geometry (sliding_window=4096)
    "mistral_7b": dict(units=4096, hidden=14336, num_layers=32,
                       num_heads=32, num_kv_heads=8,
                       rope_base=10000.0, sliding_window=4096),
}


def get_llama(name, vocab_size=32000, attn_impl="sdpa", **kwargs):
    """The named configuration's :class:`LlamaModel` (on ``meta``);
    ``attn_impl="ring"`` splits each layer's attention over the ``sp``
    axis (``sp_axis=``) of the current mesh."""
    if name not in _LLAMA_SPECS:
        raise MXNetError(f"unknown llama config {name!r}; options "
                         f"{sorted(_LLAMA_SPECS)}")
    spec = dict(_LLAMA_SPECS[name])
    spec.update(kwargs)
    return LlamaModel(vocab_size=vocab_size, attn_impl=attn_impl, **spec)


def llama_tiny(**kwargs):
    return get_llama("llama_tiny", **kwargs)


def llama3_8b(vocab_size=128256, **kwargs):
    return get_llama("llama3_8b", vocab_size=vocab_size, **kwargs)
