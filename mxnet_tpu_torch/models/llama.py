"""Llama-family decoder-only LMs in PyTorch.

* RMSNorm, RoPE (adjacent feature pairs) and grouped-query attention
  as in the JAX package's ``models/llama.py``; prefill attention goes
  through ``dot_product_attention``, which sends every aligned prompt
  to the flash kernel on the card.
* ``get_llama`` builds the structure on the ``meta`` device (no
  memory); ``LlamaForCausalLM(model, ctx=..., dtype=...)`` places it on
  its context and fills it from the context's seeded generator, so
  the full Llama-3-8B geometry is made on the card directly.
* KV caches are (B, C, KV, D) tensors updated IN PLACE by ``prefill``
  and ``decode_step``.

Tokens are float32 ids, as in the JAX package; they are cast to long
at the embedding and gather.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..base import MXNetError, torch_dtype
from ..context import current_context
from ..ops.attention import dot_product_attention, rope
from ..ops.nn import cache_update, dot, embedding, rms_norm, silu, take

__all__ = ["LlamaModel", "LlamaForCausalLM", "RMSNormBlock",
           "get_llama", "llama_tiny", "llama3_8b"]

_META = "meta"


def _linear(in_units, out_units):
    return nn.Linear(in_units, out_units, bias=False, device=_META)


class RMSNormBlock(nn.Module):
    """RMSNorm with learned gamma; Llama's eps is 1e-5."""

    def __init__(self, units, eps=1e-5):
        super().__init__()
        self.eps = eps
        self.gamma = nn.Parameter(torch.ones(units, device=_META))

    def forward(self, x):
        return rms_norm(x, self.gamma, eps=self.eps)


class _Embedding(nn.Module):
    def __init__(self, vocab_size, units):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(vocab_size, units,
                                               device=_META))

    def forward(self, tokens):
        return embedding(tokens, self.weight)


class _LlamaAttention(nn.Module):
    def __init__(self, units, num_heads, num_kv_heads, rope_base,
                 sliding_window=None):
        super().__init__()
        if units % num_heads:
            raise MXNetError(f"units {units} % num_heads {num_heads}")
        if num_heads % num_kv_heads:
            raise MXNetError("num_heads must be a multiple of "
                             "num_kv_heads (GQA groups)")
        self._h = num_heads
        self._kv = num_kv_heads
        self._d = units // num_heads
        self._base = rope_base
        self._window = sliding_window
        self.q_proj = _linear(units, num_heads * self._d)
        self.k_proj = _linear(units, num_kv_heads * self._d)
        self.v_proj = _linear(units, num_kv_heads * self._d)
        self.o_proj = _linear(num_heads * self._d, units)

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

    def forward(self, x):
        b, s = x.shape[0], x.shape[1]
        q, k, v = self._qkv(x)
        out = dot_product_attention(q, k, v, causal=True,
                                    window=self._window)
        return self.o_proj(out.reshape(b, s, self._h * self._d))


class _LlamaMLP(nn.Module):
    """SwiGLU feed-forward: down(silu(gate(x)) * up(x))."""

    def __init__(self, units, hidden):
        super().__init__()
        self.gate_proj = _linear(units, hidden)
        self.up_proj = _linear(units, hidden)
        self.down_proj = _linear(hidden, units)

    def forward(self, x):
        return self.down_proj(silu(self.gate_proj(x)) * self.up_proj(x))


class _LlamaLayer(nn.Module):
    def __init__(self, units, hidden, num_heads, num_kv_heads, rope_base,
                 sliding_window=None):
        super().__init__()
        self.input_norm = RMSNormBlock(units)
        self.attn = _LlamaAttention(units, num_heads, num_kv_heads,
                                    rope_base,
                                    sliding_window=sliding_window)
        self.post_norm = RMSNormBlock(units)
        self.mlp = _LlamaMLP(units, hidden)

    def forward(self, x):
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


class LlamaModel(nn.Module):
    """The decoder stack, built on the ``meta`` device:
    :class:`LlamaForCausalLM` places it on its context."""

    def __init__(self, vocab_size, units, hidden, num_layers, num_heads,
                 num_kv_heads=None, rope_base=10000.0,
                 sliding_window=None):
        super().__init__()
        num_kv_heads = num_kv_heads or num_heads
        self._units = units
        self.vocab_size = vocab_size
        self.sliding_window = sliding_window
        self.embed = _Embedding(vocab_size, units)
        self.layers = nn.ModuleList(
            _LlamaLayer(units, hidden, num_heads, num_kv_heads, rope_base,
                        sliding_window=sliding_window)
            for _ in range(num_layers))
        self.final_norm = RMSNormBlock(units)

    def forward(self, tokens):
        x = self.embed(tokens)
        for layer in self.layers:
            x = layer(x)
        return self.final_norm(x)


class LlamaForCausalLM(nn.Module):
    """LM head over :class:`LlamaModel`, placed on ``ctx``.

    ``ctx`` defaults to the current context (``gpu(0)``); without a card
    that raises ``MXNetError`` unless ``ctx=mx.cpu()`` is passed.
    ``dtype`` is the weights' type.  Weights are filled at construction
    from the context's generator (``mx.random.seed``), with
    :meth:`initialize`'s defaults.  ``tie_embeddings=True`` shares the
    embedding matrix with the head (Llama-3.2-1B/3B); Llama-3-8B uses an
    untied head (``tie_embeddings=False``)."""

    def __init__(self, model: LlamaModel, tie_embeddings=True, ctx=None,
                 dtype="float32"):
        dev = (ctx or current_context()).device    # raises without a card
        if not all(p.is_meta for p in model.parameters()):
            raise MXNetError("LlamaForCausalLM places a model built by "
                             "get_llama (on the meta device); this one "
                             "already holds weights")
        super().__init__()
        self._tied = tie_embeddings
        self.model = model
        if not tie_embeddings:
            self.lm_head = _linear(model._units, model.vocab_size)
        self.to(dtype=torch_dtype(dtype))
        self.to_empty(device=dev)
        self.initialize()

    @property
    def device(self) -> torch.device:
        return self.model.embed.weight.device

    @torch.no_grad()
    def initialize(self, std=0.02, seed=None):
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
        if not torch.is_tensor(tokens):
            tokens = torch.as_tensor(np.asarray(tokens, np.float32))
        return tokens.to(self.device)

    def forward(self, tokens):
        h = self.model(self._tokens(tokens))
        b, s = h.shape[:2]
        return self._head(h).reshape(b, s, self.model.vocab_size)

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
                       self.model.embed.weight, transpose_b=True)
        return self.lm_head(h).reshape(-1, self.model.vocab_size)

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
            perm = torch.as_tensor(
                (start + (np.arange(c) - start) % c).astype("f4"),
                device=dev)
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
        (sliding-window models) bounds the cache at O(W).  Returns a
        (B, S + max_new_tokens) float32 tensor on the model's device."""
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
        return torch.as_tensor(np.concatenate(out_tokens, axis=1),
                               device=dev)


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


def get_llama(name, vocab_size=32000, **kwargs):
    """The named configuration's :class:`LlamaModel` (on ``meta``)."""
    if name not in _LLAMA_SPECS:
        raise MXNetError(f"unknown llama config {name!r}; options "
                         f"{sorted(_LLAMA_SPECS)}")
    spec = dict(_LLAMA_SPECS[name])
    spec.update(kwargs)
    return LlamaModel(vocab_size=vocab_size, **spec)


def llama_tiny(**kwargs):
    return get_llama("llama_tiny", **kwargs)


def llama3_8b(vocab_size=128256, **kwargs):
    return get_llama("llama3_8b", vocab_size=vocab_size, **kwargs)
