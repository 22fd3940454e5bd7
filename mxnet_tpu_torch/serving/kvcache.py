"""KV-cache plane: preallocated per-slot K/V pages, updated in place.

A bucket's caches are one (K, V) tensor pair per transformer layer,
shaped ``(slots, cache_len, kv_heads, head_dim)``: slot ``j`` is
request ``j``'s page.  Admission prefills straight into slot ``j``'s
page through views (:meth:`KVCachePool.pages`); decode writes each
slot's new K/V in place; eviction only clears the slot's active bit on
the host.  Nothing is reallocated while the server runs, so a decode
step never doubles cache memory.
"""
from __future__ import annotations

from typing import List, Tuple

import torch

from ..base import MXNetError

__all__ = ["KVCachePool"]


class KVCachePool:
    """Per-bucket K/V pages for ``slots`` concurrent requests over
    ``lm``'s layers.

    Args:
      lm: a ``models.LlamaForCausalLM`` (anything with ``init_cache``).
      slots: concurrent requests the pool holds (the bucket batch dim).
      cache_len: positions per slot (bucket prompt length + the
        server's max new tokens).
      ctx: device context for the pages (default: the model's).
      dtype: cache dtype (floating; ``bfloat16`` halves page memory).
    """

    def __init__(self, lm, slots: int, cache_len: int, ctx=None,
                 dtype: str = "float32"):
        if slots < 1 or cache_len < 1:
            raise MXNetError(
                f"KVCachePool needs slots >= 1 and cache_len >= 1, got "
                f"{slots}/{cache_len}")
        self.slots = int(slots)
        self.cache_len = int(cache_len)
        self.dtype = str(dtype)
        self._pairs: List[Tuple[torch.Tensor, torch.Tensor]] = \
            lm.init_cache(self.slots, self.cache_len, ctx=ctx,
                          dtype=self.dtype)

    @property
    def num_layers(self) -> int:
        return len(self._pairs)

    def pairs(self):
        """The live per-layer ``(K, V)`` pairs."""
        return list(self._pairs)

    def flat(self) -> list:
        """``[k0, v0, k1, v1, ...]``."""
        return [t for pair in self._pairs for t in pair]

    def pages(self, slot: int, length: int):
        """Per-layer ``(k, v)`` views of positions ``[0, length)`` of
        ``slot``, shaped (1, length, KV, D).  They alias the pool: a
        prefill that writes its caches through them fills the slot's
        page in place (``pool[slot, :length] = page``)."""
        if not 0 <= slot < self.slots:
            raise MXNetError(f"pages: slot {slot} out of range "
                             f"[0, {self.slots})")
        if not 0 < length <= self.cache_len:
            raise MXNetError(f"pages: length {length} outside "
                             f"(0, {self.cache_len}]")
        return [(k[slot:slot + 1, :length], v[slot:slot + 1, :length])
                for k, v in self._pairs]

    @torch.no_grad()
    def reset(self):
        """Zero every page."""
        for t in self.flat():
            t.zero_()
