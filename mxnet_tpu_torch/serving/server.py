"""``Server``: continuously batched serving over a Llama-family model.

Per ``(slots, prompt_len)`` bucket the server keeps one KV-cache pool
and runs two kinds of work:

* **admit**: prefill one right-padded prompt at batch 1 straight into
  the slot's page of the pool (in place: ``pool[slot, :S] = page``,
  where the JAX package donates the pool to a compiled program), then
  sample the first token at the prompt's own last position.  A prompt
  bucket whose length is a multiple of 128 runs the flash kernel once
  per layer here;
* **decode**: every slot of the bucket advances one token in lockstep
  at its OWN absolute position (per-slot RoPE offsets, cache writes and
  validity masks), and the sampler picks greedy-or-temperature per
  slot.  Inactive slots ride along; their rows never reach another
  slot's logits.

Sampling is greedy at ``temperature == 0``, else softmax sampling with
optional server-wide top-k truncation, drawn from the device's
``mx.random`` generator.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..base import MXNetError
from ..context import current_context
from .kvcache import KVCachePool
from .scheduler import ACTIVE, BucketScheduler, Request

__all__ = ["Server"]


def _default_buckets():
    from .. import envs
    slots = int(envs.get("MXTPU_SERVING_SLOTS"))
    lens = [int(x) for x in
            str(envs.get("MXTPU_SERVING_BUCKETS")).split(",") if x.strip()]
    return [(slots, n) for n in lens]


class Server:
    """Continuously batched serving over a ``LlamaForCausalLM``-shaped
    model (anything with ``init_cache``/``prefill``/``decode_step``).

    Args:
      lm: the causal LM, on the server's device.
      buckets: ``[(slots, prompt_len), ...]`` shape classes (default
        from ``MXTPU_SERVING_SLOTS`` x ``MXTPU_SERVING_BUCKETS``).
      max_new_tokens: per-request generation cap (sizes the pages:
        ``cache_len = prompt_len + max_new_tokens``); default
        ``MXTPU_SERVING_MAX_NEW_TOKENS``.
      top_k: server-wide top-k truncation for sampled requests
        (0 = full softmax).
      eos_id: stop token (None = run to the token budget).
      ctx: device context; default the current one (``gpu(0)``), which
        raises ``MXNetError`` on a machine without a card.
      cache_dtype: KV page dtype (``bfloat16`` halves page memory).
      max_queue: wait-queue bound (``MXTPU_SERVING_MAX_QUEUE``).
    """

    def __init__(self, lm, buckets=None, max_new_tokens: int = None,
                 top_k: int = 0, eos_id: Optional[int] = None,
                 ctx=None, cache_dtype: str = "float32",
                 max_queue: Optional[int] = None):
        from .. import envs
        self.ctx = ctx or current_context()
        self.device = self.ctx.device      # raises without a card
        if lm.device != self.device:
            raise MXNetError(f"the model is on {lm.device} but the "
                             f"server's context is {self.ctx}")
        if max_new_tokens is None:
            max_new_tokens = int(envs.get("MXTPU_SERVING_MAX_NEW_TOKENS"))
        if max_queue is None:
            max_queue = int(envs.get("MXTPU_SERVING_MAX_QUEUE"))
        self.lm = lm
        self.max_new_tokens = int(max_new_tokens)
        self.eos_id = None if eos_id is None else int(eos_id)
        self.cache_dtype = str(cache_dtype)
        vocab = int(lm.model.vocab_size)
        self._kk = min(int(top_k), vocab) if top_k else 0
        self.sched = BucketScheduler(buckets or _default_buckets(),
                                     self.max_new_tokens, max_queue)
        self._pools: Dict[tuple, KVCachePool] = {
            b.key: KVCachePool(lm, b.slots, b.cache_len, ctx=self.ctx,
                               dtype=self.cache_dtype)
            for b in self.sched.buckets}
        self._bucket_stats: Dict[tuple, dict] = {
            b.key: {"prefills": 0, "decode_steps": 0, "tokens": 0,
                    "prefill_s": 0.0, "decode_s": 0.0}
            for b in self.sched.buckets}

    # -- public API -------------------------------------------------------
    def submit(self, prompt, max_new_tokens: Optional[int] = None,
               temperature: float = 0.0,
               eos_id: Optional[int] = None) -> Request:
        """Queue one generation request; admission happens at the next
        :meth:`step`.  Raises ``MXNetError`` when no bucket fits the
        prompt or the queue is full."""
        mnt = self.max_new_tokens if max_new_tokens is None \
            else min(int(max_new_tokens), self.max_new_tokens)
        req = Request(prompt, mnt, temperature=temperature,
                      eos_id=self.eos_id if eos_id is None else eos_id)
        self.sched.enqueue(req)
        return req

    def step(self) -> dict:
        """One scheduling round: admit every queued request with a free
        slot (one prefill each), then advance every non-empty bucket by
        one token.  Returns round stats."""
        admitted = 0
        for bucket, slot, req in self.sched.admissions():
            self._admit(bucket, slot, req)
            admitted += 1
        tokens = 0
        for bucket in self.sched.buckets:
            if bucket.n_active():
                tokens += self._decode(bucket)
        return {"admitted": admitted, "tokens": tokens,
                "active": len(self.sched.active_requests()),
                "queued": self.sched.queue_depth()}

    def run(self, max_rounds: Optional[int] = None) -> int:
        """Step until every submitted request finished; returns rounds
        run.  ``max_rounds`` bounds a runaway loop."""
        if max_rounds is None:
            pending = len(self.sched.active_requests()) \
                + self.sched.queue_depth()
            max_rounds = 16 + pending * (self.max_new_tokens + 2)
        rounds = 0
        while self.sched.active_requests() or self.sched.queue_depth():
            if rounds >= max_rounds:
                raise MXNetError(
                    f"serving run() exceeded {max_rounds} rounds with "
                    "requests still live")
            self.step()
            rounds += 1
        return rounds

    def generate(self, prompts, max_new_tokens: Optional[int] = None,
                 temperature: float = 0.0) -> List[np.ndarray]:
        """Submit every prompt, run to drain, and return ``prompt +
        continuation`` per request, in order."""
        reqs = [self.submit(p, max_new_tokens=max_new_tokens,
                            temperature=temperature) for p in prompts]
        self.run()
        return [r.tokens() for r in reqs]

    def evict(self, req: Request, reason: str = "user",
              requeue: bool = False) -> bool:
        """Remove a live request (slot or queue); returns True when it
        was live.  ``requeue=True`` restarts it from its prompt."""
        return self.sched.evict(req, reason, requeue=requeue)

    def stats(self) -> dict:
        """Occupancy, queue depth and per-bucket counts: prefills,
        decode steps, tokens, and host seconds spent in each (every
        prefill and decode ends in a host read of its tokens, so the
        seconds include the device's work)."""
        out = {"occupancy": self.sched.occupancy(),
               "queue_depth": self.sched.queue_depth(), "buckets": {}}
        for b in self.sched.buckets:
            out["buckets"][f"{b.slots}x{b.prompt_len}"] = \
                dict(self._bucket_stats[b.key])
        return out

    # -- internals ----------------------------------------------------------
    def _pick(self, logits, temps):
        """Per-row next token on the device: argmax where ``temps == 0``,
        a draw from the temperature-scaled (top-k truncated) softmax
        elsewhere.  ``temps`` is a host array (0 on free slots)."""
        nxt = torch.argmax(logits, dim=-1)
        rows = np.nonzero(temps > 0)[0]
        if rows.size:
            from .. import random as _random
            idx = torch.as_tensor(rows, device=logits.device)
            t = torch.as_tensor(temps[rows], dtype=torch.float32,
                                device=logits.device)
            lg = logits[idx].float() / t.clamp_min(1e-6)[:, None]
            if self._kk:
                kth = torch.topk(lg, self._kk, dim=-1).values[:, -1:]
                lg = lg.masked_fill(lg < kth, float("-inf"))
            nxt[idx] = torch.multinomial(
                torch.softmax(lg, dim=-1), 1,
                generator=_random.generator(logits.device))[:, 0]
        return nxt

    def _admit(self, bucket, slot: int, req: Request):
        t0 = time.perf_counter()
        S = bucket.prompt_len
        prompt = np.zeros((1, S), np.float32)
        prompt[0, :req.prompt_len] = req.prompt
        pool = self._pools[bucket.key]
        logits = self.lm.prefill(
            torch.as_tensor(prompt, device=self.device),
            pool.pages(slot, S),
            last_pos=torch.tensor([req.prompt_len - 1.0],
                                  device=self.device))
        tok = int(self._pick(logits, np.asarray([req.temperature]))[0])
        bucket.last_tokens[slot] = float(tok)
        stats = self._bucket_stats[bucket.key]
        stats["prefills"] += 1
        stats["tokens"] += 1
        stats["prefill_s"] += time.perf_counter() - t0
        if req.push_token(tok):
            self._finish(req)

    def _decode(self, bucket) -> int:
        t0 = time.perf_counter()
        active = bucket.active.copy()
        logits = self.lm.decode_step(
            torch.as_tensor(bucket.last_tokens.reshape(-1, 1),
                            device=self.device),
            self._pools[bucket.key].pairs(),
            torch.as_tensor(bucket.offsets, device=self.device))
        toks = self._pick(logits, bucket.temps.copy()).tolist()
        # offsets advance for every slot active at dispatch; a finished
        # request's release() rewinds its slot
        bucket.offsets += active
        produced = 0
        for j in np.nonzero(active > 0)[0]:
            req = bucket.requests[int(j)]
            if req is None or req.state != ACTIVE:
                continue
            tok = int(toks[int(j)])
            bucket.last_tokens[int(j)] = float(tok)
            produced += 1
            if req.push_token(tok):
                self._finish(req)
        stats = self._bucket_stats[bucket.key]
        stats["decode_steps"] += 1
        stats["tokens"] += produced
        stats["decode_s"] += time.perf_counter() - t0
        return produced

    def _finish(self, req: Request):
        self.sched.finish(req)
