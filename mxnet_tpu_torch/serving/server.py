"""``Server``: continuously batched serving over a Llama-family model,
one CUDA-graph replay a dispatch.

Per ``(slots, prompt_len)`` bucket the server keeps one KV-cache pool
and dispatches three kinds of work.  Each is a *variant* with its own
``_capture.StepCapture``, named as the JAX package names its programs
(``_b{slots}x{len}_prefill``, ``_decode``, ``_decode{K}``):

* **prefill** (admit): one right-padded prompt at batch 1 into scratch
  pages (1, S, KV, D), copied into positions [0, S) of the slot by
  ``index_copy_`` with the slot as a device tensor, so one graph serves
  every slot; then the first token, picked at the prompt's own last
  position.  A bucket whose length is a multiple of 128 runs the flash
  kernel once per layer here, inside the graph.  The host reads that
  token once: the read ends the time to first token;
* **decode**: every slot of the bucket advances one token in lockstep at
  its OWN absolute position (per-slot RoPE offsets, cache writes and
  validity masks) over the pool, in place.  Inactive slots ride along
  with token 0; their rows never reach another slot's logits;
* **decode{K}** (``step(decode_steps=K)``): K decode steps unrolled in
  one graph, carrying the tokens and ``offset + active`` on the device
  and returning (K, slots) tokens: one host read per K tokens.  A
  request that finishes inside the K keeps the rows after it out of its
  tokens.

On a CUDA device the first dispatch of a variant runs eagerly, the
second captures its graph, and every later one stages its inputs
(tokens, offsets, active mask and temperatures; or prompt, last
position, slot and temperature) into the graph's static inputs and
replays it: one launch from the host.  The outputs are the graph's own
buffers, which the host reads before the next dispatch.  On the CPU the
same bodies run eagerly.

Sampling (``ops.random_ops.pick_tokens``) is one device function of
the logits, the temperatures and the active mask, with the server-wide
top-k static: argmax at ``temperature == 0``, else a Gumbel-max draw
from the temperature-scaled, top-k truncated softmax, from the device's
``mx.random`` generator (registered with the graphs, so replays draw
anew; ``mx.random.seed`` makes a new generator, and the variants then
capture again).
"""
from __future__ import annotations

import itertools
import time
import weakref
from typing import Dict, List, Optional

import numpy as np
import torch

from .._capture import StepCapture
from ..base import MXNetError
from ..context import current_context
from ..ops.random_ops import pick_tokens
from .kvcache import KVCachePool
from .scheduler import ACTIVE, BucketScheduler, Request

__all__ = ["Server", "servers"]

# every live Server, in the order they were made
_servers: "weakref.WeakValueDictionary[int, Server]" = \
    weakref.WeakValueDictionary()
_uid = itertools.count(1)


def servers() -> List["Server"]:
    """The live servers of this process (parity: ``serving.servers``)."""
    return list(_servers.values())


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
        _servers[next(_uid)] = self
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
            b.key: {"prefills": 0, "decode_steps": 0,
                    "decode_dispatches": 0, "tokens": 0,
                    "prefill_s": 0.0, "decode_s": 0.0,
                    "steady_dispatches": 0, "steady_misses": 0}
            for b in self.sched.buckets}
        # suffix of a variant (bucket, kind, K) -> (its StepCapture, body)
        self._variants: Dict[str, tuple] = {}

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

    def step(self, decode_steps: int = 1) -> dict:
        """One scheduling round: admit every queued request with a free
        slot (one prefill replay each), then advance every non-empty
        bucket by ``decode_steps`` tokens: one decode replay a bucket
        (``decode_steps > 1``: the K-step variant, one host read per K
        tokens).  Returns round stats."""
        k = int(decode_steps)
        if k < 1:
            raise MXNetError(f"decode_steps must be >= 1, got "
                             f"{decode_steps}")
        admitted = 0
        for bucket, slot, req in self.sched.admissions():
            self._admit(bucket, slot, req)
            admitted += 1
        tokens = 0
        for bucket in self.sched.buckets:
            if bucket.n_active():
                tokens += self._decode(bucket, k)
        return {"admitted": admitted, "tokens": tokens,
                "active": len(self.sched.active_requests()),
                "queued": self.sched.queue_depth()}

    def run(self, decode_steps: int = 1,
            max_rounds: Optional[int] = None) -> int:
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
            self.step(decode_steps=decode_steps)
            rounds += 1
        return rounds

    def generate(self, prompts, max_new_tokens: Optional[int] = None,
                 temperature: float = 0.0,
                 decode_steps: int = 1) -> List[np.ndarray]:
        """Submit every prompt, run to drain, and return ``prompt +
        continuation`` per request, in order."""
        reqs = [self.submit(p, max_new_tokens=max_new_tokens,
                            temperature=temperature) for p in prompts]
        self.run(decode_steps=decode_steps)
        return [r.tokens() for r in reqs]

    def evict(self, req: Request, reason: str = "user",
              requeue: bool = False) -> bool:
        """Remove a live request (slot or queue); returns True when it
        was live.  ``requeue=True`` restarts it from its prompt."""
        return self.sched.evict(req, reason, requeue=requeue)

    def stats(self) -> dict:
        """Occupancy, queue depth, the graphs (``captures``,
        ``replays``, ``graph_pool_bytes``: device memory the captures
        reserved) and per-bucket counts: prefills, decode steps (tokens
        a slot advanced) and dispatches, tokens, host seconds in each
        (every dispatch ends in a host read of its tokens, so they
        include the device's work), and the steady state:
        ``steady_dispatches`` are dispatches of a variant that already
        had its graph, ``steady_misses`` the captures among them (0
        unless a variant lost its graph: a reseed).  On the CPU there
        is no graph and all of these stay 0."""
        caps = [cap for cap, _ in self._variants.values()]
        out = {"occupancy": self.sched.occupancy(),
               "queue_depth": self.sched.queue_depth(),
               "captures": sum(c.captures for c in caps),
               "replays": sum(c.replays for c in caps),
               "graph_pool_bytes": sum(c.pool_bytes for c in caps),
               "buckets": {}}
        for b in self.sched.buckets:
            out["buckets"][f"{b.slots}x{b.prompt_len}"] = \
                dict(self._bucket_stats[b.key])
        return out

    # -- internals ----------------------------------------------------------
    @staticmethod
    def _suffix(bucket, kind: str, k: int = 1) -> str:
        return f"_b{bucket.slots}x{bucket.prompt_len}_{kind}" + \
            (str(k) if k > 1 else "")

    def _pick(self, logits, temps, active=None):
        """Per-row next token (float32 ids) on the device: argmax where
        ``temps == 0``, a top-k truncated, temperature-scaled draw
        elsewhere; 0 on rows whose ``active`` is 0."""
        from .. import random as _random
        nxt = pick_tokens(logits, temps, self._kk,
                          _random.generator(logits.device))
        if active is not None:
            nxt = torch.where(active > 0, nxt, torch.zeros_like(nxt))
        return nxt

    def _prefill_body(self, bucket):
        pool = self._pools[bucket.key]
        S = bucket.prompt_len
        k0 = pool.pairs()[0][0]
        page = (1, S) + tuple(k0.shape[2:])

        def body(prompt, last_pos, slot, temp):
            scratch = [(torch.empty(page, dtype=k0.dtype, device=k0.device),
                        torch.empty(page, dtype=k0.dtype, device=k0.device))
                       for _ in range(pool.num_layers)]
            logits = self.lm.prefill(prompt, scratch, last_pos=last_pos)
            for (ck, cv), (sk, sv) in zip(pool.pairs(), scratch):
                ck[:, :S].index_copy_(0, slot, sk)
                cv[:, :S].index_copy_(0, slot, sv)
            return (self._pick(logits, temp),)
        return body

    def _decode_body(self, bucket, k: int):
        pool = self._pools[bucket.key]

        def body(tok, off, active, temps):
            rows = []
            for i in range(k):
                logits = self.lm.decode_step(tok, pool.pairs(), off)
                nxt = self._pick(logits, temps, active)
                rows.append(nxt)
                if i + 1 < k:
                    # inactive slots hold their position and token 0,
                    # as the host's bookkeeping does
                    tok, off = nxt.reshape(-1, 1), off + active
            return (torch.stack(rows),)
        return body

    @torch.no_grad()
    def _dispatch(self, bucket, kind: str, k: int, inputs):
        """Run one variant of ``bucket`` on ``inputs`` (device tensors):
        eagerly, captured or replayed.  Returns its outputs (on the card,
        the graph's buffers, valid until the variant's next dispatch)."""
        suffix = self._suffix(bucket, kind, k)
        if suffix not in self._variants:
            self._variants[suffix] = (
                StepCapture("Server" + suffix),
                self._prefill_body(bucket) if kind == "prefill"
                else self._decode_body(bucket, k))
        cap, body = self._variants[suffix]
        had_graph = cap.captures
        out = cap.run(body, inputs)
        if had_graph:
            stats = self._bucket_stats[bucket.key]
            stats["steady_dispatches"] += 1
            stats["steady_misses"] += cap.captures - had_graph
        return out

    def _admit(self, bucket, slot: int, req: Request):
        t0 = time.perf_counter()
        dev = self.device
        prompt = np.zeros((1, bucket.prompt_len), np.float32)
        prompt[0, :req.prompt_len] = req.prompt
        (tok,) = self._dispatch(bucket, "prefill", 1, [
            torch.as_tensor(prompt, device=dev),
            torch.full((1,), req.prompt_len - 1.0, device=dev),
            torch.full((1,), slot, dtype=torch.long, device=dev),
            torch.full((1,), req.temperature, device=dev)])
        tok = int(tok[0])                  # the host's one read: TTFT
        bucket.last_tokens[slot] = float(tok)
        stats = self._bucket_stats[bucket.key]
        stats["prefills"] += 1
        stats["tokens"] += 1
        stats["prefill_s"] += time.perf_counter() - t0
        if req.push_token(tok):
            self._finish(req)

    def _decode(self, bucket, k: int) -> int:
        t0 = time.perf_counter()
        dev = self.device
        active = bucket.active.copy()
        (toks,) = self._dispatch(bucket, "decode", k, [
            torch.as_tensor(bucket.last_tokens.reshape(-1, 1), device=dev),
            torch.as_tensor(bucket.offsets, device=dev),
            torch.as_tensor(active, device=dev),
            torch.as_tensor(bucket.temps, device=dev)])
        toks = toks.tolist()               # (K, slots): one host read
        # offsets advance K for every slot active at dispatch; a finished
        # request's release() rewinds its slot
        bucket.offsets += k * active
        produced = 0
        for row in toks:
            for j in np.nonzero(active > 0)[0]:
                req = bucket.requests[int(j)]
                if req is None or req.state != ACTIVE:
                    continue               # finished inside the K
                tok = int(row[int(j)])
                bucket.last_tokens[int(j)] = float(tok)
                produced += 1
                if req.push_token(tok):
                    self._finish(req)
        stats = self._bucket_stats[bucket.key]
        stats["decode_steps"] += k
        stats["decode_dispatches"] += 1
        stats["tokens"] += produced
        stats["decode_s"] += time.perf_counter() - t0
        return produced

    def _finish(self, req: Request):
        self.sched.finish(req)
