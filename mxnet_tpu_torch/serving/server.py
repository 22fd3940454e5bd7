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

Failure, overload and resize protocols (the JAX package's):

* **poison and recover**: a dispatch that fails before its launch (the
  ``dispatch`` fault point) is retried up to ``MXTPU_DISPATCH_RETRIES``
  times; one that fails at or after its launch has written the KV pages
  in place, so the server latches ``poisoned`` and :meth:`Server.step`
  refuses until :meth:`Server.recover` zeroes the pages in place and
  requeues every resident request (prompts are host-owned, so they
  replay from scratch);
* **deadlines and shedding**: ``submit(ttl_ms=)`` sheds a request whose
  deadline the estimated queue wait already exceeds, and every step
  first evicts the live requests whose deadline passed;
* **live resize**: :meth:`Server.resize_slots` moves every bucket to a
  new slot count (prewarm -> drain -> migrate -> swap): the new pools'
  variants are run and captured before anything moves, so the first
  dispatch after the swap is a replay, and a failure after the drain
  heals onto the new slot count with the residents requeued;
* **signatures**: :meth:`Server.save_signature` writes the variants a
  server dispatched, and :meth:`Server.warm_start` captures them all in
  a new server before its first request (a graph cannot cross
  processes).

Every protocol reports to :mod:`..telemetry` under the JAX package's
metric names and event kinds.
"""
from __future__ import annotations

import hashlib
import itertools
import json
import os
import time
import weakref
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import _capture, telemetry
from .._capture import StepCapture
from ..base import MXNetError
from ..context import current_context
from ..elastic import faults as _faults
from ..ops.random_ops import pick_tokens
from .kvcache import KVCachePool
from .scheduler import ACTIVE, SHED, Bucket, BucketScheduler, Request

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


def _dtype_name(dtype) -> str:
    """A dtype as numpy spells it (``float32``, ``bfloat16``)."""
    return str(dtype).replace("torch.", "")


def fingerprint(device) -> dict:
    """What a warm-start manifest must match: the torch and CUDA
    versions and the device's name and compute capability."""
    fp = {"torch": torch.__version__, "cuda": torch.version.cuda,
          "device": "cpu", "capability": None}
    if device.type == "cuda":
        fp["device"] = torch.cuda.get_device_name(device)
        fp["capability"] = "%d.%d" % torch.cuda.get_device_capability(
            device)
    return fp


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
        uid = next(_uid)
        self.name = f"serving_{lm.name}_{uid}"
        self._pools: Dict[tuple, KVCachePool] = {
            b.key: KVCachePool(lm, b.slots, b.cache_len, ctx=self.ctx,
                               dtype=self.cache_dtype)
            for b in self.sched.buckets}
        self._bucket_stats = self._fresh_bucket_stats()
        # suffix of a variant (bucket, kind, K) -> (its StepCapture, its
        # body, its manifest row)
        self._variants: Dict[str, tuple] = {}
        self._poisoned: Optional[str] = None
        self.warm_started = False
        self._struct_hash = self._compute_struct_hash()
        _servers[uid] = self

    # -- identity ---------------------------------------------------------
    def _compute_struct_hash(self, buckets=None) -> str:
        """The JAX package's structural identity of the model, bucket and
        sampler configuration: parameter shapes and dtype names, the
        ``(slots, prompt_len, cache_len)`` rows (``buckets``, else the
        live ones), top-k, cache dtype, max_new_tokens and vocab.  Equal
        configurations hash equal in both packages."""
        rows = buckets if buckets is not None else \
            [(b.slots, b.prompt_len, b.cache_len)
             for b in self.sched.buckets]
        parts = (
            tuple((tuple(int(n) for n in p.data(self.ctx).shape),
                   _dtype_name(p.data(self.ctx).dtype))
                  for p in self.lm.collect_params().values()),
            tuple(sorted(tuple(r) for r in rows)),
            self._kk, self.cache_dtype, self.max_new_tokens,
            int(self.lm.model.vocab_size))
        return hashlib.sha256(repr(parts).encode()).hexdigest()[:16]

    # -- public API -------------------------------------------------------
    def submit(self, prompt, max_new_tokens: Optional[int] = None,
               temperature: float = 0.0,
               eos_id: Optional[int] = None,
               ttl_ms: Optional[float] = None) -> Request:
        """Queue one generation request; admission happens at the next
        :meth:`step`.  Raises ``MXNetError`` when no bucket fits the
        prompt or the queue is full (both recorded as retained
        ``slot_oom`` events).

        ``ttl_ms`` arms the overload policy: when the estimated queue
        wait (:meth:`estimate_queue_wait`) already exceeds the deadline,
        the request is shed here (state ``shed``, a ``shed`` event,
        ``mxtpu_requests_shed_total`` and an ``MXNetError`` the caller
        can turn into a fast refusal) instead of waiting in the queue
        for a slot it could only reach too late."""
        mnt = self.max_new_tokens if max_new_tokens is None \
            else min(int(max_new_tokens), self.max_new_tokens)
        req = Request(prompt, mnt, temperature=temperature,
                      eos_id=self.eos_id if eos_id is None else eos_id,
                      ttl_ms=ttl_ms)
        if req.deadline is not None:
            est = self.estimate_queue_wait()
            budget = req.deadline - time.perf_counter()
            if est is not None and est > budget:
                req.state = SHED
                req.evict_reason = "shed"
                telemetry.counter(
                    "mxtpu_requests_shed_total",
                    "requests shed at enqueue by the overload policy"
                    ).inc()
                telemetry.record_event(
                    "shed", server=self.name, request=req.id,
                    prompt_len=req.prompt_len, ttl_ms=req.ttl_ms,
                    est_wait_s=round(est, 4),
                    queue_depth=self.sched.queue_depth())
                raise MXNetError(
                    f"request shed: estimated queue wait {est:.3f}s "
                    f"exceeds the {req.ttl_ms:g}ms deadline (queue "
                    f"depth {self.sched.queue_depth()}); retry with "
                    "backoff, raise ttl_ms, or add slots")
        try:
            self.sched.enqueue(req)
        except MXNetError as e:
            telemetry.record_event(
                "slot_oom", server=self.name, request=req.id,
                prompt_len=req.prompt_len,
                queue_depth=self.sched.queue_depth(),
                reason=str(e)[:200])
            raise
        telemetry.counter("mxtpu_serving_requests_total",
                          "requests submitted to the serving plane").inc()
        self._update_gauges()
        return req

    def estimate_queue_wait(self) -> Optional[float]:
        """Expected seconds a request submitted now waits for a slot:
        the waves of requests ahead of it (queue depth over the plane's
        slots) times ``max_new_tokens`` times the per-token service
        time, read from the decode histogram and the tokens counter.
        ``None`` before any decode: a server with no history never
        sheds."""
        q = self.sched.queue_depth()
        if q == 0 and self.sched.occupancy() < 1.0:
            return 0.0
        dh = telemetry.histogram(
            "mxtpu_serving_decode_seconds",
            "one decode dispatch wall clock (s)").summary()
        tokens = telemetry.counter(
            "mxtpu_serving_tokens_total",
            "tokens generated by the serving plane").value
        if not dh["count"] or tokens <= 0:
            return None
        per_token_s = dh["sum"] / tokens
        slots = sum(b.slots for b in self.sched.buckets) or 1
        waves = (q + slots) / slots
        return waves * self.max_new_tokens * per_token_s

    def _expire_deadlines(self) -> int:
        """Evict every live request (in a slot or queued) whose deadline
        passed: the ``request_evicted`` trail of :meth:`evict` plus a
        ``deadline_evicted`` event and counter."""
        now = time.perf_counter()
        expired = [r for r in self.sched.active_requests()
                   + list(self.sched.queue) if r.expired(now)]
        n = 0
        for req in expired:
            waited = now - req.submit_t
            if not self.evict(req, reason="deadline", requeue=False):
                continue
            n += 1
            telemetry.counter(
                "mxtpu_deadline_evictions_total",
                "live requests evicted on an expired deadline").inc()
            telemetry.record_event(
                "deadline_evicted", server=self.name, request=req.id,
                ttl_ms=req.ttl_ms, waited_s=round(waited, 4),
                generated=len(req.generated))
        return n

    def step(self, decode_steps: int = 1) -> dict:
        """One scheduling round: evict the requests whose deadline
        passed, admit every queued request with a free slot (one prefill
        replay each), then advance every non-empty bucket by
        ``decode_steps`` tokens: one decode replay a bucket
        (``decode_steps > 1``: the K-step variant, one host read per K
        tokens).  Returns round stats.  Raises ``MXNetError`` while the
        server is poisoned."""
        k = int(decode_steps)
        if k < 1:
            raise MXNetError(f"decode_steps must be >= 1, got "
                             f"{decode_steps}")
        if self._poisoned is not None:
            raise MXNetError(
                "this Server's KV-cache pages were written by a dispatch "
                "that failed and are no longer valid; call recover() to "
                "zero the pages and requeue resident requests. Original "
                f"error: {self._poisoned}")
        # the deadline sweep first: an expired queued request must not
        # take a slot (and a prefill), and an expired resident frees its
        # slot for this round's admissions
        self._expire_deadlines()
        admitted = 0
        pending = self.sched.admissions()
        for i, (bucket, slot, req) in enumerate(pending):
            try:
                self._admit(bucket, slot, req)
            except Exception:
                # admissions() placed every request up front: the failed
                # one and those behind it hold slots they were never
                # prefilled into, so they go back to the head of the
                # queue (in reverse, to keep their order).  A poisoned
                # server requeues every resident at recover() instead.
                if self._poisoned is None:
                    for _b, _s, r in reversed(pending[i:]):
                        self.sched.evict(r, reason="admit_aborted",
                                         requeue=True)
                raise
            admitted += 1
        tokens = 0
        for bucket in self.sched.buckets:
            if bucket.n_active():
                tokens += self._decode(bucket, k)
        self._update_gauges()
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
        was live (a finished request is left untouched: no event, no
        counter).  Leaves a retained ``request_evicted`` event and
        counts ``mxtpu_serving_requests_evicted_total``;
        ``requeue=True`` restarts it from its prompt."""
        if not self.sched.evict(req, reason, requeue=requeue):
            return False
        telemetry.counter("mxtpu_serving_requests_evicted_total",
                          "requests evicted from the serving plane").inc()
        telemetry.record_event("request_evicted", server=self.name,
                               request=req.id, reason=reason,
                               requeued=bool(requeue),
                               generated=len(req.generated))
        self._update_gauges()
        return True

    def recover(self) -> int:
        """Zero every KV page in place (the captured graphs keep their
        addresses), requeue the resident requests in their order and
        clear the poison latch; returns the number requeued.  Records
        the recovery (``elastic.manager.record_recovery``)."""
        from ..elastic.manager import record_recovery
        t0 = time.perf_counter()
        was_poisoned = self._poisoned is not None
        requeued = 0
        # reverse: a requeue goes to the head of the queue
        for req in reversed(self.sched.active_requests()):
            self.evict(req, reason="recover", requeue=True)
            requeued += 1
        for pool in self._pools.values():
            pool.reset()
        for b in self.sched.buckets:
            b.offsets[:] = 0.0
            b.active[:] = 0.0
            b.temps[:] = 0.0
            b.last_tokens[:] = 0.0
        self._poisoned = None
        record_recovery("serving", time.perf_counter() - t0,
                        was_poisoned, name=self.name, requeued=requeued)
        return requeued

    # -- live resize ------------------------------------------------------
    def _fresh_bucket_stats(self):
        return {b.key: {"prefills": 0, "decode_steps": 0,
                        "decode_dispatches": 0, "tokens": 0,
                        "prefill_s": 0.0, "decode_s": 0.0,
                        "steady_dispatches": 0, "steady_misses": 0}
                for b in self.sched.buckets}

    def resize_slots(self, new_slots: int,
                     reason: Optional[str] = None) -> dict:
        """Move every bucket to ``new_slots`` slots while the server
        runs (typically driven by ``elastic.ServingAutoscaler``):

        * **prewarm**: new pools for the new slot count, and every
          recorded variant built over them and run (captured on the
          card) with all slots inactive, before anything moves; a
          failure here leaves the server on its old configuration;
        * **drain**: dispatches are synchronous, so nothing is in
          flight between rounds; the downtime clock starts here;
        * **migrate**: each resident's pages are copied into the new
          pool by slot index (checked page by page with
          ``elastic.integrity.page_checksum`` while
          ``MXTPU_INTEGRITY`` is on); on a shrink the residents beyond
          the new count are requeued and replay from their prompts;
        * **swap**: buckets and pools rebind, and the old variants'
          graphs and pools are released.  A failure after the drain
          heals onto the new slot count with zeroed pages and every
          resident requeued (a ``recovery`` event).

        Each transition is a fault point (``resize_prewarm``,
        ``resize_drain``, ``resize_reshard``, ``resize_swap``).  Returns
        the record ``elastic.resize.resizes`` keeps."""
        from ..elastic import integrity as _integrity
        from ..elastic import resize as _resize
        from ..elastic.manager import record_recovery

        new_slots = int(new_slots)
        if new_slots < 1:
            raise MXNetError(f"resize_slots: need >= 1, got {new_slots}")
        if self._poisoned is not None:
            raise MXNetError("server is poisoned; recover() before "
                             "resizing")
        old_counts = sorted({b.slots for b in self.sched.buckets})
        if old_counts == [new_slots]:
            raise MXNetError(f"resize_slots: already at {new_slots} slots")
        # a construction with per-bucket slot counts uniformizes on its
        # first resize; the record keeps the real before-state
        old_slots = old_counts[0] if len(old_counts) == 1 else old_counts

        phase = "prewarm"
        prewarmed: Dict[str, tuple] = {}
        try:
            _faults.maybe_fire("resize_prewarm")
            t_prewarm = time.perf_counter()
            new_hash = self._compute_struct_hash(
                buckets=[(new_slots, b.prompt_len, b.cache_len)
                         for b in self.sched.buckets])
            # keyed by the OLD bucket key until the swap
            shadow = {b.key: Bucket(new_slots, b.prompt_len, b.cache_len)
                      for b in self.sched.buckets}
            new_pools = {key: KVCachePool(self.lm, new_slots,
                                          nb.cache_len, ctx=self.ctx,
                                          dtype=self.cache_dtype)
                         for key, nb in shadow.items()}
            for suffix, (_cap, _body, row) in sorted(
                    self._variants.items()):
                b = self._bucket_for_suffix(suffix)
                if b is None:
                    continue
                v = self._prewarm(shadow[b.key], new_pools[b.key],
                                  row["kind"], max(1, int(row["k"])))
                prewarmed[v[2]["suffix"]] = v
            prewarm_s = time.perf_counter() - t_prewarm
            phase = "drain"
            _faults.maybe_fire("resize_drain")
            t_drain = time.perf_counter()
        except Exception as e:
            self._release(prewarmed)
            _resize._note_failed("serving", phase, repr(e),
                                 name=self.name, still_on="old_config")
            raise

        healed = False
        heal_error = None
        migrated = 0
        requeued = 0
        try:
            _faults.maybe_fire("resize_reshard")
            new_buckets = []
            for b in list(self.sched.buckets):
                nb = shadow[b.key]
                residents = [(j, r) for j, r in enumerate(b.requests)
                             if r is not None]
                kept = residents[:new_slots]
                for _j, r in reversed(residents[new_slots:]):
                    self.evict(r, reason="resize_shrink", requeue=True)
                    requeued += 1
                if kept:
                    self._migrate(self._pools[b.key], new_pools[b.key],
                                  kept, _integrity.enabled())
                    migrated += len(kept)
                for j2, (j, _r) in enumerate(kept):
                    nb.adopt_slot(b, j, j2)
                new_buckets.append(nb)
            _faults.maybe_fire("resize_swap")
            self.sched.buckets = sorted(new_buckets,
                                        key=lambda x: x.prompt_len)
        except Exception as e:
            # heal onto the NEW slot count: the prewarmed pools zeroed in
            # place (their graphs are ready) and every resident requeued;
            # the old bucket tables still list every resident (adopt_slot
            # leaves the source row until the swap), and `requeued` keeps
            # the shrink overflow that already reached the queue
            heal_error = repr(e)
            _resize._note_failed("serving", "reshard_swap", heal_error,
                                 name=self.name, heal="requeue_replay")
            t_heal = time.perf_counter()
            for b in list(self.sched.buckets):
                for r in reversed([r for r in b.requests
                                   if r is not None]):
                    if self.evict(r, reason="resize_heal", requeue=True):
                        requeued += 1
            self.sched.buckets = sorted(
                (Bucket(new_slots, nb.prompt_len, nb.cache_len)
                 for nb in shadow.values()),
                key=lambda x: x.prompt_len)
            for pool in new_pools.values():
                pool.reset()
            self._poisoned = None
            migrated = 0
            healed = True
            record_recovery("resize_heal", time.perf_counter() - t_heal,
                            False, name=self.name, requeued=requeued)
        self._pools = {shadow[key].key: pool
                       for key, pool in new_pools.items()}
        old, self._variants = self._variants, prewarmed
        self._release(old)
        self._bucket_stats = self._fresh_bucket_stats()
        self._struct_hash = new_hash
        rec = {
            "kind": "serving", "name": self.name,
            "slots_from": old_slots, "slots_to": new_slots,
            "buckets": [f"{b.slots}x{b.prompt_len}"
                        for b in self.sched.buckets],
            "prewarmed_variants": len(prewarmed),
            "migrated": migrated, "requeued": requeued,
            "healed": healed,
            "prewarm_seconds": round(prewarm_s, 4),
            "downtime_seconds": round(time.perf_counter() - t_drain, 4),
        }
        if reason:
            rec["autoscale_reason"] = reason
        if heal_error:
            rec["heal_error"] = heal_error[:300]
        _resize._note_completed(rec)
        self._update_gauges()
        return dict(rec)

    @torch.no_grad()
    def _migrate(self, src_pool, dst_pool, kept, verify: bool):
        """Copy the pages of ``kept`` (``[(old slot, request)]``) into
        slots ``0..len(kept)-1`` of ``dst_pool``; with ``verify`` hold
        every page's checksum against its source slot."""
        from ..elastic import integrity as _integrity
        src = src_pool.flat()
        idx = torch.as_tensor([j for j, _ in kept], dtype=torch.long,
                              device=src[0].device)
        dst_pool.adopt([c.index_select(0, idx) for c in src],
                       slots=range(len(kept)))
        if not verify:
            return
        dst = dst_pool.flat()
        for j2, (j, r) in enumerate(kept):
            for ci, (c, d) in enumerate(zip(src, dst)):
                if _integrity.page_checksum(c[j]) != \
                        _integrity.page_checksum(d[j2]):
                    raise MXNetError(
                        f"KV-page checksum mismatch migrating request "
                        f"{r.id} slot {j}->{j2} (page tensor {ci}): the "
                        "request will be requeued and replayed")

    def _release(self, variants: dict):
        """Destroy the graphs of ``variants``, drop them (their bodies
        hold the pools they write) and hand the memory back to the
        card."""
        for cap, _body, _row in variants.values():
            cap.release()
        variants.clear()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def stats(self) -> dict:
        """The server's name, occupancy, queue depth, ``poisoned`` and
        ``warm_started``, the graphs (``captures``, ``replays``,
        ``graph_pool_bytes``: device memory the live captures reserved)
        and per-bucket counts: prefills, decode steps (tokens a slot
        advanced) and dispatches, tokens, host seconds in each (every
        dispatch ends in a host read of its tokens, so they include the
        device's work), and the steady state: ``steady_dispatches`` are
        dispatches of a variant that already had its graph,
        ``steady_misses`` the captures among them (0 unless a variant
        lost its graph: a reseed).  On the CPU there is no graph and the
        graph counts stay 0."""
        caps = [cap for cap, _, _ in self._variants.values()]
        out = {"name": self.name, "occupancy": self.sched.occupancy(),
               "queue_depth": self.sched.queue_depth(),
               "poisoned": self._poisoned is not None,
               "warm_started": self.warm_started,
               "captures": sum(c.captures for c in caps),
               "replays": sum(c.replays for c in caps),
               "graph_pool_bytes": sum(c.pool_bytes for c in caps),
               "buckets": {}}
        for b in self.sched.buckets:
            out["buckets"][f"{b.slots}x{b.prompt_len}"] = \
                dict(self._bucket_stats[b.key])
        return out

    # -- signatures -------------------------------------------------------
    def save_signature(self, path: str) -> str:
        """Write the serving warm-start manifest: every dispatched
        variant's suffix, kind, K and input shapes and dtypes, with the
        structural hash, the buckets and this process's
        :func:`fingerprint`.  A new server over the same model and
        configuration feeds it to :meth:`warm_start`."""
        if not self._variants:
            raise MXNetError(
                "save_signature: serve at least one request first (no "
                "variants recorded)")
        manifest = {
            "format": 1, "kind": "mxtpu_serving_plane",
            "fingerprint": fingerprint(self.device),
            "net": self.lm.name,
            "struct_hash": self._struct_hash,
            "max_new_tokens": self.max_new_tokens,
            "top_k": self._kk, "cache_dtype": self.cache_dtype,
            "buckets": [
                {"slots": b.slots, "prompt_len": b.prompt_len,
                 "cache_len": b.cache_len}
                for b in self.sched.buckets],
            "variants": [self._variants[k][2]
                         for k in sorted(self._variants)],
        }
        tmp = path + f".tmp{os.getpid()}"
        try:
            with open(tmp, "w") as f:
                json.dump(manifest, f, indent=1, sort_keys=True)
            os.replace(tmp, path)
        except BaseException:
            try:
                os.remove(tmp)
            except OSError:
                pass
            raise
        return path

    def warm_start(self, path: str) -> bool:
        """Build every variant a :meth:`save_signature` manifest records
        and run it (captured on the card) with all slots inactive, so
        the first request is served by replays with 0 captures.  Never
        raises for a bad or mismatched manifest: returns False with a
        ``warm_start`` event naming the reason, and the server captures
        on first use as it always did."""

        def _fail(reason):
            telemetry.record_event("warm_start", name=self.name,
                                   ok=False, reason=reason)
            return False

        try:
            with open(path) as f:
                m = json.load(f)
        except (OSError, ValueError) as e:
            return _fail(f"unreadable manifest: {e!r}"[:300])
        if not isinstance(m, dict) or \
                m.get("kind") != "mxtpu_serving_plane" or \
                m.get("format") != 1:
            return _fail("not an mxtpu_serving_plane manifest")
        if m.get("fingerprint") != fingerprint(self.device):
            return _fail("environment fingerprint mismatch "
                         "(torch/CUDA/device)")
        if m.get("struct_hash") != self._struct_hash:
            return _fail("structural hash mismatch: the manifest "
                         "describes a different model/bucket/sampler "
                         "configuration")
        want = sorted((b["slots"], b["prompt_len"], b["cache_len"])
                      for b in m.get("buckets", ()))
        have = sorted((b.slots, b.prompt_len, b.cache_len)
                      for b in self.sched.buckets)
        if want != have:
            return _fail(f"bucket mismatch: manifest {want} vs "
                         f"configured {have}")
        if self._poisoned is not None:
            return _fail("server is poisoned")
        try:
            sources = {}
            for v in m.get("variants", ()):
                suffix = str(v["suffix"])
                bucket = self._bucket_for_suffix(suffix)
                if bucket is None:
                    return _fail(f"variant {suffix!r} names no "
                                 "configured bucket")
                variant = self._prewarm(bucket, self._pools[bucket.key],
                                        str(v["kind"]),
                                        max(1, int(v.get("k") or 0)))
                self._variants[suffix] = variant
                sources[self.name + suffix] = \
                    "captured" if variant[0].captures else "eager"
            if not sources:
                return _fail("manifest has no compiled variants")
        except Exception as e:
            return _fail(f"warm-start failed: {e!r}"[:300])
        self.warm_started = True
        telemetry.record_event("warm_start", name=self.name, ok=True,
                               sources=sources)
        return True

    # -- variants ---------------------------------------------------------
    @staticmethod
    def _suffix(bucket, kind: str, k: int = 1) -> str:
        return f"_b{bucket.slots}x{bucket.prompt_len}_{kind}" + \
            (str(k) if k > 1 else "")

    def _bucket_for_suffix(self, suffix: str):
        for b in self.sched.buckets:
            if suffix.startswith(f"_b{b.slots}x{b.prompt_len}_"):
                return b
        return None

    def _idle_inputs(self, bucket, kind: str):
        """Inputs of a dispatch with every slot inactive (the dtypes and
        shapes of ``_admit``'s and ``_decode``'s)."""
        dev = self.device
        if kind == "prefill":
            return [torch.zeros((1, bucket.prompt_len), device=dev),
                    torch.zeros((1,), device=dev),
                    torch.zeros((1,), dtype=torch.long, device=dev),
                    torch.zeros((1,), device=dev)]
        n = bucket.slots
        return [torch.zeros((n, 1), device=dev),
                torch.zeros((n,), device=dev),
                torch.zeros((n,), device=dev),
                torch.zeros((n,), device=dev)]

    def _new_variant(self, bucket, pool, kind: str, k: int):
        """(StepCapture, body, manifest row) of one variant over
        ``pool``."""
        suffix = self._suffix(bucket, kind, k)
        body = self._prefill_body(bucket, pool) if kind == "prefill" \
            else self._decode_body(pool, k)
        row = {"suffix": suffix, "kind": kind,
               "k": k if kind == "decode" and k > 1 else 0,
               "inputs": [[list(t.shape), _dtype_name(t.dtype)]
                          for t in self._idle_inputs(bucket, kind)]}
        return StepCapture("Server" + suffix), body, row

    def _prewarm(self, bucket, pool, kind: str, k: int):
        """A new variant run on idle inputs until it has its graph (on
        the CPU: once, eagerly), so its next dispatch is a replay."""
        variant = self._new_variant(bucket, pool, kind, k)
        cap, body, _row = variant
        inputs = self._idle_inputs(bucket, kind)
        runs = _capture.WARMUP + 1 if self.device.type == "cuda" else 1
        with torch.no_grad():
            for _ in range(runs):
                cap.run(body, inputs)
        return variant

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

    def _prefill_body(self, bucket, pool):
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

    def _decode_body(self, pool, k: int):
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

    # -- dispatch ---------------------------------------------------------
    def _pre_launch(self, name: str):
        """The ``dispatch`` fault point, retried up to
        ``MXTPU_DISPATCH_RETRIES`` times (nothing has run yet, so a
        retry is safe); the last failure is recorded and raised."""
        from .. import envs
        attempt = 0
        while True:
            try:
                _faults.on_dispatch(name)
                return
            except _faults.FaultError as e:
                if attempt >= int(envs.get("MXTPU_DISPATCH_RETRIES")):
                    telemetry.record_event("error", op=name,
                                           error=repr(e)[:500])
                    telemetry.auto_dump(reason=f"dispatch:{name}")
                    raise
                attempt += 1
                telemetry.counter(
                    "mxtpu_dispatch_retries_total",
                    "transient dispatch failures absorbed by retry").inc()
                telemetry.record_event("dispatch_retry", op=name,
                                       attempt=attempt, backoff_ms=0.0,
                                       error=repr(e)[:300])

    def _poison(self, pool, name: str, e: Exception):
        pool.poison(repr(e))
        self._poisoned = repr(e)
        telemetry.counter(
            "mxtpu_poisons_total",
            "dispatches that failed after their launch (state lost)"
            ).inc()
        telemetry.record_event("poison", where="serving", name=name,
                               error=repr(e)[:500])
        telemetry.auto_dump(reason=f"serving_poisoned:{name}")
        raise MXNetError(
            "serving dispatch failed after its launch wrote the KV-cache "
            "pages; call Server.recover() to zero the pages and requeue "
            f"resident requests. Original error: {e!r}") from e

    @torch.no_grad()
    def _dispatch(self, bucket, kind: str, k: int, inputs) -> list:
        """Run one variant of ``bucket`` on ``inputs`` (device tensors):
        eagerly, captured or replayed, and read its outputs to the host
        (``.tolist()``).  A failure before the launch propagates (after
        the retries); one at or after it poisons the server."""
        pool = self._pools[bucket.key]
        if pool.poisoned is not None:
            raise MXNetError(f"bucket {bucket.key} pool is poisoned "
                             f"({pool.poisoned}); call recover()")
        suffix = self._suffix(bucket, kind, k)
        variant = self._variants.get(suffix) or \
            self._new_variant(bucket, pool, kind, k)
        cap, body, _row = variant
        name = self.name + suffix
        telemetry.record_event("dispatch", op=name)
        if _faults._active:
            self._pre_launch(name)
        had_graph = cap.captures
        with telemetry.step_owner(self, "serving_dispatch"):
            try:
                out = cap.run(body, inputs)
                if _faults._active:
                    _faults.after_launch(name)
                host = [o.tolist() for o in out]
            except Exception as e:
                self._poison(pool, name, e)
        # recorded once it ran: save_signature lists what was served
        self._variants.setdefault(suffix, variant)
        if had_graph:
            stats = self._bucket_stats[bucket.key]
            stats["steady_dispatches"] += 1
            stats["steady_misses"] += cap.captures - had_graph
        return host

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
        telemetry.counter("mxtpu_serving_prefills_total",
                          "admission prefill dispatches").inc()
        bucket.last_tokens[slot] = float(tok)
        stats = self._bucket_stats[bucket.key]
        stats["prefills"] += 1
        stats["tokens"] += 1
        telemetry.counter("mxtpu_serving_tokens_total",
                          "tokens generated by the serving plane").inc()
        finished = req.push_token(tok)
        telemetry.histogram(
            "mxtpu_serving_ttft_seconds",
            "submit -> first generated token (s)").observe(
            req.first_token_t - req.submit_t)
        dt = time.perf_counter() - t0
        stats["prefill_s"] += dt
        telemetry.histogram(
            "mxtpu_serving_prefill_seconds",
            "one admission (prefill dispatch + first token) (s)"
            ).observe(dt)
        if finished:
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
        # (K, slots), read once. Offsets advance K for every slot active
        # at dispatch; a finished request's release() rewinds its slot
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
        dt = time.perf_counter() - t0
        telemetry.histogram("mxtpu_serving_decode_seconds",
                            "one decode dispatch wall clock (s)"
                            ).observe(dt)
        if produced:
            telemetry.counter(
                "mxtpu_serving_tokens_total",
                "tokens generated by the serving plane").inc(produced)
        stats = self._bucket_stats[bucket.key]
        stats["decode_steps"] += k
        stats["decode_dispatches"] += 1
        stats["tokens"] += produced
        stats["decode_s"] += dt
        return produced

    def _finish(self, req: Request):
        self.sched.finish(req)
        telemetry.counter("mxtpu_serving_requests_completed_total",
                          "requests run to completion").inc()
        if req.done_t is not None:
            telemetry.histogram(
                "mxtpu_serving_request_seconds",
                "submit -> completion per-request latency (s)"
                ).observe(req.done_t - req.submit_t)

    def _update_gauges(self):
        telemetry.gauge("mxtpu_serving_batch_occupancy",
                        "active slots / total slots").set(
            self.sched.occupancy())
        telemetry.gauge("mxtpu_serving_queue_depth",
                        "requests waiting for a slot").set(
            self.sched.queue_depth())
