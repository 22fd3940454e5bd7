"""Continuous-batching scheduler: admit and evict between decode steps
into FIXED bucket shapes.

A bucket is a ``(slots, prompt_len)`` shape class.  Admission writes a
slot's cache page and sets its active bit, eviction clears the bit:
shapes never change, so the decode step always runs one batch of
``slots`` rows.  Pure host logic (numpy only): ``Server`` drives it.
"""
from __future__ import annotations

import itertools
import time
from collections import deque
from typing import List, Optional

import numpy as np

from ..base import MXNetError

__all__ = ["Request", "Bucket", "BucketScheduler"]

_req_uid = itertools.count(1)

#: request lifecycle states
QUEUED, ACTIVE, DONE, EVICTED = "queued", "active", "done", "evicted"


class Request:
    """One generation request moving through the serving plane."""

    __slots__ = ("id", "prompt", "max_new_tokens", "temperature",
                 "eos_id", "state", "generated", "bucket", "slot",
                 "submit_t", "first_token_t", "done_t", "evict_reason")

    def __init__(self, prompt, max_new_tokens: int,
                 temperature: float = 0.0,
                 eos_id: Optional[int] = None):
        self.id = next(_req_uid)
        self.prompt = np.asarray(prompt, dtype=np.float32).reshape(-1)
        if self.prompt.size == 0:
            raise MXNetError("empty prompt")
        self.max_new_tokens = int(max_new_tokens)
        if self.max_new_tokens < 1:
            raise MXNetError(
                f"max_new_tokens must be >= 1, got {max_new_tokens}")
        self.temperature = float(temperature)
        self.eos_id = None if eos_id is None else int(eos_id)
        self.state = QUEUED
        self.generated: List[int] = []
        self.bucket: Optional["Bucket"] = None
        self.slot: Optional[int] = None
        self.submit_t = time.perf_counter()
        self.first_token_t: Optional[float] = None
        self.done_t: Optional[float] = None
        self.evict_reason: Optional[str] = None

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.size)

    def tokens(self) -> np.ndarray:
        """Prompt + generated continuation (what the caller reads
        back)."""
        return np.concatenate(
            [self.prompt, np.asarray(self.generated, np.float32)])

    def push_token(self, tok: int) -> bool:
        """Record one generated token; returns True when the request
        just FINISHED (hit eos or its token budget)."""
        if self.first_token_t is None:
            self.first_token_t = time.perf_counter()
        self.generated.append(int(tok))
        if self.eos_id is not None and int(tok) == self.eos_id:
            return True
        return len(self.generated) >= self.max_new_tokens


class Bucket:
    """One fixed ``(slots, prompt_len)`` shape class and its host-side
    slot table.  ``cache_len = prompt_len + max_new_tokens`` positions
    per slot; a slot's offset is the ABSOLUTE next position (it drives
    RoPE, the cache write and the validity mask)."""

    def __init__(self, slots: int, prompt_len: int, cache_len: int):
        if slots < 1 or prompt_len < 1 or cache_len <= prompt_len:
            raise MXNetError(
                f"bad bucket (slots={slots}, prompt_len={prompt_len}, "
                f"cache_len={cache_len}): need slots/prompt_len >= 1 "
                "and cache_len > prompt_len")
        self.slots = int(slots)
        self.prompt_len = int(prompt_len)
        self.cache_len = int(cache_len)
        self.requests: List[Optional[Request]] = [None] * self.slots
        self.offsets = np.zeros(self.slots, np.float32)
        self.active = np.zeros(self.slots, np.float32)
        self.temps = np.zeros(self.slots, np.float32)
        self.last_tokens = np.zeros(self.slots, np.float32)

    @property
    def key(self):
        return (self.slots, self.prompt_len)

    def n_active(self) -> int:
        return int(self.active.sum())

    def free_slot(self) -> Optional[int]:
        for j, r in enumerate(self.requests):
            if r is None:
                return j
        return None

    def place(self, req: Request, slot: int):
        """Host bookkeeping of an admission (the page itself is written
        by the server's prefill)."""
        if self.requests[slot] is not None:
            raise MXNetError(f"slot {slot} is occupied")
        self.requests[slot] = req
        req.state = ACTIVE
        req.bucket, req.slot = self, slot
        # the prefill samples the first token at prompt_len-1's logits;
        # decode continues at absolute position prompt_len
        self.offsets[slot] = float(req.prompt_len)
        self.active[slot] = 1.0
        self.temps[slot] = req.temperature

    def release(self, slot: int):
        """Drop a slot back to free: active bit off, offset rewound.
        The page keeps stale contents that the per-row validity mask
        never exposes to other slots."""
        req = self.requests[slot]
        self.requests[slot] = None
        self.active[slot] = 0.0
        self.offsets[slot] = 0.0
        self.temps[slot] = 0.0
        self.last_tokens[slot] = 0.0
        if req is not None:
            req.bucket, req.slot = None, None


class BucketScheduler:
    """FIFO admission over fixed buckets and a bounded wait queue.

    ``buckets``: ``(slots, prompt_len)`` pairs.  A request lands in the
    SMALLEST bucket whose ``prompt_len`` holds its prompt (right-padded
    there); prompts longer than every bucket are rejected, and so are
    submissions past ``max_queue``."""

    def __init__(self, buckets, max_new_tokens: int, max_queue: int):
        if not buckets:
            raise MXNetError("need at least one (slots, prompt_len) "
                             "bucket")
        self.max_new_tokens = int(max_new_tokens)
        self.max_queue = int(max_queue)
        self.buckets: List[Bucket] = [
            Bucket(s, p, p + self.max_new_tokens)
            for s, p in sorted(buckets, key=lambda b: b[1])]
        if len({b.prompt_len for b in self.buckets}) != len(self.buckets):
            raise MXNetError("duplicate prompt_len buckets")
        self.queue: deque = deque()

    def select_bucket(self, prompt_len: int) -> Optional[Bucket]:
        for b in self.buckets:
            if prompt_len <= b.prompt_len:
                return b
        return None

    def enqueue(self, req: Request) -> Bucket:
        """Queue ``req``; raises ``MXNetError`` when no bucket fits the
        prompt or the queue is full."""
        bucket = self.select_bucket(req.prompt_len)
        if bucket is None:
            raise MXNetError(
                f"prompt of {req.prompt_len} tokens exceeds the "
                f"largest bucket "
                f"({self.buckets[-1].prompt_len}); add a bigger "
                "prompt-length bucket")
        if len(self.queue) >= self.max_queue:
            raise MXNetError(
                f"serving queue full ({self.max_queue}); evict or "
                "raise MXTPU_SERVING_MAX_QUEUE")
        self.queue.append(req)
        return bucket

    def admissions(self):
        """Pop every queued request whose bucket has a free slot, as
        ``[(bucket, slot, request)]`` in FIFO order (a request whose
        bucket is full never blocks one whose bucket has room).  Each
        is already PLACED, so later entries cannot take its slot."""
        out = []
        blocked = deque()
        while self.queue:
            req = self.queue.popleft()
            bucket = self.select_bucket(req.prompt_len)
            slot = bucket.free_slot()
            if slot is None:
                blocked.append(req)
                continue
            bucket.place(req, slot)
            out.append((bucket, slot, req))
        self.queue = blocked
        return out

    def finish(self, req: Request):
        req.state = DONE
        req.done_t = time.perf_counter()
        if req.bucket is not None and req.slot is not None:
            req.bucket.release(req.slot)

    def evict(self, req: Request, reason: str,
              requeue: bool = False) -> bool:
        """Remove a live request from its slot or the queue; returns
        True when anything happened.  A finished or evicted request is
        left untouched.  ``requeue=True`` restarts it from its prompt,
        at the head of the queue."""
        if req.state in (DONE, EVICTED):
            return False
        if req.bucket is not None and req.slot is not None:
            req.bucket.release(req.slot)
        elif req in self.queue:
            self.queue.remove(req)
        req.evict_reason = reason
        if requeue:
            req.state = QUEUED
            req.generated = []
            req.first_token_t = None
            self.queue.appendleft(req)
        else:
            req.state = EVICTED
        return True

    def active_requests(self) -> List[Request]:
        return [r for b in self.buckets for r in b.requests
                if r is not None]

    def queue_depth(self) -> int:
        return len(self.queue)

    def occupancy(self) -> float:
        total = sum(b.slots for b in self.buckets)
        used = sum(b.n_active() for b in self.buckets)
        return used / total if total else 0.0
