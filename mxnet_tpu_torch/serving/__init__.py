"""The serving plane: continuous batching over fixed buckets with
in-place KV-cache pages.

* :mod:`~.kvcache`: preallocated per-slot K/V pages;
* :mod:`~.scheduler`: admission and eviction over fixed
  ``(slots, prompt_len)`` buckets;
* :mod:`~.server`: ``Server``, one prefill per admission and one
  lockstep decode of ``decode_steps`` tokens per bucket per round, each
  one CUDA-graph replay on the card.
"""
from .kvcache import KVCachePool
from .scheduler import Bucket, BucketScheduler, Request
from .server import Server

__all__ = ["KVCachePool", "Bucket", "BucketScheduler", "Request",
           "Server"]
