"""``DataLoader``, as the JAX package's ``gluon/data/dataloader.py`` on
its thread-pool route.

* **Samples** are fetched (``dataset[i]``: reading, decoding, the
  transforms) on the host, under ``cpu()``: with ``num_workers > 0`` a
  thread pool fetches ``prefetch`` batches ahead of the consumer.  A
  worker's exception surfaces at the batch it poisoned.
* **Batches** are made by ``batchify_fn`` on the consumer's thread, so
  the consumer's context applies (``current_context()`` is per thread:
  a worker would make them on ``gpu(0)`` even inside ``with mx.cpu():``).
* **prefetch_to_device** (a Context, or True for the current one)
  stages the next ``depth`` batches on the card ahead of the consumer:
  each batch is made on the host, copied into pinned host memory and
  from there with ``non_blocking`` copies on a side stream; the
  consumer's stream waits for the copy's event before it reads the
  batch.  A pinned host buffer is kept until its copy has finished.
"""
from __future__ import annotations

import concurrent.futures
from collections import deque

import numpy as np
import torch

from ... import ndarray as nd
from ...context import Context, cpu, current_context
from ...ndarray.ndarray import NDArray
from .sampler import BatchSampler, RandomSampler, SequentialSampler

__all__ = ["DataLoader", "default_batchify_fn", "default_mp_batchify_fn"]

#: batches staged on the card ahead of the consumer by prefetch_to_device
PREFETCH_DEPTH = 2


def default_batchify_fn(data):
    """Stack samples into a batch: NDArrays with ``nd.stack``, tuples
    field by field, anything else through numpy."""
    if isinstance(data[0], NDArray):
        return nd.stack(*data)
    if isinstance(data[0], tuple):
        return [default_batchify_fn(list(i)) for i in zip(*data)]
    data = np.asarray(data)
    return nd.array(data, dtype=data.dtype)


default_mp_batchify_fn = default_batchify_fn


def _map_arrays(batch, fn):
    if isinstance(batch, NDArray):
        return fn(batch)
    if isinstance(batch, (list, tuple)):
        moved = [_map_arrays(b, fn) for b in batch]
        return moved if isinstance(batch, list) else tuple(moved)
    return batch


class _DeviceStager:
    """Host batches to one card: pinned host copies, ``non_blocking``
    copies on a side stream, one event a batch."""

    def __init__(self, ctx):
        self.ctx = ctx
        self.device = ctx.device
        self.stream = torch.cuda.Stream(self.device)
        self._retired = []   # (event, pinned host tensors) in flight

    def stage(self, batch):
        pinned = []

        def copy(a):
            host = a._t.detach()
            host = host if host.is_pinned() else host.pin_memory()
            pinned.append(host)
            return NDArray(host.to(self.device, non_blocking=True),
                           ctx=self.ctx)
        with torch.cuda.stream(self.stream):
            moved = _map_arrays(batch, copy)
            event = torch.cuda.Event()
            event.record(self.stream)
        return moved, event, pinned

    def hand_over(self, entry):
        """The staged batch of ``entry``, safe to read on the consumer's
        stream: that stream waits for the copies, and each device tensor
        is marked as used there (made on the side stream, its memory must
        not be reused while the consumer's work is queued)."""
        moved, event, pinned = entry
        consumer = torch.cuda.current_stream(self.device)
        consumer.wait_event(event)
        _map_arrays(moved, lambda a: a._t.record_stream(consumer))
        self._retired = [(e, p) for e, p in self._retired
                         if not e.query()]
        self._retired.append((event, pinned))
        return moved


class DataLoader:
    """Mini-batches of a Dataset (the reference's arguments).

    ``num_workers`` threads fetch samples ``prefetch`` batches ahead
    (default ``2 * num_workers``; with no workers and ``prefetch`` > 0,
    one thread).  ``prefetch_to_device`` stages batches on a card (see
    the module docstring).  ``pin_memory``, ``pin_device_id``,
    ``thread_pool`` and ``timeout`` are accepted; the workers are
    threads either way."""

    def __init__(self, dataset, batch_size=None, shuffle=False, sampler=None,
                 last_batch=None, batch_sampler=None, batchify_fn=None,
                 num_workers=0, pin_memory=False, pin_device_id=0,
                 prefetch=None, thread_pool=False, timeout=120,
                 prefetch_to_device=None):
        self._dataset = dataset
        self._timeout = timeout
        if batch_sampler is None:
            if batch_size is None:
                raise ValueError("batch_size must be specified unless "
                                 "batch_sampler is specified")
            if sampler is None:
                sampler = RandomSampler(len(dataset)) if shuffle \
                    else SequentialSampler(len(dataset))
            elif shuffle:
                raise ValueError("shuffle must not be specified if sampler "
                                 "is specified")
            batch_sampler = BatchSampler(sampler, batch_size,
                                         last_batch if last_batch
                                         else "keep")
        elif batch_size is not None or shuffle or sampler is not None or \
                last_batch is not None:
            raise ValueError("batch_size, shuffle, sampler and last_batch "
                             "must not be specified if batch_sampler is "
                             "specified.")
        self._batch_sampler = batch_sampler
        self._num_workers = max(0, num_workers)
        self._prefetch = max(0, int(prefetch) if prefetch is not None
                             else 2 * self._num_workers)
        self._prefetch_ctx = prefetch_to_device
        self._batchify_fn = batchify_fn if batchify_fn is not None \
            else default_batchify_fn
        threads = self._num_workers or (1 if self._prefetch > 0 else 0)
        self._pool = concurrent.futures.ThreadPoolExecutor(
            threads, thread_name_prefix="dataloader") if threads else None

    def __len__(self):
        return len(self._batch_sampler)

    def __iter__(self):
        ctx = self._prefetch_ctx
        if ctx is True:
            ctx = current_context()
        if isinstance(ctx, Context) and ctx.device_type == "gpu":
            return self._iter_device_prefetch(ctx)
        batches = self._iter_batches(self._batchify_fn)
        if isinstance(ctx, Context):
            return (_map_arrays(b, lambda a: a.as_in_context(ctx))
                    for b in batches)
        return batches

    def _fetch(self, indices):
        with cpu():
            return [self._dataset[i] for i in indices]

    def _iter_batches(self, batchify):
        if self._pool is None:
            for indices in self._batch_sampler:
                yield batchify(self._fetch(indices))
            return
        it = iter(list(self._batch_sampler))
        futures = deque(self._pool.submit(self._fetch, idx)
                        for _, idx in zip(range(max(1, self._prefetch)),
                                          it))
        try:
            while futures:
                f = futures.popleft()
                nxt = next(it, None)
                if nxt is not None:
                    futures.append(self._pool.submit(self._fetch, nxt))
                # a worker's exception surfaces here, at its batch
                yield batchify(f.result(timeout=self._timeout))
        finally:
            # a consumer that stops early leaves no fetch queued
            for f in futures:
                f.cancel()

    def _iter_device_prefetch(self, ctx):
        def host_batchify(samples):
            with cpu():
                return self._batchify_fn(samples)
        stager = _DeviceStager(ctx)
        batches = self._iter_batches(host_batchify)
        staged = deque(stager.stage(b) for _, b in
                       zip(range(PREFETCH_DEPTH), batches))
        while staged:
            entry = staged.popleft()
            nxt = next(batches, None)
            if nxt is not None:
                staged.append(stager.stage(nxt))
            yield stager.hand_over(entry)

    def __del__(self):
        pool = getattr(self, "_pool", None)
        if pool is not None:
            pool.shutdown(wait=False)
