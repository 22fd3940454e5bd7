"""The kvstores (see the package docstring for the modes) and the
process group's rendezvous."""
from __future__ import annotations

import datetime
import os
from typing import Dict, List, Optional

import torch

from ..base import MXNetError
from ..ndarray.ndarray import NDArray
from .compression import GradientCompression

__all__ = ["KVStore", "KVStoreDist", "KVStoreTPUSync", "create",
           "init_distributed"]


#: the process group's bound on one collective
TIMEOUT = datetime.timedelta(seconds=300)


def _env(*names):
    for n in names:
        v = os.environ.get(n)
        if v:
            return v
    return None


def init_distributed(coordinator=None, num_processes=None, process_id=None):
    """Join the launcher's process group (idempotent): returns True when
    a group is up, False when there is nothing to join.

    The rendezvous comes from the arguments, else the environment that
    ``python -m mxnet_tpu_torch.launch`` exports: ``MASTER_ADDR`` and
    ``MASTER_PORT`` (or ``MXTPU_DIST_COORDINATOR``), ``WORLD_SIZE``,
    ``RANK`` (or ``MXTPU_DIST_NUM_PROCS``, ``MXTPU_DIST_PROC_ID``), or a
    file store named by ``MXTPU_DIST_INIT`` (``file://...``).  The
    backend is the current context's: NCCL for a card (after binding
    ``cuda:LOCAL_RANK``), gloo for the CPU; NCCL without a card raises.
    A collective that waits longer than ``TIMEOUT`` fails."""
    import torch.distributed as dist
    if not dist.is_available():
        return False
    if dist.is_initialized():
        return True
    init = _env("MXTPU_DIST_INIT")
    if coordinator is None and init is None:
        addr, port = _env("MASTER_ADDR"), _env("MASTER_PORT")
        coordinator = f"{addr}:{port}" if addr and port else \
            _env("MXTPU_DIST_COORDINATOR")
    if coordinator is None and init is None:
        return False
    world = int(num_processes if num_processes is not None else
                _env("WORLD_SIZE", "MXTPU_DIST_NUM_PROCS") or 1)
    rank = int(process_id if process_id is not None else
               _env("RANK", "MXTPU_DIST_PROC_ID") or 0)
    from ..context import current_context
    backend = "nccl" if current_context().device_type == "gpu" else "gloo"
    kwargs = {}
    if backend == "nccl":
        if not (torch.cuda.is_available() and dist.is_nccl_available()):
            raise MXNetError("the current context is a card, whose process "
                             "group needs NCCL, but there is no usable "
                             "card or NCCL here; run the job under "
                             "`with mx.cpu():` for gloo")
        local = int(_env("LOCAL_RANK") or 0)
        torch.cuda.set_device(local)
        kwargs["device_id"] = torch.device("cuda", local)
    method = init if init is not None else f"tcp://{coordinator}"
    dist.init_process_group(backend, init_method=method, world_size=world,
                            rank=rank, timeout=TIMEOUT, **kwargs)
    return True


def _as_list(x):
    return list(x) if isinstance(x, (list, tuple)) else [x]


def _key_list(key):
    if isinstance(key, (list, tuple)):
        return list(key), True
    return [key], False


class KVStore:
    """The one-process store: ``local``, ``device`` and ``nccl``.  The
    values pushed for a key are summed on the stored value's context
    (compressed first, when set) and the sum goes to the updater, else
    replaces the stored value; ``pull`` copies it to every output."""

    def __init__(self, kv_type="local"):
        self._type = kv_type
        self._store: Dict[str, NDArray] = {}
        self._updater = None
        self._optimizer = None
        self._compression: Optional[GradientCompression] = None

    @property
    def type(self):
        return self._type

    @property
    def rank(self) -> int:
        return 0

    @property
    def num_workers(self) -> int:
        return 1

    @property
    def is_distributed(self) -> bool:
        return False

    def init(self, key, value):
        keys, _ = _key_list(key)
        values = _as_list(value)
        if len(keys) != len(values):
            raise MXNetError("init: number of keys != number of values")
        for k, v in zip(keys, values):
            k = str(k)
            if k in self._store:
                raise MXNetError(f"init() called twice for key {k!r}")
            v0 = v[0] if isinstance(v, (list, tuple)) else v
            self._store[k] = v0.copy()

    def _local_sum(self, k, values: List[NDArray]) -> NDArray:
        """The sum of ``values`` on the stored value's context, each
        compressed first when compression is set."""
        root = self._store[k].context
        ts = [v.as_in_context(root)._t for v in values]
        if self._compression is not None:
            ts = [self._compression.compress(f"{k}:{i}", t)
                  for i, t in enumerate(ts)]
        total = ts[0] if len(ts) == 1 else torch.stack(ts).sum(dim=0)
        return NDArray(total, ctx=root)

    def _merge(self, k, values: List[NDArray]) -> NDArray:
        merged = self._local_sum(k, values)
        if all(getattr(v, "stype", "default") == "row_sparse"
               for v in values):
            # the sum keeps the stype, so the updater's lazy update runs
            from ..ndarray.sparse import RowSparseNDArray
            merged = RowSparseNDArray(merged._t, ctx=merged.context)
        return merged

    def push(self, key, value, priority=0):
        keys, _ = _key_list(key)
        values = _as_list(value)
        if len(keys) == 1 and len(values) > 1 and \
                not isinstance(values[0], (list, tuple)):
            values = [values]
        for k, v in zip(keys, values):
            k = str(k)
            if k not in self._store:
                raise MXNetError(f"push() on uninitialized key {k!r}")
            merged = self._merge(k, _as_list(v))
            if self._updater is not None:
                self._updater(int(k) if k.isdigit() else k, merged,
                              self._store[k])
            else:
                stored = self._store[k]
                with torch.no_grad():
                    stored._t.copy_(merged._t.to(stored._t.dtype))

    def pull(self, key, out=None, priority=0, ignore_sparse=True):
        if out is None:
            raise MXNetError("pull: `out` is required")
        keys, _ = _key_list(key)
        outs = _as_list(out)
        if len(keys) == 1 and len(outs) > 1 and \
                not isinstance(outs[0], (list, tuple)):
            outs = [outs]
        for k, o in zip(keys, outs):
            k = str(k)
            if k not in self._store:
                raise MXNetError(f"pull() on uninitialized key {k!r}")
            src = self._store[k]
            for dst in _as_list(o):
                with torch.no_grad():
                    dst._t.copy_(src._t.to(dst._t.device))

    def pushpull(self, key, value, out=None, priority=0):
        self.push(key, value, priority=priority)
        self.pull(key, out=out if out is not None else value,
                  priority=priority)

    def broadcast(self, key, value, out, priority=0):
        self.init(key, value)
        self.pull(key, out=out, priority=priority)

    def row_sparse_pull(self, key, out=None, priority=0, row_ids=None):
        """Each output gets the stored rows ``row_ids`` and zeros
        elsewhere (one ``row_ids`` for every key, or one a key)."""
        if out is None or row_ids is None:
            raise MXNetError("row_sparse_pull: `out` and `row_ids` required")
        keys, _ = _key_list(key)
        outs = _as_list(out)
        ids = _as_list(row_ids)
        if len(ids) == 1:
            ids = ids * len(keys)
        elif len(ids) != len(keys):
            raise MXNetError(
                f"row_sparse_pull: {len(keys)} keys but {len(ids)} "
                "row_ids lists (must match or be a single list)")
        for k, o, rid in zip(keys, outs, ids):
            src = self._store[str(k)]._t
            for dst in _as_list(o):
                rows = rid._t.to(device=dst._t.device, dtype=torch.int64)
                picked = torch.zeros_like(dst._t)
                picked[rows] = src.to(dst._t.device)[rows].to(dst._t.dtype)
                with torch.no_grad():
                    dst._t.copy_(picked)

    # -- optimizer --------------------------------------------------------
    def set_optimizer(self, optimizer):
        from .. import optimizer as opt
        self._optimizer = optimizer
        self._updater = opt.get_updater(optimizer)

    def _set_updater(self, updater):
        self._updater = updater

    def set_gradient_compression(self, compression_params):
        self._compression = GradientCompression(compression_params)

    @property
    def gradient_compression(self):
        return self._compression

    def save_optimizer_states(self, fname, dump_optimizer=False):
        if self._updater is None:
            raise MXNetError("no optimizer has been set")
        with open(fname, "wb") as f:
            f.write(self._updater.get_states(dump_optimizer=dump_optimizer))

    def load_optimizer_states(self, fname):
        if self._updater is None:
            raise MXNetError("no optimizer has been set")
        with open(fname, "rb") as f:
            self._updater.set_states(f.read())

    def _barrier(self):
        from .. import ndarray as nd
        nd.waitall()


class KVStoreDist(KVStore):
    """``dist_sync`` and its aliases: one process a rank over the process
    group (NCCL for values on a card, gloo for the CPU's).  Each rank's
    push is summed over its contexts, then over the ranks; with
    compression each rank encodes its local sum once (int8 codes and an
    f32 scale cross the wire, by one all-gather each) and the decoded
    codes are summed.  ``init`` broadcasts rank 0's value, so every rank
    starts from the same weights."""

    def __init__(self, kv_type="dist_sync"):
        super().__init__(kv_type)
        init_distributed()
        import torch.distributed as dist
        self._dist = dist if dist.is_available() and \
            dist.is_initialized() else None

    @property
    def rank(self) -> int:
        return self._dist.get_rank() if self._dist else 0

    @property
    def num_workers(self) -> int:
        return self._dist.get_world_size() if self._dist else 1

    @property
    def is_distributed(self) -> bool:
        return True

    def _axis(self):
        from ..parallel.collectives import _Axis
        return _Axis.of_group(self._dist.group.WORLD)

    def init(self, key, value):
        super().init(key, value)
        if self.num_workers > 1:
            ax = self._axis()
            for k in _key_list(key)[0]:
                t = self._store[str(k)]._t
                ax.check(t)
                self._dist.broadcast(t, 0)

    def _merge(self, k, values):
        if self.num_workers == 1:
            return super()._merge(k, values)
        from ..parallel.collectives import _all_reduce, _gather_rows
        ax = self._axis()
        root = self._store[k].context
        if self._compression is not None:
            # compression applies once a rank, to what crosses the wire
            ts = [v.as_in_context(root)._t for v in values]
            local = ts[0] if len(ts) == 1 else torch.stack(ts).sum(dim=0)
            codes, scale = self._compression.encode(f"{k}:dist", local)
            return NDArray(self._compression.decode(
                _gather_rows(codes, ax), _gather_rows(scale.reshape(1), ax)),
                ctx=root)
        merged = super()._merge(k, values)
        return NDArray(_all_reduce(merged._t, ax), ctx=merged.context)

    def _barrier(self):
        if self.num_workers > 1:
            self._dist.barrier()
        super()._barrier()


# the reference's class name for the synchronous distributed store
KVStoreTPUSync = KVStoreDist


def create(name="local") -> KVStore:
    """A kvstore of mode ``name`` (parity: ``mx.kv.create``)."""
    if not isinstance(name, str):
        raise TypeError("name must be a string")
    if name in ("local", "local_allreduce_cpu", "local_allreduce_device",
                "device", "nccl"):
        return KVStore(name)
    if name in ("dist_sync", "dist_sync_device", "dist_tpu_sync", "dist"):
        return KVStoreDist(name)
    if name == "dist_async":
        raise MXNetError(
            "dist_async is not provided: asynchronous parameter-server "
            "updates are not ported; use 'dist_sync' (the reference's "
            "name for it here is 'dist_tpu_sync')")
    raise MXNetError(f"unknown KVStore type {name!r}")
