"""The named device mesh a trainer and the collectives run on.

The JAX package runs data parallel as one process over N devices.  The
port runs one process a card over a ``torch.distributed`` process group
(``kvstore.init_distributed``, started by ``python -m
mxnet_tpu_torch.launch``): ``make_mesh({"dp": W})`` spans the W ranks of
that group, and each rank holds one device, ``cuda:LOCAL_RANK`` on the
card (its default context is ``gpu(LOCAL_RANK)``) or the CPU.  The
context decides the backend: a card's tensors go over NCCL, the CPU's
over gloo; a mesh whose device does not match the group's backend
raises.  A mesh of one device needs no process group: its collectives
are the identity.  Several axes (``{"dp": 2, "tp": 2}``) lay the ranks
out row-major, and each axis has a sub-group of the ranks that differ
only along it (made at ``make_mesh``, by every rank in the same order,
as ``torch.distributed.new_group`` requires).

``set_mesh``, ``current_mesh`` and ``mesh_shape`` are the reference's.
"""
from __future__ import annotations

import contextlib
import itertools
import threading
from typing import Dict, Optional

import torch

from ..base import MXNetError
from ..context import Context, current_context

__all__ = ["Mesh", "make_mesh", "set_mesh", "current_mesh", "mesh_shape",
           "sync_batch_stats", "batch_stats_group"]

_state = threading.local()

# the backend each device type takes; nothing falls back to another
_BACKEND = {"cuda": "nccl", "cpu": "gloo"}


class Mesh:
    """Named axes over the ranks of a process group; ``device`` is this
    rank's device."""

    def __init__(self, axes, devices, rank=0, groups=None):
        self.shape = dict(axes)
        self.devices = list(devices)
        self.rank = int(rank)
        self._groups = dict(groups or {})

    @property
    def size(self):
        n = 1
        for s in self.shape.values():
            n *= int(s)
        return n

    @property
    def device(self) -> torch.device:
        """This rank's device."""
        return self.devices[0]

    def group(self, axis: Optional[str] = None):
        """The process group of ``axis`` (None: every axis), or None when
        it spans one rank."""
        if axis is not None and axis not in self.shape:
            raise MXNetError(f"mesh {self.shape} has no axis {axis!r}")
        return self._groups.get(axis)

    def axis_size(self, axis: Optional[str] = None) -> int:
        return self.size if axis is None else int(self.shape[axis])

    def axis_index(self, axis: Optional[str] = None) -> int:
        """This rank's coordinate along ``axis`` (row-major layout)."""
        if axis is None:
            return self.rank
        stride = 1
        names = list(self.shape)
        for a in reversed(names[names.index(axis) + 1:]):
            stride *= int(self.shape[a])
        return (self.rank // stride) % int(self.shape[axis])

    def __repr__(self):
        return f"Mesh({self.shape}, rank {self.rank}, {self.device})"


def _device(d):
    if isinstance(d, Context):
        return d.device
    return torch.device(d)


def _axis_groups(axes, rank, backend):
    """{axis: group} for every axis, and {None: the whole group}: each
    axis's group holds the ranks that differ only along it.  Every rank
    makes every group, in the same order."""
    import torch.distributed as dist
    names, sizes = list(axes), [int(s) for s in axes.values()]
    coords = list(itertools.product(*[range(s) for s in sizes]))
    groups = {None: dist.group.WORLD}
    if len(names) == 1:
        groups[names[0]] = dist.group.WORLD
        return groups
    for k, name in enumerate(names):
        seen = set()
        for c in coords:
            key = c[:k] + c[k + 1:]
            if key in seen:
                continue
            seen.add(key)
            ranks = [coords.index(c[:k] + (i,) + c[k + 1:])
                     for i in range(sizes[k])]
            g = dist.new_group(ranks, backend=backend)
            if rank in ranks:
                groups[name] = g
    return groups


def make_mesh(axes, devices=None):
    """A mesh of ``axes`` (``{"dp": W}``).  One device: ``devices``
    (default: the current context's).  More: the process group must be
    up with exactly that many ranks (``kvstore.init_distributed``, which
    this calls); ``devices`` then lists every rank's device (rank r takes
    ``devices[r]``) or this rank's alone, default the current context's
    (``gpu(LOCAL_RANK)`` under the launcher)."""
    axes = dict(axes)
    n = 1
    for size in axes.values():
        n *= int(size)
    if devices is not None:
        devices = [_device(d) for d in devices]
    if n == 1:
        if devices is None:
            devices = [current_context().device]
        if len(devices) != 1:
            raise MXNetError(f"mesh {axes} needs 1 device, got "
                             f"{len(devices)}")
        return Mesh(axes, devices, 0, _world_groups(axes, devices[0]))
    from ..kvstore.kvstore import init_distributed
    init_distributed()
    import torch.distributed as dist
    if not dist.is_initialized():
        raise MXNetError(
            f"mesh {axes} spans {n} ranks, but no process group is up: "
            "start the job with `python -m mxnet_tpu_torch.launch -n "
            f"{n} ...` (or call mx.kvstore.init_distributed())")
    world, rank = dist.get_world_size(), dist.get_rank()
    if world != n:
        raise MXNetError(f"mesh {axes} needs {n} ranks; the process "
                         f"group has {world}")
    if devices is None:
        dev = current_context().device
    elif len(devices) == n:
        dev = devices[rank]
    elif len(devices) == 1:
        dev = devices[0]
    else:
        raise MXNetError(f"mesh {axes}: give every rank's device or this "
                         f"rank's, not {len(devices)}")
    _check_backend(dev)
    return Mesh(axes, [dev], rank, _axis_groups(axes, rank,
                                                dist.get_backend()))


def _world_groups(axes, device):
    """A one-device mesh's groups: the process group when one of size 1
    is up (so a launched job of one rank still goes through NCCL), else
    none (the collectives are the identity)."""
    import torch.distributed as dist
    if not (dist.is_available() and dist.is_initialized()) or \
            dist.get_world_size() != 1:
        return {}
    _check_backend(device)
    return {None: dist.group.WORLD,
            **{a: dist.group.WORLD for a in axes}}


def _check_backend(device):
    import torch.distributed as dist
    want = _BACKEND.get(torch.device(device).type)
    have = str(dist.get_backend()).lower()
    if want is None or want not in have:
        raise MXNetError(
            f"the process group's backend is {have!r}, but the mesh's "
            f"device {device} needs {want!r}: a card's tensors go over "
            "NCCL and the CPU's over gloo; start the group with the "
            "context the job runs on")


def set_mesh(mesh) -> None:
    """Install ``mesh`` as this thread's default (None clears)."""
    _state.mesh = mesh


def current_mesh():
    """The default mesh, else a ``{"dp": W}`` mesh over the process group
    (W = its size, 1 without one)."""
    mesh = getattr(_state, "mesh", None)
    if mesh is None:
        import torch.distributed as dist
        w = dist.get_world_size() if dist.is_available() and \
            dist.is_initialized() else 1
        mesh = make_mesh({"dp": w})
        _state.mesh = mesh
    return mesh


def mesh_shape(mesh=None) -> Dict[str, int]:
    mesh = mesh if mesh is not None else current_mesh()
    return dict(mesh.shape)


# -- global batch statistics ----------------------------------------------

@contextlib.contextmanager
def sync_batch_stats(group):
    """While inside, every BatchNorm in training mode reduces its
    statistics over ``group`` (a dp>1 trainer's step body)."""
    stack = getattr(_state, "bn_groups", None)
    if stack is None:
        stack = _state.bn_groups = []
    stack.append(group)
    try:
        yield
    finally:
        stack.pop()


def batch_stats_group(sync=False):
    """The group a BatchNorm reduces its statistics over: the innermost
    :func:`sync_batch_stats` group, else with ``sync`` (SyncBatchNorm)
    the whole process group when it has more than one rank, else None."""
    stack = getattr(_state, "bn_groups", None)
    if stack:
        return stack[-1]
    if sync:
        import torch.distributed as dist
        if dist.is_available() and dist.is_initialized() and \
                dist.get_world_size() > 1:
            return dist.group.WORLD
    return None
