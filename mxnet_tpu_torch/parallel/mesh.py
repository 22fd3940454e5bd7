"""``make_mesh``: the named device mesh a trainer runs on.  Only the
one-device mesh ``{"dp": 1}`` is ported."""
from __future__ import annotations

import torch

from ..base import MXNetError
from ..context import Context, current_context

__all__ = ["Mesh", "make_mesh"]


class Mesh:
    """Named axes over a list of devices."""

    def __init__(self, axes, devices):
        self.shape = dict(axes)
        self.devices = list(devices)

    @property
    def size(self):
        return len(self.devices)

    @property
    def device(self) -> torch.device:
        """The device of a one-device mesh."""
        if self.size != 1:
            raise MXNetError(f"mesh {self.shape} spans {self.size} devices")
        return self.devices[0]

    def __repr__(self):
        return f"Mesh({self.shape}, {self.devices})"


def make_mesh(axes, devices=None):
    """A mesh of ``axes`` (``{"dp": 1}``) over ``devices`` (torch devices
    or contexts; default: the current context's device)."""
    axes = dict(axes)
    n = 1
    for size in axes.values():
        n *= int(size)
    if n != 1:
        raise MXNetError(f"mesh {axes} has {n} devices: only the "
                         "one-device mesh is ported")
    if devices is None:
        devices = [current_context()]
    devices = [d.device if isinstance(d, Context) else torch.device(d)
               for d in devices]
    if len(devices) != n:
        raise MXNetError(f"mesh {axes} needs {n} device(s), got "
                         f"{len(devices)}")
    return Mesh(axes, devices)
