"""Device contexts: ``mx.gpu(i)`` and ``mx.cpu()`` over ``torch.device``.

The default context is ``gpu(0)``: entry points run on the card unless
the caller asks for the CPU with ``ctx=mx.cpu()``.  A GPU context on a
machine without CUDA raises ``MXNetError`` when it is resolved; there
is no silent CPU path.  ``cpu_pinned()`` is host memory that arrays made
on it take page-locked when a card is present (``pin_memory``), so a
copy to the card can overlap; without a card it is plain host memory.
"""
from __future__ import annotations

import os
import threading

import torch

from .base import MXNetError

__all__ = ["Context", "cpu", "cpu_pinned", "gpu", "current_context",
           "num_gpus"]


class Context:
    """A device context, compared by (device_type, device_id)."""

    _default_ctx = threading.local()

    def __init__(self, device_type: str, device_id: int = 0):
        if device_type not in ("cpu", "gpu", "cpu_pinned"):
            raise MXNetError(f"unknown device type {device_type!r}")
        self.device_type = device_type
        self.device_id = int(device_id)

    def __eq__(self, other):
        return (isinstance(other, Context)
                and self.device_type == other.device_type
                and self.device_id == other.device_id)

    def __hash__(self):
        return hash((self.device_type, self.device_id))

    def __repr__(self):
        return f"{self.device_type}({self.device_id})"

    __str__ = __repr__

    @property
    def device(self) -> torch.device:
        """The ``torch.device``; raises when a GPU context has no card."""
        if self.device_type != "gpu":
            return torch.device("cpu")
        if not torch.cuda.is_available():
            raise MXNetError(
                f"context {self} needs a CUDA device, but none is "
                "available; pass ctx=mx.cpu() to run on the CPU")
        n = torch.cuda.device_count()
        if self.device_id >= n:
            raise MXNetError(f"context {self} out of range: only {n} "
                             "CUDA device(s) present")
        return torch.device("cuda", self.device_id)

    def __enter__(self):
        if not hasattr(Context._default_ctx, "stack"):
            Context._default_ctx.stack = []
        Context._default_ctx.stack.append(self)
        return self

    def __exit__(self, *exc):
        Context._default_ctx.stack.pop()


def cpu(device_id: int = 0) -> Context:
    return Context("cpu", device_id)


def cpu_pinned(device_id: int = 0) -> Context:
    """Page-locked host memory (parity: ``mx.cpu_pinned``)."""
    return Context("cpu_pinned", device_id)


def pinned(t: torch.Tensor, ctx: Context) -> torch.Tensor:
    """``t`` page-locked when ``ctx`` is ``cpu_pinned`` and a card is
    present, else ``t``."""
    if ctx.device_type == "cpu_pinned" and torch.cuda.is_available() \
            and not t.is_pinned():
        return t.pin_memory()
    return t


def gpu(device_id: int = 0) -> Context:
    return Context("gpu", device_id)


def num_gpus() -> int:
    """The number of CUDA cards this process sees (parity:
    ``mx.context.num_gpus``): ``torch.cuda.device_count()``, 0 without
    CUDA."""
    return torch.cuda.device_count()


def current_context() -> Context:
    """The innermost ``with ctx:`` scope, else ``gpu(LOCAL_RANK)``: the
    card of this rank under ``python -m mxnet_tpu_torch.launch``,
    ``gpu(0)`` otherwise."""
    stack = getattr(Context._default_ctx, "stack", None)
    if stack:
        return stack[-1]
    return Context("gpu", int(os.environ.get("LOCAL_RANK") or 0))

