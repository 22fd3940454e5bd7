"""Environment-variable registry: the knobs the port reads, typed.

Reads go through :func:`get`, so the supported surface is greppable.
The names are the JAX package's, so one environment configures both.
There is no switch that turns the flash kernel off: on a card, every
call the kernel can take runs it.
"""
from __future__ import annotations

import os
from typing import Any, Dict, NamedTuple

__all__ = ["get"]


class EnvVar(NamedTuple):
    name: str
    type: type
    default: Any
    doc: str


_REGISTRY: Dict[str, EnvVar] = {}


def _reg(name, typ, default, doc):
    _REGISTRY[name] = EnvVar(name, typ, default, doc)


_reg("MXTPU_SERVING_SLOTS", int, 4,
     "Default batch slots per serving bucket when serving.Server is "
     "constructed without explicit buckets.")
_reg("MXTPU_SERVING_BUCKETS", str, "32,128",
     "Default prompt-length buckets for serving.Server (comma-"
     "separated): a request lands in the smallest bucket holding its "
     "prompt, right-padded there.")
_reg("MXTPU_SERVING_MAX_NEW_TOKENS", int, 32,
     "Default per-request generation cap for serving.Server; sizes "
     "the KV-cache pages (cache_len = prompt_len bucket + this).")
_reg("MXTPU_COMPILED_STEP", int, 1,
     "0 makes gluon CompiledStep run the eager record -> backward -> "
     "Trainer.step loop instead of its captured step body.")
_reg("MXTPU_SERVING_MAX_QUEUE", int, 128,
     "Bound on the serving wait queue; submissions past it raise.")


def get(name: str):
    """Read an env var through the registry, parsed to its type."""
    var = _REGISTRY[name]
    raw = os.environ.get(var.name)
    if raw is None:
        return var.default
    return var.type(raw)
