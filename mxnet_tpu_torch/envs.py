"""Environment-variable registry: the knobs the port reads, typed.

Reads go through :func:`get`, so the supported surface is greppable.
The names are the JAX package's, so one environment configures both.
There is no switch that turns the flash kernel off: on a card, every
call the kernel can take runs it.
"""
from __future__ import annotations

import os
from typing import Any, Dict, NamedTuple

__all__ = ["get", "registry"]


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
_reg("MXTPU_ZERO_STAGE", int, 0,
     "ZeRO sharding of a dp>1 DataParallelTrainer's update (read at "
     "construction): 0 replicates the optimizer states on every rank; "
     "1 all-reduces the gradients and updates each rank's 1/dp flat "
     "slice with 1/dp of the states; 2 reduce-scatters the gradients "
     "instead. The updated slices are all-gathered into the weights.")
_reg("MXTPU_SHARDING_PLAN", str, "",
     "Path to a sharding-plan JSON (parallel.ShardingPlan.save). A "
     "DataParallelTrainer made without plan= or param_sharding= takes "
     "it: its mesh axes, its rules as the parameter layout and its ZeRO "
     "stage; an explicit mesh or dp_axis unlike the plan's wins (with a "
     "warning). A malformed file raises.")


def registry():
    """Every declared variable (name -> EnvVar)."""
    return dict(_REGISTRY)


def get(name: str):
    """Read an env var through the registry, parsed to its type."""
    var = _REGISTRY[name]
    raw = os.environ.get(var.name)
    if raw is None:
        return var.default
    return var.type(raw)
