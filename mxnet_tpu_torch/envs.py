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

_reg("MXTPU_TELEMETRY", bool, True,
     "Master switch for the telemetry plane (metrics, structured events, "
     "flight recorder). 0 disables all recording; instrumented call "
     "sites then pay one attribute load per call.")
_reg("MXTPU_FLIGHT_RECORDER_SIZE", int, 512,
     "Capacity of each flight-recorder event ring (high-volume events "
     "and the retained rare ones). Older events fall off; a dump records "
     "how many were dropped.")
_reg("MXTPU_TELEMETRY_EXPORT", str, "",
     "Directory for telemetry artifacts: flight-recorder dumps and "
     "telemetry.export_metrics() JSONL snapshots. Empty = flight dumps go "
     "to the system temp dir, metric exports to the cwd.")
_reg("MXTPU_DISPATCH_RETRIES", int, 0,
     "How many times a serving dispatch retries a failure raised before "
     "its launch (the 'dispatch' fault point) before surfacing it. A "
     "failure at or after the launch is never retried: it poisons the "
     "server until Server.recover().")
_reg("MXTPU_FAULT_INJECT", str, "",
     "Deterministic fault-injection plan (';'-separated "
     "'point[:nth=N|step=N|times=K|prob=P|ms=N]' specs; see "
     "elastic.faults). Read at import of elastic.faults; tests "
     "reconfigure via faults.configure(). Empty (default) injects "
     "nothing.")
_reg("MXTPU_FAULT_SEED", int, 0,
     "Seed of the prob= qualifier's RNG in MXTPU_FAULT_INJECT: the same "
     "seed replays the same random fault plan exactly. Re-read at every "
     "faults.configure().")
_reg("MXTPU_INTEGRITY", bool, True,
     "Integrity checks of the serving plane: a live slot resize holds "
     "every migrated KV page's checksum against its source slot "
     "(elastic.integrity.page_checksum). Inert while MXTPU_TELEMETRY=0.")
_reg("MXTPU_RESIZE_UP_QUEUE", int, 4,
     "ServingAutoscaler grow signal: wait-queue depth at/above which an "
     "observation counts toward doubling the serving slot count.")
_reg("MXTPU_RESIZE_DOWN_OCCUPANCY", float, 0.25,
     "ServingAutoscaler shrink signal: slot occupancy at/below which "
     "(with an empty queue) an observation counts toward halving the "
     "slot count.")
_reg("MXTPU_RESIZE_PATIENCE", int, 3,
     "Consecutive breaching observations before the ServingAutoscaler "
     "acts.")
_reg("MXTPU_RESIZE_COOLDOWN_S", float, 30.0,
     "Minimum seconds between autoscaler-driven resizes.")
_reg("MXTPU_RESIZE_MIN_SLOTS", int, 1,
     "Lower bound on the autoscaled per-bucket slot count.")
_reg("MXTPU_RESIZE_MAX_SLOTS", int, 64,
     "Upper bound on the autoscaled per-bucket slot count.")


def registry():
    """Every declared variable (name -> EnvVar)."""
    return dict(_REGISTRY)


def get(name: str):
    """Read an env var through the registry, parsed to its type."""
    var = _REGISTRY[name]
    raw = os.environ.get(var.name)
    if raw is None:
        return var.default
    if var.type is bool:
        return raw not in ("", "0", "false", "False")
    return var.type(raw)
