"""Helpers of the port's serving-protocol tests: the tiny Llama of both
packages from one seeded JAX model (its weights carried into the port by
``load_jax_params``, as ``test_torch_serving.py`` does), and each
package's serving handles side by side, so one scenario runs through
both and the results compare."""
import types

import numpy as np

import mxnet_tpu as jmx
from mxnet_tpu import engine as jengine
from mxnet_tpu import telemetry as jtelemetry
from mxnet_tpu.base import MXNetError as JaxError
from mxnet_tpu.elastic import faults as jfaults
from mxnet_tpu.elastic import resize as jresize
from mxnet_tpu.elastic.resize import ServingAutoscaler as JaxAutoscaler
from mxnet_tpu.models import LlamaForCausalLM as JaxLM
from mxnet_tpu.models import llama_tiny as jax_llama_tiny
from mxnet_tpu.serving import Server as JaxServer
from mxnet_tpu.serving import scheduler as jscheduler
from mxnet_tpu.serving import server as jserver
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import telemetry
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.elastic import faults, resize
from mxnet_tpu_torch.elastic.resize import ServingAutoscaler
from mxnet_tpu_torch.models import LlamaForCausalLM, llama_tiny, \
    load_jax_params
from mxnet_tpu_torch.serving import Server
from mxnet_tpu_torch.serving import scheduler, server

import torch_threads  # noqa: F401  (a worker's share of the cores)

V = 61
CPU = mx.cpu()


class Side:
    """One package's serving plane over the shared weights."""

    def __init__(self, name, lm, server_cls, autoscaler, faults_mod,
                 telemetry_mod, resize_mod, error, ctx, modules):
        self.name = name
        self.lm = lm
        self.Server = server_cls
        self.Autoscaler = autoscaler
        self.faults = faults_mod
        self.telemetry = telemetry_mod
        self.resize = resize_mod
        self.Error = error
        self.ctx = ctx
        self.modules = modules       # those that read time.perf_counter

    def server(self, **kw):
        return self.Server(self.lm, **self.ctx, **kw)

    def clean(self):
        self.faults.clear()
        self.telemetry.reset()
        self.resize._reset()

    def __repr__(self):
        return self.name


def build_sides():
    """[JAX side, port side] over one seeded ``llama_tiny``.  The JAX
    engine's op cache is emptied first: it is keyed without the devices,
    so an executable an earlier test compiled for a mesh of 8 (the same
    op and shape, a sharded KV pool's ``_zeros``) would be called here."""
    jengine.clear_cache()
    jmx.random.seed(0)
    np.random.seed(0)
    jlm = JaxLM(jax_llama_tiny(vocab_size=V))
    jlm.initialize(jmx.init.Xavier())
    lm = LlamaForCausalLM(llama_tiny(vocab_size=V), ctx=CPU)
    load_jax_params(lm, {k: p.data().asnumpy()
                         for k, p in jlm.collect_params().items()})
    return [Side("jax", jlm, JaxServer, JaxAutoscaler, jfaults,
                 jtelemetry, jresize, JaxError, {},
                 (jscheduler, jserver)),
            Side("port", lm, Server, ServingAutoscaler, faults, telemetry,
                 resize, MXNetError, {"ctx": CPU}, (scheduler, server))]


def prompt(seed, n):
    return np.random.RandomState(seed).randint(0, V, n).astype("f4")


class FakeClock:
    """One clock for both packages: it moves only when told."""

    def __init__(self, t=1000.0):
        self.t = float(t)

    def __call__(self):
        return self.t

    def advance(self, seconds):
        self.t += float(seconds)


def use_clock(monkeypatch, sides, clock):
    """Every serving module of ``sides`` reads ``clock`` as
    ``time.perf_counter``."""
    import time as _time
    fake = types.SimpleNamespace(perf_counter=clock,
                                 monotonic=_time.monotonic,
                                 time=_time.time, sleep=_time.sleep)
    for side in sides:
        for mod in side.modules:
            monkeypatch.setattr(mod, "time", fake)


def record_fields(rec):
    """The fields of a resize record both packages must agree on."""
    return {k: rec[k] for k in ("slots_from", "slots_to", "buckets",
                                "migrated", "requeued", "healed")}
