"""Sampling operators, as the JAX package's ``ops/random_ops.py``.

Where the JAX ops take a threefry key as their first input, these take
the ``torch.Generator`` to draw from as the ``generator`` attr (the
frontend in ``random.py`` passes the device's ``mx.random`` stream).
The draws differ from the JAX package's for the same seed; the tests
hold them to their distributions.
"""
from __future__ import annotations

import math

import torch

from ..base import torch_dtype
from .registry import register


def _empty(shape, dtype, device):
    return torch.empty(tuple(shape), dtype=torch_dtype(dtype), device=device)


@register("_random_uniform", num_inputs=0, scalar_attrs=("low", "high"),
          wrap_ctx=True, scalar_ref_input=None)
def _random_uniform(low, high, *, shape=(), dtype="float32", device=None,
                    generator=None):
    return _empty(shape, dtype, device).uniform_(low, high,
                                                 generator=generator)


@register("_random_normal", num_inputs=0, scalar_attrs=("loc", "scale"),
          wrap_ctx=True, scalar_ref_input=None)
def _random_normal(loc, scale, *, shape=(), dtype="float32", device=None,
                   generator=None):
    return _empty(shape, dtype, device).normal_(loc, scale,
                                                generator=generator)


@register("_random_gamma", num_inputs=0, scalar_attrs=("alpha", "beta"),
          wrap_ctx=True, scalar_ref_input=None)
def _random_gamma(alpha, beta, *, shape=(), dtype="float32", device=None,
                  generator=None):
    a = torch.full(tuple(shape), float(alpha), dtype=torch.float32,
                   device=device)
    return (torch._standard_gamma(a, generator=generator)
            * beta).to(torch_dtype(dtype))


@register("_random_exponential", num_inputs=0, scalar_attrs=("lam",),
          wrap_ctx=True, scalar_ref_input=None)
def _random_exponential(lam, *, shape=(), dtype="float32", device=None,
                        generator=None):
    return _empty(shape, dtype, device).exponential_(lam,
                                                     generator=generator)


@register("_random_poisson", num_inputs=0, scalar_attrs=("lam",),
          wrap_ctx=True, scalar_ref_input=None)
def _random_poisson(lam, *, shape=(), dtype="float32", device=None,
                    generator=None):
    rate = torch.full(tuple(shape), float(lam), dtype=torch.float32,
                      device=device)
    return torch.poisson(rate, generator=generator).to(torch_dtype(dtype))


@register("_random_randint", num_inputs=0, wrap_ctx=True)
def _random_randint(*, low=0, high=1, shape=(), dtype="int32", device=None,
                    generator=None):
    return torch.randint(int(low), int(high), tuple(shape),
                         generator=generator, dtype=torch_dtype(dtype),
                         device=device)


@register("_random_bernoulli", num_inputs=0, scalar_attrs=("prob",),
          wrap_ctx=True, scalar_ref_input=None)
def _random_bernoulli(prob, *, shape=(), dtype="float32", device=None,
                      generator=None):
    u = torch.rand(tuple(shape), generator=generator, device=device)
    return (u < prob).to(torch_dtype(dtype))


@register("_sample_multinomial", num_inputs=1)
def _sample_multinomial(data, *, shape=(), get_prob=False, dtype="int32",
                        generator=None):
    """Category draws over the last axis of ``data`` (probabilities):
    ``shape`` draws for each row, appended after the rows' axes."""
    n = math.prod(shape) if shape else 1
    rows = data.reshape(-1, data.shape[-1]).float()
    out = torch.multinomial(rows, n, replacement=True, generator=generator)
    out = out.reshape(tuple(data.shape[:-1]) + tuple(shape))
    return out.to(torch_dtype(dtype))


@register("_shuffle", num_inputs=1)
def _shuffle(data, *, generator=None):
    perm = torch.randperm(data.shape[0], generator=generator,
                          device=data.device)
    return data[perm]


def pick_tokens(logits, temps, top_k=0, generator=None):
    """Next token of each row of ``logits`` (N, vocab), as float32 ids:
    the argmax where ``temps`` (N,) or (1,) is 0, elsewhere a draw from
    the softmax of ``logits / temp`` truncated to the ``top_k`` largest
    (0: the whole vocabulary), as the JAX package's serving sampler.

    The draw is Gumbel-max, ``argmax(lg - log(-log u))`` with ``u``
    uniform from ``generator``: an exact categorical draw made of
    ordinary kernels, with no host sync and nothing data-dependent in
    its shapes, so a CUDA graph can hold it.  Every call draws ``u`` for
    every row, greedy or not."""
    lg = logits.float()
    greedy = torch.argmax(lg, dim=-1)
    lg = lg / temps.reshape(-1, 1).clamp_min(1e-6)
    if top_k:
        kth = torch.topk(lg, int(top_k), dim=-1).values[:, -1:]
        lg = lg.masked_fill(lg < kth, float("-inf"))
    u = torch.rand(lg.shape, generator=generator, device=lg.device)
    sampled = torch.argmax(lg - torch.log(-torch.log(u)), dim=-1)
    return torch.where(temps > 0, sampled, greedy).float()


@register("_sample_unique_zipfian", num_inputs=0, wrap_ctx=True)
def _sample_unique_zipfian(*, range_max=1, shape=(), device=None,
                           generator=None):
    """Log-uniform draws in [0, range_max) as int64: ``exp(u log
    range_max) - 1`` truncated, u uniform.  As the JAX package (ROADMAP
    queue 3, R8): no dedup and no counts, unlike upstream's sampler."""
    if generator is None:
        from ..random import generator as _generator
        generator = _generator(device)
    u = torch.rand(tuple(shape), generator=generator, device=device)
    vals = torch.exp(u * math.log(float(range_max))) - 1.0
    return torch.clamp(vals, 0.0, float(range_max - 1)).to(torch.int64)
