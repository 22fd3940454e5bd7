"""Global RNG state: ``mx.random.seed``, one ``torch.Generator`` per
device, and the sampling entry points (``uniform``, ``normal``, ...).

``seed(s)`` reseeds every device's stream; ``seed(s, ctx=...)`` only
that device's.  A device's stream derives from the base seed and the
device's identity, so two cards never draw the same numbers.  The
generators give other numbers than the JAX package's keys from the
same seed: tests feed both packages numpy-made inputs instead, and hold
the samplers to their distributions.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from .context import Context, current_context

__all__ = ["seed", "generator", "uniform", "normal", "randn", "randint",
           "exponential", "gamma", "poisson", "bernoulli", "multinomial",
           "shuffle"]

_DEFAULT_SEED = 0
_base_seed = _DEFAULT_SEED
_generators: Dict[torch.device, torch.Generator] = {}


def _device_seed(base: int, device: torch.device) -> int:
    code = 0 if device.type == "cpu" else 1 + (device.index or 0)
    return (int(base) * 1000003 + 997 * code) % (2 ** 63)


def seed(seed_state: int, ctx: Optional[Context] = None):
    """Reset the RNG.  ``ctx=None`` reseeds every device."""
    global _base_seed
    if ctx is None:
        _base_seed = int(seed_state)
        _generators.clear()
        return
    dev = ctx.device
    g = torch.Generator(device=dev)
    g.manual_seed(_device_seed(seed_state, dev))
    _generators[dev] = g


def generator(device: torch.device) -> torch.Generator:
    """The stream of ``device`` (created from the base seed on first
    use)."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    g = _generators.get(dev)
    if g is None:
        g = torch.Generator(device=dev)
        g.manual_seed(_device_seed(_base_seed, dev))
        _generators[dev] = g
    return g


# -- sampling (parity: the JAX package's random.py:97-219) --------------------

def _shape(shape):
    if shape is None:
        return ()
    return (shape,) if isinstance(shape, (int, np.integer)) else tuple(shape)


def _sample(opname, ctx, out, shape, dtype, **attrs):
    from .ndarray.ndarray import invoke
    from .ops.registry import get_op
    if out is not None:
        ctx = out.context
        shape = shape if shape is not None else out.shape
        dtype = dtype or out.dtype.name
    ctx = ctx or current_context()
    return invoke(get_op(opname), [], out=out, ctx=ctx, shape=_shape(shape),
                  dtype=np.dtype(dtype or "float32").name,
                  generator=generator(ctx.device), **attrs)


def uniform(low=0.0, high=1.0, shape=None, dtype="float32", ctx=None,
            out=None):
    return _sample("_random_uniform", ctx, out, shape, dtype, low=low,
                   high=high)


def normal(loc=0.0, scale=1.0, shape=None, dtype="float32", ctx=None,
           out=None):
    return _sample("_random_normal", ctx, out, shape, dtype, loc=loc,
                   scale=scale)


def randn(*shape, dtype="float32", ctx=None):
    return normal(0.0, 1.0, shape=shape, dtype=dtype, ctx=ctx)


def randint(low, high, shape=None, dtype="int32", ctx=None, out=None):
    return _sample("_random_randint", ctx, out, shape, dtype, low=int(low),
                   high=int(high))


def exponential(scale=1.0, shape=None, dtype="float32", ctx=None, out=None):
    return _sample("_random_exponential", ctx, out, shape, dtype,
                   lam=1.0 / scale)


def gamma(alpha=1.0, beta=1.0, shape=None, dtype="float32", ctx=None,
          out=None):
    return _sample("_random_gamma", ctx, out, shape, dtype, alpha=alpha,
                   beta=beta)


def poisson(lam=1.0, shape=None, dtype="float32", ctx=None, out=None):
    return _sample("_random_poisson", ctx, out, shape, dtype, lam=lam)


def bernoulli(prob=0.5, shape=None, dtype="float32", ctx=None, out=None):
    return _sample("_random_bernoulli", ctx, out, shape, dtype, prob=prob)


def multinomial(data, shape=(), get_prob=False, dtype="int32"):
    """Category draws from the probabilities along ``data``'s last
    axis."""
    from .ndarray.ndarray import invoke
    from .ops.registry import get_op
    return invoke(get_op("_sample_multinomial"), [data], shape=_shape(shape),
                  get_prob=get_prob, dtype=np.dtype(dtype).name,
                  generator=generator(data.context.device))


def shuffle(data, out=None):
    """``data`` with its first axis permuted."""
    from .ndarray.ndarray import invoke
    from .ops.registry import get_op
    return invoke(get_op("_shuffle"), [data], out=out,
                  generator=generator(data.context.device))
