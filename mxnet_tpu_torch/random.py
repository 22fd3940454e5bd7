"""Global RNG state: ``mx.random.seed`` and one ``torch.Generator`` per
device.

``seed(s)`` reseeds every device's stream; ``seed(s, ctx=...)`` only
that device's.  A device's stream derives from the base seed and the
device's identity, so two cards never draw the same numbers.  The
generators give other numbers than the JAX package's keys from the
same seed: tests feed both packages numpy-made inputs instead.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from .context import Context

__all__ = ["seed", "generator"]

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
