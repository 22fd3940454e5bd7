"""``Block``: an ``nn.Module`` with the reference's ``initialize``.

Layers make their parameters on the ``meta`` device (no memory);
``initialize(init, ctx=...)`` places the whole tree on the context's
device and fills it there from a seeded generator, so a large model is
drawn on the card directly.  The rest of the reference's Block surface
(name scopes, ``collect_params``, ``hybridize``) is not ported.
"""
from __future__ import annotations

import torch
from torch import nn

from .. import initializer
from ..context import current_context

__all__ = ["Block"]


class Block(nn.Module):
    """Base of the port's gluon layers and models."""

    def initialize(self, init=None, ctx=None, seed=None):
        """Place every parameter on ``ctx`` (default: the current context,
        ``gpu(0)``, which raises without a card) and fill it: a
        parameter's own initializer, else ``init`` (default ``Uniform()``)
        by name.  Draws come from ``seed``, or from the device's
        ``mx.random`` generator when None.  Returns ``self``."""
        from .. import random as _random
        dev = (ctx or current_context()).device
        own = {n: p.mx_init for n, p in self.named_parameters()
               if getattr(p, "mx_init", None) is not None}
        self.to_empty(device=dev)
        for name, p in self.named_parameters():
            if name in own:
                p.mx_init = own[name]
        if seed is None:
            gen = _random.generator(dev)
        else:
            gen = torch.Generator(device=dev)
            gen.manual_seed(int(seed))
        initializer.fill(self, init, gen)
        return self
