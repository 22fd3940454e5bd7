"""Gradient compression for the kvstore's push, as the JAX package's
``kvstore/compression.py``: ``2bit`` snaps each element of ``grad +
residual`` to {-threshold, 0, +threshold}, ``int8`` rounds it to 255
levels of its absmax / 127; either way the rounding error is the key's
residual, added to its next push (error feedback).  ``encode`` gives the
int8 codes and the f32 scale that cross the wire between processes, and
``decode`` sums gathered (codes, scale) pairs."""
from __future__ import annotations

import torch

from ..parallel import collectives as col

__all__ = ["GradientCompression"]


class GradientCompression:
    """A store's compression state: the type, the threshold and one
    residual a key."""

    def __init__(self, params: dict):
        params = dict(params)
        ctype = params.pop("type", params.pop("compression", "2bit"))
        if ctype not in ("2bit", "int8"):
            raise ValueError(
                f"unsupported gradient compression type {ctype!r}; "
                "'2bit' and 'int8' are available")
        self.type = ctype
        self.threshold = float(params.pop("threshold", 0.5))
        if ctype == "2bit" and self.threshold <= 0:
            raise ValueError("threshold must be positive")
        self._residuals = {}

    def _with_residual(self, key, grad):
        res = self._residuals.get(key)
        if res is None or res.shape != grad.shape or \
                res.device != grad.device:
            res = torch.zeros_like(grad)
        return grad + res

    def _codes(self, g):
        """(int8 codes, scale) of ``g``: the collectives' codec."""
        if self.type == "2bit":
            return col._ternary(g, self.threshold), torch.tensor(
                self.threshold, dtype=g.dtype, device=g.device)
        scale = col._scale(g)
        return col._codes(g, scale), scale

    def encode(self, key, grad):
        """-> (int8 codes, 0-d f32 scale); keeps the key's residual."""
        g = self._with_residual(key, grad)
        codes, scale = self._codes(g)
        self._residuals[key] = g - codes.to(g.dtype) * scale
        return codes, scale.to(torch.float32)

    def compress(self, key, grad):
        """``grad`` (a tensor) quantized, its error kept for the key."""
        g = self._with_residual(key, grad)
        codes, scale = self._codes(g)
        q = codes.to(g.dtype) * scale
        self._residuals[key] = g - q
        return q

    @staticmethod
    def decode(gathered_codes, gathered_scales):
        """The f32 sum of per-process (codes, scale) pairs: codes (P,
        ...) and scales (P,)."""
        shape = (-1,) + (1,) * (gathered_codes.dim() - 1)
        return (gathered_codes.to(torch.float32)
                * gathered_scales.reshape(shape)).sum(dim=0)
