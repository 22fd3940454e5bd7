"""Activation, normalisation and indexing operators the Llama path
uses, in plain PyTorch.  Dense layers are ``nn.Linear`` (``F.linear``,
weight (out, in) as in the JAX package's FullyConnected)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["silu", "rms_norm", "dot", "take", "embedding",
           "cache_update"]


def silu(data):
    return F.silu(data)


def rms_norm(data, gamma, eps=1e-6):
    """x * rsqrt(mean(x^2) + eps) * gamma over the last axis, in the
    input type."""
    ms = torch.mean(torch.square(data), dim=-1, keepdim=True)
    return data * torch.rsqrt(ms + eps) * gamma


def dot(a, b, transpose_a=False, transpose_b=False):
    """Contract the last axis of a with the first axis of b."""
    if transpose_a:
        a = a.t()
    if transpose_b:
        b = b.t()
    return torch.tensordot(a, b, dims=1)


def take(a, indices, axis=0):
    """Gather along ``axis`` with indices clipped into range (tokens and
    positions are float32 in this package: cast to long here)."""
    idx = indices.to(device=a.device).long().clamp(0, a.shape[axis] - 1)
    return torch.index_select(a, axis, idx.reshape(-1)).reshape(
        a.shape[:axis] + tuple(indices.shape) + a.shape[axis + 1:])


def embedding(data, weight):
    """Rows of ``weight`` for (float32 or integer) token ids."""
    return F.embedding(data.to(device=weight.device).long(), weight)


def cache_update(cache, new, offset=0):
    """Write ``new`` (B, S, ...) into ``cache`` (B, C, ...) IN PLACE at
    position ``offset`` along axis 1, cast to the cache's type.

    ``offset`` is a number or 0-d tensor (one position for every row),
    or a (B,) tensor placing each row at its own position (S == 1, the
    per-slot decode).  Like a dynamic-update-slice, the start clamps so
    the update fits in the cache."""
    c, s = cache.shape[1], new.shape[1]
    new = new.to(cache.dtype)
    if torch.is_tensor(offset) and offset.dim():
        if s != 1:
            raise ValueError("per-row cache_update writes one position")
        idx = offset.to(cache.device).long().clamp(0, c - 1)
        rows = torch.arange(cache.shape[0], device=cache.device)
        cache[rows, idx] = new[:, 0]
        return cache
    start = min(max(int(offset), 0), c - s)
    cache[:, start:start + s] = new
    return cache
