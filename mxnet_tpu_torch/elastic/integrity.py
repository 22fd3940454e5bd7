"""Integrity checksums of the serving plane.

``Server.resize_slots`` holds every migrated KV page against its source
slot with :func:`page_checksum` while :func:`enabled`;
:func:`token_checksum` is the checksum of a request's host-owned token
state.  Both hash the bytes as the JAX package's do, so a float32 page
or a token list gives the same checksum in both packages.

The rest of the JAX package's integrity sentry (the cross-replica
fingerprints, quarantine, the checkpoint scrub) comes with the training
plane's health and checkpoints (ROADMAP queue 1 item 7).
"""
from __future__ import annotations

import hashlib

__all__ = ["enabled", "page_checksum", "token_checksum"]


def enabled() -> bool:
    """Are the checks on?  ``MXTPU_INTEGRITY`` under the telemetry
    master switch (the JAX package also requires its health plane,
    which this package does not have yet)."""
    from ..telemetry import _switch
    if not _switch.enabled:
        return False
    from .. import envs
    return bool(envs.get("MXTPU_INTEGRITY"))


def _host_bytes(page) -> bytes:
    import numpy as np
    import torch
    if isinstance(page, torch.Tensor):
        t = page.detach().contiguous().cpu()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)     # numpy has no bfloat16
        page = t.numpy()
    return np.ascontiguousarray(np.asarray(page)).tobytes()


def page_checksum(host) -> str:
    """sha256 (16 hex chars) of an array's bytes (a torch tensor on any
    device, or a host array)."""
    return hashlib.sha256(_host_bytes(host)).hexdigest()[:16]


def token_checksum(prompt, generated) -> str:
    """Checksum of one serving request's host-owned token state."""
    blob = ",".join(str(int(t)) for t in prompt) + "|" + \
        ",".join(str(int(t)) for t in generated)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]
