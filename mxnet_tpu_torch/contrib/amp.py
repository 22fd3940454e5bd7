"""Automatic mixed precision, as the JAX package's ``contrib/amp``.

``init()`` makes the matrix-product operators run their float32 inputs
in bfloat16: exactly the reference's ``TARGET_DTYPE_OPS`` that the port
has (``FullyConnected``, ``dot``, ``dot_product_attention``).  Every
other operator keeps its input types, so a float32 residual plus a
bfloat16 projection promotes to float32 as in the reference.  The
operators ask :func:`cast_inputs`; nothing is patched.  ``torch.autocast``
is not used: its operator list is not the reference's, and it does not
reach the flash kernels' autograd function.

bfloat16 needs no loss scaling; float16 with a loss scaler is not
ported.
"""
from __future__ import annotations

import torch

from ..base import MXNetError

__all__ = ["init", "target_dtype", "cast_inputs", "TARGET_DTYPE_OPS"]

TARGET_DTYPE_OPS = ("FullyConnected", "dot", "dot_product_attention")

_state = {"target_dtype": None}


def init(target_dtype="bfloat16"):
    """Enable AMP (parity: ``amp.init``); a second call is a no-op."""
    if _state["target_dtype"] is not None:
        return
    if target_dtype not in ("bfloat16", "bf16", torch.bfloat16):
        raise MXNetError(f"unsupported AMP dtype {target_dtype!r}: the port "
                         "has bfloat16 (float16 needs the loss scaler, "
                         "not ported)")
    _state["target_dtype"] = torch.bfloat16


def _deinit():
    """Undo :func:`init`."""
    _state["target_dtype"] = None


def target_dtype():
    """The AMP type, or None when AMP is off."""
    return _state["target_dtype"]


def cast_inputs(op, *tensors):
    """``tensors`` as operator ``op`` takes them: float32 ones cast to the
    AMP type when AMP is on and ``op`` is a target operator; None and
    every other type pass through."""
    dt = _state["target_dtype"]
    if dt is None or op not in TARGET_DTYPE_OPS:
        return tensors
    return tuple(t.to(dt) if t is not None and t.dtype == torch.float32
                 else t for t in tensors)
