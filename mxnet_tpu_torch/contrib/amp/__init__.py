"""Automatic mixed precision, as the JAX package's ``contrib/amp``.

``init(target_dtype)`` makes the matrix-product operators run their
float32 inputs in ``target_dtype`` (bfloat16 or float16): exactly the
reference's ``TARGET_DTYPE_OPS`` that the port has (``FullyConnected``,
``Convolution``, ``Deconvolution``, ``dot``, ``dot_product_attention``).
Every other operator keeps its input types, so a float32 residual plus a
low-precision projection promotes to float32, and BatchNorm of a
low-precision convolution with float32 gamma and beta returns float32, as
in the reference.  The reference lists ``FP32_OPS`` but does not apply
them, and neither does the port (ROADMAP queue 3, R1).  The operators ask
:func:`cast_inputs`; nothing is patched.  ``torch.autocast`` is not used:
its operator list is not the reference's, and it does not reach the flash
kernels' autograd function.

float16 has a range of 65504, so its training loop scales the loss: a
:class:`~.loss_scaler.LossScaler` attached by :func:`init_trainer`,
:func:`scale_loss` around the backward, and :func:`unscale`, which reads
once a step on the host whether every gradient is finite (``all_finite``,
the reference's ``asscalar``), moves the scale and returns True when the
step must be skipped::

    amp.init("float16"); amp.init_trainer(trainer)
    with autograd.record():
        loss = ...
        with amp.scale_loss(loss, trainer) as scaled:
            scaled.backward()
    if not amp.unscale(trainer):
        trainer.step(batch_size)

``scale_loss`` sets ``trainer._scale`` to ``1 / loss_scale`` of its
original value, so the next ``trainer.step`` folds the unscaling into the
optimizer's ``rescale_grad``, a device scalar: a captured step reads each
step's scale with no new capture.

Under float16, ``init`` turns off cuBLAS's reduced-precision reduction
(``torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction``,
PyTorch's default on), so float16 products accumulate in float32 as the
reference's do; :func:`_deinit` restores it.
"""
from __future__ import annotations

import numpy as np
import torch

from ...base import MXNetError
from .loss_scaler import LossScaler

__all__ = ["init", "init_trainer", "scale_loss", "unscale", "convert_model",
           "target_dtype", "cast_inputs", "LossScaler", "TARGET_DTYPE_OPS"]

TARGET_DTYPE_OPS = ("FullyConnected", "Convolution", "Deconvolution",
                    "dot", "dot_product_attention")

_DTYPES = {"bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
           "float16": torch.float16}

_state = {"target_dtype": None, "fp16_reduction": None}


def init(target_dtype="bfloat16"):
    """Enable AMP (parity: ``amp.init``) in bfloat16 or float16; a second
    call is a no-op."""
    if _state["target_dtype"] is not None:
        return
    if target_dtype is np.float16:
        target_dtype = "float16"
    dt = target_dtype if isinstance(target_dtype, torch.dtype) \
        else _DTYPES.get(str(target_dtype))
    if dt not in (torch.bfloat16, torch.float16):
        raise MXNetError(f"unsupported AMP dtype {target_dtype!r}: "
                         "bfloat16 or float16")
    if dt == torch.float16:
        matmul = torch.backends.cuda.matmul
        _state["fp16_reduction"] = \
            matmul.allow_fp16_reduced_precision_reduction
        matmul.allow_fp16_reduced_precision_reduction = False
    _state["target_dtype"] = dt


def _deinit():
    """Undo :func:`init`."""
    if _state["fp16_reduction"] is not None:
        torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction = \
            _state["fp16_reduction"]
        _state["fp16_reduction"] = None
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


def init_trainer(trainer):
    """Attach a dynamic loss scaler to a ``gluon.Trainer`` (parity:
    ``amp.init_trainer``)."""
    if _state["target_dtype"] is None:
        raise MXNetError("call amp.init() before amp.init_trainer()")
    trainer._amp_loss_scaler = LossScaler()
    trainer._amp_original_scale = trainer._scale
    return trainer


class scale_loss:
    """``with amp.scale_loss(loss, trainer) as scaled: scaled.backward()``:
    the loss (or each of a list) times the scaler's ``loss_scale``, and the
    trainer's gradient scale divided by it."""

    def __init__(self, loss, trainer):
        self.loss = loss
        self.trainer = trainer

    def __enter__(self):
        scaler = getattr(self.trainer, "_amp_loss_scaler", None)
        if scaler is None:
            return self.loss
        self.trainer._scale = (self.trainer._amp_original_scale
                               / scaler.loss_scale)
        if isinstance(self.loss, (list, tuple)):
            return [l * scaler.loss_scale for l in self.loss]
        return self.loss * scaler.loss_scale

    def __exit__(self, *exc):
        return None


def unscale(trainer):
    """Whether any gradient of the trainer's parameters overflowed (one
    host read of ``all_finite``), moving the loss scale (parity:
    ``amp.unscale``): skip the step when it returns True."""
    scaler = getattr(trainer, "_amp_loss_scaler", None)
    if scaler is None:
        return False
    return scaler.has_overflow([p.grad() for p in trainer._params
                                if p.grad_req != "null"])


def convert_model(net, target_dtype="bfloat16"):
    """Cast a gluon block for low-precision inference (parity:
    ``amp.convert_model``'s gluon path); BatchNorm's statistics stay
    float32 (``Block.cast``)."""
    net.cast(target_dtype)
    return net
