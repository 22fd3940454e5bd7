"""Loss layers, as the JAX package's ``gluon/loss.py``: L2, L1, sigmoid
and softmax cross-entropy, KL divergence, Huber, hinge, squared hinge,
logistic, triplet and cosine-embedding losses, over the ``Loss(weight,
batch_axis)`` base.  Called with tensors or with NDArrays (a Block).

Every loss multiplies by ``sample_weight`` (broadcast) and by the number
``weight`` when given, then takes the mean over every axis but
``batch_axis``, except ``TripletLoss`` (a sum before its margin) and
``CosineEmbeddingLoss`` (one value a row), as in the reference.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..base import MXNetError
from ..ops import nn as ops
from .block import HybridBlock

__all__ = ["Loss", "L2Loss", "L1Loss", "SigmoidBinaryCrossEntropyLoss",
           "SigmoidBCELoss", "SoftmaxCrossEntropyLoss", "SoftmaxCELoss",
           "KLDivLoss", "HuberLoss", "HingeLoss", "SquaredHingeLoss",
           "LogisticLoss", "TripletLoss", "CosineEmbeddingLoss"]


def _apply_weighting(loss, weight=None, sample_weight=None):
    if sample_weight is not None:
        loss = loss * sample_weight
    if weight is not None:
        assert isinstance(weight, (float, int)), "weight must be a number"
        loss = loss * weight
    return loss


def _reshape_like(x, y):
    return x.reshape(y.shape)


def _batch_mean(loss, batch_axis):
    """The mean over every axis but ``batch_axis``."""
    keep = batch_axis % loss.dim()
    axes = [a for a in range(loss.dim()) if a != keep]
    return loss.mean(dim=axes) if axes else loss


def _softrelu_neg_abs(x):
    """``log(1 + exp(-|x|))``, the stable tail of the logistic losses."""
    return F.softplus(-torch.abs(x))


class Loss(HybridBlock):
    """Base of the losses: ``weight`` scales the loss (a number, or None)
    and ``batch_axis`` is the axis the result keeps."""

    def __init__(self, weight, batch_axis, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._weight = weight
        self._batch_axis = batch_axis

    def __repr__(self):
        return (f"{self.__class__.__name__}(batch_axis={self._batch_axis}, "
                f"w={self._weight})")

    def forward(self, *args):
        raise NotImplementedError


class L2Loss(Loss):
    """``0.5 * weight * (pred - label)^2``; ``weight`` is 1 by default."""

    def __init__(self, weight=1.0, batch_axis=0, prefix=None, params=None):
        super().__init__(weight, batch_axis, prefix=prefix, params=params)

    def forward(self, pred, label, sample_weight=None):
        loss = torch.square(_reshape_like(label, pred) - pred)
        loss = _apply_weighting(loss, self._weight / 2, sample_weight)
        return _batch_mean(loss, self._batch_axis)


class L1Loss(Loss):
    """``|pred - label|``."""

    def __init__(self, weight=None, batch_axis=0, prefix=None, params=None):
        super().__init__(weight, batch_axis, prefix=prefix, params=params)

    def forward(self, pred, label, sample_weight=None):
        loss = torch.abs(_reshape_like(label, pred) - pred)
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return _batch_mean(loss, self._batch_axis)


class SigmoidBinaryCrossEntropyLoss(Loss):
    """Binary cross-entropy of ``pred`` against 0/1 ``label``s.  ``pred``
    is a logit (the stable form ``relu(x) - x * z + log(1 + exp(-|x|))``)
    or, with ``from_sigmoid``, a probability (with 1e-12 inside each
    log).  ``pos_weight`` scales the positive term."""

    def __init__(self, from_sigmoid=False, weight=None, batch_axis=0,
                 prefix=None, params=None):
        super().__init__(weight, batch_axis, prefix=prefix, params=params)
        self._from_sigmoid = from_sigmoid

    def forward(self, pred, label, sample_weight=None, pos_weight=None):
        label = _reshape_like(label, pred)
        if not self._from_sigmoid:
            if pos_weight is None:
                loss = torch.relu(pred) - pred * label + \
                    _softrelu_neg_abs(pred)
            else:
                log_weight = 1 + (pos_weight - 1) * label
                loss = pred - pred * label + log_weight * (
                    _softrelu_neg_abs(pred) + torch.relu(-pred))
        else:
            eps = 1e-12
            pos = torch.log(pred + eps) * label
            if pos_weight is not None:
                pos = pos * pos_weight
            loss = -(pos + torch.log(1. - pred + eps) * (1. - label))
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return _batch_mean(loss, self._batch_axis)


SigmoidBCELoss = SigmoidBinaryCrossEntropyLoss


class SoftmaxCrossEntropyLoss(Loss):
    """Softmax cross-entropy along ``axis``: ``-pick(log_softmax(pred),
    label)`` for class-index labels (``sparse_label``, the default; the
    index clipped into range), else ``-sum(log_softmax(pred) * label)``
    for a distribution.  With ``from_logits`` ``pred`` is already a log
    probability."""

    def __init__(self, axis=-1, sparse_label=True, from_logits=False,
                 weight=None, batch_axis=0, prefix=None, params=None):
        super().__init__(weight, batch_axis, prefix=prefix, params=params)
        self._axis = axis
        self._sparse_label = sparse_label
        self._from_logits = from_logits

    def forward(self, pred, label, sample_weight=None):
        if not self._from_logits:
            pred = ops.log_softmax(pred, axis=self._axis)
        if self._sparse_label:
            loss = -ops.pick(pred, label, axis=self._axis, keepdims=True)
        else:
            loss = -torch.sum(pred * _reshape_like(label, pred),
                              dim=self._axis, keepdim=True)
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return _batch_mean(loss, self._batch_axis)


SoftmaxCELoss = SoftmaxCrossEntropyLoss


class KLDivLoss(Loss):
    """``label * (log(label) - pred)``; ``pred`` is a log probability
    (``from_logits``, the default), else logits put through
    ``log_softmax`` along ``axis``."""

    def __init__(self, from_logits=True, axis=-1, weight=None, batch_axis=0,
                 prefix=None, params=None):
        super().__init__(weight, batch_axis, prefix=prefix, params=params)
        self._from_logits = from_logits
        self._axis = axis

    def forward(self, pred, label, sample_weight=None):
        if not self._from_logits:
            pred = ops.log_softmax(pred, axis=self._axis)
        loss = label * (torch.log(label + 1e-12) - pred)
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return _batch_mean(loss, self._batch_axis)


class HuberLoss(Loss):
    """``|d| - rho / 2`` where ``|d| > rho``, else ``d^2 / (2 rho)``."""

    def __init__(self, rho=1, weight=None, batch_axis=0, prefix=None,
                 params=None):
        super().__init__(weight, batch_axis, prefix=prefix, params=params)
        self._rho = rho

    def forward(self, pred, label, sample_weight=None):
        loss = torch.abs(_reshape_like(label, pred) - pred)
        loss = torch.where(loss > self._rho, loss - 0.5 * self._rho,
                           (0.5 / self._rho) * torch.square(loss))
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return _batch_mean(loss, self._batch_axis)


class HingeLoss(Loss):
    """``relu(margin - pred * label)`` for -1/1 labels."""

    def __init__(self, margin=1, weight=None, batch_axis=0, prefix=None,
                 params=None):
        super().__init__(weight, batch_axis, prefix=prefix, params=params)
        self._margin = margin

    def forward(self, pred, label, sample_weight=None):
        loss = torch.relu(self._margin - pred * _reshape_like(label, pred))
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return _batch_mean(loss, self._batch_axis)


class SquaredHingeLoss(Loss):
    """``relu(margin - pred * label)^2`` for -1/1 labels."""

    def __init__(self, margin=1, weight=None, batch_axis=0, prefix=None,
                 params=None):
        super().__init__(weight, batch_axis, prefix=prefix, params=params)
        self._margin = margin

    def forward(self, pred, label, sample_weight=None):
        loss = torch.square(torch.relu(
            self._margin - pred * _reshape_like(label, pred)))
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return _batch_mean(loss, self._batch_axis)


class LogisticLoss(Loss):
    """The logistic loss of logits ``pred``; ``label_format`` "signed"
    (-1/1 labels, mapped to 0/1) or "binary" (0/1)."""

    def __init__(self, weight=None, batch_axis=0, label_format="signed",
                 prefix=None, params=None):
        super().__init__(weight, batch_axis, prefix=prefix, params=params)
        self._label_format = label_format
        if label_format not in ("signed", "binary"):
            raise MXNetError(f"label_format can only be signed or binary, "
                             f"recieved {label_format}")

    def forward(self, pred, label, sample_weight=None):
        label = _reshape_like(label, pred)
        if self._label_format == "signed":
            label = (label + 1.0) / 2.0
        loss = torch.relu(pred) - pred * label + _softrelu_neg_abs(pred)
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return _batch_mean(loss, self._batch_axis)


class TripletLoss(Loss):
    """``relu(sum(|positive - pred|^2 - |negative - pred|^2) + margin)``,
    the sum over every axis but ``batch_axis``."""

    def __init__(self, margin=1, weight=None, batch_axis=0, prefix=None,
                 params=None):
        super().__init__(weight, batch_axis, prefix=prefix, params=params)
        self._margin = margin

    def forward(self, pred, positive, negative, sample_weight=None):
        positive = _reshape_like(positive, pred)
        negative = _reshape_like(negative, pred)
        keep = self._batch_axis % pred.dim()
        loss = torch.sum(torch.square(positive - pred)
                         - torch.square(negative - pred),
                         dim=[a for a in range(pred.dim()) if a != keep])
        loss = torch.relu(loss + self._margin)
        return _apply_weighting(loss, self._weight, sample_weight)


class CosineEmbeddingLoss(Loss):
    """``1 - cos(input1, input2)`` for label 1, else ``relu(cos -
    margin)``, a row each (the rows flattened; 1e-12 inside each norm's
    square root)."""

    def __init__(self, weight=None, batch_axis=0, margin=0, prefix=None,
                 params=None):
        super().__init__(weight, batch_axis, prefix=prefix, params=params)
        self._margin = margin

    def forward(self, input1, input2, label, sample_weight=None):
        input1 = input1.reshape(input1.shape[0], -1)
        input2 = input2.reshape(input2.shape[0], -1)
        cos = torch.sum(input1 * input2, dim=-1) / (
            torch.sqrt(torch.sum(torch.square(input1), dim=-1) + 1e-12)
            * torch.sqrt(torch.sum(torch.square(input2), dim=-1) + 1e-12))
        loss = torch.where(label.reshape(-1) == 1, 1.0 - cos,
                           torch.relu(cos - self._margin))
        return _apply_weighting(loss, self._weight, sample_weight)
