"""Loss layers: ``SoftmaxCrossEntropyLoss``, as the JAX package's
``gluon/loss.py``."""
from __future__ import annotations

from torch import nn

from ..ops import nn as ops

__all__ = ["SoftmaxCrossEntropyLoss"]


class SoftmaxCrossEntropyLoss(nn.Module):
    """Softmax cross-entropy per sample for class-index labels (the
    reference's default ``sparse_label=True``): ``-pick(log_softmax(pred),
    label)`` along ``axis``, the label clipped into range, averaged over
    every axis but the first.  Dense labels, ``from_logits`` and weights
    are not ported."""

    def __init__(self, axis=-1):
        super().__init__()
        self._axis = axis

    def forward(self, pred, label):
        logp = ops.log_softmax(pred, axis=self._axis)
        loss = -ops.pick(logp, label, axis=self._axis)
        return loss.reshape(loss.shape[0], -1).mean(dim=1)
