"""Loss layers: ``SoftmaxCrossEntropyLoss``, as the JAX package's
``gluon/loss.py``.  Called with tensors or with NDArrays (a Block)."""
from __future__ import annotations

from ..ops import nn as ops
from .block import HybridBlock

__all__ = ["SoftmaxCrossEntropyLoss", "SoftmaxCELoss"]


class SoftmaxCrossEntropyLoss(HybridBlock):
    """Softmax cross-entropy per sample for class-index labels (the
    reference's default ``sparse_label=True``): ``-pick(log_softmax(pred),
    label)`` along ``axis``, the label clipped into range, averaged over
    every axis but the first.  Dense labels, ``from_logits`` and weights
    are not ported."""

    def __init__(self, axis=-1, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._axis = axis

    def forward(self, pred, label):
        logp = ops.log_softmax(pred, axis=self._axis)
        loss = -ops.pick(logp, label, axis=self._axis)
        return loss.reshape(loss.shape[0], -1).mean(dim=1)


SoftmaxCELoss = SoftmaxCrossEntropyLoss
