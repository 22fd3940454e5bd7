"""SSD single-shot detector, as the JAX package's ``models/ssd.py`` (the
reference's ``example/ssd/`` over the contrib MultiBox ops): a small
conv backbone, per-scale class and box predictors, anchors from
``_contrib_MultiBoxPrior``.  Training pairs it with
``_contrib_MultiBoxTarget`` and :class:`MultiBoxLoss`, inference with
``_contrib_MultiBoxDetection`` (``ops/det.py``).
"""
from __future__ import annotations

from ..gluon import nn
from ..gluon.block import HybridBlock

__all__ = ["SSD", "ssd_tiny", "MultiBoxLoss"]


def _feature_block(channels, prefix):
    """conv-BN-relu x2 then stride-2 downsample."""
    out = nn.HybridSequential(prefix=prefix)
    with out.name_scope():
        for _ in range(2):
            out.add(nn.Conv2D(channels, 3, padding=1, use_bias=False),
                    nn.BatchNorm(), nn.Activation("relu"))
        out.add(nn.MaxPool2D(2))
    return out


class SSD(HybridBlock):
    """Multi-scale SSD head over a small conv backbone.

    Per scale: a class predictor ``(A*(num_classes+1))``-channel conv
    and a box predictor ``(A*4)``-channel conv; anchors from
    ``_contrib_MultiBoxPrior``.  ``forward`` returns (anchors (1, N, 4),
    cls_preds (B, C+1, N), loc_preds (B, N*4)), the triple
    MultiBoxTarget and MultiBoxDetection take.
    """

    def __init__(self, num_classes, num_scales=3, base_channels=16,
                 sizes=None, ratios=None, **kwargs):
        super().__init__(**kwargs)
        self.num_classes = num_classes
        self._num_scales = num_scales
        if sizes is None:
            lo, hi = 0.2, 0.9
            step = (hi - lo) / max(num_scales - 1, 1)
            sizes = [(lo + i * step, lo + (i + 0.5) * step)
                     for i in range(num_scales)]
        if ratios is None:
            ratios = [(1.0, 2.0, 0.5)] * num_scales
        self._sizes = [tuple(s) for s in sizes]
        self._ratios = [tuple(r) for r in ratios]
        with self.name_scope():
            self.features = []
            self.cls_heads = []
            self.box_heads = []
            for i in range(num_scales):
                feat = _feature_block(base_channels * (2 ** i),
                                      prefix=f"feat{i}_")
                a = len(self._sizes[i]) + len(self._ratios[i]) - 1
                cls = nn.Conv2D(a * (num_classes + 1), 3, padding=1,
                                prefix=f"cls{i}_")
                box = nn.Conv2D(a * 4, 3, padding=1, prefix=f"box{i}_")
                self.register_child(feat, f"feat{i}")
                self.register_child(cls, f"cls{i}")
                self.register_child(box, f"box{i}")
                self.features.append(feat)
                self.cls_heads.append(cls)
                self.box_heads.append(box)

    def hybrid_forward(self, F, x):
        anchors, cls_preds, loc_preds = [], [], []
        for i in range(self._num_scales):
            x = self.features[i](x)
            anchors.append(F._contrib_MultiBoxPrior(
                x, sizes=self._sizes[i], ratios=self._ratios[i]))
            c = self.cls_heads[i](x)       # (B, A*(C+1), H, W)
            b, _, h, w = c.shape
            # flatten pixel-major (slot n = pixel n // A, anchor n % A)
            # to line up with MultiBoxPrior's anchor order and loc_preds
            c = c.reshape((b, -1, self.num_classes + 1, h * w))
            c = c.transpose((0, 2, 3, 1)).reshape(
                (b, self.num_classes + 1, -1))
            cls_preds.append(c)
            loc = self.box_heads[i](x).reshape((b, -1, 4, h * w))
            loc = loc.transpose((0, 3, 1, 2)).reshape((b, -1))
            loc_preds.append(loc)
        return (F.concat(*anchors, dim=1), F.concat(*cls_preds, dim=2),
                F.concat(*loc_preds, dim=1))


class MultiBoxLoss:
    """SSD training loss: softmax CE on classes + smooth-L1 on offsets
    (the reference example/ssd's pairing); the normalizers stay on the
    device."""

    def __call__(self, cls_preds, cls_target, loc_preds, loc_target,
                 loc_mask):
        from .. import ndarray as nd
        ctx = cls_preds.context
        logp = nd.log_softmax(cls_preds, axis=1)           # (B, C+1, N)
        picked = nd.pick(logp.transpose((0, 2, 1)), cls_target, axis=2)
        ignore = cls_target >= 0
        n_kept = nd.maximum(nd.sum(ignore), nd.ones((1,), ctx=ctx))
        cls_loss = -nd.sum(picked * ignore) / n_kept
        diff = (loc_preds - loc_target) * loc_mask
        adiff = nd.abs(diff)
        sl1 = nd.where(adiff > 1.0, adiff - 0.5, 0.5 * diff * diff)
        denom = nd.maximum(nd.sum(loc_mask), nd.ones((1,), ctx=ctx))
        loc_loss = nd.sum(sl1) / denom
        return cls_loss + loc_loss


def ssd_tiny(num_classes=2, **kwargs):
    """Small SSD for tests and examples (3 scales, 16-channel base)."""
    return SSD(num_classes, num_scales=3, base_channels=16, **kwargs)
