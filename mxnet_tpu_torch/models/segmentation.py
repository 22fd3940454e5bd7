"""Semantic segmentation, as the JAX package's ``models/segmentation.py``
(GluonCV's ``FCN`` and ``DeepLabV3`` over a zoo backbone).

The backbone is a zoo classification net made before the head: its
stage blocks keep their own parameter names and become children of
``_Backbone`` too, which taps the last two stages (stride 16 and 32;
FCN-32s, no dilation).  Each head's logits go back to the input's size
through ``BilinearResize2D`` (two products with jax.image's weights).
Under ``hybridize()`` a recorded call is one forward and one backward
graph replay (the ``CachedOp``).  :class:`SegmentationMetric` counts
its confusion matrix on the device of the arrays it is given and reads
only the matrix back.
"""
from __future__ import annotations

import numpy as np
import torch

from ..gluon import nn
from ..gluon.block import HybridBlock
from ..metric import EvalMetric
from .feature import truncate_features

__all__ = ["FCN", "DeepLabV3", "SegmentationMetric", "fcn_tiny",
           "deeplab_tiny", "SoftmaxSegLoss"]


class _Backbone(HybridBlock):
    """Splits a zoo CNN's ``features`` into stem / stages so heads can
    tap the last two stage outputs (stride 16 and 32)."""

    def __init__(self, zoo_net, **kwargs):
        super().__init__(**kwargs)
        # a plain list (not registered by assignment) and one
        # register_child each: the blocks' second parent
        self._blocks = truncate_features(zoo_net)
        for i, b in enumerate(self._blocks):
            self.register_child(b, f"bb{i}")

    def hybrid_forward(self, F, x):
        for b in self._blocks[:-2]:
            x = b(x)
        c3 = self._blocks[-2](x)
        c4 = self._blocks[-1](c3)
        return c3, c4


class _FCNHead(HybridBlock):
    """GluonCV's _FCNHead: 3x3 conv (C/4) + BN + relu + dropout + 1x1."""

    def __init__(self, in_channels, nclass, dropout=0.1, **kwargs):
        super().__init__(**kwargs)
        inter = max(in_channels // 4, 8)
        with self.name_scope():
            self.block = nn.HybridSequential()
            with self.block.name_scope():
                self.block.add(
                    nn.Conv2D(inter, 3, padding=1, use_bias=False,
                              in_channels=in_channels),
                    nn.BatchNorm(in_channels=inter),
                    nn.Activation("relu"))
                if dropout:
                    self.block.add(nn.Dropout(dropout))
                self.block.add(nn.Conv2D(nclass, 1, in_channels=inter))

    def hybrid_forward(self, F, x):
        return self.block(x)


class _SegBase(HybridBlock):
    """Shared FCN/DeepLab scaffolding: backbone taps, bilinear upsample
    back to the input's size, and the optional aux head on stage 3 (the
    GluonCV recipe's deep supervision)."""

    def __init__(self, nclass, backbone, aux=True, **kwargs):
        super().__init__(**kwargs)
        self.nclass = nclass
        self._aux = aux
        with self.name_scope():
            self.backbone = _Backbone(backbone, prefix="backbone_")

    def _upsample(self, F, x, size):
        return F.BilinearResize2D(x, height=size[0], width=size[1])

    def hybrid_forward(self, F, x):
        h, w = x.shape[2], x.shape[3]
        c3, c4 = self.backbone(x)
        out = self._upsample(F, self.head(c4), (h, w))
        if self._aux:
            return out, self._upsample(F, self.aux_head(c3), (h, w))
        return out

    def predict(self, x):
        """Class map (B, H, W) from the main head."""
        from .. import ndarray as nd
        out = self(x)
        if isinstance(out, (tuple, list)):
            out = out[0]
        return nd.argmax(out, axis=1)


class FCN(_SegBase):
    """FCN-32s with stage-3 auxiliary supervision (GluonCV ``FCN``).

    ``backbone`` is a fully-convolutional zoo classification net (its
    classifier is not used); ``c3_channels``/``c4_channels`` are the
    channel counts of its last two stages: 256/512 for resnet18/34,
    1024/2048 for resnet50 and deeper."""

    def __init__(self, nclass, backbone, c3_channels, c4_channels,
                 aux=True, dropout=0.1, **kwargs):
        super().__init__(nclass, backbone, aux=aux, **kwargs)
        with self.name_scope():
            self.head = _FCNHead(c4_channels, nclass, dropout,
                                 prefix="head_")
            if aux:
                self.aux_head = _FCNHead(c3_channels, nclass, dropout,
                                         prefix="aux_")


class _ASPP(HybridBlock):
    """Atrous spatial pyramid pooling (DeepLabV3): parallel 1x1 and
    dilated 3x3 branches + image-level pooling, fused by a 1x1."""

    def __init__(self, in_channels, out_channels=64, rates=(6, 12, 18),
                 **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.branches = []
            b0 = nn.HybridSequential(prefix="b0_")
            with b0.name_scope():
                b0.add(nn.Conv2D(out_channels, 1, use_bias=False,
                                 in_channels=in_channels),
                       nn.BatchNorm(in_channels=out_channels),
                       nn.Activation("relu"))
            self.branches.append(b0)
            self.register_child(b0, "b0")
            for i, r in enumerate(rates):
                br = nn.HybridSequential(prefix=f"b{i + 1}_")
                with br.name_scope():
                    br.add(nn.Conv2D(out_channels, 3, padding=r,
                                     dilation=r, use_bias=False,
                                     in_channels=in_channels),
                           nn.BatchNorm(in_channels=out_channels),
                           nn.Activation("relu"))
                self.branches.append(br)
                self.register_child(br, f"b{i + 1}")
            self.gap_conv = nn.Conv2D(out_channels, 1, use_bias=False,
                                      in_channels=in_channels,
                                      prefix="gap_")
            self.project = nn.Conv2D(
                out_channels, 1, use_bias=False,
                in_channels=out_channels * (len(rates) + 2),
                prefix="proj_")
            self.project_bn = nn.BatchNorm(in_channels=out_channels)

    def hybrid_forward(self, F, x):
        h, w = x.shape[2], x.shape[3]
        outs = [br(x) for br in self.branches]
        gap = F.mean(x, axis=(2, 3), keepdims=True)
        gap = F.Activation(self.gap_conv(gap), act_type="relu")
        outs.append(F.broadcast_to(gap, (x.shape[0], gap.shape[1], h, w)))
        y = self.project(F.concat(*outs, dim=1))
        return F.Activation(self.project_bn(y), act_type="relu")


class DeepLabV3(_SegBase):
    """DeepLabV3: ASPP over the stride-32 features + FCN aux head."""

    def __init__(self, nclass, backbone, c3_channels, c4_channels,
                 aspp_channels=64, rates=(6, 12, 18), aux=True,
                 dropout=0.1, **kwargs):
        super().__init__(nclass, backbone, aux=aux, **kwargs)
        with self.name_scope():
            aspp = _ASPP(c4_channels, aspp_channels, rates, prefix="aspp_")
            head = nn.HybridSequential(prefix="head_")
            with head.name_scope():
                head.add(aspp)
                if dropout:
                    head.add(nn.Dropout(dropout))
                head.add(nn.Conv2D(nclass, 1, in_channels=aspp_channels))
            self.head = head
            if aux:
                self.aux_head = _FCNHead(c3_channels, nclass, dropout,
                                         prefix="aux_")


class SoftmaxSegLoss:
    """Per-pixel CE with ignore label and optional aux weighting (the
    GluonCV MixSoftmaxCrossEntropyLoss recipe): the mean over the
    pixels not ignored, plus ``aux_weight`` times the aux head's."""

    def __init__(self, ignore_label=-1, aux_weight=0.4):
        self.ignore_label = ignore_label
        self.aux_weight = aux_weight

    def __call__(self, outs, label):
        from .. import ndarray as nd
        if not isinstance(outs, (tuple, list)):
            outs = (outs,)

        def ce(logits):
            logp = nd.log_softmax(logits, axis=1)       # (B,C,H,W)
            keep = (label != self.ignore_label)
            safe = nd.where(keep, label,
                            nd.zeros_like(label)).astype("int32")
            picked = nd.pick(logp.transpose((0, 2, 3, 1)), safe, axis=3)
            # the label's dtype: the JAX package promotes the count to it
            n = nd.maximum(nd.sum(keep), nd.ones((1,), ctx=label.context,
                                                 dtype=label.dtype))
            return -nd.sum(picked * keep) / n

        loss = ce(outs[0])
        if len(outs) > 1:
            loss = loss + self.aux_weight * ce(outs[1])
        return loss


def _tensor(x, device=None):
    """The torch tensor of an NDArray, a tensor or a numpy array (made
    on ``device`` when given)."""
    return torch.as_tensor(getattr(x, "_t", x), device=device)


class SegmentationMetric(EvalMetric):
    """pixAcc + mIoU over streaming batches (GluonCV
    ``SegmentationMetric``; the ignore label excluded).

    One confusion matrix accumulates per update through one torch
    ``bincount`` on the label's device (numpy inputs become tensors on
    the host); only the nclass x nclass counts are read back."""

    def __init__(self, nclass, ignore_label=-1):
        self.nclass = nclass
        self.ignore_label = ignore_label
        super().__init__(name="segmentation")

    def reset(self):
        super().reset()
        # reset() runs from the base __init__, before __init__ sets nclass
        n = getattr(self, "nclass", 0)
        self._cm = np.zeros((n, n), np.int64)

    def _counts(self, label, pred):
        """(nclass x nclass confusion counts, pixels counted)."""
        n = self.nclass
        li = _tensor(label).reshape(-1).long()
        pi = _tensor(pred, li.device).reshape(-1).long()
        keep = li != int(self.ignore_label)
        cm = torch.bincount(n * li[keep] + pi[keep], minlength=n * n)
        cm = cm.cpu().numpy().reshape(n, n)
        return cm, int(cm.sum())

    def update(self, labels, preds):
        if not isinstance(labels, (list, tuple)):
            labels, preds = [labels], [preds]
        for label, pred in zip(labels, preds):
            cm, kept = self._counts(label, pred)
            self._cm += cm
            self.num_inst += kept

    def get(self):
        cm = self._cm
        inter = np.diag(cm)
        acc = float(inter.sum() / max(cm.sum(), 1))
        union = cm.sum(0) + cm.sum(1) - inter
        seen = union > 0
        iou = np.where(seen, inter / np.maximum(union, 1), np.nan)
        miou = float(np.nanmean(iou)) if seen.any() else 0.0
        return (["pixAcc", "mIoU"], [acc, miou])


def _tiny_backbone():
    from ..gluon.model_zoo import vision
    return vision.resnet18_v1(classes=10, thumbnail=True)


def fcn_tiny(nclass=3, aux=True):
    """Test-size FCN over thumbnail resnet18 (stages end at 256/512)."""
    return FCN(nclass, _tiny_backbone(), c3_channels=256, c4_channels=512,
               aux=aux)


def deeplab_tiny(nclass=3, aux=True):
    return DeepLabV3(nclass, _tiny_backbone(), c3_channels=256,
                     c4_channels=512, aspp_channels=32, aux=aux)
