"""Faster R-CNN, as the JAX package's ``models/rcnn.py`` (the
reference's ``example/rcnn`` and GluonCV's ``faster_rcnn`` family):
a stride-8 conv backbone, an RPN over dense square anchors, RoIAlign and
a Dense head.

Both stages have static shapes: the RPN proposes a fixed number of
regions an image (the top K by objectness through ``topk``; the
threshold-and-NMS pipeline lives only in ``decode``, where ``box_nms``
marks suppressed rows), ``ROIAlign`` pools K regions an image, and the
targets of both stages come from dense IoU matrices and argmax.  The
proposals are cut from the gradient before RoIAlign.  The anchors are a
constant parameter (``anchors``), so a hybridized call carries them with
the weights; such a call holds ``topk`` and ``ROIAlign`` in its graph.
"""
from __future__ import annotations

import numpy as np

from ..base import MXNetError
from ..gluon import nn
from ..gluon.block import HybridBlock

__all__ = ["FasterRCNN", "FasterRCNNLoss", "faster_rcnn_tiny"]


def _conv_bn_relu(channels, stride=1, prefix=""):
    out = nn.HybridSequential(prefix=prefix)
    with out.name_scope():
        out.add(nn.Conv2D(channels, 3, strides=stride, padding=1,
                          use_bias=False),
                nn.BatchNorm(), nn.Activation("relu"))
    return out


def _encode_deltas(nd, src, dst):
    """Box regression targets from ``src`` to ``dst``, both (..., 4)
    corners in pixels."""
    sw = nd.maximum(src[..., 2] - src[..., 0], nd.ones_like(src[..., 0]))
    sh = nd.maximum(src[..., 3] - src[..., 1], nd.ones_like(src[..., 0]))
    sx = (src[..., 0] + src[..., 2]) / 2.0
    sy = (src[..., 1] + src[..., 3]) / 2.0
    dw = nd.maximum(dst[..., 2] - dst[..., 0], nd.ones_like(src[..., 0]))
    dh = nd.maximum(dst[..., 3] - dst[..., 1], nd.ones_like(src[..., 0]))
    dx = (dst[..., 0] + dst[..., 2]) / 2.0
    dy = (dst[..., 1] + dst[..., 3]) / 2.0
    return nd.stack((dx - sx) / sw, (dy - sy) / sh,
                    nd.log(dw / sw), nd.log(dh / sh), axis=-1)


def _apply_deltas(nd, boxes, deltas, size):
    """The inverse of :func:`_encode_deltas`, clipped to the image."""
    bw = nd.maximum(boxes[..., 2] - boxes[..., 0],
                    nd.ones_like(boxes[..., 0]))
    bh = nd.maximum(boxes[..., 3] - boxes[..., 1],
                    nd.ones_like(boxes[..., 0]))
    bx = (boxes[..., 0] + boxes[..., 2]) / 2.0
    by = (boxes[..., 1] + boxes[..., 3]) / 2.0
    cx = bx + deltas[..., 0] * bw
    cy = by + deltas[..., 1] * bh
    w = bw * nd.exp(nd.clip(deltas[..., 2], -4.0, 4.0))
    h = bh * nd.exp(nd.clip(deltas[..., 3], -4.0, 4.0))
    out = nd.stack(cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2, axis=-1)
    return nd.clip(out, 0.0, float(size))


def _take_rows(nd, data, idx):
    """data (B, N, D), idx (B, K) -> (B, K, D) by a one-hot product, as
    the JAX package selects them (no gather); the one-hot takes the
    data's type."""
    onehot = nd.one_hot(idx.astype("int32"), data.shape[1],
                        dtype=data.dtype)                  # (B, K, N)
    return nd.batch_dot(onehot, data)


class FasterRCNN(HybridBlock):
    """Two-stage detector with a fixed proposal budget.

    ``forward(x)`` returns (rpn_obj (B, Na), rpn_deltas (B, Na, 4),
    proposals (B, K, 4) corners in pixels, cls_logits (B, K, C+1),
    head_deltas (B, K, 4)); class 0 is the background."""

    def __init__(self, num_classes, image_size=64, base_channels=16,
                 anchor_sizes=(12, 24, 40), num_proposals=16,
                 roi_size=4, **kwargs):
        super().__init__(**kwargs)
        if image_size % 8:
            raise MXNetError("image_size must be a multiple of 8")
        self.num_classes = num_classes
        self._size = image_size
        self._stride = 8
        self._k = int(num_proposals)
        self._roi = int(roi_size)
        g = image_size // self._stride
        # one centered square a size a cell
        ys, xs = np.mgrid[0:g, 0:g].astype("f4")
        cxy = np.stack([xs, ys], -1).reshape(-1, 2) * self._stride \
            + self._stride / 2.0
        # slot order (anchor size, cell), as the head's reshape lays it
        self._anchors_np = np.concatenate(
            [np.concatenate([cxy - s / 2.0, cxy + s / 2.0], axis=1)
             for s in anchor_sizes], 0).astype("f4")
        self._num_anchor_shapes = len(anchor_sizes)
        with self.name_scope():
            self.anchors = self.params.get_constant("anchors",
                                                    self._anchors_np)
            self.backbone = nn.HybridSequential(prefix="backbone_")
            with self.backbone.name_scope():
                self.backbone.add(_conv_bn_relu(base_channels))
                self.backbone.add(_conv_bn_relu(base_channels * 2, 2))
                self.backbone.add(_conv_bn_relu(base_channels * 4, 2))
                self.backbone.add(_conv_bn_relu(base_channels * 8, 2))
            self.rpn_conv = _conv_bn_relu(base_channels * 8, prefix="rpnc_")
            a = self._num_anchor_shapes
            self.rpn_obj = nn.Conv2D(a, 1, prefix="rpno_")
            self.rpn_box = nn.Conv2D(a * 4, 1, prefix="rpnb_")
            self.head_fc = nn.Dense(128, activation="relu", flatten=False,
                                    prefix="fc_")
            self.head_cls = nn.Dense(num_classes + 1, flatten=False,
                                     prefix="cls_")
            self.head_box = nn.Dense(4, flatten=False, prefix="box_")

    @property
    def anchors_c(self):
        """The anchors' constant parameter (the JAX package's name)."""
        return self.anchors

    @property
    def num_anchors(self):
        return self._anchors_np.shape[0]

    def hybrid_forward(self, F, x, anchors=None):
        b = x.shape[0]
        feat = self.backbone(x)
        r = self.rpn_conv(feat)
        a = self._num_anchor_shapes
        g2 = feat.shape[2] * feat.shape[3]
        obj = self.rpn_obj(r).reshape((b, a * g2))         # (B, Na)
        deltas = self.rpn_box(r).reshape((b, a, 4, g2))
        deltas = deltas.transpose((0, 1, 3, 2)).reshape(
            (b, a * g2, 4))                                # (B, Na, 4)
        boxes = _apply_deltas(F, anchors.expand_dims(0), deltas,
                              self._size)                  # (B, Na, 4)
        # the fixed proposal budget: the top K by objectness, cut from
        # the gradient
        k = self._k
        top_idx = F.topk(obj, k=k, axis=-1)                # (B, K)
        props = F.stop_gradient(_take_rows(F, boxes, top_idx))
        # RoIAlign over the batch: (B*K, 5) rows with the image index
        bidx = F.repeat(F.arange(0, b, ctx=x.context).reshape((b, 1)),
                        repeats=k, axis=1)
        rois = F.concat(bidx.reshape((b * k, 1)),
                        props.reshape((b * k, 4)), dim=-1)
        pooled = F.ROIAlign(feat, rois, pooled_size=(self._roi, self._roi),
                            spatial_scale=1.0 / self._stride)
        h = self.head_fc(pooled.reshape((b, k, -1)))
        return obj, deltas, props, self.head_cls(h), self.head_box(h)

    def decode(self, outs, conf_thresh=0.05, nms_thresh=0.5):
        """(B, K, 6) [cls_id, score, x1, y1, x2, y2] in [0, 1], suppressed
        rows -1 (``box_nms``); the background is left out."""
        from .. import ndarray as nd
        _, _, props, cls_logits, head_deltas = outs
        probs = nd.softmax(cls_logits, axis=-1)            # (B, K, C+1)
        fg = probs[:, :, 1:]
        cls_id = nd.argmax(fg, axis=-1, keepdims=True)
        score = nd.max(fg, axis=-1, keepdims=True)
        boxes = _apply_deltas(nd, props, head_deltas, self._size) \
            / float(self._size)
        rows = nd.concat(cls_id.astype("float32"), score, boxes, dim=-1)
        return nd.contrib.box_nms(
            rows, overlap_thresh=nms_thresh, valid_thresh=conf_thresh,
            topk=self._k, id_index=0, score_index=1, coord_start=2)


def _smooth_l1(nd, x):
    ax = nd.abs(x)
    return nd.where(ax > 1.0, ax - 0.5, 0.5 * x * x)


def _bce(nd, logit, target):
    return nd.relu(logit) - logit * target + \
        nd.log(1.0 + nd.exp(-nd.abs(logit)))


class FasterRCNNLoss:
    """RPN BCE and smooth L1, head cross-entropy and smooth L1, with
    dense-IoU target assignment (positive at IoU >= ``rpn_pos_iou`` /
    ``head_pos_iou``, RPN negatives below ``rpn_neg_iou``, the rest
    ignored).  ``labels`` are SSD-style (B, M, 5) [cls, x1..y2] in
    [0, 1], padded rows cls = -1."""

    def __init__(self, net: FasterRCNN, rpn_pos_iou=0.5, rpn_neg_iou=0.3,
                 head_pos_iou=0.5):
        self.net = net
        self.rpn_pos = float(rpn_pos_iou)
        self.rpn_neg = float(rpn_neg_iou)
        self.head_pos = float(head_pos_iou)

    def __call__(self, outs, labels):
        from .. import ndarray as nd
        net = self.net
        size = float(net._size)
        obj, deltas, props, cls_logits, head_deltas = outs
        b = labels.shape[0]
        valid = (labels[:, :, 0:1] >= 0)                   # (B, M, 1)
        gt_boxes = labels[:, :, 1:] * size                 # (B, M, 4)
        gt_cls = nd.maximum(labels[:, :, 0], nd.zeros_like(labels[:, :, 0]))
        one = nd.ones((1,), ctx=obj.context)

        def match(boxes):
            """(B, X, 4) -> (best IoU (B, X), its GT (B, X))."""
            iou = nd.contrib.box_iou(boxes, gt_boxes) \
                * valid.transpose((0, 2, 1))               # (B, X, M)
            return nd.max(iou, axis=-1), nd.argmax(iou, axis=-1)

        # the RPN
        anchors = net.anchors_c.data(obj.context).expand_dims(0)
        anc = nd.broadcast_to(anchors, (b,) + anchors.shape[1:])
        a_iou, a_gt = match(anc)
        pos = (a_iou >= self.rpn_pos)
        neg = (a_iou < self.rpn_neg)
        npos = nd.maximum(nd.sum(pos), one)
        rpn_obj_loss = nd.sum(_bce(nd, obj, pos) * (pos + neg)) \
            / nd.maximum(nd.sum(pos + neg), one)
        t = _encode_deltas(nd, anc, _take_rows(nd, gt_boxes, a_gt))
        rpn_box_loss = nd.sum(
            _smooth_l1(nd, deltas - t) * pos.expand_dims(-1)) / npos

        # the head
        p_iou, p_gt = match(props)
        fg = (p_iou >= self.head_pos)                      # (B, K)
        cls_target = (_take_rows(nd, gt_cls.expand_dims(-1),
                                 p_gt)[:, :, 0] + 1.0) * fg  # 0: background
        logp = nd.log_softmax(cls_logits, axis=-1)
        head_cls_loss = -nd.mean(
            nd.pick(logp, cls_target.astype("int32"), axis=-1))
        th = _encode_deltas(nd, props, _take_rows(nd, gt_boxes, p_gt))
        nfg = nd.maximum(nd.sum(fg), one)
        head_box_loss = nd.sum(
            _smooth_l1(nd, head_deltas - th) * fg.expand_dims(-1)) / nfg
        return rpn_obj_loss + rpn_box_loss + head_cls_loss + head_box_loss


def faster_rcnn_tiny(num_classes=2, image_size=64, **kwargs):
    """Test-size Faster R-CNN (64 pixels, an 8 x 8 grid, 16
    proposals)."""
    return FasterRCNN(num_classes, image_size=image_size, base_channels=8,
                      **kwargs)
