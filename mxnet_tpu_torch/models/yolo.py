"""YOLOv3, as the JAX package's ``models/yolo.py`` (GluonCV's ``YOLOV3``
family): a Darknet-style stem of strided conv-BN-LeakyReLU blocks, three
detection grids (strides 8, 16, 32) with three anchors each.

Every shape is static: the slots' cells, anchors and strides are
constants of the input size (``_build_layout``); target assignment
(:func:`build_targets`) is a dense (B, M, N) matrix applied by
reductions, the lowest-index GT winning a slot two GTs share; the
ignore mask is a dense (B, N, M) IoU.  ``decode`` runs ``box_nms``
(``ops/det.py``).  The model's and the loss's arithmetic are the JAX
package's op for op, through ``mx.nd``.
"""
from __future__ import annotations

import numpy as np

from ..base import MXNetError
from ..gluon import nn
from ..gluon.block import HybridBlock

__all__ = ["YOLOv3", "YOLOv3Loss", "yolo3_tiny", "build_targets"]


def _conv_bn_leaky(channels, kernel, stride=1, prefix=""):
    out = nn.HybridSequential(prefix=prefix)
    with out.name_scope():
        out.add(nn.Conv2D(channels, kernel, strides=stride,
                          padding=kernel // 2, use_bias=False),
                nn.BatchNorm(),
                nn.LeakyReLU(0.1))
    return out


class YOLOv3(HybridBlock):
    """A Darknet-style stem and three YOLO heads.

    ``anchors``: 3 lists of (w, h) pairs in pixels of the input image,
    finest scale first.  ``forward`` returns the raw head tensor
    (B, N, 5 + num_classes), N the sum over scales of H * W * A, a slot
    [tx, ty, tw, th, obj, cls...]; ``decode`` turns it into corner boxes
    and scores, and the loss takes it raw."""

    def __init__(self, num_classes, image_size=32, base_channels=16,
                 anchors=None, **kwargs):
        super().__init__(**kwargs)
        if image_size % 32:
            raise MXNetError("image_size must be a multiple of 32")
        self.num_classes = num_classes
        self._size = image_size
        if anchors is None:
            s = image_size
            anchors = [[(s * .08, s * .08), (s * .16, s * .12),
                        (s * .12, s * .20)],
                       [(s * .25, s * .25), (s * .40, s * .30),
                        (s * .30, s * .45)],
                       [(s * .55, s * .55), (s * .80, s * .60),
                        (s * .65, s * .85)]]
        if len(anchors) != 3:
            raise MXNetError("YOLOv3 uses exactly 3 scales")
        self._anchors = [[(float(w), float(h)) for w, h in a]
                         for a in anchors]
        self._strides = [8, 16, 32]
        with self.name_scope():
            self.stem = nn.HybridSequential(prefix="stem_")
            with self.stem.name_scope():
                self.stem.add(_conv_bn_leaky(base_channels, 3))
                for i in range(3):      # stride 8
                    self.stem.add(_conv_bn_leaky(
                        base_channels * 2 ** (i + 1), 3, stride=2))
            self.stage4 = _conv_bn_leaky(base_channels * 16, 3,
                                         stride=2, prefix="s4_")
            self.stage5 = _conv_bn_leaky(base_channels * 32, 3,
                                         stride=2, prefix="s5_")
            self.heads = []
            for i in range(3):
                a = len(self._anchors[i])
                head = nn.Conv2D(a * (5 + num_classes), 1,
                                 prefix=f"head{i}_")
                self.register_child(head, f"head{i}")
                self.heads.append(head)
        self._layout = self._build_layout()

    def _build_layout(self):
        """Each slot's constants: its grid cell's origin (pixels), its
        anchor's w and h, its stride; (N, 2), (N, 2), (N, 1) float32."""
        cells, awh, strides = [], [], []
        for i, stride in enumerate(self._strides):
            g = self._size // stride
            ys, xs = np.mgrid[0:g, 0:g]
            # slot order (cell row-major, then anchor), as the head's
            # reshape lays it out
            cell = np.stack([xs, ys], -1).reshape(-1, 2)
            a = len(self._anchors[i])
            cells.append(np.repeat(cell, a, axis=0) * stride)
            awh.append(np.tile(np.asarray(self._anchors[i], "f4"),
                               (g * g, 1)).reshape(-1, 2))
            strides.append(np.full((g * g * a, 1), stride, "f4"))
        return (np.concatenate(cells).astype("f4"),
                np.concatenate(awh).astype("f4"),
                np.concatenate(strides).astype("f4"))

    @property
    def num_slots(self):
        return self._layout[0].shape[0]

    def hybrid_forward(self, F, x):
        c3 = self.stem(x)
        c4 = self.stage4(c3)
        c5 = self.stage5(c4)
        outs = []
        for feat, head, anchors in zip((c3, c4, c5), self.heads,
                                       self._anchors):
            y = head(feat)                     # (B, A*(5+C), H, W)
            b, _, h, w = y.shape
            a = len(anchors)
            y = y.reshape((b, a, 5 + self.num_classes, h * w))
            y = y.transpose((0, 3, 1, 2)).reshape(
                (b, h * w * a, 5 + self.num_classes))
            outs.append(y)
        return F.concat(*outs, dim=1)          # (B, N, 5+C)

    def _layout_nd(self, ctx):
        """The layout as NDArrays on ``ctx``, made once a context."""
        from .. import ndarray as nd
        memo = self.__dict__.setdefault("_layout_memo", {})
        if ctx not in memo:
            memo[ctx] = tuple(nd.array(a, ctx=ctx) for a in self._layout)
        return memo[ctx]

    def decode(self, preds, conf_thresh=0.01, nms_thresh=0.45, topk=100):
        """Raw preds -> (B, N, 6) [cls_id, score, x1, y1, x2, y2] in [0, 1]
        coordinates, suppressed rows -1 (``box_nms``)."""
        from .. import ndarray as nd
        cells, awh, strides = self._layout_nd(preds.context)
        xy = (nd.sigmoid(preds[:, :, 0:2]) * strides + cells) / self._size
        wh = nd.exp(nd.clip(preds[:, :, 2:4], -8.0, 8.0)) * awh \
            / self._size
        obj = nd.sigmoid(preds[:, :, 4:5])
        cls = nd.sigmoid(preds[:, :, 5:])
        scores = obj * cls                       # (B, N, C)
        cls_id = nd.argmax(scores, axis=-1, keepdims=True)
        best = nd.max(scores, axis=-1, keepdims=True)
        rows = nd.concat(cls_id.astype("float32"), best, xy - wh / 2.0,
                         xy + wh / 2.0, dim=-1)
        return nd.contrib.box_nms(rows, overlap_thresh=nms_thresh,
                                  valid_thresh=conf_thresh, topk=topk,
                                  id_index=0, score_index=1,
                                  coord_start=2, force_suppress=False)


def build_targets(net, labels, ctx):
    """Static-shape YOLOv3 target assignment.

    A valid GT (class >= 0) goes to the slots whose anchor has its best
    wh-IoU and whose grid cell (at that slot's stride) holds its center.
    The assignment is a dense (B, M, N) matrix, the slots' targets come
    out of products with it.  Returns (obj_target (B, N), t_x, t_y, t_w,
    t_h, cls (B, N), x1, y1, x2, y2 (B, M, pixels), valid (B, M, 1))."""
    from .. import ndarray as nd
    size = float(net._size)
    cells, awh, strides = net._layout_nd(ctx)
    n = net.num_slots
    valid = (labels[:, :, 0:1] >= 0)                       # (B, M, 1)
    gt_cls = nd.maximum(labels[:, :, 0], nd.zeros_like(labels[:, :, 0]))
    x1, y1 = labels[:, :, 1] * size, labels[:, :, 2] * size
    x2, y2 = labels[:, :, 3] * size, labels[:, :, 4] * size
    gx, gy = (x1 + x2) / 2.0, (y1 + y2) / 2.0              # (B, M)
    gw = nd.maximum(x2 - x1, nd.ones_like(x1))
    gh = nd.maximum(y2 - y1, nd.ones_like(y1))

    # each GT's best anchor by wh-IoU at the origin
    aw = awh[:, 0].reshape((1, 1, n))
    ah = awh[:, 1].reshape((1, 1, n))
    gw_ = gw.expand_dims(-1)
    gh_ = gh.expand_dims(-1)
    inter = nd.minimum(gw_, aw) * nd.minimum(gh_, ah)
    wh_iou = inter / (gw_ * gh_ + aw * ah - inter)         # (B, M, N)
    best_iou = nd.max(wh_iou, axis=-1, keepdims=True)
    is_best_shape = (wh_iou >= best_iou - 1e-9)
    cx = cells[:, 0].reshape((1, 1, n))
    cy = cells[:, 1].reshape((1, 1, n))
    st = strides[:, 0].reshape((1, 1, n))
    gx_ = gx.expand_dims(-1)
    gy_ = gy.expand_dims(-1)
    in_cell = ((gx_ >= cx) * (gx_ < cx + st)
               * (gy_ >= cy) * (gy_ < cy + st))
    assign = is_best_shape * in_cell * valid               # (B, M, N)

    obj_target = nd.max(assign, axis=1)                    # (B, N)
    # GTs that collide on a slot: the lowest-index one wins (the argmax
    # of the 0/1 column); an unmatched slot reads GT 0, which every
    # consumer masks
    first_gt = nd.argmax(assign, axis=1).astype("int32")   # (B, N)
    sel = nd.one_hot(first_gt, labels.shape[1])            # (B, N, M)

    def to_slots(v):
        return nd.sum(sel * v.expand_dims(1), axis=-1)

    sx, sy = to_slots(gx), to_slots(gy)
    sw, sh = to_slots(gw), to_slots(gh)
    scls = to_slots(gt_cls)
    cxs = cells[:, 0].reshape((1, n))
    cys = cells[:, 1].reshape((1, n))
    sts = strides[:, 0].reshape((1, n))
    t_x = nd.clip((sx - cxs) / sts, 1e-4, 1.0 - 1e-4)
    t_y = nd.clip((sy - cys) / sts, 1e-4, 1.0 - 1e-4)
    t_w = nd.log(nd.maximum(sw, nd.ones_like(sw)) / awh[:, 0].reshape((1, n)))
    t_h = nd.log(nd.maximum(sh, nd.ones_like(sh)) / awh[:, 1].reshape((1, n)))
    return (obj_target, t_x, t_y, t_w, t_h, scls, x1, y1, x2, y2, valid)


def _bce(nd, logit, target):
    """Sigmoid cross-entropy from logits, the stable form."""
    return nd.relu(logit) - logit * target + \
        nd.log(1.0 + nd.exp(-nd.abs(logit)))


class YOLOv3Loss:
    """GluonCV's YOLOV3Loss pairing: sigmoid BCE for the center offsets,
    objectness and classes, L1 for the log-scale w and h; an unmatched
    slot whose decoded box overlaps a GT above ``ignore_iou`` leaves the
    objectness loss.  ``labels`` are SSD-style (B, M, 5) [cls, x1, y1,
    x2, y2] in [0, 1], padded rows cls = -1."""

    def __init__(self, net: YOLOv3, ignore_iou=0.7):
        self.net = net
        self.ignore_iou = float(ignore_iou)

    def __call__(self, preds, labels):
        from .. import ndarray as nd
        net = self.net
        cells, awh, strides = net._layout_nd(preds.context)
        b = labels.shape[0]
        (obj_target, t_x, t_y, t_w, t_h, scls, x1, y1, x2, y2,
         valid) = build_targets(net, labels, preds.context)

        # the ignore mask: decoded boxes against the GTs
        xy = nd.sigmoid(preds[:, :, 0:2]) * strides + cells
        wh = nd.exp(nd.clip(preds[:, :, 2:4], -8.0, 8.0)) * awh
        dec = nd.concat(xy - wh / 2, xy + wh / 2, dim=-1)  # px corners
        gtb = nd.concat(x1.expand_dims(-1), y1.expand_dims(-1),
                        x2.expand_dims(-1), y2.expand_dims(-1),
                        dim=-1)                            # (B, M, 4)
        ious = nd.contrib.box_iou(dec, gtb) \
            * valid.transpose((0, 2, 1))                   # (B, N, M)
        best_over_gt = nd.max(ious, axis=-1)               # (B, N)
        ignore = (best_over_gt > self.ignore_iou) * (1.0 - obj_target)

        obj_loss = _bce(nd, preds[:, :, 4], obj_target) * (1.0 - ignore)
        pos = obj_target
        npos = nd.maximum(nd.sum(pos), nd.ones((1,), ctx=preds.context))
        xy_loss = (_bce(nd, preds[:, :, 0], t_x)
                   + _bce(nd, preds[:, :, 1], t_y)) * pos
        wh_loss = (nd.abs(preds[:, :, 2] - t_w)
                   + nd.abs(preds[:, :, 3] - t_h)) * pos
        cls_onehot = nd.one_hot(scls.astype("int32"), net.num_classes)
        cls_loss = nd.sum(_bce(nd, preds[:, :, 5:], cls_onehot),
                          axis=-1) * pos
        return (nd.sum(obj_loss) / (b * 1.0)
                + nd.sum(xy_loss + wh_loss + cls_loss) / npos)


def yolo3_tiny(num_classes=2, image_size=32, **kwargs):
    """Test-size YOLOv3 (a 32-pixel input: 4 x 4, 2 x 2 and 1 x 1 cells,
    3 anchors each)."""
    return YOLOv3(num_classes, image_size=image_size, base_channels=8,
                  **kwargs)
