"""Detection and bounding-box ops, as the JAX package's ``ops/det.py``
(the reference's ``src/operator/contrib/`` ``bounding_box.cc``,
``roi_align.cc``, ``multibox_{prior,target,detection}.cc``,
``psroi_pooling.cc``, ``multi_proposal.cc``).

Every op runs on its inputs' device with their static shapes: ``box_nms``
returns the input's shape with suppressed rows all -1, sorted by
descending score.  The JAX package suppresses greedily with an N-step
``fori_loop``; here the same greedy answer is the fixed point of one
masked reduction a pass (:func:`_greedy_keep`), which settles in as many
passes as the longest chain of suppressions, usually a few, and is built
over the first ``topk`` sorted rows only, since no row past them is kept
or suppresses another.  Scatters whose indices may repeat keep the last
writer, as XLA's do, through ``scatter_reduce("amax")`` (deterministic on
the card).
"""
from __future__ import annotations

import numpy as np
import torch

from .registry import alias, register

__all__ = ["box_iou", "box_nms", "roi_align", "multibox_prior",
           "multibox_target", "multibox_detection", "box_encode",
           "box_decode", "bipartite_matching", "psroi_pooling",
           "multi_proposal", "proposal", "nms_passes"]

#: fixed-point passes of each batch chunk of the last ``box_nms`` call
nms_passes = []

# rows of a (rows, n, n) suppression mask built at once: 64M elements
_NMS_CHUNK = 1 << 26


def _iou_corner(lhs, rhs):
    """IoU between (..., N, 4) and (..., M, 4) corner boxes -> (..., N, M);
    0 where the union is not positive."""
    lx1, ly1, lx2, ly2 = (lhs[..., :, None, i] for i in range(4))
    rx1, ry1, rx2, ry2 = (rhs[..., None, :, i] for i in range(4))
    ix = (torch.minimum(lx2, rx2) - torch.maximum(lx1, rx1)).clamp(min=0)
    iy = (torch.minimum(ly2, ry2) - torch.maximum(ly1, ry1)).clamp(min=0)
    inter = ix * iy
    area_l = (lx2 - lx1).clamp(min=0) * (ly2 - ly1).clamp(min=0)
    area_r = (rx2 - rx1).clamp(min=0) * (ry2 - ry1).clamp(min=0)
    union = area_l + area_r - inter
    return torch.where(union > 0, inter / union, 0.0)


def _to_corner(boxes):
    """center (x, y, w, h) -> corner (x1, y1, x2, y2)."""
    x, y, w, h = (boxes[..., i] for i in range(4))
    return torch.stack([x - w / 2, y - h / 2, x + w / 2, y + h / 2], dim=-1)


@register("_contrib_box_iou", num_inputs=2)
def box_iou(lhs, rhs, *, format="corner"):
    """Pairwise IoU of (..., N, 4) and (..., M, 4) boxes."""
    if format == "center":
        lhs, rhs = _to_corner(lhs), _to_corner(rhs)
    return _iou_corner(lhs, rhs)


def _greedy_keep(valid, over):
    """The rows greedy suppression keeps: row j is kept iff it is valid
    and no kept row i < j overlaps it (``over[..., i, j]``, True only
    above the diagonal).  Iterates ``keep = valid & ~any_i(keep_i &
    over_ij)`` from ``keep = valid``: pass k settles the first k rows, so
    the unique fixed point, reached when ``keep`` stops changing, is the
    greedy answer.  One host read a pass.  Returns (keep, passes)."""
    keep = valid
    passes = 0
    while True:
        passes += 1
        new = valid & ~(keep.unsqueeze(-1) & over).any(dim=-2)
        if torch.equal(new, keep):
            return keep, passes
        keep = new


@register("_contrib_box_nms", num_inputs=1)
def box_nms(data, *, overlap_thresh=0.5, valid_thresh=0, topk=-1,
            coord_start=2, score_index=1, id_index=-1,
            force_suppress=False, in_format="corner",
            out_format="corner"):
    """Greedy non-maximum suppression of (..., N, K) rows with a score at
    ``score_index``, corner coordinates at ``coord_start``, and a class
    id at ``id_index`` (only rows of the same class suppress each other,
    unless ``force_suppress``).  Rows come back sorted by descending
    score (the first of equal scores first), suppressed and invalid rows
    (score <= ``valid_thresh``, or past the ``topk``-th) all -1; the
    shape is the input's.  Raises on the center format, as the JAX
    package does."""
    if in_format == "center" or out_format == "center":
        raise NotImplementedError(
            "box_nms: center format not implemented (corner only)")
    nms_passes.clear()
    shape = data.shape
    n = shape[-2]
    flat = data.reshape((-1,) + tuple(shape[-2:]))
    scores = flat[..., score_index]
    valid = scores > valid_thresh
    key = torch.where(valid, scores, float("-inf"))
    order = torch.argsort(-key, dim=-1, stable=True)
    d_sorted = torch.gather(flat, 1, order[..., None].expand(flat.shape))
    valid_sorted = torch.gather(valid, 1, order)
    # rows past the topk-th are neither kept nor suppress: build the
    # overlaps over the first k rows only
    k = min(int(topk), n) if topk > 0 else n
    keep = torch.zeros_like(valid_sorted)
    head = d_sorted[:, :k]
    upper = torch.ones((k, k), dtype=torch.bool, device=data.device).triu(1)
    step = max(1, _NMS_CHUNK // max(k * k, 1))
    for lo in range(0, flat.shape[0], step):
        rows = head[lo:lo + step]
        boxes = rows[..., coord_start:coord_start + 4]
        iou = _iou_corner(boxes, boxes)
        if id_index >= 0 and not force_suppress:
            ids = rows[..., id_index]
            iou = torch.where(ids[:, :, None] == ids[:, None, :], iou, 0.0)
        over = iou > overlap_thresh
        del iou
        kept, passes = _greedy_keep(valid_sorted[lo:lo + step, :k],
                                    over & upper)
        keep[lo:lo + step, :k] = kept
        nms_passes.append(passes)
    out = torch.where(keep[..., None], d_sorted, -1.0)
    return out.to(data.dtype).reshape(shape)


@register("_contrib_ROIAlign", num_inputs=2)
def roi_align(data, rois, *, pooled_size=(7, 7), spatial_scale=1.0,
              sample_ratio=-1, position_sensitive=False):
    """ROI Align: for (R, 5) rows [batch index, x1, y1, x2, y2] in image
    coordinates over ``data`` (N, C, H, W), the mean of ``sample_ratio``
    x ``sample_ratio`` bilinear taps a bin (``-1`` takes 2, as the JAX
    package does) -> (R, C, PH, PW)."""
    if position_sensitive:
        raise NotImplementedError("position_sensitive ROIAlign")
    ph, pw = (pooled_size if isinstance(pooled_size, (tuple, list))
              else (pooled_size, pooled_size))
    n, c, h, w = data.shape
    sr = sample_ratio if sample_ratio > 0 else 2
    rois = rois.to(data.dtype)
    r = rois.shape[0]
    bidx = rois[:, 0].long()
    x1, y1, x2, y2 = (rois[:, i + 1:i + 2] * spatial_scale for i in range(4))
    bin_w = torch.clamp(x2 - x1, min=1.0) / pw
    bin_h = torch.clamp(y2 - y1, min=1.0) / ph
    dev = data.device
    ys = y1 + (torch.arange(ph * sr, device=dev) + 0.5) * (bin_h / sr)
    xs = x1 + (torch.arange(pw * sr, device=dev) + 0.5) * (bin_w / sr)
    y0 = torch.floor(ys).clamp(0, h - 1)
    x0 = torch.floor(xs).clamp(0, w - 1)
    y1i = (y0 + 1).clamp(0, h - 1).long()
    x1i = (x0 + 1).clamp(0, w - 1).long()
    wy = (ys - y0).clamp(0.0, 1.0)
    wx = (xs - x0).clamp(0.0, 1.0)
    y0, x0 = y0.long(), x0.long()
    b = bidx[:, None, None]

    def gather(yi, xi):                       # (R, C, Sy, Sx)
        return data[b, :, yi[:, :, None], xi[:, None, :]].movedim(-1, 1)

    wy, wx = wy[:, None, :, None], wx[:, None, None, :]
    v = (gather(y0, x0) * ((1 - wy) * (1 - wx))
         + gather(y0, x1i) * ((1 - wy) * wx)
         + gather(y1i, x0) * (wy * (1 - wx))
         + gather(y1i, x1i) * (wy * wx))
    return v.reshape(r, c, ph, sr, pw, sr).mean(dim=(3, 5))


alias("box_iou", "_contrib_box_iou")
alias("box_nms", "_contrib_box_nms")
alias("ROIAlign", "_contrib_ROIAlign")


# -- the SSD ops (reference multibox_{prior,target,detection}.cc) ------------


@register("_contrib_MultiBoxPrior", num_inputs=1)
def multibox_prior(data, *, sizes=(1.0,), ratios=(1.0,), clip=False,
                   steps=(-1.0, -1.0), offsets=(0.5, 0.5)):
    """Anchors of a (B, C, H, W) feature map (only H and W are read):
    per pixel every size at ``ratios[0]``, then ``sizes[0]`` at each other
    ratio, centred at ``(i + offset) * step`` (step 1 / H, 1 / W unless
    ``steps`` gives it) -> (1, H W A, 4) normalized corner boxes."""
    h, w = data.shape[2], data.shape[3]
    dev = data.device
    step_y = steps[0] if steps[0] > 0 else 1.0 / h
    step_x = steps[1] if steps[1] > 0 else 1.0 / w
    cy = (torch.arange(h, dtype=torch.float32, device=dev)
          + offsets[0]) * step_y
    cx = (torch.arange(w, dtype=torch.float32, device=dev)
          + offsets[1]) * step_x
    r0 = float(np.sqrt(ratios[0]))
    half = [(s * r0 / 2.0, s / r0 / 2.0) for s in sizes]
    for r in ratios[1:]:
        sr = float(np.sqrt(r))
        half.append((sizes[0] * sr / 2.0, sizes[0] / sr / 2.0))
    # the half sizes as float32 numbers, passed as scalars (no upload, so
    # a captured graph can hold the op)
    half = [tuple(float(v) for v in np.float32(p)) for p in half]
    cxg = cx[None, :].expand(h, w)
    cyg = cy[:, None].expand(h, w)
    boxes = torch.stack(
        [torch.stack([cxg - hw, cyg - hh, cxg + hw, cyg + hh], dim=-1)
         for hw, hh in half], dim=2)                      # (H, W, A, 4)
    boxes = boxes.reshape(1, h * w * len(half), 4)
    if clip:
        boxes = boxes.clamp(0.0, 1.0)
    return boxes


def _encode_loc(anchors, gt, variances):
    """Corner anchors and corner ground truth -> (dx, dy, dw, dh)."""
    aw = anchors[..., 2] - anchors[..., 0]
    ah = anchors[..., 3] - anchors[..., 1]
    ax = (anchors[..., 0] + anchors[..., 2]) / 2
    ay = (anchors[..., 1] + anchors[..., 3]) / 2
    gw = (gt[..., 2] - gt[..., 0]).clamp(min=1e-8)
    gh = (gt[..., 3] - gt[..., 1]).clamp(min=1e-8)
    gx = (gt[..., 0] + gt[..., 2]) / 2
    gy = (gt[..., 1] + gt[..., 3]) / 2
    dx = (gx - ax) / aw.clamp(min=1e-8) / variances[0]
    dy = (gy - ay) / ah.clamp(min=1e-8) / variances[1]
    dw = torch.log(gw / aw.clamp(min=1e-8)) / variances[2]
    dh = torch.log(gh / ah.clamp(min=1e-8)) / variances[3]
    return torch.stack([dx, dy, dw, dh], dim=-1)


def _last_writer(index, n, m):
    """For (B, M) anchor indices (``n`` = dropped), the (B, n) index of
    the last of the M rows that wrote each anchor, -1 where none did:
    ``.at[index].set(arange(M), mode="drop")`` as XLA resolves repeats."""
    b = index.shape[0]
    rows = torch.arange(m, device=index.device).expand(b, m)
    out = torch.full((b, n + 1), -1, dtype=torch.long, device=index.device)
    return out.scatter_reduce_(1, index, rows, "amax")[:, :n]


@register("_contrib_MultiBoxTarget", num_inputs=3, num_outputs=3)
def multibox_target(anchors, labels, cls_preds, *,
                    overlap_threshold=0.5, ignore_label=-1.0,
                    negative_mining_ratio=-1.0,
                    negative_mining_thresh=0.5, minimum_negative_samples=0,
                    variances=(0.1, 0.1, 0.2, 0.2)):
    """Anchor-to-ground-truth matching and the regression targets.

    anchors (1, N, 4) corner; labels (B, M, 5) rows [cls, x1, y1, x2, y2],
    padded with cls -1; cls_preds (B, C + 1, N), read only by the hard
    negative mining.  An anchor matches its best ground truth at IoU >=
    ``overlap_threshold``, and each valid ground truth also claims its
    best anchor (the last claim of an anchor wins; padding rows claim
    nothing).  With ``negative_mining_ratio`` > 0 the negatives kept
    are the ``ratio * positives`` (at least ``minimum_negative_samples``)
    with the highest max-logit over background, among anchors whose best
    IoU is below ``negative_mining_thresh``; the other negatives get
    ``ignore_label``.  Returns loc_target (B, N 4), loc_mask (B, N 4) and
    cls_target (B, N), the class + 1 (0 = background)."""
    anc = anchors[0]
    n = anc.shape[0]
    b, m = labels.shape[0], labels.shape[1]
    cls = labels[:, :, 0]
    valid = cls >= 0                                     # (B, M)
    gt = labels[:, :, 1:5]
    iou = _iou_corner(anc.expand(b, n, 4), gt)           # (B, N, M)
    iou = torch.where(valid[:, None, :], iou, -1.0)
    best_iou, best_gt = iou.max(dim=2)
    pos = best_iou >= overlap_threshold
    gt_best = torch.where(valid, iou.argmax(dim=1), n)   # (B, M)
    claimed = _last_writer(gt_best, n, m)                # (B, N)
    forced = claimed >= 0
    match = torch.where(forced, claimed, best_gt)
    pos = pos | forced
    matched = torch.gather(gt, 1, match[..., None].expand(b, n, 4))
    loc_t = _encode_loc(anc, matched, variances)
    loc_t = torch.where(pos[..., None], loc_t, 0.0).reshape(b, -1)
    loc_m = pos[..., None].expand(b, n, 4).to(torch.float32).reshape(b, -1)
    cls_t = torch.where(pos, torch.gather(cls, 1, match) + 1.0, 0.0)
    if negative_mining_ratio > 0:
        bg = cls_preds[:, 0]
        neg_score = cls_preds.max(dim=1).values - bg
        neg_score = torch.where(best_iou < negative_mining_thresh,
                                neg_score, float("-inf"))
        num_pos = pos.sum(dim=1, keepdim=True)
        quota = (negative_mining_ratio * num_pos.float()).int()
        quota = quota.clamp(min=int(minimum_negative_samples))
        key = -torch.where(pos, float("-inf"), neg_score)
        neg_rank = torch.argsort(torch.argsort(key, dim=1, stable=True),
                                 dim=1, stable=True)
        keep_neg = (~pos) & (best_iou < negative_mining_thresh) \
            & (neg_rank < quota)
        cls_t = torch.where(pos | keep_neg, cls_t, float(ignore_label))
    return loc_t, loc_m, cls_t


@register("_contrib_MultiBoxDetection", num_inputs=3)
def multibox_detection(cls_probs, loc_preds, anchors, *, clip=True,
                       threshold=0.01, background_id=0,
                       nms_threshold=0.5, force_suppress=False,
                       variances=(0.1, 0.1, 0.2, 0.2), nms_topk=-1):
    """Decode and per-class NMS: cls_probs (B, C + 1, N), loc_preds
    (B, N 4), anchors (1, N, 4) -> (B, N, 6) rows [class id, score, x1,
    y1, x2, y2], the id numbering the foreground classes (the background
    row taken out), rows scoring at most ``threshold`` and suppressed
    rows all -1, through :func:`box_nms` with ``topk=nms_topk``."""
    anc = anchors[0]
    aw = anc[:, 2] - anc[:, 0]
    ah = anc[:, 3] - anc[:, 1]
    ax = (anc[:, 0] + anc[:, 2]) / 2
    ay = (anc[:, 1] + anc[:, 3]) / 2
    b = cls_probs.shape[0]
    d = loc_preds.reshape(b, -1, 4)
    cx = d[..., 0] * variances[0] * aw + ax
    cy = d[..., 1] * variances[1] * ah + ay
    w = torch.exp((d[..., 2] * variances[2]).clamp(max=10.0)) * aw
    h = torch.exp((d[..., 3] * variances[3]).clamp(max=10.0)) * ah
    boxes = torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2],
                        dim=-1)
    if clip:
        boxes = boxes.clamp(0.0, 1.0)
    fg = torch.cat([cls_probs[:, :background_id],
                    cls_probs[:, background_id + 1:]], dim=1)
    score, cls_id = fg.max(dim=1)
    keep = score > threshold
    ids = torch.where(keep, cls_id.to(score.dtype), -1.0)
    rows = torch.cat([ids[..., None],
                      torch.where(keep, score, -1.0)[..., None], boxes],
                     dim=-1)
    return box_nms(rows, overlap_thresh=nms_threshold, valid_thresh=0.0,
                   topk=nms_topk, coord_start=2, score_index=1, id_index=0,
                   force_suppress=force_suppress)


# -- box coding and matching (reference bounding_box.cc) ---------------------


@register("_contrib_box_encode", num_inputs=4, num_outputs=2)
def box_encode(samples, matches, anchors, refs, *,
               means=(0.0, 0.0, 0.0, 0.0), stds=(0.1, 0.1, 0.2, 0.2)):
    """Regression targets of (B, N, 4) corner anchors against the (B, M,
    4) corner references each one matches (``matches`` (B, N)), masked
    to the positives (``samples`` > 0.5) -> (targets, masks), each
    (B, N, 4)."""
    a_w = anchors[:, :, 2] - anchors[:, :, 0]
    a_h = anchors[:, :, 3] - anchors[:, :, 1]
    a_x = anchors[:, :, 0] + a_w * 0.5
    a_y = anchors[:, :, 1] + a_h * 0.5
    idx = matches.long().clamp(min=0)
    g = torch.gather(refs, 1, idx[..., None].expand(idx.shape + (4,)))
    g_w = g[:, :, 2] - g[:, :, 0]
    g_h = g[:, :, 3] - g[:, :, 1]
    g_x = g[:, :, 0] + g_w * 0.5
    g_y = g[:, :, 1] + g_h * 0.5
    eps = 1e-8
    t = torch.stack([
        ((g_x - a_x) / (a_w + eps) - means[0]) / stds[0],
        ((g_y - a_y) / (a_h + eps) - means[1]) / stds[1],
        (torch.log(g_w.clamp(min=eps) / (a_w + eps)) - means[2]) / stds[2],
        (torch.log(g_h.clamp(min=eps) / (a_h + eps)) - means[3]) / stds[3]],
        dim=-1)
    mask = (samples > 0.5)[:, :, None].expand(t.shape).to(t.dtype)
    return t * mask, mask


@register("_contrib_box_decode", num_inputs=2)
def box_decode(data, anchors, *, std0=0.1, std1=0.1, std2=0.2, std3=0.2,
               clip=-1.0, format="corner"):
    """(B, N, 4) deltas over (1 or B, N, 4) anchors (corner, or center
    with ``format="center"``) -> corner boxes; ``clip`` > 0 caps the
    scaled log-size deltas before the exponential."""
    if format == "center":
        a_x, a_y = anchors[..., 0], anchors[..., 1]
        a_w, a_h = anchors[..., 2], anchors[..., 3]
    else:
        a_w = anchors[..., 2] - anchors[..., 0]
        a_h = anchors[..., 3] - anchors[..., 1]
        a_x = anchors[..., 0] + a_w * 0.5
        a_y = anchors[..., 1] + a_h * 0.5
    x = data[..., 0] * std0 * a_w + a_x
    y = data[..., 1] * std1 * a_h + a_y
    dw = data[..., 2] * std2
    dh = data[..., 3] * std3
    if clip > 0:
        dw = dw.clamp(max=clip)
        dh = dh.clamp(max=clip)
    w = torch.exp(dw) * a_w * 0.5
    h = torch.exp(dh) * a_h * 0.5
    return torch.stack([x - w, y - h, x + w, y + h], dim=-1)


@register("_contrib_bipartite_matching", num_inputs=1, num_outputs=2)
def bipartite_matching(dist, *, is_ascend=False, threshold=0.5, topk=-1):
    """Greedy bipartite matching of a (B, N, M) score matrix, best pair
    first (the first of equal ones), until the best fails ``threshold``
    -> (row_match (B, N), col_match (B, M)), -1 where unmatched, as
    float32.  min(N, M) rounds (``topk`` fewer), each one reduction over
    the matrix."""
    b, n, m = dist.shape
    sign = 1.0 if is_ascend else -1.0
    rounds = min(n, m) if topk <= 0 else min(topk, n, m)
    d = dist.to(torch.float32)
    dev = d.device
    rmatch = torch.full((b, n), -1.0, device=dev)
    cmatch = torch.full((b, m), -1.0, device=dev)
    bi = torch.arange(b, device=dev)
    rows = torch.arange(n, device=dev)[None, :, None]
    cols = torch.arange(m, device=dev)[None, None, :]
    for _ in range(rounds):
        flat = d.reshape(b, n * m)
        best = flat.argmin(dim=1) if is_ascend else flat.argmax(dim=1)
        val = flat[bi, best]
        ok = (val <= threshold) if is_ascend else (val >= threshold)
        r, c = best // m, best % m
        rmatch[bi, r] = torch.where(ok & (rmatch[bi, r] < 0), c.float(),
                                    rmatch[bi, r])
        cmatch[bi, c] = torch.where(ok & (cmatch[bi, c] < 0), r.float(),
                                    cmatch[bi, c])
        burn = ok[:, None, None] & ((rows == r[:, None, None])
                                    | (cols == c[:, None, None]))
        d = torch.where(burn, sign * 1e30, d)
    return rmatch, cmatch


# -- R-FCN and Faster R-CNN (reference psroi_pooling.cc, multi_proposal.cc) --


@register("_contrib_PSROIPooling", num_inputs=2)
def psroi_pooling(data, rois, *, spatial_scale=1.0, output_dim=0,
                  pooled_size=7, group_size=0):
    """Position-sensitive ROI pooling: ``data`` (N, k k od, H, W), rois
    (R, 5) [batch index, x1, y1, x2, y2] (rounded, then scaled) -> (R,
    od, k, k), bin (i, j) the mean over its pixels of channel group
    ``(c k + i) k + j``."""
    k = int(pooled_size)
    gs = int(group_size) if group_size else k
    if gs != k:
        raise NotImplementedError("PSROIPooling: group_size != pooled_size")
    n, ctot, h, w = data.shape
    od = int(output_dim) if output_dim else ctot // (k * k)
    rois = rois.to(torch.float32)
    dev = data.device
    x1, y1, x2, y2 = (torch.round(rois[:, i]) * spatial_scale
                      for i in range(1, 5))
    bin_w = torch.clamp(x2 - x1, min=0.1) / k
    bin_h = torch.clamp(y2 - y1, min=0.1) / k
    step = torch.arange(k, dtype=torch.float32, device=dev)
    y_lo = torch.floor(y1[:, None] + step * bin_h[:, None])
    y_hi = torch.ceil(y1[:, None] + (step + 1) * bin_h[:, None])
    x_lo = torch.floor(x1[:, None] + step * bin_w[:, None])
    x_hi = torch.ceil(x1[:, None] + (step + 1) * bin_w[:, None])
    ys = torch.arange(h, dtype=torch.float32, device=dev) + 0.5
    xs = torch.arange(w, dtype=torch.float32, device=dev) + 0.5
    my = ((ys >= y_lo[..., None]) & (ys < y_hi[..., None])).to(data.dtype)
    mx = ((xs >= x_lo[..., None]) & (xs < x_hi[..., None])).to(data.dtype)
    denom = torch.clamp(my.sum(-1)[:, :, None] * mx.sum(-1)[:, None, :],
                        min=1.0)                              # (R, k, k)
    bidx = rois[:, 0].long()
    out = None
    for i in range(n):
        img = data[i].reshape(od, k, k, h, w)
        part = torch.einsum("cijyx,riy,rjx->rcij", img, my, mx)
        part = torch.where((bidx == i)[:, None, None, None], part, 0.0)
        out = part if out is None else out + part
    return out / denom[:, None]


@register("_contrib_MultiProposal", num_inputs=3, num_outputs=2)
def multi_proposal(cls_prob, bbox_pred, im_info, *, rpn_pre_nms_top_n=6000,
                   rpn_post_nms_top_n=300, threshold=0.7, rpn_min_size=16,
                   scales=(4, 8, 16, 32), ratios=(0.5, 1, 2),
                   feature_stride=16, output_score=False, iou_loss=False):
    """RPN proposals: cls_prob (B, 2A, H, W) (background first, then
    foreground), bbox_pred (B, 4A, H, W), im_info (B, 3) [height, width,
    scale] -> (proposals (B post_nms, 5) [batch index, x1, y1, x2, y2],
    scores (B post_nms, 1)).  The reference's base anchors, the
    Faster R-CNN decode clipped to the image, the min-size filter, the
    pre-NMS top ``rpn_pre_nms_top_n``, :func:`box_nms` at ``threshold``,
    the survivors compacted to the front, and an image with fewer than
    ``rpn_post_nms_top_n`` padded by its top proposal (the whole image
    at score 0 when none survives).  ``iou_loss`` raises, as in the JAX
    package."""
    if iou_loss:
        raise NotImplementedError(
            "MultiProposal: iou_loss=True (IoUTransformInv decode) "
            "is not implemented")
    b, c2, h, w = cls_prob.shape
    a = c2 // 2
    dev = cls_prob.device
    base = float(feature_stride)
    w0 = h0 = base
    xc = yc = 0.5 * (base - 1)
    rows = []
    for r in ratios:
        ws = float(np.round(np.sqrt(w0 * h0 / r)))
        hs = float(np.round(ws * r))
        for s in scales:
            rows.append([xc - 0.5 * (ws * s - 1), yc - 0.5 * (hs * s - 1),
                         xc + 0.5 * (ws * s - 1), yc + 0.5 * (hs * s - 1)])
    shift_x = torch.arange(w, dtype=torch.float32, device=dev) \
        * feature_stride
    shift_y = torch.arange(h, dtype=torch.float32, device=dev) \
        * feature_stride
    sy, sx = torch.meshgrid(shift_y, shift_x, indexing="ij")
    shifts = torch.stack([sx, sy, sx, sy], dim=-1)             # (H, W, 4)
    # the base anchors as float32 scalars (no upload)
    anchors = torch.stack(
        [torch.stack([shifts[..., j] + float(np.float32(row[j]))
                      for j in range(4)], dim=-1) for row in rows],
        dim=2).reshape(-1, 4)
    fg = cls_prob[:, a:].permute(0, 2, 3, 1).reshape(b, -1)
    deltas = bbox_pred.permute(0, 2, 3, 1).reshape(b, -1, 4)
    aw = anchors[:, 2] - anchors[:, 0] + 1.0
    ah = anchors[:, 3] - anchors[:, 1] + 1.0
    ax = anchors[:, 0] + aw * 0.5
    ay = anchors[:, 1] + ah * 0.5
    px = deltas[..., 0] * aw + ax
    py = deltas[..., 1] * ah + ay
    pw = torch.exp(deltas[..., 2].clamp(max=10.0)) * aw
    ph = torch.exp(deltas[..., 3].clamp(max=10.0)) * ah
    imh = im_info[:, 0:1]
    imw = im_info[:, 1:2]
    zero = torch.zeros_like(imw)
    x1 = torch.clamp(px - 0.5 * (pw - 1), zero, imw - 1)
    y1 = torch.clamp(py - 0.5 * (ph - 1), zero, imh - 1)
    x2 = torch.clamp(px + 0.5 * (pw - 1), zero, imw - 1)
    y2 = torch.clamp(py + 0.5 * (ph - 1), zero, imh - 1)
    min_size = rpn_min_size * im_info[:, 2:3]
    keep = (x2 - x1 + 1 >= min_size) & (y2 - y1 + 1 >= min_size)
    scores = torch.where(keep, fg, -1.0)
    n_all = scores.shape[1]
    n_pre = n_all if int(rpn_pre_nms_top_n) <= 0 \
        else min(int(rpn_pre_nms_top_n), n_all)
    n_post = n_pre if int(rpn_post_nms_top_n) <= 0 \
        else int(rpn_post_nms_top_n)
    order = torch.argsort(-scores, dim=1, stable=True)[:, :n_pre]
    cand = torch.stack([torch.gather(v, 1, order)
                        for v in (scores, x1, y1, x2, y2)], dim=-1)
    kept = box_nms(cand, overlap_thresh=threshold, valid_thresh=0.0,
                   topk=-1, coord_start=1, score_index=0, id_index=-1,
                   force_suppress=True)
    valid = kept[:, :, 0] > 0
    comp = torch.argsort((~valid).to(torch.uint8), dim=1, stable=True)
    kept = torch.gather(kept, 1, comp[..., None].expand(kept.shape))
    valid = torch.gather(valid, 1, comp)
    if kept.shape[1] < n_post:
        pad = n_post - kept.shape[1]
        kept = torch.cat([kept, kept[:, :1].expand(b, pad, 5)], dim=1)
        valid = torch.cat([valid, valid.new_zeros((b, pad))], dim=1)
    sel = kept[:, :n_post]
    valid = valid[:, :n_post]
    zeros = torch.zeros((b,), dtype=sel.dtype, device=dev)
    whole = torch.stack([zeros, zeros, zeros, imw[:, 0] - 1, imh[:, 0] - 1],
                        dim=-1)[:, None].to(sel.dtype)
    fill = torch.where(valid.any(dim=1)[:, None, None], sel[:, :1], whole)
    sel = torch.where(valid[..., None], sel, fill)
    bcol = torch.arange(b, dtype=sel.dtype, device=dev)[:, None, None] \
        .expand(b, n_post, 1)
    proposals = torch.cat([bcol, sel[:, :, 1:5]], dim=-1).reshape(
        b * n_post, 5)
    out_scores = sel[:, :, 0:1].clamp(min=0.0).reshape(b * n_post, 1)
    return proposals, out_scores


@register("_contrib_Proposal", num_inputs=3)
def proposal(cls_prob, bbox_pred, im_info, *, rpn_pre_nms_top_n=6000,
             rpn_post_nms_top_n=300, threshold=0.7, rpn_min_size=16,
             scales=(4, 8, 16, 32), ratios=(0.5, 1, 2), feature_stride=16,
             output_score=False, iou_loss=False):
    """:func:`multi_proposal`'s proposals alone; ``output_score`` raises
    (MultiProposal's second output has them), as in the JAX package."""
    if output_score:
        raise NotImplementedError(
            "Proposal: output_score=True — use MultiProposal, whose "
            "scores output is always available")
    props, _ = multi_proposal(
        cls_prob, bbox_pred, im_info, rpn_pre_nms_top_n=rpn_pre_nms_top_n,
        rpn_post_nms_top_n=rpn_post_nms_top_n, threshold=threshold,
        rpn_min_size=rpn_min_size, scales=scales, ratios=ratios,
        feature_stride=feature_stride, iou_loss=iou_loss)
    return props
