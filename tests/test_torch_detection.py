"""The detection group (all of the JAX package's ``ops/det.py``) and
``models/ssd.py`` against the JAX package on the CPU.

The ops run through ``mxnet_tpu.nd`` and ``mxnet_tpu_torch.nd`` on the
same seeded numpy inputs (``torch_parity.check``: values, dtypes and the
gradients of the floating inputs to rtol 1e-5 / atol 1e-6).  The
selections are held exactly: ``box_nms``'s kept rows (with ``topk``,
``id_index``, ``force_suppress``, tied scores and a batch),
``bipartite_matching``, ``MultiBoxTarget``'s class targets and masks
(padding rows, two ground truths claiming one anchor, hard negatives),
``MultiBoxDetection``'s kept rows and ``MultiProposal``'s scores.  The
random boxes are drawn so that no IoU lies within 1e-4 of a threshold
the op compares it with.  ``ssd_tiny``'s training is held in
``test_torch_ssd.py``.
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import nd
from mxnet_tpu_torch.ops import det

import torch_parity

CPU = mx.cpu()


def _iou_np(a, b):
    """IoU matrix of corner boxes (float64)."""
    a, b = a.astype("f8"), b.astype("f8")
    ix = np.clip(np.minimum(a[:, None, 2], b[None, :, 2])
                 - np.maximum(a[:, None, 0], b[None, :, 0]), 0, None)
    iy = np.clip(np.minimum(a[:, None, 3], b[None, :, 3])
                 - np.maximum(a[:, None, 1], b[None, :, 1]), 0, None)
    inter = ix * iy
    area = lambda c: np.clip(c[:, 2] - c[:, 0], 0, None) \
        * np.clip(c[:, 3] - c[:, 1], 0, None)
    union = area(a)[:, None] + area(b)[None, :] - inter
    return np.where(union > 0, inter / np.where(union > 0, union, 1), 0)


def _boxes(rng, n, lo=0.05, hi=0.4):
    xy = rng.uniform(0.0, 0.7, (n, 2))
    wh = rng.uniform(lo, hi, (n, 2))
    return np.concatenate([xy, xy + wh], 1).astype("f4")


def clear_boxes(seed, n, thresholds, other=None, **kw):
    """``n`` seeded random boxes (the first seed from ``seed`` on) with
    no IoU among them (or against ``other``) within 1e-4 of a
    threshold."""
    for s in range(seed, seed + 1000):
        b = _boxes(np.random.RandomState(s), n, **kw)
        iou = _iou_np(b, b if other is None else other)
        if all(np.abs(iou - t).min() > 1e-4 for t in thresholds):
            return b
    raise AssertionError("no clear draw")


def nms_rows(seed, b, n, classes=3, thresholds=(0.5,)):
    """(b, n, 6) rows [id, score, x1, y1, x2, y2]."""
    rng = np.random.RandomState(seed)
    out = np.zeros((b, n, 6), "f4")
    for i in range(b):
        out[i, :, 2:] = clear_boxes(seed * 100 + i, n, thresholds,
                                    lo=0.15, hi=0.45)
        out[i, :, 0] = rng.randint(0, classes, n)
        out[i, :, 1] = rng.uniform(-0.2, 1.0, n).round(2)   # ties, invalids
    return out


ROWS = nms_rows(1, 2, 24)
ROWS_ONE = nms_rows(2, 1, 30)[0]
ANCHORS = clear_boxes(3, 40, (0.5, 0.3), other=None)[None]
GT = np.full((2, 4, 5), -1.0, "f4")
for _i, _k in enumerate((3, 2)):
    GT[_i, :_k, 1:] = clear_boxes(7 + _i, _k, (0.5, 0.3), other=ANCHORS[0])
    GT[_i, :_k, 0] = np.arange(_k) % 2
GT[1, 2:] = -1.0
CLS_PREDS = np.random.RandomState(4).randn(2, 3, 40).astype("f4")
PRIOR_IN = np.zeros((1, 3, 4, 6), "f4")
LOCS = (0.3 * np.random.RandomState(5).randn(2, 160)).astype("f4")
PROBS = np.random.RandomState(6).dirichlet(np.ones(3), (2, 40)) \
    .transpose(0, 2, 1).astype("f4")
RNG = np.random.RandomState(15)
FEAT = RNG.randn(2, 3, 8, 8).astype("f4")
ROIS = np.array([[0, 1.0, 1.5, 6.2, 5.0], [1, 0.3, 2.0, 7.5, 7.9],
                 [1, 2.0, 2.0, 2.5, 2.6]], "f4")
PS_FEAT = RNG.randn(2, 2 * 9, 8, 8).astype("f4")
ENC_ANCHORS = np.stack([RNG.uniform(0.0, 0.4, (2, 6)),
                        RNG.uniform(0.0, 0.4, (2, 6)),
                        RNG.uniform(0.5, 0.9, (2, 6)),
                        RNG.uniform(0.5, 0.9, (2, 6))], -1).astype("f4")
ENC_REFS = (ENC_ANCHORS[:, :3] + 0.05).astype("f4")
ENC_MATCH = np.array([[0, 1, 2, 0, -1, 2], [2, 2, 1, 0, 1, -1]], "f4")
ENC_SAMPLES = np.array([[1, 1, 0, 1, -1, 1], [1, 0, 1, 1, 1, 0]], "f4")
RPN_CLS = RNG.uniform(0.0, 1.0, (2, 2 * 3, 5, 6)).astype("f4")
RPN_BOX = (0.2 * RNG.randn(2, 4 * 3, 5, 6)).astype("f4")
IM_INFO = np.array([[80.0, 96.0, 1.0], [72.0, 90.0, 1.5]], "f4")

DET = {
    "_contrib_box_iou": (lambda F, a, b: F.contrib.box_iou(a, b),
                         [ANCHORS[0][:6], GT[0, :3, 1:]]),
    "_contrib_box_iou_center": (lambda F, a, b: F.contrib.box_iou(
        a, b, format="center"),
        [(ANCHORS[0][:5] * [1, 1, .3, .3]).astype("f4"),
         (ANCHORS[0][5:9] * [1, 1, .3, .3]).astype("f4")]),
    "_contrib_box_nms": (lambda F, d: F.contrib.box_nms(
        d, overlap_thresh=0.5, coord_start=2, score_index=1, id_index=0),
        [ROWS]),
    "_contrib_box_nms_topk_force": (lambda F, d: F.contrib.box_nms(
        d, overlap_thresh=0.5, topk=7, coord_start=2, score_index=1,
        id_index=0, force_suppress=True, valid_thresh=0.1), [ROWS]),
    "_contrib_ROIAlign": (lambda F, x, r: F.contrib.ROIAlign(
        x, r, pooled_size=(3, 2), spatial_scale=0.9), [FEAT, ROIS]),
    "_contrib_ROIAlign_sampled": (lambda F, x, r: F.contrib.ROIAlign(
        x, r, pooled_size=2, sample_ratio=3), [FEAT, ROIS]),
    "_contrib_MultiBoxPrior": (lambda F, x: F.contrib.MultiBoxPrior(
        x, sizes=(0.5, 0.25), ratios=(1.0, 2.0)), [PRIOR_IN]),
    "_contrib_MultiBoxPrior_steps": (lambda F, x: F.contrib.MultiBoxPrior(
        x, sizes=(0.1, 0.141), ratios=(1, 2, 0.5, 3, 1.0 / 3),
        steps=(8 / 300, 8 / 300), offsets=(0.5, 0.5), clip=True),
        [PRIOR_IN]),
    "_contrib_MultiBoxTarget": (lambda F, a, l, c: F.contrib.MultiBoxTarget(
        a, l, c), [ANCHORS, GT, CLS_PREDS]),
    "_contrib_MultiBoxTarget_mining": (
        lambda F, a, l, c: F.contrib.MultiBoxTarget(
            a, l, c, negative_mining_ratio=3.0, negative_mining_thresh=0.3,
            minimum_negative_samples=2, ignore_label=-1.0),
        [ANCHORS, GT, CLS_PREDS]),
    "_contrib_MultiBoxDetection": (
        lambda F, p, l, a: F.contrib.MultiBoxDetection(
            p, l, a, nms_threshold=0.45, threshold=0.3), [PROBS, LOCS,
                                                           ANCHORS]),
    "_contrib_MultiBoxDetection_topk": (
        lambda F, p, l, a: F.contrib.MultiBoxDetection(
            p, l, a, nms_threshold=0.45, nms_topk=9, force_suppress=True,
            clip=False), [PROBS, LOCS, ANCHORS]),
    "_contrib_box_encode": (lambda F, s, m, a, r: F.contrib.box_encode(
        s, m, a, r), [ENC_SAMPLES, ENC_MATCH, ENC_ANCHORS, ENC_REFS]),
    "_contrib_box_decode": (lambda F, d, a: F.contrib.box_decode(d, a),
                            [LOCS.reshape(2, 40, 4)[:, :6], ENC_ANCHORS]),
    "_contrib_box_decode_center_clip": (
        lambda F, d, a: F.contrib.box_decode(d, a, clip=0.4,
                                             format="center"),
        [4 * LOCS.reshape(2, 40, 4)[:, :6], ENC_ANCHORS[:1]]),
    "_contrib_bipartite_matching": (
        lambda F, d: F.contrib.bipartite_matching(d, threshold=0.2),
        [RNG.uniform(0, 1, (2, 5, 3)).astype("f4")]),
    "_contrib_bipartite_matching_ascend": (
        lambda F, d: F.contrib.bipartite_matching(d, is_ascend=True,
                                                  threshold=0.6, topk=2),
        [RNG.uniform(0, 1, (2, 3, 4)).astype("f4")]),
    "_contrib_PSROIPooling": (lambda F, x, r: F.contrib.PSROIPooling(
        x, r, output_dim=2, pooled_size=3, spatial_scale=0.8),
        [PS_FEAT, ROIS]),
    "_contrib_MultiProposal": (lambda F, c, b, i: F.contrib.MultiProposal(
        c, b, i, rpn_pre_nms_top_n=60, rpn_post_nms_top_n=20,
        ratios=(0.5, 1, 2), scales=(1.0,), rpn_min_size=4, threshold=0.6,
        feature_stride=16), [RPN_CLS, RPN_BOX, IM_INFO]),
    "_contrib_Proposal": (lambda F, c, b, i: F.contrib.Proposal(
        c, b, i, rpn_post_nms_top_n=-1, rpn_pre_nms_top_n=-1,
        ratios=(0.5, 1, 2), scales=(1.0,), rpn_min_size=1),
        [RPN_CLS, RPN_BOX, IM_INFO]),
}
# the variants, the matching (no gradient in either package) and the
# proposal ops (their gradient passes argsort's knife edges) compare
# values only; each differentiable op's gradient is held once
VALUE_ONLY = {"_contrib_box_iou_center", "_contrib_box_nms_topk_force",
              "_contrib_ROIAlign_sampled", "_contrib_MultiBoxPrior_steps",
              "_contrib_MultiBoxTarget_mining",
              "_contrib_MultiBoxDetection_topk",
              "_contrib_box_decode_center_clip",
              "_contrib_bipartite_matching",
              "_contrib_bipartite_matching_ascend",
              "_contrib_MultiProposal", "_contrib_Proposal"}
#: every op this file holds against the JAX package (test_torch_ndarray.py
#: test_every_op_has_a_case reads it)
DETECTION_OPS = {"_contrib_box_iou", "_contrib_box_nms", "_contrib_ROIAlign",
                 "box_iou", "box_nms", "ROIAlign", "_contrib_MultiBoxPrior",
                 "_contrib_MultiBoxTarget", "_contrib_MultiBoxDetection",
                 "_contrib_box_encode", "_contrib_box_decode",
                 "_contrib_bipartite_matching", "_contrib_PSROIPooling",
                 "_contrib_MultiProposal", "_contrib_Proposal"}
# selections held exactly: (case, output indices)
EXACT = {"_contrib_box_nms": (0,), "_contrib_box_nms_topk_force": (0,),
         "_contrib_bipartite_matching": (0, 1),
         "_contrib_bipartite_matching_ascend": (0, 1),
         "_contrib_MultiBoxTarget": (1, 2),
         "_contrib_MultiBoxTarget_mining": (1, 2),
         "_contrib_MultiProposal": (1,)}


@pytest.mark.parametrize("case", sorted(DET))
def test_op_matches_jax(case):
    fn, arrays = DET[case]
    # compiled, the JAX package's MultiBoxTarget encodes one offset in 160
    # 7e-5 (relative) away from its eager result, which the port matches
    got = torch_parity.check(fn, arrays, grad=case not in VALUE_ONLY,
                             compiled=not case.startswith(
                                 "_contrib_MultiBoxTarget"))
    if case in EXACT:
        want, _ = torch_parity.run(jmx, fn, [np.asarray(a) for a in arrays],
                                   grad=False)
        for i in EXACT[case]:
            np.testing.assert_array_equal(got[i], want[i])
    if case.startswith("_contrib_MultiBoxDetection"):
        want, _ = torch_parity.run(jmx, fn, arrays, grad=False)
        np.testing.assert_array_equal(got[0][..., :2], want[0][..., :2])


def test_every_case_is_an_op():
    from mxnet_tpu_torch.ops.registry import get_op, list_ops
    assert DETECTION_OPS <= set(list_ops())
    for op in DETECTION_OPS:
        name = get_op(op).name
        assert any(c == name or c.startswith(name + "_") for c in DET), op
    for short in ("box_iou", "box_nms", "ROIAlign"):
        assert get_op(short) is get_op("_contrib_" + short)
        assert getattr(nd.contrib, short) is not None


@pytest.mark.parametrize("ties", [False, True])
def test_box_nms_rows_exactly_as_jax(ties):
    """Kept rows, their order and the -1 rows, bit for bit; with tied
    scores the first row of a tie comes first (a stable sort)."""
    rows = ROWS_ONE.copy()
    if ties:
        rows[:, 1] = np.repeat([0.9, 0.7, 0.4, 0.2, 0.1, -0.3], 5)
    for kw in (dict(id_index=0), dict(id_index=0, topk=11),
               dict(force_suppress=True, id_index=0, valid_thresh=0.3),
               dict(overlap_thresh=0.3)):
        j = jmx.nd.contrib.box_nms(jmx.nd.array(rows), coord_start=2,
                                   score_index=1, **kw).asnumpy()
        t = nd.contrib.box_nms(nd.array(rows, ctx=CPU), coord_start=2,
                               score_index=1, **kw).asnumpy()
        np.testing.assert_array_equal(t, j)


def _greedy_np(rows, thresh):
    order = np.argsort(-rows[:, 1], kind="stable")
    boxes = rows[order, 2:]
    iou = _iou_np(boxes, boxes)
    keep = []
    for j in range(len(rows)):
        if all(iou[i, j] <= thresh for i in keep):
            keep.append(j)
    return order, keep


def test_box_nms_fixed_point_on_a_chain_as_long_as_n():
    """Box i overlaps only its neighbours, scores fall along the chain:
    greedy keeps every other box, and the fixed point needs about one
    pass a box to settle it."""
    n = 40
    x = np.arange(n, dtype="f4") * 0.3
    rows = np.stack([np.zeros(n), np.linspace(1.0, 0.5, n), x,
                     np.zeros(n), x + 1.0, np.ones(n)], 1).astype("f4")
    order, keep = _greedy_np(rows, 0.5)
    assert keep == list(range(0, n, 2))
    t = nd.contrib.box_nms(nd.array(rows, ctx=CPU), overlap_thresh=0.5,
                           coord_start=2, score_index=1).asnumpy()
    want = np.full_like(rows, -1.0)
    want[keep] = rows[order][keep]
    np.testing.assert_array_equal(t, want)
    assert n - 2 <= det.nms_passes[0] <= n + 1, det.nms_passes
    j = jmx.nd.contrib.box_nms(jmx.nd.array(rows), overlap_thresh=0.5,
                               coord_start=2, score_index=1).asnumpy()
    np.testing.assert_array_equal(t, j)


def test_box_nms_center_format_raises():
    with pytest.raises(NotImplementedError, match="center"):
        nd.contrib.box_nms(nd.array(ROWS, ctx=CPU), in_format="center")


def test_multibox_target_forced_claims_as_jax():
    """Padding rows in the middle claim nothing (an index past the
    anchors is dropped, not clamped onto anchor 0), and when two ground
    truths have the same best anchor the later one keeps it (XLA's
    scatter)."""
    anchors = np.array([[[0.0, 0.0, 0.3, 0.3], [0.5, 0.5, 0.8, 0.8],
                         [0.1, 0.6, 0.4, 0.9], [0.6, 0.0, 0.9, 0.2]]], "f4")
    labels = np.array([[[1, 0.52, 0.48, 0.83, 0.79],
                        [-1, 0, 0, 0, 0],
                        [0, 0.55, 0.55, 0.85, 0.85],
                        [2, 0.05, 0.62, 0.38, 0.95]],
                       [[-1, 0, 0, 0, 0], [0, 0.6, 0.05, 0.92, 0.21],
                        [-1, 0, 0, 0, 0], [-1, 0, 0, 0, 0]]], "f4")
    preds = np.random.RandomState(0).randn(2, 4, 4).astype("f4")
    for kw in ({}, dict(overlap_threshold=0.95),
               dict(negative_mining_ratio=1.0, negative_mining_thresh=0.3)):
        j = jmx.nd._contrib_MultiBoxTarget(
            jmx.nd.array(anchors), jmx.nd.array(labels),
            jmx.nd.array(preds), **kw)
        t = nd._contrib_MultiBoxTarget(
            nd.array(anchors, ctx=CPU), nd.array(labels, ctx=CPU),
            nd.array(preds, ctx=CPU), **kw)
        for a, b in zip(j, t):
            np.testing.assert_allclose(b.asnumpy(), a.asnumpy(), rtol=1e-5,
                                       atol=1e-6)
        np.testing.assert_array_equal(t[2].asnumpy(), j[2].asnumpy())
    # the later ground truth (class 0) took anchor 1 from the earlier one
    assert t[2].asnumpy()[0, 1] == 1.0


def test_multibox_target_near_positives_get_ignore_label():
    """The JAX package's case: a quota past the eligible negatives leaves
    the near-positives at ignore_label, never background."""
    anchors = np.asarray([[[0.0, 0.0, 0.4, 0.4], [0.15, 0.0, 0.55, 0.4],
                           [0.2, 0.0, 0.6, 0.4], [0.6, 0.6, 1.0, 1.0]]],
                         "f4")
    labels = np.asarray([[[1.0, 0.0, 0.0, 0.4, 0.4]]], "f4")
    _, _, cls_t = nd._contrib_MultiBoxTarget(
        nd.array(anchors, ctx=CPU), nd.array(labels, ctx=CPU),
        nd.zeros((1, 3, 4), ctx=CPU), negative_mining_ratio=3.0,
        negative_mining_thresh=0.3)
    np.testing.assert_array_equal(cls_t.asnumpy()[0], [2, -1, -1, 0])


def test_ssd300_prior_counts_8732_anchors():
    """SSD300's six maps (Liu et al. 2016) through MultiBoxPrior."""
    total = 0
    s = [30, 60, 111, 162, 213, 264, 315]
    for k, (fm, step) in enumerate(zip((38, 19, 10, 5, 3, 1),
                                       (8, 16, 32, 64, 100, 300))):
        ratios = (1, 2, 0.5, 3, 1 / 3) if 1 <= k <= 3 else (1, 2, 0.5)
        a = nd.contrib.MultiBoxPrior(
            nd.zeros((1, 1, fm, fm), ctx=CPU),
            sizes=(s[k] / 300, np.sqrt(s[k] * s[k + 1]) / 300),
            ratios=ratios, steps=(step / 300, step / 300))
        total += a.shape[1]
    assert total == 8732
