"""The registry's last names (the linalg family, ``khatri_rao``, the
interleaved self-attention products, ``_sample_unique_zipfian``,
``SoftmaxOutput`` and ``MakeLoss``) against the JAX package's, op by op.

Each case runs one callable through ``mxnet_tpu.nd`` and
``mxnet_tpu_torch.nd`` on the same seeded numpy inputs on the CPU
(``torch_parity.check``): the outputs, their dtypes and the gradients of
every floating input agree to rtol 1e-5 / atol 1e-6 (1e-4 for the
factorizations, whose two LAPACK builds round differently).  The sampler
is held to its distribution: its range and its log-uniform histogram
within a chi-square bound.
"""
import math

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, nd

import torch_parity

CPU = mx.cpu()
RNG = np.random.RandomState(16)


def _n(*shape):
    return RNG.randn(*shape).astype("f4")


def _spd(n, batch=()):
    a = RNG.randn(*batch, n, n).astype("f8")
    return (a @ np.swapaxes(a, -1, -2) + n * np.eye(n)).astype("f4")


def _lower(n, batch=()):
    a = np.tril(RNG.randn(*batch, n, n)) * 0.3
    idx = np.arange(n)
    a[..., idx, idx] = 1.0 + np.abs(a[..., idx, idx])
    return a.astype("f4")


A34, B45, SPD, L4, QKV = _n(3, 4), _n(4, 5), _spd(4, (2,)), _lower(4), \
    _n(5, 2, 3 * 8)
ATT = np.abs(_n(2 * 2, 5, 5))
LABELS = np.array([0, 2, 1, -1, 3, 2], "f4")
LOGITS = _n(6, 4)

TAIL = {
    "linalg_gemm2": (lambda F, a, b: F.linalg_gemm2(a, b, alpha=0.5),
                     [A34, B45]),
    "linalg_gemm2_transposed": (
        lambda F, a, b: F.linalg_gemm2(a, b, transpose_a=True,
                                       transpose_b=True),
        [_n(2, 4, 3), _n(2, 5, 4)]),
    "linalg_potrf": (lambda F, a: F.linalg_potrf(a), [SPD]),
    "linalg_potri": (lambda F, a: F.linalg_potri(a), [L4]),
    "linalg_syrk": (lambda F, a: F.linalg_syrk(a, alpha=2.0), [A34]),
    "linalg_syrk_transpose": (lambda F, a: F.linalg_syrk(a, transpose=True),
                              [A34]),
    "linalg_trmm": (lambda F, a, b: F.linalg_trmm(a, b, alpha=1.5),
                    [_n(4, 4), _n(4, 3)]),
    "linalg_trmm_right_upper_t": (
        lambda F, a, b: F.linalg_trmm(a, b, rightside=True, lower=False,
                                      transpose=True),
        [_n(4, 4), _n(3, 4)]),
    "linalg_trsm": (lambda F, a, b: F.linalg_trsm(a, b, alpha=2.0),
                    [L4, _n(4, 3)]),
    "linalg_trsm_right_t": (
        lambda F, a, b: F.linalg_trsm(a, b, rightside=True, transpose=True),
        [L4, _n(3, 4)]),
    "linalg_trsm_upper_t": (
        lambda F, a, b: F.linalg_trsm(a, b, lower=False, transpose=True),
        [np.ascontiguousarray(L4.T), _n(4, 2)]),
    "linalg_gelqf": (lambda F, a: F.linalg_gelqf(a), [_n(3, 5)]),
    "linalg_sumlogdiag": (lambda F, a: F.linalg_sumlogdiag(a),
                          [np.abs(_n(2, 3, 3)) + 0.5]),
    "khatri_rao": (lambda F, a, b, c: F.khatri_rao(a, b, c),
                   [_n(2, 3), _n(4, 3), _n(3, 3)]),
    "interleaved_matmul_selfatt_qk": (
        lambda F, x: F.interleaved_matmul_selfatt_qk(x, heads=2), [QKV]),
    "interleaved_matmul_selfatt_valatt": (
        lambda F, x, att: F.interleaved_matmul_selfatt_valatt(x, att,
                                                              heads=2),
        [QKV, ATT]),
    "SoftmaxOutput": (lambda F, d, l: F.SoftmaxOutput(d, l),
                      [LOGITS, np.array([0, 2, 1, 3, 3, 2], "f4")]),
    "SoftmaxOutput_ignore_valid": (
        lambda F, d, l: F.SoftmaxOutput(d, l, use_ignore=True,
                                        normalization="valid",
                                        grad_scale=2.0),
        [LOGITS, LABELS]),
    "SoftmaxOutput_batch_smooth": (
        lambda F, d, l: F.SoftmaxOutput(d, l, normalization="batch",
                                        smooth_alpha=0.1, out_grad=True),
        [LOGITS, np.array([0, 2, 1, 3, 3, 2], "f4")]),
    "SoftmaxOutput_multi_output": (
        lambda F, d, l: F.SoftmaxOutput(d, l, multi_output=True),
        [_n(2, 4, 3), np.array([[0, 3, 1], [2, 2, 0]], "f4")]),
    "MakeLoss": (lambda F, a: F.MakeLoss(a * a, grad_scale=3.0), [A34]),
}

#: the ops this file holds against the JAX package (test_torch_ndarray's
#: test_every_op_has_a_case reads it)
TAIL_OPS = {"linalg_gemm2", "linalg_potrf", "linalg_potri", "linalg_syrk",
            "linalg_trmm", "linalg_trsm", "linalg_gelqf",
            "linalg_sumlogdiag", "khatri_rao",
            "interleaved_matmul_selfatt_qk",
            "interleaved_matmul_selfatt_valatt", "_sample_unique_zipfian",
            "SoftmaxOutput", "MakeLoss"}

_FACTOR = ("linalg_potrf", "linalg_potri", "linalg_gelqf")


@pytest.mark.parametrize("case", sorted(TAIL))
def test_op_matches_jax(case):
    fn, arrays = TAIL[case]
    tol = 1e-4 if case.startswith(_FACTOR) else 1e-5
    # SoftmaxOutput's gradient is the reference's custom one (softmax -
    # label) only when the JAX package runs it eagerly
    torch_parity.check(fn, arrays, rtol=tol, atol=tol / 10,
                       compiled=not case.startswith("SoftmaxOutput"))


def test_every_case_is_an_op():
    from mxnet_tpu_torch.ops.registry import get_op
    names = {c if c in TAIL_OPS else c.rsplit("_", 1)[0] for c in TAIL}
    for case in TAIL:
        assert any(case.startswith(op) for op in TAIL_OPS), case
    for op in TAIL_OPS:
        get_op(op)
    assert names


def test_gelqf_is_an_lq_factorization():
    a = _n(3, 5)
    lq, q = nd.linalg_gelqf(nd.array(a, ctx=CPU))
    lq, q = lq.asnumpy(), q.asnumpy()
    np.testing.assert_allclose(lq @ q, a, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(q @ q.T, np.eye(3), atol=1e-5)
    assert np.allclose(lq, np.tril(lq))


def test_softmax_output_gradient_is_the_cross_entropy_gradient():
    """The backward ignores the head gradient (out_grad=False) and is
    (prob - one_hot) * grad_scale / valid labels."""
    d = nd.array(LOGITS, ctx=CPU)
    d.attach_grad()
    with autograd.record():
        p = nd.SoftmaxOutput(d, nd.array(LABELS, ctx=CPU), use_ignore=True,
                             normalization="valid", grad_scale=2.0)
    p.backward(nd.array(np.full(p.shape, 7.0, "f4"), ctx=CPU))
    prob = np.exp(LOGITS) / np.exp(LOGITS).sum(1, keepdims=True)
    onehot = np.zeros_like(prob)
    keep = LABELS != -1
    onehot[np.arange(6)[keep], LABELS[keep].astype(int)] = 1
    want = (prob - onehot) * keep[:, None] * 2.0 / keep.sum()
    np.testing.assert_allclose(d.grad.asnumpy(), want, rtol=1e-5, atol=1e-6)


def _jax_key():
    """A key array of the JAX package's stream (its samplers take one as
    their first input)."""
    from mxnet_tpu.random import _next_key_nd
    return _next_key_nd(jmx.cpu())


def test_sample_unique_zipfian_is_log_uniform():
    """R8: log-uniform draws without dedup, as the JAX package.  The
    range, the dtype, and the histogram over [e^j - 1, e^(j+1) - 1)
    within a chi-square bound (the 0.999 quantile, 8 degrees of
    freedom: 26.12); the JAX package's draws pass the same test."""
    range_max, n = 3000, 40000
    mx.random.seed(16)
    jmx.random.seed(16)
    draws = {"port": nd._sample_unique_zipfian(range_max=range_max,
                                               shape=(n,), ctx=CPU),
             "jax": jmx.nd._sample_unique_zipfian(
                 _jax_key(), range_max=range_max, shape=(n,))}
    assert draws["port"].dtype == np.int64
    # integer bins [e_j, e_j+1), the last closed at range_max - 1:
    # P(v >= m) = 1 - log(m + 1) / log(range_max)
    edges = np.array([math.ceil(math.exp(j) - 1) for j in range(9)]
                     + [range_max - 1])
    p = np.diff(np.log1p(edges)) / math.log(range_max)
    for name, arr in draws.items():
        v = arr.asnumpy()
        assert v.shape == (n,) and v.min() >= 0 and v.max() < range_max, \
            name
        counts = np.histogram(v, bins=edges)[0]
        chi2 = float(((counts - n * p) ** 2 / (n * p)).sum())
        assert chi2 < 26.12, (name, chi2, counts)
