"""The registry's first group of ops (ordering, sequence, triangle,
cumulative, gather/scatter, creation, ``_cache_update`` and the
``_contrib_`` ops) against the JAX package's, op by op.

Each case runs one callable through ``mxnet_tpu.nd`` and
``mxnet_tpu_torch.nd`` on the same seeded numpy inputs on the CPU
(``torch_parity.check``): the outputs, their dtypes and the gradients of
every floating input agree to rtol 1e-5 / atol 1e-6 (1e-4 where the two
CPU libraries differ in the last bits of a transcendental function).
Then the cases the reference's numerics single out: the order among
equal elements of ``topk``, ``sort`` and ``argsort``, the clamped
offsets of ``_cache_update``, repeated indices, a zero in ``cumprod``
and ``log_sum_exp`` over a row of -inf.
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, nd

import torch_parity

CPU = mx.cpu()
RNG = np.random.RandomState(14)


def _n(*shape):
    return RNG.randn(*shape).astype("f4")


A = _n(3, 5)
B3 = _n(2, 3, 4)
TIES = np.array([[1, 3, 3, 2, 3, 1], [2, 2, 0, 2, 5, 5]], "f4")
GROUP1 = {
    "topk": (lambda F, a: F.topk(a, k=3, ret_typ="both"), [A]),
    "topk_value_axis0": (lambda F, a: F.topk(a, axis=0, k=2,
                                             ret_typ="value"), [A]),
    "topk_ascend_indices": (lambda F, a: F.topk(a, k=2, is_ascend=True,
                                                dtype="int32"), [A]),
    "sort": (lambda F, a: F.sort(a), [A]),
    "sort_descend_axis0": (lambda F, a: F.sort(a, axis=0, is_ascend=False),
                           [A]),
    "argsort": (lambda F, a: F.argsort(a), [A]),
    "argsort_descend": (lambda F, a: F.argsort(a, is_ascend=False,
                                               dtype="int32"), [A]),
    "SequenceLast": (lambda F, a, n: F.SequenceLast(
        a, n, use_sequence_length=True), [B3, np.array([1, 0, 2], "f4")]),
    "SequenceLast_axis1": (lambda F, a, n: F.SequenceLast(
        a, n, use_sequence_length=True, axis=1),
        [B3, np.array([3, 1], "f4")]),
    "SequenceLast_nolen": (lambda F, a: F.SequenceLast(a), [B3]),
    "reverse": (lambda F, a: F.reverse(a, axis=1), [B3]),
    "flip": (lambda F, a: F.flip(a, axis=(0, 2)), [B3]),
    "roll": (lambda F, a: F.roll(a, shift=2, axis=1), [A]),
    "roll_flat": (lambda F, a: F.roll(a, shift=-3), [A]),
    "tril": (lambda F, a: F.tril(a, k=1), [A]),
    "triu": (lambda F, a: F.triu(a, k=-1), [B3]),
    "diag": (lambda F, a: F.diag(a, k=1), [A]),
    "diag_vector": (lambda F, a: F.diag(a, k=-1), [_n(4)]),
    "diag_batched": (lambda F, a: F.diag(a), [B3]),
    "trace": (lambda F, a: F.trace(a, offset=1), [A]),
    "trace_axes": (lambda F, a: F.trace(a, axis1=1, axis2=2), [B3]),
    "cumsum": (lambda F, a: F.cumsum(a, axis=1), [A]),
    "cumsum_flat": (lambda F, a: F.cumsum(a), [A]),
    "cumsum_int": (lambda F, a: F.cumsum(a, axis=0),
                   [np.arange(6, dtype="int32").reshape(2, 3)]),
    "cumprod": (lambda F, a: F.cumprod(a, axis=0), [A]),
    "cumprod_zero": (lambda F, a: F.cumprod(a, axis=1),
                     [np.array([[1.5, 0.0, 2.0, -3.0],
                                [0.5, 2.0, 0.0, 0.0]], "f4")]),
    "cumprod_dtype": (lambda F, a: F.cumprod(a, dtype="float16"), [A]),
    "square_sum": (lambda F, a: F.square_sum(a, axis=1, keepdims=True),
                   [B3]),
    "square_sum_exclude": (lambda F, a: F.square_sum(a, axis=1,
                                                     exclude=True), [B3]),
    "log_sum_exp": (lambda F, a: F.log_sum_exp(a, axis=(0, 2)), [B3]),
    "log_sum_exp_all": (lambda F, a: F.log_sum_exp(a), [A]),
    "gather_nd": (lambda F, a, i: F.gather_nd(a, i),
                  [B3, np.array([[1, 0, 1, -1], [2, 2, 0, 1]], "f4")]),
    "gather_nd_clamped": (lambda F, a, i: F.gather_nd(a, i),
                          [A, np.array([[1, 5, -1], [0, 7, -1]], "f4")]),
    "gather_nd_raw": (lambda F, a, i: F.gather_nd_raw(a, i),
                      [A, np.array([[0, 2, 2]], "f4")]),
    "scatter_nd": (lambda F, d, i: F.scatter_nd(d, i, shape=(3, 3, 2)),
                   [_n(3, 2), np.array([[0, 1, 2], [2, 0, 1]], "f4")]),
    "scatter_nd_repeated": (
        lambda F, d, i: F.scatter_nd(d, i, shape=(3, 3)),
        [_n(5), np.array([[0, 1, 0, 2, 0], [1, 0, 1, 2, 1]], "f4")]),
    "batch_take": (lambda F, a, i: F.batch_take(a, i),
                   [A, np.array([0, 4, -1], "f4")]),
    "slice_like": (lambda F, a, b: F.slice_like(a, b), [B3, _n(1, 2, 3)]),
    "slice_like_axes": (lambda F, a, b: F.slice_like(a, b, axes=(2,)),
                        [B3, _n(5, 5, 2)]),
    "argmax_channel": (lambda F, a: F.argmax_channel(a), [B3]),
    "ravel_multi_index": (
        lambda F, c: F.ravel_multi_index(c, shape=(3, 4)),
        [np.array([[0, 1, 2], [3, 0, 1]], "f4")]),
    "unravel_index": (lambda F, c: F.unravel_index(c, shape=(3, 4)),
                      [np.array([0, 5, 11, 12, -1, -2, 40], "f4")]),
    "hard_sigmoid": (lambda F, a: F.hard_sigmoid(a, alpha=0.3, beta=0.4),
                     [A]),
    "smooth_l1": (lambda F, a: F.smooth_l1(a, scalar=2.0), [A]),
    "softmin": (lambda F, a: F.softmin(a, axis=0), [A]),
    "SoftmaxActivation": (lambda F, a: F.SoftmaxActivation(a), [B3]),
    "SoftmaxActivation_channel": (
        lambda F, a: F.SoftmaxActivation(a, mode="channel"), [B3]),
    "_cache_update": (lambda F, c, n: F._cache_update(c, n, offset=1),
                      [_n(2, 5, 3), _n(2, 2, 3)]),
    "_cache_update_rows": (lambda F, c, n, o: F._cache_update(c, n,
                                                              offset=o),
                           [_n(3, 5, 2), _n(3, 2, 2),
                            np.array([0, 4, -2], "f4")]),
    "_contrib_arange_like": (lambda F, a: F.contrib.arange_like(
        a, start=1.5, step=0.5, repeat=2), [B3]),
    "_contrib_arange_like_axis": (lambda F, a: F.contrib.arange_like(
        a, axis=2), [B3]),
    "_contrib_index_array": (lambda F, a: F.contrib.index_array(a), [B3]),
    "_contrib_index_array_axes": (
        lambda F, a: F.contrib.index_array(a, axes=(2, 0)), [B3]),
    "_contrib_index_copy": (lambda F, o, i, n: F.contrib.index_copy(o, i, n),
                            [A, np.array([2, 0], "f4"), _n(2, 5)]),
}
# digamma's last bits differ between XLA and PyTorch
DIGAMMA_X = RNG.uniform(0.3, 4.0, (3, 4)).astype("f4")
CREATION = {
    "linspace": lambda F: F.linspace(start=-1.0, stop=2.0, num=7,
                                     ctx=F_ctx(F)),
    "linspace_open": lambda F: F.linspace(0.0, 1.0, 5, False, ctx=F_ctx(F)),
    "logspace": lambda F: F.logspace(start=0.0, stop=2.0, num=5,
                                     ctx=F_ctx(F)),
    "logspace_base2": lambda F: F.logspace(start=1.0, stop=4.0, num=4,
                                           endpoint=False, base=2.0,
                                           ctx=F_ctx(F)),
}
#: every op this file holds against the JAX package (test_torch_ndarray.py
#: test_every_op_has_a_case reads it)
REGISTRY_OPS = {"topk", "sort", "argsort", "SequenceLast", "reverse",
                "flip", "roll", "tril", "triu", "diag", "trace", "cumsum",
                "cumprod", "square_sum", "log_sum_exp", "gather_nd",
                "gather_nd_raw", "scatter_nd", "batch_take", "slice_like",
                "argmax_channel", "ravel_multi_index", "unravel_index",
                "hard_sigmoid", "smooth_l1", "softmin", "SoftmaxActivation",
                "_cache_update", "_contrib_arange_like",
                "_contrib_index_array", "_contrib_index_copy", "digamma",
                "linspace", "logspace"}


def F_ctx(F):
    return jmx.cpu() if F is jmx.nd else CPU


@pytest.mark.parametrize("case", sorted(GROUP1))
def test_op_matches_jax(case):
    fn, arrays = GROUP1[case]
    torch_parity.check(fn, arrays)


def test_digamma_matches_jax():
    torch_parity.check(lambda F, a: F.digamma(a), [DIGAMMA_X], rtol=1e-4,
                       atol=1e-5)


@pytest.mark.parametrize("case", sorted(CREATION))
def test_creation_matches_jax(case):
    j = CREATION[case](jmx.nd).asnumpy()
    t = CREATION[case](nd).asnumpy()
    assert j.dtype == t.dtype and j.shape == t.shape
    np.testing.assert_allclose(t, j, rtol=1e-6, atol=1e-6)


def test_every_case_is_an_op():
    """The names above are the ops (and nothing but ops) of the group."""
    from mxnet_tpu_torch.ops.registry import list_ops
    assert REGISTRY_OPS <= set(list_ops())
    named = {c.split("_nolen")[0] for c in GROUP1}
    for op in REGISTRY_OPS - {"digamma", "linspace", "logspace"}:
        assert any(c == op or c.startswith(op + "_") for c in named), op


# -- order among equal elements -----------------------------------------------------


@pytest.mark.parametrize("kw", [dict(k=4), dict(k=4, is_ascend=True),
                                dict(k=6, axis=-1), dict(k=2, axis=0)])
def test_topk_tie_order(kw):
    """lax.top_k's order: the lower index first among equal values."""
    j = jmx.nd.topk(jmx.nd.array(TIES), ret_typ="both", **kw)
    t = nd.topk(nd.array(TIES, ctx=CPU), ret_typ="both", **kw)
    assert isinstance(t, list) and len(t) == 2
    for a, b in zip(j, t):
        np.testing.assert_array_equal(b.asnumpy(), a.asnumpy())
    if kw.get("axis", -1) == -1 and not kw.get("is_ascend"):
        np.testing.assert_array_equal(t[1].asnumpy()[0, :4], [1, 2, 4, 3])


@pytest.mark.parametrize("is_ascend", [True, False])
@pytest.mark.parametrize("axis", [0, -1])
def test_sort_argsort_tie_order(is_ascend, axis):
    """Descending is the stable ascending order flipped: the higher
    index first among equal values (the value's gradient goes there)."""
    for op in ("sort", "argsort"):
        torch_parity.check(
            lambda F, a: getattr(F, op)(a, axis=axis, is_ascend=is_ascend),
            [TIES])
    got = nd.argsort(nd.array(TIES[0], ctx=CPU), is_ascend=False)
    if not is_ascend:
        np.testing.assert_array_equal(got.asnumpy(), [4, 2, 1, 3, 5, 0])


# -- _cache_update's clamped offsets and its in-place write ---------------------------


@pytest.mark.parametrize("offset", [0, 3, 4, 7, -1, -3, -6,
                                    np.array(3, "f4"), np.array(9, "f4"),
                                    np.array([4, -6, 1], "f4"),
                                    np.array([-1, 20, 2], "f4")])
def test_cache_update_clamps_as_dynamic_update_slice(offset):
    """The last position, past it, and below 0; a scalar, a 0-d and a
    (B,) offset: negative counts from the end, then the start clamps so
    the two new rows fit."""
    cache, new = _n(3, 5, 2), _n(3, 2, 2)

    def fn(F, c, n, *rest):
        off = rest[0] if rest else offset
        return F._cache_update(c, n, offset=off)
    arrays = [cache, new] + ([offset] if isinstance(offset, np.ndarray)
                             else [])
    torch_parity.check(fn, arrays)


def test_cache_update_in_place_and_cast():
    """``out=cache`` writes the cache's own storage (the decode step's
    call), ``new`` cast to the cache's type; without ``out`` the cache
    stays as it was."""
    cache = nd.zeros((2, 6, 1), ctx=CPU, dtype="float16")
    ptr = cache._t.data_ptr()
    new = nd.array(np.full((2, 1, 1), 1.25, "f4"), ctx=CPU)
    fresh = nd._cache_update(cache, new, offset=5)
    assert fresh.dtype == np.float16 and not cache.asnumpy().any()
    assert nd._cache_update(cache, new, 2, out=cache) is cache
    assert cache._t.data_ptr() == ptr
    np.testing.assert_array_equal(cache.asnumpy()[:, :, 0],
                                  [[0, 0, 1.25, 0, 0, 0]] * 2)
    off = nd.array(np.array([0, 9], "f4"), ctx=CPU)
    nd._cache_update(cache, new, offset=off, out=cache)
    np.testing.assert_array_equal(cache.asnumpy()[:, :, 0],
                                  [[1.25, 0, 1.25, 0, 0, 0],
                                   [0, 0, 1.25, 0, 0, 1.25]])


# -- gradients the reference's numerics single out --------------------------------------


def test_log_sum_exp_minus_inf_row():
    """A row of -inf: -inf, and a NaN gradient on it, as JAX's."""
    x = np.array([[-np.inf, -np.inf, -np.inf], [0.5, -1.0, 2.0]], "f4")
    j, jg = torch_parity.run(jmx, lambda F, a: F.log_sum_exp(a, axis=1), [x])
    t, tg = torch_parity.run(mx, lambda F, a: F.log_sum_exp(a, axis=1), [x])
    np.testing.assert_array_equal(t[0][0], j[0][0])
    np.testing.assert_allclose(t[0][1], j[0][1], rtol=1e-6)
    np.testing.assert_array_equal(np.isnan(tg[0]), np.isnan(jg[0]))
    np.testing.assert_allclose(tg[0][1], jg[0][1], rtol=1e-6)


def test_scatter_nd_repeated_writes_last_and_grads_it():
    """Two items at one coordinate: the last is written and only it
    takes the gradient (JAX's scatter on the CPU)."""
    data = np.array([1.0, 2.0, 3.0, 4.0], "f4")
    idx = np.array([[0, 1, 0, 2], [1, 0, 1, 2]], "f4")

    def fn(F, d, i):
        return F.scatter_nd(d, i, shape=(3, 3))
    out = torch_parity.check(fn, [data, idx])
    assert out[0][0, 1] == 3.0
    _, g = torch_parity.run(mx, fn, [data, idx])
    assert g[0][0] == 0.0 and g[0][2] != 0.0


def test_gather_nd_repeated_indices_sum_gradients():
    a = _n(3, 4)
    idx = np.array([[1, 1, 2, 1], [0, 0, 3, 0]], "f4")
    torch_parity.check(lambda F, x, i: F.gather_nd(x, i), [a, idx])
    _, g = torch_parity.run(mx, lambda F, x, i: F.gather_nd(x, i), [a, idx])
    w = np.linspace(-1.0, 1.0, 4, dtype="f4")
    np.testing.assert_allclose(g[0][1, 0], w[0] + w[1] + w[3], rtol=1e-6)


def test_topk_values_gradient_goes_to_the_picked():
    x = np.array([[0.5, 2.0, 2.0, -1.0, 2.0]], "f4")
    torch_parity.check(lambda F, a: F.topk(a, k=2, ret_typ="value"), [x])


def test_topk_both_returns_two_ndarrays_and_records():
    x = nd.array(A, ctx=CPU)
    x.attach_grad()
    with autograd.record():
        vals, idx = nd.topk(x, k=2, ret_typ="both")
        loss = vals.sum()
    loss.backward()
    assert isinstance(vals, nd.NDArray) and isinstance(idx, nd.NDArray)
    assert idx.dtype == np.float32 and vals.shape == (3, 2)
    assert x.grad.asnumpy().sum() == 6.0


def test_contrib_namespace_resolves_prefixed_ops():
    assert nd.contrib.index_copy is nd._contrib_index_copy
    assert nd.contrib.topk is nd.topk
    from mxnet_tpu_torch.gluon import HybridBlock

    class Ramp(HybridBlock):
        def hybrid_forward(self, F, x):
            return F.contrib.arange_like(x, axis=1) + F.sort(x)

    out = Ramp(prefix="ramp_")(nd.array(TIES, ctx=CPU)).asnumpy()
    np.testing.assert_array_equal(out[0], np.sort(TIES[0]) + np.arange(6))
