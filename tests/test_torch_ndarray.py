"""The port's ``mx.nd`` against the JAX package's, op by op.

Every op the port registers has a case here (``test_every_op_has_a_case``
holds that): the same numpy inputs go through ``mxnet_tpu.nd`` and
``mxnet_tpu_torch.nd`` on the CPU; outputs, their dtypes and the input
gradients agree to rtol 1e-5 / atol 1e-6 in float32 (1e-4 for the
transcendental functions whose CPU implementations differ in the last
bits between XLA and PyTorch).  Then the NDArray contract: MXNet's dtype
rules, reshape codes, indexing and views, ``out=``, the sync points.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import nd
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops.registry import get_op, list_ops, validate_opdef

import torch_parity

CPU = mx.cpu()
RNG = np.random.RandomState(0)


def _u(*shape, lo=0.2, hi=0.8):
    return RNG.uniform(lo, hi, shape).astype("f4")


X = _u(3, 4)
Y = _u(1, 4)

# -- elementwise unary: (input domain, rtol) ----------------------------------
UNARY = {
    "abs": (_u(3, 4, lo=-1, hi=1), 1e-5), "sign": (_u(3, 4, lo=-1, hi=1), 0),
    "rint": (_u(3, 4, lo=-3, hi=3), 0), "ceil": (_u(3, 4, lo=-3, hi=3), 0),
    "floor": (_u(3, 4, lo=-3, hi=3), 0), "trunc": (_u(3, 4, lo=-3, hi=3), 0),
    "fix": (_u(3, 4, lo=-3, hi=3), 0), "round": (_u(3, 4, lo=-3, hi=3), 0),
    "square": (X, 1e-5), "sqrt": (X, 1e-5), "rsqrt": (X, 1e-5),
    "cbrt": (_u(3, 4, lo=-1, hi=1), 1e-4), "rcbrt": (X, 1e-4),
    "exp": (X, 1e-5), "log": (X, 1e-5), "log10": (X, 1e-5),
    "log2": (X, 1e-5), "log1p": (X, 1e-5), "expm1": (X, 1e-5),
    "sin": (X, 1e-5), "cos": (X, 1e-5), "tan": (X, 1e-4),
    "arcsin": (X, 1e-5), "arccos": (X, 1e-5), "arctan": (X, 1e-5),
    "sinh": (X, 1e-5), "cosh": (X, 1e-5), "tanh": (X, 1e-5),
    "arcsinh": (X, 1e-5), "arccosh": (X + 1.0, 1e-4),
    "arctanh": (X, 1e-5), "erf": (X, 1e-5), "erfinv": (X, 1e-4),
    "gamma": (X + 0.5, 1e-4), "gammaln": (X + 0.5, 1e-4),
    "negative": (X, 1e-5), "reciprocal": (X, 1e-5),
    "logical_not": (np.array([[0.0, 1.0, 2.0, 0.0]], "f4"), 0),
    "sigmoid": (X, 1e-5), "softsign": (X, 1e-5),
    "relu": (_u(3, 4, lo=-1, hi=1), 1e-5),
    "degrees": (X, 1e-5), "radians": (X, 1e-5),
}


@pytest.mark.parametrize("name", sorted(UNARY))
def test_unary(name):
    x, rtol = UNARY[name]
    torch_parity.check(lambda F, a: getattr(F, name)(a), [x],
                       rtol=rtol or 1e-6)


SCALAR = ["_plus_scalar", "_minus_scalar", "_rminus_scalar", "_mul_scalar",
          "_div_scalar", "_rdiv_scalar", "_mod_scalar", "_rmod_scalar",
          "_power_scalar", "_rpower_scalar", "_maximum_scalar",
          "_minimum_scalar", "_equal_scalar", "_not_equal_scalar",
          "_greater_scalar", "_greater_equal_scalar", "_lesser_scalar",
          "_lesser_equal_scalar"]


@pytest.mark.parametrize("name", SCALAR)
def test_scalar_ops(name):
    x = RNG.uniform(1, 5, (3, 4)).astype("f4")
    s = 0.5 if name in ("_maximum_scalar", "_minimum_scalar") else 2
    torch_parity.check(lambda F, a: getattr(F, name)(a, scalar=s), [x],
                       rtol=1e-6)


@pytest.mark.parametrize("name", ["_plus_scalar", "_rminus_scalar",
                                  "_mul_scalar", "_mod_scalar",
                                  "_power_scalar", "_greater_scalar"])
def test_scalar_ops_keep_an_integer_type(name):
    """MXNet's rule: a Python int keeps an int32 array int32, as the JAX
    package's ``scalar_ref_input`` makes it."""
    x = np.arange(1, 13, dtype="int32").reshape(3, 4)
    out = torch_parity.check(lambda F, a: getattr(F, name)(a, scalar=2),
                             [x])
    assert out[0].dtype == np.int32


BROADCAST = ["broadcast_add", "broadcast_sub", "broadcast_mul",
             "broadcast_div", "broadcast_mod", "broadcast_power",
             "broadcast_maximum", "broadcast_minimum", "broadcast_hypot",
             "broadcast_equal", "broadcast_not_equal", "broadcast_greater",
             "broadcast_greater_equal", "broadcast_lesser",
             "broadcast_lesser_equal", "broadcast_logical_and",
             "broadcast_logical_or", "broadcast_logical_xor",
             "elemwise_add", "elemwise_sub", "elemwise_mul", "elemwise_div"]


@pytest.mark.parametrize("name", BROADCAST)
def test_binary(name):
    b = Y if name.startswith("broadcast") else _u(3, 4)
    if "logical" in name:
        x, b = np.round(X), np.round(b + 0.3)
    else:
        x = X
    torch_parity.check(lambda F, p, q: getattr(F, name)(p, q), [x, b],
                       rtol=1e-5)


REDUCE = [("sum", {}), ("sum", {"axis": 1}), ("sum", {"axis": (0, 2)}),
          ("sum", {"axis": 1, "keepdims": True}),
          ("sum", {"axis": 1, "exclude": True}), ("mean", {"axis": 0}),
          ("prod", {"axis": (0, 1)}), ("max", {"axis": 2}),
          ("min", {}), ("nansum", {"axis": 1}), ("nanprod", {"axis": 2}),
          ("sum_axis", {"axis": 0}), ("norm", {}), ("norm", {"axis": 1}),
          ("norm", {"ord": 1, "axis": 0, "keepdims": True})]


@pytest.mark.parametrize("case", range(len(REDUCE)))
def test_reductions(case):
    name, kw = REDUCE[case]
    x = _u(2, 3, 4, lo=0.5, hi=1.5)
    torch_parity.check(lambda F, a: getattr(F, name)(a, **kw), [x],
                       rtol=1e-5)


@pytest.mark.parametrize("name", ["argmax", "argmin"])
def test_arg_reductions_return_float32(name):
    out = torch_parity.check(lambda F, a: getattr(F, name)(a, axis=1),
                             [_u(3, 5)], grad=False)
    assert out[0].dtype == np.float32


def test_int_reduction_keeps_type():
    x = np.arange(12, dtype="int32").reshape(3, 4)
    out = torch_parity.check(lambda F, a: F.sum(a, axis=1), [x])
    assert out[0].dtype == np.int32


SHAPE = {
    "reshape": (lambda F, a: F.reshape(a, shape=(0, -1)), [_u(2, 3, 4)]),
    "Reshape": (lambda F, a: F.Reshape(a, shape=(-3, 4)), [_u(2, 3, 4)]),
    "transpose": (lambda F, a: F.transpose(a, axes=(1, 0, 2)),
                  [_u(2, 3, 4)]),
    "expand_dims": (lambda F, a: F.expand_dims(a, axis=1), [X]),
    "squeeze": (lambda F, a: F.squeeze(a, axis=1), [_u(3, 1, 4)]),
    "flatten": (lambda F, a: F.flatten(a), [_u(2, 3, 4)]),
    "Flatten": (lambda F, a: F.Flatten(a), [_u(2, 3, 4)]),
    "broadcast_to": (lambda F, a: F.broadcast_to(a, shape=(3, 0)), [Y]),
    "broadcast_axis": (lambda F, a: F.broadcast_axis(a, axis=0, size=3),
                       [Y]),
    "broadcast_like": (lambda F, a, b: F.broadcast_like(a, b), [Y, X]),
    "slice": (lambda F, a: F.slice(a, begin=(0, 1), end=(2, 3)),
              [_u(2, 3, 4)]),
    "slice_axis": (lambda F, a: F.slice_axis(a, axis=1, begin=1, end=3),
                   [_u(2, 3, 4)]),
    "_slice_basic": (lambda F, a: a[1:, None, ..., 2], [_u(2, 3, 4)]),
    "concat": (lambda F, a, b: F.concat(a, b, dim=0), [X, Y]),
    "Concat": (lambda F, a, b: F.Concat(a, b, dim=0), [X, Y]),
    "stack": (lambda F, a, b: F.stack(a, b, axis=1), [X, X + 1]),
    "split": (lambda F, a: F.split(a, num_outputs=2, axis=1), [X]),
    "SliceChannel": (lambda F, a: F.SliceChannel(a, num_outputs=3, axis=0,
                                                 squeeze_axis=True), [X]),
    "take": (lambda F, a, i: F.take(a, i, axis=1),
             [X, np.array([[0, 3], [5, -1]], "f4")]),
    "take_wrap": (lambda F, a, i: F.take(a, i, axis=0, mode="wrap"),
                  [X, np.array([4, -1, 1], "f4")]),
    "pick": (lambda F, a, i: F.pick(a, i, axis=1),
             [X, np.array([0, 3, 9], "f4")]),
    "pick_wrap": (lambda F, a, i: F.pick(a, i, axis=0, mode="wrap",
                                         keepdims=True),
                  [X, np.array([0, 4, -1, 2], "f4")]),
    "one_hot": (lambda F, i: F.one_hot(i, depth=5, on_value=2.0,
                                       off_value=-1.0),
                [np.array([0, 4, 7, -1], "f4")]),
    "tile": (lambda F, a: F.tile(a, reps=(2, 1, 3)), [X]),
    "repeat": (lambda F, a: F.repeat(a, repeats=2, axis=1), [X]),
    "repeat_flat": (lambda F, a: F.repeat(a, repeats=3), [X]),
    "where": (lambda F, c, a, b: F.where(c, a, b),
              [np.array([[1, 0, 2, 0]] * 3, "f4"), X, X * 2]),
    "swapaxes": (lambda F, a: F.swapaxes(a, dim1=0, dim2=2), [_u(2, 3, 4)]),
    "SwapAxis": (lambda F, a: F.SwapAxis(a, dim1=0, dim2=1), [X]),
    "dot": (lambda F, a, b: F.dot(a, b), [X, _u(4, 5)]),
    "dot_transposed": (lambda F, a, b: F.dot(a, b, transpose_a=True,
                                             transpose_b=True),
                       [_u(4, 3), _u(5, 4)]),
    "dot_3d": (lambda F, a, b: F.dot(a, b), [_u(2, 3, 4), _u(4, 5)]),
    "batch_dot": (lambda F, a, b: F.batch_dot(a, b, transpose_b=True),
                  [_u(2, 3, 4), _u(2, 5, 4)]),
    "cast": (lambda F, a: F.cast(a, dtype="float16"), [X]),
    "clip": (lambda F, a: F.clip(a, 0.3, 0.6), [X]),
    "_copy": (lambda F, a: F._copy(a), [X]),
    "zeros_like": (lambda F, a: F.zeros_like(a), [X]),
    "ones_like": (lambda F, a: F.ones_like(a), [X]),
    "identity": (lambda F, a: F.identity(a), [X]),
    "BlockGrad": (lambda F, a: F.BlockGrad(a) * a, [X]),
    "stop_gradient": (lambda F, a: F.stop_gradient(a * 2) * a, [X]),
    "power": (lambda F, a, b: F.power(a, b), [X, Y]),
    "logical_and": (lambda F, a, b: F.logical_and(a, b),
                    [np.round(X), np.round(Y)]),
    "logical_or": (lambda F, a, b: F.logical_or(a, b),
                   [np.round(X), np.round(Y)]),
    "logical_xor": (lambda F, a, b: F.logical_xor(a, b),
                    [np.round(X), np.round(Y)]),
    # the sequence ops of gluon.rnn's unroll and BidirectionalCell
    "SequenceMask": (lambda F, a, n: F.SequenceMask(
        a, n, use_sequence_length=True, value=-1.0),
        [_u(4, 3, 2), np.array([4, 1, 2], "f4")]),
    "SequenceMask_axis1": (lambda F, a, n: F.SequenceMask(
        a, n, use_sequence_length=True, axis=1),
        [_u(3, 4, 2), np.array([4, 1, 2], "f4")]),
    "SequenceReverse": (lambda F, a, n: F.SequenceReverse(
        a, n, use_sequence_length=True),
        [_u(4, 3, 2), np.array([4, 1, 3], "f4")]),
    "SequenceReverse_all": (lambda F, a: F.SequenceReverse(a),
                            [_u(4, 3, 2)]),
    # nn: the MLP's ops
    "FullyConnected": (lambda F, a, w, b: F.FullyConnected(
        a, w, b, num_hidden=5), [_u(2, 3, 4), _u(5, 12), _u(5)]),
    "FullyConnected_no_bias": (lambda F, a, w: F.FullyConnected(
        a, w, num_hidden=5, no_bias=True, flatten=False),
        [_u(2, 3, 4), _u(5, 4)]),
    "Activation": (lambda F, a: F.Activation(a, act_type="relu") +
                   F.Activation(a, act_type="sigmoid") +
                   F.Activation(a, act_type="tanh") +
                   F.Activation(a, act_type="softrelu") +
                   F.Activation(a, act_type="softsign"),
                   [_u(3, 4, lo=-1, hi=1)]),
    "softmax": (lambda F, a: F.softmax(a, axis=0, temperature=2.0), [X]),
    "softmax_length": (lambda F, a, n: F.softmax(a, n, axis=-1,
                                                 use_length=True),
                       [X, np.array([1, 4, 2], "f4")]),
    "log_softmax": (lambda F, a: F.log_softmax(a, axis=-1), [X]),
    "softmax_cross_entropy": (lambda F, a, y: F.softmax_cross_entropy(a, y),
                              [X, np.array([0, 3, 1], "f4")]),
}


@pytest.mark.parametrize("name", sorted(SHAPE))
def test_shape_and_nn_ops(name):
    fn, arrays = SHAPE[name]
    torch_parity.check(fn, arrays, rtol=1e-5)


@pytest.mark.parametrize("name", ["sgd_update", "sgd_mom_update",
                                  "sgd_update_clip_wd", "sgd_lazy",
                                  "adam_update", "adam_lazy",
                                  "clip_by_global_norm", "add_n",
                                  "ElementWiseSum"])
def test_optimizer_ops(name):
    w, g, m = _u(4, 5), _u(4, 5, lo=-1, hi=1), _u(4, 5, lo=-0.1, hi=0.1)
    v = _u(4, 5, lo=0.01, hi=0.1)
    if name in ("sgd_lazy", "adam_lazy"):
        g[1] = 0.0
    fns = {
        "sgd_update": lambda F, w, g: F.sgd_update(
            w, g, lr=0.1, wd=0.0, rescale_grad=0.5),
        "sgd_update_clip_wd": lambda F, w, g: F.sgd_update(
            w, g, 0.1, 0.01, rescale_grad=2.0, clip_gradient=0.5),
        "sgd_lazy": lambda F, w, g: F.sgd_update(
            w, g, lr=0.1, wd=0.1, lazy_update=True),
        "sgd_mom_update": lambda F, w, g, m: F.sgd_mom_update(
            w, g, m, lr=0.1, wd=0.01, momentum=0.9, rescale_grad=0.5),
        "adam_update": lambda F, w, g, m, v: F.adam_update(
            w, g, m, v, 0.01, 0.001, rescale_grad=0.5, beta1=0.8,
            clip_gradient=0.3),
        "adam_lazy": lambda F, w, g, m, v: F.adam_update(
            w, g, m, v, lr=0.01, wd=0.1, lazy_update=True),
        "clip_by_global_norm": lambda F, w, g: F.clip_by_global_norm(
            w, g, max_norm=1.5),
        "add_n": lambda F, w, g, m: F.add_n(w, g, m),
        "ElementWiseSum": lambda F, w, g: F.ElementWiseSum(w, g),
    }
    arrays = {"sgd_mom_update": [w, g, m], "adam_update": [w, g, m, v],
              "adam_lazy": [w, g, m, v], "add_n": [w, g, m]}.get(name,
                                                                [w, g])
    torch_parity.check(fns[name], arrays, rtol=1e-6, grad=False)


def test_sgd_update_out_is_in_place():
    """``out=`` writes into the existing tensor (and its views)."""
    w = nd.array(np.ones((2, 3), "f4"), ctx=CPU)
    view = w[0]
    t = w._t
    r = nd.sgd_update(w, nd.ones((2, 3), ctx=CPU), 0.1, 0.0, out=w)
    assert r is w and w._t is t
    np.testing.assert_allclose(view.asnumpy(), [0.9] * 3, rtol=1e-6)


CREATION = {
    "_zeros": lambda F: F.zeros((2, 3), ctx=_ctx(F), dtype="int32"),
    "_ones": lambda F: F.ones(4, ctx=_ctx(F)),
    "_full": lambda F: F.full((2, 2), 7, ctx=_ctx(F)),
    "_arange": lambda F: F.arange(1, 7, 1.5, repeat=2, ctx=_ctx(F)),
    "_eye": lambda F: F.eye(3, 4, k=1, ctx=_ctx(F)),
}


def _ctx(F):
    import mxnet_tpu as jmx
    return mx.cpu() if F is nd else jmx.cpu()


@pytest.mark.parametrize("name", sorted(CREATION))
def test_creation(name):
    import mxnet_tpu as jmx
    j = CREATION[name](jmx.nd).asnumpy()
    t = CREATION[name](nd).asnumpy()
    assert j.dtype == t.dtype
    np.testing.assert_array_equal(t, j)


RANDOM_OPS = {"_random_uniform", "_random_normal", "_random_gamma",
              "_random_exponential", "_random_poisson", "_random_randint",
              "_random_bernoulli", "_sample_multinomial", "_shuffle",
              "Dropout"}


# held against the JAX ops, value and gradient, in test_torch_conv_ops.py
CONV_OPS = {"Convolution", "Pooling", "BatchNorm"}

# raises NotImplementedError as the JAX op does, in test_torch_rnn.py
RNN_OPS = {"RNN"}

# held against the JAX ops, value and gradient, in test_torch_nn_layers.py
NN_LAYER_OPS = {"Deconvolution", "LeakyReLU", "gelu_tanh", "InstanceNorm",
                "GroupNorm", "LayerNorm", "pad", "Pad"}


# -- the Llama blocks' ops ---------------------------------------------------

def _ids(n, v, seed):
    return np.random.RandomState(seed).randint(0, v, n).astype("f4")


LLAMA_OPS = {
    "RMSNorm": (lambda F, x, g: F.RMSNorm(x, g, eps=1e-5),
                [_u(2, 3, 8, lo=-1, hi=1), _u(8)], 1e-5),
    "silu": (lambda F, x: F.silu(x), [_u(3, 4, lo=-2, hi=2)], 1e-5),
    "rope": (lambda F, x: F.rope(x, base=10000.0),
             [_u(2, 5, 4, 8, lo=-1, hi=1)], 1e-5),
    "rope_offset": (lambda F, x: F.rope(x, 7, base=500000.0),
                    [_u(2, 5, 4, 8, lo=-1, hi=1)], 1e-5),
    "Embedding": (lambda F, i, w: F.Embedding(i, w, input_dim=11,
                                             output_dim=6),
                  [_ids((2, 5), 11, 1), _u(11, 6)], 1e-6),
    "embedding": (lambda F, i, w: F.embedding(i, w),
                  [_ids((7,), 11, 2), _u(11, 6)], 1e-6),
    # grouped-query attention: 4 query heads over 2 KV heads
    "dot_product_attention": (
        lambda F, q, k, v: F.dot_product_attention(q, k, v, causal=True),
        [_u(2, 8, 4, 8, lo=-1, hi=1), _u(2, 8, 2, 8, lo=-1, hi=1),
         _u(2, 8, 2, 8, lo=-1, hi=1)], 1e-5),
    "dot_product_attention_window": (
        lambda F, q, k, v: F.dot_product_attention(q, k, v, causal=True,
                                                   window=3),
        [_u(1, 8, 2, 8, lo=-1, hi=1), _u(1, 8, 2, 8, lo=-1, hi=1),
         _u(1, 8, 2, 8, lo=-1, hi=1)], 1e-5),
    # S=128: the flash route (its plain version on the CPU)
    "dot_product_attention_flash": (
        lambda F, q, k, v: F.dot_product_attention(q, k, v, causal=True),
        [_u(1, 128, 4, 8, lo=-1, hi=1), _u(1, 128, 2, 8, lo=-1, hi=1),
         _u(1, 128, 2, 8, lo=-1, hi=1)], 1e-4),
    # V=97: slabs of 33, 33 and 31 rows (chunk 40 rebalanced)
    "chunked_softmax_ce": (
        lambda F, h, w, lbl: F.chunked_softmax_ce(h, w, lbl, chunk=40),
        [_u(6, 8, lo=-1, hi=1), _u(97, 8, lo=-1, hi=1), _ids(6, 97, 3)],
        1e-5),
    "chunked_softmax_ce_bias": (
        lambda F, h, w, b, lbl: F.chunked_softmax_ce_bias(h, w, b, lbl,
                                                          chunk=32),
        [_u(6, 8, lo=-1, hi=1), _u(97, 8, lo=-1, hi=1),
         _u(97, lo=-1, hi=1), _ids(6, 97, 4)], 1e-5),
}


@pytest.mark.parametrize("case", sorted(LLAMA_OPS))
def test_llama_ops(case):
    """Value, dtype and every gradient against the JAX op."""
    fn, arrays, rtol = LLAMA_OPS[case]
    torch_parity.check(fn, arrays, rtol=rtol, atol=1e-6)


def test_rms_norm_is_float32_under_amp():
    """Under AMP a bfloat16 input to ``RMSNorm`` with its float32 gamma
    gives float32 by type promotion, as in the reference, whose
    ``amp.init`` casts only its target ops: ``log_softmax`` keeps
    bfloat16 and a target op gives bfloat16.  Values and dtypes against
    the JAX ops under the JAX package's AMP, at the bfloat16 tolerance
    of ``test_utils``."""
    import mxnet_tpu as jmx
    from mxnet_tpu.contrib import amp as jamp
    from mxnet_tpu_torch.contrib import amp
    xn, gn = _u(2, 8, lo=-1, hi=1), _u(8)
    an, bn = _u(2, 8), _u(3, 8)

    def run(pkg, amp_mod):
        F, ctx = pkg.nd, pkg.cpu()
        x = F.array(xn, ctx=ctx).astype("bfloat16")
        amp_mod.init("bfloat16")
        try:
            return (F.RMSNorm(x, F.array(gn, ctx=ctx), eps=1e-5),
                    F.log_softmax(x),
                    F.FullyConnected(F.array(an, ctx=ctx),
                                     F.array(bn, ctx=ctx), num_hidden=3,
                                     no_bias=True))
        finally:
            amp_mod._deinit()

    got, want = run(mx, amp), run(jmx, jamp)
    assert [str(o.dtype) for o in got] == ["float32", "bfloat16",
                                           "bfloat16"]
    for g, w in zip(got, want):
        assert str(g.dtype) == str(w.dtype)
        np.testing.assert_allclose(g.astype("float32").asnumpy(),
                                   w.astype("float32").asnumpy(),
                                   rtol=1e-2, atol=1e-2)


def test_chunked_softmax_ce_checks():
    h, w = nd.array(_u(2, 4), ctx=CPU), nd.array(_u(5, 4), ctx=CPU)
    lbl = nd.array([0.0, 4.0], ctx=CPU)
    # axis_name is a tensor-parallel axis of the current mesh (one
    # without it raises)
    from mxnet_tpu_torch import parallel
    try:
        with mx.cpu(), pytest.raises(MXNetError, match="no axis 'tp'"):
            nd.chunked_softmax_ce(h, w, lbl, axis_name="tp")
    finally:
        parallel.set_mesh(None)
    with pytest.raises(MXNetError, match="chunk"):
        nd.chunked_softmax_ce(h, w, lbl, chunk=0)
    with pytest.raises(MXNetError, match="flash=False"):
        nd.dot_product_attention(*(nd.array(_u(1, 4, 1, 8), ctx=CPU)
                                   for _ in range(3)), flash=False)


def test_every_op_has_a_case():
    """Each registered op is held against the JAX package here (the
    Llama blocks' ops in LLAMA_OPS), in test_torch_conv_ops.py
    (CONV_OPS), test_torch_rnn.py (RNN_OPS), test_torch_nn_layers.py
    (NN_LAYER_OPS), test_torch_optimizer.py (the update ops) or
    test_torch_amp.py (AMP's ops), test_torch_registry_ops.py
    (REGISTRY_OPS), test_torch_vision_ops.py (VISION_OPS),
    test_torch_detection.py (DETECTION_OPS), test_torch_quantization.py
    (QUANT_OPS), test_torch_deformable.py (DEFORMABLE_OPS),
    test_torch_registry_tail.py (TAIL_OPS), test_torch_moe.py
    (MOE_OPS), or by its statistics in test_torch_autograd.py (the
    samplers, Dropout)."""
    from test_torch_deformable import DEFORMABLE_OPS
    from test_torch_detection import DETECTION_OPS
    from test_torch_moe import MOE_OPS
    from test_torch_optimizer import UPDATE_OPS
    from test_torch_quantization import QUANT_OPS
    from test_torch_registry_ops import REGISTRY_OPS
    from test_torch_registry_tail import TAIL_OPS
    from test_torch_vision_ops import VISION_OPS
    covered = set(UNARY) | set(SCALAR) | set(BROADCAST) | set(CREATION) \
        | {n for n, _ in REDUCE} | set(SHAPE) | {"argmax", "argmin"} \
        | {"sgd_update", "sgd_mom_update", "adam_update",
           "clip_by_global_norm", "add_n", "ElementWiseSum"} \
        | {u[0] for u in UPDATE_OPS} \
        | {"lamb_update_phase1", "lamb_update_phase2", "multi_sgd_update",
           "multi_sgd_mom_update", "multi_mp_sgd_update",
           "multi_mp_sgd_mom_update", "multi_adam_update",
           "multi_lamb_update", "multi_sum_sq", "multi_lars"} \
        | {"amp_cast", "amp_multicast", "all_finite", "multi_all_finite"} \
        | RANDOM_OPS | CONV_OPS \
        | RNN_OPS | NN_LAYER_OPS | set(LLAMA_OPS) | REGISTRY_OPS \
        | VISION_OPS | DETECTION_OPS | QUANT_OPS | DEFORMABLE_OPS \
        | TAIL_OPS | MOE_OPS
    missing = sorted(set(list_ops()) - covered)
    assert missing == []


# -- int8 operands accumulate in int32 (ROADMAP queue 3, F14) ---------------------

def _i8(*shape, seed=0):
    return np.random.RandomState(seed).randint(-127, 128, shape).astype("i1")


INT8_CASES = {
    # ROADMAP's case: 8 products of 100 * 100 wrap in int8, not in int32
    "dot_f14": (lambda F, a, b: F.dot(a, b),
                [np.full((4, 8), 100, "i1"), np.full((8, 3), 100, "i1")]),
    "dot_transposed": (lambda F, a, b: F.dot(a, b, transpose_a=True,
                                             transpose_b=True),
                       [_i8(147, 5), _i8(4, 147, seed=1)]),
    "dot_nd": (lambda F, a, b: F.dot(a, b),
               [_i8(2, 3, 6), _i8(6, 2, 5, seed=1)]),
    "batch_dot": (lambda F, a, b: F.batch_dot(a, b, transpose_b=True),
                  [_i8(3, 5, 9), _i8(3, 4, 9, seed=1)]),
    "conv_k147_stride2": (lambda F, x, w: F.Convolution(
        x, w, kernel=(7, 7), stride=(2, 2), pad=(3, 3), num_filter=4,
        no_bias=True), [_i8(2, 3, 12, 12), _i8(4, 3, 7, 7, seed=1)]),
    "conv_groups_dilate": (lambda F, x, w: F.Convolution(
        x, w, kernel=(3, 3), dilate=(2, 2), pad=(1, 1), num_filter=6,
        num_group=2, no_bias=True), [_i8(1, 4, 9, 9), _i8(6, 2, 3, 3,
                                                         seed=1)]),
    "conv_1x1": (lambda F, x, w: F.Convolution(
        x, w, kernel=(1, 1), num_filter=8, no_bias=True),
        [_i8(2, 16, 5, 5), _i8(8, 16, 1, 1, seed=1)]),
}


@pytest.mark.parametrize("case", sorted(INT8_CASES))
def test_int8_products_accumulate_in_int32(case):
    """F14: int8 x int8 ``dot``, ``batch_dot`` and ``Convolution`` give
    int32, bit-equal to the JAX package's (``_int8_acc``)."""
    fn, arrays = INT8_CASES[case]
    got = torch_parity.check(fn, arrays, rtol=0, atol=0, grad=False)[0]
    assert got.dtype == np.int32
    if case == "dot_f14":
        assert (got == 80000).all()


def test_registry_contracts():
    for name in list_ops():
        assert validate_opdef(get_op(name)) == [], name
    from mxnet_tpu_torch.ops.registry import register
    with pytest.raises(ValueError, match="scalar_attrs"):
        register("_bad", scalar_attrs=("lr",))(lambda x, scale: x)
    with pytest.raises(ValueError, match="registered twice"):
        register("relu")(lambda x: x)
    with pytest.raises(KeyError):
        get_op("no_such_op")


# -- the NDArray contract --------------------------------------------------------


def test_dtype_rules():
    assert nd.array([1, 2], ctx=CPU).dtype == np.float32
    assert nd.array(np.zeros(3), ctx=CPU).dtype == np.float32
    assert nd.array(np.zeros(3, "int32"), ctx=CPU).dtype == np.int32
    assert nd.array([1, 2], ctx=CPU, dtype="float16").dtype == np.float16
    a = nd.array([1, 2, 3], ctx=CPU, dtype="int32")
    assert (a + 1).dtype == np.int32
    assert (a > 1).dtype == np.int32
    np.testing.assert_array_equal((a > 1).asnumpy(), [0, 1, 1])
    h = nd.array([1.0], ctx=CPU, dtype="float16") * 2
    assert h.dtype == np.float16
    assert nd.argmax(nd.array([[1, 3, 2]], ctx=CPU), axis=1).dtype \
        == np.float32
    b = nd.array([1.5, -2.5], ctx=CPU).astype("int32")
    assert b.dtype == np.int32
    np.testing.assert_array_equal(b.asnumpy(), [1, -2])


def test_operators_against_numpy():
    xn, yn = _u(2, 3), _u(3)
    x, y = nd.array(xn, ctx=CPU), nd.array(yn, ctx=CPU)
    for got, want in [(x + y, xn + yn), (x - 1, xn - 1), (1 - x, 1 - xn),
                      (x * 2, xn * 2), (2 / x, 2 / xn), (x / y, xn / yn),
                      (x ** 2, xn ** 2), (2 ** x, 2 ** xn), (-x, -xn),
                      (x % 0.3, np.mod(xn, 0.3)), (abs(-x), xn),
                      (x + yn, xn + yn), (x.T, xn.T)]:
        np.testing.assert_allclose(got.asnumpy(), want, rtol=1e-5)
    assert (x == x).asnumpy().all() and not (x != x).asnumpy().any()
    assert (x == None) is False  # noqa: E711


def test_inplace_operators_keep_the_array():
    a = nd.ones((2, 2), ctx=CPU)
    t = a._t
    a += 1
    a *= 3
    a -= 1
    a /= 5
    assert a._t is t
    np.testing.assert_allclose(a.asnumpy(), np.ones((2, 2)))


def test_reshape_codes_and_views():
    x = nd.zeros((2, 3, 4), ctx=CPU)
    assert x.reshape((-1,)).shape == (24,)
    assert x.reshape((0, -1)).shape == (2, 12)
    assert x.reshape((-2,)).shape == (2, 3, 4)
    assert x.reshape((-3, 4)).shape == (6, 4)
    assert x.reshape((-4, 1, 2, 3, 4)).shape == (1, 2, 3, 4)
    assert x.reshape(shape=(4, -1), reverse=True).shape == (4, 6)
    # NDArray.reshape and basic indexing share storage; ops copy
    r = x.reshape((6, 4))
    r[:] = 1.0
    assert x.asnumpy().sum() == 24
    v = x[1:2]
    v[:] = 3.0
    assert x.asnumpy()[1].sum() == 36
    x[0, 0] = 9.0
    np.testing.assert_array_equal(r.asnumpy()[0], [9, 9, 9, 9])
    f = nd.flatten(x)
    f[:] = 0.0
    assert x.asnumpy()[1].sum() == 36
    t = nd.transpose(x)
    t[:] = 0.0
    assert x.asnumpy()[1].sum() == 36


def test_indexing():
    x = nd.arange(0, 12, ctx=CPU).reshape((3, 4))
    np.testing.assert_array_equal(x[1].asnumpy(), [4, 5, 6, 7])
    np.testing.assert_array_equal(x[:, 1].asnumpy(), [1, 5, 9])
    np.testing.assert_array_equal(x[..., -1].asnumpy(), [3, 7, 11])
    assert x[None].shape == (1, 3, 4)
    np.testing.assert_array_equal(
        x[nd.array([0, 2], ctx=CPU, dtype="int32")].asnumpy(),
        [[0, 1, 2, 3], [8, 9, 10, 11]])
    np.testing.assert_array_equal(x[[2, 0]].asnumpy()[:, 0], [8, 0])
    y = x[nd.array([1], ctx=CPU)]
    y[:] = -1.0
    assert x.asnumpy()[1, 0] == 4      # advanced indexing copies
    x[0:2, 1] = nd.array([7.0, 8.0], ctx=CPU)
    x[2] = 5
    x[:, 3] = np.array([1.0, 1.0, 1.0])
    np.testing.assert_array_equal(x.asnumpy()[:, 1], [7, 8, 5])
    np.testing.assert_array_equal(x.asnumpy()[:, 3], [1, 1, 1])
    with pytest.raises(MXNetError, match="negative step"):
        x[::-1]
    np.testing.assert_array_equal(
        nd.slice(x, begin=(None,), end=(None,), step=(-1,)).asnumpy(),
        x.asnumpy()[::-1])


def test_out_and_copyto_write_in_place():
    a = nd.array(_u(2, 3), ctx=CPU)
    out = nd.zeros((2, 3), ctx=CPU)
    t = out._t
    res = nd.exp(a, out=out)
    assert res is out and out._t is t
    np.testing.assert_allclose(out.asnumpy(), np.exp(a.asnumpy()),
                               rtol=1e-6)
    c = nd.zeros((2, 3), ctx=CPU, dtype="float16")
    a.copyto(c)
    assert c.dtype == np.float16
    d = a.copyto(mx.cpu(1))
    assert d.context == mx.cpu(1) and d._t is not a._t
    assert a.as_in_context(CPU) is a
    with pytest.raises(MXNetError, match="same"):
        a.copyto(a)
    e = a.detach()
    assert e._t.untyped_storage().data_ptr() == \
        a._t.untyped_storage().data_ptr()


def test_sync_points_and_errors():
    a = nd.ones((8, 8), ctx=CPU)
    b = a * 2
    b.wait_to_read()
    nd.waitall()
    assert b.asnumpy()[0, 0] == 2
    host = b.asnumpy()
    host[0, 0] = 100
    assert b.asnumpy()[0, 0] == 2      # asnumpy returns a copy
    assert nd.array([5.0], ctx=CPU).asscalar() == 5.0
    with pytest.raises(ValueError):
        b.asscalar()
    with pytest.raises(MXNetError, match="dot"):
        nd.dot(nd.ones((2, 3), ctx=CPU), nd.ones((4, 5), ctx=CPU))
    assert len(b) == 8 and bool(nd.array([1.0], ctx=CPU))
    with pytest.raises(ValueError):
        bool(b)


def test_default_context_is_the_card():
    """Without ctx=, arrays go to gpu(0): without a card, that raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for make in (lambda: nd.array([1.0]), lambda: nd.zeros((2,)),
                 lambda: nd.random.uniform(shape=(2,))):
        with pytest.raises(MXNetError, match="CUDA"):
            make()
    with CPU:
        assert nd.zeros((2,)).context == CPU
