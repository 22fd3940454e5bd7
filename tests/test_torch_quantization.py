"""Int8 quantization against the JAX package's: the registry's
quantization ops, the int8 layers, calibration, and quantized nets.

On the CPU, with the same seeded numpy inputs and the JAX weights carried
into the port by name:

* int32 accumulators (``dot`` and ``Convolution`` of int8 operands) are
  bit-equal (``tests/test_torch_ndarray.py`` holds the ops themselves);
* int8 codes equal in at least 99.9 % of elements and are never more than
  1 apart (a float32 product may round the other way at a .5 boundary);
* calibrated ranges on the same activations: min/max exactly, entropy
  within one histogram bin (to the bit, in fact);
* quantized nets (a ``Conv-BN-ReLU-Dense`` ``HybridSequential`` and a
  ``resnet18_v1`` thumbnail at 16 x 16, batch 4): relative L2 <= 1e-2
  and argmax agreement >= 0.97 against the JAX package's int8 output.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu.contrib import quantization as jq
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import nd
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.contrib import quantization as q
from mxnet_tpu_torch.models import load_jax_gluon_params
from mxnet_tpu_torch.ops import quantization_ops as qops

import torch_parity  # noqa: F401  (a worker's share of the cores)

CPU = mx.cpu()
RNG = np.random.RandomState(16)

#: the ops this file holds against the JAX package
QUANT_OPS = {"_contrib_quantize", "_contrib_dequantize",
             "_contrib_requantize"}


def _n(*shape, scale=1.0):
    return (RNG.randn(*shape) * scale).astype("f4")


def _codes_close(got, want):
    """Int8 codes: >= 99.9 % equal, none more than 1 apart; returns the
    count that differ."""
    got, want = np.asarray(got, "i4"), np.asarray(want, "i4")
    assert got.shape == want.shape
    diff = np.abs(got - want)
    assert diff.max(initial=0) <= 1
    assert (diff == 0).mean() >= 0.999, (diff != 0).sum()
    return int((diff != 0).sum())


def _rel_l2(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


# -- the registry's ops ------------------------------------------------------

def test_quantize_and_dequantize_match_jax():
    x = _n(64, 33, scale=3.0)
    lo, hi = np.array([-2.5], "f4"), np.array([4.0], "f4")
    jo = jmx.nd.contrib.quantize(*(jmx.nd.array(a) for a in (x, lo, hi)))
    to = nd.contrib.quantize(*(nd.array(a, ctx=CPU) for a in (x, lo, hi)))
    assert to[0].dtype == np.int8 and to[1].dtype == np.float32
    _codes_close(to[0].asnumpy(), jo[0].asnumpy())
    for j, t in zip(jo[1:], to[1:]):
        assert t.shape == (1,)
        np.testing.assert_array_equal(t.asnumpy(), j.asnumpy())
    jd = jmx.nd.contrib.dequantize(jo[0], jo[1], jo[2]).asnumpy()
    td = nd.contrib.dequantize(nd.array(jo[0].asnumpy(), ctx=CPU,
                                        dtype="int8"), to[1], to[2])
    assert td.dtype == np.float32
    np.testing.assert_allclose(td.asnumpy(), jd, rtol=1e-6, atol=1e-7)
    with pytest.raises(ValueError, match="int8"):
        nd.contrib.quantize(*(nd.array(a, ctx=CPU) for a in (x, lo, hi)),
                            out_type="uint8")


@pytest.mark.parametrize("calib", [None, (-3.0e-3, 2.0e-3)])
def test_requantize_matches_jax(calib):
    acc = RNG.randint(-2 ** 24, 2 ** 24, (32, 40)).astype("i4")
    lo, hi = np.array([-7.5], "f4"), np.array([6.0], "f4")
    kw = {} if calib is None else dict(min_calib_range=calib[0],
                                       max_calib_range=calib[1])
    jo = jmx.nd.contrib.requantize(jmx.nd.array(acc, dtype="int32"),
                                   jmx.nd.array(lo), jmx.nd.array(hi), **kw)
    to = nd.contrib.requantize(nd.array(acc, ctx=CPU, dtype="int32"),
                               nd.array(lo, ctx=CPU), nd.array(hi, ctx=CPU),
                               **kw)
    assert to[0].dtype == np.int8
    _codes_close(to[0].asnumpy(), jo[0].asnumpy())
    for j, t in zip(jo[1:], to[1:]):
        np.testing.assert_allclose(t.asnumpy(), j.asnumpy(), rtol=1e-6)


def test_requantize_refuses_half_a_calibration_pair():
    args = [nd.array(np.ones((2, 2), "i4"), ctx=CPU, dtype="int32"),
            nd.array([-1.0], ctx=CPU), nd.array([1.0], ctx=CPU)]
    with pytest.raises(ValueError, match="together"):
        nd.contrib.requantize(*args, min_calib_range=-1.0)


def test_int8_mm_pads_and_counts_only_on_the_card():
    a = torch.from_numpy(RNG.randint(-127, 128, (5, 147)).astype("i1"))
    b = torch.from_numpy(RNG.randint(-127, 128, (147, 4)).astype("i1"))
    before = qops.int_mm_launches
    got = qops.int8_mm(a, b)
    assert got.dtype == torch.int32 and qops.int_mm_launches == before
    np.testing.assert_array_equal(got.numpy(),
                                  a.numpy().astype("i8") @ b.numpy())


# -- quantize_array and calibration -------------------------------------------

def test_quantize_array_per_tensor_and_per_channel():
    w = _n(6, 5, 3, 3)
    for kw in ({}, {"axis": 0}):
        jq_, js = jq.quantize_array(jmx.nd.array(w), **kw)
        tq, ts = q.quantize_array(nd.array(w, ctx=CPU), **kw)
        assert tq.dtype == np.int8 and tq.context == CPU
        np.testing.assert_array_equal(tq.asnumpy(), jq_.asnumpy())
        np.testing.assert_array_equal(np.asarray(ts), np.asarray(js))
        back = q.dequantize_array(tq, ts if not kw else
                                  nd.array(ts.reshape(-1, 1, 1, 1),
                                           ctx=CPU))
        np.testing.assert_allclose(back.asnumpy(), w,
                                   atol=float(np.max(ts)) / 2 + 1e-7)


def test_calibration_ranges():
    acts = [np.maximum(_n(4, 8, 5, 5, scale=2.0), 0) for _ in range(3)]
    jlo, jhi = jq.calib_minmax([jmx.nd.array(a) for a in acts])
    tlo, thi = q.calib_minmax([torch.from_numpy(a) for a in acts])
    assert (tlo, thi) == (jlo, jhi)
    jt = jq.calib_entropy([jmx.nd.array(a) for a in acts])
    tt = q.calib_entropy([nd.array(a, ctx=CPU) for a in acts])
    bin_width = max(float(np.max(a)) for a in acts) / 2048
    assert abs(tt[1] - jt[1]) <= bin_width and tt[0] == -tt[1]
    # the port's KL search builds the same reconstruction without the
    # loop over the 255 groups: the same threshold, to the bit
    assert tt == jt


# -- the int8 layers and nets ---------------------------------------------------

def _carry(jnet, tnet, x):
    """Make both nets' deferred shapes with one call on ``x``, then carry
    the JAX weights (running statistics included) into the port."""
    jnet(jmx.nd.array(x))
    tnet(nd.array(x, ctx=CPU))
    params = {k: p.data().asnumpy() for k, p in
              jnet.collect_params().items()}
    load_jax_gluon_params(tnet, params)


def _small(pkg):
    net = pkg.gluon.nn.HybridSequential(prefix="qs_")
    with net.name_scope():
        net.add(pkg.gluon.nn.Conv2D(8, 3, padding=1),
                pkg.gluon.nn.BatchNorm(),
                pkg.gluon.nn.Activation("relu"),
                pkg.gluon.nn.Conv2D(6, 3, strides=2, use_bias=False),
                pkg.gluon.nn.BatchNorm(),
                pkg.gluon.nn.Activation("relu"),
                pkg.gluon.nn.Dense(5))
    return net


def _settle(jnet, n, shape, seed):
    """BatchNorm statistics away from 0 and 1: ``n`` train-mode forwards
    of seeded batches in the JAX package."""
    r = np.random.RandomState(seed)
    for _ in range(n):
        with jmx.autograd.train_mode():
            jnet(jmx.nd.array(r.randn(*shape).astype("f4") + 0.5))


@pytest.fixture(scope="module")
def small_nets():
    jmx.random.seed(5)
    jnet = _small(jmx)
    jnet.initialize(jmx.init.Xavier())
    x = _n(4, 3, 8, 8)
    jnet(jmx.nd.array(x))
    _settle(jnet, 3, (4, 3, 8, 8), 7)
    tnet = _small(mx)
    tnet.initialize(mx.init.Xavier(), ctx=CPU)
    _carry(jnet, tnet, x)
    return jnet, tnet


def test_quantized_layers_match_jax(small_nets):
    jnet, tnet = small_nets
    x = _n(4, 3, 8, 8)
    kids_j, kids_t = list(jnet._children.values()), list(
        tnet._child_blocks())
    for calib in (None, (-2.0, 3.0)):
        jc = jq.QuantizedConv(kids_j[0], calib, fold_bn=kids_j[1])
        tc = q.QuantizedConv(kids_t[0], calib, fold_bn=kids_t[1])
        np.testing.assert_array_equal(tc.wq.asnumpy(), jc.wq.asnumpy())
        want = jc(jmx.nd.array(x)).asnumpy()
        got = tc(torch.from_numpy(x)).numpy()
        assert _rel_l2(got, want) <= 1e-5
        h = _n(4, 6 * 3 * 3)
        jd = jq.QuantizedDense(kids_j[6], calib)
        td = q.QuantizedDense(kids_t[6], calib)
        want = jd(jmx.nd.array(h)).asnumpy()
        got = td(torch.from_numpy(h)).numpy()
        assert _rel_l2(got, want) <= 1e-5


def test_quantized_small_net_matches_jax(small_nets):
    jnet, tnet = small_nets
    calib = [_n(4, 3, 8, 8) for _ in range(3)]
    jqn = jq.quantize_net(jnet, calib_data=iter(
        [jmx.nd.array(c) for c in calib]), calib_mode="entropy")
    tqn = q.quantize_net(tnet, calib_data=iter(
        [nd.array(c, ctx=CPU) for c in calib]), calib_mode="entropy")
    assert len(tqn.layer_map) == len(jqn.layer_map) == 5
    x = _n(16, 3, 8, 8)
    want = jqn(jmx.nd.array(x)).asnumpy()
    got = tqn(nd.array(x, ctx=CPU)).asnumpy()
    assert _rel_l2(got, want) <= 1e-2
    assert (got.argmax(1) == want.argmax(1)).mean() >= 0.97
    # the layers are back: the float net is unchanged after the int8 call
    np.testing.assert_allclose(tnet(nd.array(x, ctx=CPU)).asnumpy(),
                               jnet(jmx.nd.array(x)).asnumpy(),
                               rtol=1e-4, atol=1e-5)


def test_quantize_model_refuses_a_hybridized_net(small_nets):
    _, tnet = small_nets
    tnet.hybridize()
    try:
        with pytest.raises(MXNetError, match="un-hybridized"):
            q.quantize_model(tnet)
    finally:
        tnet.hybridize(False)


def test_quantized_resnet18_matches_jax():
    """A resnet18_v1 thumbnail (16 x 16, 10 classes, batch 4), min/max
    calibration over 4 batches: 20 convs and the Dense, and 19 folded
    BatchNorms (the thumbnail's first conv has none).

    Given the JAX package's ranges, the port's int8 logits are bit-equal
    to its.  The first layer's range is the input's, equal exactly.  The
    others are maxima of the float activations, which part from the JAX
    package's by an ulp or two (the convolutions sum in another order), so
    they are held to 1e-5 relative.  A code at a rounding boundary then
    flips now and then, and the flips grow through the 20 layers: other
    draws of this case read 0.004-0.018 relative L2 against an int8 error
    of 0.025-0.040 from the float net, so with its own ranges the port's
    logits are held to 2e-2 relative L2 and argmax agreement >= 0.97.
    Entropy calibration is held on the same activations in
    ``test_calibration_ranges`` and on the small net."""
    from mxnet_tpu.gluon.model_zoo.vision import resnet18_v1 as jres
    from mxnet_tpu_torch.gluon.model_zoo.vision import resnet18_v1 as tres
    jmx.random.seed(6)
    jnet = jres(classes=10, thumbnail=True, prefix="r_")
    jnet.initialize(jmx.init.Xavier())
    x = _n(4, 3, 16, 16)
    jnet(jmx.nd.array(x))
    _settle(jnet, 2, (4, 3, 16, 16), 8)
    tnet = tres(classes=10, thumbnail=True, prefix="r_")
    tnet.initialize(mx.init.Xavier(), ctx=CPU)
    _carry(jnet, tnet, x)
    calib = [_n(4, 3, 16, 16) + 0.5 for _ in range(4)]
    jmap = jq.quantize_model(jnet, calib_data=iter(
        [jmx.nd.array(c) for c in calib]), calib_mode="naive")
    tmap = q.quantize_model(tnet, calib_data=iter(
        [nd.array(c, ctx=CPU) for c in calib]), calib_mode="naive")
    assert len(tmap) == len(jmap) == 40
    jl = [v for v in jmap.values() if hasattr(v, "_calib")]
    tl = [v for v in tmap.values() if hasattr(v, "_calib")]
    assert len(tl) == len(jl) == 21
    np.testing.assert_array_equal(tl[0]._calib, jl[0]._calib)
    for j, t in zip(jl, tl):
        np.testing.assert_allclose(t._calib, j._calib, rtol=1e-5)
    xs = _n(4, 3, 16, 16) + 0.5
    want = jq.QuantizedNet(jnet, jmap)(jmx.nd.array(xs)).asnumpy()
    own = q.QuantizedNet(tnet, tmap)(nd.array(xs, ctx=CPU)).asnumpy()
    assert np.isfinite(own).all()
    assert (own.argmax(1) == want.argmax(1)).mean() >= 0.97
    assert _rel_l2(own, want) <= 2e-2
    for j, t in zip(jl, tl):
        t._calib = j._calib
    shared = q.QuantizedNet(tnet, tmap)(nd.array(xs, ctx=CPU)).asnumpy()
    np.testing.assert_array_equal(shared, want)
