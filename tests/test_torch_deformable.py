"""The deformable convolutions (``_contrib_DeformableConvolution``,
``_contrib_ModulatedDeformableConvolution``) and the layer
``gluon.contrib.cnn.DeformableConvolution`` against the JAX package's.

The ops run through both registries on the same seeded numpy inputs on
the CPU (``torch_parity.check``): the output and the gradients of data,
offset, mask, weight and bias agree to rtol 1e-5 / atol 1e-5.  The
offsets are normal with scale 1.5, so taps land between pixels and
outside the image (zero there).  The layer is built in both packages,
the JAX weights carried across by name after each made its deferred
shapes, and the output, the input's gradient and every parameter's
gradient compared (rtol 1e-4, atol 1e-5, ``test_utils``' float32).
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import nd
from mxnet_tpu_torch.models import load_jax_gluon_params

import torch_parity

CPU = mx.cpu()
RNG = np.random.RandomState(16)

#: the ops this file holds against the JAX package
DEFORMABLE_OPS = {"_contrib_DeformableConvolution",
                  "_contrib_ModulatedDeformableConvolution"}


def _n(*shape, scale=1.0):
    return (RNG.randn(*shape) * scale).astype("f4")


def _out(h, k, s, p, d):
    return (h + 2 * p - ((k - 1) * d + 1)) // s + 1


# name -> (batch, channels, size, filters, kernel, stride, pad, dilate,
#          groups, deformable groups, bias)
CASES = {
    "3x3_pad1": (2, 4, 6, 5, 3, 1, 1, 1, 1, 1, True),
    "3x3_stride2_dilate2": (1, 4, 9, 4, 3, 2, 2, 2, 1, 1, True),
    "groups2_dg2_nobias": (2, 4, 5, 6, 3, 1, 1, 1, 2, 2, False),
    "1x1": (2, 3, 4, 2, 1, 1, 0, 1, 1, 1, True),
}


def _inputs(case, modulated):
    b, c, h, o, k, s, p, d, g, dg, bias = CASES[case]
    ho = _out(h, k, s, p, d)
    arrays = [_n(b, c, h, h), _n(b, 2 * dg * k * k, ho, ho, scale=1.5)]
    if modulated:
        arrays.append(1.0 / (1.0 + np.exp(-_n(b, dg * k * k, ho, ho))))
    arrays.append(_n(o, c // g, k, k, scale=0.3))
    if bias:
        arrays.append(_n(o))
    kw = dict(kernel=(k, k), stride=(s, s), pad=(p, p), dilate=(d, d),
              num_filter=o, num_group=g, num_deformable_group=dg,
              no_bias=not bias)
    return [a.astype("f4") for a in arrays], kw


@pytest.mark.parametrize("modulated", [False, True])
@pytest.mark.parametrize("case", sorted(CASES))
def test_op_matches_jax(case, modulated):
    arrays, kw = _inputs(case, modulated)
    name = "_contrib_ModulatedDeformableConvolution" if modulated \
        else "_contrib_DeformableConvolution"
    torch_parity.check(lambda F, *xs: getattr(F, name)(*xs, **kw), arrays,
                       rtol=1e-5, atol=1e-5)


def test_zero_offsets_give_the_plain_convolution():
    arrays, kw = _inputs("3x3_stride2_dilate2", False)
    arrays[1] = np.zeros_like(arrays[1])
    xs = [nd.array(a, ctx=CPU) for a in arrays]
    got = nd.contrib.DeformableConvolution(*xs, **kw).asnumpy()
    conv_kw = {k: v for k, v in kw.items() if k != "num_deformable_group"}
    want = nd.Convolution(xs[0], xs[2], xs[3], **conv_kw).asnumpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def _layer(pkg, **kw):
    return pkg.gluon.contrib.cnn.DeformableConvolution(
        6, kernel_size=3, padding=1, prefix="dc_", **kw)


@pytest.mark.parametrize("kw", [{}, {"activation": "relu", "groups": 2,
                                     "num_deformable_group": 2,
                                     "use_bias": False}])
def test_layer_matches_jax(kw):
    x = _n(2, 4, 7, 7)
    jmx.random.seed(3)
    jnet = _layer(jmx, **kw)
    jnet.initialize(jmx.init.Xavier())
    jnet(jmx.nd.array(x))
    # offsets away from 0, so the sampling is not the plain grid
    off = jnet.offset_conv.weight
    off.set_data(jmx.nd.array(_n(*off.shape, scale=0.2)))
    tnet = _layer(mx, **kw)
    tnet.initialize(mx.init.Xavier(), ctx=CPU)
    tnet(nd.array(x, ctx=CPU))
    params = {k: p.data().asnumpy()
              for k, p in jnet.collect_params().items()}
    assert sorted(tnet.collect_params().keys()) == sorted(params)
    load_jax_gluon_params(tnet, params, jax_prefix="dc_")
    head = _n(2, 6, 7, 7)
    res = []
    for pkg, net in ((jmx, jnet), (mx, tnet)):
        ctx = {"ctx": CPU} if pkg is mx else {}
        xa = pkg.nd.array(x, **ctx)
        xa.attach_grad()
        with pkg.autograd.record():
            out = net(xa)
            loss = (out * pkg.nd.array(head, **ctx)).sum()
        loss.backward()
        res.append((out.asnumpy(), xa.grad.asnumpy(),
                    {k: p.grad().asnumpy()
                     for k, p in net.collect_params().items()}))
    (want, want_gx, want_g), (got, got_gx, got_g) = res
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got_gx, want_gx, rtol=1e-4, atol=1e-5)
    for k, g in want_g.items():
        np.testing.assert_allclose(got_g[k], g, rtol=1e-4, atol=1e-5,
                                   err_msg=k)
    assert tnet.weight.shape == (6, 4 // kw.get("groups", 1), 3, 3)
