"""The port's ``gluon.nn`` layers that came with the GAN slice, and their
ops (``LeakyReLU``, ``gelu_tanh``, ``Deconvolution``, ``InstanceNorm``,
``GroupNorm``, ``LayerNorm``, ``pad``), against the JAX package's.

Each layer is built in both packages under one prefix, its deferred
shapes made by one call, and the JAX weights carried into the port by
name (``load_jax_gluon_params``, which raises on a shape that differs,
so the deferred shapes are checked too).  Then on the same seeded numpy
input both record ``sum(out * head)`` for a fixed numpy ``head`` and
run ``backward``: the outputs, the input's gradient and every
parameter's gradient agree to ``test_utils``' float32 tolerances (rtol
1e-4, atol 1e-5).  A hybridized port layer gives its eager outputs and
gradients.  The ops are held the same way through both registries
(``jax.vjp`` against PyTorch's autograd), over the reference's
Deconvolution cases (groups, dilation, ``adj``, ``target_shape``) and
``pad``'s three modes.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu.gluon import nn as jnn
from mxnet_tpu.ops.registry import get_op as jax_op
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import nd
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon import nn
from mxnet_tpu_torch.models import load_jax_gluon_params
from mxnet_tpu_torch.ops.registry import get_op as port_op

CPU = mx.cpu()
F32 = dict(rtol=1e-4, atol=1e-5)


def _seq(pkg_nn, layers):
    net = pkg_nn.HybridSequential(prefix="l_")
    with net.name_scope():
        net.add(*layers(pkg_nn))
    return net


def _concat(pkg_nn, hybrid):
    cls = pkg_nn.HybridConcatenate if hybrid else pkg_nn.Concatenate
    net = cls(axis=1, prefix="l_")
    with net.name_scope():
        net.add(pkg_nn.Dense(4), pkg_nn.Activation("tanh"),
                pkg_nn.Dense(2, use_bias=False))
    return net


# name -> (make(pkg_nn) -> layer, input shape); every layer's prefix "l_"
LAYERS = {
    # the reference's signature, deferred by default (ROADMAP F9)
    "LayerNorm_deferred": (lambda n: n.LayerNorm(prefix="l_"), (2, 3, 5)),
    "LayerNorm_axis1": (lambda n: n.LayerNorm(
        axis=1, epsilon=1e-3, center=False, gamma_initializer="uniform",
        prefix="l_"), (2, 4, 3, 2)),
    "Conv1DTranspose": (lambda n: n.Conv1DTranspose(
        4, 3, strides=2, padding=1, output_padding=1, prefix="l_"),
        (2, 3, 7)),
    "Conv2DTranspose": (lambda n: n.Conv2DTranspose(
        6, 4, strides=2, padding=1, use_bias=False, prefix="l_"),
        (2, 3, 5, 5)),
    "Conv2DTranspose_groups_dilation": (lambda n: n.Conv2DTranspose(
        6, 3, strides=(2, 1), padding=(1, 2), output_padding=(1, 0),
        dilation=(1, 2), groups=2, in_channels=4, prefix="l_"),
        (2, 4, 5, 6)),
    "Conv2DTranspose_relu": (lambda n: n.Conv2DTranspose(
        5, 2, strides=2, activation="relu", prefix="l_"), (2, 3, 4, 4)),
    "Conv3DTranspose": (lambda n: n.Conv3DTranspose(
        3, 3, strides=2, padding=1, output_padding=1, prefix="l_"),
        (1, 2, 3, 4, 3)),
    "LeakyReLU": (lambda n: n.LeakyReLU(0.2, prefix="l_"), (3, 4, 5)),
    "PReLU": (lambda n: n.PReLU(in_channels=3, prefix="l_"), (2, 3, 4, 4)),
    "PReLU_one_slope": (lambda n: n.PReLU(prefix="l_"), (4, 6)),
    "ELU": (lambda n: n.ELU(alpha=0.7, prefix="l_"), (3, 8)),
    "SELU": (lambda n: n.SELU(prefix="l_"), (3, 8)),
    "Swish": (lambda n: n.Swish(beta=1.5, prefix="l_"), (3, 8)),
    "Swish_beta1": (lambda n: n.Swish(prefix="l_"), (3, 8)),
    "SiLU": (lambda n: n.SiLU(prefix="l_"), (3, 8)),
    "GELU": (lambda n: n.GELU(prefix="l_"), (3, 8)),
    "GELU_tanh": (lambda n: n.GELU(approximation="tanh", prefix="l_"),
                  (3, 8)),
    "MaxPool1D": (lambda n: n.MaxPool1D(3, 2, 1, prefix="l_"), (2, 3, 9)),
    "MaxPool3D": (lambda n: n.MaxPool3D(2, ceil_mode=True, prefix="l_"),
                  (1, 2, 5, 4, 5)),
    "AvgPool1D": (lambda n: n.AvgPool1D(3, 2, 1, count_include_pad=False,
                                        prefix="l_"), (2, 3, 9)),
    "AvgPool3D": (lambda n: n.AvgPool3D(2, padding=1, prefix="l_"),
                  (1, 2, 4, 5, 4)),
    "GlobalMaxPool1D": (lambda n: n.GlobalMaxPool1D(prefix="l_"),
                        (2, 3, 7)),
    "GlobalMaxPool2D": (lambda n: n.GlobalMaxPool2D(prefix="l_"),
                        (2, 3, 5, 6)),
    "GlobalMaxPool3D": (lambda n: n.GlobalMaxPool3D(prefix="l_"),
                        (1, 2, 3, 4, 5)),
    "GlobalAvgPool1D": (lambda n: n.GlobalAvgPool1D(prefix="l_"),
                        (2, 3, 7)),
    "GlobalAvgPool3D": (lambda n: n.GlobalAvgPool3D(prefix="l_"),
                        (1, 2, 3, 4, 5)),
    "InstanceNorm": (lambda n: n.InstanceNorm(prefix="l_"), (2, 3, 4, 5)),
    "InstanceNorm_scale": (lambda n: n.InstanceNorm(scale=True,
                                                    prefix="l_"), (2, 3, 6)),
    "GroupNorm": (lambda n: n.GroupNorm(num_groups=2, prefix="l_"),
                  (2, 4, 3, 3)),
    "Identity": (lambda n: n.Identity(prefix="l_"), (3, 4)),
    "Lambda": (lambda n: n.Lambda("tanh", prefix="l_"), (3, 4)),
    "Lambda_callable": (lambda n: n.Lambda(lambda x: x * x + 1.0,
                                           prefix="l_"), (3, 4)),
    "HybridLambda": (lambda n: n.HybridLambda(
        lambda F, x: F.relu(x) * 2.0 + F.sigmoid(x), prefix="l_"), (3, 4)),
    "HybridLambda_name": (lambda n: n.HybridLambda("softsign",
                                                   prefix="l_"), (3, 4)),
    "Concatenate": (lambda n: _concat(n, False), (3, 5)),
    "HybridConcatenate": (lambda n: _concat(n, True), (3, 5)),
    "ReflectionPad2D": (lambda n: n.ReflectionPad2D(2, prefix="l_"),
                        (2, 3, 5, 6)),
    "ReflectionPad2D_tuple": (lambda n: n.ReflectionPad2D(
        (0, 0, 0, 0, 1, 2, 0, 3), prefix="l_"), (2, 3, 5, 6)),
    "gan_generator_block": (lambda n: _seq(n, lambda m: (
        m.Conv2DTranspose(8, 4, 1, 0, use_bias=False), m.BatchNorm(),
        m.Activation("relu"), m.Conv2DTranspose(3, 4, 2, 1,
                                                use_bias=False),
        m.Activation("tanh"))), (2, 6, 1, 1)),
}

#: the 27 layers the GAN slice added, each among the cases above
NEW_LAYERS = ["Conv1DTranspose", "Conv2DTranspose", "Conv3DTranspose",
              "LeakyReLU", "PReLU", "ELU", "SELU", "Swish", "SiLU", "GELU",
              "MaxPool1D", "MaxPool3D", "AvgPool1D", "AvgPool3D",
              "GlobalMaxPool1D", "GlobalMaxPool2D", "GlobalMaxPool3D",
              "GlobalAvgPool1D", "GlobalAvgPool3D", "InstanceNorm",
              "GroupNorm", "Identity", "Lambda", "HybridLambda",
              "Concatenate", "HybridConcatenate", "ReflectionPad2D"]


def _data(shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype("f4")


def _pair(case):
    """The JAX layer and the port's, with the JAX weights (Xavier,
    seeded) carried across after each made its deferred shapes."""
    make, shape = LAYERS[case]
    jmx.random.seed(3)
    jnet = make(jnn)
    jnet.initialize(jmx.init.Xavier())
    x = _data(shape, 1)
    jnet(jmx.nd.array(x))
    tnet = make(nn)
    tnet.initialize(mx.init.Xavier(), ctx=CPU)
    tnet(nd.array(x, ctx=CPU))
    params = {k: p.data().asnumpy() for k, p in
              jnet.collect_params().items()}
    assert sorted(tnet.collect_params().keys()) == sorted(params)
    if params:
        load_jax_gluon_params(tnet, params, jax_prefix="l_")
    return jnet, tnet


def _run(pkg, net, x, head):
    """(output, input gradient, {param: gradient}) of sum(out * head)."""
    kw = {"ctx": CPU} if pkg is mx else {}
    xa = pkg.nd.array(x, **kw)
    xa.attach_grad()
    with pkg.autograd.record():
        out = net(xa)
        loss = (out * pkg.nd.array(head, **kw)).sum()
    loss.backward()
    grads = {k: p.grad().asnumpy() for k, p in net.collect_params().items()
             if p.grad_req != "null"}
    return out.asnumpy(), xa.grad.asnumpy(), grads


@pytest.mark.parametrize("case", sorted(LAYERS))
def test_layer_matches_jax(case):
    jnet, tnet = _pair(case)
    x = _data(LAYERS[case][1], 2)
    out = jnet(jmx.nd.array(x)).asnumpy()
    head = _data(out.shape, 5)
    want, want_gx, want_g = _run(jmx, jnet, x, head)
    got, got_gx, got_g = _run(mx, tnet, x, head)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **F32)
    np.testing.assert_allclose(got_gx, want_gx, **F32)
    assert sorted(got_g) == sorted(want_g)
    for k, g in want_g.items():
        np.testing.assert_allclose(got_g[k], g, err_msg=k, **F32)


@pytest.mark.parametrize("case", sorted(LAYERS))
def test_hybridized_layer_equals_eager(case):
    _, tnet = _pair(case)
    x = _data(LAYERS[case][1], 4)
    out = tnet(nd.array(x, ctx=CPU)).asnumpy()
    head = _data(out.shape, 6)
    eager = _run(mx, tnet, x, head)
    if isinstance(tnet, mx.gluon.HybridBlock):
        tnet.hybridize()
    for _ in range(2):
        got = _run(mx, tnet, x, head)
        np.testing.assert_array_equal(got[0], eager[0])
        np.testing.assert_array_equal(got[1], eager[1])
        for k, g in eager[2].items():
            np.testing.assert_array_equal(got[2][k], g)


def test_every_reference_name_is_exported():
    assert set(jnn.__all__) <= set(dir(nn))
    assert sorted(nn.__all__) == sorted(jnn.__all__)
    assert set(NEW_LAYERS) <= set(LAYERS)


@pytest.mark.parametrize("cls,shape,want", [
    ("Conv2DTranspose", (2, 5, 3, 3), (5, 6, 4, 4)),
    ("Conv1DTranspose", (2, 4, 7), (4, 2, 3)),
    ("InstanceNorm", (2, 7, 3, 3), (7,)),
])
def test_deferred_shapes_come_from_the_first_call(cls, shape, want):
    kw = {"InstanceNorm": {}, "Conv1DTranspose": dict(channels=4,
                                                      kernel_size=3,
                                                      groups=2),
          "Conv2DTranspose": dict(channels=6, kernel_size=4)}[cls]
    layer = getattr(nn, cls)(**kw)
    layer.initialize(ctx=CPU)
    first = next(iter(layer.collect_params().values()))
    assert 0 in first.shape
    with pytest.raises(MXNetError, match="deferred"):
        first.data()
    layer(nd.array(_data(shape), ctx=CPU))
    assert first.shape == want
    jlayer = getattr(jnn, cls)(**kw)
    jlayer.initialize()
    jlayer(jmx.nd.array(_data(shape)))
    assert next(iter(jlayer.collect_params().values())).shape == want


def test_instance_norm_gamma_takes_no_gradient_by_default():
    layer = nn.InstanceNorm()
    layer.initialize(ctx=CPU)
    layer(nd.array(_data((2, 3, 4)), ctx=CPU))
    assert layer.collect_params()[layer.prefix + "gamma"].grad_req == "null"
    assert layer.collect_params()[layer.prefix + "beta"].grad_req == "write"


def test_prelu_alpha_defaults_to_a_quarter():
    layer = nn.PReLU(in_channels=3)
    layer.initialize(mx.init.Xavier(), ctx=CPU)
    alpha = layer.collect_params()[layer.prefix + "alpha"].data().asnumpy()
    np.testing.assert_array_equal(alpha, np.full(3, 0.25, "f4"))


def test_leaky_relu_rejects_a_negative_slope():
    with pytest.raises(AssertionError):
        nn.LeakyReLU(-0.1)


# -- the ops -------------------------------------------------------------------

def _head(shape, seed=9):
    return np.random.RandomState(seed).uniform(-1, 1, shape).astype("f4")


def _jax_run(name, arrays, attrs, diff):
    fn = jax_op(name).fcompute

    def f(*xs):
        it = iter(xs)
        return fn(*[jnp.asarray(next(it)) if d else jnp.asarray(a)
                    for a, d in zip(arrays, diff)], **attrs)
    @jax.jit          # the op and its gradient in one compiled program
    def run(*primals):
        out, vjp = jax.vjp(f, *primals)
        return out, vjp(jnp.asarray(_head(out.shape)))
    out, grads = run(*[a for a, d in zip(arrays, diff) if d])
    return np.asarray(out), [np.asarray(g) for g in grads]


def _port_run(name, arrays, attrs, diff):
    ts = [torch.from_numpy(np.ascontiguousarray(a)).requires_grad_(d)
          for a, d in zip(arrays, diff)]
    out = port_op(name).fcompute(*ts, **attrs)
    grads = torch.autograd.grad(out, [t for t in ts if t.requires_grad],
                                torch.from_numpy(_head(tuple(out.shape))))
    return out.detach().numpy(), [g.numpy() for g in grads]


def _check(name, arrays, attrs, diff=None):
    diff = diff or [True] * len(arrays)
    want, want_g = _jax_run(name, arrays, attrs, diff)
    got, got_g = _port_run(name, arrays, attrs, diff)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **F32)
    for g, w in zip(got_g, want_g):
        np.testing.assert_allclose(g, w, **F32)
    return got


# (data shape, weight shape, attrs); the reference's own cases
# (tests/test_gluon.py) first
DECONV_CASES = {
    "grad_of_conv": ((2, 3, 8, 8), (3, 5, 4, 4),
                     dict(kernel=(4, 4), stride=(2, 2), pad=(1, 1))),
    "grad_of_conv_groups": ((2, 4, 8, 8), (4, 3, 4, 4),
                            dict(kernel=(4, 4), stride=(2, 2), pad=(1, 1),
                                 num_group=2)),
    "target_shape": ((1, 3, 8, 8), (3, 5, 4, 4),
                     dict(kernel=(4, 4), stride=(2, 2),
                          target_shape=(16, 16))),
    "target_shape_odd_total": ((1, 3, 4, 4), (3, 5, 3, 3),
                               dict(kernel=(3, 3), stride=(2, 2),
                                    target_shape=(8, 9))),
    "adj": ((2, 3, 5, 5), (3, 4, 3, 3),
            dict(kernel=(3, 3), stride=(3, 2), pad=(1, 1), adj=(2, 1))),
    "adj_beyond_pad": ((2, 3, 4, 4), (3, 4, 3, 3),
                       dict(kernel=(3, 3), stride=(2, 2), adj=(1, 1))),
    "dilation_bias": ((2, 4, 6, 5), (4, 2, 3, 2),
                      dict(kernel=(3, 2), stride=(1, 2), dilate=(2, 3),
                           pad=(2, 1), no_bias=False)),
    "1d_groups_bias": ((2, 6, 9), (6, 2, 4),
                       dict(kernel=(4,), stride=(2,), pad=(1,),
                            num_group=3, no_bias=False)),
    "3d": ((1, 2, 3, 4, 3), (2, 3, 3, 3, 3),
           dict(kernel=(3, 3, 3), stride=(2, 2, 2), pad=(1, 1, 1),
                adj=(1, 0, 1))),
    "dcgan_first": ((4, 16, 1, 1), (16, 32, 4, 4),
                    dict(kernel=(4, 4), stride=(1, 1), pad=(0, 0))),
}


@pytest.mark.parametrize("case", sorted(DECONV_CASES))
def test_deconvolution_matches_jax(case):
    dshape, wshape, attrs = DECONV_CASES[case]
    rng = np.random.RandomState(0)
    arrays = [rng.randn(*dshape).astype("f4"),
              (rng.randn(*wshape) * 0.3).astype("f4")]
    if not attrs.get("no_bias", True):
        arrays.append(rng.randn(wshape[1] * attrs.get("num_group", 1))
                      .astype("f4"))
    got = _check("Deconvolution", arrays, attrs)
    if "target_shape" in attrs:
        assert got.shape[2:] == attrs["target_shape"]


def test_deconvolution_target_shape_is_the_cropped_full_output():
    rng = np.random.RandomState(7)
    x = nd.array(rng.randn(1, 3, 4, 4).astype("f4"), ctx=CPU)
    w = nd.array(rng.randn(3, 5, 3, 3).astype("f4"), ctx=CPU)
    out = nd.Deconvolution(x, w, kernel=(3, 3), stride=(2, 2),
                           num_filter=5, target_shape=(8, 9))
    full = nd.Deconvolution(x, w, kernel=(3, 3), stride=(2, 2),
                            num_filter=5)
    assert full.shape == (1, 5, 9, 9)
    np.testing.assert_array_equal(out.asnumpy(),
                                  full.asnumpy()[:, :, 1:9, :])


@pytest.mark.parametrize("bad", ["adj", "target_shape"])
def test_deconvolution_raises_as_the_reference(bad):
    x = nd.array(_data((1, 3, 4, 4)), ctx=CPU)
    w = nd.array(_data((3, 5, 4, 4)), ctx=CPU)
    kw = dict(adj=(2, 2)) if bad == "adj" else dict(target_shape=(20, 20))
    with pytest.raises(ValueError, match=bad if bad == "adj" else "total"):
        nd.Deconvolution(x, w, kernel=(4, 4), stride=(2, 2), num_filter=5,
                         **kw)


LEAKY_CASES = {
    "leaky": dict(act_type="leaky", slope=0.1),
    "elu": dict(act_type="elu", slope=0.8),
    "selu": dict(act_type="selu"),
    "gelu": dict(act_type="gelu"),
    "rrelu": dict(act_type="rrelu", lower_bound=0.1, upper_bound=0.3),
}


@pytest.mark.parametrize("case", sorted(LEAKY_CASES) + ["prelu_channels",
                                                        "prelu_one"])
def test_leaky_relu_op_matches_jax(case):
    x = _data((2, 3, 4, 5)) * 2
    if case.startswith("prelu"):
        n = 3 if case == "prelu_channels" else 1
        gamma = np.linspace(0.1, 0.4, n).astype("f4")
        _check("LeakyReLU", [x, gamma], dict(act_type="prelu"))
    else:
        _check("LeakyReLU", [x], LEAKY_CASES[case])


def test_gelu_tanh_matches_jax():
    _check("gelu_tanh", [_data((4, 7)) * 3], {})


@pytest.mark.parametrize("case", ["instance", "instance_eps", "group",
                                  "group_3d", "layer_last", "layer_axis1"])
def test_norm_ops_match_jax(case):
    rng = np.random.RandomState(3)
    if case.startswith("instance"):
        x = rng.randn(2, 3, 4, 5).astype("f4")
        g, b = rng.randn(3).astype("f4"), rng.randn(3).astype("f4")
        attrs = {} if case == "instance" else dict(eps=1e-5)
        _check("InstanceNorm", [x, g, b], attrs)
    elif case.startswith("group"):
        x = rng.randn(2, 6, 4, 3).astype("f4") if case == "group" else \
            rng.randn(2, 4, 3, 2, 2).astype("f4")
        groups = 3 if case == "group" else 2
        g = rng.randn(groups).astype("f4")
        b = rng.randn(groups).astype("f4")
        _check("GroupNorm", [x, g, b], dict(num_groups=groups, eps=1e-5))
    else:
        x = rng.randn(2, 5, 6).astype("f4")
        axis = -1 if case == "layer_last" else 1
        n = x.shape[axis]
        g, b = rng.randn(n).astype("f4"), rng.randn(n).astype("f4")
        _check("LayerNorm", [x, g, b], dict(axis=axis, eps=1e-5))


PAD_CASES = {
    "constant": ((2, 3, 4), dict(mode="constant", constant_value=1.5,
                                 pad_width=(1, 0, 0, 2, 3, 1))),
    "edge": ((2, 3, 4, 5), dict(mode="edge",
                                pad_width=(0, 0, 0, 0, 2, 1, 1, 3))),
    "edge_last_axis": ((2, 3, 5), dict(mode="edge",
                                       pad_width=(0, 0, 0, 0, 2, 3))),
    "reflect": ((2, 3, 5, 6), dict(mode="reflect",
                                   pad_width=(0, 0, 0, 0, 1, 2, 3, 1))),
    "reflect_3_axes": ((2, 4, 5, 6), dict(mode="reflect",
                                          pad_width=(0, 0, 1, 1, 2, 0,
                                                     0, 3))),
}


@pytest.mark.parametrize("case", sorted(PAD_CASES))
def test_pad_matches_jax(case):
    shape, attrs = PAD_CASES[case]
    _check("pad", [_data(shape)], attrs)


def test_pad_reflect_of_a_leading_axis_raises():
    with pytest.raises(MXNetError, match="last three"):
        nd.pad(nd.array(_data((2, 3, 4, 5)), ctx=CPU), mode="reflect",
               pad_width=(1, 1, 1, 1, 1, 1, 1, 1))


def test_new_ops_are_nd_functions():
    for name in ("LeakyReLU", "Deconvolution", "InstanceNorm", "GroupNorm",
                 "LayerNorm", "pad", "Pad", "gelu_tanh"):
        assert callable(getattr(nd, name)), name
    x = nd.array(_data((2, 3)), ctx=CPU)
    np.testing.assert_allclose(
        nd.LeakyReLU(x, act_type="leaky", slope=0.3).asnumpy(),
        jmx.nd.LeakyReLU(jmx.nd.array(x.asnumpy()), act_type="leaky",
                         slope=0.3).asnumpy(), **F32)
