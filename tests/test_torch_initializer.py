"""The port's initializers against the JAX package's ``initializer.py``.

The deterministic ones (Zero, One, Constant, Bilinear, LSTMBias, the
name dispatch, Mixed) must give the JAX package's values exactly.  The
random ones draw from a ``torch.Generator`` where the JAX package draws
from numpy, so they are held to their distribution: Orthogonal's rows
orthonormal times ``scale`` (to 1e-5, float32 rounding) in both
packages, Xavier's and MSRAPrelu's sample standard deviation within 3 %
of the fan's (a 512 x 768 draw: the standard error of a sample std is
0.1 %) in both, and Uniform's bound.
"""
import math

import numpy as np
import pytest
import torch

from mxnet_tpu import initializer as jinit
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import initializer as tinit
from mxnet_tpu_torch.base import MXNetError


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def _both(init_j, init_t, name, shape):
    """(JAX values, port values) of one parameter ``name`` of ``shape``."""
    a = np.full(shape, np.nan, "f4")
    init_j(name, a)
    t = torch.full(shape, float("nan"))
    init_t(name, t, _gen())
    return a, t.numpy()


@pytest.mark.parametrize("name", [
    "dense0_bias", "bn_gamma", "bn_beta", "bn_running_mean",
    "bn_running_var", "bn_moving_mean", "bn_moving_var",
    "x_moving_inv_var", "q_moving_avg", "act_min", "act_max"])
def test_name_dispatch_matches_jax(name):
    """Every initializer fills these names with the reference's constant,
    whatever its own rule."""
    for cls in ("Xavier", "Uniform", "Normal", "Orthogonal"):
        a, t = _both(getattr(jinit, cls)(), getattr(tinit, cls)(), name,
                     (4, 6))
        np.testing.assert_array_equal(t, a)


@pytest.mark.parametrize("case", [
    ("zero", {}, (3, 4)), ("zeros", {}, (3, 4)), ("one", {}, (3, 4)),
    ("ones", {}, (5,)), ("constant", {"value": 0.25}, (2, 3)),
    ("constant", {"value": [[1.0, 2.0, 3.0]]}, (2, 3)),
    ("bilinear", {}, (2, 1, 4, 4)), ("bilinear", {}, (3, 1, 5, 5)),
    ("lstmbias", {}, (16,)), ("lstmbias", {"forget_bias": 2.5}, (24,)),
], ids=lambda c: f"{c[0]}-{c[2]}" if isinstance(c, tuple) else None)
def test_deterministic_initializers_match_jax_exactly(case):
    name, kw, shape = case
    a, t = _both(jinit.create(name, **kw), tinit.create(name, **kw),
                 "layer_weight", shape)
    np.testing.assert_array_equal(t, a)


def test_mixed_matches_jax():
    pats = ["conv.*_weight", ".*bias", ".*"]
    mj = jinit.Mixed(pats, [jinit.Constant(3.0), jinit.One(),
                            jinit.Zero()])
    mt = tinit.Mixed(pats, [tinit.Constant(3.0), "one", tinit.Zero()])
    for name in ("conv0_weight", "fc_bias", "fc_weight"):
        a, t = _both(mj, mt, name, (2, 2))
        np.testing.assert_array_equal(t, a)
    with pytest.raises(MXNetError, match="did not match"):
        tinit.Mixed(["conv.*"], [tinit.One()])("fc_weight", torch.zeros(2),
                                               _gen())


def test_registry_create_and_initdesc():
    assert set(jinit._REGISTRY) <= set(tinit._REGISTRY)
    x = tinit.create("xavier", rnd_type="gaussian", factor_type="in",
                     magnitude=2)
    assert (x.rnd_type, x.factor_type, x.magnitude) == ("gaussian", "in",
                                                        2.0)
    assert isinstance(tinit.create(None), tinit.Uniform)
    with pytest.raises(MXNetError, match="unknown initializer"):
        tinit.create("nope")

    @tinit.register
    class Halves(tinit.Initializer):
        def init_weight(self, name, arr, generator):
            arr.fill_(0.5)
    try:
        t = torch.zeros(2, 2)
        tinit.create("halves")("w", t, _gen())
        assert (t == 0.5).all()
    finally:
        del tinit._REGISTRY["halves"]
    d = tinit.InitDesc("fc_weight", attrs={"lr_mult": "2"})
    assert d == "fc_weight" and d.attrs == {"lr_mult": "2"}
    t = torch.zeros(3)
    tinit.One()(tinit.InitDesc("fc_bias"), t, _gen())
    assert (t == 0).all()
    assert mx.init is tinit and mx.init.MSRAPrelu is tinit.MSRAPrelu


@pytest.mark.parametrize("shape", [(6, 10), (10, 6), (4, 3, 2, 2)])
@pytest.mark.parametrize("rand_type", ["uniform", "normal"])
def test_orthogonal_is_orthonormal_in_both(shape, rand_type):
    scale = 1.414
    a, t = _both(jinit.Orthogonal(scale, rand_type),
                 tinit.Orthogonal(scale, rand_type), "w", shape)
    for w in (a, t):
        m = w.reshape(shape[0], -1) / scale
        g = m @ m.T if m.shape[0] <= m.shape[1] else m.T @ m
        np.testing.assert_allclose(g, np.eye(g.shape[0]), atol=1e-5)
    assert not np.allclose(a, t)        # the random streams differ


@pytest.mark.parametrize("rnd_type", ["uniform", "gaussian"])
@pytest.mark.parametrize("factor_type", ["in", "out", "avg"])
def test_xavier_draws_the_fan_scale_in_both(rnd_type, factor_type):
    shape = (512, 768)
    fans = {"in": 768.0, "out": 512.0, "avg": (768.0 + 512.0) / 2}
    scale = math.sqrt(3.0 / fans[factor_type])
    want_std = scale / math.sqrt(3.0) if rnd_type == "uniform" else scale
    a, t = _both(jinit.Xavier(rnd_type, factor_type, 3),
                 tinit.Xavier(rnd_type, factor_type, 3), "w", shape)
    for w in (a, t):
        assert abs(w.std() / want_std - 1.0) < 0.03
        assert abs(w.mean()) < 3 * want_std / math.sqrt(w.size)
        if rnd_type == "uniform":
            assert np.abs(w).max() <= scale
    with pytest.raises(MXNetError, match="factor_type"):
        tinit.Xavier(factor_type="mid")("w", torch.zeros(3, 3), _gen())
    with pytest.raises(MXNetError, match=">=2D"):
        tinit.Xavier()("w", torch.zeros(3), _gen())


def test_msra_prelu_draws_he_scale_in_both():
    shape = (256, 64, 3, 3)
    slope = 0.25
    fan = (64 * 9 + 256 * 9) / 2.0
    want_std = math.sqrt(2.0 / (1.0 + slope ** 2) / fan)
    a, t = _both(jinit.MSRAPrelu(slope=slope), tinit.MSRAPrelu(slope=slope),
                 "conv_weight", shape)
    for w in (a, t):
        assert abs(w.std() / want_std - 1.0) < 0.03


def test_uniform_and_normal_in_both():
    for j, t_, check in (
            (jinit.Uniform(0.2), tinit.Uniform(0.2),
             lambda w: np.abs(w).max() <= 0.2 and abs(w.std() - 0.2 / 3 ** .5)
             < 0.01),
            (jinit.Normal(0.3), tinit.Normal(0.3),
             lambda w: abs(w.std() - 0.3) < 0.01)):
        a, t = _both(j, t_, "w", (300, 300))
        assert check(a) and check(t)


def test_block_initialize_takes_the_new_initializers():
    """A gluon net initialized with Mixed: each parameter by its name, the
    biases by the name dispatch, on the CPU context."""
    from mxnet_tpu_torch.gluon import nn
    net = nn.HybridSequential(prefix="ini_")
    with net.name_scope():
        net.add(nn.Dense(8, in_units=4), nn.Dense(4, in_units=8))
    net.initialize(tinit.Mixed([".*dense0_weight", ".*"],
                               [tinit.Orthogonal(), tinit.Xavier(
                                   rnd_type="gaussian")]), ctx=mx.cpu())
    p = {k.split("_", 1)[1]: v.data().asnumpy()
         for k, v in net.collect_params().items()}
    w0 = p["dense0_weight"] / 1.414
    np.testing.assert_allclose(w0.T @ w0, np.eye(4), atol=1e-5)
    assert (p["dense0_bias"] == 0).all() and (p["dense1_bias"] == 0).all()
    assert p["dense1_weight"].std() > 0
