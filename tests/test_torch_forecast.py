"""The port's GluonTS forecasters (``models/forecast.py``) against the
JAX package's, and the transformer blocks' names.

The reference's loop (``example/forecasting_deepar.py``) is, in both
packages:

    net = DeepAR(C, P, ...); net.initialize(mx.init.Xavier()); net.hybridize()
    trainer = gluon.Trainer(net.collect_params(), "adam", {...})
    with autograd.record(): loss = net(past, future).mean()
    loss.backward(); trainer.step(B)
    paths = net.sample(past, num_samples=...)

Seeded JAX models are carried into the port by gluon name
(``load_jax_gluon_params``), both see the same numpy-made series, and:

* both models' per-series NLL agrees to rtol 1e-5 and every parameter's
  gradient to the float32 tolerance of ``test_utils`` (rtol 1e-4, atol
  1e-5);
* three hybridized Adam steps agree: the losses to rtol 1e-4, each
  weight to 1e-4 in relative L2 (as in ``test_torch_llama_train.py``),
  with one CachedOp entry; then ``forecast()`` to rtol 1e-4, atol 1e-5.
  The attention key biases are the exception: their gradient is zero in
  exact arithmetic (softmax is shift-invariant), so Adam moves them by
  the sign of float32 noise, and they are held to their bound instead
  (each step moves a weight by about lr at most);
* ``sample()`` has the reference's (num_samples, B, P) shape, a seed
  gives the same paths again, and the first step's sample mean lies
  within five standard errors of ``forecast()``'s first step (that
  step's input is the last observation in both);
* ``MultiHeadAttention``, ``PositionwiseFFN``, ``TransformerEncoderCell``
  and ``TransformerEncoder`` are ``HybridBlock``s that take ``prefix=``,
  with the JAX package's ``collect_params()`` names.
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu.gluon.contrib import nn as jcnn
from mxnet_tpu.models import DeepAR as JaxDeepAR
from mxnet_tpu.models import TransformerForecaster as JaxTransformer
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, gluon, nd
from mxnet_tpu_torch.gluon.contrib import nn as cnn
from mxnet_tpu_torch.models import (DeepAR, TransformerForecaster,
                                    load_jax_gluon_params)
from mxnet_tpu_torch.test_utils import assert_almost_equal

CPU = mx.cpu()
C, P, B = 16, 6, 4
LOSS_RTOL = 1e-5
TRAJ_TOL = 1e-4

MODELS = {
    "deepar": (JaxDeepAR, DeepAR, dict(num_cells=8, num_layers=2)),
    "transformer": (JaxTransformer, TransformerForecaster,
                    dict(units=16, hidden_size=32, num_heads=4,
                         enc_layers=2, dec_layers=2)),
}
LR = {"deepar": 1e-2, "transformer": 1e-3}


def _series(seed):
    rng = np.random.RandomState(seed)
    t = np.arange(C + P)[None, :]
    x = (1.0 + 3.0 * rng.rand(B, 1)) * np.sin(2 * np.pi * t / 6.0
                                            + rng.rand(B, 1) * 6.0)
    x = (x + 2.0 + 0.1 * rng.randn(B, C + P)).astype("f4")
    return x[:, :C], x[:, C:]


def _pair(kind, seed=0):
    """A Xavier-initialized JAX model and the port's, the JAX weights
    carried across by gluon name."""
    jcls, tcls, kw = MODELS[kind]
    jmx.random.seed(seed)
    jnet = jcls(C, P, prefix="fc_", **kw)
    jnet.initialize(jmx.init.Xavier())
    past, fut = _series(0)
    jnet(jmx.nd.array(past), jmx.nd.array(fut))    # the deferred shapes
    tnet = tcls(C, P, prefix="fc_", **kw)
    tnet.initialize(mx.init.Xavier(), ctx=CPU)
    assert sorted(tnet.collect_params().keys()) == \
        sorted(jnet.collect_params().keys())
    load_jax_gluon_params(tnet, {k: p.data().asnumpy()
                                 for k, p in jnet.collect_params().items()},
                          jax_prefix="fc_")
    return jnet, tnet


def _arrays(pkg, *xs):
    if pkg is mx:
        return [nd.array(x, ctx=CPU) for x in xs]
    return [pkg.nd.array(x) for x in xs]


@pytest.mark.parametrize("kind", sorted(MODELS))
def test_nll_and_grads_match_jax(kind):
    jnet, tnet = _pair(kind)
    past, fut = _series(1)
    jnet.hybridize()          # one JAX program rather than op by op
    out = {}
    for pkg, net in ((jmx, jnet), (mx, tnet)):
        with pkg.autograd.record():
            nll = net(*_arrays(pkg, past, fut))
            loss = (nll * pkg.nd.array(np.linspace(0.5, 1.5, B)
                                       .astype("f4"),
                                       ctx=nll.context)).sum()
        loss.backward()
        out[pkg] = (nll.asnumpy(), {k: p.grad().asnumpy() for k, p in
                                    net.collect_params().items()})
    assert out[mx][0].shape == (B,)
    np.testing.assert_allclose(out[mx][0], out[jmx][0], rtol=LOSS_RTOL)
    for k, g in out[jmx][1].items():
        assert_almost_equal(out[mx][1][k], g, names=(k, "jax"))


def _loop(pkg, net, past, fut, steps, lr):
    """The reference's loop: hybridize, Adam, record, ``net(...).mean()``,
    backward, step(B).  Returns the losses."""
    net.hybridize()
    tr = pkg.gluon.Trainer(net.collect_params(), "adam",
                           {"learning_rate": lr})
    a, b = _arrays(pkg, past, fut)
    losses = []
    for _ in range(steps):
        with pkg.autograd.record():
            loss = net(a, b).mean()
        loss.backward()
        tr.step(B)
        losses.append(float(loss.asnumpy()))
    return losses


@pytest.mark.parametrize("kind", sorted(MODELS))
def test_three_adam_steps_and_forecast_match_jax(kind):
    jnet, tnet = _pair(kind, seed=1)
    past, fut = _series(2)
    want = _loop(jmx, jnet, past, fut, 3, LR[kind])
    got = _loop(mx, tnet, past, fut, 3, LR[kind])
    np.testing.assert_allclose(got, want, rtol=TRAJ_TOL)
    assert got[-1] < got[0]
    assert len(tnet._cached_op) == 1
    jw = {k: p.data().asnumpy() for k, p in jnet.collect_params().items()}
    for k, p in tnet.collect_params().items():
        w = p.data().asnumpy()
        if k.endswith("_key_bias"):
            # softmax is shift-invariant, so a key bias has no gradient
            # in exact arithmetic; Adam moves it by the sign of float32
            # noise, at most about lr a step in either package
            assert np.abs(w).max() <= 3 * LR[kind] * 1.01, k
            continue
        dist = np.linalg.norm(w - jw[k]) / np.linalg.norm(jw[k])
        assert dist <= TRAJ_TOL, (k, dist)
    j_fc = jnet.forecast(jmx.nd.array(past)).asnumpy()
    t_fc = tnet.forecast(nd.array(past, ctx=CPU)).asnumpy()
    assert t_fc.shape == (B, P)
    assert_almost_equal(t_fc, j_fc)


def test_deepar_sample_shape_seed_and_mean():
    _, tnet = _pair("deepar", seed=2)
    past, _ = _series(3)
    x = nd.array(past, ctx=CPU)
    mx.random.seed(7)
    a = tnet.sample(x, num_samples=2000).asnumpy()
    mx.random.seed(7)
    b = tnet.sample(x, num_samples=2000).asnumpy()
    c = tnet.sample(x, num_samples=2000).asnumpy()
    assert a.shape == (2000, B, P)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
    first = tnet.forecast(x).asnumpy()[:, 0]
    se = a[:, :, 0].std(axis=0) / np.sqrt(a.shape[0])
    assert np.all(np.abs(a[:, :, 0].mean(axis=0) - first) < 5 * se + 1e-6)


def test_deepar_dropout_draws_in_training_only():
    """DeepAR's LSTM dropout (the reference's default 0.1 in GluonTS)
    acts in the recorded training call and not in predict mode."""
    past, fut = _series(4)
    net = DeepAR(C, P, num_cells=8, num_layers=2, dropout=0.5, prefix="dd_")
    ref = DeepAR(C, P, num_cells=8, num_layers=2, prefix="dr_")
    net.initialize(ctx=CPU, seed=3)
    ref.initialize(ctx=CPU, seed=3)
    a, b = _arrays(mx, past, fut)
    np.testing.assert_array_equal(net(a, b).asnumpy(), ref(a, b).asnumpy())
    with autograd.record():
        dropped = net(a, b)
    assert not np.allclose(dropped.asnumpy(), ref(a, b).asnumpy())


# -- the transformer blocks' names ------------------------------------------------

BLOCKS = {
    "multiheadattention": (lambda m: m.MultiHeadAttention(32, 4,
                                                          prefix="att_")),
    "positionwiseffn": (lambda m: m.PositionwiseFFN(32, 64, prefix="ffn_")),
    "encodercell": (lambda m: m.TransformerEncoderCell(32, 64, 4,
                                                       prefix="cell_")),
    "encoder": (lambda m: m.TransformerEncoder(32, 64, 2, 4, prefix="enc_")),
}


@pytest.mark.parametrize("kind", sorted(BLOCKS))
def test_transformer_blocks_are_named_hybrid_blocks(kind):
    """``prefix=`` is taken and ``collect_params()`` names equal the JAX
    package's (which the JAX block has once its deferred shapes are
    known)."""
    jblock = BLOCKS[kind](jcnn)
    tblock = BLOCKS[kind](cnn)
    assert isinstance(tblock, gluon.HybridBlock)
    jblock.initialize()
    jblock(jmx.nd.ones((2, 3, 32)))
    assert list(tblock.collect_params().keys()) == \
        list(jblock.collect_params().keys())
    for name, p in jblock.collect_params().items():
        assert tblock.collect_params()[name].shape == p.shape
