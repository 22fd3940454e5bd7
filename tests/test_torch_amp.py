"""The port's fp16 mixed precision against the JAX package's
``contrib.amp``.

``amp.init("float16")`` with the dynamic ``LossScaler``,
``init_trainer``, ``scale_loss``, ``unscale`` and ``convert_model``:
the reference's own AMP case (``tests/test_contrib_extras.py``), the
scaler's growth and back-off against the reference's ``LossScaler``, and
three steps of the reference's AMP loop (``record`` -> ``scale_loss`` ->
``backward`` -> ``unscale`` -> ``step``) on a tiny BERT with LAMB, from
the same weights and batch, against the JAX package: the losses, loss
scales and skip flags, and every weight.  The JAX side runs its Pallas
flash kernels in interpret mode in float16 (``MXTPU_FLASH_MODE=always``),
the port the plain versions of its kernels' float16 route.  Tolerances
are ``mxnet_tpu/test_utils.py``'s: float16 (1e-2, 1e-2) for what float16
products feed (the losses; the weights in relative L2), float32
(1e-4, 1e-5) for the scaled gradient of a float32 net.
"""
import jax
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import engine as jengine
from mxnet_tpu import gluon as jgluon
from mxnet_tpu import models as jmodels
from mxnet_tpu import nd as jnd
from mxnet_tpu.contrib import amp as jamp
from mxnet_tpu.ops import flash_attention as fa_mod
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import gluon, models, nd
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.contrib import amp
from mxnet_tpu_torch.models.convert import jax_bert_name_to_torch

CPU = mx.cpu()
F16_TOL = 1e-2
V, B, S, M = 96, 2, 128, 4
LR = 1e-2
BERT = dict(vocab_size=V, max_length=S, dropout=0.0, num_layers=2,
            units=64, hidden_size=128, num_heads=2)


@pytest.fixture
def amp_off():
    """Both packages' AMP off again after the test (their state is the
    process's)."""
    yield
    amp._deinit()
    jamp._deinit()


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_scale_loss_and_unscale_match_jax(amp_off, dtype):
    """The reference's case: a Dense under AMP, the loss scaled inside
    ``record``, against the JAX package.  In bfloat16 nothing overflows;
    in float16 the loss is float16, so ``loss * 2^16`` overflows at once
    in both packages, ``unscale`` reports it and halves the scale."""
    w = np.random.RandomState(0).randn(2, 3).astype("f4")

    def run(pkg, gl, ampmod, ctx):
        ampmod.init(dtype)
        net = gl.nn.Dense(2, in_units=3, prefix="amp_")
        net.initialize(ctx=ctx) if ctx is not None else net.initialize()
        net.collect_params()["amp_weight"].set_data(pkg.nd.array(w, ctx=ctx))
        tr = ampmod.init_trainer(gl.Trainer(net.collect_params(), "sgd",
                                            {"learning_rate": 0.1},
                                            kvstore=None))
        x = pkg.nd.ones((2, 3), ctx=ctx) if ctx is not None \
            else pkg.nd.ones((2, 3))
        with pkg.autograd.record():
            y = net(x).sum()
            with ampmod.scale_loss(y, tr) as scaled:
                scaled.backward()
        overflow = ampmod.unscale(tr)
        grad = net.collect_params()["amp_weight"].grad().asnumpy()
        out = overflow, grad, tr._scale, tr._amp_loss_scaler.loss_scale
        ampmod._deinit()
        return out
    with np.errstate(over="ignore"):
        want = run(jmx, jgluon, jamp, None)
    got = run(mx, gluon, amp, CPU)
    assert got[0] == want[0] == (dtype == "float16")
    assert got[2] == want[2] == 2.0 ** -16
    assert got[3] == want[3] == (2.0 ** 15 if got[0] else 2.0 ** 16)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-4, atol=1e-5)


def test_loss_scaler_matches_jax():
    """Growth after ``scale_window`` clean steps, back-off on an
    overflow, the 2^24 ceiling and the floor of 1, step for step against
    the reference's scaler."""
    from mxnet_tpu.contrib.amp import LossScaler as JaxScaler
    good, bad_inf, bad_nan = [1.0, 2.0], [np.inf, 1.0], [np.nan, 0.0]
    steps = [good, good, bad_inf, good, good, good, bad_nan] + [good] * 5
    for init, window in ((2.0 ** 23, 2), (4.0, 3), (2.0 ** 16, 2000)):
        js = JaxScaler(init_scale=init, scale_window=window)
        ts = amp.LossScaler(init_scale=init, scale_window=window)
        for g in steps:
            want = js.has_overflow([jnd.array(g), jnd.ones((3,))])
            got = ts.has_overflow([nd.array(g, ctx=CPU),
                                   nd.ones((3,), ctx=CPU)])
            assert got == want
            assert ts.loss_scale == js.loss_scale
    s = amp.LossScaler(init_scale=4.0, scale_window=1)
    for _ in range(5):
        s.has_overflow([nd.array([np.inf], ctx=CPU)])
    assert s.loss_scale == 1.0
    s = amp.LossScaler(init_scale=2.0 ** 23, scale_window=1)
    for _ in range(3):
        s.has_overflow([nd.array([1.0], ctx=CPU)])
    assert s.loss_scale == 2.0 ** 24
    assert amp.LossScaler().loss_scale == 2.0 ** 16


def test_all_finite_and_casts_match_jax():
    """``all_finite`` (and ``multi_all_finite``), ``amp_cast`` and
    ``amp_multicast`` against the reference's ops."""
    a = np.array([1.0, -2.0], "f4")
    for arrays in ([a], [a, np.array([np.inf], "f4")],
                   [a, np.array([np.nan, 1.0], "f4")]):
        want = jnd.all_finite(*[jnd.array(x) for x in arrays]).asnumpy()
        for op in (nd.all_finite, nd.multi_all_finite):
            got = op(*[nd.array(x, ctx=CPU) for x in arrays])
            assert got.dtype == np.float32 and got.asnumpy() == want
    assert nd.amp_cast(nd.array(a, ctx=CPU), dtype="float16").dtype == \
        jnd.amp_cast(jnd.array(a), dtype="float16").dtype
    for narrow in (False, True):
        want = jnd.amp_multicast(jnd.array(a).astype("float16"),
                                 jnd.array(a), num_outputs=2,
                                 cast_narrow=narrow)
        got = nd.amp_multicast(nd.array(a, ctx=CPU).astype("float16"),
                               nd.array(a, ctx=CPU), num_outputs=2,
                               cast_narrow=narrow)
        assert [g.dtype for g in got] == [w.dtype for w in want]


def test_float16_init_casts_the_target_ops(amp_off):
    """``init("float16")``: the target ops take float16, the others keep
    their types, and cuBLAS's reduced-precision float16 reduction is off
    until ``_deinit``; ``convert_model`` casts a net, BatchNorm staying
    float32."""
    from mxnet_tpu_torch.ops import nn as ops
    matmul = torch.backends.cuda.matmul
    before = matmul.allow_fp16_reduced_precision_reduction
    x = torch.ones(2, 8)
    w = torch.ones(4, 8)
    amp.init(np.float16)
    assert amp.target_dtype() == torch.float16
    assert matmul.allow_fp16_reduced_precision_reduction is False
    assert ops.fully_connected(x, w).dtype == torch.float16
    assert ops.layer_norm(x, torch.ones(8), torch.zeros(8)).dtype == \
        torch.float32
    amp._deinit()
    assert matmul.allow_fp16_reduced_precision_reduction == before
    assert ops.fully_connected(x, w).dtype == torch.float32
    net = gluon.nn.HybridSequential()
    net.add(gluon.nn.Dense(4, in_units=8), gluon.nn.BatchNorm(in_channels=4))
    net.initialize(ctx=CPU)
    assert amp.convert_model(net, "float16") is net
    dtypes = {p.name: p.dtype for p in net.collect_params().values()}
    assert {d for n, d in dtypes.items() if "dense" in n} == {"float16"}
    assert {d for n, d in dtypes.items() if "batchnorm" in n} == \
        {"float32"}
    with pytest.raises(MXNetError, match="amp.init"):
        amp.init_trainer(gluon.Trainer(net.collect_params(), "sgd"))


def _batch():
    rng = np.random.RandomState(0)
    tokens = rng.randint(0, V, (B, S)).astype("f4")
    types = rng.randint(0, 2, (B, S)).astype("f4")
    valid = np.array([S, S - 37], "f4")
    positions = rng.randint(0, S - 37, (B, M)).astype("f4")
    labels = np.concatenate([rng.randint(0, V, (B, M)),
                             rng.randint(0, 2, (B, 1))], 1).astype("f4")
    return (tokens, types, valid, positions), labels


def _amp_loop(pkg, gl, ampmod, net, data, labels, ctx, steps=3):
    """The reference's fp16 AMP loop with LAMB: per step the loss, the
    scale it ran at and whether the step was skipped."""
    sce = gl.loss.SoftmaxCrossEntropyLoss()
    kw = {} if ctx is None else {"ctx": ctx}
    args = [pkg.nd.array(x, **kw) for x in data]
    mlm_label = pkg.nd.array(labels[:, :M].reshape(-1), **kw)
    nsp_label = pkg.nd.array(labels[:, M], **kw)
    tr = gl.Trainer(net.collect_params(), "lamb",
                    {"learning_rate": LR, "wd": 0.01})
    ampmod.init_trainer(tr)
    out = []
    for _ in range(steps):
        scale = tr._amp_loss_scaler.loss_scale
        with pkg.autograd.record():
            mlm, nsp = net(*args)
            loss = sce(mlm, mlm_label).mean() + sce(nsp, nsp_label).mean()
            with ampmod.scale_loss(loss, tr) as scaled:
                scaled.backward()
        skipped = ampmod.unscale(tr)
        if not skipped:
            tr.step(B)
        out.append((float(loss.asnumpy()), scale, bool(skipped)))
    return out


@pytest.fixture
def flash_kernels(monkeypatch):
    monkeypatch.setenv("MXTPU_FLASH_MODE", "always")
    monkeypatch.setattr(fa_mod, "_INTERPRET", True)
    jax.clear_caches()
    jengine.clear_cache()
    yield


def test_bert_amp_loop_with_lamb_matches_jax(flash_kernels, amp_off):
    """Three fp16 AMP-loop steps of a tiny BERT (2 layers, 64 units, key
    padding) with LAMB: losses, scales and skip flags equal the JAX
    package's, the weights within float16's tolerance."""
    data, labels = _batch()
    jamp.init("float16")
    jmx.random.seed(0)
    jnet = jmodels.BERTForPretrain(jmodels.bert_small(**BERT))
    jnet.initialize(jmx.init.Xavier())
    jnet(*[jnd.array(x) for x in data])      # the deferred Dense shapes
    start = {k: p.data().asnumpy()
             for k, p in jnet.collect_params().items()}
    want = _amp_loop(jmx, jgluon, jamp, jnet, data, labels, None)
    want_w = {k: p.data().asnumpy()
              for k, p in jnet.collect_params().items()}

    amp.init("float16")
    net = models.BERTForPretrain(models.bert_small(**BERT))
    net.initialize(mx.init.Xavier(), ctx=CPU)
    models.load_jax_bert_params(net, start)
    got = _amp_loop(mx, gluon, amp, net, data, labels, CPU)
    state = net.state_dict()

    assert [g[1:] for g in got] == [w[1:] for w in want]
    np.testing.assert_allclose([g[0] for g in got], [w[0] for w in want],
                               rtol=F16_TOL, atol=F16_TOL)
    assert not all(g[2] for g in got), "every step overflowed"
    # a tensor that starts at 0 (the biases and betas) takes LAMB's first
    # step with a trust ratio of 1, lr * g / (|g| + epsilon): a gradient
    # element within float16 rounding of 0 (or any element of an
    # attention key bias, whose gradient is 0 in exact arithmetic) can
    # flip its sign between the packages.  Those are held to the step's
    # bound, lr a step; every other tensor, and the whole model, to
    # float16's tolerance in relative L2
    moved, diff, norm = 0, 0.0, 0.0
    for name, w in want_w.items():
        t = state[jax_bert_name_to_torch(name, True)].float().numpy()
        t = t.reshape(w.shape)
        diff += float(np.square(t - w).sum())
        norm += float(np.square(w).sum())
        moved += not np.array_equal(w, start[name])
        if not start[name].any():
            assert np.abs(t).max() <= 3 * LR and np.abs(w).max() <= 3 * LR
            continue
        rel = np.linalg.norm(t - w) / np.linalg.norm(w)
        assert rel <= F16_TOL, (name, rel)
    assert np.sqrt(diff / norm) <= F16_TOL
    assert moved > 0
