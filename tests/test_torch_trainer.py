"""The port's training step against the JAX package's, and AMP.

``DataParallelTrainer.step`` (Adam, lr 1e-3) on ``bert_small`` (2
layers, vocab 200, dropout 0, B=2 x S=128, f32) from the same weights as
the JAX ``DataParallelTrainer(fuse_step=True)`` on a one-device mesh:
the 3-step loss trajectories agree to 1e-4 relative.  The JAX side runs
as ``tests/test_attention_bert.py`` runs it, with its attention on the
Pallas flash kernels in interpret mode (``MXTPU_FLASH_MODE=always``), so
its gradient goes through ``_dq_kernel`` and ``_dkv_kernel``; the
port's runs the plain versions of its kernels.
"""
import jax
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import engine as jengine
from mxnet_tpu import nd
from mxnet_tpu import models as jmodels
from mxnet_tpu import parallel as jparallel
from mxnet_tpu.gluon.block import HybridBlock
from mxnet_tpu.gluon.loss import SoftmaxCrossEntropyLoss as JaxSCE
from mxnet_tpu.ops import attention as jattn
from mxnet_tpu.ops import flash_attention as fa_mod
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import models, parallel
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.contrib import amp
from mxnet_tpu_torch.gluon import Block
from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
from mxnet_tpu_torch.ops import flash_attention as tfa

V, B, S, M = 200, 2, 128, 4
CFG = dict(vocab_size=V, max_length=S, dropout=0.0, num_layers=2)


def _batch():
    rng = np.random.RandomState(0)
    data = (rng.randint(0, V, (B, S)).astype("f"),
            rng.randint(0, 2, (B, S)).astype("f"),
            rng.randint(0, S, (B, M)).astype("f"))
    label = np.concatenate([rng.randint(0, V, (B, M)),
                            rng.randint(0, 2, (B, 1))], 1).astype("f")
    return data, label


class _JaxFull(HybridBlock):
    def __init__(self, mod, **kw):
        super().__init__(**kw)
        with self.name_scope():
            self.mod = mod

    def hybrid_forward(self, F, t, ty, p):
        return self.mod(t, ty, None, p)


class _Full(Block):
    def __init__(self, mod):
        super().__init__()
        self.mod = mod

    def forward(self, t, ty, p):
        return self.mod(t, ty, None, p)


def _loss_fn(sce):
    def loss_fn(outs, label):
        mlm, nsp = outs
        return sce(mlm, label[:, :M].reshape((-1,))).mean() + \
            sce(nsp, label[:, M]).mean()
    return loss_fn


@pytest.fixture
def flash_kernels(monkeypatch):
    monkeypatch.setenv("MXTPU_FLASH_MODE", "always")
    monkeypatch.setattr(fa_mod, "_INTERPRET", True)
    # the JAX package counts a flash dispatch when it traces, so the
    # reference must trace anew: an equal program that another test of
    # this process traced first would otherwise be reused
    jax.clear_caches()
    jengine.clear_cache()
    yield


def test_three_step_trajectory_matches_jax(flash_kernels):
    data, label = _batch()
    jmx.random.seed(0)
    jinner = jmodels.BERTForPretrain(jmodels.bert_small(**CFG))
    jmodel = _JaxFull(jinner)
    jmodel.initialize(jmx.init.Xavier())
    jdata = tuple(nd.array(x) for x in data)
    jmodel(*jdata)                     # sets the deferred Dense shapes
    params = {k: p.data().asnumpy()
              for k, p in jinner.collect_params().items()}
    dpt = jparallel.DataParallelTrainer(
        jmodel, _loss_fn(JaxSCE()), "adam", {"learning_rate": 1e-3},
        mesh=jparallel.make_mesh({"dp": 1}), fuse_step=True)
    before = jattn.flash_dispatch_count()
    want = [float(dpt.step(jdata, nd.array(label)).asnumpy())
            for _ in range(3)]
    assert jattn.flash_dispatch_count() > before

    inner = models.BERTForPretrain(models.bert_small(**CFG))
    model = _Full(inner).initialize(mx.init.Xavier(), ctx=mx.cpu())
    models.load_jax_bert_params(inner, params)
    tdpt = parallel.DataParallelTrainer(
        model, _loss_fn(SoftmaxCrossEntropyLoss()), "adam",
        {"learning_rate": 1e-3},
        mesh=parallel.make_mesh({"dp": 1}, devices=[mx.cpu()]),
        fuse_step=True)
    tfa.flash_fwd_launches = tfa.flash_bwd_launches = 0
    tfa.flash_bwd_dq_tc_launches = 0
    got = [tdpt.step(data, label).item() for _ in range(3)]
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert got[2] < got[0]
    assert tdpt.num_update == 3
    assert tfa.flash_fwd_launches == tfa.flash_bwd_launches == 0   # CPU
    assert tfa.flash_bwd_dq_tc_launches == 0


def test_step_restores_the_training_mode():
    model = models.bert_small(vocab_size=50, max_length=128, num_layers=1,
                              dropout=0.1).initialize(ctx=mx.cpu(), seed=1)
    model.eval()
    rng = np.random.RandomState(2)
    tok = rng.randint(0, 50, (1, 128)).astype("f")
    dpt = parallel.DataParallelTrainer(
        model, lambda outs, label: (outs[1] - label).square().mean(),
        "adam")
    before = [p.detach().clone() for p in model.parameters()]
    dpt.step((tok, np.zeros_like(tok)), np.zeros((1, 256), "f"))
    assert not model.training
    assert all(not torch.equal(a, p) for a, p in
               zip(before, model.parameters()))


def test_trainer_checks():
    model = models.bert_small(vocab_size=50, max_length=128, num_layers=1)
    model.initialize(ctx=mx.cpu())
    with pytest.raises(MXNetError, match="one-device mesh"):
        parallel.make_mesh({"dp": 2}, devices=[mx.cpu(), mx.cpu()])
    with pytest.raises(MXNetError, match="not ported"):
        parallel.DataParallelTrainer(model, None, "lamb")
    with pytest.raises(MXNetError, match="no 'dp' axis"):
        parallel.DataParallelTrainer(
            model, None, "adam",
            mesh=parallel.make_mesh({"tp": 1}, devices=[mx.cpu()]))


def test_amp_casts_only_the_target_ops():
    """init/_deinit round trip: under AMP, FullyConnected, dot and
    dot_product_attention run f32 inputs in bf16 (the attention's
    gradient too); other ops and the f32 residual keep f32; after
    _deinit everything is f32 again."""
    from mxnet_tpu_torch.ops import nn as ops
    from mxnet_tpu_torch.ops.attention import dot_product_attention
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(2, 128, 32).astype("f4"))
    w = torch.from_numpy(rng.randn(16, 32).astype("f4"))
    q = torch.from_numpy(rng.randn(1, 128, 2, 16).astype("f4"))
    q.requires_grad_(True)
    gamma, beta = torch.ones(32), torch.zeros(32)
    assert amp.target_dtype() is None
    amp.init("bfloat16")
    try:
        amp.init("bfloat16")               # a second init is a no-op
        assert amp.target_dtype() == torch.bfloat16
        assert ops.fully_connected(x, w, flatten=False).dtype == \
            torch.bfloat16
        assert ops.dot(x[0], w, transpose_b=True).dtype == torch.bfloat16
        out = dot_product_attention(q, q, q)
        assert out.dtype == torch.bfloat16
        out.float().sum().backward()
        assert q.grad.dtype == torch.float32
        assert ops.layer_norm(x, gamma, beta).dtype == torch.float32
        h = ops.fully_connected(x, w, flatten=False)
        assert ops.layer_norm(h, gamma[:16], beta[:16]).dtype == \
            torch.float32                  # bf16 data, f32 gamma
        assert (x[..., :16] + h).dtype == torch.float32
    finally:
        amp._deinit()
    assert amp.target_dtype() is None
    assert ops.fully_connected(x, w, flatten=False).dtype == torch.float32
    assert dot_product_attention(q, q, q).dtype == torch.float32
    with pytest.raises(MXNetError, match="float16"):
        amp.init("float16")
