"""The port's BERT against the JAX package's, with the same weights.

A seeded JAX ``bert_small`` (2 layers, vocab 200, f32, dropout 0) runs
one forward, so its deferred Dense shapes are set, and is copied into
the port with ``load_jax_bert_params``.  Both then see the same
numpy-made batch (B=2, S=128).  Outputs and the gradient of every
parameter agree to rtol=atol=1e-4 in float32 (the frameworks sum in
other orders).  The JAX model's attention runs its XLA path here; the
port's runs the flash kernels' plain versions (S=128 is aligned).
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import autograd, nd
from mxnet_tpu import models as jmodels
from mxnet_tpu.gluon.loss import SoftmaxCrossEntropyLoss as JaxSCE
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import models
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
from mxnet_tpu_torch.models import load_jax_bert_params
from mxnet_tpu_torch.models.convert import jax_bert_name_to_torch

V, B, S, M = 200, 2, 128, 4
TOL = 1e-4
CFG = dict(vocab_size=V, max_length=S, dropout=0.0, num_layers=2)


def _batch(seed=0):
    rng = np.random.RandomState(seed)
    return dict(tokens=rng.randint(0, V, (B, S)).astype("f4"),
                types=rng.randint(0, 2, (B, S)).astype("f4"),
                valid=np.array([100.0, 128.0], "f4"),
                positions=rng.randint(0, S, (B, M)).astype("f4"),
                labels=rng.randint(0, V, (B * M,)).astype("f4"),
                nsp=rng.randint(0, 2, (B,)).astype("f4"))


def _jax_model(pretrain, decode_mlm=True):
    jmx.random.seed(0)
    bert = jmodels.bert_small(**CFG)
    net = jmodels.BERTForPretrain(bert, decode_mlm=decode_mlm) \
        if pretrain else bert
    net.initialize(jmx.init.Xavier())
    x = _batch()
    if pretrain:
        net(nd.array(x["tokens"]), nd.array(x["types"]), None,
            nd.array(x["positions"]))
    else:
        net(nd.array(x["tokens"]), nd.array(x["types"]))
    net.hybridize()     # its calls compile whole, not an op at a time
    return net


def _port_model(jnet, pretrain, decode_mlm=True):
    bert = models.bert_small(**CFG)
    net = models.BERTForPretrain(bert, decode_mlm=decode_mlm) \
        if pretrain else bert
    net.initialize(mx.init.Xavier(), ctx=mx.cpu())
    load_jax_bert_params(net, {k: p.data().asnumpy()
                               for k, p in jnet.collect_params().items()})
    return net


def _close(got, want, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=TOL, atol=TOL, err_msg=msg)


def _check_grads(jnet, net, pretrain):
    own = dict(net.named_parameters())
    n = 0
    for name, p in jnet.collect_params().items():
        tname = jax_bert_name_to_torch(name, pretrain)
        _close(own[tname].grad.numpy(), p.grad().asnumpy(), name)
        n += 1
    assert n == len(own)


@pytest.mark.parametrize("with_len", [False, True],
                         ids=["full-length", "valid-length"])
def test_bert_model_forward_and_grads(with_len):
    """BERTModel: seq and pooled outputs, and the gradient of every
    parameter for a random linear read-out of both."""
    jnet = _jax_model(pretrain=False)
    net = _port_model(jnet, pretrain=False)
    x = _batch()
    rng = np.random.RandomState(5)
    r_seq = rng.randn(B, S, 256).astype("f4")
    r_pool = rng.randn(B, 256).astype("f4")
    jvl = nd.array(x["valid"]) if with_len else None
    with autograd.record():
        jseq, jpool = jnet(nd.array(x["tokens"]), nd.array(x["types"]), jvl)
        jloss = (jseq * nd.array(r_seq)).sum() + \
            (jpool * nd.array(r_pool)).sum()
    jloss.backward()
    tvl = torch.from_numpy(x["valid"]) if with_len else None
    seq, pooled = net(torch.from_numpy(x["tokens"]),
                      torch.from_numpy(x["types"]), tvl)
    loss = (seq * torch.from_numpy(r_seq)).sum() + \
        (pooled * torch.from_numpy(r_pool)).sum()
    loss.backward()
    _close(seq.detach().numpy(), jseq.asnumpy(), "seq")
    _close(pooled.detach().numpy(), jpool.asnumpy(), "pooled")
    _check_grads(jnet, net, pretrain=False)


def test_bert_for_pretrain_loss_and_grads():
    """BERTForPretrain (decoded MLM): scores, the pretraining loss and
    every parameter's gradient, the tied word embedding included."""
    jnet = _jax_model(pretrain=True)
    net = _port_model(jnet, pretrain=True)
    x = _batch()
    jsce = JaxSCE()
    with autograd.record():
        jmlm, jnsp = jnet(nd.array(x["tokens"]), nd.array(x["types"]),
                          nd.array(x["valid"]), nd.array(x["positions"]))
        jloss = jsce(jmlm, nd.array(x["labels"])).mean() + \
            jsce(jnsp, nd.array(x["nsp"])).mean()
    jloss.backward()
    sce = SoftmaxCrossEntropyLoss()
    mlm, nsp = net(*(torch.from_numpy(x[k]) for k in
                     ("tokens", "types", "valid", "positions")))
    loss = sce(mlm, torch.from_numpy(x["labels"])).mean() + \
        sce(nsp, torch.from_numpy(x["nsp"])).mean()
    loss.backward()
    assert mlm.shape == (B * M, V) and nsp.shape == (B, 2)
    _close(mlm.detach().numpy(), jmlm.asnumpy(), "mlm")
    _close(nsp.detach().numpy(), jnsp.asnumpy(), "nsp")
    _close(loss.item(), float(jloss.asnumpy()), "loss")
    _check_grads(jnet, net, pretrain=True)


def test_bert_for_pretrain_undecoded_mlm():
    """decode_mlm=False returns (hidden, nsp, tied weight, bias)."""
    jnet = _jax_model(pretrain=True, decode_mlm=False)
    net = _port_model(jnet, pretrain=True, decode_mlm=False)
    x = _batch(seed=1)
    want = jnet(nd.array(x["tokens"]), nd.array(x["types"]), None,
                nd.array(x["positions"]))
    with torch.no_grad():
        got = net(torch.from_numpy(x["tokens"]),
                  torch.from_numpy(x["types"]), None,
                  torch.from_numpy(x["positions"]))
    assert len(got) == len(want) == 4
    assert got[2] is net.bert.word_embed._tensor("weight")
    for name, a, w in zip(("hidden", "nsp", "word_w", "bias"), got, want):
        _close(a.detach().numpy(), w.asnumpy(), name)


@pytest.mark.parametrize("defect", ["unknown-name", "missing",
                                    "wrong-shape", "pretrain-name"])
def test_load_jax_bert_params_raises(defect):
    params = {k: p.data().asnumpy()
              for k, p in _jax_model(pretrain=True).collect_params().items()}
    target = models.BERTForPretrain(models.bert_small(**CFG))
    key = next(k for k in params if k.endswith("layer1_layernorm1_gamma"))
    if defect == "unknown-name":
        params["bertmodel0_enc_layer0_attention_weight"] = np.zeros(3)
        match = "unrecognised BERT parameter"
    elif defect == "missing":
        del params[key]
        match = "missing"
    elif defect == "wrong-shape":
        params[key] = params[key][:-1]
        match = "shape"
    else:
        # a BERTModel has no pretraining heads
        target = models.bert_small(**CFG)
        params = {k: v for k, v in params.items()
                  if k.startswith("bertforpretrain")}
        match = "unrecognised BERT parameter"
    target.initialize(ctx=mx.cpu())
    with pytest.raises(MXNetError, match=match):
        load_jax_bert_params(target, params)


def test_bert_configs_and_unknown_name():
    base = models.bert_base()
    assert len(base.encoder.layers) == 12 and base._units == 768
    n = sum(p.numel() for p in models.BERTForPretrain(base).parameters())
    assert 105e6 < n < 115e6                           # ~110 M
    assert len(models.bert_large().encoder.layers) == 24
    with pytest.raises(MXNetError, match="unknown bert config"):
        models.get_bert("bert_huge")


def test_initialize_draws_on_the_context():
    """Xavier for weights, the parameter's own initializer where it has
    one (position_embed normal, mlm_bias zeros), gamma ones, bias zeros;
    the same seed draws the same weights."""
    a = models.BERTForPretrain(models.bert_small(**CFG)).initialize(
        mx.init.Xavier(), ctx=mx.cpu(), seed=3)
    b = models.BERTForPretrain(models.bert_small(**CFG)).initialize(
        mx.init.Xavier(), ctx=mx.cpu(), seed=3)
    for (n, p), (_, q) in zip(a.named_parameters(), b.named_parameters()):
        assert p.device.type == "cpu" and torch.equal(p, q), n
    bert = a.bert
    w = bert.encoder.layers[0].ffn.ffn_1._tensor("weight")
    bound = np.sqrt(3.0 / ((256 + 1024) / 2.0))
    assert w.abs().max() <= bound and w.abs().max() > 0.9 * bound
    assert 0.005 < bert._tensor("position_embed").std().item() < 0.015
    assert torch.all(a._tensor("mlm_bias") == 0)
    assert torch.all(bert.embed_layer_norm._tensor("gamma") == 1)
    assert torch.all(bert.pooler._tensor("bias") == 0)
