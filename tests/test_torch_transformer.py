"""The port's transformer encoder against the JAX package's, and remat.

A JAX ``TransformerEncoder`` under the name BERT gives its encoder
(prefix ``bertmodel0_enc_``) runs once, so its deferred Dense shapes are
set, and its weights are copied by name into the port's.  Both take the
same numpy input and (B, 1, 1, S) key-padding mask: the post-LN (BERT)
and the pre-LN cell agree in output and input gradient to rtol=atol=1e-4
(float32, dropout 0).  ``remat=True`` (``torch.utils.checkpoint``) and
``scan_layers=True`` (run unrolled) give the plain stack's output and
gradients, dropout on, from the same ``mx.random`` seed.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import autograd, nd
from mxnet_tpu.gluon.contrib import nn as jnn
import mxnet_tpu_torch as mx
from mxnet_tpu_torch.gluon import Block
from mxnet_tpu_torch.gluon.contrib.nn import TransformerEncoder
from mxnet_tpu_torch.models.convert import (_copy_by_name,
                                            jax_bert_name_to_torch)

U, HIDDEN, HEADS, LAYERS, B, S = 64, 128, 4, 2, 2, 128
TOL = 1e-4


class _Encoder(Block):
    """The port's encoder under the name ``BERTModel`` gives it."""

    def __init__(self, **kw):
        super().__init__()
        self.encoder = TransformerEncoder(U, HIDDEN, LAYERS, HEADS, **kw)

    def forward(self, x, mask=None):
        return self.encoder(x, mask)


def _inputs():
    rng = np.random.RandomState(0)
    x = rng.randn(B, S, U).astype("f4")
    mask = (np.arange(S)[None, :] < np.array([[90], [128]])).astype("f4")
    return x, mask.reshape(B, 1, 1, S), rng.randn(B, S, U).astype("f4")


@pytest.mark.parametrize("pre_norm", [False, True], ids=["post-ln", "pre-ln"])
def test_encoder_matches_jax(pre_norm):
    x, mask, ct = _inputs()
    jmx.random.seed(0)
    jenc = jnn.TransformerEncoder(U, HIDDEN, LAYERS, HEADS, dropout=0.0,
                                  pre_norm=pre_norm, prefix="bertmodel0_enc_")
    jenc.initialize(jmx.init.Xavier())
    jenc.hybridize()    # compiled whole, not an op at a time
    jx = nd.array(x)
    jx.attach_grad()
    with autograd.record():
        jout = jenc(jx, nd.array(mask))
        jloss = (jout * nd.array(ct)).sum()
    jloss.backward()

    enc = _Encoder(dropout=0.0, pre_norm=pre_norm).initialize(ctx=mx.cpu())
    _copy_by_name(enc, {k: p.data().asnumpy()
                        for k, p in jenc.collect_params().items()},
                  lambda n: jax_bert_name_to_torch(n, pretrain=False))
    tx = torch.from_numpy(x).requires_grad_(True)
    out = enc(tx, torch.from_numpy(mask))
    (out * torch.from_numpy(ct)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), jout.asnumpy(),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tx.grad.numpy(), jx.grad.asnumpy(),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("kw", [dict(remat=True), dict(scan_layers=True),
                                dict(remat=True, scan_layers=True)],
                         ids=["remat", "scan-layers", "both"])
def test_remat_and_scan_layers_match_the_plain_stack(kw):
    """Dropout 0.1 in training mode: the checkpointed recomputation
    replays the forward's dropout draws, so output and every gradient
    equal the plain stack's; the generator ends where the plain stack's
    does."""
    x, mask, ct = _inputs()
    plain = _Encoder(dropout=0.1).initialize(ctx=mx.cpu(), seed=4)
    other = _Encoder(dropout=0.1, **kw).initialize(ctx=mx.cpu(), seed=4)
    results = []
    for net in (plain, other):
        net.train()
        mx.random.seed(11)
        tx = torch.from_numpy(x).requires_grad_(True)
        out = net(tx, torch.from_numpy(mask))
        (out * torch.from_numpy(ct)).sum().backward()
        after = torch.rand(4, generator=mx.random.generator(tx.device))
        results.append((out.detach(), tx.grad,
                        [p.grad for p in net.parameters()], after))
    (o1, g1, p1, a1), (o2, g2, p2, a2) = results
    assert torch.equal(o1, o2) and torch.equal(a1, a2)
    torch.testing.assert_close(g2, g1, rtol=1e-6, atol=1e-6)
    for a, b in zip(p2, p1):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
