"""The port's decoder-LM training against the JAX package's.

The reference's Llama training script (``tests/test_llama.py``
``test_training_converges_hybridized``) is, in both packages:

    net = LlamaForCausalLM(get_llama(...)); net.initialize(mx.init.Xavier())
    net.hybridize()
    trainer = gluon.Trainer(net.collect_params(), "adam", {...})
    with autograd.record(): loss = net.loss(tokens)
    loss.backward(); trainer.step(B)

Here a seeded JAX model's ``collect_params()`` arrays are carried into
the port by name (``load_jax_gluon_params``), both see the same
numpy-made tokens, and:

* ``chunked_softmax_ce`` and ``chunked_softmax_ce_bias`` agree with the
  JAX op in value (rtol 1e-5) and every gradient (rtol 2e-4, atol 1e-5,
  the reference's own tolerances, ``tests/test_llama.py``), with padded
  slabs (V=97 at chunk 32 and 40) and without (V=96 at 32, one slab);
  the backward saves no (N, V) tensor;
* ``LlamaForCausalLM.loss`` agrees with the JAX ``loss`` (value and every
  parameter's gradient) for ``llama_tiny``, ``mistral_tiny`` and the
  untied head, with full logits and chunked, and V >= 32768 takes the
  chunked route by default;
* three hybridized Adam steps agree: the losses to rtol 1e-4 and each
  weight tensor to 1e-4 in relative L2 distance (Adam divides each
  update by the gradient's own running size, so an element whose
  gradient is mostly cancellation moves by float32 noise times the
  learning rate: element by element a few weights of ten thousand
  differ by 3e-4 of the largest at lr 1e-2); under
  ``amp.init("bfloat16")``, at the same lr 1e-2, the losses within the
  bfloat16 tolerance of ``test_utils`` (rtol = atol = 1e-2) and each
  tensor's change over the three steps within 0.25 of the JAX change's
  size in relative L2: the same division scales bfloat16's rounding of
  each gradient, so the changes part by at most 0.13 (the final norm's
  gamma; 0.06 at the median) in the full loss and 0.08 in the chunked
  one, where a port that stepped at half the learning rate parts by
  0.5 in every tensor, and one that did not step at all by 1;
* the port's own loop converges as the reference's test asks (the loss
  falls by more than 1.0 in 50 steps).

Everything runs on the CPU: the port's attention takes its plain
versions, the JAX package its XLA path.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu.contrib import amp as jamp
from mxnet_tpu.models import LlamaForCausalLM as JaxLM
from mxnet_tpu.models import get_llama as jax_get_llama
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, gluon, nd
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.contrib import amp
from mxnet_tpu_torch.models import LlamaForCausalLM, get_llama, \
    load_jax_gluon_params
from mxnet_tpu_torch.ops import nn as ops

import torch_parity

CPU = mx.cpu()
V = 61
LOSS_RTOL = 1e-5
GRAD_TOL = dict(rtol=2e-4, atol=1e-5)
TRAJ_TOL = 1e-4
BF16_TOL = dict(rtol=1e-2, atol=1e-2)
BF16_STEP_TOL = 0.25


def _tokens(b, s, seed, v=V):
    return np.random.RandomState(seed).randint(0, v, (b, s)).astype("f4")


def _pair(name="llama_tiny", tied=True, v=V, seed=0):
    """A Xavier-initialized JAX LM and the port's, with the JAX
    weights carried across by gluon name."""
    jmx.random.seed(seed)
    jlm = JaxLM(jax_get_llama(name, vocab_size=v), tie_embeddings=tied)
    jlm.initialize(jmx.init.Xavier())
    lm = LlamaForCausalLM(get_llama(name, vocab_size=v),
                          tie_embeddings=tied, ctx=CPU)
    load_jax_gluon_params(lm, {k: p.data().asnumpy()
                               for k, p in jlm.collect_params().items()})
    return jlm, lm


def _by_suffix(params, fn):
    """{name without its block number: fn(param)}."""
    import re
    return {re.sub(r"^([a-z]+)\d+_", r"\1_", k): fn(p)
            for k, p in params.items()}


# -- chunked_softmax_ce ----------------------------------------------------------

CE_CASES = {
    "v97_chunk32_padded": (97, 32),
    "v97_chunk40_padded": (97, 40),
    "v96_chunk32": (96, 32),
    "v97_one_slab": (97, 8192),
}


@pytest.mark.parametrize("bias", [False, True], ids=["plain", "bias"])
@pytest.mark.parametrize("case", sorted(CE_CASES))
def test_chunked_softmax_ce_matches_jax(case, bias):
    v, chunk = CE_CASES[case]
    rng = np.random.RandomState(5)
    n, u = 12, 16
    hidden = rng.randn(n, u).astype("f4")
    weight = (rng.randn(v, u) * 0.5).astype("f4")
    label = rng.randint(0, v, n).astype("f4")
    arrays = [hidden, weight] + ([rng.randn(v).astype("f4")] if bias
                                 else []) + [label]

    def fn(F, *xs):
        if bias:
            return F.chunked_softmax_ce_bias(*xs, chunk=chunk)
        return F.chunked_softmax_ce(*xs, chunk=chunk)
    (j_out,), j_grad = torch_parity.run(jmx, fn, arrays)
    (t_out,), t_grad = torch_parity.run(mx, fn, arrays)
    assert t_out.dtype == j_out.dtype == np.float32
    assert t_out.shape == (n,)
    np.testing.assert_allclose(t_out, j_out, rtol=LOSS_RTOL)
    assert len(t_grad) == len(j_grad) == len(arrays)
    for t, j in zip(t_grad, j_grad):
        np.testing.assert_allclose(t, j, **GRAD_TOL)


def test_chunked_softmax_ce_saves_no_logits():
    """The backward recomputes each slab: what the forward saves is the
    inputs and the per-row statistics, never an (N, V) tensor, and the
    gradients equal the full-logits ones."""
    n, u, v = 64, 16, 1000
    rng = np.random.RandomState(6)
    h = torch.tensor(rng.randn(n, u).astype("f4"), requires_grad=True)
    w = torch.tensor(rng.randn(v, u).astype("f4"), requires_grad=True)
    lbl = torch.tensor(rng.randint(0, v, n).astype("f4"))
    saved = []

    def pack(t):
        saved.append(tuple(t.shape))
        return t
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        loss = ops.chunked_softmax_ce(h, w, lbl, chunk=100)
    assert saved and all(n * v > int(np.prod(s)) for s in saved), saved
    assert (v, u) in saved and (n,) in saved
    gh, gw = torch.autograd.grad(loss.sum(), (h, w))
    logits = h @ w.t()
    ref = torch.logsumexp(logits, 1) - logits.gather(
        1, lbl.long()[:, None])[:, 0]
    rh, rw = torch.autograd.grad(ref.sum(), (h, w))
    np.testing.assert_allclose(loss.detach(), ref.detach(), rtol=1e-5)
    np.testing.assert_allclose(gh, rh, **GRAD_TOL)
    np.testing.assert_allclose(gw, rw, **GRAD_TOL)


# -- LlamaForCausalLM.loss --------------------------------------------------------

LOSS_CASES = {
    "llama_tiny": ("llama_tiny", True),
    "mistral_tiny": ("mistral_tiny", True),
    "untied_head": ("llama_tiny", False),
}


@pytest.mark.parametrize("vocab_chunk", [0, 16], ids=["full", "chunk16"])
@pytest.mark.parametrize("case", sorted(LOSS_CASES))
def test_loss_and_grads_match_jax(case, vocab_chunk):
    """The loss and every parameter's gradient; mistral_tiny's 48
    tokens cross its window of 32."""
    name, tied = LOSS_CASES[case]
    jlm, lm = _pair(name, tied)
    tok = _tokens(2, 48, seed=7)
    with jmx.autograd.record():
        jl = jlm.loss(jmx.nd.array(tok), vocab_chunk=vocab_chunk)
    jl.backward()
    with autograd.record():
        tl = lm.loss(nd.array(tok, ctx=CPU), vocab_chunk=vocab_chunk)
    tl.backward()
    assert tl.shape == () and tl.dtype == np.float32
    np.testing.assert_allclose(float(tl.asnumpy()), float(jl.asnumpy()),
                               rtol=LOSS_RTOL)
    want = _by_suffix(jlm.collect_params(), lambda p: p.grad().asnumpy())
    got = _by_suffix(lm.collect_params(), lambda p: p.grad().asnumpy())
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **GRAD_TOL)


def test_large_vocab_takes_the_chunked_route(monkeypatch):
    """At V >= 32768 ``loss`` streams the head in slabs of 8192 (here
    32768 rows: 4 slabs) by default, and agrees with the JAX loss."""
    v = 32768
    jlm, lm = _pair("llama_tiny", True, v=v)
    calls = []
    real = ops._ChunkedCE.apply

    def spy(*args):
        calls.append(args[-1])
        return real(*args)
    monkeypatch.setattr(ops._ChunkedCE, "apply", spy)
    tok = _tokens(2, 16, seed=8, v=v)
    got = float(lm.loss(nd.array(tok, ctx=CPU)).asnumpy())
    want = float(jlm.loss(jmx.nd.array(tok)).asnumpy())
    assert calls == [8192]
    assert len(ops._slabs(v, 8192)) == 4
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    # the full-logits route stays reachable
    full = float(lm.loss(nd.array(tok, ctx=CPU), vocab_chunk=0).asnumpy())
    assert calls == [8192]
    np.testing.assert_allclose(full, want, rtol=1e-4)


# -- the gluon training loop ------------------------------------------------------

def _loop(pkg, net, tok, steps, lr, ctx=None):
    """The reference's loop: hybridize, Adam, record, loss, backward,
    step(B).  Returns the losses."""
    net.hybridize()
    tr = pkg.gluon.Trainer(net.collect_params(), "adam",
                           {"learning_rate": lr})
    b = tok.shape[0]
    x = pkg.nd.array(tok, ctx=ctx) if ctx is not None else pkg.nd.array(tok)
    losses = []
    for _ in range(steps):
        with pkg.autograd.record():
            loss = net.loss(x)
        loss.backward()
        tr.step(b)
        losses.append(float(loss.asnumpy()))
    return losses


TRAJ_CASES = {
    "llama_tiny": ("llama_tiny", True, None),
    "mistral_tiny": ("mistral_tiny", True, None),
    "untied_chunked": ("llama_tiny", False, 16),
}


@pytest.mark.parametrize("case", sorted(TRAJ_CASES))
def test_three_hybridized_adam_steps_match_jax(case):
    name, tied, chunk = TRAJ_CASES[case]
    jlm, lm = _pair(name, tied, seed=1)
    if chunk:
        for net in (jlm, lm):
            net.loss = _with_chunk(net.loss, chunk)
    tok = _tokens(2, 48, seed=9)
    want = _loop(jmx, jlm, tok, 3, 1e-2)
    got = _loop(mx, lm, tok, 3, 1e-2, ctx=CPU)
    np.testing.assert_allclose(got, want, rtol=TRAJ_TOL)
    jw = _by_suffix(jlm.collect_params(), lambda p: p.data().asnumpy())
    tw = _by_suffix(lm.collect_params(), lambda p: p.data().asnumpy())
    assert sorted(tw) == sorted(jw)
    for k in jw:
        dist = np.linalg.norm(tw[k] - jw[k]) / np.linalg.norm(jw[k])
        assert dist <= TRAJ_TOL, (k, dist)
    # one CachedOp entry for the model: the tokens' shape and dtype
    assert len(lm.model._cached_op if chunk else lm._cached_op) == 1
    assert got[-1] < got[0]


def _with_chunk(loss, chunk):
    def call(tokens):
        return loss(tokens, vocab_chunk=chunk)
    return call


@pytest.mark.parametrize("vocab_chunk", [None, 16], ids=["full", "chunk16"])
def test_three_adam_steps_under_bf16_amp_match_jax(vocab_chunk):
    """``amp.init("bfloat16")`` in both packages: the projections and
    attention in bfloat16, the norms, the residual stream and the chunked
    loss in float32; the losses within the bfloat16 tolerance, and each
    tensor's change (w3 - w0) against the JAX change in relative L2."""
    jlm, lm = _pair("llama_tiny", True, seed=2)
    for net in (jlm, lm):
        net.loss = _with_chunk(net.loss, vocab_chunk)
    w0 = _by_suffix(jlm.collect_params(),
                    lambda p: p.data().asnumpy().copy())
    tok = _tokens(2, 48, seed=10)
    jamp.init("bfloat16")
    try:
        want = _loop(jmx, jlm, tok, 3, 1e-2)
    finally:
        jamp._deinit()
    amp.init("bfloat16")
    try:
        got = _loop(mx, lm, tok, 3, 1e-2, ctx=CPU)
        h = lm.model(nd.array(tok, ctx=CPU))
    finally:
        amp._deinit()
    assert h.dtype == np.float32          # the final RMSNorm's output
    np.testing.assert_allclose(got, want, **BF16_TOL)
    jw = _by_suffix(jlm.collect_params(), lambda p: p.data().asnumpy())
    tw = _by_suffix(lm.collect_params(), lambda p: p.data().asnumpy())
    assert sorted(tw) == sorted(jw)
    for k in jw:
        assert tw[k].dtype == np.float32
        step = jw[k] - w0[k]
        dist = np.linalg.norm(tw[k] - w0[k] - step) / np.linalg.norm(step)
        assert dist <= BF16_STEP_TOL, (k, dist)


def test_training_converges_hybridized():
    """The reference's test on the port alone (its own Xavier draws):
    B=8, S=16, V=97, Adam lr 3e-3, the loss falls by more than 1.0 in 50
    steps."""
    v, b = 97, 8
    mx.random.seed(0)
    net = LlamaForCausalLM(get_llama("llama_tiny", vocab_size=v), ctx=CPU)
    net.initialize(mx.init.Xavier())
    toks = _tokens(b, 16, seed=2, v=v)
    losses = _loop(mx, net, toks, 50, 3e-3, ctx=CPU)
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0] - 1.0, (losses[0], losses[-1])


# -- initialize and the name-based loader ----------------------------------------

def test_initialize_forms():
    lm = LlamaForCausalLM(get_llama("llama_tiny", vocab_size=V), ctx=CPU)
    gamma = lm.model.final_norm.gamma
    q = lm.model.layers[0].attn.q_proj.weight
    assert q.std().item() == pytest.approx(0.02, rel=0.2)
    lm.initialize(mx.init.Xavier(), seed=3)
    # Xavier's uniform bound over the average fan (64 in, 64 out)
    assert q.abs().max().item() <= np.sqrt(3.0 / 64) + 1e-6
    assert q.std().item() > 0.1
    assert (gamma == 1).all()
    lm.initialize(std=0.3, seed=1)
    assert q.std().item() == pytest.approx(0.3, rel=0.2)
    with pytest.raises(MXNetError, match="std="):
        lm.initialize(mx.init.Xavier(), std=0.3)


@pytest.mark.parametrize("defect", ["missing", "extra", "shape"])
def test_load_jax_gluon_params_raises(defect):
    jlm, lm = _pair("llama_tiny", False)
    params = {k: p.data().asnumpy() for k, p in
              jlm.collect_params().items()}
    head = next(k for k in params if k.endswith("head_weight"))
    if defect == "missing":
        del params[head]
    elif defect == "extra":
        params["llamamodel0_layer9_attn_q_weight"] = params[head]
    else:
        params[head] = params[head][:, :3]
    with pytest.raises(MXNetError):
        load_jax_gluon_params(lm, params)
