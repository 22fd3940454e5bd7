"""The port's Llama against the JAX package's, with the same weights.

A seeded JAX ``LlamaForCausalLM`` is copied into the port with
``load_jax_params``; both then see the same numpy-made tokens.  Logits
agree to rtol=atol=1e-4 in float32 (the two frameworks sum in other
orders), tokens exactly.  ``mistral_tiny`` (window 32) runs a 128-token
prompt, past the window: banded attention, the rolling cache and its
slot permutation.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import nd
from mxnet_tpu.models import LlamaForCausalLM as JaxLM
from mxnet_tpu.models import get_llama as jax_get_llama
import mxnet_tpu_torch as mx
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.models import LlamaForCausalLM, get_llama, \
    load_jax_params

V = 61
TOL = 1e-4


@pytest.fixture(scope="module", params=["llama_tiny", "mistral_tiny"])
def pair(request):
    name = request.param
    jmx.random.seed(0)
    jlm = JaxLM(jax_get_llama(name, vocab_size=V))
    jlm.initialize(jmx.init.Xavier())
    params = {k: p.data().asnumpy()
              for k, p in jlm.collect_params().items()}
    lm = LlamaForCausalLM(get_llama(name, vocab_size=V), ctx=mx.cpu())
    load_jax_params(lm, params)
    return name, jlm, lm


def _tokens(b, s, seed=0):
    return np.random.RandomState(seed).randint(0, V, (b, s)).astype("f4")


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=TOL, atol=TOL)


def test_forward_logits(pair):
    _, jlm, lm = pair
    tok = _tokens(2, 128)
    _close(lm(torch.from_numpy(tok)).detach().numpy(),
           jlm(nd.array(tok)).asnumpy())


def test_prefill_last_pos_right_padded(pair):
    """Right-padded rows read their logits at their own last token, and
    the caches hold the same K/V."""
    _, jlm, lm = pair
    tok = _tokens(2, 128, seed=1)
    tok[0, 100:] = 0.0                       # row 0: 100 real tokens
    last = np.array([99.0, 127.0], "f4")
    jc = jlm.init_cache(2, 136)
    tc = lm.init_cache(2, 136)
    want = jlm.prefill(nd.array(tok), jc, last_pos=nd.array(last))
    got = lm.prefill(torch.from_numpy(tok), tc,
                     last_pos=torch.from_numpy(last))
    _close(got.numpy(), want.asnumpy())
    for (jk, jv), (tk, tv) in zip(jc, tc):
        _close(tk.numpy(), jk.asnumpy())
        _close(tv.numpy(), jv.asnumpy())


def test_decode_steps_shared_offset(pair):
    """Six steps at one shared position; mistral_tiny decodes from its
    rolling buffer (32 slots, filled through the prompt permutation)."""
    name, jlm, lm = pair
    rolling = name == "mistral_tiny"
    tok = _tokens(2, 128, seed=2)
    jc = jlm.init_cache(2, 134, rolling=rolling)
    tc = lm.init_cache(2, 134, rolling=rolling)
    want = jlm.prefill(nd.array(tok), jc).asnumpy()
    _close(lm.prefill(torch.from_numpy(tok), tc).numpy(), want)
    for i in range(6):
        nxt = want.argmax(-1).astype("f4").reshape(2, 1)
        want = jlm.decode_step(nd.array(nxt), jc, 128 + i).asnumpy()
        got = lm.decode_step(torch.from_numpy(nxt), tc, 128 + i).numpy()
        _close(got, want)


def test_decode_steps_per_row_offsets(pair):
    """Six steps with a (B,) offset: each row at its own depth."""
    _, jlm, lm = pair
    tok = _tokens(2, 128, seed=3)
    jc = jlm.init_cache(2, 134)
    tc = lm.init_cache(2, 134)
    jlm.prefill(nd.array(tok), jc)
    lm.prefill(torch.from_numpy(tok), tc)
    nxt = tok[:, -1:].copy()
    for i in range(6):
        off = np.array([128.0 + i, 90.0 + i], "f4")
        want = jlm.decode_step(nd.array(nxt), jc, nd.array(off)).asnumpy()
        got = lm.decode_step(torch.from_numpy(nxt), tc,
                             torch.from_numpy(off)).numpy()
        _close(got, want)
        nxt = want.argmax(-1).astype("f4").reshape(2, 1)


@pytest.mark.parametrize("temperature", [0.0, 0.8],
                         ids=["greedy", "sampled"])
def test_generate_tokens_equal(pair, temperature):
    name, jlm, lm = pair
    rolling = name == "mistral_tiny"
    tok = _tokens(2, 128, seed=4)
    kw = dict(max_new_tokens=6, temperature=temperature, top_k=5, seed=3,
              rolling=rolling)
    want = jlm.generate(nd.array(tok), **kw).asnumpy()
    got = lm.generate(torch.from_numpy(tok), **kw).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n", [0, 1, 6])
def test_generate_fused_greedy_equals_jax_and_generate(pair, n):
    """The whole generation in one body: greedy tokens equal the JAX
    ``generate_fused`` and the port's ``generate``; 0 new tokens gives
    a copy of the prompt, 1 runs the prefill only."""
    name, jlm, lm = pair
    rolling = name == "mistral_tiny"
    tok = _tokens(2, 128, seed=5)
    want = jlm.generate_fused(nd.array(tok), max_new_tokens=n,
                              rolling=rolling).asnumpy()
    prompt = torch.from_numpy(tok)
    got = lm.generate_fused(prompt, max_new_tokens=n, rolling=rolling)
    assert got.shape == (2, 128 + n) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        got.numpy(), lm.generate(prompt, max_new_tokens=n,
                                 rolling=rolling).numpy())
    got[:, 0] = -1.0                    # a new tensor, not the prompt
    assert (prompt[:, 0] >= 0).all()


def test_generate_fused_signatures(pair):
    """One capture a signature: a repeated call reuses it, the
    temperature and seed do not enter it, and a new ``max_new_tokens``
    (or sampling, or top_k while sampling) gets a new one."""
    _, _, lm = pair
    lm._fused.clear()
    tok = torch.from_numpy(_tokens(1, 16, seed=6))
    lm.generate_fused(tok, max_new_tokens=3)
    lm.generate_fused(tok, max_new_tokens=3, top_k=7)   # greedy: ignored
    assert len(lm._fused) == 1
    lm.generate_fused(tok, max_new_tokens=4)
    assert len(lm._fused) == 2
    lm.generate_fused(tok, max_new_tokens=3, temperature=0.7, seed=1)
    lm.generate_fused(tok, max_new_tokens=3, temperature=1.3, seed=2)
    assert len(lm._fused) == 3
    lm.generate_fused(tok, max_new_tokens=3, temperature=0.7, top_k=5)
    assert len(lm._fused) == 4
    lm.generate_fused(tok, max_new_tokens=0)
    assert len(lm._fused) == 4


def test_generate_fused_sampled_seeded(pair):
    """A seed gives the same tokens at every call, another seed other
    tokens; tokens stay in range and the prompt is kept."""
    name, _, lm = pair
    rolling = name == "mistral_tiny"
    tok = torch.from_numpy(_tokens(2, 128, seed=7))
    kw = dict(max_new_tokens=8, temperature=1.5, top_k=20,
              rolling=rolling)
    a = lm.generate_fused(tok, seed=11, **kw)
    b = lm.generate_fused(tok, seed=11, **kw)
    c = lm.generate_fused(tok, seed=12, **kw)
    assert torch.equal(a, b)
    assert not torch.equal(a, c)
    assert torch.equal(a[:, :128], tok)
    gen = a[:, 128:]
    assert ((gen >= 0) & (gen < V)).all()
    assert torch.equal(gen, gen.round())


@pytest.mark.parametrize("eos", ["none", "mid"])
def test_generate_beam_equals_jax(pair, eos):
    """Beam search: the JAX ``generate_beam``'s sequences exactly and
    its scores to 1e-5 (f32), without an eos and with one that ends
    beams early."""
    _, jlm, lm = pair
    tok = _tokens(2, 16, seed=8)
    eos_id = None
    if eos == "mid":
        greedy = lm.generate(torch.from_numpy(tok), max_new_tokens=6)
        eos_id = int(greedy[0, 19])
    kw = dict(max_new_tokens=6, beam_size=3, eos_id=eos_id, alpha=0.8)
    jseq, jsc = jlm.generate_beam(nd.array(tok), **kw)
    seq, sc = lm.generate_beam(torch.from_numpy(tok), **kw)
    assert seq.shape == jseq.shape and sc.shape == (2, 3)
    np.testing.assert_array_equal(seq.numpy(), jseq.asnumpy())
    np.testing.assert_allclose(sc.numpy(), jsc.asnumpy(), rtol=1e-5,
                               atol=1e-5)
    assert (np.diff(sc.numpy(), axis=1) <= 0).all()   # best first
    np.testing.assert_array_equal(seq.numpy()[:, 0, :16], tok)


def _jax_params(name="llama_tiny", tie=True):
    jmx.random.seed(0)
    jlm = JaxLM(jax_get_llama(name, vocab_size=V), tie_embeddings=tie)
    jlm.initialize(jmx.init.Xavier())
    return {k: p.data().asnumpy() for k, p in jlm.collect_params().items()}


@pytest.mark.parametrize("defect", ["missing", "wrong-shape",
                                    "unknown-name", "not-in-model"])
def test_load_jax_params_raises(defect):
    params = _jax_params()
    lm = LlamaForCausalLM(get_llama("llama_tiny", vocab_size=V),
                          ctx=mx.cpu())
    key = next(k for k in params if k.endswith("layer1_attn_k_weight"))
    if defect == "missing":
        del params[key]
        match = "missing"
    elif defect == "wrong-shape":
        params[key] = params[key][:, :-1]
        match = "shape"
    elif defect == "unknown-name":
        params["llamamodel0_layer0_attn_bias"] = np.zeros(3, "f4")
        match = "unrecognised"
    else:
        params["llamaforcausallm9_head_weight"] = np.zeros((V, 64), "f4")
        match = "does not have"
    with pytest.raises(MXNetError, match=match):
        load_jax_params(lm, params)


def test_load_untied_head():
    """An untied head (Llama-3-8B's layout) maps onto ``lm_head``."""
    params = _jax_params(tie=False)
    lm = LlamaForCausalLM(get_llama("llama_tiny", vocab_size=V),
                          tie_embeddings=False, ctx=mx.cpu())
    load_jax_params(lm, params)
    head = next(v for k, v in params.items() if k.endswith("head_weight"))
    np.testing.assert_array_equal(lm.lm_head.weight.detach().numpy(), head)
