"""The port's flash-attention backward against the JAX package's.

The same numpy inputs and cotangent go through ``jax.vjp`` of the JAX
``flash_attention`` (its Pallas kernels ``_dq_kernel`` and
``_dkv_kernel`` in interpret mode) and through the port's ``_FlashFwd``
and ``torch.autograd`` (on the CPU, ``flash_bwd_plain``).  Tolerances,
as in the JAX package's own backward tests: f32 2e-5, bf16 2e-2; float16
1e-2 (``mxnet_tpu/test_utils.py``'s float16 rtol and atol: the port
rounds P and dS to float16 for the tensor cores where the JAX kernels
keep them in f32).
Gradients the mask forces to zero (a query that sees no key, a key no
query sees) are checked for exact equality with 0.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mxnet_tpu.ops import flash_attention as fa_mod
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import flash_attention as tfa
from mxnet_tpu_torch.ops.attention import dot_product_attention

F32_TOL = 2e-5
BF16_TOL = 2e-2
F16_TOL = 1e-2


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(fa_mod, "_INTERPRET", True)
    yield


def _inputs(b, s_q, s_k, h, d, kv=None, seed=0):
    rng = np.random.RandomState(seed)
    kv = kv or h
    return tuple((0.5 * rng.randn(*shape)).astype("f4") for shape in (
        (b, s_q, h, d), (b, s_k, kv, d), (b, s_k, kv, d), (b, s_q, h, d)))


def _key_padding(b, s_k, lens):
    return np.arange(s_k)[None, :] < np.asarray(lens)[:, None]


def _jax_grads(q, k, v, ct, mask=None, causal=False, window=None,
               dtype=jnp.float32):
    args = [jnp.asarray(x, dtype) for x in (q, k, v)]
    jmask = None if mask is None else jnp.asarray(mask)
    _, vjp = jax.vjp(lambda q, k, v: fa_mod.flash_attention(
        q, k, v, mask=jmask, causal=causal, window=window), *args)
    return [np.asarray(g.astype(jnp.float32))
            for g in vjp(jnp.asarray(ct, dtype))]


def _torch_grads(q, k, v, ct, mask=None, causal=False, window=None,
                 dtype=torch.float32):
    args = [torch.from_numpy(x).to(dtype).requires_grad_(True)
            for x in (q, k, v)]
    tmask = None if mask is None else torch.from_numpy(mask)
    out = tfa.flash_attention(*args, mask=tmask, causal=causal,
                              window=window)
    out.backward(torch.from_numpy(ct).to(dtype))
    for a in args:
        assert a.grad.dtype == dtype
    return [a.grad.float().numpy() for a in args]


def _visible(b, s_q, s_k, causal, window, mask):
    """(B, S_q, S_k) pairs the mask leaves visible."""
    keep = np.ones((b, s_q, s_k), bool)
    off = s_k - s_q
    qi = np.arange(s_q)[:, None]
    kj = np.arange(s_k)[None, :]
    if causal:
        keep &= qi + off >= kj
        if window is not None:
            keep &= kj > qi + off - window
    if mask is not None:
        keep &= mask.reshape(b, 1, s_k)
    return keep


CASES = [
    pytest.param(dict(d=64), id="d64"),
    pytest.param(dict(d=64, causal=True), id="d64-causal"),
    pytest.param(dict(d=128), id="d128"),
    pytest.param(dict(d=128, causal=True), id="d128-causal"),
    # a head dim the tensor cores take zero-padded to 80
    pytest.param(dict(d=72, causal=True), id="d72-causal"),
    pytest.param(dict(s_q=256, s_k=256, causal=True), id="multi-k-block"),
    pytest.param(dict(s_q=128, s_k=256, causal=True), id="cross-causal"),
    pytest.param(dict(s_q=256, s_k=128, causal=True, zeros=True),
                 id="short-keys"),
    pytest.param(dict(s_q=256, s_k=256, causal=True, window=32),
                 id="window32"),
    pytest.param(dict(s_q=256, s_k=256, causal=True, window=100),
                 id="window100"),
    pytest.param(dict(b=2, s_q=256, s_k=256, causal=True, window=64,
                      lens=(200, 256), mask="4d", zeros=True),
                 id="window-key-padding"),
    pytest.param(dict(b=2, lens=(77, 128), mask="4d", zeros=True),
                 id="key-padding-b11s"),
    pytest.param(dict(b=3, lens=(100, 0, 128), mask="2d", causal=True,
                      zeros=True), id="key-padding-bs-empty-row"),
]


@pytest.mark.parametrize("case", CASES)
def test_flash_backward_matches_jax_kernels(interpret, case):
    b, d = case.get("b", 1), case.get("d", 64)
    s_q, s_k = case.get("s_q", 128), case.get("s_k", 128)
    causal, window = case.get("causal", False), case.get("window")
    q, k, v, ct = _inputs(b, s_q, s_k, 2, d, seed=s_q + 3 * s_k + d)
    mask = None
    if "lens" in case:
        mask = _key_padding(b, s_k, case["lens"])
    fmask = mask
    if case.get("mask") == "4d":
        fmask = mask[:, None, None, :]
    want = _jax_grads(q, k, v, ct, fmask, causal, window)
    got = _torch_grads(q, k, v, ct, fmask, causal, window)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        assert np.isfinite(a).all(), name
        np.testing.assert_allclose(a, w, rtol=F32_TOL, atol=F32_TOL,
                                   err_msg=name)

    # exact zeros where the mask leaves nothing to differentiate
    keep = _visible(b, s_q, s_k, causal, window, mask)
    blind_q = ~keep.any(axis=2)                          # (B, S_q)
    blind_k = ~keep.any(axis=1)                          # (B, S_k)
    dq, dk, dv = got
    assert (dq[blind_q] == 0).all() and (dk[blind_k] == 0).all() \
        and (dv[blind_k] == 0).all()
    assert (want[0][blind_q] == 0).all() and (want[1][blind_k] == 0).all()
    assert (blind_q.any() or blind_k.any()) == case.get("zeros", False)


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_flash_backward_bf16_matches_jax_kernels(interpret, causal):
    q, k, v, ct = _inputs(1, 128, 256, 2, 64, seed=31)
    want = _jax_grads(q, k, v, ct, causal=causal, dtype=jnp.bfloat16)
    got = _torch_grads(q, k, v, ct, causal=causal, dtype=torch.bfloat16)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a, w, rtol=BF16_TOL, atol=BF16_TOL,
                                   err_msg=name)


@pytest.mark.parametrize("case", [
    pytest.param(dict(s=256, d=64, window=100), id="window100"),
    pytest.param(dict(s=128, d=72), id="d72-causal"),
])
def test_flash_backward_bf16_cases_match_jax_kernels(interpret, case):
    """bf16 gradients through the branches the tensor-core dK/dV kernel
    adds: a band edge in the middle of a tile, and head-dim padding."""
    s, d = case["s"], case["d"]
    q, k, v, ct = _inputs(1, s, s, 2, d, seed=37)
    want = _jax_grads(q, k, v, ct, causal=True, window=case.get("window"),
                      dtype=jnp.bfloat16)
    got = _torch_grads(q, k, v, ct, causal=True, window=case.get("window"),
                       dtype=torch.bfloat16)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a, w, rtol=BF16_TOL, atol=BF16_TOL,
                                   err_msg=name)


@pytest.mark.parametrize("case", [
    pytest.param(dict(causal=False), id="full"),
    pytest.param(dict(causal=True, s_q=128, s_k=256), id="cross-causal"),
    pytest.param(dict(causal=True, window=100, s_q=256, s_k=256),
                 id="window100"),
    pytest.param(dict(causal=True, d=72), id="d72-causal"),
    pytest.param(dict(b=2, lens=(77, 128)), id="key-padding"),
])
def test_flash_backward_f16_matches_jax_kernels(interpret, case):
    """float16 gradients: the JAX kernels keep P and dS in f32, the
    port's float16 route rounds them to float16."""
    b, d = case.get("b", 1), case.get("d", 64)
    s_q, s_k = case.get("s_q", 128), case.get("s_k", 128)
    q, k, v, ct = _inputs(b, s_q, s_k, 2, d, seed=43 + d)
    mask = None
    if "lens" in case:
        mask = _key_padding(b, s_k, case["lens"])[:, None, None, :]
    kw = dict(causal=case.get("causal", False), window=case.get("window"))
    want = _jax_grads(q, k, v, ct, mask, dtype=jnp.float16, **kw)
    got = _torch_grads(q, k, v, ct, mask, dtype=torch.float16, **kw)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        assert np.isfinite(a).all(), name
        np.testing.assert_allclose(a, w, rtol=F16_TOL, atol=F16_TOL,
                                   err_msg=name)


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_gqa_backward_sums_the_group(interpret, causal):
    """H=4 query heads over KV=2: the port's dK/dV (one per KV head)
    equal the JAX kernels' gradients for repeated K/V, summed over each
    group."""
    q, k, v, ct = _inputs(1, 128, 128, 4, 64, kv=2, seed=41)
    rep = lambda x: np.repeat(x, 2, axis=2)               # noqa: E731
    want = _jax_grads(q, rep(k), rep(v), ct, causal=causal)
    want[1] = want[1].reshape(1, 128, 2, 2, 64).sum(axis=3)
    want[2] = want[2].reshape(1, 128, 2, 2, 64).sum(axis=3)
    args = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    out = dot_product_attention(*args, causal=causal)
    out.backward(torch.from_numpy(ct))
    for name, a, w in zip(("dq", "dk", "dv"), args, want):
        np.testing.assert_allclose(a.grad.numpy(), w, rtol=F32_TOL,
                                   atol=F32_TOL, err_msg=name)


def test_plain_backward_is_the_autograd_of_plain_attention():
    """flash_bwd_plain equals autograd through the plain attention
    (sdpa_plain) in float32: the recomputation from the LSE is exact."""
    from mxnet_tpu_torch.ops.attention import sdpa_plain
    q, k, v, ct = _inputs(2, 128, 128, 4, 32, kv=2, seed=3)
    args = [torch.from_numpy(x).double().requires_grad_(True)
            for x in (q, k, v)]
    sdpa_plain(*args, None, 1 / np.sqrt(32), True).backward(
        torch.from_numpy(ct).double())
    got = _torch_grads(q, k, v, ct, causal=True)
    for name, a, w in zip(("dq", "dk", "dv"), got, args):
        np.testing.assert_allclose(a, w.grad.numpy(), rtol=F32_TOL,
                                   atol=F32_TOL, err_msg=name)


def test_lse_only_when_a_gradient_is_needed(monkeypatch):
    """The no-grad path asks the forward for no LSE; a recorded one
    does."""
    seen = []
    fwd = tfa.flash_fwd

    def spy(*a, **kw):
        seen.append(kw["want_lse"])
        return fwd(*a, **kw)
    monkeypatch.setattr(tfa, "flash_fwd", spy)
    q, k, v, _ = (torch.from_numpy(x) for x in _inputs(1, 128, 128, 2, 16))
    with torch.no_grad():
        tfa.flash_attention(q.requires_grad_(True), k, v)
    tfa.flash_attention(q, k, v)
    tfa.flash_attention(q.detach(), k, v)
    assert seen == [False, True, False]


def test_backward_wrapper_checks():
    q, k, v, g = (torch.from_numpy(x) for x in _inputs(1, 128, 128, 2, 16))
    out, lse = tfa.flash_fwd(q, k, v, 0.25, want_lse=True)
    with pytest.raises(MXNetError, match="flash_bwd: lse"):
        tfa.flash_bwd(q, k, v, out, lse[:, :64], g, 0.25)
    with pytest.raises(MXNetError, match="flash_bwd: grad"):
        tfa.flash_bwd(q, k, v, out, lse, g.bfloat16(), 0.25)
    with pytest.raises(MXNetError, match="no kernel for device meta"):
        tfa.flash_bwd(*(t.to("meta") for t in (q, k, v, out, lse, g)),
                      0.25)


def test_cpu_backward_launches_no_kernel():
    tfa.flash_bwd_launches = tfa.flash_bwd_dq_tc_launches = 0
    q, k, v, g = (torch.from_numpy(x) for x in _inputs(1, 128, 128, 2, 16))
    q.requires_grad_(True)
    tfa.flash_attention(q, k, v, causal=True).backward(g)
    assert q.grad is not None and tfa.flash_bwd_launches == 0
    assert tfa.flash_bwd_dq_tc_launches == 0
