"""The port's flash attention and attention dispatch against the JAX
package.

Inputs are made with numpy from a seed and fed to both packages.  The
JAX flash kernel runs in Pallas interpret mode; on the CPU the port's
wrapper runs its kernel's plain version.  Tolerances: f32 2e-5 (the
JAX package's own interpret-vs-oracle tolerance), bf16 2e-2, float16
1e-2 (``mxnet_tpu/test_utils.py``'s float16 rtol and atol: the port
rounds P to float16 for the tensor cores where the JAX kernel keeps it
in f32, at most 2^-11 relative).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mxnet_tpu.ops import attention as jattn
from mxnet_tpu.ops import flash_attention as fa_mod
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import attention as tattn
from mxnet_tpu_torch.ops import flash_attention as tfa

F32_TOL = 2e-5
BF16_TOL = 2e-2
F16_TOL = 1e-2


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(fa_mod, "_INTERPRET", True)
    yield


def _qkv(b, s_q, s_k, h, d, kv=None, seed=0):
    rng = np.random.RandomState(seed)
    kv = kv or h
    return (rng.randn(b, s_q, h, d).astype("f4"),
            rng.randn(b, s_k, kv, d).astype("f4"),
            rng.randn(b, s_k, kv, d).astype("f4"))


def _key_padding(b, s_k, seed=1):
    lens = np.random.RandomState(seed).randint(s_k // 4, s_k, size=b)
    return np.arange(s_k)[None, :] < lens[:, None]


FLASH_CASES = [
    pytest.param(dict(d=64), id="d64"),
    pytest.param(dict(d=64, causal=True), id="d64-causal"),
    pytest.param(dict(d=128), id="d128"),
    pytest.param(dict(d=128, causal=True), id="d128-causal"),
    # a head dim the tensor cores take zero-padded to 80
    pytest.param(dict(d=72), id="d72"),
    pytest.param(dict(d=72, causal=True), id="d72-causal"),
    pytest.param(dict(s_q=256, s_k=256), id="multi-k-block"),
    pytest.param(dict(s_q=128, s_k=256), id="cross"),
    pytest.param(dict(s_q=128, s_k=256, causal=True), id="cross-causal"),
    pytest.param(dict(s_q=256, s_k=128, causal=True), id="short-keys"),
    pytest.param(dict(s_q=256, s_k=256, causal=True, window=32),
                 id="window32"),
    pytest.param(dict(s_q=256, s_k=256, causal=True, window=100),
                 id="window100"),
    pytest.param(dict(b=2, mask="4d"), id="key-padding-b11s"),
    pytest.param(dict(b=2, mask="2d", causal=True), id="key-padding-bs"),
    # the NMT decoder's self-attention mask (B, 1, 1, S) with causal, and
    # a key-padded cross-attention whose source is longer than the target
    pytest.param(dict(b=2, mask="4d", causal=True),
                 id="causal-key-padding-b11s"),
    pytest.param(dict(b=2, s_q=128, s_k=256, mask="4d"),
                 id="cross-key-padding"),
]


@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_matches_jax_kernel(interpret, case):
    b, d = case.get("b", 1), case.get("d", 64)
    s_q, s_k = case.get("s_q", 128), case.get("s_k", 128)
    causal, window = case.get("causal", False), case.get("window")
    q, k, v = _qkv(b, s_q, s_k, 2, d, seed=s_q + s_k + d)
    mask_np = None
    if "mask" in case:
        mask_np = _key_padding(b, s_k)
        if case["mask"] == "4d":
            mask_np = mask_np[:, None, None, :]
    jmask = None if mask_np is None else jnp.asarray(mask_np)
    tmask = None if mask_np is None else torch.from_numpy(mask_np)
    want = np.asarray(fa_mod.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), mask=jmask,
        causal=causal, window=window))
    got = tfa.flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        mask=tmask, causal=causal, window=window).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)


def test_flash_bf16_matches_jax_kernel(interpret):
    q, k, v = _qkv(1, 128, 256, 2, 64, seed=5)
    want = np.asarray(fa_mod.flash_attention(
        jnp.asarray(q, jnp.bfloat16), jnp.asarray(k, jnp.bfloat16),
        jnp.asarray(v, jnp.bfloat16), causal=True).astype(jnp.float32))
    got = tfa.flash_attention(
        torch.from_numpy(q).bfloat16(), torch.from_numpy(k).bfloat16(),
        torch.from_numpy(v).bfloat16(), causal=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=BF16_TOL,
                               atol=BF16_TOL)


@pytest.mark.parametrize("case", [
    pytest.param(dict(s=256, d=64, window=100), id="window100"),
    pytest.param(dict(s=256, d=72), id="d72-causal"),
])
def test_flash_bf16_cases_match_jax_kernel(interpret, case):
    """bf16 through the branches the tensor-core kernel adds: a band
    edge in the middle of a key tile, and head-dim padding."""
    q, k, v = _qkv(1, case["s"], case["s"], 2, case["d"], seed=13)
    bf = [jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)]
    want = np.asarray(fa_mod.flash_attention(
        *bf, causal=True, window=case.get("window")).astype(jnp.float32))
    got = tfa.flash_attention(
        *(torch.from_numpy(x).bfloat16() for x in (q, k, v)), causal=True,
        window=case.get("window"))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=BF16_TOL,
                               atol=BF16_TOL)


@pytest.mark.parametrize("case", [
    pytest.param(dict(s_q=128, s_k=256, causal=True), id="cross-causal"),
    pytest.param(dict(causal=True, window=100, s_q=256, s_k=256),
                 id="window100"),
    pytest.param(dict(d=72, causal=True), id="d72-causal"),
    pytest.param(dict(b=2, mask=True), id="key-padding"),
])
def test_flash_f16_matches_jax_kernel(interpret, case):
    """float16 through the JAX kernel (f32 scores and P) and the port's
    float16 route (P rounded to float16), output in float16."""
    b, d = case.get("b", 1), case.get("d", 64)
    s_q, s_k = case.get("s_q", 128), case.get("s_k", 128)
    q, k, v = _qkv(b, s_q, s_k, 2, d, seed=41 + d)
    mask_np = _key_padding(b, s_k)[:, None, None, :] if case.get("mask") \
        else None
    kw = dict(causal=case.get("causal", False), window=case.get("window"))
    want = np.asarray(fa_mod.flash_attention(
        *(jnp.asarray(x, jnp.float16) for x in (q, k, v)),
        mask=None if mask_np is None else jnp.asarray(mask_np),
        **kw).astype(jnp.float32))
    got = tfa.flash_attention(
        *(torch.from_numpy(x).half() for x in (q, k, v)),
        mask=None if mask_np is None else torch.from_numpy(mask_np), **kw)
    assert got.dtype == torch.float16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=F16_TOL,
                               atol=F16_TOL)


def test_float16_attention_takes_the_flash_kernels(monkeypatch):
    """F6: float16 inputs pass ``_flash_viable``, so
    ``dot_product_attention`` sends them to the flash route (the kernels
    on the card, their plain versions here) and never to ``sdpa_plain``,
    as the JAX package's dispatch does not look at the dtype."""
    q, k, v = (torch.from_numpy(x).half() for x in _qkv(2, 128, 128, 4, 32,
                                                         kv=2, seed=3))
    assert tattn._flash_viable(q, k, v)

    def refuse(*a, **kw):
        raise AssertionError("float16 attention took sdpa_plain")
    monkeypatch.setattr(tattn, "sdpa_plain", refuse)
    calls = []
    plain = tfa.flash_attention_plain
    monkeypatch.setattr(tfa, "flash_attention_plain",
                        lambda *a, **kw: calls.append(1) or plain(*a, **kw))
    out = tattn.dot_product_attention(q, k, v, causal=True)
    assert out.dtype == torch.float16 and calls == [1]


def test_flash_lse_matches_jax_kernel(interpret):
    """The optional LSE output (for the backward) is the JAX kernel's
    lane-replicated LSE, one lane, as (B*H, S_q)."""
    q, k, v = _qkv(2, 128, 256, 2, 64, seed=9)
    scale = 1.0 / np.sqrt(64)
    want_o, want_lse = fa_mod._flash_fwd_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale, True)
    got_o, got_lse = tfa.flash_fwd(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        scale, causal=True, want_lse=True)
    assert tuple(got_lse.shape) == (4, 128)
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o),
                               rtol=F32_TOL, atol=F32_TOL)
    np.testing.assert_allclose(got_lse.numpy(),
                               np.asarray(want_lse)[:, :, 0],
                               rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_dot_product_attention_gqa_matches_jax(causal):
    """GQA (H=4, KV=2): the port hands the unrepeated K/V to the flash
    path; the JAX op groups heads in its einsum."""
    q, k, v = _qkv(2, 128, 128, 4, 32, kv=2, seed=21)
    want = np.asarray(jattn.dot_product_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal))
    got = tattn.dot_product_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal).numpy()
    np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)


def test_decode_shaped_attention_matches_jax():
    """One query against a key-padded cache: the plain path."""
    q, k, v = _qkv(3, 1, 40, 4, 16, kv=2, seed=4)
    mask_np = (np.arange(40)[None, :] <= np.array([[5], [17], [39]]))
    mask_np = mask_np.reshape(3, 1, 1, 40)
    want = np.asarray(jattn.dot_product_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(mask_np), use_mask=True))
    got = tattn.dot_product_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(mask_np)).numpy()
    np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)


def test_sdpa_plain_query_mask_matches_jax():
    """A query-dependent (B, H, S_q, S_k) mask, with the dtype path of
    the JAX package's XLA attention."""
    q, k, v = _qkv(2, 24, 24, 4, 16, seed=6)
    mask_np = np.random.RandomState(2).rand(2, 4, 24, 24) > 0.3
    want = np.asarray(jattn._sdpa_xla(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(mask_np), 0.25, True))
    got = tattn.sdpa_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(mask_np), 0.25, True).numpy()
    np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)


def test_flash_query_mask_matches_jax(interpret):
    """flash_attention with a query-dependent (B, H, S_q, S_k) mask runs
    the plain path, as the JAX function runs its XLA path."""
    q, k, v = _qkv(2, 128, 128, 2, 32, seed=8)
    mask_np = np.random.RandomState(3).rand(2, 2, 128, 128) > 0.3
    want = np.asarray(fa_mod.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        mask=jnp.asarray(mask_np), causal=True))
    tfa.flash_fwd_launches = 0
    got = tfa.flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        mask=torch.from_numpy(mask_np), causal=True).numpy()
    np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)
    assert tfa.flash_fwd_launches == 0


def test_no_switch_turns_the_kernel_off():
    """Nothing in the port routes a call the kernel takes to the plain
    path: no flash= argument and no environment variable."""
    import inspect
    from mxnet_tpu_torch import envs
    assert "flash" not in inspect.signature(
        tattn.dot_product_attention).parameters
    assert not [n for n in envs._REGISTRY if "FLASH" in n]


def test_ambiguous_2d_mask_raises():
    q, k, v = (torch.from_numpy(x) for x in _qkv(2, 2, 128, 2, 16))
    mask = torch.ones(2, 128, dtype=torch.bool)
    with pytest.raises(MXNetError, match="ambiguous"):
        tattn.dot_product_attention(q, k, v, mask)
    with pytest.raises(MXNetError, match="ambiguous"):
        tfa.flash_attention(q, k, v, mask=mask)


@pytest.mark.parametrize("fn", ["dot_product_attention",
                                "flash_attention"])
@pytest.mark.parametrize("kw,match", [
    (dict(causal=False, window=16), "requires causal"),
    (dict(causal=True, window=0), "positive"),
], ids=["not-causal", "nonpositive"])
def test_window_validation_raises(fn, kw, match):
    q, k, v = (torch.from_numpy(x) for x in _qkv(1, 128, 128, 2, 16))
    f = (tattn.dot_product_attention if fn == "dot_product_attention"
         else tfa.flash_attention)
    with pytest.raises(MXNetError, match=match):
        f(q, k, v, **kw)


@pytest.mark.parametrize("bad", ["head_dim", "dtype", "kmask"])
def test_flash_wrapper_checks(bad):
    """The wrapper refuses what the kernel does not take, on any
    device."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(1, 128, 128, 2, 16))
    kmask = None
    if bad == "head_dim":
        q, k, v = (x[..., :12] for x in (q, k, v))
    elif bad == "dtype":
        k = k.bfloat16()
    else:
        kmask = torch.ones(1, 64)
    with pytest.raises(MXNetError, match="flash_fwd"):
        tfa.flash_fwd(q, k, v, 0.25, kmask=kmask)


def test_backward_not_ported_raises():
    """The backward is ported (K2/K3; here their plain version): it no
    longer raises, and gives finite gradients of the inputs' shapes and
    types."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(1, 128, 128, 2, 16))
    q.requires_grad_(True)
    v.requires_grad_(True)
    out = tfa.flash_attention(q, k, v, causal=True)
    out.sum().backward()
    for t in (q, v):
        assert t.grad.shape == t.shape and t.grad.dtype == t.dtype
        assert torch.isfinite(t.grad).all()
    assert k.grad is None


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16], ids=["f32", "bf16", "f16"])
def test_viable_shapes_pass_the_tile_checks(dtype):
    """Every shape ``_flash_viable`` sends to the kernels (lengths
    128-1024, head dims 8-256) passes both wrappers' tile checks, the
    largest tiles of either route."""
    checked = 0
    for s_q in range(128, 1025, 128):
        for s_k in range(128, 1025, 128):
            for d in range(8, 257, 8):
                q = torch.empty(1, s_q, 4, d, dtype=dtype, device="meta")
                k = torch.empty(1, s_k, 2, d, dtype=dtype, device="meta")
                if not tattn._flash_viable(q, k, k):
                    continue
                tfa._check_tiles(s_q, s_k, tfa.FWD_BLOCK_Q, tfa.FWD_BLOCK_K,
                                 "flash_fwd")
                tfa._check_tiles(s_q, s_k, tfa.BWD_BLOCK_Q, tfa.BWD_BLOCK_K,
                                 "flash_bwd")
                checked += 1
    assert checked == 8 * 8 * 32
    with pytest.raises(MXNetError, match="multiple of"):
        tfa._check_tiles(128, 96, tfa.FWD_BLOCK_Q, tfa.FWD_BLOCK_K,
                         "flash_fwd")


def test_cpu_calls_leave_the_route_counters_at_zero():
    """CPU tensors run the plain versions: neither the tensor-core nor
    the CUDA-core route counts a launch."""
    for name in ("flash_fwd_launches", "flash_fwd_tc_launches",
                 "flash_bwd_launches", "flash_bwd_dkv_launches",
                 "flash_bwd_dkv_tc_launches"):
        setattr(tfa, name, 0)
    q, k, v = (torch.from_numpy(x).bfloat16().requires_grad_(True)
               for x in _qkv(1, 128, 128, 2, 16))
    tfa.flash_attention(q, k, v, causal=True).float().sum().backward()
    assert q.grad is not None
    assert (tfa.flash_fwd_launches, tfa.flash_fwd_tc_launches,
            tfa.flash_bwd_launches, tfa.flash_bwd_dkv_launches,
            tfa.flash_bwd_dkv_tc_launches) == (0, 0, 0, 0, 0)
