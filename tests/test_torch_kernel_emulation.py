"""The CUDA sources of the port's flash kernels, run on the CPU.

``csrc/flash_fwd.cu`` and ``csrc/flash_bwd.cu`` are compiled with g++
against a stand-in for the CUDA runtime (``tests/torch_kernel_emu``: one
std::thread per CUDA thread; shuffles, ldmatrix and mma.sync computed
from the PTX fragment layouts).  The kernels then run on CPU tensors
through their C entry points, with the arguments the wrappers pass, and
are held against the plain versions (``flash_attention_plain``,
``flash_bwd_plain``), which the other test files hold against the JAX
package's Pallas kernels.  This checks the tensor-core kernels' fragment
layouts, masks, tile skips, head-dim padding and GQA sums, and the
CUDA-core kernels, without a card.  Tolerances are ``chip_smoke.py``'s:
bf16 2e-2 (the forward absolute, each gradient times max(1, max|ref|)),
f32 1e-4; a gradient the mask forces to zero must be exactly 0.
"""
import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import pytest
import torch

from mxnet_tpu_torch.ops import flash_attention as tfa
from mxnet_tpu_torch.ops.attention import _causal_band

REPO = Path(__file__).resolve().parents[1]
CSRC = REPO / "mxnet_tpu_torch" / "csrc"
EMU = Path(__file__).resolve().parent / "torch_kernel_emu"
TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
MISALIGNED = 716  # cudaErrorMisalignedAddress

# the inline-PTX helpers of flash_tc.cuh that emu_tc.h stands in for
_ASM_FNS = ("smem_addr", "cp_async16", "cp_async_commit", "ldsm_x4",
            "ldsm_x4_t", "mma")


def _emulated_header():
    hdr = (CSRC / "flash_tc.cuh").read_text()
    for name in _ASM_FNS:
        m = re.search(r"\n(__device__ __forceinline__ [^\n]*\b%s\([^)]*\)"
                      r"[^{]*\{.*?\n\})\n" % name, hdr, re.S)
        assert m, name
        hdr = hdr.replace(m.group(1), "")
    m = re.search(r"\n(template <int N>\n__device__ __forceinline__ void "
                  r"cp_async_wait\(\) \{.*?\n\})\n", hdr, re.S)
    assert m
    hdr = hdr.replace(m.group(1), "")
    return hdr.replace("typedef __nv_bfloat16 bf16;",
                       "typedef __nv_bfloat16 bf16;\n"
                       + (EMU / "emu_tc.h").read_text())


def _emulated_source(name):
    """csrc/<name>.cu with each kernel<<<...>>>(p) launch as a call of
    emu_launch, and the dynamic shared memory it declares defined."""
    src = (CSRC / f"{name}.cu").read_text()
    src, n = re.subn(r"(\w+<[^;<>]+>)<<<([^>]+)>>>\((\w+)\);",
                     r"emu_launch(\1, \2, \3);", src)
    assert n > 0
    return ("namespace { alignas(16) unsigned char smem_raw[240 * 1024];\n"
            "alignas(16) float smem[60 * 1024]; }\n" + src
            + "\nunsigned char* emu_smem_base = smem_raw;\n"
            "size_t emu_smem_bytes = sizeof(smem_raw);\n")


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    """The two kernel libraries, built for the CPU stand-in."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the kernel sources for the CPU")
    out = tmp_path_factory.mktemp("kernel_emu")
    (out / "flash_tc.cuh").write_text(_emulated_header())
    for h in ("cuda_bf16.h", "cuda_runtime.h"):
        (out / h).write_text("")
    procs = {}
    for name in ("flash_fwd", "flash_bwd"):
        (out / f"{name}.cpp").write_text(_emulated_source(name))
        procs[name] = subprocess.Popen(
            [gxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-pthread", "-w",
             "-include", str(EMU / "emu.h"), "-I", str(out),
             "-o", str(out / f"lib{name}.so"), str(out / f"{name}.cpp")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name, p in procs.items():
        log, _ = p.communicate()
        assert p.returncode == 0, log[-4000:]
    return (tfa._bind_fwd(ctypes.CDLL(str(out / "libflash_fwd.so"))),
            tfa._bind_bwd(ctypes.CDLL(str(out / "libflash_bwd.so"))))


def _inputs(b, s_q, s_k, h, kv, d, dtype, lens=None, seed=0):
    g = torch.Generator().manual_seed(seed)
    q, k, v, do = (torch.randn(b, s, n, d, generator=g).to(dtype) for s, n in
                   ((s_q, h), (s_k, kv), (s_k, kv), (s_q, h)))
    kmask = None
    if lens is not None:
        kmask = (torch.arange(s_k)[None]
                 < torch.tensor(lens)[:, None]).float()
    return q, k, v, do, kmask


def _visible(b, s_q, s_k, causal, window, kmask):
    keep = torch.ones(b, s_q, s_k, dtype=torch.bool)
    if causal:
        keep = keep & _causal_band(s_q, s_k, window, "cpu")[None]
    if kmask is not None:
        keep = keep & (kmask > 0)[:, None, :]
    return keep


FWD_CASES = [
    pytest.param(dict(), id="gqa"),
    pytest.param(dict(causal=True), id="causal"),
    pytest.param(dict(s_q=128, s_k=256, causal=True), id="cross-causal"),
    # offset below 0: no tile skip; the first 128 rows see no key
    pytest.param(dict(s_q=256, s_k=128, causal=True), id="short-keys"),
    pytest.param(dict(s_q=256, s_k=256, causal=True, window=100),
                 id="window100"),
    pytest.param(dict(b=2, lens=(0, 77)), id="key-padding-empty-row"),
    pytest.param(dict(h=4, kv=2, d=72, causal=True), id="d72-causal"),
    pytest.param(dict(s_q=64, d=128, causal=True), id="d128-causal"),
    pytest.param(dict(s_q=64, h=1, kv=1, d=256), id="d256"),
    pytest.param(dict(s_q=64, s_k=64, d=8), id="d8"),
    # three key tiles: the double buffer ends on its second half
    pytest.param(dict(s_k=192, causal=True), id="odd-key-tiles"),
    pytest.param(dict(causal=True, dtype=torch.float32), id="f32-causal"),
    pytest.param(dict(b=2, lens=(100, 128), window=50, causal=True,
                      dtype=torch.float32), id="f32-window-key-padding"),
]


@pytest.mark.parametrize("case", FWD_CASES)
def test_flash_fwd_source_matches_plain(libs, case):
    b, h, kv, d = (case.get(n, dv) for n, dv in
                   (("b", 1), ("h", 2), ("kv", 1), ("d", 64)))
    s_q, s_k = case.get("s_q", 128), case.get("s_k", 128)
    causal, window = case.get("causal", False), case.get("window")
    dtype = case.get("dtype", torch.bfloat16)
    q, k, v, _, kmask = _inputs(b, s_q, s_k, h, kv, d, dtype,
                                case.get("lens"), seed=s_q + s_k + d)
    scale = d ** -0.5
    out = torch.full_like(q, float("nan"))
    lse = torch.full((b * h, s_q), float("nan"))
    rc = libs[0].mxtpu_flash_fwd(*tfa._fwd_args(
        q, k, v, out, lse, kmask, scale, causal, window), None)
    assert rc == 0
    assert libs[0].mxtpu_flash_fwd_tc(tfa._DTYPE_CODES[dtype]) == \
        (dtype == torch.bfloat16)
    ref, ref_lse = tfa.flash_attention_plain(
        q, k, v, scale, causal=causal, kmask=kmask, window=window,
        want_lse=True)
    tol = TOL[dtype]
    assert (out.float() - ref.float()).abs().max().item() <= tol
    assert (lse - ref_lse).abs().max().item() <= tol


BWD_CASES = [
    pytest.param(dict(), id="gqa"),
    pytest.param(dict(causal=True), id="causal"),
    pytest.param(dict(s_q=128, s_k=256, h=2, kv=2, causal=True),
                 id="cross-causal"),
    pytest.param(dict(s_q=256, s_k=128, h=1, causal=True), id="short-keys"),
    pytest.param(dict(s_q=256, s_k=256, h=1, causal=True, window=100),
                 id="window100"),
    pytest.param(dict(b=2, h=1, lens=(0, 77)), id="key-padding-empty-row"),
    pytest.param(dict(b=2, h=1, lens=(100, 0), causal=True),
                 id="causal-key-padding"),
    # keys 0-319 lie below every query's window: a key tile that visits
    # no query tile writes exact zeros
    pytest.param(dict(s_q=128, s_k=512, h=1, causal=True, window=64),
                 id="cross-window-blind-key-tiles"),
    pytest.param(dict(h=4, kv=2, d=72, causal=True), id="d72-gqa-causal"),
    pytest.param(dict(s_q=64, h=1, d=128, causal=True), id="d128-causal"),
    pytest.param(dict(s_q=64, d=256), id="d256"),
    pytest.param(dict(causal=True, dtype=torch.float32), id="f32-causal"),
    # one query tile of four heads over two KV heads at D = 64: Q and dO
    # held in registers, Delta per head
    pytest.param(dict(s_q=64, h=4, kv=2), id="d64-multihead"),
    # key padding that ends inside the second of two 64-key tiles, and a
    # row that sees every key
    pytest.param(dict(b=2, s_q=64, h=1, lens=(70, 128)),
                 id="key-padding-two-key-tiles"),
]


@pytest.mark.parametrize("case", BWD_CASES)
def test_flash_bwd_sources_match_plain(libs, case):
    """K2 then K3 (which reads K2's Delta), as ``flash_bwd`` launches
    them, against ``flash_bwd_plain`` on the plain forward's O and LSE."""
    b, h, kv, d = (case.get(n, dv) for n, dv in
                   (("b", 1), ("h", 2), ("kv", 1), ("d", 64)))
    s_q, s_k = case.get("s_q", 128), case.get("s_k", 128)
    causal, window = case.get("causal", False), case.get("window")
    dtype = case.get("dtype", torch.bfloat16)
    q, k, v, do, kmask = _inputs(b, s_q, s_k, h, kv, d, dtype,
                                 case.get("lens"), seed=s_q + 3 * s_k + d)
    scale = d ** -0.5
    out, lse = tfa.flash_attention_plain(q, k, v, scale, causal=causal,
                                         kmask=kmask, window=window,
                                         want_lse=True)
    lse = lse.contiguous()
    dq, dk, dv = (torch.full_like(t, float("nan")) for t in (q, k, v))
    delta = torch.full_like(lse, float("nan"))
    args = tfa._bwd_args(q, k, v, out, do, scale, causal, window)
    km = kmask.data_ptr() if kmask is not None else None
    code = tfa._DTYPE_CODES[dtype]
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(), km)
    assert libs[1].mxtpu_flash_bwd_dq(*ptrs, dq.data_ptr(), code, *args,
                                      None) == 0
    assert libs[1].mxtpu_flash_bwd_dkv(*ptrs, dk.data_ptr(), dv.data_ptr(),
                                       code, *args, None) == 0
    assert libs[1].mxtpu_flash_bwd_dq_tc(code) == (dtype == torch.bfloat16)
    assert libs[1].mxtpu_flash_bwd_dkv_tc(code) == (dtype == torch.bfloat16)
    ref = tfa.flash_bwd_plain(q, k, v, out, lse, do, scale, causal=causal,
                              kmask=kmask, window=window)
    for name, got, want in zip(("dq", "dk", "dv"), (dq, dk, dv), ref):
        limit = TOL[dtype] * max(1.0, want.float().abs().max().item())
        err = (got.float() - want.float()).abs().max().item()
        assert err <= limit, (name, err, limit)
    keep = _visible(b, s_q, s_k, causal, window, kmask)
    blind_q, blind_k = ~keep.any(dim=2), ~keep.any(dim=1)
    assert (dq[blind_q] == 0).all()
    assert (dk[blind_k] == 0).all() and (dv[blind_k] == 0).all()


def test_tensor_core_kernels_refuse_misaligned_inputs(libs):
    """The bf16 kernels read 16 bytes at a time: a pointer off a 16-byte
    boundary is refused (the wrappers copy such a tensor first)."""
    q, k, v, do, _ = _inputs(1, 64, 64, 1, 1, 64, torch.bfloat16)
    flat = torch.zeros(q.numel() + 8, dtype=torch.bfloat16)
    q_off = flat[1:1 + q.numel()].view(q.shape)   # 2 bytes off
    out = torch.empty_like(q)
    assert libs[0].mxtpu_flash_fwd(*tfa._fwd_args(
        q_off, k, v, out, None, None, 0.125, False, None),
        None) == MISALIGNED
    assert tfa._aligned(q_off).data_ptr() % 16 == 0
    assert tfa._aligned(q) is q
    lse = torch.zeros(64)
    delta = torch.zeros(64)
    args = tfa._bwd_args(q_off, k, v, out, do, 0.125, False, None)
    assert libs[1].mxtpu_flash_bwd_dkv(
        q_off.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        do.data_ptr(), lse.data_ptr(), delta.data_ptr(), None,
        torch.empty_like(k).data_ptr(), torch.empty_like(v).data_ptr(), 1,
        *args, None) == MISALIGNED
    # K2 reads O too: a misaligned q or O is refused
    out_off = flat[1:1 + q.numel()].view(q.shape)
    for qq, oo in ((q_off, out), (q, out_off)):
        assert libs[1].mxtpu_flash_bwd_dq(
            qq.data_ptr(), k.data_ptr(), v.data_ptr(), oo.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(), None,
            torch.empty_like(q).data_ptr(), 1,
            *tfa._bwd_args(qq, k, v, oo, do, 0.125, False, None),
            None) == MISALIGNED


def test_library_tiles_equal_the_wrappers_constants(libs):
    """The tile sizes the libraries export are the constants the
    wrappers check (``chip_smoke.py`` holds the card's build to them
    too)."""
    fwd, bwd = libs
    assert (fwd.mxtpu_flash_fwd_block_q(), fwd.mxtpu_flash_fwd_block_k()) \
        == (tfa.FWD_BLOCK_Q, tfa.FWD_BLOCK_K)
    assert (bwd.mxtpu_flash_bwd_block_q(), bwd.mxtpu_flash_bwd_block_k()) \
        == (tfa.BWD_BLOCK_Q, tfa.BWD_BLOCK_K)
