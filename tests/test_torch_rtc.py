"""``mx.rtc`` (K4) on the CPU: what runs without a card.

NVRTC and the CUDA driver exist only on the card's machine, where
``chip_smoke.py``'s ``rtc`` phase compiles the user kernels and holds
each against its plain version.  Here: the signature parser, the
argument checks (type, contiguity, device), the raises (a CPU context, a
missing library, an unknown kernel), the caching (compile once per
module, look up once per kernel) against stand-ins for the two
libraries, and each user kernel's plain version against the JAX
package's ``PallasModule`` kernel run under the Pallas interpreter, as
``tests/test_rtc.py`` runs it.
"""
import ctypes
import re

import numpy as np
import pytest
import torch

import chip_smoke
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import nd, rtc
from mxnet_tpu_torch.base import MXNetError

CPU = mx.cpu()


def test_signature_parser():
    assert rtc._parse_signature(
        "const float *x, float* y,float alpha ,  int n") == [
        (True, True, "float"), (True, False, "float"),
        (False, False, "float"), (False, False, "int")]
    assert rtc._parse_signature("const __half *h, int64_t k, uint8_t *m")\
        == [(True, True, "__half"), (False, False, "int64_t"),
            (True, False, "uint8_t")]
    assert rtc._parse_signature("double") == [(False, False, "double")]
    for bad in ("float **x", "const", "float x y", ""):
        with pytest.raises(MXNetError, match="invalid"):
            rtc._parse_signature(bad)
    with pytest.raises(MXNetError, match="unsupported"):
        rtc._parse_signature("bfloat16 *x")


def _kernel(signature):
    return rtc.CudaKernel(None, "k", "k", signature)


def test_argument_checks():
    k = _kernel("const float *x, float *y, float a, int n, __half h")
    x = nd.array(np.ones((2, 3), "f4"), ctx=CPU)
    y = nd.zeros((2, 3), ctx=CPU)
    vals = k._check_args([x, y, 2.0, 6, 1.5], torch.device("cpu"))
    assert vals[0].value == x.tensor.data_ptr()
    assert isinstance(vals[2], ctypes.c_float) and vals[2].value == 2.0
    assert isinstance(vals[3], ctypes.c_int32) and vals[3].value == 6
    assert vals[4].value == int(np.float16(1.5).view(np.uint16))
    with pytest.raises(MXNetError, match="takes 5 arguments"):
        k._check_args([x, y, 2.0], torch.device("cpu"))
    with pytest.raises(MXNetError, match="int32"):
        k._check_args([x, y.astype("int32"), 2.0, 6, 1.0],
                      torch.device("cpu"))
    with pytest.raises(MXNetError, match="contiguous"):
        k._check_args([x, nd.zeros((3, 2), ctx=CPU).T, 2.0, 6, 1.0],
                      torch.device("cpu"))
    with pytest.raises(MXNetError, match="NDArray"):
        k._check_args([x.asnumpy(), y, 2.0, 6, 1.0], torch.device("cpu"))
    with pytest.raises(MXNetError, match="number"):
        k._check_args([x, y, x, 6, 1.0], torch.device("cpu"))
    with pytest.raises(MXNetError, match="number"):
        k._check_args([x, y, 2.0, True, 1.0], torch.device("cpu"))
    with pytest.raises(MXNetError, match="the launch on cuda:0"):
        k._check_args([x, y, 2.0, 6, 1.0], torch.device("cuda", 0))


def test_launch_needs_a_gpu_context():
    k = _kernel("float *y")
    y = nd.zeros((4,), ctx=CPU)
    with pytest.raises(MXNetError, match="GPU context"):
        k.launch([y], CPU, (1, 1, 1), (4, 1, 1))
    with pytest.raises(MXNetError, match="GPU context"):
        k.launch([y], "gpu", (1, 1, 1), (4, 1, 1))
    if not torch.cuda.is_available():
        with pytest.raises(MXNetError, match="CUDA"):
            k.launch([y], mx.gpu(0), (1, 1, 1), (4, 1, 1))


def test_missing_libraries_raise_and_name_them(monkeypatch, tmp_path):
    monkeypatch.setattr(rtc, "_libs", {})
    monkeypatch.setattr(rtc, "_nvrtc_dirs", lambda: [str(tmp_path)])
    with pytest.raises(MXNetError, match="libnvrtc"):
        rtc.CudaModule("extern \"C\" __global__ void k() {}")

    def no_lib(path, *a, **kw):
        raise OSError(f"{path}: cannot open shared object file")
    monkeypatch.setattr(rtc.ctypes, "CDLL", no_lib)
    with pytest.raises(MXNetError, match="libcuda.so.1"):
        rtc._cuda()
    with pytest.raises(MXNetError, match="string"):
        rtc.CudaModule(b"bytes are not source")


def test_compiles_once_and_looks_up_once(monkeypatch):
    """Against stand-ins for NVRTC and the driver: one compile per
    module, one lookup per (card, kernel), lowered names for exports,
    and an unknown kernel raises."""
    compiles, lookups = [], []

    def fake_compile(source, options, exports):
        compiles.append((source, options, exports))
        return b"CUBIN", {e: f"_lowered_{i}" for i, e in enumerate(exports)}

    def fake_load(cubin, device_id, modules, name):
        lookups.append((device_id, name))
        if name not in ("axpy", "_lowered_0"):
            raise MXNetError(f"kernel {name!r} is not in the module")
        modules.setdefault(device_id, object())
        return ctypes.c_void_p(1234)

    monkeypatch.setattr(rtc, "_compile", fake_compile)
    monkeypatch.setattr(rtc, "_load_function", fake_load)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    mod = rtc.CudaModule("src", options=("-lineinfo",),
                         exports=("fill<float>",))
    assert compiles == [("src", ("-lineinfo",), ("fill<float>",))]
    assert mod.cubin_bytes == 5
    k1 = mod.get_kernel("axpy", "const float *x, float *y")
    k2 = mod.get_kernel("axpy", "const float *x, float *y")
    kf = mod.get_kernel("fill<float>", "const float *x, float *out, int n")
    assert lookups == [(0, "axpy"), (0, "_lowered_0")]
    assert k1._lowered == k2._lowered == "axpy"
    assert kf._lowered == "_lowered_0" and len(compiles) == 1
    with pytest.raises(MXNetError, match="not in the module"):
        mod.get_kernel("nope", "float *x")


def test_get_kernel_needs_a_card(monkeypatch):
    monkeypatch.setattr(rtc, "_compile", lambda *a: (b"C", {}))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(MXNetError, match="CUDA device"):
        rtc.CudaModule("src").get_kernel("axpy", "float *y")


def test_user_kernel_sources_match_their_signatures():
    """Each signature chip_smoke.py launches with names the parameter
    types of its kernel in RTC_SOURCE (NVRTC cannot check that here)."""
    src = chip_smoke.RTC_SOURCE
    for name, sig in chip_smoke.RTC_SIGNATURES.items():
        base = name.split("<")[0]
        m = re.search(r"void\s+" + re.escape(base) + r"\s*\(([^)]*)\)", src)
        assert m, name
        params = [p.strip() for p in m.group(1).split(",")]
        want = rtc._parse_signature(sig)
        assert len(params) == len(want), name
        for p, (is_ptr, is_const, ctype) in zip(params, want):
            if "<" in name and p.startswith("T"):
                ctype = {"fill<float>": "T", "fill<int>": "T"}[name]
            assert p.startswith("const") == is_const, (name, p)
            assert ("*" in p) == is_ptr, (name, p)
            assert re.search(r"\b" + re.escape(ctype) + r"\b", p), (name, p)
    assert set(chip_smoke.RTC_EXPORTS) <= set(chip_smoke.RTC_SIGNATURES)


# -- the plain versions against the JAX package's Pallas kernels -------------


def _pallas(kernels, name, args, **launch):
    from mxnet_tpu import nd as jnd, rtc as jrtc
    k = jrtc.PallasModule(kernels).get_kernel(name, interpret=True)
    return [o.asnumpy() for o in k.launch([jnd.array(a) for a in args],
                                          **launch)]


def test_axpy_plain_matches_pallas():
    def axpy(x_ref, y_ref, o_ref, *, alpha):
        o_ref[...] = alpha * x_ref[...] + y_ref[...]
    from mxnet_tpu import rtc as jrtc
    rng = np.random.RandomState(0)
    x, y = rng.randn(8, 16).astype("f4"), rng.randn(8, 16).astype("f4")
    k = jrtc.PallasModule({"axpy": axpy}).get_kernel("axpy", alpha=2.0,
                                                     interpret=True)
    from mxnet_tpu import nd as jnd
    (want,) = k.launch([jnd.array(x), jnd.array(y)], out_shapes=[(8, 16)])
    got = chip_smoke.axpy_plain(torch.from_numpy(x), torch.from_numpy(y),
                                2.0)
    np.testing.assert_allclose(got.numpy(), want.asnumpy(), rtol=1e-6,
                               atol=1e-6)


def test_scale_rows_and_ident_plain_match_pallas():
    from jax.experimental import pallas as pl

    def scaled(x_ref, o_ref):
        o_ref[...] = x_ref[...] * (pl.program_id(0) + 1)
    x = np.random.RandomState(1).randn(4, 8).astype("f4")
    t = torch.from_numpy(x)
    for rows, grid in ((1, 4), (2, 2)):
        spec = [pl.BlockSpec((rows, 8), lambda i: (i, 0))]
        (want,) = _pallas({"k": scaled}, "k", [x], grid=(grid,),
                          out_shapes=[(4, 8)], in_specs=spec,
                          out_specs=spec)
        np.testing.assert_array_equal(
            chip_smoke.ident_plain(t, rows).numpy(), want)
        if rows == 1:
            np.testing.assert_array_equal(
                chip_smoke.scale_rows_plain(t).numpy(), want)


def test_stats_and_fill_plain_match_pallas():
    def stats(x_ref, s_ref, q_ref):
        s_ref[...] = x_ref[...] + 1.0
        q_ref[...] = x_ref[...] * x_ref[...]

    def fill(x_ref, o_ref):
        o_ref[...] = x_ref[...].astype(o_ref.dtype) + 1
    x = np.random.RandomState(2).uniform(-3, 3, (2, 3)).astype("f4")
    t = torch.from_numpy(x)
    s, q = _pallas({"stats": stats}, "stats", [x],
                   out_shapes=[(2, 3), (2, 3)])
    ps, pq = chip_smoke.stats_plain(t)
    np.testing.assert_array_equal(ps.numpy(), s)
    np.testing.assert_array_equal(pq.numpy(), q)
    for dtype, tdt in (("float32", torch.float32), ("int32", torch.int32)):
        (want,) = _pallas({"fill": fill}, "fill", [x], out_shapes=[(2, 3)],
                          out_dtypes=[dtype])
        got = chip_smoke.fill_plain(t, tdt).numpy()
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
