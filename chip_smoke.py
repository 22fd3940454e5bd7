#!/usr/bin/env python3
"""On-card smoke test of mxnet_tpu_torch, the PyTorch / CUDA port.

    python3 chip_smoke.py            # every phase, one CUDA card

Phases, each printing JSON lines:

1. device:  the card's name, power limit and compute capability (9.0).
2. build:   nvcc builds every kernel under mxnet_tpu_torch/csrc/ (one
            nvcc a source, in parallel): ptxas' registers and spills for
            each kernel (no spill allowed in a tensor-core kernel at
            D <= 128), the HMMA (tensor-core) instructions in each
            kernel's SASS (cuobjdump), and the tile sizes the libraries
            export against the wrappers' constants.
3. kernels: each kernel against its plain PyTorch version on the card,
            with its device time, the plain version's, the library
            call's (F.scaled_dot_product_attention, forward or backward:
            a yardstick the package never calls) and its bound (the
            larger of bytes over 3.35 TB/s and operations over the
            type's peak): the flash forward (K1) and backward (K2 dQ, K3
            dK/dV), bf16 on the tensor cores and f32 on the CUDA cores.
            Device times are the kernels' own time on the card, summed
            by torch.profiler over a window of back-to-back calls
            (device_ms); ``launch_ms`` is the older host-paced reading
            (CUDA events around the calls), kept for the host's cost of
            a wrapper call. The library's backward computes dQ, dK and
            dV in one kernel, so K2 + K3 are compared with the whole of
            it; each one's share of it is only an estimate.
4. parity:  llama_tiny in float32 served through Server on the card (the
            flash kernel) gives the same greedy tokens as on the CPU (the
            plain version), and the kernel ran once per layer per
            admission.
5. serve:   the Llama-3-8B geometry (bf16 weights drawn on the card from a
            seeded generator) served through Server: 8 prompts of 20-500
            tokens in buckets (4, 128) and (4, 512), 32 new tokens each.
6. train_parity: bert_small (2 layers, vocab 200, f32, dropout 0) takes 3
            Adam steps on the card and on the CPU from the same weights:
            the losses agree to 1e-4 relative, and on the card every
            layer ran K1 and K2/K3 once per step.
7. train:   BERT-base pretraining as bench.py's bench_bert_pretrain runs
            it (batch 64, seq 128, 20 masked positions, Adam lr 1e-4,
            bf16 AMP, dropout 0.1; weights drawn on the card) through
            DataParallelTrainer.step: 3 warm-up steps, then the
            two-window slope timing, samples/s, MFU against the H100's
            dense bf16 peak, peak memory and a profiled step.
8. imperative_parity: bench.py's bench_mlp_train MLP (784-1024-1024-10,
            batch 512, f32) takes 3 steps of record -> backward ->
            gluon.Trainer("sgd", lr 0.05).step(512) on the card and on the
            CPU from the same weights: losses agree to 1e-4 relative, and
            so do all the weights (relative L2 difference).
9. imperative: the same MLP on the card through mx.nd arrays,
            hybridize(), autograd.record(), backward() and Trainer.step:
            warm-up, the two-window slope timing, samples/s, a profiled
            step (device busy share, kernels a step), peak memory; the
            loss falls.
10. rtc:    mx.rtc.CudaModule (K4) compiles the user kernels (the five of
            tests/test_rtc.py, in CUDA) with NVRTC for sm_90a; each against
            its plain version; axpy timed (device time) at 2^26 f32
            against torch.add and its bound; the host time of a launch; and one SGD update of the
            MLP's parameters through axpy on p.data() and p.grad(), equal
            to sgd_update's.

Then one line of per-kernel numbers ({"kernels": [...]}), the card's name
and power limit as nvidia-smi gives them, and as the last line
{"ok": true, "device": {...}}.  Any failed check exits nonzero.
``--phases`` runs a subset (for quick checks of a new kernel).
"""
from __future__ import annotations

import argparse
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

H100_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}   # dense; f32 without TF32
ALL_PHASES = ("device,build,kernels,parity,serve,train_parity,train,"
              "imperative_parity,imperative,rtc")


def emit(obj):
    print(json.dumps(obj), flush=True)


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


def nvidia_smi():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable: {e!r}"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() \
        else f"nvidia-smi: {out.stderr.strip()}"


def cuda_time_ms(fn, reps, warmup=2):
    """Host-paced time of one call: CUDA events around ``reps``
    back-to-back calls.  Where a call's host work (Python, checks,
    allocation, launch) outlasts its kernels, this reads the host."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps, warmup=2, by_kernel=False, tries=3):
    """Device time of one call: from one torch.profiler window of
    ``reps`` back-to-back calls, each CUDA kernel's (and copy's) mean
    self device time times its launches a call, summed.  The host's pace
    does not enter it.  Every call runs the same kernels, so each must
    be recorded a nonzero multiple of ``reps`` times; the profiler
    drops an event now and then (one NVRTC launch in 20), so a count
    within 10 % of such a multiple passes, and a window that lost more
    is taken again, up to ``tries`` windows.  With ``by_kernel`` also
    returns {kernel: ms a call}."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us, counts = {}, {}
        for ev in prof.key_averages():
            if ev.device_type == torch.autograd.DeviceType.CUDA \
                    and ev.self_device_time_total > 0:
                us[ev.key] = us.get(ev.key, 0.0) + ev.self_device_time_total
                counts[ev.key] = counts.get(ev.key, 0) + ev.count
        per_call = {k: round(n / reps) for k, n in counts.items()}
        if counts and all(per_call[k] >= 1
                          and abs(n - per_call[k] * reps) <= 0.1 * reps
                          for k, n in counts.items()):
            per = {k: us[k] / counts[k] * per_call[k] / 1e3 for k in us}
            total = sum(per.values())
            return (total, per) if by_kernel else total
    fail(f"device_ms: {tries} profiler windows of {reps} calls each "
         f"recorded kernels a number of times far from a multiple of the "
         f"calls: {counts}")


COUNTERS = ("flash_fwd_launches", "flash_bwd_launches",
            "flash_bwd_dq_launches", "flash_bwd_dkv_launches",
            "flash_fwd_tc_launches", "flash_bwd_dq_tc_launches",
            "flash_bwd_dkv_tc_launches")
# the counters of the CUDA-core f32 route: every launch counts there,
# and a bf16 launch also counts in its *_tc_launches
F32_ROUTE = COUNTERS[:4]


def reset_counts():
    """Set every kernel launch count to 0 (the flash kernels' and the
    user kernels' of mx.rtc)."""
    from mxnet_tpu_torch import rtc
    from mxnet_tpu_torch.ops import flash_attention as fa
    for name in COUNTERS:
        setattr(fa, name, 0)
    rtc.rtc_launches = 0


def read_counts():
    """{counter: launches since the last reset_counts()}."""
    from mxnet_tpu_torch.ops import flash_attention as fa
    return {name: getattr(fa, name) for name in COUNTERS}


# -- phase 3: kernels ---------------------------------------------------------

FLASH_CASES = [
    # the serving prefill's shapes (Llama-3-8B: H=32, KV=8, D=128)
    dict(name="prefill_s128_bf16", s_q=128, s_k=128, dtype="bfloat16",
         causal=True),
    dict(name="prefill_s512_bf16", s_q=512, s_k=512, dtype="bfloat16",
         causal=True),
    dict(name="prefill_s128_f32", s_q=128, s_k=128, dtype="float32",
         causal=True),
    dict(name="prefill_s512_f32", s_q=512, s_k=512, dtype="float32",
         causal=True),
    # the masks, each in both types: f32 at 1e-4 catches a key off by
    # one at a band or padding edge, which bf16's tolerance could hide
    dict(name="window_s1024_w256_bf16", s_q=1024, s_k=1024,
         dtype="bfloat16", causal=True, window=256),
    dict(name="window_s1024_w256_f32", s_q=1024, s_k=1024,
         dtype="float32", causal=True, window=256),
    dict(name="key_padding_s512_bf16", s_q=512, s_k=512, dtype="bfloat16",
         causal=False, b=2, kmask_lens=(300, 512)),
    dict(name="key_padding_s512_f32", s_q=512, s_k=512, dtype="float32",
         causal=False, b=2, kmask_lens=(300, 512)),
    dict(name="cross_causal_128x256_bf16", s_q=128, s_k=256,
         dtype="bfloat16", causal=True),
    dict(name="cross_causal_128x256_f32", s_q=128, s_k=256,
         dtype="float32", causal=True),
    dict(name="lse_s512_f32", s_q=512, s_k=512, dtype="float32",
         causal=True, want_lse=True),
    dict(name="lse_s512_causal_bf16", s_q=512, s_k=512, dtype="bfloat16",
         causal=True, want_lse=True),
    # a causal offset below 0 (S_k < S_q): no tile skip, and the first
    # 128 rows see no key, so they come out as the uniform average of V
    dict(name="short_keys_256x128_bf16", s_q=256, s_k=128,
         dtype="bfloat16", causal=True),
    # a band edge in the middle of a 64-key tile
    dict(name="window_s512_w100_bf16", s_q=512, s_k=512, dtype="bfloat16",
         causal=True, window=100),
    # the other head-dim instantiations (BERT's 64, and the 256 limit),
    # and a head dim the tensor cores take zero-padded to 80
    dict(name="d64_s256_bf16", s_q=256, s_k=256, dtype="bfloat16",
         causal=False, h=12, kv=12, d=64),
    dict(name="d72_s256_bf16", s_q=256, s_k=256, dtype="bfloat16",
         causal=True, h=8, kv=2, d=72),
    dict(name="d256_s256_bf16", s_q=256, s_k=256, dtype="bfloat16",
         causal=True, h=8, kv=2, d=256),
    dict(name="d256_s256_f32", s_q=256, s_k=256, dtype="float32",
         causal=True, h=8, kv=2, d=256),
    # BERT-base training's forward: b64 s128, H=KV=12, D=64, with the LSE
    dict(name="bert_b64_s128_lse_bf16", b=64, s_q=128, s_k=128,
         dtype="bfloat16", causal=False, h=12, kv=12, d=64, want_lse=True),
    dict(name="bert_b64_s128_lse_f32", b=64, s_q=128, s_k=128,
         dtype="float32", causal=False, h=12, kv=12, d=64, want_lse=True),
]
HEADLINE_CASE = "bert_b64_s128_lse_bf16"
SERVE_CASE = "prefill_s512_bf16"
TOL = {"bfloat16": 2e-2, "float32": 1e-4}

# the backward (K2 dQ, K3 dK/dV) against flash_bwd_plain, with a random
# dO; tolerance TOL[dtype] * max(1, max|ref|) on each gradient, and
# gradients the mask forces to zero must be exactly 0
BWD_CASES = [
    # BERT-base training: b64 s128, H=KV=12, D=64, no mask
    dict(name="bert_b64_s128_bf16", b=64, s_q=128, s_k=128, h=12, kv=12,
         d=64, dtype="bfloat16", causal=False),
    dict(name="bert_b64_s128_f32", b=64, s_q=128, s_k=128, h=12, kv=12,
         d=64, dtype="float32", causal=False),
    # Llama prefill (GQA H=32 over KV=8: K3 sums each group of 4)
    dict(name="llama_s512_bf16", s_q=512, s_k=512, dtype="bfloat16",
         causal=True),
    dict(name="llama_s512_f32", s_q=512, s_k=512, dtype="float32",
         causal=True),
    dict(name="window_s1024_w256_bf16", s_q=1024, s_k=1024,
         dtype="bfloat16", causal=True, window=256),
    dict(name="window_s1024_w256_f32", s_q=1024, s_k=1024,
         dtype="float32", causal=True, window=256),
    dict(name="key_padding_s512_bf16", s_q=512, s_k=512, dtype="bfloat16",
         causal=False, b=2, kmask_lens=(300, 512)),
    dict(name="key_padding_s512_f32", s_q=512, s_k=512, dtype="float32",
         causal=False, b=2, kmask_lens=(300, 512)),
    dict(name="key_padding_empty_row_s512_bf16", s_q=512, s_k=512,
         dtype="bfloat16", causal=False, b=2, kmask_lens=(0, 512)),
    dict(name="key_padding_empty_row_s512_f32", s_q=512, s_k=512,
         dtype="float32", causal=False, b=2, kmask_lens=(0, 512)),
    dict(name="cross_causal_128x256_bf16", s_q=128, s_k=256,
         dtype="bfloat16", causal=True),
    dict(name="cross_causal_128x256_f32", s_q=128, s_k=256,
         dtype="float32", causal=True),
    dict(name="short_keys_256x128_bf16", s_q=256, s_k=128,
         dtype="bfloat16", causal=True),
    dict(name="short_keys_256x128_f32", s_q=256, s_k=128, dtype="float32",
         causal=True),
    # keys 0-319 lie below every query's window: whole key tiles that
    # visit no query tile, whose dK and dV must be exactly 0
    dict(name="cross_window_128x512_w64_bf16", s_q=128, s_k=512,
         dtype="bfloat16", causal=True, window=64),
    # a band edge in the middle of a 64-key tile
    dict(name="window_s512_w100_bf16", s_q=512, s_k=512, dtype="bfloat16",
         causal=True, window=100),
    dict(name="d72_s256_bf16", s_q=256, s_k=256, dtype="bfloat16",
         causal=True, h=8, kv=2, d=72),
    dict(name="d256_s256_bf16", s_q=256, s_k=256, dtype="bfloat16",
         causal=True, h=8, kv=2, d=256),
    dict(name="d256_s256_f32", s_q=256, s_k=256, dtype="float32",
         causal=True, h=8, kv=2, d=256),
]
BWD_HEADLINE_CASE = "bert_b64_s128_bf16"


def _case_inputs(case, dev, n_q=1):
    """q, k, v (and ``n_q - 1`` more q-shaped tensors) drawn at std 1
    from a seeded generator, the key mask, and the (B, S_q, S_k) mask of
    visible pairs."""
    import torch
    from mxnet_tpu_torch.ops.attention import _causal_band

    b, h = case.get("b", 1), case.get("h", 32)
    kv, d = case.get("kv", 8), case.get("d", 128)
    s_q, s_k = case["s_q"], case["s_k"]
    dt = getattr(torch, case["dtype"])
    g = torch.Generator(device=dev)
    g.manual_seed(1234)
    q = torch.randn(b, s_q, h, d, generator=g, device=dev).to(dt)
    k = torch.randn(b, s_k, kv, d, generator=g, device=dev).to(dt)
    v = torch.randn(b, s_k, kv, d, generator=g, device=dev).to(dt)
    extra = [torch.randn(b, s_q, h, d, generator=g, device=dev).to(dt)
             for _ in range(n_q - 1)]
    kmask = None
    if "kmask_lens" in case:
        pos = torch.arange(s_k, device=dev)[None, :]
        lens = torch.tensor(case["kmask_lens"], device=dev)[:, None]
        kmask = (pos < lens).float()
    window = case.get("window")
    keep = torch.ones(s_q, s_k, dtype=torch.bool, device=dev)
    if case["causal"]:
        keep = _causal_band(s_q, s_k, window if window and window < s_k
                            else None, dev)
    keep = keep[None].expand(b, s_q, s_k)
    if kmask is not None:
        keep = keep & (kmask > 0)[:, None, :]
    return (q, k, v, *extra), kmask, keep


def _bound(flops, nbytes, dtype):
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _flash_case(case, dev):
    import torch
    import torch.nn.functional as F
    from mxnet_tpu_torch.ops import flash_attention as fa

    (q, k, v), kmask, keep = _case_inputs(case, dev)
    b, s_q, h, d = q.shape
    s_k, kv = k.shape[1], k.shape[2]
    dt = q.dtype
    window, causal = case.get("window"), case["causal"]
    want_lse = case.get("want_lse", False)
    scale = 1.0 / d ** 0.5

    out, lse = fa.flash_fwd(q, k, v, scale, causal=causal, kmask=kmask,
                            window=window, want_lse=want_lse)
    torch.cuda.synchronize()
    ref, ref_lse = fa.flash_attention_plain(
        q, k, v, scale, causal=causal, kmask=kmask, window=window,
        want_lse=want_lse)
    err = (out.float() - ref.float()).abs().max().item()
    check(torch.isfinite(out.float()).all().item(),
          f"{case['name']}: non-finite kernel output")
    tol = TOL[case["dtype"]]
    lse_err = None
    if want_lse:
        lse_err = (lse - ref_lse).abs().max().item()
        check(lse_err <= tol, f"{case['name']}: lse error {lse_err} > {tol}")
    check(err <= tol, f"{case['name']}: max abs error {err} > {tol}")

    def kernel():
        return fa.flash_fwd(q, k, v, scale, causal=causal, kmask=kmask,
                            window=window, want_lse=want_lse)
    kernel_ms = device_ms(kernel, reps=20)
    launch_ms = cuda_time_ms(kernel, reps=20)
    plain_ms = device_ms(lambda: fa.flash_attention_plain(
        q, k, v, scale, causal=causal, kmask=kmask, window=window,
        want_lse=want_lse), reps=5, warmup=1)

    # the work this run's masks need, and the bound it sets
    pairs = int(keep.sum().item())
    flops = 4.0 * h * d * pairs
    elem = 2 if dt == torch.bfloat16 else 4
    nbytes = elem * d * (2 * b * s_q * h + 2 * b * s_k * kv)
    if kmask is not None:
        nbytes += 4 * b * s_k
    if want_lse:
        nbytes += 4 * b * h * s_q
    bound_ms, bound_by = _bound(flops, nbytes, case["dtype"])

    # the library yardstick: (B, H, S, D) layout, GQA, same mask
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    lib_kw = _library_mask(case, keep, kmask)
    library_ms = device_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, enable_gqa=True, scale=scale, **lib_kw), reps=20)
    row = {"phase": "kernels", "kernel": "flash_fwd", "case": case["name"],
           "cores": _cores(dt), "b": b, "h": h, "kv": kv, "d": d,
           "s_q": s_q, "s_k": s_k,
           "dtype": case["dtype"], "causal": causal, "window": window,
           "key_padding": kmask is not None, "max_abs_err": err,
           "mean_abs_ref": ref.float().abs().mean().item(),
           "lse_max_abs_err": lse_err, "tol": tol, "kernel_ms": kernel_ms,
           "launch_ms": launch_ms, "plain_ms": plain_ms,
           "library_ms": library_ms, "bound_ms": bound_ms,
           "bound_by": bound_by, "kernel_over_library": kernel_ms / library_ms,
           "bound_over_kernel": bound_ms / kernel_ms, "flops": flops,
           "bytes": nbytes,
           "tflops_per_s": flops / (kernel_ms * 1e-3) / 1e12}
    emit(row)
    return row


def _cores(dtype):
    import torch
    return "tensor_cores" if dtype == torch.bfloat16 else "cuda_cores"


def _library_mask(case, keep, kmask):
    """F.scaled_dot_product_attention's mask arguments for a case."""
    if case["causal"] and case["s_q"] == case["s_k"] \
            and case.get("window") is None and kmask is None:
        return {"is_causal": True}
    if case["causal"] or kmask is not None:
        return {"attn_mask": keep[:, None]}
    return {}


def _flash_bwd_case(case, dev):
    """K2 and K3 against flash_bwd_plain on the kernel forward's output
    and LSE, with a random dO."""
    import torch
    import torch.nn.functional as F
    from mxnet_tpu_torch.ops import flash_attention as fa

    (q, k, v, g), kmask, keep = _case_inputs(case, dev, n_q=2)
    b, s_q, h, d = q.shape
    s_k, kv = k.shape[1], k.shape[2]
    window, causal = case.get("window"), case["causal"]
    scale = 1.0 / d ** 0.5
    kw = dict(causal=causal, kmask=kmask, window=window)
    out, lse = fa.flash_fwd(q, k, v, scale, want_lse=True, **kw)
    got = fa.flash_bwd(q, k, v, out, lse, g, scale, **kw)
    torch.cuda.synchronize()
    ref = fa.flash_bwd_plain(q, k, v, out, lse, g, scale, **kw)
    tol = TOL[case["dtype"]]
    errs, limits = {}, {}
    for name, a, r in zip(("dq", "dk", "dv"), got, ref):
        check(torch.isfinite(a.float()).all().item(),
              f"{case['name']}: non-finite {name}")
        errs[name] = (a.float() - r.float()).abs().max().item()
        limits[name] = tol * max(1.0, r.float().abs().max().item())
        check(errs[name] <= limits[name],
              f"{case['name']}: {name} max abs error {errs[name]} > "
              f"{limits[name]}")
    # exact zeros: a query that sees no key, a key that no query sees
    blind_q = ~keep.any(dim=2)                            # (B, S_q)
    blind_k = ~keep.any(dim=1)                            # (B, S_k)
    zeros = int(blind_q.sum().item()) * h * d \
        + 2 * int(blind_k.sum().item()) * kv * d
    check(bool((got[0][blind_q] == 0).all().item())
          and bool((got[1][blind_k] == 0).all().item())
          and bool((got[2][blind_k] == 0).all().item()),
          f"{case['name']}: a gradient the mask forces to zero is not 0")

    km = kmask.contiguous() if kmask is not None else None
    _, delta = fa._bwd_dq(q, k, v, out, g, lse, km, scale, causal, window)
    reps = 10

    def whole():
        return fa.flash_bwd(q, k, v, out, lse, g, scale, **kw)

    def dq_only():
        return fa._bwd_dq(q, k, v, out, g, lse, km, scale, causal, window)

    def dkv_only():
        return fa._bwd_dkv(q, k, v, out, g, lse, delta, km, scale, causal,
                           window)
    kernel_ms, dq_ms, dkv_ms = (device_ms(f, reps=reps)
                                for f in (whole, dq_only, dkv_only))
    launch_ms, dq_launch_ms, dkv_launch_ms = (
        cuda_time_ms(f, reps=reps) for f in (whole, dq_only, dkv_only))
    plain_ms = device_ms(
        lambda: fa.flash_bwd_plain(q, k, v, out, lse, g, scale, **kw),
        reps=3, warmup=1)

    # the library yardstick: the backward of F.scaled_dot_product_attention
    # on the same inputs, as (forward + backward) - forward
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_(True)
                  for x in (q, k, v))
    gt = g.transpose(1, 2).contiguous()
    lib_kw = dict(enable_gqa=True, scale=scale,
                  **_library_mask(case, keep, kmask))
    lib_fwd = device_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, **lib_kw), reps=reps)
    lib_all, lib_kernels = device_ms(lambda: torch.autograd.grad(
        F.scaled_dot_product_attention(qt, kt, vt, **lib_kw),
        (qt, kt, vt), gt), reps=reps, by_kernel=True)
    lib_bwd = lib_all - lib_fwd

    # the work this run's masks need: 5 products of 2*D per visible
    # (query, key) pair and query head (dQ: S, dP, dS K; dK/dV: S, dP,
    # P^T dO, dS^T Q); bytes: q, k, v, o, dO, LSE read, dq, dk, dv written
    pairs = int(keep.sum().item()) * h
    elem = q.element_size()
    q_bytes = elem * b * s_q * h * d
    kv_bytes = elem * b * s_k * kv * d
    lse_bytes = 4 * b * h * s_q
    mask_bytes = 4 * b * s_k if kmask is not None else 0
    total = (_bound(10.0 * d * pairs,
                    4 * q_bytes + 4 * kv_bytes + lse_bytes + mask_bytes,
                    case["dtype"]))
    # K2 also reads O and writes Delta (rowsum(dO o O), 2*D a query row)
    dq_bound = _bound(6.0 * d * pairs + 2.0 * d * b * s_q * h,
                      4 * q_bytes + 2 * kv_bytes + 2 * lse_bytes
                      + mask_bytes, case["dtype"])
    dkv_bound = _bound(8.0 * d * pairs, 2 * q_bytes + 4 * kv_bytes
                       + 2 * lse_bytes + mask_bytes, case["dtype"])
    # the library computes dQ, dK and dV in one kernel, so no run reads
    # either kernel's share of it: an estimate, in proportion to the
    # operations each does, is reported beside the measured whole
    dq_ops = 6.0 * d * pairs + 2.0 * d * b * s_q * h
    dq_share = lib_bwd * dq_ops / (dq_ops + 8.0 * d * pairs)
    dkv_share = lib_bwd - dq_share
    row = {"phase": "kernels", "kernel": "flash_bwd", "case": case["name"],
           "dq_cores": _cores(q.dtype), "dkv_cores": _cores(q.dtype),
           "b": b, "h": h, "kv": kv, "d": d, "s_q": s_q, "s_k": s_k,
           "dtype": case["dtype"], "causal": causal, "window": window,
           "key_padding": kmask is not None, "max_abs_err": errs,
           "limit": limits, "forced_zeros": zeros,
           "kernel_ms": kernel_ms, "dq_ms": dq_ms, "dkv_ms": dkv_ms,
           "launch_ms": launch_ms, "dq_launch_ms": dq_launch_ms,
           "dkv_launch_ms": dkv_launch_ms, "plain_ms": plain_ms,
           "library_ms": lib_bwd, "library_fwd_ms": lib_fwd,
           "library_fwd_bwd_ms": lib_all, "library_kernels": lib_kernels,
           "library_dq_share_est_ms": dq_share,
           "library_dkv_share_est_ms": dkv_share,
           "bound_ms": total[0], "bound_by": total[1],
           "dq_bound_ms": dq_bound[0], "dq_bound_by": dq_bound[1],
           "dkv_bound_ms": dkv_bound[0], "dkv_bound_by": dkv_bound[1],
           "kernel_over_library": kernel_ms / lib_bwd,
           "dq_over_library_share_est": dq_ms / dq_share,
           "dkv_over_library_share_est": dkv_ms / dkv_share,
           "bound_over_kernel": total[0] / kernel_ms,
           "dq_bound_over_kernel": dq_bound[0] / dq_ms,
           "dkv_bound_over_kernel": dkv_bound[0] / dkv_ms,
           "flops": 10.0 * d * pairs,
           "tflops_per_s": 10.0 * d * pairs / (kernel_ms * 1e-3) / 1e12}
    emit(row)
    return row


def phase_kernels(dev):
    import torch
    rows = [_flash_case(c, dev) for c in FLASH_CASES]
    bwd_rows = [_flash_bwd_case(c, dev) for c in BWD_CASES]
    torch.cuda.synchronize()
    emit({"phase": "kernels",
          "kernels": ["flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"]})
    return rows, bwd_rows


# -- phase 10: rtc (K4) --------------------------------------------------------

# User kernels: the five of tests/test_rtc.py, written in CUDA for
# mx.rtc.CudaModule (NVRTC).  They are user code, not the package's.
RTC_SOURCE = r"""
extern "C" __global__ void axpy(const float *x, float *y, float alpha,
                                int n) {
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i < n) y[i] = alpha * x[i] + y[i];
}

// one block per row: row r is scaled by r + 1
extern "C" __global__ void scale_rows(const float *x, float *out, int cols) {
    int r = blockIdx.x;
    for (int j = threadIdx.x; j < cols; j += blockDim.x)
        out[r * cols + j] = x[r * cols + j] * (float)(r + 1);
}

// two outputs: x + 1 and x * x
extern "C" __global__ void stats(const float *x, float *s, float *q, int n) {
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i < n) {
        float v = x[i];
        s[i] = v + 1.0f;
        q[i] = v * v;
    }
}

// block b covers rows [b * rows_per_block, (b + 1) * rows_per_block) and
// scales them by b + 1: the block mapping decides the result
extern "C" __global__ void ident(const float *x, float *out,
                                 int rows_per_block, int cols) {
    int b = blockIdx.x;
    int base = b * rows_per_block * cols;
    for (int k = threadIdx.x; k < rows_per_block * cols; k += blockDim.x)
        out[base + k] = x[base + k] * (float)(b + 1);
}

// a template: reached through exports= and its lowered name
template <typename T>
__global__ void fill(const float *x, T *out, int n) {
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i < n) out[i] = (T)x[i] + (T)1;
}
"""
RTC_EXPORTS = ("fill<float>", "fill<int>")
RTC_SIGNATURES = {
    "axpy": "const float *x, float *y, float alpha, int n",
    "scale_rows": "const float *x, float *out, int cols",
    "stats": "const float *x, float *s, float *q, int n",
    "ident": "const float *x, float *out, int rows_per_block, int cols",
    "fill<float>": "const float *x, float *out, int n",
    "fill<int>": "const float *x, int *out, int n",
}


def axpy_plain(x, y, alpha):
    return alpha * x + y


def scale_rows_plain(x):
    import torch
    rows = torch.arange(1, x.shape[0] + 1, dtype=x.dtype, device=x.device)
    return x * rows[:, None]


def stats_plain(x):
    return x + 1.0, x * x


def ident_plain(x, rows_per_block):
    import torch
    b = torch.arange(x.shape[0], device=x.device) // rows_per_block + 1
    return x * b.to(x.dtype)[:, None]


def fill_plain(x, dtype):
    return x.to(dtype) + 1


def _grid(n, block=256):
    return ((n + block - 1) // block, 1, 1), (block, 1, 1)


def rtc_kernel_cases(mx, ctx, mod, rows=512, cols=1024):
    """Every user kernel of ``mod`` against its plain version on ``ctx``
    (a card): the kernels, and {case: (max_abs_err, limit)}.  f32
    arithmetic to 1e-6, copies and integers exactly."""
    import torch
    from mxnet_tpu_torch import nd
    k = {name: mod.get_kernel(name, sig)
         for name, sig in RTC_SIGNATURES.items()}
    rng = np.random.RandomState(0)
    x = nd.array(rng.randn(rows, cols).astype("f4"), ctx=ctx)
    y = nd.array(rng.randn(rows, cols).astype("f4"), ctx=ctx)
    n = rows * cols
    res = {}

    def err(a, b):
        return (a._t.double() - b.double()).abs().max().item()

    y0 = y._t.clone()
    k["axpy"].launch([x, y, 2.0, n], ctx, *_grid(n))
    res["axpy"] = (err(y, axpy_plain(x._t, y0, 2.0)), 1e-6)
    out = nd.zeros((rows, cols), ctx=ctx)
    k["scale_rows"].launch([x, out, cols], ctx, (rows, 1, 1), (256, 1, 1))
    res["scale_rows"] = (err(out, scale_rows_plain(x._t)), 0.0)
    s, q = nd.zeros((rows, cols), ctx=ctx), nd.zeros((rows, cols), ctx=ctx)
    k["stats"].launch([x, s, q, n], ctx, *_grid(n))
    ps, pq = stats_plain(x._t)
    res["stats"] = (max(err(s, ps), err(q, pq)), 0.0)
    for rpb in (1, 2):
        out = nd.zeros((rows, cols), ctx=ctx)
        k["ident"].launch([x, out, rpb, cols], ctx, (rows // rpb, 1, 1),
                          (256, 1, 1))
        res[f"ident_rows_per_block_{rpb}"] = (err(out, ident_plain(x._t,
                                                                   rpb)), 0.0)
    for name, dt in (("fill<float>", torch.float32),
                     ("fill<int>", torch.int32)):
        out = nd.zeros((rows, cols), ctx=ctx, dtype=dt)
        k[name].launch([x, out, n], ctx, *_grid(n))
        res[name] = (err(out, fill_plain(x._t, dt)), 0.0)
    torch.cuda.synchronize()
    return k, res


def phase_rtc(mx, dev):
    """K4: NVRTC builds the user kernels; each against its plain version;
    axpy timed at 2^26 f32; one SGD update of the MLP through axpy."""
    import torch
    from mxnet_tpu_torch import autograd, gluon, nd, rtc

    ctx = mx.gpu(0)
    t0 = time.perf_counter()
    mod = rtc.CudaModule(RTC_SOURCE, exports=RTC_EXPORTS)
    compile_s = time.perf_counter() - t0
    k, cases = rtc_kernel_cases(mx, ctx, mod)
    for name, (err, limit) in cases.items():
        check(err <= limit, f"rtc: {name} max abs error {err} > {limit}")
    # compiled once per module, looked up once per (card, name)
    looked_up = len(mod._functions)
    again = mod.get_kernel("axpy", RTC_SIGNATURES["axpy"])
    check(len(mod._functions) == looked_up and again._lowered == "axpy",
          "rtc: a second get_kernel looked the kernel up again")
    try:
        mod.get_kernel("no_such_kernel", "float *x")
        fail("rtc: an unknown kernel did not raise")
    except mx.MXNetError:
        pass

    # axpy at 2^26 f32: 12 bytes an element (x, y read; y written)
    n = 1 << 26
    alpha = 0.5
    g = torch.Generator(device=dev)
    g.manual_seed(4)
    x = nd.NDArray(torch.randn(n, generator=g, device=dev), ctx=ctx)
    y = nd.NDArray(torch.randn(n, generator=g, device=dev), ctx=ctx)
    y0 = y._t.clone()
    grid, block = _grid(n)
    k["axpy"].launch([x, y, alpha, n], ctx, grid, block)
    big_err = (y._t - axpy_plain(x._t, y0, alpha)).abs().max().item()
    check(big_err <= 1e-6, f"rtc: axpy at 2^26 max abs error {big_err}")
    reps = 20

    def axpy():
        k["axpy"].launch([x, y, alpha, n], ctx, grid, block)
    ms = device_ms(axpy, reps=reps)
    launch_ms = cuda_time_ms(axpy, reps=reps)
    plain_ms = device_ms(lambda: axpy_plain(x._t, y._t, alpha), reps=reps)
    library_ms = device_ms(lambda: torch.add(y._t, x._t, alpha=alpha),
                           reps=reps)
    nbytes = 12 * n
    bound_ms, bound_by = _bound(2.0 * n, nbytes, "float32")

    # host time of a launch that hits every cache (a small array)
    small = nd.zeros((1024,), ctx=ctx)
    launch = 200
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(launch):
        k["axpy"].launch([small, small, 1.0, 1024], ctx, (4, 1, 1),
                         (256, 1, 1))
    host_us = (time.perf_counter() - t0) / launch * 1e6
    torch.cuda.synchronize()

    # the main path: one SGD update of the imperative MLP's parameters
    # through axpy on p.data() and p.grad(), against sgd_update from the
    # same start
    mx.random.seed(0)
    net = build_mlp(mx, ctx)
    xnp, ynp = mlp_batch(MLP["batch_size"], MLP["widths"][0])
    xb, yb = nd.array(xnp, ctx=ctx), nd.array(ynp, ctx=ctx)
    with autograd.record():
        loss = gluon.loss.SoftmaxCrossEntropyLoss()(net(xb), yb)
    loss.backward()
    params = list(net.collect_params().values())
    lr, rescale = MLP["lr"], 1.0 / MLP["batch_size"]
    want = []
    for p in params:
        w = p.data().copy()
        nd.sgd_update(w, p.grad(), lr=lr, wd=0.0, rescale_grad=rescale,
                      out=w)
        want.append(w)
    torch.cuda.synchronize()
    reset_counts()
    for p in params:
        w = p.data()
        k["axpy"].launch([p.grad(), w, -lr * rescale, w.size], ctx,
                         *_grid(w.size))
    torch.cuda.synchronize()
    launches = rtc.rtc_launches
    sgd_err = max((p.data()._t - w._t).abs().max().item()
                  for p, w in zip(params, want))
    equal = all(torch.equal(p.data()._t, w._t) for p, w in zip(params, want))
    row = {"phase": "rtc", "nvrtc": list(rtc.nvrtc_version()),
           "arch": rtc.ARCH, "compile_s": compile_s,
           "cubin_bytes": mod.cubin_bytes, "kernels": sorted(k),
           "cases": {c: {"max_abs_err": e, "limit": l}
                     for c, (e, l) in cases.items()},
           "axpy_n": n, "axpy_max_abs_err": big_err, "axpy_ms": ms,
           "axpy_launch_ms": launch_ms, "axpy_plain_ms": plain_ms, "axpy_library_ms": library_ms,
           "axpy_bound_ms": bound_ms, "axpy_bound_by": bound_by,
           "axpy_bytes": nbytes,
           "axpy_gb_per_s": nbytes / (ms * 1e-3) / 1e9,
           "host_us_per_launch": host_us, "sgd_params": len(params),
           "sgd_launches": launches, "sgd_max_abs_diff": sgd_err,
           "sgd_equal": equal, "card": nvidia_smi()}
    emit(row)
    check(launches == len(params),
          f"rtc: {launches} axpy launches for {len(params)} parameters")
    check(equal, f"rtc: the axpy SGD update differs from sgd_update's by "
          f"{sgd_err}")
    return row


# -- phases 8 and 9: the imperative path ---------------------------------------

# bench.py's bench_mlp_train: 784-1024-1024-10 ReLU MLP, batch 512, SGD at
# lr 0.05, Xavier weights
MLP = dict(widths=(784, 1024, 1024, 10), batch_size=512, lr=0.05,
           steps=30, warmup=5)


def build_mlp(mx, ctx, widths=MLP["widths"], seed=None):
    """bench_mlp_train's net on ``ctx``, hybridized (it runs eagerly)."""
    from mxnet_tpu_torch.gluon import nn
    net = nn.HybridSequential()
    with net.name_scope():
        net.add(nn.Dense(widths[1], activation="relu", in_units=widths[0]),
                nn.Dense(widths[2], activation="relu", in_units=widths[1]),
                nn.Dense(widths[3], in_units=widths[2]))
    net.initialize(mx.init.Xavier(), ctx=ctx, seed=seed)
    net.hybridize()
    return net


def mlp_batch(batch_size, in_units, classes=10):
    """The bench's batch: uniform inputs, random class labels (float32)."""
    rng = np.random.RandomState(0)
    return (rng.rand(batch_size, in_units).astype("f4"),
            rng.randint(0, classes, batch_size).astype("f4"))


def mlp_step_fn(mx, net, ctx, xnp, ynp, lr=MLP["lr"]):
    """One training step: record -> backward -> Trainer("sgd").step;
    returns the per-sample loss NDArray (not synchronised)."""
    from mxnet_tpu_torch import autograd, gluon, nd
    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": lr}, kvstore=None)
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    x, y = nd.array(xnp, ctx=ctx), nd.array(ynp, ctx=ctx)
    batch_size = xnp.shape[0]

    def step():
        with autograd.record():
            loss = loss_fn(net(x), y)
        loss.backward()
        trainer.step(batch_size)
        return loss
    return step


def phase_imperative_parity(mx, dev, steps=3):
    """3 SGD steps on the card and on the CPU from the same weights.

    The weights are held by their relative L2 difference over all
    parameters.  An elementwise bound per tensor does not hold between
    two summation orders here: the bench's batch has ReLU
    pre-activations within 1.2e-7 of zero, so the card flips a few ReLU
    masks that the CPU does not, and each flip moves one sample's whole
    contribution to a gradient row (up to 2 % of a small bias after 3
    steps).  Both numbers are emitted."""
    b = MLP["batch_size"]
    xnp, ynp = mlp_batch(b, MLP["widths"][0])
    cpu_net = build_mlp(mx, mx.cpu(), seed=5)
    card_net = build_mlp(mx, mx.gpu(0), seed=5)
    for src, dst in zip(cpu_net.collect_params().values(),
                        card_net.collect_params().values()):
        dst.set_data(src.data())
    losses, weights = [], []
    for net, ctx in ((cpu_net, mx.cpu()), (card_net, mx.gpu(0))):
        step = mlp_step_fn(mx, net, ctx, xnp, ynp)
        losses.append([step().mean().asscalar() for _ in range(steps)])
        weights.append([p.data().asnumpy().astype("f8")
                        for p in net.collect_params().values()])
    cpu_losses, card_losses = losses
    rel = max(abs(g - c) / abs(c) for g, c in zip(card_losses, cpu_losses))
    cpu_w, card_w = weights
    diff = math.sqrt(sum(float(np.square(g - c).sum())
                         for g, c in zip(card_w, cpu_w)))
    norm = math.sqrt(sum(float(np.square(c).sum()) for c in cpu_w))
    per_tensor = {name: {"max_abs_diff": float(np.abs(g - c).max()),
                         "max_abs": float(np.abs(c).max())}
                  for name, g, c in zip(cpu_net.collect_params().keys(),
                                        card_w, cpu_w)}
    emit({"phase": "imperative_parity", "model": "mlp_784_1024_1024_10",
          "batch_size": b, "dtype": "float32", "steps": steps,
          "cpu_losses": cpu_losses, "gpu_losses": card_losses,
          "max_rel_diff": rel, "weights_rel_l2_diff": diff / norm,
          "per_tensor": per_tensor})
    check(rel <= 1e-4, f"imperative_parity: losses differ by {rel}")
    check(diff / norm <= 1e-4,
          f"imperative_parity: weights differ by {diff / norm} (L2)")
    check(card_losses[-1] < card_losses[0],
          "imperative_parity: the loss did not fall")


def phase_imperative(mx, dev, cfg=MLP):
    """bench_mlp_train's loop on the card: warm-up, then the two-window
    slope timing and a profiled step."""
    import torch
    from mxnet_tpu_torch import nd
    b, steps, warmup = cfg["batch_size"], cfg["steps"], cfg["warmup"]
    mx.random.seed(0)
    net = build_mlp(mx, mx.gpu(0))
    n_params = sum(p.data().size for p in net.collect_params().values())
    xnp, ynp = mlp_batch(b, cfg["widths"][0])
    step = mlp_step_fn(mx, net, mx.gpu(0), xnp, ynp, lr=cfg["lr"])
    first = step().mean().asscalar()
    for _ in range(warmup - 1):
        step()
    nd.waitall()

    def timed_window(n):
        t0 = time.perf_counter()
        for _ in range(n):
            last = step()
        val = last.mean().asscalar()
        check(math.isfinite(val), f"imperative: loss {val} is not finite")
        return time.perf_counter() - t0, val

    n1 = steps // 3
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    t_small, _ = timed_window(n1)
    dt, last = timed_window(steps)
    peak = torch.cuda.max_memory_allocated(dev)
    slope = (dt - t_small) / (steps - n1)
    naive = dt / steps
    slope_used = "slope"
    if slope <= 0 or slope < 0.2 * naive:
        slope, slope_used = naive, "naive"
    breakdown = profile_call(step)
    flops = 6.0 * n_params * b
    emit({"phase": "imperative", "model": "mlp_784_1024_1024_10",
          "dtype": "float32", "batch_size": b, "params": n_params,
          "warmup": warmup, "windows": [n1, steps],
          "window_s": [t_small, dt], "step_ms": slope * 1e3,
          "naive_step_ms": naive * 1e3, "timing": slope_used,
          "samples_per_s": b / slope, "flops_per_step": flops,
          "bound_ms": flops / PEAK_FLOPS["float32"] * 1e3,
          "kernels_per_step": breakdown["kernels"],
          "device_busy_share": breakdown["device_busy_share"],
          "first_loss": first, "last_loss": last, "peak_mem_bytes": peak,
          "card": nvidia_smi()})
    emit(dict({"phase": "imperative_breakdown", "call": "step_b512"},
              **breakdown))
    check(last < first, f"imperative: last loss {last} not below the "
          f"first {first}")


# -- phase 4: parity -----------------------------------------------------------

def phase_parity(mx, dev):
    import numpy as np
    import torch
    from mxnet_tpu_torch.models import LlamaForCausalLM, llama_tiny
    from mxnet_tpu_torch.serving import Server

    vocab = 256
    cpu_lm = LlamaForCausalLM(llama_tiny(vocab_size=vocab), ctx=mx.cpu())
    cpu_lm.initialize(std=0.3, seed=7)
    gpu_lm = LlamaForCausalLM(llama_tiny(vocab_size=vocab), ctx=mx.gpu(0))
    gpu_lm.load_state_dict(cpu_lm.state_dict())
    rng = np.random.RandomState(3)
    prompts = [rng.randint(0, vocab, n).astype("f4")
               for n in (30, 77, 128, 100)]
    cpu_out = Server(cpu_lm, buckets=[(2, 128)], max_new_tokens=8,
                     ctx=mx.cpu()).generate(prompts)
    reset_counts()
    srv = Server(gpu_lm, buckets=[(2, 128)], max_new_tokens=8,
                 ctx=mx.gpu(0))
    gpu_out = srv.generate(prompts)
    torch.cuda.synchronize()
    counts = read_counts()
    launches = counts["flash_fwd_launches"]
    admissions = srv.stats()["buckets"]["2x128"]["prefills"]
    layers = len(gpu_lm.model.layers)
    same = all(np.array_equal(a, b) for a, b in zip(cpu_out, gpu_out))
    emit({"phase": "parity", "model": "llama_tiny", "dtype": "float32",
          "requests": len(prompts), "admissions": admissions,
          "flash_fwd_launches": launches,
          "flash_fwd_tc_launches": counts["flash_fwd_tc_launches"],
          "layers": layers, "tokens_equal": same})
    check(same, "parity: greedy tokens on the card differ from the CPU's")
    check(launches == admissions * layers,
          f"parity: {launches} flash launches, want {admissions} x {layers}")
    check(counts["flash_fwd_tc_launches"] == 0,
          "parity: an f32 forward took the tensor-core route")


# -- phase 5: serve ------------------------------------------------------------

def phase_serve(mx, dev):
    import numpy as np
    import torch
    from mxnet_tpu_torch.models import LlamaForCausalLM, llama3_8b
    from mxnet_tpu_torch.serving import Server

    t0 = time.perf_counter()
    mx.random.seed(0)
    lm = LlamaForCausalLM(llama3_8b(), tie_embeddings=False,
                          ctx=mx.gpu(0), dtype="bfloat16")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in lm.parameters())
    weight_bytes = sum(p.numel() * p.element_size() for p in lm.parameters())
    vocab = lm.model.vocab_size

    # every logits tensor the server reads is checked on the device
    nonfinite = torch.zeros((), dtype=torch.long, device=dev)

    def checked(fn):
        def wrapper(*a, **kw):
            out = fn(*a, **kw)
            nonfinite.add_((~torch.isfinite(out)).sum())
            return out
        return wrapper
    plain_prefill, plain_decode = lm.prefill, lm.decode_step
    lm.prefill = checked(plain_prefill)
    lm.decode_step = checked(plain_decode)

    new_tokens = 32
    srv = Server(lm, buckets=[(4, 128), (4, 512)],
                 max_new_tokens=new_tokens, ctx=mx.gpu(0),
                 cache_dtype="bfloat16")
    rng = np.random.RandomState(11)
    # warm-up: one short request (cuBLAS handles, first-call overheads)
    srv.generate([rng.randint(0, vocab, 20).astype("f4")],
                 max_new_tokens=2)
    torch.cuda.synchronize()
    before = srv.stats()["buckets"]
    lens = [20, 64, 100, 128, 200, 333, 450, 500]
    prompts = [rng.randint(0, vocab, n).astype("f4") for n in lens]

    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    t0 = time.perf_counter()
    reqs = [srv.submit(p) for p in prompts]
    srv.run()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    counts = read_counts()
    launches = counts["flash_fwd_launches"]
    tc_launches = counts["flash_fwd_tc_launches"]
    after = srv.stats()["buckets"]

    delta = {k: {f: after[k][f] - before[k][f] for f in after[k]}
             for k in after}
    admissions = sum(d["prefills"] for d in delta.values())
    tokens = sum(d["tokens"] for d in delta.values())
    decode_tokens = tokens - admissions
    decode_s = sum(d["decode_s"] for d in delta.values())
    prefill_s = sum(d["prefill_s"] for d in delta.values())
    ttft = [r.first_token_t - r.submit_t for r in reqs]
    layers = len(lm.model.layers)
    bad = int(nonfinite.item())
    emit({"phase": "serve", "model": "llama3_8b", "dtype": "bfloat16",
          "params": n_params, "weight_bytes": weight_bytes,
          "weights_init_s": init_s, "buckets": ["4x128", "4x512"],
          "prompt_lens": lens, "new_tokens": new_tokens,
          "requests": len(reqs), "admissions": admissions,
          "flash_fwd_launches": launches,
          "flash_fwd_tc_launches": tc_launches, "layers": layers,
          "ttft_p50_s": statistics.median(ttft), "ttft_max_s": max(ttft),
          "prefill_s": prefill_s, "decode_s": decode_s,
          "tokens": tokens, "decode_tokens": decode_tokens, "wall_s": wall_s,
          "tokens_per_wall_s": tokens / wall_s,
          "peak_mem_bytes": torch.cuda.max_memory_allocated(dev),
          "nonfinite_logits": bad, "per_bucket": delta,
          "card": nvidia_smi()})
    for r in reqs:
        gen = np.asarray(r.generated)
        check(r.state == "done" and len(gen) == new_tokens,
              f"serve: request {r.id} ended {r.state} with {len(gen)} "
              "tokens")
        check(((gen >= 0) & (gen < vocab)).all(),
              f"serve: request {r.id} has tokens out of range")
    check(bad == 0, f"serve: {bad} non-finite logits")
    check(admissions == len(reqs), f"serve: {admissions} admissions")
    check(launches == admissions * layers,
          f"serve: {launches} flash launches, want {admissions} x {layers}")
    check(tc_launches == launches,
          f"serve: {tc_launches} of {launches} bf16 flash launches took "
          "the tensor-core route")

    # where the time goes: one prefill per bucket and one 4-slot decode
    # step, outside the counted run
    lm.prefill, lm.decode_step = plain_prefill, plain_decode
    for s in (128, 512):
        caches = lm.init_cache(1, s + new_tokens, dtype="bfloat16")
        tok = torch.as_tensor(rng.randint(0, vocab, (1, s)).astype("f4"),
                              device=dev)
        last = torch.tensor([s - 1.0], device=dev)
        emit(dict({"phase": "serve_breakdown", "call": f"prefill_s{s}"},
                  **profile_call(lambda: lm.prefill(
                      tok, [(k[:, :s], v[:, :s]) for k, v in caches],
                      last_pos=last))))
    caches = lm.init_cache(4, 512 + new_tokens, dtype="bfloat16")
    tok = torch.zeros((4, 1), device=dev)
    off = torch.tensor([20.0, 100.0, 300.0, 500.0], device=dev)
    emit(dict({"phase": "serve_breakdown", "call": "decode_4slots_c544"},
              **profile_call(lambda: lm.decode_step(tok, caches, off))))
    return launches


# -- phases 6 and 7: training -------------------------------------------------

def _full_len_pretrain(mod):
    """bench.py's ``_FullLenPretrain``: BERTForPretrain with
    ``valid_length=None`` (full-length rows, no padding mask)."""
    from mxnet_tpu_torch.gluon import Block

    class FullLenPretrain(Block):
        def __init__(self, mod):
            super().__init__()
            self.mod = mod

        def forward(self, tokens, types, positions):
            return self.mod(tokens, types, None, positions)
    return FullLenPretrain(mod)


def _pretrain_loss(m):
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    sce = SoftmaxCrossEntropyLoss()

    def loss_fn(outs, label):
        mlm_labels = label[:, :m].reshape((-1,))
        nsp_labels = label[:, m]
        mlm_scores, nsp_scores = outs
        mlm = sce(mlm_scores, mlm_labels).mean()
        return mlm + sce(nsp_scores, nsp_labels).mean()
    return loss_fn


def _pretrain_batch(vocab, b, seq_len, m, dev):
    """bench.py's batch: tokens, types, masked positions and labels from
    np.random.RandomState(0), as float32 on ``dev``."""
    import numpy as np
    import torch
    rng = np.random.RandomState(0)
    tokens = torch.as_tensor(
        rng.randint(0, vocab, (b, seq_len)).astype("f"), device=dev)
    types = torch.as_tensor(
        rng.randint(0, 2, (b, seq_len)).astype("f"), device=dev)
    positions = torch.as_tensor(
        rng.randint(0, seq_len, (b, m)).astype("f"), device=dev)
    label = torch.as_tensor(np.concatenate(
        [rng.randint(0, vocab, (b, m)), rng.randint(0, 2, (b, 1))],
        axis=1).astype("f"), device=dev)
    return (tokens, types, positions), label


def phase_train_parity(mx, dev):
    """bert_small, 2 layers, f32, dropout 0: 3 Adam steps on the card and
    on the CPU from the same weights."""
    import torch
    from mxnet_tpu_torch import models, parallel

    vocab, b, seq_len, m, steps, layers = 200, 2, 128, 4, 3, 2
    losses = []
    weights = None
    for ctx in (mx.cpu(), mx.gpu(0)):
        inner = models.BERTForPretrain(models.bert_small(
            vocab_size=vocab, max_length=128, dropout=0.0,
            num_layers=layers))
        model = _full_len_pretrain(inner).initialize(
            mx.init.Xavier(), ctx=ctx, seed=5)
        if weights is None:
            weights = {k: t.clone() for k, t in model.state_dict().items()}
        else:
            model.load_state_dict(weights)
        dpt = parallel.DataParallelTrainer(
            model, _pretrain_loss(m), "adam", {"learning_rate": 1e-3},
            mesh=parallel.make_mesh({"dp": 1}, devices=[ctx]),
            fuse_step=True)
        data, label = _pretrain_batch(vocab, b, seq_len, m, ctx.device)
        reset_counts()
        losses.append([dpt.step(data, label).item() for _ in range(steps)])
        launches = read_counts()
    cpu_losses, card_losses = losses
    rel = max(abs(g - c) / abs(c) for g, c in zip(card_losses, cpu_losses))
    emit({"phase": "train_parity", "model": "bert_small", "layers": layers,
          "dtype": "float32", "steps": steps, "cpu_losses": cpu_losses,
          "gpu_losses": card_losses, "max_rel_diff": rel, **launches})
    check(rel <= 1e-4, f"train_parity: losses differ by {rel} relative")
    check(all(launches[n] == steps * layers for n in F32_ROUTE),
          f"train_parity: launches {launches}, want {steps * layers} each")
    check(all(launches[n] == 0 for n in COUNTERS
              if n.endswith("_tc_launches")),
          f"train_parity: f32 launches took the tensor-core route: "
          f"{launches}")
    check(card_losses[-1] < card_losses[0],
          "train_parity: the loss did not fall")


# bench.py's bert_base configuration (bench_bert_pretrain's arguments)
BERT_BASE = dict(model="bert_base", vocab=30522, batch_size=64,
                 seq_len=128, num_masked=20, hidden=768, layers=12,
                 steps=20, warmup=3, max_length=512)


def phase_train(mx, dev, ctx, cfg=BERT_BASE):
    """bench.py's bench_bert_pretrain at ``cfg`` on ``ctx``."""
    import torch
    from mxnet_tpu_torch import models, parallel
    from mxnet_tpu_torch.contrib import amp

    vocab, batch_size = cfg["vocab"], cfg["batch_size"]
    seq_len, num_masked = cfg["seq_len"], cfg["num_masked"]
    hidden, layers = cfg["hidden"], cfg["layers"]
    steps, warmup = cfg["steps"], cfg["warmup"]
    mx.random.seed(0)
    amp.init(target_dtype="bfloat16")
    try:
        make_bert = getattr(models, cfg["model"])
        inner = models.BERTForPretrain(make_bert(
            vocab_size=vocab, max_length=cfg["max_length"], dropout=0.1))
        model = _full_len_pretrain(inner)
        t0 = time.perf_counter()
        model.initialize(mx.init.Xavier(), ctx=ctx)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        b, m = batch_size, num_masked
        mesh = parallel.make_mesh({"dp": 1}, devices=[ctx.device])
        dpt = parallel.DataParallelTrainer(model, _pretrain_loss(m), "adam",
                                           {"learning_rate": 1e-4},
                                           mesh=mesh, fuse_step=True)
        data, label = _pretrain_batch(vocab, b, seq_len, m, ctx.device)
        first = None
        for _ in range(warmup):
            loss = dpt.step(data, label)
            first = loss.item() if first is None else first
        torch.cuda.synchronize()

        def timed_window(n):
            t0 = time.perf_counter()
            last = None
            for _ in range(n):
                last = dpt.step(data, label)
            val = last.item()
            check(math.isfinite(val), f"train: loss {val} is not finite")
            return time.perf_counter() - t0, val

        n1 = max(min(steps // 3, steps - 1), 1)
        torch.cuda.reset_peak_memory_stats(dev)
        reset_counts()
        t_small, _ = timed_window(n1)
        dt, last = timed_window(steps)
        launches = read_counts()
        peak = torch.cuda.max_memory_allocated(dev)
        slope = (dt - t_small) / (steps - n1)
        naive = dt / steps
        slope_used = "slope"
        if slope <= 0 or slope < 0.2 * naive:
            slope, slope_used = naive, "naive"
        breakdown = profile_call(lambda: dpt.step(data, label))
    finally:
        amp._deinit()

    sps = batch_size / slope
    embed = {id(inner.bert.word_embed.weight),
             id(inner.bert.token_type_embed.weight),
             id(inner.bert.position_embed)}
    n_params = sum(p.numel() for p in model.parameters()
                   if id(p) not in embed)
    flops_v1 = (6 * n_params * seq_len
                + 12 * layers * hidden * seq_len * seq_len)
    flops_v2 = flops_v1 + 6 * num_masked * hidden * vocab
    n_steps = n1 + steps
    emit({"phase": "train", "model": cfg["model"],
          "dtype": "bfloat16 AMP",
          "batch_size": batch_size, "seq_len": seq_len,
          "num_masked": num_masked, "vocab": vocab, "layers": layers,
          "params": sum(p.numel() for p in model.parameters()),
          "non_embedding_params": n_params, "weights_init_s": init_s,
          "warmup": warmup, "windows": [n1, steps],
          "window_s": [t_small, dt], "step_ms": slope * 1e3,
          "naive_step_ms": naive * 1e3, "timing": slope_used,
          "samples_per_s": sps,
          "mfu_v1": sps * flops_v1 / PEAK_FLOPS["bfloat16"],
          "mfu_v2": sps * flops_v2 / PEAK_FLOPS["bfloat16"],
          "first_loss": first, "last_loss": last, **launches,
          "steps_counted": n_steps,
          "peak_mem_bytes": peak, "card": nvidia_smi()})
    emit(dict({"phase": "train_breakdown", "call": "step_b64_s128"},
              **breakdown))
    check(last < first, f"train: last loss {last} not below the first "
          f"{first}")
    # bf16 AMP: every K1, K2 and K3 launch on the tensor cores, so every
    # counter (the *_tc_launches too) is layers x steps
    check(all(n == layers * n_steps for n in launches.values()),
          f"train: launches {launches}, want {layers} x {n_steps} each")
    return launches


def profile_call(fn, reps=3):
    """Host wall time of ``fn`` (ending in a synchronize; median of
    ``reps``), and the device time of one profiled call split into the
    flash kernels (forward, backward), matrix products and the rest."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    fwd = bwd = gemm = other = 0.0
    n_kernels = 0
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = ev.self_device_time_total
        n_kernels += ev.count
        name = ev.key.lower()
        if "flash_fwd" in name:
            fwd += us
        elif "flash_bwd" in name:
            bwd += us
        elif any(t in name for t in ("gemm", "gemv", "cutlass", "nvjet",
                                     "xmma", "matmul")):
            gemm += us
        else:
            other += us
    device_ms = (fwd + bwd + gemm + other) / 1e3
    wall_ms = statistics.median(walls)
    return {"wall_ms": wall_ms,
            "device_ms": device_ms if n_kernels else "not measured",
            "flash_ms": (fwd + bwd) / 1e3, "flash_fwd_ms": fwd / 1e3,
            "flash_bwd_ms": bwd / 1e3, "gemm_ms": gemm / 1e3,
            "other_ms": other / 1e3, "kernels": n_kernels,
            "device_busy_share": device_ms / wall_ms if n_kernels else None}


# -- phase 2: build -------------------------------------------------------------

def _kernel_name(mangled):
    """``flash_fwd_tc_kernel<64,64>`` from a mangled kernel name."""
    m = re.search(r"\d(flash_[a-z0-9_]*?_kernel)I((?:Li\d+E|f|13__nv_bfloat16)+)E",
                  mangled)
    if m is None:
        return mangled
    args = [a or ("float" if f else "bf16") for a, f, _ in re.findall(
        r"Li(\d+)E|(f)|(13__nv_bfloat16)", m.group(2))]
    return f"{m.group(1)}<{','.join(args)}>"


def _ptxas_report(log):
    """{kernel: {registers, spill_stores, spill_loads}} from nvcc's
    -Xptxas=-v output."""
    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = out.setdefault(_kernel_name(m.group(1)), {})
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and cur is not None:
            cur["spill_stores"], cur["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m and cur is not None:
            cur["registers"] = int(m.group(1))
    return out


def _hmma_counts(sass):
    """{kernel: HMMA (tensor-core) instructions} from cuobjdump -sass."""
    out, cur = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = _kernel_name(m.group(1))
            out[cur] = 0
        elif cur is not None and "HMMA" in line:
            out[cur] += 1
    return out


def phase_build():
    """Build every source (one nvcc each, in parallel); per kernel
    ptxas' registers and spills and the HMMA instructions of its SASS.
    Every tensor-core kernel must contain HMMA, and none may spill at a
    head dim <= 128.  The tile sizes the libraries export must equal
    the wrappers' constants."""
    from mxnet_tpu_torch import _kernels
    from mxnet_tpu_torch._kernels.build import _lib_path, _nvcc
    from mxnet_tpu_torch.ops import flash_attention as fa
    t0 = time.perf_counter()
    took = _kernels.build()
    seconds = time.perf_counter() - t0
    cuobjdump = os.path.join(os.path.dirname(_nvcc()), "cuobjdump")
    per_source = {}
    for n in _kernels.sources():
        kern = _ptxas_report(_kernels.build_log(n))
        sass = subprocess.run([cuobjdump, "-sass", _lib_path(n)],
                              capture_output=True, text=True, timeout=300)
        check(sass.returncode == 0, f"build: cuobjdump {n}: {sass.stderr}")
        for k, count in _hmma_counts(sass.stdout).items():
            kern.setdefault(k, {})["hmma"] = count
        per_source[n] = {"hmma": sum(v.get("hmma", 0) for v in kern.values()),
                         "kernels": kern}
    fwd, bwd = fa._kernel(), fa._bwd_kernels()
    tiles = {"flash_fwd": [fwd.mxtpu_flash_fwd_block_q(),
                           fwd.mxtpu_flash_fwd_block_k()],
             "flash_bwd": [bwd.mxtpu_flash_bwd_block_q(),
                           bwd.mxtpu_flash_bwd_block_k()]}
    emit({"phase": "build", "sources": _kernels.sources(),
          "seconds": seconds, "per_source_s": took, "tiles": tiles,
          "per_source": per_source})
    for n, s in per_source.items():
        for k, v in s["kernels"].items():
            if "_tc_kernel" not in k:
                continue
            check(v.get("hmma", 0) > 0, f"build: {k} has no HMMA instruction")
            if int(re.search(r"<(\d+)", k).group(1)) <= 128:
                check(v.get("spill_stores") == 0 and v.get("spill_loads") == 0,
                      f"build: {k} spills: {v}")
    check(tiles == {"flash_fwd": [fa.FWD_BLOCK_Q, fa.FWD_BLOCK_K],
                    "flash_bwd": [fa.BWD_BLOCK_Q, fa.BWD_BLOCK_K]},
          f"build: the libraries' tiles {tiles} differ from the wrappers'")


# -- the kernels line ------------------------------------------------------------

DESIGN = {
    "tensor_cores": "bf16: mma.sync m16n8k16 on the tensor cores (f32 "
                    "accumulate), 4 warps of 16 rows, tiles by 16-byte "
                    "cp.async, double-buffered, ldmatrix fragments",
    "cuda_cores": "f32 FMAs on the CUDA cores, 256 threads, tiles staged "
                  "in shared memory as f32",
}


def _ratios(ms, library_ms, bound_ms):
    return {"kernel_over_library": ms / library_ms,
            "bound_over_kernel": bound_ms / ms}


def kernel_entries(rows, bwd_rows, train, serve_launches):
    """The flash kernels' entries of the {"kernels": [...]} line: each
    at BERT's training shape in bf16 (the main path's route), with its
    f32 route's numbers at the same shape, and K1 also at the serving
    prefill."""
    fwd = {r["case"]: r for r in rows}
    bwd = {r["case"]: r for r in bwd_rows}
    head, serve = fwd.get(HEADLINE_CASE), fwd.get(SERVE_CASE)
    b16, b32 = bwd.get(BWD_HEADLINE_CASE), bwd.get("bert_b64_s128_f32")
    f32 = fwd.get("bert_b64_s128_lse_f32")
    if None in (head, serve, b16, b32, f32):
        return []
    src = "mxnet_tpu_torch/csrc/"

    def fwd_nums(r):
        return dict({"case": r["case"], "cores": r["cores"],
                     "max_abs_err": r["max_abs_err"], "ms": r["kernel_ms"],
                     "launch_ms": r["launch_ms"], "plain_ms": r["plain_ms"],
                     "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                     "library_ms": r["library_ms"]},
                    **_ratios(r["kernel_ms"], r["library_ms"], r["bound_ms"]))

    def bwd_nums(r, part):
        err = (r["max_abs_err"]["dq"] if part == "dq" else
               max(r["max_abs_err"]["dk"], r["max_abs_err"]["dv"]))
        ms, est = r[f"{part}_ms"], r[f"library_{part}_share_est_ms"]
        return {"case": r["case"], "cores": r[f"{part}_cores"],
                "max_abs_err": err, "ms": ms,
                "launch_ms": r[f"{part}_launch_ms"],
                "plain_ms": r["plain_ms"],
                "bound_ms": r[f"{part}_bound_ms"],
                "bound_by": r[f"{part}_bound_by"],
                "library_ms": r["library_ms"],
                "library_share_est_ms": est,
                "k2_plus_k3_ms": r["kernel_ms"],
                "kernel_over_library": r["kernel_ms"] / r["library_ms"],
                "over_library_share_est": ms / est,
                "bound_over_kernel": r[f"{part}_bound_ms"] / ms}
    whole = ("plain_ms is flash_bwd_plain and library_ms the backward of "
             "F.scaled_dot_product_attention, each computing dq, dk and "
             "dv together; kernel_over_library is K2 + K3 (k2_plus_k3_ms) "
             "over it. library_share_est_ms is an estimate, not a "
             "reading: the library's backward split between K2 and K3 in "
             "proportion to their operations")
    return [
        dict({"name": "flash_fwd", "route": "cuda",
              "design": DESIGN["tensor_cores"],
              "source": src + "flash_fwd.cu",
              "replaces": "mxnet_tpu/ops/flash_attention.py:76",
              "launches": train.get("flash_fwd_launches"),
              "tc_launches": train.get("flash_fwd_tc_launches"),
              "serve_launches": serve_launches, "serve": fwd_nums(serve),
              "f32": dict(fwd_nums(f32), design=DESIGN["cuda_cores"])},
             **fwd_nums(head)),
        dict({"name": "flash_bwd_dq", "route": "cuda",
              "design": DESIGN["tensor_cores"],
              "source": src + "flash_bwd.cu",
              "replaces": "mxnet_tpu/ops/flash_attention.py:303",
              "launches": train.get("flash_bwd_dq_launches"),
              "tc_launches": train.get("flash_bwd_dq_tc_launches"),
              "f32": dict(bwd_nums(b32, "dq"), design=DESIGN["cuda_cores"]),
              "plain_and_library": whole}, **bwd_nums(b16, "dq")),
        dict({"name": "flash_bwd_dkv", "route": "cuda",
              "design": DESIGN["tensor_cores"],
              "source": src + "flash_bwd.cu",
              "replaces": "mxnet_tpu/ops/flash_attention.py:386",
              "launches": train.get("flash_bwd_dkv_launches"),
              "tc_launches": train.get("flash_bwd_dkv_tc_launches"),
              "f32": dict(bwd_nums(b32, "dkv"), design=DESIGN["cuda_cores"]),
              "plain_and_library": whole}, **bwd_nums(b16, "dkv")),
    ]


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=ALL_PHASES,
                    help="comma-separated subset of phases to run")
    args = ap.parse_args()
    phases = set(args.phases.split(","))

    if not os.path.isdir(os.path.join(HERE, "mxnet_tpu_torch")):
        fail("mxnet_tpu_torch/ is not beside chip_smoke.py; run it from a "
             "checkout of the repository")
    try:
        import torch
    except ImportError as e:
        fail(f"PyTorch is not installed: {e}")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke needs a card")
    sys.path.insert(0, HERE)
    import mxnet_tpu_torch as mx

    # float32 matmuls in full float32, as the kernel's contract
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = mx.gpu(0).device
    card = nvidia_smi()
    name = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    if "device" in phases:
        emit({"phase": "device", "nvidia_smi": card, "name": name,
              "capability": list(cap), "count": torch.cuda.device_count(),
              "torch": torch.__version__, "cuda": torch.version.cuda})
    check(cap == (9, 0), f"compute capability {cap}, want (9, 0) (Hopper)")

    if "build" in phases:
        phase_build()

    rows, bwd_rows = phase_kernels(dev) if "kernels" in phases \
        else ([], [])
    if "parity" in phases:
        phase_parity(mx, dev)
    serve_launches = phase_serve(mx, dev) if "serve" in phases else None
    if "train_parity" in phases:
        phase_train_parity(mx, dev)
    train = phase_train(mx, dev, mx.gpu(0)) if "train" in phases \
        else {}
    if "imperative_parity" in phases:
        phase_imperative_parity(mx, dev)
    if "imperative" in phases:
        phase_imperative(mx, dev)
    rtc = phase_rtc(mx, dev) if "rtc" in phases else None

    kernels = kernel_entries(rows, bwd_rows, train, serve_launches)
    if rtc is not None:
        kernels.append(
            {"name": "rtc_axpy", "route": "cuda",
             "design": "user CUDA compiled by NVRTC for sm_90a (CUBIN)",
             "source": "mxnet_tpu_torch/rtc.py",
             "user_kernel_source": "chip_smoke.py RTC_SOURCE",
             "replaces": "mxnet_tpu/rtc.py:109",
             "case": "axpy_2^26_f32", "launches": rtc["sgd_launches"],
             "max_abs_err": rtc["axpy_max_abs_err"], "ms": rtc["axpy_ms"],
             "plain_ms": rtc["axpy_plain_ms"],
             "bound_ms": rtc["axpy_bound_ms"],
             "bound_by": rtc["axpy_bound_by"],
             "library_ms": rtc["axpy_library_ms"],
             "launch_ms": rtc["axpy_launch_ms"],
             "kernel_over_library": rtc["axpy_ms"] / rtc["axpy_library_ms"],
             "bound_over_kernel": rtc["axpy_bound_ms"] / rtc["axpy_ms"],
             "library_call": "torch.add(y, x, alpha=a)"})
    if kernels:
        emit({"kernels": kernels})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
