#!/usr/bin/env python3
"""On-card smoke test of mxnet_tpu_torch, the PyTorch / CUDA port.

    python3 chip_smoke.py            # every phase, one CUDA card

Phases, each printing JSON lines:

1. device:  the card's name, power limit and compute capability (9.0).
2. build:   nvcc builds every kernel under mxnet_tpu_torch/csrc/.
3. kernels: each kernel against its plain PyTorch version on the card,
            with its time, the plain version's, the library call's
            (F.scaled_dot_product_attention, a yardstick the package never
            calls) and its bound (the larger of bytes over 3.35 TB/s and
            operations over the type's peak).
4. parity:  llama_tiny in float32 served through Server on the card (the
            flash kernel) gives the same greedy tokens as on the CPU (the
            plain version), and the kernel ran once per layer per
            admission.
5. serve:   the Llama-3-8B geometry (bf16 weights drawn on the card from a
            seeded generator) served through Server: 8 prompts of 20-500
            tokens in buckets (4, 128) and (4, 512), 32 new tokens each.

Then one line of per-kernel numbers ({"kernels": [...]}), the card's name
and power limit as nvidia-smi gives them, and as the last line
{"ok": true, "device": {...}}.  Any failed check exits nonzero.
``--phases`` runs a subset (for quick checks of a new kernel).
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

H100_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}   # dense; f32 without TF32


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
    # the other head-dim instantiations (BERT's 64, and the 256 limit)
    dict(name="d64_s256_bf16", s_q=256, s_k=256, dtype="bfloat16",
         causal=False, h=12, kv=12, d=64),
    dict(name="d256_s256_f32", s_q=256, s_k=256, dtype="float32",
         causal=True, h=8, kv=2, d=256),
]
HEADLINE_CASE = "prefill_s512_bf16"
TOL = {"bfloat16": 2e-2, "float32": 1e-4}


def _flash_case(case, dev):
    import torch
    import torch.nn.functional as F
    from mxnet_tpu_torch.ops import flash_attention as fa
    from mxnet_tpu_torch.ops.attention import _causal_band

    b, h = case.get("b", 1), case.get("h", 32)
    kv, d = case.get("kv", 8), case.get("d", 128)
    s_q, s_k = case["s_q"], case["s_k"]
    dt = getattr(torch, case["dtype"])
    window, causal = case.get("window"), case["causal"]
    want_lse = case.get("want_lse", False)
    g = torch.Generator(device=dev)
    g.manual_seed(1234)
    q = torch.randn(b, s_q, h, d, generator=g, device=dev).to(dt)
    k = torch.randn(b, s_k, kv, d, generator=g, device=dev).to(dt)
    v = torch.randn(b, s_k, kv, d, generator=g, device=dev).to(dt)
    kmask = None
    if "kmask_lens" in case:
        pos = torch.arange(s_k, device=dev)[None, :]
        lens = torch.tensor(case["kmask_lens"], device=dev)[:, None]
        kmask = (pos < lens).float()
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

    kernel_ms = cuda_time_ms(lambda: fa.flash_fwd(
        q, k, v, scale, causal=causal, kmask=kmask, window=window,
        want_lse=want_lse), reps=20)
    plain_ms = cuda_time_ms(lambda: fa.flash_attention_plain(
        q, k, v, scale, causal=causal, kmask=kmask, window=window,
        want_lse=want_lse), reps=5, warmup=1)

    # the work this run's masks need, and the bound it sets
    keep = torch.ones(s_q, s_k, dtype=torch.bool, device=dev)
    if causal:
        keep = _causal_band(s_q, s_k, window if window and window < s_k
                            else None, dev)
    keep = keep[None].expand(b, s_q, s_k)
    if kmask is not None:
        keep = keep & (kmask > 0)[:, None, :]
    pairs = int(keep.sum().item())
    flops = 4.0 * h * d * pairs
    elem = 2 if dt == torch.bfloat16 else 4
    nbytes = elem * d * (2 * b * s_q * h + 2 * b * s_k * kv)
    if kmask is not None:
        nbytes += 4 * b * s_k
    if want_lse:
        nbytes += 4 * b * h * s_q
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[case["dtype"]] * 1e3
    bound_ms, bound_by = (t_bytes, "bytes") if t_bytes >= t_ops \
        else (t_ops, "operations")

    # the library yardstick: (B, H, S, D) layout, GQA, same mask
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    lib_kw = {}
    if causal and s_q == s_k and window is None and kmask is None:
        lib_kw["is_causal"] = True
    elif causal or kmask is not None:
        lib_kw["attn_mask"] = keep[:, None]
    library_ms = cuda_time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, enable_gqa=True, scale=scale, **lib_kw), reps=20)
    row = {"phase": "kernels", "kernel": "flash_fwd", "case": case["name"],
           "b": b, "h": h, "kv": kv, "d": d, "s_q": s_q, "s_k": s_k,
           "dtype": case["dtype"], "causal": causal, "window": window,
           "key_padding": kmask is not None, "max_abs_err": err,
           "mean_abs_ref": ref.float().abs().mean().item(),
           "lse_max_abs_err": lse_err, "tol": tol, "kernel_ms": kernel_ms,
           "plain_ms": plain_ms, "library_ms": library_ms,
           "bound_ms": bound_ms, "bound_by": bound_by, "flops": flops,
           "bytes": nbytes,
           "tflops_per_s": flops / (kernel_ms * 1e-3) / 1e12}
    emit(row)
    return row


def phase_kernels(dev):
    import torch
    rows = [_flash_case(c, dev) for c in FLASH_CASES]
    torch.cuda.synchronize()
    emit({"phase": "kernels", "kernels": ["flash_fwd"]})
    return rows


# -- phase 4: parity -----------------------------------------------------------

def phase_parity(mx, dev):
    import numpy as np
    import torch
    from mxnet_tpu_torch.models import LlamaForCausalLM, llama_tiny
    from mxnet_tpu_torch.ops import flash_attention as fa
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
    fa.flash_fwd_launches = 0
    srv = Server(gpu_lm, buckets=[(2, 128)], max_new_tokens=8,
                 ctx=mx.gpu(0))
    gpu_out = srv.generate(prompts)
    torch.cuda.synchronize()
    launches = fa.flash_fwd_launches
    admissions = srv.stats()["buckets"]["2x128"]["prefills"]
    layers = len(gpu_lm.model.layers)
    same = all(np.array_equal(a, b) for a, b in zip(cpu_out, gpu_out))
    emit({"phase": "parity", "model": "llama_tiny", "dtype": "float32",
          "requests": len(prompts), "admissions": admissions,
          "flash_fwd_launches": launches, "layers": layers,
          "tokens_equal": same})
    check(same, "parity: greedy tokens on the card differ from the CPU's")
    check(launches == admissions * layers,
          f"parity: {launches} flash launches, want {admissions} x {layers}")


# -- phase 5: serve ------------------------------------------------------------

def phase_serve(mx, dev):
    import numpy as np
    import torch
    from mxnet_tpu_torch.models import LlamaForCausalLM, llama3_8b
    from mxnet_tpu_torch.ops import flash_attention as fa
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
    fa.flash_fwd_launches = 0
    t0 = time.perf_counter()
    reqs = [srv.submit(p) for p in prompts]
    srv.run()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = fa.flash_fwd_launches
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
          "flash_fwd_launches": launches, "layers": layers,
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


def profile_call(fn, reps=3):
    """Host wall time of ``fn`` (ending in a synchronize; median of
    ``reps``), and the device time of one profiled call split into the
    flash kernel, matrix products and the rest."""
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
    flash = gemm = other = 0.0
    n_kernels = 0
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = ev.self_device_time_total
        n_kernels += ev.count
        name = ev.key.lower()
        if "flash_fwd" in name:
            flash += us
        elif any(t in name for t in ("gemm", "gemv", "cutlass", "nvjet",
                                     "xmma", "matmul")):
            gemm += us
        else:
            other += us
    device_ms = (flash + gemm + other) / 1e3
    wall_ms = statistics.median(walls)
    return {"wall_ms": wall_ms,
            "device_ms": device_ms if n_kernels else "not measured",
            "flash_ms": flash / 1e3, "gemm_ms": gemm / 1e3,
            "other_ms": other / 1e3, "kernels": n_kernels,
            "device_busy_share": device_ms / wall_ms if n_kernels else None}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default="device,build,kernels,parity,serve",
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
    from mxnet_tpu_torch import _kernels

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
        t0 = time.perf_counter()
        took = _kernels.build()
        ptxas = {n: [ln.strip() for ln in _kernels.build_log(n).splitlines()
                     if "registers" in ln or "spill" in ln]
                 for n in _kernels.sources()}
        emit({"phase": "build", "sources": _kernels.sources(),
              "seconds": time.perf_counter() - t0, "per_source_s": took,
              "ptxas": ptxas})

    rows = phase_kernels(dev) if "kernels" in phases else []
    if "parity" in phases:
        phase_parity(mx, dev)
    launches = phase_serve(mx, dev) if "serve" in phases else None

    head = next((r for r in rows if r["case"] == HEADLINE_CASE), None)
    if head is not None:
        emit({"kernels": [{
            "name": "flash_fwd", "route": "cuda",
            "source": "mxnet_tpu_torch/csrc/flash_fwd.cu",
            "replaces": "mxnet_tpu/ops/flash_attention.py:76",
            "launches": launches, "max_abs_err": head["max_abs_err"],
            "ms": head["kernel_ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"]}]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
