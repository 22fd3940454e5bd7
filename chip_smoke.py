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
            it; each one's share of it is only an estimate.  Each
            output is held to an absolute limit (TOL) and to two
            scale-free ones: the worst row's error over that row's rms
            in the plain version, and the tensor's relative L2
            (ROW_TOL, L2_TOL), printed beside the reference's typical
            size; the same measures of the plain output with half its
            positions zeroed must exceed both.
4. parity:  llama_tiny in float32 on the card against the CPU: Server's
            greedy tokens with decode_steps 1 and 4 (every dispatch a
            graph replay after its variant's first graph, the flash
            kernel once per layer per admission, counted through the
            replays), generate_fused's greedy tokens (an eager call, the
            captured call, a replay) against the CPU's generate, and
            generate_beam's sequences (exactly) and scores (1e-4); given
            an NDArray prompt on the card, all three return NDArrays on
            the prompt's context with the same tokens.
5. serve:   the Llama-3-8B geometry (bf16 weights drawn on the card from a
            seeded generator) served through Server: 8 prompts of 20-500
            tokens in buckets (4, 128) and (4, 512), 32 new tokens each,
            in three windows after a warm-up: decode_steps=1 twice and
            decode_steps=8 (the last two must capture nothing: every
            dispatch a steady replay); TTFT, tokens per wall second,
            decode ms a step, captures, replays, graph pools, peak
            memory; profiled
            eager and replayed calls (prefill S=512, 4-slot decode);
            two sampled runs after one mx.random.seed, equal; then
            generate_fused at B=4, S=512, 32 new tokens (timed replays,
            K1 once per layer a call) and sampled (temperature 0.8,
            top_k 50): one seed gives equal tokens at every replay.
6. train_parity: bert_small (2 layers, vocab 200, f32, dropout 0) takes 3
            Adam steps on the card and on the CPU from the same weights,
            through bench.py's HybridBlock and DataParallelTrainer(
            fuse_step=True) fed NDArrays (on the card: a warm-up step,
            the captured step, a replay): the losses agree to 1e-4
            relative, and on the card every layer ran K1 and K2/K3 once
            per step, counted through the replays.
7. train_capture_parity: the same bert_small, 4 steps: the captured
            trainer's losses against the eager trainer's on the card
            (1e-6 relative) and the CPU's (1e-4); step_multi(repeat=4)
            of a fresh captured trainer against the 4 step() calls, bit
            for bit; one capture each.
8. dropout: dropout inside a captured step: two replays draw different
            masks, each keeping 1 - p of the elements (within 1 %),
            scaled by 1 / (1 - p).
9. train:   BERT-base pretraining as bench.py's bench_bert_pretrain runs
            it (batch 64, seq 128, 20 masked positions, Adam lr 1e-4,
            bf16 AMP, dropout 0.1; weights drawn on the card) through
            DataParallelTrainer(fuse_step=True): 3 warm-up steps and a
            step_multi(repeat=8), then step and step_multi(repeat=8),
            each timed by the two-window slope, as one graph replay a
            step (one capture, replays = steps, each launch counter =
            layers x steps); samples/s, MFU against the H100's dense
            bf16 peak, peak memory and the graph's pool; then the eager
            trainer (fuse_step=False) on the same model, timed the same
            way; a profiled replayed step beside a profiled eager one.
10. imperative_parity: bench.py's bench_mlp_train MLP (784-1024-1024-10,
            batch 512, f32) takes 3 steps through
            gluon.Trainer("sgd", lr 0.05).compile_step on the card and
            on the CPU from the same weights: losses agree to 1e-4
            relative, and so do all the weights (relative L2
            difference); one capture on the card.
11. imperative: the same MLP on the card through compile_step, as
            bench.py drives it: warm-up, the two-window slope timing,
            samples/s, a profiled step (device busy share, kernels a
            step), peak memory; then the gluon record -> backward ->
            Trainer.step loop on the same net, timed and profiled the
            same way; the loss falls.  No compiled step may fall back to
            the eager loop in phases 10-11.
12. rtc:    mx.rtc.CudaModule (K4) compiles the user kernels (the five of
            tests/test_rtc.py, in CUDA) with NVRTC for sm_90a; each against
            its plain version; axpy timed (device time, CUDA events
            behind a spin kernel) at 2^26 f32 against torch.add and its
            bound; the host time of a launch; and one SGD update of the
            MLP's parameters through axpy on p.data() and p.grad(), equal
            to sgd_update's.
13. resnet_parity: resnet18_v1 and resnet18_v2 (thumbnail, 10 classes,
            batch 4, 32 x 32, float32, cuDNN's TF32 flag left at
            PyTorch's default) on the card against the CPU from the same
            weights: predict and training-mode outputs and running
            statistics; hybridized (a CachedOp: eager warm-up, capture,
            replays of the forward and of the backward graph) against
            unhybridized; an earlier replay's output and gradient kept
            by a later replay; set_data read by the next replay; all
            within 1e-4 relative.  Then 3 SGD steps through
            DataParallelTrainer(fuse_step=True) with the net inline (no
            capture of its own): bit for bit the eager trainer's on the
            card, and the CPU's losses, weights and running statistics
            within the larger of 1e-4 and 4x the CPU's own float32-
            against-float64 distance (batch 4 under BatchNorm is
            ill-conditioned).
14. resnet:  benchmark/resnet_bench.py's ResNet-50 v1 (1000 classes,
            Xavier, hybridized, bf16 AMP, batch 64 of 224 x 224): the
            inference call, the captured SGD step of
            DataParallelTrainer(fuse_step=True) (the eager trainer
            beside it) and the gluon loop (forward and backward one
            replay each, then Trainer.step's multi-tensor SGD), each by
            the two-window slope: images/s, MFU against the dense bf16
            peak from the model's own convolution and Dense FLOPs, peak
            memory, graph pools, captures and replays, and a profiled
            call split into convolution, BatchNorm, GEMM and other; the
            loss falls, the running statistics move and stay finite, and
            no flash kernel runs.
15. llama_train_parity: llama_tiny (S=128, the full logits) and
            mistral_tiny (S=256, past its window; the chunked head) at
            V=61, B=2, float32: 3 steps of the reference's gluon loop
            (hybridize, gluon.Trainer "adam", record -> net.loss ->
            backward -> step) on the card and on the CPU from the same
            weights: losses and weights within 1e-4 relative; on the
            card one capture, then a forward and a backward replay a
            step, every flash counter of the f32 route layers x steps.
            Then chunked_softmax_ce at V=128256, U=4096, N=512 against
            the full float32 logits (loss, dH, dW within 1e-4) and the
            memory each needs beyond its inputs and gradients: the
            chunked one far below the 263 MB of the full logits.
16. llama_train: the same loop at Llama-3-8B's published width (4096 /
            14336, 32 heads over 8 KV heads, V=128256, untied head) cut
            to 4 layers, bf16 AMP, Adam lr 1e-4, one sequence of 4096
            seeded tokens: two timed windows (5 and 20 steps) after 3
            warm-ups; tokens/s, ms a step, MFU of the bf16 part and the
            float32 head's share, peak memory, the CachedOp's pool; one
            capture before the windows, every timed step one forward and
            one backward replay, K1, K2 and K3 each 4 a step; a profiled
            step split into flash, bf16 GEMM, head (the chunked
            cross-entropy, measured alone), Adam and other.
17. forecast_parity: tiny DeepAR and TransformerForecaster (context 24,
            prediction 12, 16 cells or units, float32, dropout 0; cuDNN's
            TF32 flag left at PyTorch's default, which the recurrence
            turns off itself) from the same Xavier weights: 3 Adam steps
            of the hybridized gluon loop (record -> net(past,
            future).mean() -> backward -> step) on the card and on the
            CPU: losses within 1e-4, weights within 1e-5 in relative L2
            (the attention key biases, whose gradient is zero in exact
            arithmetic, within Adam's bound); forecast() within 1e-5;
            sample() seeded twice equal; the captured loop (one capture,
            then a forward and a backward replay a step) bit for bit the
            eager loop on the card; no flash kernel.
18. forecast: GluonTS's documented widths (FORECAST: DeepAR 40 cells x
            2 LSTM layers, dropout 0.1, 20,082 parameters; the
            Transformer 32 units, 128 hidden, 8 heads, 2 + 2 layers,
            65,730 parameters), context 168, prediction 24, batch 32,
            Adam lr 1e-3, float32, seeded synthetic series: the gluon
            loop timed by the two-window slope (5 and 20 steps after 3
            warm-ups), series/s, one capture before the windows and one
            forward and one backward replay a timed step, a profiled
            step split into the recurrence, GEMM, attention (plain,
            measured alone), Adam and other, the busy share, peak
            memory, no flash launch, the loss falling; then DeepAR's
            sample(num_samples=100) and forecast() over 370 series: ms a
            call, sample paths a second, peak memory.

19. gan_parity: example/dcgan.py's generator and discriminator at tiny
            widths (GAN_PARITY: ngf = ndf = 8, nz 16, batch 8, float32;
            cuDNN's TF32 flag left at PyTorch's default, which the
            convolutions turn off themselves) from the same Normal(0.02)
            weights: 3 alternating D/G Adam iterations (lr 2e-4, beta1
            0.5, seeded noise) on the card against the CPU: in float64
            the same function (losses, weights and moving statistics
            within 1e-10), in float32 losses within 1e-4 and each weight
            and moving statistic within the larger of 1e-5 and twice the
            sum of the CPU's and the card's own float32-against-float64
            distances in relative L2; Deconvolution, forward and the
            three gradients,
            at the four generator shapes of the gan phase, a
            target_shape and an adj case, through cuDNN (1e-4); every
            layer and loss of the GAN slice, forward and gradient, in
            one sweep (1e-4); the same iterations with both nets
            hybridized bit for bit the eager ones, both CachedOps
            captured and replayed; no flash kernel.
20. gan:     the same nets at DCGAN's published widths (GAN: Radford et
            al. 2016, nz 100, ngf = ndf = 64, batch 128, Adam lr 2e-4
            beta1 0.5) on the example's 32 x 32 RGB, float32, seeded
            blob images made up front and z drawn on the card: the
            example's iteration eager and hybridized, each timed by the
            two-window slope (5 and 20 iterations after 3 warm-ups): ms
            an iteration, images/s, FLOPs from the layers' shapes
            against the float32 peak, a profiled iteration split into
            cuDNN's fprop, dgrad and wgrad kernels, BatchNorm, Adam and
            other, the busy share, peak memory, the CachedOps' pools and
            replays; losses finite, D's accuracy reported, no flash
            kernel.
21. wordlm_parity: example/word_lm.py's RNNModel at its defaults
            (WORDLM_PARITY: vocab 64, embed 32, hidden 64, 1 LSTM layer,
            dropout 0, Embedding(sparse_grad=True)) from the same Xavier
            weights: 3 lazy-Adam and 3 lazy-SGD-momentum steps (weight
            decay on) on the card against the CPU: losses within 1e-4,
            each weight within the larger of 1e-5 and 4x the CPU's own
            float32-against-float64 distance in relative L2; the
            embedding rows no step touched bit for bit their start, their
            optimizer states exactly 0; hybridized bit for bit eager; a
            TF32 run that the weight rule must reject; no flash kernel.
22. wordlm:  the same loop at the medium width of Zaremba, Sutskever &
            Vinyals 2014, section 4 (WORDLM: V 10,000, 2 x 650 LSTM,
            embedding 650, batch 20 x 35 steps, dropout 0.5, the gradient
            norm clipped at 5 through gluon.utils.clip_global_norm, Adam
            3e-3; 19,780,400 parameters) over a Zipf-bigram corpus of
            PTB's training length drawn from seed 0, eager, hybridized
            and eager again: the two-window slope (5 and 20 steps after 3
            warm-ups), tokens/s, FLOPs against the float32 peak, peak
            memory, a profiled step split into cuDNN's LSTM kernels, the
            decoder's and the recurrence's GEMMs, softmax and CE, dense
            Adam, lazy Adam, the clip and other, the busy share;
            perplexity falling; rows the last step did not touch bit for
            bit unchanged by it; no flash kernel.
23. data:    example/train_mnist.py --synthetic at its size (DATA) and
            example/estimator_fit.py --synthetic: the DataLoader's batches
            (2 workers, shuffled under one numpy seed) equal on the CPU's
            and the card's context, and with prefetch_to_device=gpu(0)
            byte-equal and on the card; epochs with and without prefetch
            (images/s, the loader's share of host time); the MLP through
            trainer.compile_step with a FactorScheduler against the eager
            loop (the rate follows the schedule, weights within 1e-6, one
            capture); the Estimator's validation accuracy above 0.8 and
            its best checkpoint reloading to the trained net's outputs bit
            for bit.

24. fp16_parity: K1-K3's float16 route (F6) against the plain versions
            at BERT's shape (b64 s128, H=12, D=64; with and without a
            pretraining batch's key padding) and Llama training's (S=4096,
            32 over 8 heads, D=128, causal), held to float16's limits;
            3 steps of the reference's fp16 AMP loop (amp.init("float16"),
            init_trainer, scale_loss, unscale, LAMB) on a tiny BERT, card
            against CPU: losses, loss scales and skip flags, weights in
            relative L2 (a tensor that starts at 0 within LAMB's bound of
            lr a step), K1-K3 on the tensor cores, no sdpa_plain call; a
            net cast to float16 with SGD momentum and multi_precision: the
            float32 masters' change against the CPU's, each float16 weight
            its master's rounding.
25. optimizers_parity: the nine optimizers the port added (NAG, AdamW,
            AdaGrad, AdaDelta, RMSProp plain and centered, Ftrl, SignSGD,
            Signum, LAMB) and Test, 3 steps of an MLP (32-64-10, f32) on
            the card against the CPU through gluon.Trainer, compile_step
            (one capture) and, for the four fused rules (NAG, RMSProp,
            AdamW, AdaGrad), DataParallelTrainer(fuse_step=True): losses
            and weights within 1e-4.
26. bert_fp16: BERT-base pretraining (bench_bert_pretrain's batch: b64
            s128, 20 masked, dropout 0.1) under amp.init("float16") with
            the dynamic loss scaler and LAMB (lr 1e-4, wd 0.01), the
            model hybridized, through the reference's gluon AMP loop: the
            two-window slope a step (5 and 20 steps after 3 warm-ups),
            samples/s, the busy share, a profiled step split into flash,
            GEMM, LAMB and other, peak memory, the loss-scale trajectory
            and the skipped steps; K1-K3 in float16, 12 launches each a
            step; no sdpa_plain call; losses finite and falling after the
            scaler settles.

The kernels phase also runs K1-K3 at Llama-3-8B's training shape (B=1,
S=4096, H=32 over KV=8, D=128, causal, bf16).  Then one line of per-kernel numbers ({"kernels": [...]}), the card's name
and power limit as nvidia-smi gives them, and as the last line
{"ok": true, "device": {...}}.  Any failed check exits nonzero.
``--phases`` runs a subset (for quick checks of a new kernel).
"""
from __future__ import annotations

import argparse
import contextlib
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
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12,
              "float32": 67e12}   # dense; f32 without TF32
ALL_PHASES = ("device,build,kernels,parity,serve,train_parity,"
              "train_capture_parity,dropout,train,imperative_parity,"
              "imperative,rtc,resnet_parity,resnet,llama_train_parity,"
              "llama_train,forecast_parity,forecast,gan_parity,gan,"
              "wordlm_parity,wordlm,data,fp16_parity,optimizers_parity,"
              "bert_fp16")
SERVING_PHASES = {"device", "build", "parity", "serve"}


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


#: idle seconds at each end of a profiled window (see ``profiled``)
EDGE_S = 0.02


def profiled(fn, reps):
    """torch.profiler's ``key_averages()`` over ``reps`` back-to-back
    calls of ``fn`` (the schedule's own step annotation left out), taken
    as the active step of a profiler schedule after one warm-up call in
    the same session: the launches at the very start of a session are
    sometimes not recorded.  The card idles ``EDGE_S`` at each end of
    the active step: the profiler drops a kernel whose device timestamps
    fall outside the step's host-clock window, so a kernel launched right
    at its start or ending right at its end could be lost to the skew
    between the two clocks."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        fn()
        torch.cuda.synchronize()
        prof.step()
        time.sleep(EDGE_S)
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        time.sleep(EDGE_S)
        prof.step()
    return [ev for ev in prof.key_averages()
            if not ev.key.startswith("ProfilerStep")]


def queued_ms(fn, reps, warmup=2, tries=3):
    """Device time of one call from CUDA events, the host's pace kept
    out: a spin kernel holds the stream while the host enqueues the start
    event, ``reps`` calls and the end event, so the calls run back to
    back on the card.  Fails unless the host had enqueued them all
    before the spin ended (a longer spin is tried first).  For kernels
    launched through the driver API (NVRTC's ``cuLaunchKernel``), of
    which torch.profiler loses a few launches in 20 (1 to 3 on an H100),
    so that ``device_ms`` cannot count them; the events see every
    launch."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    cycles = 1 << 24
    for _ in range(tries):
        spin, start, end = (torch.cuda.Event(enable_timing=True)
                            for _ in range(3))
        spin.record()
        torch.cuda._sleep(cycles)
        t0 = time.perf_counter()
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        host_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        spin_ms = spin.elapsed_time(start)
        if host_ms < spin_ms:
            return start.elapsed_time(end) / reps
        cycles *= 8
    fail(f"queued_ms: the host took {host_ms} ms to enqueue {reps} calls, "
         f"longer than the {spin_ms} ms spin meant to hold them back")


def events_ms(fn, reps, warmup=2, by_kernel=False):
    """``device_ms``'s reading from CUDA events (``queued_ms``): the
    device time of one call, the host's pace kept out, with no profiler
    session; with ``by_kernel`` also an empty {kernel: ms}.  For kernel
    readings taken after many profiled phases, where the profiler starts
    to lose events."""
    ms = queued_ms(fn, reps, warmup)
    return (ms, {}) if by_kernel else ms


def window_kernels(fn, reps):
    """One profiler window of ``reps`` calls: ({kernel: self device
    microseconds}, {kernel: recorded launches}), CUDA kernels and copies
    that took time."""
    import torch
    us, counts = {}, {}
    for ev in profiled(fn, reps):
        if ev.device_type == torch.autograd.DeviceType.CUDA \
                and ev.self_device_time_total > 0:
            us[ev.key] = us.get(ev.key, 0.0) + ev.self_device_time_total
            counts[ev.key] = counts.get(ev.key, 0) + ev.count
    return us, counts


def device_ms(fn, reps, warmup=2, by_kernel=False, tries=5):
    """Device time of one call: from one torch.profiler window of
    ``reps`` back-to-back calls, each CUDA kernel's (and copy's) mean
    self device time times its launches a call, summed.  The host's pace
    does not enter it.  Every call runs the same kernels, so each must
    be recorded a nonzero multiple of ``reps`` times; the profiler
    drops an event now and then, so a count within 10 % of such a
    multiple passes, and a window that lost more is taken again, up to
    ``tries`` windows.  Driver-API launches (NVRTC) are lost too often
    for this count: ``queued_ms`` times them.  With ``by_kernel`` also
    returns {kernel: ms a call}."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        us, counts = window_kernels(fn, reps)
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


def kernel_split_ms(fn, reps, warmup=1, tries=5):
    """A call's device time by kernel, for a call whose total is read
    from CUDA events (``queued_ms``): one torch.profiler window of
    ``reps`` calls, each kernel's mean self device time a recorded
    launch times its launches a call (its recorded count over ``reps``,
    rounded).  Unlike ``device_ms`` it takes a window that lost an event
    or two, which after many profiled phases in one process the profiler
    does now and then: a window is taken again when a count sits a
    quarter of ``reps`` or more from a multiple (the rounding would be a
    guess) or it lost more than 1 % of its events.  Returns ({kernel: ms
    a call}, events the window lost, windows taken)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for taken in range(1, tries + 1):
        us, counts = window_kernels(fn, reps)
        per_call = {k: round(n / reps) for k, n in counts.items()}
        lost = sum(per_call[k] * reps - n for k, n in counts.items())
        if counts and all(per_call[k] >= 1
                          and abs(n - per_call[k] * reps) < 0.25 * reps
                          for k, n in counts.items()) \
                and abs(lost) <= 0.01 * sum(counts.values()):
            return {k: us[k] / counts[k] * per_call[k] / 1e3
                    for k in us}, lost, taken
    fail(f"kernel_split_ms: {tries} profiler windows of {reps} calls each "
         f"recorded kernels a number of times far from a multiple of the "
         f"calls: {counts}")


COUNTERS = ("flash_fwd_launches", "flash_bwd_launches",
            "flash_bwd_dq_launches", "flash_bwd_dkv_launches",
            "flash_fwd_tc_launches", "flash_bwd_dq_tc_launches",
            "flash_bwd_dkv_tc_launches")
# the counters of the CUDA-core f32 route: every launch counts there,
# and a bf16 launch also counts in its *_tc_launches
F32_ROUTE = COUNTERS[:4]


def free_earlier_phases():
    """Collect what earlier phases left in reference cycles (the serve
    phase's 16 GB of Llama weights among them), so that a phase's peak
    memory is its own."""
    import gc
    import torch
    gc.collect()
    torch.cuda.empty_cache()


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
    # Llama-3-8B training's forward: one sequence of 4096, H=32 over KV=8,
    # D=128, causal, with the LSE
    dict(name="llama_train_s4096_lse_bf16", s_q=4096, s_k=4096,
         dtype="bfloat16", causal=True, want_lse=True),
]
HEADLINE_CASE = "bert_b64_s128_lse_bf16"
LLAMA_TRAIN_CASE = "llama_train_s4096_lse_bf16"
SERVE_CASE = "prefill_s512_bf16"
TOL = {"bfloat16": 2e-2, "float16": 1e-2, "float32": 1e-4}
# the scale-free limits beside TOL's absolute one (_scaled_err): the worst
# row's error over that row's rms in the reference, and the whole
# tensor's relative L2.  Under causal masking a row's size falls with its
# position (at S=4096 the first keys' dV is ~10x the typical key's), so
# an absolute limit set by the largest rows cannot see the small ones.
# Set from the readings of every case on an H100 (PERF.md section 6):
# the worst sound readings were, bf16, 3.3e-2 a row and 2.1e-3 in L2;
# float16, 3.1e-2 a row (the floored dQ row at Llama's shape, as bf16's;
# 3.9e-3 elsewhere) and 2.0e-4 in L2; f32, 9.3e-3 a row (a floored row
# of rounding size; 5.7e-6 elsewhere) and 2.6e-7 in L2; a wrong output
# (_check_scaled) reads >= 3.7 a row and >= 0.16 in L2.  float16's TOL
# is mxnet_tpu/test_utils.py's (its worst reading 3.9e-3)
ROW_TOL = {"bfloat16": 0.1, "float16": 0.1, "float32": 3e-2}
L2_TOL = {"bfloat16": 1e-2, "float16": 2e-3, "float32": 1e-5}

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
    # Llama-3-8B training's backward: batch 1, S=4096, causal GQA (K3
    # sums each group of 4 query heads)
    dict(name="llama_train_s4096_bf16", s_q=4096, s_k=4096,
         dtype="bfloat16", causal=True),
]
BWD_HEADLINE_CASE = "bert_b64_s128_bf16"
LLAMA_TRAIN_BWD_CASE = "llama_train_s4096_bf16"


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


def _scaled_err(got, ref):
    """The error of ``got`` against ``ref`` on the scale of ``ref``: the
    largest over rows (one position and head, over D) of the row's max
    abs error over the row's rms in ``ref`` (a row below 1e-3 of the
    tensor's rms is held over that floor: a query that sees one key has
    a dQ of rounding size), the relative L2 of the whole tensor, and the
    reference's typical size (its rms, and its rows' median rms)."""
    import torch
    a, r = got.float(), ref.float()
    rms = r.square().mean().sqrt().clamp_min(1e-30)
    row_rms = r.square().mean(dim=-1).sqrt()
    row_err = (a - r).abs().amax(dim=-1)
    row_rel = row_err / torch.maximum(row_rms, 1e-3 * rms)
    return {"row_rel_max": row_rel.max().item(),
            "rel_l2": ((a - r).norm() / r.norm().clamp_min(1e-30)).item(),
            "ref_rms": rms.item(),
            "ref_row_rms_median": row_rms.median().item(),
            "ref_row_rms_median_late":
                row_rms[:, r.shape[1] // 2:].median().item(),
            "ref_max_abs": r.abs().max().item()}


def _check_scaled(case, name, got, ref):
    """_scaled_err of one output, held to ROW_TOL and L2_TOL; and the
    same measures of a wrong output, ``ref`` with the second half of its
    positions zeroed, which must exceed both limits."""
    e = _scaled_err(got, ref)
    dt = case["dtype"]
    wrong = ref.clone()
    wrong[:, ref.shape[1] // 2:] = 0
    w = _scaled_err(wrong, ref)
    e["wrong_half_zero"] = {"row_rel_max": w["row_rel_max"],
                            "rel_l2": w["rel_l2"]}
    check(w["row_rel_max"] > ROW_TOL[dt] and w["rel_l2"] > L2_TOL[dt],
          f"{case['name']}: {name} with half its positions zeroed reads "
          f"{w}, within the limits")
    check(e["row_rel_max"] <= ROW_TOL[dt],
          f"{case['name']}: {name} worst row error over its rms "
          f"{e['row_rel_max']} > {ROW_TOL[dt]}")
    check(e["rel_l2"] <= L2_TOL[dt],
          f"{case['name']}: {name} relative L2 error {e['rel_l2']} > "
          f"{L2_TOL[dt]}")
    return e


def _bound(flops, nbytes, dtype):
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _flash_case(case, dev, phase="kernels", timer=None):
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

    timer = timer or device_ms
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
    scaled = _check_scaled(case, "out", out, ref)

    def kernel():
        return fa.flash_fwd(q, k, v, scale, causal=causal, kmask=kmask,
                            window=window, want_lse=want_lse)
    kernel_ms = timer(kernel, reps=20)
    launch_ms = cuda_time_ms(kernel, reps=20)
    plain_ms = timer(lambda: fa.flash_attention_plain(
        q, k, v, scale, causal=causal, kmask=kmask, window=window,
        want_lse=want_lse), reps=5, warmup=1)

    # the work this run's masks need, and the bound it sets
    pairs = int(keep.sum().item())
    flops = 4.0 * h * d * pairs
    elem = q.element_size()
    nbytes = elem * d * (2 * b * s_q * h + 2 * b * s_k * kv)
    if kmask is not None:
        nbytes += 4 * b * s_k
    if want_lse:
        nbytes += 4 * b * h * s_q
    bound_ms, bound_by = _bound(flops, nbytes, case["dtype"])

    # the library yardstick: (B, H, S, D) layout, GQA, same mask
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    lib_kw = _library_mask(case, keep, kmask)
    library_ms = timer(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, enable_gqa=True, scale=scale, **lib_kw), reps=20)
    row = {"phase": phase, "kernel": "flash_fwd", "case": case["name"],
           "cores": _cores(dt), "b": b, "h": h, "kv": kv, "d": d,
           "s_q": s_q, "s_k": s_k,
           "dtype": case["dtype"], "causal": causal, "window": window,
           "key_padding": kmask is not None, "max_abs_err": err,
           "mean_abs_ref": ref.float().abs().mean().item(),
           "lse_max_abs_err": lse_err, "tol": tol, "scaled_err": scaled,
           "row_tol": ROW_TOL[case["dtype"]],
           "l2_tol": L2_TOL[case["dtype"]], "kernel_ms": kernel_ms,
           "launch_ms": launch_ms, "plain_ms": plain_ms,
           "library_ms": library_ms, "timer": timer.__name__,
           "bound_ms": bound_ms,
           "bound_by": bound_by, "kernel_over_library": kernel_ms / library_ms,
           "bound_over_kernel": bound_ms / kernel_ms, "flops": flops,
           "bytes": nbytes,
           "tflops_per_s": flops / (kernel_ms * 1e-3) / 1e12}
    emit(row)
    return row


def _cores(dtype):
    import torch
    return "cuda_cores" if dtype == torch.float32 else "tensor_cores"


def _library_mask(case, keep, kmask):
    """F.scaled_dot_product_attention's mask arguments for a case."""
    if case["causal"] and case["s_q"] == case["s_k"] \
            and case.get("window") is None and kmask is None:
        return {"is_causal": True}
    if case["causal"] or kmask is not None:
        return {"attn_mask": keep[:, None]}
    return {}


def _flash_bwd_case(case, dev, phase="kernels", timer=None):
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
    timer = timer or device_ms
    out, lse = fa.flash_fwd(q, k, v, scale, want_lse=True, **kw)
    got = fa.flash_bwd(q, k, v, out, lse, g, scale, **kw)
    torch.cuda.synchronize()
    ref = fa.flash_bwd_plain(q, k, v, out, lse, g, scale, **kw)
    tol = TOL[case["dtype"]]
    errs, limits, scaled = {}, {}, {}
    for name, a, r in zip(("dq", "dk", "dv"), got, ref):
        check(torch.isfinite(a.float()).all().item(),
              f"{case['name']}: non-finite {name}")
        errs[name] = (a.float() - r.float()).abs().max().item()
        limits[name] = tol * max(1.0, r.float().abs().max().item())
        check(errs[name] <= limits[name],
              f"{case['name']}: {name} max abs error {errs[name]} > "
              f"{limits[name]}")
        scaled[name] = _check_scaled(case, name, a, r)
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
    kernel_ms, dq_ms, dkv_ms = (timer(f, reps=reps)
                                for f in (whole, dq_only, dkv_only))
    launch_ms, dq_launch_ms, dkv_launch_ms = (
        cuda_time_ms(f, reps=reps) for f in (whole, dq_only, dkv_only))
    plain_ms = timer(
        lambda: fa.flash_bwd_plain(q, k, v, out, lse, g, scale, **kw),
        reps=3, warmup=1)

    # the library yardstick: the backward of F.scaled_dot_product_attention
    # on the same inputs, as (forward + backward) - forward
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_(True)
                  for x in (q, k, v))
    gt = g.transpose(1, 2).contiguous()
    lib_kw = dict(enable_gqa=True, scale=scale,
                  **_library_mask(case, keep, kmask))
    lib_fwd = timer(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, **lib_kw), reps=reps)
    lib_all, lib_kernels = timer(lambda: torch.autograd.grad(
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
    row = {"phase": phase, "kernel": "flash_bwd", "case": case["name"],
           "dq_cores": _cores(q.dtype), "dkv_cores": _cores(q.dtype),
           "b": b, "h": h, "kv": kv, "d": d, "s_q": s_q, "s_k": s_k,
           "dtype": case["dtype"], "causal": causal, "window": window,
           "key_padding": kmask is not None, "max_abs_err": errs,
           "limit": limits, "scaled_err": scaled,
           "row_tol": ROW_TOL[case["dtype"]],
           "l2_tol": L2_TOL[case["dtype"]], "forced_zeros": zeros,
           "kernel_ms": kernel_ms, "dq_ms": dq_ms, "dkv_ms": dkv_ms,
           "launch_ms": launch_ms, "dq_launch_ms": dq_launch_ms,
           "dkv_launch_ms": dkv_launch_ms, "plain_ms": plain_ms,
           "library_ms": lib_bwd, "library_fwd_ms": lib_fwd,
           "library_fwd_bwd_ms": lib_all, "library_kernels": lib_kernels,
           "timer": timer.__name__,
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
    # all three timed alike, with the host's pace kept out (queued_ms)
    ms = queued_ms(axpy, reps=reps)
    launch_ms = cuda_time_ms(axpy, reps=reps)
    plain_ms = queued_ms(lambda: axpy_plain(x._t, y._t, alpha), reps=reps)
    library_ms = queued_ms(lambda: torch.add(y._t, x._t, alpha=alpha),
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
    """bench_mlp_train's net on ``ctx``, hybridized (a CachedOp: inline
    inside compile_step, one forward and one backward replay a step in
    the gluon loop)."""
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


def mlp_step_fn(mx, net, ctx, xnp, ynp, lr=MLP["lr"], compiled=True):
    """One training step of ``net`` with Trainer("sgd"): through
    ``trainer.compile_step`` as bench.py runs it (one graph replay a step
    on the card), or with ``compiled=False`` the gluon loop: record ->
    backward -> Trainer.step (the hybridized net's forward and backward
    one replay each, then the multi-tensor SGD).  Returns (step, the CompiledStep or None); a
    step returns the per-sample loss NDArray (not synchronised)."""
    from mxnet_tpu_torch import autograd, gluon, nd
    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": lr}, kvstore=None)
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    x, y = nd.array(xnp, ctx=ctx), nd.array(ynp, ctx=ctx)
    batch_size = xnp.shape[0]
    if compiled:
        cs = trainer.compile_step(net, loss_fn)
        return (lambda: cs.step(x, y, batch_size)), cs

    def step():
        with autograd.record():
            loss = loss_fn(net(x), y)
        loss.backward()
        trainer.step(batch_size)
        return loss
    return step, None


def check_no_fallback(phase):
    from mxnet_tpu_torch.gluon import compiled_step
    reports = compiled_step.fallback_reports()
    check(not reports, f"{phase}: a compiled step fell back to the eager "
          f"loop: {reports}")


def phase_imperative_parity(mx, dev, steps=3):
    """3 SGD steps through compile_step on the card (a warm-up step, the
    capture and its replay, a replay) and on the CPU from the same
    weights.

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
        step, cs = mlp_step_fn(mx, net, ctx, xnp, ynp)
        losses.append([step().mean().asscalar() for _ in range(steps)])
        check(cs.last_path == "compiled",
              f"imperative_parity: the step took the {cs.last_path} path")
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
          "path": "compile_step", "batch_size": b, "dtype": "float32",
          "steps": steps, "cpu_losses": cpu_losses,
          "gpu_losses": card_losses, "max_rel_diff": rel,
          "weights_rel_l2_diff": diff / norm, "per_tensor": per_tensor,
          "captures": cs.captures, "replays": cs.replays})
    check(rel <= 1e-4, f"imperative_parity: losses differ by {rel}")
    check(diff / norm <= 1e-4,
          f"imperative_parity: weights differ by {diff / norm} (L2)")
    check(card_losses[-1] < card_losses[0],
          "imperative_parity: the loss did not fall")
    check(cs.captures == 1 and cs.replays == steps - 1,
          f"imperative_parity: {cs.captures} captures, {cs.replays} "
          f"replays; want 1 and {steps - 1}")
    check_no_fallback("imperative_parity")


def phase_imperative(mx, dev, cfg=MLP):
    """bench_mlp_train's loop on the card through compile_step: warm-up,
    the two-window slope timing and a profiled step; then the eager loop
    on the same net, timed and profiled the same way."""
    import torch
    from mxnet_tpu_torch import nd
    b, steps, warmup = cfg["batch_size"], cfg["steps"], cfg["warmup"]
    free_earlier_phases()
    mx.random.seed(0)
    net = build_mlp(mx, mx.gpu(0))
    n_params = sum(p.data().size for p in net.collect_params().values())
    xnp, ynp = mlp_batch(b, cfg["widths"][0])
    step, cs = mlp_step_fn(mx, net, mx.gpu(0), xnp, ynp, lr=cfg["lr"])
    first = step().mean().asscalar()
    for _ in range(warmup - 1):
        step()
    nd.waitall()

    def mean_loss(loss):
        return loss.mean().asscalar()
    n1 = steps // 3
    torch.cuda.reset_peak_memory_stats(dev)
    replays0 = cs.replays
    step_s, naive_s, windows, used, last = timed_windows(
        step, n1, steps, "imperative", read=mean_loss)
    replays = cs.replays - replays0
    peak = torch.cuda.max_memory_allocated(dev)
    eager_step, _ = mlp_step_fn(mx, net, mx.gpu(0), xnp, ynp, lr=cfg["lr"],
                                compiled=False)
    for _ in range(warmup):
        eager_step()
    nd.waitall()
    torch.cuda.reset_peak_memory_stats(dev)
    eager_s, eager_naive_s, eager_windows, eager_used, _ = timed_windows(
        eager_step, n1, steps, "imperative eager", read=mean_loss)
    eager_peak = torch.cuda.max_memory_allocated(dev)
    eager_breakdown = profile_call(eager_step)
    breakdown = profile_call(step)
    flops = 6.0 * n_params * b
    emit({"phase": "imperative", "model": "mlp_784_1024_1024_10",
          "path": "compile_step", "dtype": "float32", "batch_size": b,
          "params": n_params, "warmup": warmup, "windows": [n1, steps],
          "window_s": windows, "step_ms": step_s * 1e3,
          "naive_step_ms": naive_s * 1e3, "timing": used,
          "samples_per_s": b / step_s, "flops_per_step": flops,
          "bound_ms": flops / PEAK_FLOPS["float32"] * 1e3,
          "kernels_per_step": breakdown["kernels"],
          "device_busy_share": breakdown["device_busy_share"],
          "eager_step_ms": eager_s * 1e3,
          "eager_naive_step_ms": eager_naive_s * 1e3,
          "eager_window_s": eager_windows, "eager_timing": eager_used,
          "eager_samples_per_s": b / eager_s,
          "eager_kernels_per_step": eager_breakdown["kernels"],
          "eager_device_busy_share": eager_breakdown["device_busy_share"],
          "captures": cs.captures, "replays_counted": replays,
          "first_loss": first, "last_loss": last, "peak_mem_bytes": peak,
          "eager_peak_mem_bytes": eager_peak,
          "graph_pool_bytes": cs.pool_bytes, "card": nvidia_smi()})
    emit(dict({"phase": "imperative_breakdown", "call": "step_b512_replay"},
              **breakdown))
    emit(dict({"phase": "imperative_breakdown", "call": "step_b512_eager"},
              **eager_breakdown))
    check(last < first, f"imperative: last loss {last} not below the "
          f"first {first}")
    check(cs.captures == 1 and replays == n1 + steps,
          f"imperative: {cs.captures} captures and {replays} replays in "
          f"the timed windows; want 1 and {n1 + steps}")
    check_no_fallback("imperative")


# -- phases 13 and 14: the hybridized ResNet (BASELINE config #2) ---------------

# f32 parity on the card against the CPU: relative to the CPU's values
# (max abs difference over max abs for outputs and losses, the L2 norm of
# the difference over the L2 norm for weights and running statistics)
RESNET_TOL = 1e-4
# benchmark/resnet_bench.py's configuration: resnet50_v1, 1000 classes,
# Xavier, bf16 AMP, batch 64 of 224 x 224 synthetic images, SGD lr 0.05
RESNET50 = dict(model="resnet50_v1", classes=1000, batch_size=64,
                image_size=224, lr=0.05, steps=20, warmup=3)


def _rel(got, want):
    got, want = np.asarray(got, "f8"), np.asarray(want, "f8")
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _rel_l2(got, want):
    """L2 norm of the difference over the L2 norm, over lists of
    arrays."""
    diff = sum(float(np.square(np.asarray(g, "f8") - np.asarray(w, "f8"))
                     .sum()) for g, w in zip(got, want))
    norm = sum(float(np.square(np.asarray(w, "f8")).sum()) for w in want)
    return math.sqrt(diff / max(norm, 1e-30))


def _param_values(net, select=None):
    return [p.data().asnumpy() for name, p in net.collect_params().items()
            if select is None or select(name)]


def _is_stat(name):
    return name.endswith("running_mean") or name.endswith("running_var")


def _resnet_net(mx, name, ctx, x):
    """``name`` (thumbnail, 10 classes) on ``ctx``, called once on ``x``
    in predict mode, which makes the deferred parameters."""
    from mxnet_tpu_torch.gluon.model_zoo import vision
    net = vision.get_model(name, classes=10, thumbnail=True, prefix="net_")
    net.initialize(mx.init.Xavier(), ctx=ctx, seed=3)
    net(mx.nd.array(x, ctx=ctx))
    return net


def _sgd_trajectory(net, ctx, x, y, fuse, dtype=None, steps=3):
    """``steps`` SGD steps (lr 0.1, momentum 0.9, wd 1e-4) of ``net``
    through DataParallelTrainer: (the trainer, the losses, [(weights,
    running statistics) after the first step, after the last])."""
    import torch
    from mxnet_tpu_torch import gluon, parallel
    sce = gluon.loss.SoftmaxCrossEntropyLoss()
    dpt = parallel.DataParallelTrainer(
        net, lambda out, label: sce(out, label).mean(), "sgd",
        {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4},
        fuse_step=fuse)
    xt = torch.from_numpy(x).to(ctx.device, dtype or torch.float32)
    yt = torch.from_numpy(y).to(ctx.device)
    losses, after = [], []
    for i in range(steps):
        losses.append(float(dpt.step(xt, yt)))
        if i in (0, steps - 1):
            after.append((_param_values(net, lambda n: not _is_stat(n)),
                          _param_values(net, _is_stat)))
    return dpt, losses, after


def _copy_params(src, dst):
    for a, b in zip(src.collect_params().values(),
                    dst.collect_params().values()):
        b.set_data(a.data())


def _grads(mx, net, x, ctx):
    from mxnet_tpu_torch import autograd
    with autograd.record():
        loss = (net(mx.nd.array(x, ctx=ctx)) ** 2).sum()
    loss.backward()
    return [p.grad().asnumpy() for p in net.collect_params().values()
            if p.grad_req != "null"]


def phase_resnet_parity(mx, dev):
    """resnet18_v1 and resnet18_v2 (thumbnail, 10 classes, batch 4, 32 x
    32, float32) on the card against the CPU from the same weights, with
    PyTorch's default TF32 flags (cuDNN's on): predict and training-mode
    outputs and the running statistics after; the hybridized net against
    itself unhybridized (predict: eager warm-up, capture, replay;
    recorded: the same, gradients from the backward graph), an earlier
    output and gradient not overwritten by a later replay, ``set_data``
    read by the next replay; all within RESNET_TOL.  Then 3 SGD steps
    (lr 0.1, momentum 0.9, wd 1e-4) through
    DataParallelTrainer(fuse_step=True) with the hybridized net inline:
    on the card equal bit for bit to the eager trainer's (cuDNN's
    deterministic algorithms); against the CPU the losses, weights and
    running statistics after the first and the third step, each within
    the larger of RESNET_TOL and 4 times the CPU's own float32-against-
    float64 distance there.  Batch 4 under BatchNorm makes this
    trajectory ill-conditioned: on the CPU alone, resnet18_v1's float32
    and float64 weights part by up to 6e-4 (relative L2) after one step
    and by ~3e-2 after three."""
    import torch
    from mxnet_tpu_torch import autograd, nd
    flags = {"cudnn.allow_tf32": torch.backends.cudnn.allow_tf32,
             "cuda.matmul.allow_tf32":
                 torch.backends.cuda.matmul.allow_tf32}
    check(flags == {"cudnn.allow_tf32": True,
                    "cuda.matmul.allow_tf32": False},
          f"resnet_parity: TF32 flags {flags} are not PyTorch's defaults")
    rng = np.random.RandomState(0)
    x = rng.rand(4, 3, 32, 32).astype("f4")
    x2 = rng.rand(4, 3, 32, 32).astype("f4")
    y = rng.randint(0, 10, 4).astype("f4")
    cpu, card = mx.cpu(), mx.gpu(0)
    reset_counts()
    for name in ("resnet18_v1", "resnet18_v2"):
        cnet, gnet = (_resnet_net(mx, name, c, x) for c in (cpu, card))
        _copy_params(cnet, gnet)
        row = {"phase": "resnet_parity", "model": name, "batch_size": 4,
               "image_size": 32, "dtype": "float32", "tf32_flags": flags,
               "tol": RESNET_TOL}
        # predict mode, then a training-mode forward and its statistics
        want = cnet(nd.array(x, ctx=cpu)).asnumpy()
        eager = gnet(nd.array(x, ctx=card)).asnumpy()
        row["predict"] = _rel(eager, want)
        with autograd.record():
            got_t = gnet(nd.array(x, ctx=card)).asnumpy()
        with autograd.record():
            want_t = cnet(nd.array(x, ctx=cpu)).asnumpy()
        row["train_forward"] = _rel(got_t, want_t)
        row["running_stats_after_train_forward"] = _rel_l2(
            _param_values(gnet, _is_stat), _param_values(cnet, _is_stat))
        # hybridized against unhybridized, on the card (the training
        # forward of the gradients moved the running statistics)
        grads0 = _grads(mx, gnet, x, card)
        eager = gnet(nd.array(x, ctx=card)).asnumpy()
        gnet.hybridize()
        hyb = [gnet(nd.array(x, ctx=card)).asnumpy() for _ in range(3)]
        row["hybrid_predict"] = max(_rel(h, eager) for h in hyb)
        hgrads = [_grads(mx, gnet, x, card) for _ in range(3)]
        row["hybrid_grads"] = max(_rel_l2(g, grads0) for g in hgrads)
        op = gnet._cached_op
        row["cachedop"] = {"entries": len(op), "captures": op.captures,
                           "replays": op.replays,
                           "pool_bytes": op.pool_bytes}
        check(len(op) == 2 and op.captures == 2 and op.replays == 4,
              f"resnet_parity {name}: CachedOp {row['cachedop']}, want 2 "
              "entries (predict, recorded), one capture and two replays "
              "each")
        # an earlier replay's output and gradient survive a later replay
        y1 = gnet(nd.array(x, ctx=card))
        first = y1.asnumpy()
        gnet(nd.array(x2, ctx=card)).wait_to_read()
        row["output_kept"] = bool(np.array_equal(y1.asnumpy(), first))
        xa = nd.array(x, ctx=card)
        xa.attach_grad()
        with autograd.record():
            head = gnet(xa).sum()
        (gx,) = autograd.grad(head, [xa])
        gx_first = gx.asnumpy()
        xb = nd.array(x2, ctx=card)
        xb.attach_grad()
        with autograd.record():
            head = gnet(xb).sum()
        autograd.grad(head, [xb])[0].wait_to_read()
        row["grad_kept"] = bool(np.array_equal(gx.asnumpy(), gx_first))
        check(row["output_kept"] and row["grad_kept"],
              f"resnet_parity {name}: a later replay overwrote an earlier "
              f"output ({row['output_kept']}) or gradient "
              f"({row['grad_kept']})")
        # set_data after a replay is read by the next replay
        _copy_params(cnet, gnet)
        w = [p for p in cnet.collect_params().values()
             if p.name.endswith("weight")][1]
        w.set_data(w.data().asnumpy() * 0.5)
        gnet.collect_params()[w.name].set_data(w.data().asnumpy())
        row["set_data_seen"] = _rel(gnet(nd.array(x, ctx=card)).asnumpy(),
                                    cnet(nd.array(x, ctx=cpu)).asnumpy())
        # 3 SGD steps through the fused trainer, the net inline, all from
        # the CPU net's state: on the card captured and eager (cuDNN's
        # deterministic algorithms: they must agree bit for bit), on the
        # CPU in float32 and float64
        captures0 = op.captures
        enet = _resnet_net(mx, name, card, x)
        dnet = _resnet_net(mx, name, cpu, x)
        for twin in (enet, dnet):
            _copy_params(cnet, twin)
        dnet.to(torch.float64)
        deterministic = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            dpt, card_l, card_after = _sgd_trajectory(gnet, card, x, y, True)
            _, eager_l, eager_after = _sgd_trajectory(enet, card, x, y,
                                                      False)
        finally:
            torch.backends.cudnn.deterministic = deterministic
        _, cpu_l, cpu_after = _sgd_trajectory(cnet, cpu, x, y, True)
        _, f64_l, f64_after = _sgd_trajectory(dnet, cpu, x, y, True,
                                              torch.float64)

        def dist(la, aa, lb, ab, at):
            """After the first step (at 0) or the last (at 1)."""
            n = 1 if at == 0 else len(la)
            return {"losses": _rel(la[:n], lb[:n]),
                    "weights": _rel_l2(aa[at][0], ab[at][0]),
                    "running_stats": _rel_l2(aa[at][1], ab[at][1])}
        got = [dist(card_l, card_after, cpu_l, cpu_after, at)
               for at in (0, 1)]
        spread = [dist(cpu_l, cpu_after, f64_l, f64_after, at)
                  for at in (0, 1)]
        tols = [{k: max(RESNET_TOL, 4 * v) for k, v in sp.items()}
                for sp in spread]
        bitwise = card_l == eager_l and all(
            np.array_equal(a, b) for i in range(2) for part in range(2)
            for a, b in zip(card_after[i][part], eager_after[i][part]))
        row.update({
            "sgd": {"lr": 0.1, "momentum": 0.9, "wd": 1e-4, "steps": 3},
            "cpu_losses": cpu_l, "cpu_f64_losses": f64_l,
            "gpu_losses": card_l, "gpu_eager_losses": eager_l,
            "captured_equals_eager_bitwise": bitwise,
            "after_step_1": got[0], "after_step_3": got[1],
            "cpu_f32_vs_f64_after_step_1": spread[0],
            "cpu_f32_vs_f64_after_step_3": spread[1],
            "tol_step_1": tols[0], "tol_step_3": tols[1],
            "trainer_captures": dpt.captures, "trainer_replays": dpt.replays,
            "cachedop_captures_in_trainer": op.captures - captures0})
        emit(row)
        for key in ("predict", "train_forward",
                    "running_stats_after_train_forward", "hybrid_predict",
                    "hybrid_grads", "set_data_seen"):
            check(row[key] <= RESNET_TOL,
                  f"resnet_parity {name}: {key} differs by {row[key]}")
        for step, dists, tol in zip((1, 3), got, tols):
            for key, val in dists.items():
                check(val <= tol[key], f"resnet_parity {name}: after SGD "
                      f"step {step} the {key} differ by {val}, above "
                      f"{tol[key]}")
        check(bitwise, f"resnet_parity {name}: the captured steps differ "
              f"from the eager ones ({card_l} against {eager_l})")
        check(dpt.captures == 1 and dpt.replays == 2,
              f"resnet_parity {name}: the trainer captured {dpt.captures} "
              f"times and replayed {dpt.replays}; want 1 and 2")
        check(op.captures == captures0,
              f"resnet_parity {name}: the hybridized net captured inside "
              "the trainer's step")
    launches = read_counts()
    check(not any(launches.values()),
          f"resnet_parity: the ResNet path launched flash kernels "
          f"{launches}")


def _resnet_flops(net, x):
    """Forward FLOPs of one call of ``net`` on ``x`` (2 a multiply-add),
    from the shapes its convolutions and Dense layers see in that
    call."""
    from mxnet_tpu_torch.gluon.nn import Dense
    from mxnet_tpu_torch.gluon.nn.conv_layers import _Conv
    total = [0]

    def conv_hook(mod, inputs, out):
        w = mod.weight
        total[0] += 2 * out.numel() * w[0].numel()

    def dense_hook(mod, inputs, out):
        total[0] += 2 * out.numel() * mod.weight.shape[1]
    hooks = []
    for m in net.modules():
        if isinstance(m, _Conv):
            hooks.append(m.register_forward_hook(conv_hook))
        elif isinstance(m, Dense):
            hooks.append(m.register_forward_hook(dense_hook))
    try:
        net(x)
    finally:
        for h in hooks:
            h.remove()
    return total[0]


def phase_resnet(mx, dev, cfg=RESNET50):
    """benchmark/resnet_bench.py's ResNet-50 at full width on the card:
    get_model, Xavier, hybridize, bf16 AMP, batch 64 of 224 x 224.
    Inference (predict-mode net(x): one capture, then every timed call
    a replay), the captured training step (DataParallelTrainer(..., "sgd",
    fuse_step=True): one capture, no nested one) beside the eager
    trainer, and the gluon loop (record, net(x), loss, backward,
    Trainer.step: the forward and the backward one replay each), each
    timed by the two-window slope and profiled."""
    import torch
    from mxnet_tpu_torch import autograd, gluon, nd, parallel
    from mxnet_tpu_torch.contrib import amp
    from mxnet_tpu_torch.gluon.model_zoo import vision
    b, size, steps = cfg["batch_size"], cfg["image_size"], cfg["steps"]
    warmup = cfg["warmup"]
    n1 = steps // 4
    free_earlier_phases()
    mx.random.seed(0)
    amp.init(target_dtype="bfloat16")
    rng = np.random.RandomState(0)
    x = nd.array(rng.rand(b, 3, size, size).astype("f4"), ctx=mx.gpu(0))
    y = nd.array(rng.randint(0, cfg["classes"], b).astype("f4"),
                 ctx=mx.gpu(0))
    reset_counts()
    try:
        net = vision.get_model(cfg["model"], classes=cfg["classes"])
        net.initialize(mx.init.Xavier(), ctx=mx.gpu(0))
        net.hybridize()
        # the first call makes the deferred parameters (inline)
        fwd_flops = _resnet_flops(net, x)
        params = net.collect_params()
        n_params = sum(p.data().size for p in params.values()
                       if p.grad_req != "null")
        n_stats = sum(p.data().size for n, p in params.items()
                      if _is_stat(n))
        stats0 = [p.data().asnumpy() for n, p in params.items()
                  if _is_stat(n)]
        parts = {}

        def measure(part, call, read, flops, owner):
            for _ in range(warmup):
                out = call()
            first_read = read(out)
            torch.cuda.reset_peak_memory_stats(dev)
            replays0 = owner.replays
            bwd0 = getattr(owner, "backward_replays", 0)
            step_s, naive_s, windows, used, last = timed_windows(
                call, n1, steps, f"resnet {part}", read=read)
            peak = torch.cuda.max_memory_allocated(dev)
            row = {"step_ms": step_s * 1e3, "naive_step_ms": naive_s * 1e3,
                   "timing": used, "windows": [n1, steps],
                   "window_s": windows, "images_per_s": b / step_s,
                   "flops_per_step": flops,
                   "mfu": flops / step_s / PEAK_FLOPS["bfloat16"],
                   "peak_mem_bytes": peak, "captures": owner.captures,
                   "replays_counted": owner.replays - replays0,
                   "backward_replays_counted":
                       getattr(owner, "backward_replays", 0) - bwd0,
                   "first_read": first_read, "last_read": last}
            parts[part] = row
            return row

        # inference: predict mode, no recording
        op = net._cached_op
        infer = measure("inference", lambda: net(x),
                        lambda o: float(o.asnumpy().ravel()[0]),
                        fwd_flops, op)
        infer["graph_pool_bytes"] = op.pool_bytes
        infer["breakdown"] = profile_call(lambda: net(x))
        check(op.captures == 1 and infer["replays_counted"] == n1 + steps,
              f"resnet inference: {op.captures} captures and "
              f"{infer['replays_counted']} replays; want 1 and "
              f"{n1 + steps}")

        # training: the captured fused step, then the eager trainer
        sce = gluon.loss.SoftmaxCrossEntropyLoss()

        def trainer(fuse):
            return parallel.DataParallelTrainer(
                net, lambda out, label: sce(out, label).mean(), "sgd",
                {"learning_rate": cfg["lr"]}, fuse_step=fuse)
        dpt = trainer(True)
        first = float(dpt.step(x, y).asnumpy())
        op_captures, op_entries = op.captures, len(op)
        train = measure("train", lambda: dpt.step(x, y), last_loss,
                        3 * fwd_flops, dpt)
        train["first_loss"] = first
        train["graph_pool_bytes"] = dpt.pool_bytes
        train["breakdown"] = profile_call(lambda: dpt.step(x, y))
        check(dpt.captures == 1 and train["replays_counted"] == n1 + steps,
              f"resnet train: {dpt.captures} captures and "
              f"{train['replays_counted']} replays; want 1 and "
              f"{n1 + steps}")
        check(op.captures == op_captures and len(op) == op_entries,
              "resnet train: the hybridized net captured inside the "
              "trainer's step")
        check(train["last_read"] < first,
              f"resnet train: last loss {train['last_read']} not below "
              f"the first {first}")
        eager = trainer(False)
        eager_row = measure("train_eager_trainer", lambda: eager.step(x, y),
                            last_loss, 3 * fwd_flops, op)
        eager_row["graph_pool_bytes"] = op.pool_bytes
        eager_row["breakdown"] = profile_call(lambda: eager.step(x, y))
        check(eager_row["replays_counted"] == n1 + steps ==
              eager_row["backward_replays_counted"],
              f"resnet eager trainer: {eager_row['replays_counted']} forward "
              f"and {eager_row['backward_replays_counted']} backward replays "
              f"of the hybridized net, want {n1 + steps} each")

        # the gluon loop: record, forward, loss, backward, Trainer.step
        gtr = gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": cfg["lr"]}, kvstore=None)

        def gluon_step():
            with autograd.record():
                loss = sce(net(x), y)
            loss.backward()
            gtr.step(b)
            return loss
        captures_before = op.captures
        loop = measure("gluon_loop", gluon_step,
                       lambda l: float(l.mean().asscalar()), 3 * fwd_flops,
                       op)
        loop["graph_pool_bytes"] = op.pool_bytes
        loop["breakdown"] = profile_call(gluon_step)
        check(op.captures == captures_before,
              f"resnet gluon loop: {op.captures - captures_before} new "
              "captures; the eager trainer's calls captured its entry")
        check(loop["replays_counted"] == n1 + steps ==
              loop["backward_replays_counted"],
              f"resnet gluon loop: {loop['replays_counted']} forward and "
              f"{loop['backward_replays_counted']} backward replays in the "
              f"timed windows, want {n1 + steps} each")
        stats1 = [p.data().asnumpy() for n, p in params.items()
                  if _is_stat(n)]
        launches = read_counts()
    finally:
        amp._deinit()
    moved = _rel_l2(stats1, stats0)
    finite = all(np.isfinite(s).all() for s in stats1)
    emit({"phase": "resnet", "model": cfg["model"],
          "dtype": "bfloat16 AMP", "batch_size": b, "image_size": size,
          "classes": cfg["classes"], "params": n_params,
          "running_stat_values": n_stats,
          "forward_flops_per_image": fwd_flops / b,
          "cachedop": {"entries": len(op), "captures": op.captures,
                       "replays": op.replays, "pool_bytes": op.pool_bytes},
          "cudnn_benchmark": torch.backends.cudnn.benchmark,
          "layout": "NCHW", "running_stats_moved_rel_l2": moved,
          "running_stats_finite": finite, "flash_launches": launches,
          "card": nvidia_smi(), **{k: {kk: vv for kk, vv in v.items()
                                       if kk != "breakdown"}
                                   for k, v in parts.items()}})
    for part, row in parts.items():
        emit(dict({"phase": "resnet_breakdown", "call": part},
                  **row["breakdown"]))
    check(moved > 0 and finite, f"resnet: running statistics moved "
          f"{moved}, finite {finite}")
    # training goes on from one part to the next over the fixed batch:
    # each part's loss ends no higher than it began
    for part in ("train_eager_trainer", "gluon_loop"):
        row = parts[part]
        check(row["last_read"] <= row["first_read"],
              f"resnet {part}: the loss rose from {row['first_read']} to "
              f"{row['last_read']}")
    check(not any(launches.values()),
          f"resnet: the ResNet path launched flash kernels {launches}")


# -- phases 15-16: Llama training ----------------------------------------------

# the reference's gluon loop at Llama-3-8B's published width: untied head,
# depth cut from 32 layers to 4 (Adam's float32 state of the whole model,
# 16 B a parameter, is 128.5 GB); one sequence of 4096 tokens a step
LLAMA_TRAIN = dict(config="llama3_8b", vocab=128256, layers=4,
                   batch_size=1, seq_len=4096, lr=1e-4, warmup=3,
                   windows=(5, 20), vocab_chunk=8192)
# the parity runs: (config, sequence length, vocab_chunk); both lengths
# take the flash kernels' f32 routes, mistral_tiny's 256 crosses its
# window of 32; llama_tiny's loss takes the full logits, mistral_tiny's
# the chunked head
LLAMA_PARITY = (("llama_tiny", 128, None), ("mistral_tiny", 256, 16))
LLAMA_PARITY_TOL = 1e-4
# chunked_softmax_ce against the full logits on the card
CE_CHECK = dict(n=512, units=4096, vocab=128256, chunk=8192)


def _llama_loop(mx, net, tokens, steps, lr, vocab_chunk=None):
    """The reference's training loop (``tests/test_llama.py``): hybridize,
    gluon.Trainer "adam", record -> net.loss -> backward -> step(B).
    Returns (losses, trainer, the CachedOp the loss runs through)."""
    from mxnet_tpu_torch import autograd, gluon
    net.hybridize()
    tr = gluon.Trainer(net.collect_params(), "adam", {"learning_rate": lr})
    losses = []
    for _ in range(steps):
        with autograd.record():
            loss = net.loss(tokens, vocab_chunk=vocab_chunk)
        loss.backward()
        tr.step(tokens.shape[0])
        losses.append(float(loss.asnumpy()))
    # the chunked head calls the model; the full logits, the whole LM
    op = net.model._cached_op if vocab_chunk else net._cached_op
    return losses, tr, op


def _chunked_ce_check(dev, cfg=CE_CHECK):
    """chunked_softmax_ce on the card at Llama-3-8B's vocabulary against
    the full (N, V) float32 logits on the same inputs: loss, dH and dW
    within LLAMA_PARITY_TOL relative, and the memory each needs beyond
    its inputs and gradients."""
    import torch
    from mxnet_tpu_torch.ops import nn as ops
    n, u, v = cfg["n"], cfg["units"], cfg["vocab"]
    g = torch.Generator(device=dev)
    g.manual_seed(11)
    h = torch.randn(n, u, generator=g, device=dev).requires_grad_(True)
    w = (torch.randn(v, u, generator=g, device=dev) * 0.02) \
        .requires_grad_(True)
    lbl = torch.randint(0, v, (n,), generator=g, device=dev).float()
    grad_bytes = 4 * (n * u + v * u)

    def run(fn):
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        loss = fn()
        torch.cuda.synchronize(dev)
        fwd = torch.cuda.max_memory_allocated(dev) - base
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        gh, gw = torch.autograd.grad(loss.sum(), (h, w))
        torch.cuda.synchronize(dev)
        bwd = torch.cuda.max_memory_allocated(dev) - base - grad_bytes
        return loss.detach(), gh, gw, fwd, bwd

    def full():
        logits = h @ w.t()
        return torch.logsumexp(logits, 1) - logits.gather(
            1, lbl.long()[:, None])[:, 0]
    got = run(lambda: ops.chunked_softmax_ce(h, w, lbl, chunk=cfg["chunk"]))
    want = run(full)
    errs = {k: _rel(a.cpu().numpy(), b.cpu().numpy())
            for k, a, b in zip(("loss", "d_hidden", "d_weight"), got, want)}
    logits_bytes = 4 * n * v
    ms = device_ms(lambda: torch.autograd.grad(
        ops.chunked_softmax_ce(h, w, lbl, chunk=cfg["chunk"]).sum(),
        (h, w)), reps=3, warmup=1)
    row = {"phase": "llama_train_parity", "check": "chunked_softmax_ce",
           **cfg, "slabs": len(ops._slabs(v, cfg["chunk"])),
           "rel_err": errs, "tol": LLAMA_PARITY_TOL,
           "full_logits_bytes": logits_bytes,
           "fwd_extra_bytes": got[3], "bwd_extra_bytes": got[4],
           "full_fwd_extra_bytes": want[3],
           "full_bwd_extra_bytes": want[4], "fwd_bwd_ms": ms}
    emit(row)
    for k, e in errs.items():
        check(e <= LLAMA_PARITY_TOL, f"chunked_softmax_ce: {k} relative "
              f"error {e} > {LLAMA_PARITY_TOL}")
    # O(N * chunk): a slab's logits and their gradient, a few at a time,
    # far below the whole (N, V) logits
    for k in ("fwd_extra_bytes", "bwd_extra_bytes"):
        check(row[k] <= logits_bytes / 4,
              f"chunked_softmax_ce: {k} {row[k]} is not far below the "
              f"full logits' {logits_bytes} bytes")
    return row


def phase_llama_train_parity(mx, dev, steps=3, lr=1e-3):
    """llama_tiny (S=128) and mistral_tiny (S=256, past its window of 32)
    at V=61, B=2, float32: 3 steps of the hybridized gluon loop on the
    card and on the CPU from the same Xavier weights.  Losses and weights
    (relative L2 a tensor) within LLAMA_PARITY_TOL; on the card one
    capture, the later steps a forward and a backward replay each, and
    every flash counter of the f32 route layers x steps.  Then
    chunked_softmax_ce at Llama-3-8B's vocabulary against the full
    logits."""
    from mxnet_tpu_torch import models
    free_earlier_phases()
    rows = []
    for config, s, chunk in LLAMA_PARITY:
        tok = np.random.RandomState(0).randint(0, 61, (2, s)).astype("f4")

        def make(ctx):
            return models.LlamaForCausalLM(
                models.get_llama(config, vocab_size=61), ctx=ctx)
        cpu = make(mx.cpu()).initialize(mx.init.Xavier(), seed=5)
        card = make(mx.gpu(0))
        _copy_params(cpu, card)
        want, _, _ = _llama_loop(mx, cpu, mx.nd.array(tok, ctx=mx.cpu()),
                                 steps, lr, chunk)
        reset_counts()
        got, _, op = _llama_loop(mx, card, mx.nd.array(tok, ctx=mx.gpu(0)),
                                 steps, lr, chunk)
        launches = read_counts()
        layers = len(card.model.layers)
        loss_err = _rel(got, want)
        weight_err = max(_rel_l2([a.data().asnumpy()], [b.data().asnumpy()])
                         for a, b in zip(card.collect_params().values(),
                                         cpu.collect_params().values()))
        row = {"phase": "llama_train_parity", "config": config,
               "seq_len": s, "vocab_chunk": chunk, "losses": got,
               "cpu_losses": want, "loss_rel_err": loss_err,
               "weight_rel_l2_max": weight_err, "tol": LLAMA_PARITY_TOL,
               "captures": op.captures, "replays": op.replays,
               "backward_replays": op.backward_replays,
               "launches": launches}
        emit(row)
        rows.append(row)
        check(loss_err <= LLAMA_PARITY_TOL and
              weight_err <= LLAMA_PARITY_TOL,
              f"llama_train_parity {config}: losses {loss_err}, weights "
              f"{weight_err} > {LLAMA_PARITY_TOL}")
        check(got[-1] < got[0], f"llama_train_parity {config}: the loss "
              f"did not fall {got}")
        # step 1 eager (the warm-up), step 2 captured and replayed,
        # step 3 replayed
        check(op.captures == 1 and op.replays == steps - 1 ==
              op.backward_replays,
              f"llama_train_parity {config}: captures {op.captures}, "
              f"replays {op.replays}, backward {op.backward_replays}")
        check(all(launches[k] == layers * steps for k in F32_ROUTE)
              and not any(launches[k] for k in COUNTERS
                          if k not in F32_ROUTE),
              f"llama_train_parity {config}: launches {launches}, want "
              f"{layers} x {steps} on the f32 route")
    rows.append(_chunked_ce_check(dev))
    return rows


def _llama_split(per_kernel, head_gemm_ms, head_ms):
    """A profiled step's device time by kind (ms): flash kernels, Adam
    (the multi-tensor kernels), the head (the chunked cross-entropy,
    measured alone: ``head_ms``, of it GEMMs ``head_gemm_ms``), the
    layers' GEMMs (every GEMM kernel of the step less the head's) and
    the rest."""
    total = sum(per_kernel.values())
    flash = sum(t for k, t in per_kernel.items() if "flash_" in k)
    adam = sum(t for k, t in per_kernel.items()
               if "multi_tensor_apply" in k)
    gemm = sum(t for k, t in per_kernel.items() if _is_gemm(k))
    split = {"device_ms": total, "flash_ms": flash, "adam_ms": adam,
             "head_ms": head_ms, "head_gemm_ms": head_gemm_ms,
             "gemm_bf16_ms": gemm - head_gemm_ms,
             "other_ms": total - flash - adam - head_ms
             - (gemm - head_gemm_ms)}
    split["shares"] = {k[:-3]: v / total for k, v in split.items()
                       if k.endswith("_ms") and k not in ("device_ms",
                                                          "head_gemm_ms")}
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:10]
    split["top_kernels"] = [[k[:100], t] for k, t in top]
    return split


def _is_gemm(name):
    name = name.lower()
    return any(g in name for g in ("gemm", "gemv", "cutlass", "nvjet",
                                   "xmma", "matmul"))


def phase_llama_train(mx, dev, cfg=LLAMA_TRAIN):
    """The reference's Llama training loop at Llama-3-8B's published width
    (4096 / 14336, 32 heads over 8 KV heads, D=128, V=128256, untied
    head; ``cfg["layers"]`` layers), bf16 AMP, Adam lr 1e-4, one sequence
    of 4096 seeded tokens: warm-ups, then two timed windows of the gluon
    loop; tokens/s, ms a step, MFU, the head's float32 share, peak
    memory, the CachedOp's pool, captures and replays, launches, and one
    profiled step split into flash, bf16 GEMM, head, Adam and other."""
    import torch
    from mxnet_tpu_torch import autograd, gluon, models
    from mxnet_tpu_torch.contrib import amp
    from mxnet_tpu_torch.ops import nn as ops
    v, layers = cfg["vocab"], cfg["layers"]
    b, s, lr = cfg["batch_size"], cfg["seq_len"], cfg["lr"]
    n1, n2 = cfg["windows"]
    free_earlier_phases()
    mx.random.seed(0)
    amp.init(target_dtype="bfloat16")
    try:
        t0 = time.perf_counter()
        net = models.LlamaForCausalLM(
            models.get_llama(cfg["config"], vocab_size=v, num_layers=layers),
            tie_embeddings=False, ctx=mx.gpu(0))
        net.initialize(mx.init.Xavier())
        torch.cuda.synchronize(dev)
        init_s = time.perf_counter() - t0
        net.hybridize()
        trainer = gluon.Trainer(net.collect_params(), "adam",
                                {"learning_rate": lr})
        tok = np.random.RandomState(0).randint(0, v, (b, s)).astype("f4")
        tokens = mx.nd.array(tok, ctx=mx.gpu(0))

        def step():
            with autograd.record():
                loss = net.loss(tokens)
            loss.backward()
            trainer.step(b)
            return loss
        first = None
        for _ in range(cfg["warmup"]):
            loss = step()
            first = last_loss(loss) if first is None else first
        op = net.model._cached_op
        captures0, replays0, bwd0 = op.captures, op.replays, \
            op.backward_replays
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        reset_counts()
        step_s, naive_s, windows, used, last = timed_windows(
            step, n1, n2, "llama_train")
        launches = read_counts()
        peak = torch.cuda.max_memory_allocated(dev)
        reserved = torch.cuda.max_memory_reserved(dev)
        replays, bwd = op.replays - replays0, op.backward_replays - bwd0
        captures = op.captures - captures0
        n_steps = n1 + n2
        # the profiled step, and the head alone on the same shapes
        step_ms, per_kernel = device_ms(step, reps=3, warmup=1,
                                        by_kernel=True)
        hid = torch.randn(b * (s - 1), net.model._units, device=dev,
                          requires_grad=True)
        head_w = net.lm_head.weight
        lbl = tokens.tensor[:, 1:].reshape(-1)

        def head():
            return torch.autograd.grad(ops.chunked_softmax_ce(
                hid, head_w, lbl, chunk=cfg["vocab_chunk"]).sum(),
                (hid, head_w))
        head_ms, head_kernels = device_ms(head, reps=3, warmup=1,
                                          by_kernel=True)
        head_gemm_ms = sum(t for k, t in head_kernels.items() if _is_gemm(k))
        del hid, head_kernels
        split = _llama_split(per_kernel, head_gemm_ms, head_ms)
        walls = []
        for _ in range(3):
            t1 = time.perf_counter()
            step()
            torch.cuda.synchronize(dev)
            walls.append((time.perf_counter() - t1) * 1e3)
        split["wall_ms"] = statistics.median(walls)
        split["device_busy_share"] = step_ms / split["wall_ms"]
        pool = op.pool_bytes
        n_params = sum(p.numel() for p in net.parameters())
        embed = net.model.embed.weight.numel() + net.lm_head.weight.numel()
    finally:
        amp._deinit()
    u, heads = net.model._units, net.model.layers[0].attn._h
    d = net.model.layers[0].attn._d
    t = b * s
    non_embed = n_params - embed
    # causal attention: QK^T and PV over the kept half of the pairs,
    # 2 S^2 D H a layer forward, twice that backward
    attn_flops = 3 * layers * b * 2.0 * s * s * d * heads
    bf16_flops = 6.0 * non_embed * t + attn_flops
    # the head in float32: four products of 2 T U V (forward, the
    # backward's recompute, dH, dW) over B (S - 1) rows
    head_flops = 4 * 2.0 * b * (s - 1) * u * v
    bound_s = bf16_flops / PEAK_FLOPS["bfloat16"] \
        + head_flops / PEAK_FLOPS["float32"]
    row = {"phase": "llama_train", "config": cfg["config"],
           "units": u,
           "hidden": net.model.layers[0].mlp.gate_proj.weight.shape[0],
           "heads": heads,
           "kv_heads": net.model.layers[0].attn._kv, "head_dim": d,
           "vocab": v, "layers": layers, "tied": False,
           "batch_size": b, "seq_len": s, "dtype": "bfloat16 AMP",
           "optimizer": "adam", "lr": lr, "params": n_params,
           "non_embedding_params": non_embed, "weights_init_s": init_s,
           "warmup": cfg["warmup"], "windows": [n1, n2],
           "window_s": windows, "step_ms": step_s * 1e3,
           "naive_step_ms": naive_s * 1e3, "timing": used,
           "tokens_per_s": t / step_s,
           "mfu": bf16_flops / step_s / PEAK_FLOPS["bfloat16"],
           "bf16_flops_per_step": bf16_flops,
           "attention_flops_per_step": attn_flops,
           "head_f32_flops_per_step": head_flops,
           "head_f32_bound_ms": head_flops / PEAK_FLOPS["float32"] * 1e3,
           "step_bound_ms": bound_s * 1e3,
           "bound_over_step": bound_s / step_s,
           "first_loss": first, "last_loss": last,
           "peak_mem_bytes": peak, "peak_reserved_bytes": reserved,
           "cachedop": {"entries": len(op), "captures": op.captures,
                        "pool_bytes": pool},
           "captures_counted": captures, "replays_counted": replays,
           "backward_replays_counted": bwd, "steps_counted": n_steps,
           **launches, "card": nvidia_smi()}
    emit(row)
    emit(dict({"phase": "llama_train_breakdown",
               "call": "gluon loop step (profiled)"}, **split))
    check(math.isfinite(last) and last < first,
          f"llama_train: the loss went from {first} to {last}")
    check(captures == 0 and op.captures == 1 and len(op) == 1,
          f"llama_train: {op.captures} captures ({captures} in the timed "
          f"windows), {len(op)} entries; want one, before the windows")
    check(replays == n_steps == bwd,
          f"llama_train: {replays} forward and {bwd} backward replays in "
          f"the timed windows, want {n_steps} each (no eager step)")
    check(all(n == layers * n_steps for n in launches.values()),
          f"llama_train: launches {launches}, want {layers} x {n_steps} "
          "each (K1 in the forward replay, K2 and K3 in the backward)")
    return dict(launches, per_step=layers, row=row, split=split)


# -- phases 17-18: GluonTS forecasting (BASELINE config #4) ---------------------

# GluonTS's documented defaults: DeepAREstimator (num_cells 40, num_layers
# 2, LSTM, dropout 0.1) and TransformerEstimator's widths (model_dim 32,
# inner_ff_dim_scale 4, num_heads 8) with the reference class's 2 + 2
# layers; the DeepAR paper's electricity setup (hourly, context 168,
# prediction 24, 370 series); GluonTS's Trainer batch 32, Adam lr 1e-3,
# float32; prediction with num_parallel_samples 100.  The series are
# synthetic (example/forecasting_deepar.py's seasonal sines, hourly
# period 24), made from a seed with numpy: no dataset is in the repository
FORECAST = dict(context=168, prediction=24, batch_size=32, lr=1e-3,
                series=370, num_samples=100, warmup=3, windows=(5, 20),
                deepar=dict(num_cells=40, num_layers=2, dropout=0.1),
                transformer=dict(units=32, hidden_size=128, num_heads=8,
                                 enc_layers=2, dec_layers=2),
                params={"deepar": 20082, "transformer": 65730})
# the parity runs: tiny configurations, float32, dropout 0
FORECAST_PARITY = dict(context=24, prediction=12, batch_size=8, lr=1e-3,
                       deepar=dict(num_cells=16, num_layers=2),
                       transformer=dict(units=16, hidden_size=32,
                                        num_heads=4, enc_layers=2,
                                        dec_layers=2))
FORECAST_LOSS_TOL = 1e-4
FORECAST_WEIGHT_TOL = 1e-5
FORECAST_FC_TOL = 1e-5


def _forecast_series(n, length, seed, period=24):
    """example/forecasting_deepar.py's series: seasonal sines with random
    phase and amplitude, plus noise, shifted positive."""
    rng = np.random.RandomState(seed)
    t = np.arange(length)[None, :]
    x = (1.0 + 3.0 * rng.rand(n, 1)) * np.sin(
        2 * np.pi * t / period + rng.rand(n, 1) * 2 * np.pi)
    return (x + 5.0 + 0.1 * rng.randn(n, length)).astype("float32")


def _forecaster(mx, kind, cfg, ctx, seed):
    """``kind``'s model at ``cfg``, Xavier-initialized on ``ctx`` from
    ``seed``, under the prefix ``kind_`` (so two of them share names)."""
    from mxnet_tpu_torch import models
    cls = models.DeepAR if kind == "deepar" else models.TransformerForecaster
    net = cls(cfg["context"], cfg["prediction"], prefix=f"{kind}_",
              **cfg[kind])
    return net.initialize(mx.init.Xavier(), ctx=ctx, seed=seed)


def _forecast_loop(mx, net, past, fut, steps, lr, hybridize=True):
    """The reference's loop (example/forecasting_deepar.py): hybridize,
    gluon.Trainer "adam", record -> net(past, future).mean() -> backward
    -> step(B).  Returns (losses, step function)."""
    from mxnet_tpu_torch import autograd, gluon
    net.hybridize(hybridize)
    tr = gluon.Trainer(net.collect_params(), "adam", {"learning_rate": lr})
    b = past.shape[0]

    def step():
        with autograd.record():
            loss = net(past, fut).mean()
        loss.backward()
        tr.step(b)
        return loss
    return [float(step().asnumpy()) for _ in range(steps)], step


def _weights(net):
    return {k: p.data().asnumpy() for k, p in net.collect_params().items()}


def _weight_errs(got, want, f64, lr, steps):
    """Each tensor's relative L2 distance from ``want`` (the CPU's
    float32 weights), and the limit it is held to: the larger of
    FORECAST_WEIGHT_TOL and 4x the CPU's own float32-against-float64
    distance for that tensor (as resnet_parity does: a weight whose
    update float32 cannot resolve, such as a causal self-attention's
    query bias, parts from float64 by more than 1e-5 on the CPU alone).
    A key bias has no gradient in exact arithmetic (softmax is
    shift-invariant), so Adam moves it by the sign of float32 noise, by
    about lr a step at most: it is held to that bound instead.  Returns
    ({name: (distance, limit)}, the key biases' largest size)."""
    errs, key_bias = {}, 0.0
    for k, w in want.items():
        if k.endswith("_key_bias"):
            key_bias = max(key_bias, float(np.abs(got[k]).max()))
            continue
        errs[k] = (_rel_l2([got[k]], [w]),
                   max(FORECAST_WEIGHT_TOL, 4 * _rel_l2([w], [f64[k]])))
    check(key_bias <= steps * lr * 1.01,
          f"forecast_parity: a key bias moved {key_bias}, past Adam's "
          f"bound {steps * lr}")
    return errs, key_bias


def phase_forecast_parity(mx, dev, steps=3):
    """Tiny DeepAR and TransformerForecaster (C=24, P=12, 16 cells or
    units, float32, dropout 0; cuDNN's TF32 flag left at PyTorch's
    default, which the recurrence turns off itself) from the same Xavier
    weights: 3 Adam steps of the hybridized gluon loop on the card and on
    the CPU (losses within 1e-4, weights within 1e-5 in relative L2);
    forecast() within 1e-5 of the CPU's; sample() seeded twice gives the
    same paths; the captured loop (one capture, then a forward and a
    backward replay a step) bit for bit the eager loop on the card; no
    flash kernel."""
    import torch
    from mxnet_tpu_torch import nd
    cfg = FORECAST_PARITY
    free_earlier_phases()
    check(torch.backends.cudnn.allow_tf32,
          "forecast_parity: cuDNN's TF32 flag is meant to stay at PyTorch's "
          "default (on) here")
    data = _forecast_series(cfg["batch_size"],
                            cfg["context"] + cfg["prediction"], 3)
    rows = []
    for kind in ("deepar", "transformer"):
        nets, arrays = {}, {}
        for where, ctx in (("cpu", mx.cpu()), ("card", mx.gpu(0)),
                           ("card_eager", mx.gpu(0))):
            nets[where] = _forecaster(mx, kind, cfg, ctx, seed=7)
            arrays[where] = [mx.nd.array(data[:, :cfg["context"]], ctx=ctx),
                             mx.nd.array(data[:, cfg["context"]:], ctx=ctx)]
        _copy_params(nets["cpu"], nets["card"])
        _copy_params(nets["cpu"], nets["card_eager"])
        # the CPU's float64 twin: how far float32 itself carries the
        # weights
        nets["cpu_f64"] = _forecaster(mx, kind, cfg, mx.cpu(), seed=7)
        _copy_params(nets["cpu"], nets["cpu_f64"])
        nets["cpu_f64"].to(torch.float64)
        arrays["cpu_f64"] = [nd.array(a.asnumpy(), ctx=mx.cpu(),
                                      dtype="float64")
                             for a in arrays["cpu"]]
        losses = {}
        reset_counts()
        for where in nets:
            losses[where], _ = _forecast_loop(
                mx, nets[where], *arrays[where], steps, cfg["lr"],
                hybridize=where != "card_eager")
        launches = read_counts()
        weights = {w: _weights(n) for w, n in nets.items()}
        loss_err = _rel(losses["card"], losses["cpu"])
        errs, key_bias = _weight_errs(weights["card"], weights["cpu"],
                                      weights["cpu_f64"], cfg["lr"], steps)
        weight_err = max(e for e, _ in errs.values())
        worst = max(errs, key=lambda k: errs[k][0] / errs[k][1])
        over = {k: e for k, e in errs.items() if e[0] > e[1]}
        fc = {w: nets[w].forecast(arrays[w][0]).asnumpy()
              for w in ("cpu", "card")}
        fc_err = _rel(fc["card"], fc["cpu"])
        bitwise = losses["card"] == losses["card_eager"] and all(
            np.array_equal(weights["card"][k], weights["card_eager"][k])
            for k in weights["card"])
        op = nets["card"]._cached_op
        row = {"phase": "forecast_parity", "model": kind,
               "context": cfg["context"], "prediction": cfg["prediction"],
               "batch_size": cfg["batch_size"], **cfg[kind],
               "losses": losses["card"], "cpu_losses": losses["cpu"],
               "loss_rel_err": loss_err, "loss_tol": FORECAST_LOSS_TOL,
               "weight_rel_l2_max": weight_err,
               "weight_tol": FORECAST_WEIGHT_TOL,
               "worst_tensor": [worst, *errs[worst]],
               "above_1e-5": {k: e for k, e in errs.items()
                              if e[0] > FORECAST_WEIGHT_TOL},
               "cpu_f32_vs_f64_loss_rel_err": _rel(losses["cpu"],
                                                   losses["cpu_f64"]),
               "key_bias_max_abs": key_bias,
               "forecast_rel_err": fc_err, "forecast_tol": FORECAST_FC_TOL,
               "captured_equals_eager_bitwise": bitwise,
               "captures": op.captures, "replays": op.replays,
               "backward_replays": op.backward_replays,
               "launches": launches}
        if kind == "deepar":
            paths = []
            for _ in range(2):
                mx.random.seed(11)
                paths.append(nets["card"].sample(arrays["card"][0],
                                                 num_samples=50).asnumpy())
            row["sample_shape"] = list(paths[0].shape)
            row["sample_seeded_equal"] = bool(np.array_equal(*paths))
            check(row["sample_seeded_equal"] and row["sample_shape"] == [
                50, cfg["batch_size"], cfg["prediction"]],
                f"forecast_parity: sample() {row['sample_shape']}, seeded "
                f"twice equal: {row['sample_seeded_equal']}")
        emit(row)
        rows.append(row)
        check(loss_err <= FORECAST_LOSS_TOL and not over
              and fc_err <= FORECAST_FC_TOL,
              f"forecast_parity {kind}: losses {loss_err}, weights above "
              f"their limits {over}, forecast {fc_err}")
        check(bitwise, f"forecast_parity {kind}: the captured loop is not "
              f"bit for bit the eager one: {losses['card']} against "
              f"{losses['card_eager']}")
        check(op.captures == 1 and op.replays == steps - 1 ==
              op.backward_replays,
              f"forecast_parity {kind}: captures {op.captures}, replays "
              f"{op.replays}, backward {op.backward_replays}")
        check(not any(launches.values()),
              f"forecast_parity {kind}: flash launches {launches}")
        check(losses["card"][-1] < losses["card"][0],
              f"forecast_parity {kind}: the loss did not fall "
              f"{losses['card']}")
    return rows


def _forecast_split(per_kernel, attn):
    """A profiled step's device time by kind (ms): the recurrence (cuDNN's
    RNN kernels), GEMMs, attention (the plain path, measured alone on the
    step's shapes: ``attn`` is (ms, of it GEMMs)), Adam (the multi-tensor
    kernels) and the rest."""
    total = sum(per_kernel.values())
    rnn = sum(t for k, t in per_kernel.items()
              if "rnn" in k.lower() or "lstm" in k.lower())
    adam = sum(t for k, t in per_kernel.items()
               if "multi_tensor_apply" in k)
    gemm = sum(t for k, t in per_kernel.items()
               if _is_gemm(k) and not ("rnn" in k.lower()
                                       or "lstm" in k.lower()))
    attn_ms, attn_gemm = attn
    split = {"device_ms": total, "rnn_ms": rnn,
             "gemm_ms": gemm - attn_gemm, "attention_plain_ms": attn_ms,
             "adam_ms": adam,
             "other_ms": total - rnn - gemm - adam - (attn_ms - attn_gemm)}
    split["shares"] = {k[:-3]: v / total for k, v in split.items()
                       if k.endswith("_ms") and k != "device_ms"}
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:8]
    split["top_kernels"] = [[k[:100], t] for k, t in top]
    return split


def _attention_alone(net, b, dev):
    """(ms, of it GEMMs) of a TransformerForecaster step's attention,
    forward and backward, run alone on the step's shapes: each encoder
    layer's self-attention over the context, each decoder layer's causal
    self-attention and its cross-attention into the memory."""
    import torch
    from mxnet_tpu_torch.ops.attention import dot_product_attention
    c, p = net.context_length, net.prediction_length
    h = net.encoder.layers[0].attention._num_heads
    d = net._units // h
    causal = torch.tril(torch.ones(p, p, device=dev)).reshape(1, 1, p, p)
    shapes = [(c, c, None)] * len(net.encoder.layers)
    shapes += [(p, p, causal), (p, c, None)] * len(net.dec_cells)
    g = torch.Generator(device=dev)
    g.manual_seed(3)
    qkv = [[torch.randn(b, s, h, d, generator=g, device=dev,
                        requires_grad=True) for s in (sq, sk, sk)] + [m]
           for sq, sk, m in shapes]

    def run():
        for q, k, v, m in qkv:
            out = dot_product_attention(q, k, v, m)
            torch.autograd.grad(out.sum(), (q, k, v))
    ms, per = device_ms(run, reps=5, warmup=2, by_kernel=True)
    return ms, sum(t for k, t in per.items() if _is_gemm(k))


def phase_forecast(mx, dev, cfg=FORECAST):
    """GluonTS forecasting at its documented widths (FORECAST): for each
    model the reference's gluon loop (hybridized, Adam lr 1e-3, batch 32
    of context 168 + prediction 24) timed by the two-window slope (5 and
    20 steps after 3 warm-ups): ms a step, series/s, one capture before
    the windows and one forward and one backward replay a timed step, a
    profiled step split into the recurrence, GEMM, attention (plain),
    Adam and other, the busy share, peak memory, no flash launch, the
    loss falling; then DeepAR's sample(num_samples=100) and forecast()
    over 370 series: ms a call and sample paths a second."""
    import torch
    free_earlier_phases()
    c, p, b = cfg["context"], cfg["prediction"], cfg["batch_size"]
    data = _forecast_series(b, c + p, 0)
    past = mx.nd.array(data[:, :c], ctx=mx.gpu(0))
    fut = mx.nd.array(data[:, c:], ctx=mx.gpu(0))
    n1, n2 = cfg["windows"]
    out = {}
    for kind in ("deepar", "transformer"):
        free_earlier_phases()
        mx.random.seed(0)
        net = _forecaster(mx, kind, cfg, mx.gpu(0), seed=0)
        n_params = sum(p_.data().size
                       for p_ in net.collect_params().values())
        check(n_params == cfg["params"][kind],
              f"forecast {kind}: {n_params} parameters, want "
              f"{cfg['params'][kind]}")
        first = None
        _, step = _forecast_loop(mx, net, past, fut, 0, cfg["lr"])
        for _ in range(cfg["warmup"]):
            loss = step()
            first = last_loss(loss) if first is None else first
        op = net._cached_op
        captures0, replays0, bwd0 = op.captures, op.replays, \
            op.backward_replays
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        reset_counts()
        step_s, naive_s, windows, used, last = timed_windows(
            step, n1, n2, f"forecast {kind}")
        launches = read_counts()
        peak = torch.cuda.max_memory_allocated(dev)
        reserved = torch.cuda.max_memory_reserved(dev)
        captures = op.captures - captures0
        replays, bwd = op.replays - replays0, op.backward_replays - bwd0
        step_ms, per_kernel = device_ms(step, reps=5, warmup=1,
                                        by_kernel=True)
        attn = _attention_alone(net, b, dev) if kind == "transformer" \
            else (0.0, 0.0)
        split = _forecast_split(per_kernel, attn)
        walls = []
        for _ in range(5):
            t1 = time.perf_counter()
            step()
            torch.cuda.synchronize(dev)
            walls.append((time.perf_counter() - t1) * 1e3)
        split["wall_ms"] = statistics.median(walls)
        split["device_busy_share"] = step_ms / split["wall_ms"]
        row = {"phase": "forecast", "model": kind, "context": c,
               "prediction": p, "batch_size": b, **cfg[kind],
               "dtype": "float32", "optimizer": "adam", "lr": cfg["lr"],
               "params": n_params, "warmup": cfg["warmup"],
               "windows": [n1, n2], "window_s": windows,
               "step_ms": step_s * 1e3, "naive_step_ms": naive_s * 1e3,
               "timing": used, "series_per_s": b / step_s,
               "first_loss": first, "last_loss": last,
               "peak_mem_bytes": peak, "peak_reserved_bytes": reserved,
               "cachedop": {"entries": len(op), "captures": op.captures,
                            "pool_bytes": op.pool_bytes},
               "captures_counted": captures, "replays_counted": replays,
               "backward_replays_counted": bwd, "steps_counted": n1 + n2,
               "launches": launches, "card": nvidia_smi()}
        emit(row)
        emit(dict({"phase": "forecast_breakdown", "model": kind,
                   "call": "gluon loop step (profiled)"}, **split))
        check(math.isfinite(last) and last < first,
              f"forecast {kind}: the loss went from {first} to {last}")
        check(captures == 0 and op.captures == 1 and len(op) == 1,
              f"forecast {kind}: {op.captures} captures ({captures} in the "
              f"timed windows), {len(op)} entries; want one, before them")
        check(replays == n1 + n2 == bwd,
              f"forecast {kind}: {replays} forward and {bwd} backward "
              f"replays in the timed windows, want {n1 + n2} each")
        check(not any(launches.values()),
              f"forecast {kind}: flash launches {launches}")
        out[kind] = row
        if kind == "deepar":
            out["predict"] = _deepar_predict(mx, net, cfg, dev)
    return out


def _deepar_predict(mx, net, cfg, dev):
    """DeepAR's sample(num_samples) and forecast() over ``cfg["series"]``
    series of the context length: ms a call (CUDA events around 3 calls
    after a warm-up), sample paths a second, peak memory (and the memory
    the sample's LSTM warm-up over the context takes beyond its inputs);
    finite paths of the reference's shape."""
    import torch
    from mxnet_tpu_torch.gluon.block import inline_calls
    series = mx.nd.array(_forecast_series(cfg["series"], cfg["context"], 1),
                         ctx=mx.gpu(0))
    s = cfg["num_samples"]
    mx.random.seed(5)
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    paths = net.sample(series, num_samples=s)
    torch.cuda.synchronize(dev)
    sample_peak = torch.cuda.max_memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    fc = net.forecast(series)
    torch.cuda.synchronize(dev)
    forecast_peak = torch.cuda.max_memory_allocated(dev)
    # the sample's warm-up alone: the LSTM over the context's first
    # C - 1 steps of every row, one fused call a layer
    rows = cfg["series"] * s
    ctx_in = mx.nd.zeros((rows, cfg["context"] - 1, 1), ctx=mx.gpu(0))
    states = net.lstm.begin_state(rows, ctx=mx.gpu(0))
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    with torch.no_grad(), inline_calls():
        net.lstm(ctx_in, states)
    torch.cuda.synchronize(dev)
    warmup_extra = torch.cuda.max_memory_allocated(dev) - base
    del ctx_in, states
    sample_ms = cuda_time_ms(lambda: net.sample(series, num_samples=s),
                             reps=3, warmup=1)
    forecast_ms = cuda_time_ms(lambda: net.forecast(series), reps=3,
                               warmup=1)
    p = paths.asnumpy()
    row = {"phase": "forecast_predict", "model": "deepar",
           "series": cfg["series"], "num_samples": s,
           "rows_a_step": cfg["series"] * s,
           "prediction": cfg["prediction"], "sample_ms": sample_ms,
           "sample_paths_per_s": cfg["series"] * s / (sample_ms / 1e3),
           "forecast_ms": forecast_ms,
           "forecast_series_per_s": cfg["series"] / (forecast_ms / 1e3),
           "sample_peak_mem_bytes": sample_peak,
           "sample_warmup_lstm_extra_bytes": warmup_extra,
           "forecast_peak_mem_bytes": forecast_peak,
           "sample_shape": list(p.shape),
           "sample_mean_abs_gap_to_forecast": float(np.abs(
               p.mean(axis=0) - fc.asnumpy()).mean()),
           "card": nvidia_smi()}
    emit(row)
    check(list(p.shape) == [s, cfg["series"], cfg["prediction"]]
          and np.isfinite(p).all(),
          f"forecast_predict: sample paths {p.shape}, finite "
          f"{np.isfinite(p).all()}")
    return row


# -- phases 19-20: GAN training -------------------------------------------------

# example/dcgan.py's nets at DCGAN's published widths (Radford et al. 2016,
# "Unsupervised Representation Learning with Deep Convolutional GANs",
# sections 3-4: z of 100, 64 base filters doubling each layer, batch 128,
# Adam lr 2e-4 with beta1 0.5) on the example's four-layer 32 x 32 RGB
GAN = dict(nz=100, ngf=64, ndf=64, nc=3, batch_size=128, lr=2e-4,
           beta1=0.5, warmup=3, windows=(5, 20), batches=8)
# the parity runs: tiny widths, float32
GAN_PARITY = dict(nz=16, ngf=8, ndf=8, nc=3, batch_size=8, lr=2e-4,
                  beta1=0.5, steps=3)
GAN_LOSS_TOL = 1e-4
# each weight and moving statistic, card against CPU in float32, in
# relative L2: within the larger of GAN_WEIGHT_TOL and 4x the CPU's own
# float32-against-float64 distance.  GAN_WEIGHT_TOL is 3x the largest
# distance the card's float32 showed from its own float64 (1.66e-5, the
# generator's first BatchNorm beta): every gradient of the card's first
# iteration is ~1e-5 from float64 where the CPU's is ~6e-7, and Adam
# carries that into the weights.  A TF32 run of the same loop lands at
# 1e-3 to 0.2, and gan_parity runs one and requires this rule to reject it
GAN_WEIGHT_TOL = 5e-5
GAN_F64_TOL = 1e-10
GAN_OP_TOL = 1e-4


def _gan_nets(mx, cfg):
    """example/dcgan.py's build_generator and build_discriminator at
    ``cfg``'s widths: z (N, nz, 1, 1) -> Conv2DTranspose stack ->
    (N, nc, 32, 32) under tanh; a strided Conv2D stack with LeakyReLU
    0.2 -> one logit a 1 x 1 position."""
    from mxnet_tpu_torch.gluon import nn
    ngf, ndf, nc = cfg["ngf"], cfg["ndf"], cfg["nc"]
    gen = nn.HybridSequential(prefix="gen_")
    with gen.name_scope():
        gen.add(nn.Conv2DTranspose(ngf * 4, 4, 1, 0, use_bias=False),
                nn.BatchNorm(), nn.Activation("relu"),
                nn.Conv2DTranspose(ngf * 2, 4, 2, 1, use_bias=False),
                nn.BatchNorm(), nn.Activation("relu"),
                nn.Conv2DTranspose(ngf, 4, 2, 1, use_bias=False),
                nn.BatchNorm(), nn.Activation("relu"),
                nn.Conv2DTranspose(nc, 4, 2, 1, use_bias=False),
                nn.Activation("tanh"))
    disc = nn.HybridSequential(prefix="disc_")
    with disc.name_scope():
        disc.add(nn.Conv2D(ndf, 4, 2, 1, use_bias=False),
                 nn.LeakyReLU(0.2),
                 nn.Conv2D(ndf * 2, 4, 2, 1, use_bias=False),
                 nn.BatchNorm(), nn.LeakyReLU(0.2),
                 nn.Conv2D(ndf * 4, 4, 2, 1, use_bias=False),
                 nn.BatchNorm(), nn.LeakyReLU(0.2),
                 nn.Conv2D(1, 4, 1, 0, use_bias=False))
    return gen, disc


def _gan_images(rng, batch, size=32):
    """example/dcgan.py's synthetic_batch: a bright gaussian blob at a
    random place, the three channels at three brightnesses, in [-1, 1]."""
    y, x = np.mgrid[0:size, 0:size]
    imgs = np.empty((batch, 3, size, size), "float32")
    for i in range(batch):
        cx, cy = rng.randint(8, size - 8, 2)
        blob = np.exp(-((x - cx) ** 2 + (y - cy) ** 2) / 30.0)
        for c in range(3):
            imgs[i, c] = blob * (0.5 + 0.5 * c / 2) * 2 - 1
    return imgs


def _gan_pair(mx, cfg, ctx, seed):
    """Generator and discriminator on ``ctx``, Normal(0.02) from
    ``seed``, their deferred shapes made by one predict-mode call."""
    gen, disc = _gan_nets(mx, cfg)
    for i, net in enumerate((gen, disc)):
        net.initialize(mx.init.Normal(0.02), ctx=ctx, seed=seed + i)
    z = mx.nd.zeros((cfg["batch_size"], cfg["nz"], 1, 1), ctx=ctx)
    disc(gen(z))
    return gen, disc


def _gan_loop(mx, gen, disc, cfg, ctx, reals, noise=None, dtype="float32"):
    """example/dcgan.py's iteration as a function: a D step (disc(real),
    disc(gen(z).detach()), the two SigmoidBCE means, backward, Adam) and
    a G step (disc(gen(z)) against the real label, backward, Adam).  z is
    ``noise[i]`` (numpy, for parity runs) or drawn on the device as the
    example draws it.  Returns the iteration, which returns (d_loss,
    g_loss, out_r, out_f)."""
    from mxnet_tpu_torch import autograd, gluon, nd
    b, nz = cfg["batch_size"], cfg["nz"]
    opt = {"learning_rate": cfg["lr"], "beta1": cfg["beta1"]}
    g_tr = gluon.Trainer(gen.collect_params(), "adam", dict(opt))
    d_tr = gluon.Trainer(disc.collect_params(), "adam", dict(opt))
    bce = gluon.loss.SigmoidBinaryCrossEntropyLoss()
    real_label = nd.ones((b,), ctx=ctx, dtype=dtype)
    fake_label = nd.zeros((b,), ctx=ctx, dtype=dtype)
    reals = [nd.array(r, ctx=ctx, dtype=dtype) for r in reals]
    noise = None if noise is None else [nd.array(z, ctx=ctx, dtype=dtype)
                                        for z in noise]
    step = [0]

    def iteration():
        i = step[0]
        step[0] += 1
        real = reals[i % len(reals)]
        z = noise[i] if noise is not None else \
            nd.random.normal(shape=(b, nz, 1, 1), ctx=ctx)
        with autograd.record():
            out_r = disc(real).reshape((-1,))
            fake = gen(z)
            out_f = disc(fake.detach()).reshape((-1,))
            d_loss = (nd.mean(bce(out_r, real_label))
                      + nd.mean(bce(out_f, fake_label)))
        d_loss.backward()
        d_tr.step(b)
        with autograd.record():
            out = disc(gen(z)).reshape((-1,))
            g_loss = nd.mean(bce(out, real_label))
        g_loss.backward()
        g_tr.step(b)
        return d_loss, g_loss, out_r, out_f
    return iteration


def _gan_weights(gen, disc):
    return {k: p.data().asnumpy().astype("f8") for net in (gen, disc)
            for k, p in net.collect_params().items()}


def _gan_precision_probe(mx, dev, cfg, reals, noise):
    """Where the card's float32 leaves float64 in the first iteration:
    the discriminator's last convolution (the logits) in the G step,
    its input and its weight (after the D step's Adam update), the
    gradient at the generator's output and the generator's G-step
    gradients, each as the float32 run's relative L2 distance from the
    float64 run of the same device, and the D step's gradient of that
    weight with its smallest element (Adam's first step divides each
    element by its own size plus eps / sqrt(1 - beta2)); then that
    convolution alone on the float64 run's input and weight rounded to
    float32, against the exact product of the rounded operands, with
    the kernels the card ran for it."""
    import torch
    from mxnet_tpu_torch.ops import nn as ops_nn
    base = _gan_pair(mx, cfg, mx.cpu(), seed=11)
    got = {}
    for where, ctx in (("cpu", mx.cpu()), ("card", mx.gpu(0))):
        for dt in ("float64", "float32"):
            gen, disc = _gan_pair(mx, cfg, ctx, seed=11)
            for src, dst in zip(base, (gen, disc)):
                _copy_params(src, dst)
            if dt == "float64":
                gen.to(torch.float64)
                disc.to(torch.float64)
            seen = {"logits": [], "grad": [], "wgrad": []}
            last = list(disc.children())[-1]

            def keep(mod, inputs, out, seen=seen):
                seen["logits"].append((inputs[0].detach().cpu().double(),
                                       out.detach().cpu().double()))

            def keep_grad(mod, inputs, out, seen=seen):
                if out.requires_grad:
                    out.register_hook(lambda g: seen["grad"].append(
                        g.detach().cpu().double()))
            hooks = [last.register_forward_hook(keep),
                     list(gen.children())[-1].register_forward_hook(
                         keep_grad),
                     last.weight.register_hook(lambda g, seen=seen: seen[
                         "wgrad"].append(g.detach().cpu().double()))]
            try:
                _gan_loop(mx, gen, disc, cfg, ctx, reals, noise, dtype=dt)()
            finally:
                for h in hooks:
                    h.remove()
            # the third call of the discriminator is the G step's
            got[where, dt] = {
                "logits_input": seen["logits"][2][0].numpy(),
                "logits": seen["logits"][2][1].numpy(),
                "grad_at_gen_output": seen["grad"][-1].numpy(),
                "weight": last.weight.detach().cpu().double().numpy(),
                # the first backward through the last weight: the D step's
                "d_step_wgrad": seen["wgrad"][0].numpy().ravel(),
                "grads": {k: p.grad().asnumpy().astype("f8") for k, p in
                          gen.collect_params().items()
                          if p.grad_req != "null"}}
    w0_norm = float(np.linalg.norm(
        list(base[1].children())[-1].weight.detach().numpy()))

    def first_step(g):
        """Adam's first step (the optimizer's defaults, Trainer.step's
        1 / batch rescale) in float64."""
        g = g / cfg["batch_size"]
        return cfg["lr"] * g / (abs(g) + 1e-8 / math.sqrt(1 - 0.999))
    row = {}
    for where in ("cpu", "card"):
        a, b = got[where, "float32"], got[where, "float64"]
        row[where] = {k: _rel_l2([a[k]], [b[k]]) for k in (
            "logits_input", "weight", "logits", "grad_at_gen_output")}
        row[where]["gen_grads_max"] = max(
            _rel_l2([a["grads"][k]], [b["grads"][k]]) for k in b["grads"])
        # Adam's first step, lr g / (|g| + eps / sqrt(1 - beta2)), is
        # sensitive where |g| is small: the smallest element's rounding
        g32, g64 = a["d_step_wgrad"], b["d_step_wgrad"]
        i = int(np.argmin(np.abs(g64)))
        row[where]["d_step_wgrad"] = {
            "rel_l2": _rel_l2([g32], [g64]),
            "smallest_f64": float(g64[i]), "smallest_f32": float(g32[i]),
            "max_abs_f64": float(np.abs(g64).max()),
            # the weight distance that element's step alone makes
            "its_step_over_weight_norm": abs(
                first_step(g32[i]) - first_step(g64[i])) / w0_norm}
    x64, w64 = got["card", "float64"]["logits_input"], \
        got["card", "float64"]["weight"]
    x32, w32 = (torch.from_numpy(a.astype("f4")) for a in (x64, w64))
    exact = torch.nn.functional.conv2d(x32.double(), w32.double()).numpy()
    alone = {"logit_abs_mean": float(np.abs(exact).mean()),
             "term_abs_sum_mean": float(np.einsum(
                 "nchw,ochw->no", np.abs(x64), np.abs(w64)).mean())}
    for where, device in (("cpu", torch.device("cpu")), ("card", dev)):
        xs, ws = x32.to(device), w32.to(device)
        alone[where] = _rel_l2([ops_nn.convolution(xs, ws).cpu().numpy()],
                               [exact])
    xs, ws = x32.to(dev), w32.to(dev)
    alone["card_kernels"] = sorted(k[:90] for k in window_kernels(
        lambda: ops_nn.convolution(xs, ws), 3)[0])
    row["logits_conv_alone"] = alone
    return row


def _d_accuracy(out_r, out_f):
    """D's real/fake accuracy from its logits (as the example reads it)."""
    pr = out_r.asnumpy() > 0.0
    pf = out_f.asnumpy() <= 0.0
    return float(0.5 * (pr.mean() + pf.mean()))


def _deconv_case(mx, dev, name, data, weight, bias, attrs):
    """Deconvolution on the card against the CPU: the output and the
    gradients of sum(out * head) for data, weight and bias; the kernels
    one profiler window of its forward saw on the card named (cuDNN's,
    or the case fails; only the names are read, so a lost event of a
    tiny kernel does not matter here)."""
    import torch
    from mxnet_tpu_torch.ops import nn as ops

    def run(device, head=None):
        ts = [torch.from_numpy(a).to(device).requires_grad_(True)
              for a in (data, weight, bias)]
        out = ops.deconvolution(*ts, **attrs)
        if head is None:
            head = np.random.RandomState(5).uniform(
                -1, 1, tuple(out.shape)).astype("f4")
        grads = torch.autograd.grad(out, ts,
                                    torch.from_numpy(head).to(device))
        return [t.detach().cpu().numpy() for t in (out, *grads)], head
    want, head = run(torch.device("cpu"))
    got, _ = run(dev, head)
    ts = [torch.from_numpy(a).to(dev) for a in (data, weight, bias)]
    per = set(window_kernels(lambda: ops.deconvolution(*ts, **attrs), 5)[0])
    errs = [_rel(g, w) for g, w in zip(got, want)]
    row = {"case": name, "data": list(data.shape),
           "weight": list(weight.shape), "attrs": {k: list(v) if isinstance(
               v, tuple) else v for k, v in attrs.items()},
           "out": list(got[0].shape),
           "rel_err": dict(zip(("out", "d_data", "d_weight", "d_bias"),
                               errs)),
           "card_kernels": sorted(k[:80] for k in per)}
    check(max(errs) <= GAN_OP_TOL,
          f"gan_parity: Deconvolution {name} differs from the CPU by "
          f"{row['rel_err']}")
    check(any(c in k.lower() for k in per for c in CONV_KERNELS),
          f"gan_parity: Deconvolution {name} ran no cuDNN kernel: "
          f"{sorted(per)}")
    return row


def _gan_deconv_cases(mx, dev):
    """Deconvolution at the four generator shapes of the full-width run
    (the ``gan`` phase), with a bias, plus a target_shape and an adj
    case."""
    cfg = GAN
    rng = np.random.RandomState(3)
    b, chans = cfg["batch_size"], [cfg["nz"], cfg["ngf"] * 4,
                                   cfg["ngf"] * 2, cfg["ngf"], cfg["nc"]]
    sizes = [1, 4, 8, 16]
    cases = []
    for i in range(4):
        cin, cout, s = chans[i], chans[i + 1], sizes[i]
        stride, pad = (1, 0) if i == 0 else (2, 1)
        cases.append((f"gen_layer{i}", (b, cin, s, s), (cin, cout, 4, 4),
                      dict(stride=(stride, stride), pad=(pad, pad))))
    cases.append(("target_shape", (4, 8, 7, 7), (8, 6, 3, 3),
                  dict(stride=(2, 2), target_shape=(14, 13))))
    cases.append(("adj_groups", (4, 8, 5, 6), (8, 3, 3, 3),
                  dict(stride=(3, 2), pad=(1, 1), adj=(2, 1),
                       num_group=2)))
    rows = []
    for name, dshape, wshape, attrs in cases:
        cout = wshape[1] * attrs.get("num_group", 1)
        rows.append(_deconv_case(
            mx, dev, name, rng.randn(*dshape).astype("f4"),
            (rng.randn(*wshape) * 0.05).astype("f4"),
            rng.randn(cout).astype("f4"), attrs))
    return rows


def _gan_layer_sweep(mx, dev):
    """Each layer and loss the GAN slice added, on the card against the
    CPU from the same weights: the output and the gradients of sum(out *
    head) for the input and every parameter, within GAN_OP_TOL."""
    from mxnet_tpu_torch import autograd, nd
    from mxnet_tpu_torch.gluon import loss as L
    from mxnet_tpu_torch.gluon import nn
    layers = {
        "Conv1DTranspose": (lambda: nn.Conv1DTranspose(
            4, 3, strides=2, padding=1, output_padding=1), (2, 3, 7)),
        "Conv2DTranspose": (lambda: nn.Conv2DTranspose(
            6, 3, strides=2, padding=1, output_padding=1, groups=2,
            dilation=2), (2, 4, 5, 5)),
        "Conv3DTranspose": (lambda: nn.Conv3DTranspose(
            3, 3, strides=2, padding=1), (1, 2, 3, 4, 3)),
        "LeakyReLU": (lambda: nn.LeakyReLU(0.2), (3, 8)),
        "PReLU": (lambda: nn.PReLU(in_channels=3), (2, 3, 4)),
        "ELU": (lambda: nn.ELU(0.7), (3, 8)),
        "SELU": (lambda: nn.SELU(), (3, 8)),
        "Swish": (lambda: nn.Swish(1.5), (3, 8)),
        "SiLU": (lambda: nn.SiLU(), (3, 8)),
        "GELU": (lambda: nn.GELU(), (3, 8)),
        "GELU_tanh": (lambda: nn.GELU("tanh"), (3, 8)),
        "MaxPool1D": (lambda: nn.MaxPool1D(3, 2, 1), (2, 3, 9)),
        "MaxPool3D": (lambda: nn.MaxPool3D(2, ceil_mode=True),
                      (1, 2, 5, 4, 5)),
        "AvgPool1D": (lambda: nn.AvgPool1D(3, 2, 1,
                                           count_include_pad=False),
                      (2, 3, 9)),
        "AvgPool3D": (lambda: nn.AvgPool3D(2, padding=1), (1, 2, 4, 5, 4)),
        "GlobalMaxPool1D": (lambda: nn.GlobalMaxPool1D(), (2, 3, 7)),
        "GlobalMaxPool2D": (lambda: nn.GlobalMaxPool2D(), (2, 3, 5, 6)),
        "GlobalMaxPool3D": (lambda: nn.GlobalMaxPool3D(), (1, 2, 3, 4, 5)),
        "GlobalAvgPool1D": (lambda: nn.GlobalAvgPool1D(), (2, 3, 7)),
        "GlobalAvgPool3D": (lambda: nn.GlobalAvgPool3D(), (1, 2, 3, 4, 5)),
        "InstanceNorm": (lambda: nn.InstanceNorm(scale=True), (2, 3, 4, 5)),
        "GroupNorm": (lambda: nn.GroupNorm(2), (2, 4, 3, 3)),
        "Identity": (lambda: nn.Identity(), (3, 4)),
        "Lambda": (lambda: nn.Lambda("tanh"), (3, 4)),
        "HybridLambda": (lambda: nn.HybridLambda(
            lambda F, x: F.relu(x) * 2.0), (3, 4)),
        "Concatenate": (lambda: _concat(nn.Concatenate), (3, 5)),
        "HybridConcatenate": (lambda: _concat(nn.HybridConcatenate),
                              (3, 5)),
        "ReflectionPad2D": (lambda: nn.ReflectionPad2D(2), (2, 3, 5, 6)),
    }

    def _concat(cls):
        net = cls(axis=1)
        with net.name_scope():
            net.add(nn.Dense(4), nn.Activation("tanh"))
        return net

    rng = np.random.RandomState(4)

    def run(fn, inputs, ctx, params):
        arrays = [None if a is None else nd.array(a, ctx=ctx)
                  for a in inputs]
        for a in arrays:
            if a is not None:
                a.attach_grad()
        with autograd.record():
            out = fn(*arrays)
            total = (out * nd.array(np.linspace(-1, 1, out.size)
                                    .reshape(out.shape).astype("f4"),
                                    ctx=ctx)).sum()
        total.backward()
        return ([out.asnumpy()] + [a.grad.asnumpy() for a in arrays
                                   if a is not None]
                + [p.grad().asnumpy() for p in params
                   if p.grad_req != "null"])

    errs = {}
    for name, (make, shape) in layers.items():
        x = rng.randn(*shape).astype("f4")
        nets = {}
        for where, ctx in (("cpu", mx.cpu()), ("card", mx.gpu(0))):
            net = make()
            net.initialize(mx.init.Xavier(), ctx=ctx, seed=1)
            net(nd.array(x, ctx=ctx))
            nets[where] = net
        _copy_params(nets["cpu"], nets["card"])
        got, want = (run(nets[w], [x], c, list(
            nets[w].collect_params().values()))
            for w, c in (("card", mx.gpu(0)), ("cpu", mx.cpu())))
        errs[name] = max(_rel(g, w) for g, w in zip(got, want))
    b, k = 6, 5
    binary = (rng.rand(b, k) > 0.5).astype("f4")
    signed = binary * 2 - 1
    prob = rng.uniform(0.05, 0.95, (b, k)).astype("f4")
    dist = np.exp(rng.randn(b, k))
    dist = (dist / dist.sum(-1, keepdims=True)).astype("f4")
    x, y = rng.randn(b, k).astype("f4") * 2, rng.randn(b, k).astype("f4")
    sw = rng.uniform(0.5, 1.5, (b, 1)).astype("f4")
    pw = rng.uniform(0.5, 2.0, (k,)).astype("f4")
    losses = {
        "L2Loss": (L.L2Loss(), [x, y, sw]),
        "L1Loss": (L.L1Loss(weight=0.5), [x, y]),
        "SigmoidBCELoss": (L.SigmoidBCELoss(), [x, binary, sw]),
        "SigmoidBCELoss_pos_weight": (L.SigmoidBCELoss(),
                                      [x, binary, None, pw]),
        "SigmoidBCELoss_from_sigmoid": (
            L.SigmoidBCELoss(from_sigmoid=True), [prob, binary, None, pw]),
        "SoftmaxCELoss": (L.SoftmaxCELoss(),
                          [x, rng.randint(0, k, b).astype("f4")]),
        "SoftmaxCELoss_dense": (L.SoftmaxCELoss(sparse_label=False),
                                [x, dist, sw]),
        "KLDivLoss": (L.KLDivLoss(from_logits=False), [x, dist]),
        "HuberLoss": (L.HuberLoss(rho=0.5), [x, y]),
        "HingeLoss": (L.HingeLoss(), [x, signed]),
        "SquaredHingeLoss": (L.SquaredHingeLoss(), [x, signed]),
        "LogisticLoss": (L.LogisticLoss(), [x, signed]),
        "TripletLoss": (L.TripletLoss(), [x, y, y[::-1].copy()]),
        "CosineEmbeddingLoss": (L.CosineEmbeddingLoss(margin=0.1),
                                [x, y, signed[:, 0]]),
    }
    for name, (fn, inputs) in losses.items():
        got, want = (run(fn, inputs, c, [])
                     for c in (mx.gpu(0), mx.cpu()))
        errs[name] = max(_rel(g, w) for g, w in zip(got, want))
    over = {k: e for k, e in errs.items() if e > GAN_OP_TOL}
    check(not over, f"gan_parity: layers and losses on the card differ from "
          f"the CPU: {over}")
    return errs


def gan_cachedop_counts(n):
    """The CachedOps' counts over ``n`` iterations of the hybridized
    loop.  The generator's first call in an iteration (the D step's
    fake) replays without a backward (its output is detached); its
    G-step call finds that output alive and runs eagerly.  The
    discriminator's real-batch and G-step calls replay with their
    backward; its fake-batch call finds the real batch's backward
    pending and runs eagerly.  The first iteration warms each net up
    eagerly and captures at the next call."""
    return {"gen": {"captures": 1, "replays": n, "backward_replays": 1,
                    "calls": 2 * n},
            "disc": {"captures": 1, "replays": 2 * n,
                     "backward_replays": 2 * n, "calls": 3 * n}}


@contextlib.contextmanager
def _tf32_convolutions():
    """The port's convolutions with their TF32 guard bypassed, so that
    cuDNN's flag (PyTorch's default, on) applies: gan_parity's control
    run, which its weight rule must reject."""
    from mxnet_tpu_torch.ops import nn as ops_nn
    guard = ops_nn._ieee_f32
    ops_nn._ieee_f32 = contextlib.nullcontext
    try:
        yield
    finally:
        ops_nn._ieee_f32 = guard


def phase_gan_parity(mx, dev):
    """example/dcgan.py's nets at tiny widths (GAN_PARITY: ngf = ndf = 8,
    nz 16, batch 8, float32; cuDNN's TF32 flag left at PyTorch's
    default, which the convolutions turn off themselves) from the same
    Normal(0.02) weights: 3 alternating D/G Adam iterations (lr 2e-4,
    beta1 0.5, seeded numpy noise) on the card against the CPU: in
    float64 the same function (losses and every weight and moving
    statistic within 1e-10 relative); in float32 the D and G losses
    within 1e-4, and each weight and moving statistic within the larger
    of GAN_WEIGHT_TOL and 4x the CPU's own float32-against-float64
    distance in relative L2, the card's own float32-against-float64
    distance within the same limit; a control run with the convolutions
    in TF32 must break that rule; ``_gan_precision_probe``'s readings
    of where the card's float32 leaves float64 (reported).
    Deconvolution on the card against
    the CPU, forward and the three gradients, at the four generator
    shapes of the ``gan`` phase, a target_shape and an adj case, through
    cuDNN; every new layer and loss, forward and gradient, in one sweep;
    the same iterations with both nets hybridized on the card bit for
    bit the eager ones (cuDNN's deterministic algorithms), with the
    CachedOps' captures, replays, backward replays and eager calls
    exactly gan_cachedop_counts; no flash launch."""
    import torch
    cfg = GAN_PARITY
    free_earlier_phases()
    check(torch.backends.cudnn.allow_tf32,
          "gan_parity: cuDNN's TF32 flag is meant to stay at PyTorch's "
          "default (on) here")
    reset_counts()
    deconv = _gan_deconv_cases(mx, dev)
    sweep = _gan_layer_sweep(mx, dev)
    steps, b = cfg["steps"], cfg["batch_size"]
    rng = np.random.RandomState(0)
    reals = [_gan_images(rng, b) for _ in range(steps)]
    noise = np.random.RandomState(1).randn(steps, b, cfg["nz"], 1, 1) \
        .astype("f4")
    runs = {"cpu": (mx.cpu(), False), "cpu_f64": (mx.cpu(), False),
            "card": (mx.gpu(0), True), "card_eager": (mx.gpu(0), False),
            "card_f64": (mx.gpu(0), False), "card_tf32": (mx.gpu(0), False)}
    f64 = ("cpu_f64", "card_f64")
    nets, losses = {}, {}
    for where, (ctx, hyb) in runs.items():
        nets[where] = _gan_pair(mx, cfg, ctx, seed=11)
    for where in runs:
        if where != "cpu":
            for src, dst in zip(nets["cpu"], nets[where]):
                _copy_params(src, dst)
    for where in f64:
        for net in nets[where]:
            net.to(torch.float64)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        probe = _gan_precision_probe(mx, dev, cfg, reals, noise)
        for where, (ctx, hyb) in runs.items():
            gen, disc = nets[where]
            if hyb:
                gen.hybridize()
                disc.hybridize()
            it = _gan_loop(mx, gen, disc, cfg, ctx, reals, noise,
                           dtype="float64" if where in f64 else "float32")
            with _tf32_convolutions() if where == "card_tf32" \
                    else contextlib.nullcontext():
                out = [it() for _ in range(steps)]
            losses[where] = [[float(o[0].asnumpy()) for o in out],
                             [float(o[1].asnumpy()) for o in out]]
    finally:
        torch.backends.cudnn.deterministic = deterministic
    launches = read_counts()
    weights = {w: _gan_weights(*n) for w, n in nets.items()}
    loss_err = max(_rel(losses["card"][i], losses["cpu"][i])
                   for i in range(2))
    f64_loss_err = max(_rel(losses["card_f64"][i], losses["cpu_f64"][i])
                       for i in range(2))
    f64_errs = {k: _rel_l2([weights["card_f64"][k]], [w])
                for k, w in weights["cpu_f64"].items()}
    own = {where: {k: _rel_l2([weights[where][k]], [weights[ref][k]])
                   for k in weights[where]}
           for where, ref in (("cpu", "cpu_f64"), ("card", "card_f64"),
                              ("card_tf32", "card_f64"))}
    limit = {k: max(GAN_WEIGHT_TOL, 4 * own["cpu"][k])
             for k in weights["cpu"]}
    errs = {k: (_rel_l2([weights["card"][k]], [w]), limit[k])
            for k, w in weights["cpu"].items()}
    over = {k: e for k, e in errs.items() if e[0] > e[1]}
    own_over = {k: (e, limit[k]) for k, e in own["card"].items()
                if e > limit[k]}
    control = {k: _rel_l2([weights["card_tf32"][k]], [w])
               for k, w in weights["cpu"].items()}
    control_over = sorted(k for k, e in control.items() if e > limit[k])
    worst = max(errs, key=lambda k: errs[k][0] / errs[k][1])
    bitwise = losses["card"] == losses["card_eager"] and all(
        np.array_equal(weights["card"][k], weights["card_eager"][k])
        for k in weights["card"])
    ops = {n: nets["card"][i]._cached_op for i, n in enumerate(("gen",
                                                                 "disc"))}
    want = gan_cachedop_counts(steps)
    counted = {n: {"captures": op.captures, "replays": op.replays,
                   "backward_replays": op.backward_replays,
                   "calls": want[n]["calls"]} for n, op in ops.items()}
    row = {"phase": "gan_parity", **cfg,
           "d_losses": losses["card"][0], "g_losses": losses["card"][1],
           "cpu_d_losses": losses["cpu"][0], "cpu_g_losses": losses["cpu"][1],
           "loss_rel_err": loss_err, "loss_tol": GAN_LOSS_TOL,
           "weight_rel_l2_max": max(e for e, _ in errs.values()),
           "weight_tol": GAN_WEIGHT_TOL, "worst_tensor": [worst, *errs[worst]],
           "above_1e-5": {k: e for k, e in errs.items() if e[0] > 1e-5},
           "cpu_f32_vs_f64_loss_rel_err": max(
               _rel(losses["cpu"][i], losses["cpu_f64"][i])
               for i in range(2)),
           "f64_loss_rel_err": f64_loss_err,
           "f64_weight_rel_l2_max": max(f64_errs.values()),
           "f64_tol": GAN_F64_TOL,
           "f32_vs_f64_weight_rel_l2": {
               where: {k: own[where][k] for k in sorted(
                   own[where], key=lambda k: -own[where][k])[:4]}
               for where in own},
           "tf32_control": {
               "loss_rel_err": max(_rel(losses["card_tf32"][i],
                                        losses["cpu"][i]) for i in range(2)),
               "weight_rel_l2_max": max(control.values()),
               "tensors_over_limit": len(control_over),
               "of": len(control)},
           "f32_vs_f64_first_iteration": probe,
           "hybridized_equals_eager_bitwise": bitwise,
           "cachedop": {n: dict(c, eager_calls=c["calls"] - c["replays"],
                                entries=len(ops[n]))
                        for n, c in counted.items()},
           "deconvolution": deconv, "layer_and_loss_rel_err": sweep,
           "launches": launches}
    emit(row)
    check(f64_loss_err <= GAN_F64_TOL
          and max(f64_errs.values()) <= GAN_F64_TOL,
          f"gan_parity: in float64 the card's losses differ from the CPU's "
          f"by {f64_loss_err} and its weights by "
          f"{max(f64_errs.values())}")
    check(loss_err <= GAN_LOSS_TOL and not over and not own_over,
          f"gan_parity: losses {loss_err}, weights above their limits "
          f"{over}, the card's own float32-vs-float64 distances above "
          f"them {own_over}")
    check(control_over, "gan_parity: the TF32 control run passed the "
          "weight rule, which then cannot tell TF32 from float32: "
          f"{row['tf32_control']}")
    check(bitwise, f"gan_parity: the hybridized loop is not bit for bit "
          f"the eager one: {losses['card']} against {losses['card_eager']}")
    check(counted == want, f"gan_parity: the CachedOps counted {counted}, "
          f"want {want}")
    check(not any(launches.values()),
          f"gan_parity: flash launches {launches}")
    return row


def _gan_flops(gen, disc, z, real):
    """Forward FLOPs (2 a multiply-add) of one generator call on ``z``
    and one discriminator call on ``real``, from the shapes their
    convolutions see: a convolution's output elements times its
    weight's per-filter size, a transposed convolution's input elements
    times its weight's per-input-channel size."""
    from mxnet_tpu_torch.gluon.nn.conv_layers import _Conv, _ConvTranspose
    total = {}

    def hook(kind):
        def fn(mod, inputs, out):
            w = mod.weight
            n = out.numel() * w[0].numel() if kind == "disc" else \
                inputs[0].numel() * w[0].numel()
            total[kind] = total.get(kind, 0) + 2 * n
        return fn
    hooks = [m.register_forward_hook(hook("gen")) for m in gen.modules()
             if isinstance(m, _ConvTranspose)]
    hooks += [m.register_forward_hook(hook("disc")) for m in disc.modules()
              if isinstance(m, _Conv)]
    try:
        gen(z)
        disc(real)
    finally:
        for h in hooks:
            h.remove()
    return total["gen"], total["disc"]


def _gan_split(per_kernel):
    """A profiled iteration's device time by kind (ms): cuDNN's
    convolution kernels by what they compute (fprop: the discriminator's
    forward and the generator's data gradient; dgrad: the generator's
    transposed forward and the discriminator's data gradient; wgrad: both
    nets' weight gradients; their layout transforms apart), BatchNorm,
    Adam (the multi-tensor kernels) and the rest."""
    split = {"fprop": 0.0, "dgrad": 0.0, "wgrad": 0.0, "conv_other": 0.0,
             "batchnorm": 0.0, "adam": 0.0, "other": 0.0}
    for k, t in per_kernel.items():
        name = k.lower()
        if "batch_norm" in name or "batchnorm" in name or "bn_" in name:
            split["batchnorm"] += t
        elif "multi_tensor_apply" in name:
            split["adam"] += t
        elif "dgrad" in name:
            split["dgrad"] += t
        elif "wgrad" in name:
            split["wgrad"] += t
        elif "fprop" in name:
            split["fprop"] += t
        elif any(c in name for c in CONV_KERNELS):
            split["conv_other"] += t
        else:
            split["other"] += t
    total = sum(per_kernel.values())
    out = {"device_ms": total, **{f"{k}_ms": v for k, v in split.items()}}
    out["conv_transpose_dgrad_wgrad_ms"] = split["dgrad"] + split["wgrad"]
    out["shares"] = {k: v / total for k, v in split.items()}
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:10]
    out["top_kernels"] = [[k[:100], t] for k, t in top]
    return out


def phase_gan(mx, dev, cfg=GAN):
    """example/dcgan.py's GAN at DCGAN's published widths (GAN: nz 100,
    ngf = ndf = 64, batch 128, Adam lr 2e-4 beta1 0.5, float32, seeded
    synthetic blob images made up front, z drawn on the card): the
    example's iteration (a D step and a G step), eager as the example
    runs it and with both nets hybridized, each timed by the two-window
    slope (5 and 20 iterations after 3 warm-ups): ms an iteration,
    images/s, FLOPs from the layers' own shapes against the float32
    peak; a profiled iteration split into cuDNN's fprop, dgrad and wgrad
    kernels, BatchNorm, Adam and other (``kernel_split_ms``), beside the
    iteration's device time from CUDA events with the host held back
    (``queued_ms``); the busy share, peak memory, the CachedOps' pools;
    the captures, replays and backward replays of the timed windows
    exactly those of a warm loop; both losses finite, D's accuracy after
    the windows (reported), no flash launch."""
    import torch
    free_earlier_phases()
    b, n1, n2 = cfg["batch_size"], *cfg["windows"]
    rng = np.random.RandomState(0)
    reals = [_gan_images(rng, b) for _ in range(cfg["batches"])]
    out = {}
    for mode in ("eager", "hybridized"):
        free_earlier_phases()
        mx.random.seed(0)
        gen, disc = _gan_pair(mx, cfg, mx.gpu(0), seed=0)
        n_params = {n: sum(p.data().size for p in net.collect_params()
                           .values() if p.grad_req != "null")
                    for n, net in (("gen", gen), ("disc", disc))}
        g_flops, d_flops = _gan_flops(
            gen, disc, mx.nd.zeros((b, cfg["nz"], 1, 1), ctx=mx.gpu(0)),
            mx.nd.array(reals[0], ctx=mx.gpu(0)))
        if mode == "hybridized":
            gen.hybridize()
            disc.hybridize()
        # an iteration: D forward on real and fake, G forward; D backward
        # twice (data and weight gradients, 2 forwards' worth each); G
        # forward, D forward, D backward and G backward in the G step
        it_flops = 4 * g_flops + 9 * d_flops
        iteration = _gan_loop(mx, gen, disc, cfg, mx.gpu(0), reals)
        first = None
        for _ in range(cfg["warmup"]):
            res = iteration()
            first = first or [float(res[0].asnumpy()),
                              float(res[1].asnumpy())]
        ops = {"gen": gen._cached_op, "disc": disc._cached_op} \
            if mode == "hybridized" else {}
        before = {n: (op.captures, op.replays, op.backward_replays)
                  for n, op in ops.items()}
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        reset_counts()
        it_s, naive_s, windows, used, g_last = timed_windows(
            iteration, n1, n2, f"gan {mode}",
            read=lambda r: float(r[1].asnumpy()))
        launches = read_counts()
        peak = torch.cuda.max_memory_allocated(dev)
        reserved = torch.cuda.max_memory_reserved(dev)
        counted = {n: [a - b_ for a, b_ in zip(
            (op.captures, op.replays, op.backward_replays), before[n])]
            for n, op in ops.items()}
        last = iteration()
        d_last = float(last[0].asnumpy())
        d_acc = _d_accuracy(last[2], last[3])
        per_kernel, lost, taken = kernel_split_ms(iteration, reps=5)
        split = _gan_split(per_kernel)
        split["profiler_lost_events"] = lost
        split["profiler_windows_taken"] = taken
        # two iterations at most: an eager one is ~400 launches, and a
        # third would fill the launch queue behind the spin
        split["queued_ms"] = statistics.median(
            queued_ms(iteration, reps=2, warmup=1) for _ in range(3))
        walls = []
        for _ in range(5):
            t1 = time.perf_counter()
            iteration()
            torch.cuda.synchronize(dev)
            walls.append((time.perf_counter() - t1) * 1e3)
        split["wall_ms"] = statistics.median(walls)
        split["device_busy_share"] = split["device_ms"] / split["wall_ms"]
        split["device_over_queued"] = split["device_ms"] / split["queued_ms"]
        bound_ms = it_flops / PEAK_FLOPS["float32"] * 1e3
        row = {"phase": "gan", "mode": mode, "model": "dcgan (example)",
               **{k: cfg[k] for k in ("nz", "ngf", "ndf", "nc", "lr",
                                      "beta1")},
               "batch_size": b, "image_size": 32, "dtype": "float32",
               "params": n_params, "warmup": cfg["warmup"],
               "windows": [n1, n2], "window_s": windows,
               "iteration_ms": it_s * 1e3, "naive_iteration_ms":
                   naive_s * 1e3, "timing": used,
               "images_per_s": b / it_s,
               "gen_forward_flops_per_image": g_flops / b,
               "disc_forward_flops_per_image": d_flops / b,
               "iteration_flops": it_flops,
               "f32_bound_ms": bound_ms,
               "achieved_tflops": it_flops / it_s / 1e12,
               "first_losses": first, "last_d_loss": d_last,
               "last_g_loss": g_last, "d_accuracy_after": d_acc,
               "peak_mem_bytes": peak, "peak_reserved_bytes": reserved,
               "cachedop": {n: {"entries": len(op), "captures":
                                op.captures, "pool_bytes": op.pool_bytes}
                            for n, op in ops.items()},
               "graph_pool_bytes": sum(op.pool_bytes for op in ops.values()),
               "captures_replays_backward_in_windows": counted,
               "iterations_counted": n1 + n2, "launches": launches,
               "card": nvidia_smi()}
        emit(row)
        emit(dict({"phase": "gan_breakdown", "mode": mode,
                   "call": "one iteration (a D step and a G step)"},
                  **split))
        check(math.isfinite(d_last) and math.isfinite(g_last),
              f"gan {mode}: losses {d_last}, {g_last}")
        check(not any(launches.values()),
              f"gan {mode}: flash launches {launches}")
        if ops:
            # warm: each iteration one generator replay without a
            # backward, two discriminator replays with theirs
            want = {"gen": [0, n1 + n2, 0],
                    "disc": [0, 2 * (n1 + n2), 2 * (n1 + n2)]}
            check(counted == want,
                  f"gan {mode}: captures, replays and backward replays in "
                  f"the timed windows {counted}, want {want}")
        out[mode] = row
    return out


# -- phases 21-23: the word-level LM, data and the Estimator -------------------

# Zaremba, Sutskever & Vinyals 2014, "Recurrent Neural Network
# Regularization", section 4, the medium model: vocabulary 10,000, 2 LSTM
# layers of 650 units, embedding 650, unrolled 35 steps, batch 20,
# dropout 0.5, gradient norm clipped at 5; PTB's training length; the loop
# is example/word_lm.py's (untied dense decoder, Adam at 3e-3)
WORDLM = dict(vocab=10000, embed=650, hidden=650, layers=2, batch_size=20,
              seq_len=35, dropout=0.5, clip=5.0, lr=3e-3, corpus=929589,
              warmup=3, windows=(5, 20), params=19780400)
# the parity runs: example/word_lm.py's defaults, dropout 0
WORDLM_PARITY = dict(vocab=64, embed=32, hidden=64, layers=1, batch_size=8,
                     seq_len=16, dropout=0.0, corpus=2000, steps=3)
WORDLM_OPTIMIZERS = {"adam": ("adam", {"learning_rate": 3e-3, "wd": 1e-4}),
                     "sgd_momentum": ("sgd", {"learning_rate": 0.5,
                                              "momentum": 0.9, "wd": 1e-4})}
WORDLM_LOSS_TOL = 1e-4
WORDLM_WEIGHT_TOL = 1e-5
# the captured lazy-Adam steps against the eager loop, on the card
WORDLM_CAPTURE_TOL = 1e-6


def word_lm_corpus(vocab, length, seed=0):
    """example/word_lm.py's law, drawn vectorized from ``seed``: Zipf
    unigrams, and token t followed by (3t + 1) mod vocab with probability
    0.8.  A token that follows k steps after the last fresh draw t0 is
    3^k t0 + (3^k - 1) / 2 mod vocab."""
    rng = np.random.RandomState(seed)
    probs = 1.0 / np.arange(1, vocab + 1)
    probs /= probs.sum()
    follow = rng.rand(length) < 0.8
    fresh = rng.choice(vocab, length, p=probs)
    follow[0], fresh[0] = False, 1
    pos = np.arange(length)
    start = np.maximum.accumulate(np.where(follow, 0, pos))
    k = pos - start
    pow3 = np.ones(k.max() + 1, np.int64)
    geo = np.zeros(k.max() + 1, np.int64)
    for i in range(1, k.max() + 1):
        pow3[i] = pow3[i - 1] * 3 % vocab
        geo[i] = (geo[i - 1] * 3 + 1) % vocab
    return (pow3[k] * fresh[start] + geo[k]) % vocab


def word_lm_batches(corpus, batch_size, seq_len):
    """example/word_lm.py's batchify, cycling over the corpus: (data,
    target) float32 segments of (batch, seq_len)."""
    n = (len(corpus) - 1) // (batch_size * seq_len)
    usable = n * batch_size * seq_len
    data = corpus[:usable].reshape(batch_size, -1).astype("f4")
    target = corpus[1:usable + 1].reshape(batch_size, -1).astype("f4")
    while True:
        for i in range(n):
            s = i * seq_len
            yield data[:, s:s + seq_len], target[:, s:s + seq_len]


def word_lm_model(mx, cfg, ctx, seed):
    """example/word_lm.py's RNNModel ("lstm": Embedding(sparse_grad=True)
    -> LSTM (NTC) -> Dropout -> untied Dense decoder) at ``cfg``, Xavier
    from ``seed`` on ``ctx``, called once (the LSTM's deferred width)."""
    import torch
    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch.gluon import nn, rnn

    class RNNModel(gluon.HybridBlock):
        def __init__(self, **kwargs):
            super().__init__(**kwargs)
            with self.name_scope():
                self.embed = nn.Embedding(cfg["vocab"], cfg["embed"],
                                          sparse_grad=True)
                self.rnn = rnn.LSTM(cfg["hidden"], num_layers=cfg["layers"],
                                    layout="NTC", dropout=cfg["dropout"])
                self.drop = nn.Dropout(cfg["dropout"])
                self.decoder = nn.Dense(cfg["vocab"], flatten=False,
                                        in_units=cfg["hidden"])

        def hybrid_forward(self, F, tokens, state):
            out, state = self.rnn(self.embed(tokens), state)
            return self.decoder(self.drop(out)), state

    net = RNNModel(prefix="rnnmodel_")
    net.initialize(mx.init.Xavier(), ctx=ctx, seed=seed)
    net(mx.nd.zeros((cfg["batch_size"], cfg["seq_len"]), ctx=ctx),
        net.rnn.begin_state(batch_size=cfg["batch_size"], ctx=ctx))
    return net


def word_lm_loop(mx, net, cfg, corpus, ctx, optimizer, params, clip=None,
                 hybridize=True, dtype="float32"):
    """example/word_lm.py's step as a function: a segment as NDArrays,
    the hidden state detached, record -> net -> mean softmax CE ->
    backward -> (``clip_global_norm`` of the gradients at ``clip``) ->
    ``trainer.step(1)``.  Returns (trainer, step, the tokens of the last
    step); a step returns its loss (not synchronised)."""
    from mxnet_tpu_torch import autograd, gluon, nd
    net.hybridize(hybridize)
    tr = gluon.Trainer(net.collect_params(), optimizer, dict(params))
    sce = gluon.loss.SoftmaxCrossEntropyLoss()
    batches = word_lm_batches(corpus, cfg["batch_size"], cfg["seq_len"])
    state = [[nd.array(s.asnumpy(), ctx=ctx, dtype=dtype) for s in
              net.rnn.begin_state(batch_size=cfg["batch_size"], ctx=ctx)]]
    grads = [p for p in net.collect_params().values()
             if p.grad_req != "null"]
    last = [None]

    def step():
        data, target = next(batches)
        last[0] = data
        x = nd.array(data, ctx=ctx, dtype=dtype)
        y = nd.array(target.reshape(-1), ctx=ctx, dtype=dtype)
        st = [s.detach() for s in state[0]]
        with autograd.record():
            out, st = net(x, st)
            loss = nd.mean(sce(out.reshape((-1, cfg["vocab"])), y))
        loss.backward()
        if clip is not None:
            gluon.utils.clip_global_norm([p.grad() for p in grads], clip)
        tr.step(1)
        state[0] = st
        return loss
    return tr, step, last


@contextlib.contextmanager
def _tf32_everywhere():
    """TF32 in every float32 product: the matmul and cuDNN flags on and
    the port's guards (convolutions, the recurrence) bypassed.
    wordlm_parity's control run, which its weight rule must reject."""
    import torch
    from mxnet_tpu_torch.ops import nn as ops_nn
    from mxnet_tpu_torch.ops import rnn as ops_rnn
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32, ops_nn._ieee_f32,
             ops_rnn._ieee_f32)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    ops_nn._ieee_f32 = ops_rnn._ieee_f32 = contextlib.nullcontext
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32, ops_nn._ieee_f32,
         ops_rnn._ieee_f32) = saved


def _optimizer_states(tr):
    """{name: [state arrays]} of a gluon Trainer."""
    out = {}
    for i, p in enumerate(tr._params):
        st = tr._updater.states.get(i)
        st = () if st is None else (st if isinstance(st, tuple) else (st,))
        out[p.name] = [s.asnumpy() for s in st]
    return out


def phase_wordlm_parity(mx, dev):
    """example/word_lm.py's RNNModel at its defaults (WORDLM_PARITY: vocab
    64, embed 32, hidden 64, 1 layer, dropout 0, sparse_grad=True) from
    the same Xavier weights: 3 lazy-Adam and 3 lazy-SGD-momentum steps
    (weight decay on) on the card against the CPU: losses within 1e-4,
    each weight within the larger of 1e-5 and 4x the CPU's own
    float32-against-float64 distance in relative L2; the embedding rows
    no step touched bit for bit their start on the card, their optimizer
    states exactly 0; hybridized bit for bit eager; a TF32 run (Adam)
    that the weight rule must reject; no flash kernel."""
    import torch
    cfg = WORDLM_PARITY
    free_earlier_phases()
    corpus = word_lm_corpus(cfg["vocab"], cfg["corpus"], seed=1)
    segments = word_lm_batches(corpus, cfg["batch_size"], cfg["seq_len"])
    touched = {int(t) for _ in range(cfg["steps"])
               for t in next(segments)[0].ravel()}
    emb_name = "rnnmodel_embedding0_weight"
    rows = []
    for name, (optimizer, params) in WORDLM_OPTIMIZERS.items():
        runs = {"cpu": (mx.cpu(), True, "float32"),
                "cpu_f64": (mx.cpu(), True, "float64"),
                "card": (mx.gpu(0), True, "float32"),
                "card_eager": (mx.gpu(0), False, "float32")}
        if name == "adam":
            runs["card_tf32"] = (mx.gpu(0), True, "float32")
        start = word_lm_model(mx, cfg, mx.cpu(), seed=7)
        w0 = _weights(start)
        losses, weights, states, nets = {}, {}, {}, {}
        reset_counts()
        for where, (ctx, hyb, dtype) in runs.items():
            net = word_lm_model(mx, cfg, ctx, seed=7)
            _copy_params(start, net)
            if dtype != "float32":
                net.to(getattr(torch, dtype))
            tr, step, _ = word_lm_loop(mx, net, cfg, corpus, ctx, optimizer,
                                       params, hybridize=hyb, dtype=dtype)
            with _tf32_everywhere() if where == "card_tf32" \
                    else contextlib.nullcontext():
                losses[where] = [float(step().asnumpy())
                                 for _ in range(cfg["steps"])]
            weights[where] = _weights(net)
            states[where] = _optimizer_states(tr)
            nets[where] = net
        launches = read_counts()
        f64 = {k: v.astype("f4") for k, v in weights["cpu_f64"].items()}
        limits = {k: max(WORDLM_WEIGHT_TOL, 4 * _rel_l2([w], [f64[k]]))
                  for k, w in weights["cpu"].items()}
        errs = {k: _rel_l2([weights["card"][k]], [w])
                for k, w in weights["cpu"].items()}
        over = {k: [e, limits[k]] for k, e in errs.items() if e > limits[k]}
        loss_err = _rel(losses["card"], losses["cpu"])
        untouched = sorted(set(range(cfg["vocab"])) - touched)
        emb_same = bool(np.array_equal(weights["card"][emb_name][untouched],
                                       w0[emb_name][untouched]))
        state_zero = all(not np.any(s[untouched])
                         for s in states["card"][emb_name])
        bitwise = losses["card"] == losses["card_eager"] and all(
            np.array_equal(weights["card"][k], weights["card_eager"][k])
            for k in weights["card"])
        row = {"phase": "wordlm_parity", "optimizer": name, **cfg,
               "params": dict(params), "losses": losses["card"],
               "cpu_losses": losses["cpu"], "loss_rel_err": loss_err,
               "loss_tol": WORDLM_LOSS_TOL,
               "weight_rel_l2": errs, "weight_limits": limits,
               "over_limit": over,
               "cpu_f32_vs_f64_loss_rel_err": _rel(losses["cpu"],
                                                   losses["cpu_f64"]),
               "untouched_rows": len(untouched),
               "untouched_rows_bitwise_start": emb_same,
               "untouched_rows_state_zero": state_zero,
               "embedding_states": len(states["card"][emb_name]),
               "hybridized_equals_eager_bitwise": bitwise,
               "launches": launches}
        if "card_tf32" in weights:
            control = {k: _rel_l2([weights["card_tf32"][k]], [w])
                       for k, w in weights["cpu"].items()}
            row["tf32_control"] = {
                "loss_rel_err": _rel(losses["card_tf32"], losses["cpu"]),
                "weight_rel_l2_max": max(control.values()),
                "over_limit": sorted(k for k, e in control.items()
                                     if e > limits[k])}
        emit(row)
        rows.append(row)
        check(loss_err <= WORDLM_LOSS_TOL and not over,
              f"wordlm_parity {name}: losses {loss_err}, weights over their "
              f"limits {over}")
        check(untouched and emb_same and state_zero
              and len(states["card"][emb_name]) >= 1,
              f"wordlm_parity {name}: {len(untouched)} untouched rows, "
              f"bitwise their start {emb_same}, states zero {state_zero}")
        check(bitwise, f"wordlm_parity {name}: hybridized {losses['card']} "
              f"is not bit for bit eager {losses['card_eager']}")
        check(not any(launches.values()),
              f"wordlm_parity {name}: flash launches {launches}")
        if "tf32_control" in row:
            check(row["tf32_control"]["over_limit"],
                  f"wordlm_parity: the TF32 control passed the weight rule "
                  f"{row['tf32_control']}: the rule cannot tell TF32 from "
                  "float32")
    captures, replays, rates, eager_rates, err = _wordlm_captured(
        mx, cfg, corpus, start)
    row = {"phase": "wordlm_parity", "optimizer": "adam",
           "call": "compile_step, FactorScheduler(step=2)",
           "captures": captures, "replays": replays, "rates": rates,
           "eager_rates": eager_rates, "weight_rel_l2_to_eager": err}
    emit(row)
    rows.append(row)
    check(captures == 1 and replays == len(rates) - 1
          and rates == eager_rates and len(set(rates)) > 1
          and err <= WORDLM_CAPTURE_TOL,
          f"wordlm_parity: the captured lazy step {row}")
    check_no_fallback("wordlm_parity")
    return rows


def _wordlm_captured(mx, cfg, corpus, start, steps=6):
    """The tiny model's step (zero initial states, lazy Adam with a
    FactorScheduler halving the rate every 2 updates) through
    ``trainer.compile_step`` on the card, against the eager gluon loop
    on the card from the same weights: (captures, replays, the captured
    rates, the eager rates, the largest relative L2 distance between the
    two runs' weights).  Each step looks up other rows."""
    from mxnet_tpu_torch import autograd, gluon, nd
    gpu = mx.gpu(0)
    segments = word_lm_batches(corpus, cfg["batch_size"], cfg["seq_len"])
    data = [next(segments) for _ in range(steps)]
    runs = {}
    for kind in ("captured", "eager"):
        lm = word_lm_model(mx, cfg, gpu, seed=7)
        _copy_params(start, lm)
        zeros = [s.asnumpy() for s in lm.rnn.begin_state(
            batch_size=cfg["batch_size"], ctx=gpu)]

        class Step(gluon.HybridBlock):
            """The model on (tokens, h, c): its logits, (B * T, V)."""

            def __init__(self):
                super().__init__(prefix="")
                self.lm = lm

            def hybrid_forward(self, F, x, h, c):
                return self.lm(x, [h, c])[0].reshape((-1, cfg["vocab"]))
        net = Step()
        sched = mx.lr_scheduler.FactorScheduler(step=2, factor=0.5)
        tr = gluon.Trainer(net.collect_params(), "adam",
                           {"learning_rate": 3e-3, "wd": 1e-4,
                            "lr_scheduler": sched})
        sce = gluon.loss.SoftmaxCrossEntropyLoss()
        cs = tr.compile_step(net, sce) if kind == "captured" else None
        rates = []
        for x_np, y_np in data:
            args = [nd.array(a, ctx=gpu) for a in (x_np, *zeros)]
            y = nd.array(y_np.reshape(-1), ctx=gpu)
            if cs is not None:
                cs.step(args, y, batch_size=1)
            else:
                with autograd.record():
                    loss = sce(net(*args), y)
                loss.backward()
                tr.step(1)
            rates.append(tr.learning_rate)
        runs[kind] = (cs, rates, _weights(lm))
    cs = runs["captured"][0]
    err = max(_rel_l2([runs["captured"][2][k]], [w])
              for k, w in runs["eager"][2].items())
    return cs.captures, cs.replays, runs["captured"][1], \
        runs["eager"][1], err


def _wordlm_split(per_kernel, lazy_ms, clip_ms, decoder_ms):
    """A profiled step's device time by kind (ms): cuDNN's LSTM pointwise
    kernels, GEMMs (the decoder's three products, measured alone on the
    step's shapes: ``decoder_ms``; the rest are cuDNN's recurrence
    products), softmax and cross-entropy, dense Adam (the multi-tensor
    kernels), lazy Adam and the clip (each measured alone on the step's
    tensors: ``lazy_ms``, ``clip_ms``) and the rest."""
    total = sum(per_kernel.values())

    def kind(k):
        low = k.lower()
        if any(n in low for n in ("rnn", "lstm", "generic_elementwise")):
            return "rnn"
        if _is_gemm(k):
            return "gemm"
        if "softmax" in low or "nll" in low:
            return "softmax_ce"
        if "multi_tensor_apply" in k:
            return "adam_dense"
        return "other"
    split = dict.fromkeys(("rnn_ms", "gemm_ms", "softmax_ce_ms",
                           "adam_dense_ms", "other_ms"), 0.0)
    for k, t in per_kernel.items():
        split[kind(k) + "_ms"] += t
    split["device_ms"] = total
    split["adam_lazy_ms"] = lazy_ms
    split["clip_ms"] = clip_ms
    split["other_ms"] -= lazy_ms + clip_ms
    split["gemm_decoder_ms"] = decoder_ms
    split["gemm_recurrence_ms"] = split.pop("gemm_ms") - decoder_ms
    split["shares"] = {k[:-3]: v / total for k, v in split.items()
                       if k.endswith("_ms") and k != "device_ms"}
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:10]
    split["top_kernels"] = [[k[:100], t] for k, t in top]
    return split


def _wordlm_alone(mx, net, tr, cfg):
    """(lazy Adam on the embedding, the clip over every gradient, the
    decoder's forward and two gradient products), each alone on the
    step's tensors: device ms from CUDA events (``queued_ms``; the
    profiler loses events after many profiled phases in one process)."""
    import torch
    from mxnet_tpu_torch import gluon
    opt = tr.optimizer
    names = [p.name for p in tr._params]
    i = names.index("rnnmodel_embedding0_weight")
    emb, state = tr._params[i], tr._updater.states[i]
    scalars = opt.stage(emb.data().tensor.device)
    lazy_ms = queued_ms(lambda: opt._apply_lazy(
        emb.data().tensor, emb.grad().tensor,
        (state[0].tensor, state[1].tensor), scalars, (1.0, 1.0)), reps=10)
    grads = [p.grad() for p in tr._params if p.grad_req != "null"]
    clip_ms = queued_ms(lambda: gluon.utils.clip_global_norm(
        grads, 1e30, check_isfinite=False), reps=10)
    w = net.collect_params()["rnnmodel_dense0_weight"].data().tensor
    g = torch.Generator(device=w.device)
    g.manual_seed(4)
    tokens = cfg["batch_size"] * cfg["seq_len"]
    h = torch.randn(tokens, cfg["hidden"], generator=g, device=w.device)
    dy = torch.randn(tokens, cfg["vocab"], generator=g, device=w.device)

    def decoder():
        torch.mm(h, w.t())
        torch.mm(dy, w)
        torch.mm(dy.t(), h)
    return lazy_ms, clip_ms, queued_ms(decoder, reps=10)


def _wordlm_flops(cfg):
    """A step's FLOPs from the shapes: the LSTM layers' gate products
    (input and recurrent) and the decoder, forward and twice that
    backward."""
    t = cfg["batch_size"] * cfg["seq_len"]
    h, e, v = cfg["hidden"], cfg["embed"], cfg["vocab"]
    lstm = sum(2 * 4 * h * ((e if i == 0 else h) + h)
               for i in range(cfg["layers"]))
    return 3 * t * (lstm + 2 * h * v)


def phase_wordlm(mx, dev, cfg=WORDLM):
    """The word-level LM at the medium width of Zaremba et al. 2014
    (WORDLM: V 10,000, 2 x 650 LSTM, embedding 650, b20 x 35, dropout 0.5,
    clip 5, Adam 3e-3, sparse_grad=True: lazy Adam on the embedding),
    example/word_lm.py's loop over a seeded Zipf-bigram corpus of PTB's
    training length, eager, hybridized and eager again: the two-window
    slope (5 and 20
    steps after 3 warm-ups), tokens/s, FLOPs against the float32 peak,
    peak memory, a profiled step split into the recurrence, GEMM, softmax
    and CE, dense Adam, lazy Adam, the clip and other, the busy share;
    perplexity falling; the embedding rows the last step did not touch
    bit for bit unchanged by it; no flash launch."""
    import torch
    free_earlier_phases()
    corpus = word_lm_corpus(cfg["vocab"], cfg["corpus"], seed=0)
    n1, n2 = cfg["windows"]
    optimizer = ("adam", {"learning_rate": cfg["lr"]})
    flops = _wordlm_flops(cfg)
    out = {}
    alone = None
    # eager again last: whether the second mode's host time is its own
    # or the process's after a profiled window
    for mode in ("eager", "hybridized", "eager_again"):
        free_earlier_phases()
        mx.random.seed(0)
        net = word_lm_model(mx, cfg, mx.gpu(0), seed=0)
        n_params = sum(p.data().size for p in net.collect_params().values())
        check(n_params == cfg["params"], f"wordlm: {n_params} parameters, "
              f"want {cfg['params']}")
        tr, step, last = word_lm_loop(mx, net, cfg, corpus, mx.gpu(0),
                                      *optimizer, clip=cfg["clip"],
                                      hybridize=mode == "hybridized")
        first = None
        for _ in range(cfg["warmup"]):
            loss = step()
            first = last_loss(loss) if first is None else first
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        reset_counts()
        step_s, naive_s, windows, used, last_l = timed_windows(
            step, n1, n2, f"wordlm {mode}")
        launches = read_counts()
        peak = torch.cuda.max_memory_allocated(dev)
        # the last step's untouched rows: bit for bit unchanged by it
        emb = net.collect_params()["rnnmodel_embedding0_weight"]
        before = emb.data().asnumpy()
        step()
        torch.cuda.synchronize(dev)
        after = emb.data().asnumpy()
        hit = set(last[0].astype(np.int64).ravel().tolist())
        untouched = sorted(set(range(cfg["vocab"])) - hit)
        same = bool(np.array_equal(after[untouched], before[untouched]))
        moved = int(np.any(after[sorted(hit)] != before[sorted(hit)],
                           axis=1).sum())
        per_kernel, lost, taken = kernel_split_ms(step, reps=5)
        if alone is None:      # the same tensors in every mode
            alone = _wordlm_alone(mx, net, tr, cfg)
        split = _wordlm_split(per_kernel, *alone)
        walls = []
        for _ in range(5):
            t1 = time.perf_counter()
            step()
            torch.cuda.synchronize(dev)
            walls.append((time.perf_counter() - t1) * 1e3)
        split["wall_ms"] = statistics.median(walls)
        split["device_busy_share"] = split["device_ms"] / split["wall_ms"]
        split["profile_events_lost"], split["profile_windows"] = lost, taken
        tokens = cfg["batch_size"] * cfg["seq_len"]
        row = {"phase": "wordlm", "mode": mode, **cfg,
               "optimizer": "adam (lazy on the embedding)",
               "params_counted": n_params, "warmup": cfg["warmup"],
               "window_s": windows, "step_ms": step_s * 1e3,
               "naive_step_ms": naive_s * 1e3, "timing": used,
               "tokens_per_s": tokens / step_s,
               "flops_per_step": flops,
               "tflops_per_s": flops / step_s / 1e12,
               "f32_bound_ms": flops / PEAK_FLOPS["float32"] * 1e3,
               "first_loss": first, "last_loss": last_l,
               "first_perplexity": math.exp(min(first, 20.0)),
               "last_perplexity": math.exp(min(last_l, 20.0)),
               "peak_mem_bytes": peak,
               "peak_over_start_bytes": peak - base,
               "last_step_untouched_rows": len(untouched),
               "untouched_rows_unchanged": same,
               "last_step_touched_rows": len(hit),
               "touched_rows_moved": moved,
               "launches": launches, "card": nvidia_smi()}
        emit(row)
        emit(dict({"phase": "wordlm_breakdown", "mode": mode,
                   "call": "one training step (profiled)"}, **split))
        check(math.isfinite(last_l) and last_l < first,
              f"wordlm {mode}: the loss went from {first} to {last_l}")
        check(untouched and same and moved > 0,
              f"wordlm {mode}: {len(untouched)} rows the last step did not "
              f"touch, unchanged {same}; touched rows moved {moved} of "
              f"{len(hit)}")
        check(not any(launches.values()),
              f"wordlm {mode}: flash launches {launches}")
        out[mode] = row
    return out


# example/train_mnist.py --synthetic and example/estimator_fit.py
# --synthetic at their own sizes
DATA = dict(train=2048, val=512, batch_size=128, workers=2,
            widths=(784, 128, 64, 10), lr=0.1, sched_step=4,
            sched_factor=0.5, capture_steps=12, est_epochs=3)


def _mnist_net(mx, ctx, seed, prefix="mlp_"):
    """example/train_mnist.py's build_net: Dense 128 relu, 64 relu, 10,
    hybridized, Xavier from ``seed``."""
    from mxnet_tpu_torch.gluon import nn
    w = DATA["widths"]
    net = nn.HybridSequential(prefix=prefix)
    with net.name_scope():
        net.add(nn.Dense(w[1], activation="relu", in_units=w[0]),
                nn.Dense(w[2], activation="relu", in_units=w[1]),
                nn.Dense(w[3], in_units=w[2]))
    net.initialize(mx.init.Xavier(), ctx=ctx, seed=seed)
    net.hybridize()
    return net


def _mnist_loaders(mx, prefetch=None):
    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch.gluon.data.vision import MNIST, transforms
    to_tensor = transforms.ToTensor()
    train = MNIST(train=True, synthetic=DATA["train"]).transform_first(
        to_tensor)
    val = MNIST(train=False, synthetic=DATA["val"]).transform_first(
        to_tensor)
    kw = {"num_workers": DATA["workers"], "prefetch_to_device": prefetch}
    return (gluon.data.DataLoader(train, DATA["batch_size"], shuffle=True,
                                  **kw),
            gluon.data.DataLoader(val, DATA["batch_size"], **kw))


def _loader_pass(loader, ctx_scope, seed=0):
    """One seeded pass: the batches (as given) and their host copies."""
    np.random.seed(seed)
    with ctx_scope:
        batches = list(loader)
    return batches, [[b.asnumpy() for b in batch] for batch in batches]


def _mnist_epoch(mx, net, trainer, loader, metric, ctx):
    """example/train_mnist.py's epoch; returns (seconds, seconds the host
    waited on the loader, images)."""
    import torch
    from mxnet_tpu_torch import autograd, gluon
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    metric.reset()
    waited, images = 0.0, 0
    t0 = time.perf_counter()
    it = iter(loader)
    while True:
        t1 = time.perf_counter()
        batch = next(it, None)
        waited += time.perf_counter() - t1
        if batch is None:
            break
        x, y = (b.as_in_context(ctx) for b in batch)
        with autograd.record():
            out = net(x.reshape((x.shape[0], -1)))
            loss = loss_fn(out, y)
        loss.backward()
        trainer.step(x.shape[0])
        metric.update([y], [out])
        images += x.shape[0]
    torch.cuda.synchronize()
    return time.perf_counter() - t0, waited, images


def _estimator_fit(mx, ctx, ckpt_dir):
    """example/estimator_fit.py --synthetic on ``ctx``: returns (the
    estimator, its net, the validation loader, the results)."""
    from mxnet_tpu_torch import gluon, nd
    from mxnet_tpu_torch.gluon.contrib.estimator import (
        CheckpointHandler, EarlyStoppingHandler, Estimator)
    from mxnet_tpu_torch.metric import Accuracy
    rng = np.random.RandomState(0)
    x = rng.rand(1024, 784).astype("f4")
    w = rng.randn(784, 10).astype("f4")
    y = (x @ w).argmax(axis=1).astype("f4")
    split = int(0.9 * len(x))

    def loader(a, b, bs, shuffle):
        return gluon.data.DataLoader(gluon.data.ArrayDataset(
            nd.array(a, ctx=ctx), nd.array(b, ctx=ctx)), batch_size=bs,
            shuffle=shuffle)
    with ctx:
        net = _mnist_net(mx, ctx, seed=0, prefix="est_")
        train, val = loader(x[:split], y[:split], 128, True), \
            loader(x[split:], y[split:], 256, False)
        est = Estimator(net, gluon.loss.SoftmaxCrossEntropyLoss(),
                        metrics=Accuracy(), context=ctx,
                        trainer=gluon.Trainer(net.collect_params(), "adam",
                                              {"learning_rate": 1e-3}))
        est.fit(train, val_data=val, epochs=DATA["est_epochs"],
                event_handlers=[
                    CheckpointHandler(ckpt_dir, monitor=est.train_loss_metric,
                                      save_best=True),
                    EarlyStoppingHandler(monitor=est.train_loss_metric,
                                         patience=3)])
        results = dict(est.evaluate(val))
    return est, net, val, results


def phase_data(mx, dev, cfg=DATA):
    """example/train_mnist.py --synthetic at its size (DATA: 2048 and 512
    images, batch 128, 2 workers, hybridized 784-128-64-10 MLP, SGD 0.1,
    metric.Accuracy): the loader's batches on the card's context equal
    the CPU context's, in order (seeded); with prefetch_to_device=gpu(0)
    every batch byte-equal to the one without, and on the card; an epoch
    without and with prefetch: images/s and the loader's share of the
    host's time (plain, prefetch, prefetch, plain: two of each); the MLP
    through trainer.compile_step with a
    FactorScheduler (the rate halves every 4 updates) against the eager
    loop from the same weights: the rate follows the schedule, the
    weights agree to 1e-6 in relative L2, one capture; then
    example/estimator_fit.py --synthetic on the card: validation accuracy
    > 0.8, and the best checkpoint, reloaded into a fresh net, gives the
    trained net's outputs bit for bit."""
    import shutil
    import tempfile
    import torch
    from mxnet_tpu_torch import gluon, nd
    free_earlier_phases()
    gpu = mx.gpu(0)
    train, val = _mnist_loaders(mx)
    _, on_cpu = _loader_pass(train, mx.cpu())
    _, on_card = _loader_pass(train, gpu)
    same_order = len(on_cpu) == len(on_card) == math.ceil(
        cfg["train"] / cfg["batch_size"]) and all(
        a.tobytes() == b.tobytes() for x, y in zip(on_cpu, on_card)
        for a, b in zip(x, y))
    ptrain, pval = _mnist_loaders(mx, prefetch=gpu)
    staged, staged_host = _loader_pass(ptrain, gpu)
    prefetch_equal = len(staged_host) == len(on_cpu) and all(
        a.tobytes() == b.tobytes() and a.dtype == b.dtype
        for x, y in zip(staged_host, on_cpu) for a, b in zip(x, y))
    prefetch_on_card = all(b.context == gpu and b.tensor.is_cuda
                           for batch in staged for b in batch)
    del staged
    check(same_order, "data: the loader's batches on the card's context "
          "differ from the CPU context's")
    check(prefetch_equal and prefetch_on_card,
          f"data: prefetch_to_device batches equal {prefetch_equal}, on "
          f"the card {prefetch_on_card}")
    epochs = {"plain": [], "prefetch": []}
    for mode, loader, vloader in (("plain", train, val),
                                  ("prefetch", ptrain, pval),
                                  ("prefetch", ptrain, pval),
                                  ("plain", train, val)):
        net = _mnist_net(mx, gpu, seed=0)
        trainer = gluon.Trainer(net.collect_params(), "sgd",
                                {"learning_rate": cfg["lr"]})
        metric = mx.metric.Accuracy()
        with gpu:
            np.random.seed(1)
            _mnist_epoch(mx, net, trainer, loader, metric, gpu)  # warm-up
            secs, waited, images = _mnist_epoch(mx, net, trainer, loader,
                                                metric, gpu)
            train_acc = metric.get()[1]
            metric.reset()
            for x, y in vloader:
                x, y = x.as_in_context(gpu), y.as_in_context(gpu)
                metric.update([y], [net(x.reshape((x.shape[0], -1)))])
        epochs[mode].append({"epoch_s": secs, "images_per_s": images / secs,
                        "loader_wait_s": waited,
                        "loader_share": waited / secs,
                        "train_accuracy": train_acc,
                        "validation_accuracy": metric.get()[1]})
    # compile_step with a scheduled learning rate against the eager loop
    x_np = on_cpu[0][0].reshape(cfg["batch_size"], -1)
    y_np = on_cpu[0][1]
    runs = {}
    for kind in ("compiled", "eager"):
        net = _mnist_net(mx, gpu, seed=2)
        sched = mx.lr_scheduler.FactorScheduler(step=cfg["sched_step"],
                                                factor=cfg["sched_factor"])
        tr = gluon.Trainer(net.collect_params(), "sgd",
                           {"learning_rate": cfg["lr"],
                            "lr_scheduler": sched})
        loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
        x, y = nd.array(x_np, ctx=gpu), nd.array(y_np, ctx=gpu)
        cs = tr.compile_step(net, loss_fn) if kind == "compiled" else None
        lrs = []
        for _ in range(cfg["capture_steps"]):
            if cs is not None:
                cs.step(x, y)
            else:
                with mx.autograd.record():
                    loss = loss_fn(net(x), y)
                loss.backward()
                tr.step(cfg["batch_size"])
            lrs.append(tr.learning_rate)
        runs[kind] = (lrs, _weights(net), cs)
    want_sched = mx.lr_scheduler.FactorScheduler(step=cfg["sched_step"],
                                                 factor=cfg["sched_factor"],
                                                 base_lr=cfg["lr"])
    want_lrs = [want_sched(i) for i in range(1, cfg["capture_steps"] + 1)]
    cs = runs["compiled"][2]
    sched_err = max(_rel_l2([runs["compiled"][1][k]], [w])
                    for k, w in runs["eager"][1].items())
    check_no_fallback("data")
    # example/estimator_fit.py --synthetic on the card
    ckpt = tempfile.mkdtemp(prefix="estimator_ckpt_")
    try:
        est, net, vloader, results = _estimator_fit(mx, gpu, ckpt)
        best = os.path.join(ckpt, "model-best.params")
        last = os.path.join(ckpt, f"model-epoch{cfg['est_epochs'] - 1}"
                            ".params")
        best_is_last = open(best, "rb").read() == open(last, "rb").read()
        fresh = _mnist_net(mx, gpu, seed=5, prefix="est_")
        fresh.load_parameters(best)
        with gpu:
            xb = next(iter(vloader))[0]
            reload_bitwise = bool(np.array_equal(fresh(xb).asnumpy(),
                                                 net(xb).asnumpy()))
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    row = {"phase": "data", **cfg, "batches": len(on_cpu),
           "loader_order_equal_cpu": same_order,
           "prefetch_batches_byte_equal": prefetch_equal,
           "prefetch_batches_on_card": prefetch_on_card,
           "epoch": epochs,
           "schedule": {"lrs": runs["compiled"][0], "want": want_lrs,
                        "eager_lrs": runs["eager"][0],
                        "weight_rel_l2_max": sched_err,
                        "captures": cs.captures, "replays": cs.replays,
                        "last_path": cs.last_path},
           "estimator": {"results": results, "best_is_last_epoch":
                         best_is_last, "reload_bitwise": reload_bitwise,
                         "train_metrics": [m.get() for m in
                                           est.train_metrics]},
           "card": nvidia_smi()}
    emit(row)
    check(runs["compiled"][0] == want_lrs == runs["eager"][0],
          f"data: learning rates {runs['compiled'][0]}, want {want_lrs}")
    check(sched_err <= 1e-6, f"data: the captured steps' weights are "
          f"{sched_err} from the eager loop's")
    check(cs.captures == 1 and cs.last_path == "compiled",
          f"data: captures {cs.captures}, last path {cs.last_path}")
    check(results.get("validation accuracy", 0.0) > 0.8,
          f"data: estimator_fit's validation accuracy {results}")
    check(best_is_last and reload_bitwise,
          f"data: the best checkpoint is the last epoch's {best_is_last}, "
          f"reloads bit for bit {reload_bitwise}")
    return row


# -- phase 4: parity -----------------------------------------------------------

def phase_parity(mx, dev):
    """llama_tiny f32 on the card against the CPU: the Server's greedy
    tokens with one-step and 4-step decode (graph replays after each
    variant's first graph), ``generate_fused`` greedy against the CPU's
    ``generate``, and ``generate_beam``'s sequences and scores."""
    import numpy as np
    import torch
    from mxnet_tpu_torch.models import LlamaForCausalLM, llama_tiny
    from mxnet_tpu_torch.serving import Server

    vocab = 256
    cpu_lm = LlamaForCausalLM(llama_tiny(vocab_size=vocab), ctx=mx.cpu())
    cpu_lm.initialize(std=0.3, seed=7)
    gpu_lm = LlamaForCausalLM(llama_tiny(vocab_size=vocab), ctx=mx.gpu(0))
    gpu_lm.load_state_dict(cpu_lm.state_dict())
    layers = len(gpu_lm.model.layers)
    rng = np.random.RandomState(3)
    prompts = [rng.randint(0, vocab, n).astype("f4")
               for n in (30, 77, 128, 100)]
    srv_kw = dict(buckets=[(2, 128)], max_new_tokens=8)
    cpu_out = Server(cpu_lm, ctx=mx.cpu(), **srv_kw).generate(prompts)
    for k in (1, 4):
        reset_counts()
        srv = Server(gpu_lm, ctx=mx.gpu(0), **srv_kw)
        gpu_out = srv.generate(prompts, decode_steps=k)
        torch.cuda.synchronize()
        counts = read_counts()
        launches = counts["flash_fwd_launches"]
        st = srv.stats()
        b = st["buckets"]["2x128"]
        same = all(np.array_equal(x, y) for x, y in zip(cpu_out, gpu_out))
        emit({"phase": "parity", "model": "llama_tiny", "dtype": "float32",
              "decode_steps": k, "requests": len(prompts),
              "admissions": b["prefills"],
              "decode_dispatches": b["decode_dispatches"],
              "captures": st["captures"], "replays": st["replays"],
              "steady_dispatches": b["steady_dispatches"],
              "steady_misses": b["steady_misses"],
              "graph_pool_bytes": st["graph_pool_bytes"],
              "flash_fwd_launches": launches,
              "flash_fwd_tc_launches": counts["flash_fwd_tc_launches"],
              "layers": layers, "tokens_equal": same})
        check(same, f"parity: decode_steps={k}: greedy tokens on the card "
              "differ from the CPU's")
        check(launches == b["prefills"] * layers,
              f"parity: {launches} flash launches, want {b['prefills']} x "
              f"{layers}")
        check(counts["flash_fwd_tc_launches"] == 0,
              "parity: an f32 forward took the tensor-core route")
        # every variant: an eager first dispatch, then one capture
        check(st["captures"] == len(srv._variants) and st["replays"] > 0
              and b["steady_misses"] == 0,
              f"parity: decode_steps={k}: {st['captures']} captures of "
              f"{len(srv._variants)} variants, {st['replays']} replays, "
              f"{b['steady_misses']} steady misses")

    tok = rng.randint(0, vocab, (2, 128)).astype("f4")
    want = cpu_lm.generate(tok, max_new_tokens=8).numpy()
    fused = []
    for call in range(3):       # eager, captured and replayed, replayed
        reset_counts()
        fused.append(gpu_lm.generate_fused(tok, max_new_tokens=8)
                     .cpu().numpy())
        launches = read_counts()["flash_fwd_launches"]
    (cap,) = gpu_lm._fused.values()
    same = [bool(np.array_equal(f, want)) for f in fused]
    emit({"phase": "parity_generate_fused", "model": "llama_tiny",
          "dtype": "float32", "batch": 2, "prompt_len": 128,
          "new_tokens": 8, "tokens_equal_by_call": same,
          "captures": cap.captures, "replays": cap.replays,
          "graph_pool_bytes": cap.pool_bytes,
          "flash_fwd_launches_last_call": launches})
    check(all(same), f"parity: generate_fused on the card differs from the "
          f"CPU's generate (calls: {same})")
    check(cap.captures == 1 and cap.replays == 2,
          f"parity: generate_fused {cap.captures} captures, {cap.replays} "
          "replays; want 1 and 2")
    check(launches == layers, f"parity: generate_fused replay ran {launches} "
          f"flash launches, want {layers}")

    beam_kw = dict(max_new_tokens=6, beam_size=3, alpha=0.8)
    cseq, csc = cpu_lm.generate_beam(tok, **beam_kw)
    reset_counts()
    gseq, gsc = gpu_lm.generate_beam(tok, **beam_kw)
    launches = read_counts()["flash_fwd_launches"]
    seq_same = bool(torch.equal(gseq.cpu(), cseq))
    score_err = float((gsc.cpu() - csc).abs().max())
    emit({"phase": "parity_generate_beam", "model": "llama_tiny",
          "dtype": "float32", "batch": 2, "prompt_len": 128, "beam": 3,
          "new_tokens": 6, "sequences_equal": seq_same,
          "score_max_abs_err": score_err, "flash_fwd_launches": launches})
    check(seq_same, "parity: generate_beam sequences on the card differ "
          "from the CPU's")
    check(score_err <= 1e-4, f"parity: generate_beam scores differ by "
          f"{score_err} (> 1e-4)")
    check(launches == layers, f"parity: generate_beam ran {launches} flash "
          f"launches, want {layers} (one prefill)")

    # given an NDArray prompt the generate family returns NDArrays on the
    # prompt's context, as the reference does
    nd_tok = mx.nd.array(tok, ctx=mx.gpu(0))
    got = {"generate": gpu_lm.generate(nd_tok, max_new_tokens=8),
           "generate_fused": gpu_lm.generate_fused(nd_tok, max_new_tokens=8),
           "generate_beam": gpu_lm.generate_beam(nd_tok, **beam_kw)}
    kinds = {k: [type(o).__name__ + "@" + str(o.context)
                 for o in (v if isinstance(v, tuple) else (v,))]
             for k, v in got.items()}
    same = bool(np.array_equal(got["generate"].asnumpy(), want)
                and np.array_equal(got["generate_fused"].asnumpy(), want)
                and np.array_equal(got["generate_beam"][0].asnumpy(),
                                   cseq.numpy()))
    emit({"phase": "parity_generate_ndarray", "returns": kinds,
          "tokens_equal": same})
    check(all(isinstance(o, mx.nd.NDArray) and o.context == mx.gpu(0)
              for v in got.values()
              for o in (v if isinstance(v, tuple) else (v,))) and same,
          f"parity: the generate family given an NDArray prompt returned "
          f"{kinds}, tokens equal {same}")


# -- phase 5: serve ------------------------------------------------------------

SERVE_NEW_TOKENS = 32
SERVE_LENS = [20, 64, 100, 128, 200, 333, 450, 500]


def serve_window(srv, prompts, decode_steps, window, layers, vocab, dev):
    """Submit every prompt at once and run the server to drain with
    ``decode_steps``; one line of readings, with the counts it moved."""
    import torch
    before = srv.stats()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    t0 = time.perf_counter()
    reqs = [srv.submit(p) for p in prompts]
    srv.run(decode_steps=decode_steps)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    counts = read_counts()
    after = srv.stats()
    delta = {k: {f: after["buckets"][k][f] - before["buckets"][k][f]
                 for f in after["buckets"][k]} for k in after["buckets"]}

    def total(f):
        return sum(d[f] for d in delta.values())
    ttft = [r.first_token_t - r.submit_t for r in reqs]
    row = {"phase": "serve", "window": window, "decode_steps": decode_steps,
           "requests": len(reqs), "admissions": total("prefills"),
           "tokens": total("tokens"), "wall_s": wall_s,
           "tokens_per_wall_s": total("tokens") / wall_s,
           "ttft_p50_s": statistics.median(ttft), "ttft_max_s": max(ttft),
           "prefill_s": total("prefill_s"), "decode_s": total("decode_s"),
           "decode_steps_run": total("decode_steps"),
           "decode_dispatches": total("decode_dispatches"),
           "decode_ms_per_step": 1e3 * total("decode_s")
           / total("decode_steps"),
           "decode_ms_per_dispatch": 1e3 * total("decode_s")
           / total("decode_dispatches"),
           "captures": after["captures"] - before["captures"],
           "replays": after["replays"] - before["replays"],
           "steady_dispatches": total("steady_dispatches"),
           "steady_misses": total("steady_misses"),
           "graph_pool_bytes": after["graph_pool_bytes"],
           "graph_pool_bytes_by_variant": {
               suffix: cap.pool_bytes
               for suffix, (cap, _) in srv._variants.items()},
           "peak_mem_bytes": torch.cuda.max_memory_allocated(dev),
           "flash_fwd_launches": counts["flash_fwd_launches"],
           "flash_fwd_tc_launches": counts["flash_fwd_tc_launches"],
           "layers": layers, "per_bucket": delta}
    emit(row)
    for r in reqs:
        gen = np.asarray(r.generated)
        check(r.state == "done" and len(gen) == SERVE_NEW_TOKENS,
              f"serve: request {r.id} ended {r.state} with {len(gen)} "
              "tokens")
        check(((gen >= 0) & (gen < vocab)).all(),
              f"serve: request {r.id} has tokens out of range")
    check(row["admissions"] == len(reqs),
          f"serve: {row['admissions']} admissions")
    launches = row["flash_fwd_launches"]
    check(launches == row["admissions"] * layers,
          f"serve: {launches} flash launches, want {row['admissions']} x "
          f"{layers}")
    check(row["flash_fwd_tc_launches"] == launches,
          f"serve: {row['flash_fwd_tc_launches']} of {launches} bf16 flash "
          "launches took the tensor-core route")
    return row, [list(r.generated) for r in reqs]


def phase_serve(mx, dev):
    """The Llama-3-8B geometry in bf16 through Server, every dispatch a
    graph replay after its variant's first graph: two windows with
    one-step decode (the second must capture nothing), one with 8-step
    decode; where the time goes, eager and replayed; generate_fused at
    B=4, S=512; seeded sampling."""
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
    vocab = lm.model.vocab_size
    layers = len(lm.model.layers)
    emit({"phase": "serve_model", "model": "llama3_8b", "dtype": "bfloat16",
          "params": sum(p.numel() for p in lm.parameters()),
          "weight_bytes": sum(p.numel() * p.element_size()
                              for p in lm.parameters()),
          "weights_init_s": init_s, "buckets": ["4x128", "4x512"],
          "prompt_lens": SERVE_LENS, "new_tokens": SERVE_NEW_TOKENS,
          "card": nvidia_smi()})

    # every logits tensor the server and generate_fused read is checked
    # on the device, inside the graphs too (the adds are captured)
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

    srv = Server(lm, buckets=[(4, 128), (4, 512)],
                 max_new_tokens=SERVE_NEW_TOKENS, ctx=mx.gpu(0),
                 cache_dtype="bfloat16")
    rng = np.random.RandomState(11)
    # warm-up: a short request in each bucket, with one-step then 8-step
    # decode (cuBLAS handles, first-call overheads; every variant's
    # eager first dispatch, and the captures of all but the one-step
    # decode, which the first window captures)
    warm = [rng.randint(0, vocab, n).astype("f4") for n in (20, 200)]
    srv.generate(warm, max_new_tokens=2)
    srv.generate(warm, max_new_tokens=17, decode_steps=8)
    torch.cuda.synchronize()
    prompts = [rng.randint(0, vocab, n).astype("f4") for n in SERVE_LENS]
    windows = []
    for window, k in enumerate((1, 1, 8)):
        windows.append(serve_window(srv, prompts, k, window, layers, vocab,
                                    dev)[0])
    # the second one-step window and the 8-step window capture nothing:
    # every dispatch is a steady replay
    for steady in windows[1:]:
        dispatches = steady["admissions"] + steady["decode_dispatches"]
        check(steady["captures"] == 0 and steady["steady_misses"] == 0,
              f"serve: window {steady['window']} captured "
              f"{steady['captures']} graphs ({steady['steady_misses']} "
              "steady misses)")
        check(steady["replays"] == dispatches
              and steady["steady_dispatches"] == dispatches,
              f"serve: window {steady['window']} replayed "
              f"{steady['replays']} of {dispatches} dispatches "
              f"({steady['steady_dispatches']} steady)")
    steady = windows[1]

    # where the time goes: eager calls, then the server's replays of
    # the 512 bucket's decode (4 slots, cache 544) and prefill
    lm.prefill, lm.decode_step = plain_prefill, plain_decode
    for s in (128, 512):
        caches = lm.init_cache(1, s + SERVE_NEW_TOKENS, dtype="bfloat16")
        tok = torch.as_tensor(rng.randint(0, vocab, (1, s)).astype("f4"),
                              device=dev)
        last = torch.tensor([s - 1.0], device=dev)
        emit(dict({"phase": "serve_breakdown", "call": f"prefill_s{s}"},
                  **profile_call(lambda: lm.prefill(
                      tok, [(k[:, :s], v[:, :s]) for k, v in caches],
                      last_pos=last))))
    caches = lm.init_cache(4, 512 + SERVE_NEW_TOKENS, dtype="bfloat16")
    tok = torch.zeros((4, 1), device=dev)
    off = torch.tensor([20.0, 100.0, 300.0, 500.0], device=dev)
    emit(dict({"phase": "serve_breakdown", "call": "decode_4slots_c544"},
              **profile_call(lambda: lm.decode_step(tok, caches, off))))
    b512 = srv.sched.buckets[1]
    ones, zeros = torch.ones(4, device=dev), torch.zeros(4, device=dev)
    emit(dict({"phase": "serve_breakdown",
               "call": "decode_4slots_c544_replay"},
              **profile_call(lambda: srv._dispatch(
                  b512, "decode", 1, [tok, off, ones, zeros]))))
    prompt = torch.as_tensor(rng.randint(0, vocab, (1, 512)).astype("f4"),
                             device=dev)
    pre_in = [prompt, torch.tensor([511.0], device=dev),
              torch.zeros(1, dtype=torch.long, device=dev),
              torch.zeros(1, device=dev)]
    emit(dict({"phase": "serve_breakdown", "call": "prefill_s512_replay"},
              **profile_call(lambda: srv._dispatch(
                  b512, "prefill", 1, pre_in))))
    lm.prefill = checked(plain_prefill)
    lm.decode_step = checked(plain_decode)

    # seeded sampling: the same seed gives the same tokens (every
    # variant captures again on the reseeded generator)
    sampled = []
    for _ in range(2):
        mx.random.seed(5)
        reqs = [srv.submit(p, max_new_tokens=8, temperature=0.8)
                for p in prompts]
        srv.run()
        sampled.append([list(r.generated) for r in reqs])
    emit({"phase": "serve_sampled", "temperature": 0.8, "new_tokens": 8,
          "tokens_equal": sampled[0] == sampled[1],
          "captures": srv.stats()["captures"]})
    check(sampled[0] == sampled[1], "serve: two sampled runs after "
          "mx.random.seed(5) drew different tokens")

    fused = phase_generate_fused(lm, rng, vocab, layers, dev)
    bad = int(nonfinite.item())
    emit({"phase": "serve_checks", "nonfinite_logits": bad})
    check(bad == 0, f"serve: {bad} non-finite logits")
    return {"launches": steady["flash_fwd_launches"],
            "generate_fused_launches": fused}


def phase_generate_fused(lm, rng, vocab, layers, dev):
    """generate_fused at B=4, S=512, 32 new tokens: greedy (an eager
    call, the captured call, then timed replays), and sampled
    (temperature 0.8, top_k 50): a seed gives equal tokens at every
    replay, another seed other tokens."""
    import torch
    b, s, n = 4, 512, SERVE_NEW_TOKENS
    tok = torch.as_tensor(rng.randint(0, vocab, (b, s)).astype("f4"),
                          device=dev)

    def call(**kw):
        return lm.generate_fused(tok, n, cache_dtype="bfloat16", **kw)

    def timed(**kw):
        t0 = time.perf_counter()
        out = call(**kw)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0
    eager, eager_s = timed()
    replayed, capture_s = timed()          # captured, then replayed once
    walls, launches = [], []
    for _ in range(3):
        reset_counts()
        out, wall = timed()
        walls.append(wall)
        launches.append(read_counts()["flash_fwd_launches"])
    wall = statistics.median(walls)
    key = (b, s, n, False, 0, False, "bfloat16", str(tok.dtype))
    cap = lm._fused[key]
    gen = out[:, s:]
    sample = dict(temperature=0.8, top_k=50)
    call(seed=1, **sample)                     # eager warm-up
    s1, s1b, s2 = (call(seed=1, **sample), call(seed=1, **sample),
                   call(seed=2, **sample))
    row = {"phase": "generate_fused", "model": "llama3_8b",
           "dtype": "bfloat16", "batch": b, "prompt_len": s,
           "new_tokens": n, "eager_call_s": eager_s,
           "capture_call_s": capture_s, "wall_s": walls,
           "tokens_per_wall_s": b * n / wall,
           "flash_fwd_launches_per_call": launches,
           "captures": cap.captures, "replays": cap.replays,
           "graph_pool_bytes": cap.pool_bytes,
           "replays_equal": bool(torch.equal(out, replayed)),
           "eager_equals_replay": bool(torch.equal(out, eager)),
           "sampled_same_seed_equal": bool(torch.equal(s1, s1b)),
           "sampled_other_seed_differs": not torch.equal(s1, s2),
           "card": nvidia_smi()}
    emit(row)
    check(torch.equal(out[:, :s], tok), "generate_fused: the prompt changed")
    check(bool(((gen >= 0) & (gen < vocab)).all()),
          "generate_fused: tokens out of range")
    check(row["replays_equal"], "generate_fused: two greedy replays differ")
    check(all(x == layers for x in launches),
          f"generate_fused: flash launches a call {launches}, want {layers}")
    check(cap.captures == 1, f"generate_fused: {cap.captures} captures")
    check(row["sampled_same_seed_equal"] and row["sampled_other_seed_differs"],
          "generate_fused: seed 1 twice gave different tokens, or seed 2 "
          "the same as seed 1")
    return launches[-1]


# -- phases 6 and 7: training -------------------------------------------------

def _full_len_pretrain(mod):
    """bench.py's ``_FullLenPretrain``: a HybridBlock over BERTForPretrain
    with ``valid_length=None`` (full-length rows, no padding mask)."""
    from mxnet_tpu_torch.gluon import HybridBlock

    class FullLenPretrain(HybridBlock):
        def __init__(self, mod, **kw):
            super().__init__(**kw)
            with self.name_scope():
                self.mod = mod

        def hybrid_forward(self, F, tokens, types, positions):
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


def _pretrain_batch(mx, vocab, b, seq_len, m, ctx):
    """bench.py's batch: tokens, types, masked positions and labels from
    np.random.RandomState(0), as float32 NDArrays on ``ctx``."""
    import numpy as np
    rng = np.random.RandomState(0)
    tokens = mx.nd.array(rng.randint(0, vocab, (b, seq_len)).astype("f"),
                         ctx=ctx)
    types = mx.nd.array(rng.randint(0, 2, (b, seq_len)).astype("f"),
                        ctx=ctx)
    positions = mx.nd.array(rng.randint(0, seq_len, (b, m)).astype("f"),
                            ctx=ctx)
    label = mx.nd.array(np.concatenate(
        [rng.randint(0, vocab, (b, m)), rng.randint(0, 2, (b, 1))],
        axis=1).astype("f"), ctx=ctx)
    return (tokens, types, positions), label


def _small_pretrainer(mx, ctx, weights=None, fuse_step=True, layers=2,
                      vocab=200, m=4):
    """bert_small (``layers`` layers, f32, dropout 0) through the
    HybridBlock, Adam lr 1e-3 on ``ctx``; ``weights`` (a state_dict) is
    loaded when given.  Returns (trainer, state_dict)."""
    from mxnet_tpu_torch import models, parallel
    inner = models.BERTForPretrain(models.bert_small(
        vocab_size=vocab, max_length=128, dropout=0.0, num_layers=layers))
    model = _full_len_pretrain(inner).initialize(mx.init.Xavier(), ctx=ctx,
                                                 seed=5)
    if weights is None:
        weights = {k: t.clone() for k, t in model.state_dict().items()}
    else:
        model.load_state_dict(weights)
    dpt = parallel.DataParallelTrainer(
        model, _pretrain_loss(m), "adam", {"learning_rate": 1e-3},
        mesh=parallel.make_mesh({"dp": 1}, devices=[ctx]),
        fuse_step=fuse_step)
    return dpt, weights


def _scalar(loss):
    return float(loss.asnumpy())


def phase_train_parity(mx, dev):
    """bert_small, 2 layers, f32, dropout 0: 3 Adam steps on the card and
    on the CPU from the same weights (on the card: a warm-up step, the
    captured step and a replay)."""
    vocab, b, seq_len, m, steps, layers = 200, 2, 128, 4, 3, 2
    losses = []
    weights = None
    for ctx in (mx.cpu(), mx.gpu(0)):
        dpt, weights = _small_pretrainer(mx, ctx, weights, layers=layers,
                                         vocab=vocab, m=m)
        data, label = _pretrain_batch(mx, vocab, b, seq_len, m, ctx)
        reset_counts()
        losses.append([_scalar(dpt.step(data, label))
                       for _ in range(steps)])
        launches = read_counts()
    cpu_losses, card_losses = losses
    rel = max(abs(g - c) / abs(c) for g, c in zip(card_losses, cpu_losses))
    emit({"phase": "train_parity", "model": "bert_small", "layers": layers,
          "dtype": "float32", "steps": steps, "cpu_losses": cpu_losses,
          "gpu_losses": card_losses, "max_rel_diff": rel,
          "captures": dpt.captures, "replays": dpt.replays, **launches})
    check(rel <= 1e-4, f"train_parity: losses differ by {rel} relative")
    check(dpt.captures == 1 and dpt.replays == steps - 1,
          f"train_parity: {dpt.captures} captures and {dpt.replays} "
          f"replays, want 1 and {steps - 1}")
    check(all(launches[n] == steps * layers for n in F32_ROUTE),
          f"train_parity: launches {launches}, want {steps * layers} each")
    check(all(launches[n] == 0 for n in COUNTERS
              if n.endswith("_tc_launches")),
          f"train_parity: f32 launches took the tensor-core route: "
          f"{launches}")
    check(card_losses[-1] < card_losses[0],
          "train_parity: the loss did not fall")


def phase_train_capture_parity(mx, dev):
    """bert_small, 2 layers, f32, dropout 0, from one set of weights:
    4 steps of the captured trainer (a warm-up step, the capture and its
    replay, two replays) against 4 eager steps on the card and against
    the CPU; step_multi(repeat=4) of a fresh captured trainer against
    those 4 step() calls, bit for bit."""
    vocab, b, seq_len, m, steps = 200, 2, 128, 4, 4
    cpu_dpt, weights = _small_pretrainer(mx, mx.cpu())
    data, label = _pretrain_batch(mx, vocab, b, seq_len, m, mx.cpu())
    cpu = [_scalar(cpu_dpt.step(data, label)) for _ in range(steps)]
    data, label = _pretrain_batch(mx, vocab, b, seq_len, m, mx.gpu(0))
    captured, _ = _small_pretrainer(mx, mx.gpu(0), weights)
    cap = [_scalar(captured.step(data, label)) for _ in range(steps)]
    eager_dpt, _ = _small_pretrainer(mx, mx.gpu(0), weights,
                                     fuse_step=False)
    eager = [_scalar(eager_dpt.step(data, label)) for _ in range(steps)]
    multi_dpt, _ = _small_pretrainer(mx, mx.gpu(0), weights)
    multi = [float(v) for v in
             multi_dpt.step_multi(data, label, repeat=steps).asnumpy()]
    rel_eager = max(abs(c - e) / abs(e) for c, e in zip(cap, eager))
    rel_cpu = max(abs(c - e) / abs(e) for c, e in zip(cap, cpu))
    same_weights = all(
        bool((a == c).all()) for a, c in zip(captured._params,
                                             multi_dpt._params))
    emit({"phase": "train_capture_parity", "model": "bert_small",
          "layers": 2, "dtype": "float32", "steps": steps,
          "captured_losses": cap, "eager_losses": eager,
          "cpu_losses": cpu, "step_multi_losses": multi,
          "max_rel_diff_eager": rel_eager, "bit_equal_eager": cap == eager,
          "max_rel_diff_cpu": rel_cpu, "step_multi_bit_equal": multi == cap,
          "step_multi_weights_bit_equal": same_weights,
          "captures": captured.captures, "replays": captured.replays,
          "step_multi_captures": multi_dpt.captures,
          "step_multi_replays": multi_dpt.replays})
    check(rel_eager <= 1e-6, f"train_capture_parity: captured and eager "
          f"losses differ by {rel_eager} relative")
    check(rel_cpu <= 1e-4, f"train_capture_parity: captured and CPU "
          f"losses differ by {rel_cpu} relative")
    check(multi == cap and same_weights, "train_capture_parity: "
          f"step_multi(repeat={steps}) {multi} is not {steps} step() calls "
          f"{cap} bit for bit")
    for who, t in (("step", captured), ("step_multi", multi_dpt)):
        check(t.captures == 1 and t.replays == steps - 1,
              f"train_capture_parity: {who}: {t.captures} captures, "
              f"{t.replays} replays; want 1 and {steps - 1}")


def phase_dropout(mx, dev, n=1 << 20, p=0.1):
    """Dropout inside a captured step: a block returns Dropout(p)(x * w)
    on x = 1 (w = 1, Adam at lr 0 keeps it), and the loss function copies
    that output into a buffer the graph writes at every replay.  Two
    replays' masks must differ, each keep rate lie within 1 % of 1 - p,
    and every kept value be 1 / (1 - p)."""
    import torch
    from mxnet_tpu_torch import gluon, parallel

    class Drop(gluon.HybridBlock):
        def __init__(self, **kw):
            super().__init__(**kw)
            with self.name_scope():
                self.w = self.params.get("w", shape=(n,), init="ones")
                self.drop = gluon.nn.Dropout(p)

        def hybrid_forward(self, F, x, w):
            return self.drop(x * w)

    seen = torch.zeros(n, device=dev)

    def loss_fn(out, label):
        seen.copy_(out.tensor.detach())
        return (out * label).mean()

    mx.random.seed(0)
    net = Drop().initialize(ctx=mx.gpu(0))
    dpt = parallel.DataParallelTrainer(
        net, loss_fn, "adam", {"learning_rate": 0.0},
        mesh=parallel.make_mesh({"dp": 1}, devices=[mx.gpu(0)]),
        fuse_step=True)
    x = mx.nd.ones((n,), ctx=mx.gpu(0))
    outs = []
    for _ in range(4):
        dpt.step(x, x)
        outs.append(seen.clone())
    keep = [(o != 0) for o in outs]
    rates = [k.float().mean().item() for k in keep]
    scale = 1.0 / (1.0 - p)
    want = torch.tensor(1.0, device=dev) / (1.0 - p)
    scale_err = max((o[k] - want).abs().max().item()
                    for o, k in zip(outs, keep))
    differ = [(a != c).float().mean().item()
              for a, c in zip(keep[1:], keep[2:])]
    emit({"phase": "dropout", "p": p, "n": n,
          "steps": ["warm-up", "capture + replay", "replay", "replay"],
          "keep_rates": rates, "kept_value_max_err": scale_err,
          "kept_scale": scale, "differ_between_replays": differ,
          "captures": dpt.captures, "replays": dpt.replays})
    check(dpt.captures == 1 and dpt.replays == 3,
          f"dropout: {dpt.captures} captures, {dpt.replays} replays")
    check(all(abs(r - (1.0 - p)) <= 0.01 * (1.0 - p) for r in rates),
          f"dropout: keep rates {rates}, want {1.0 - p} within 1 %")
    check(scale_err <= 1e-6, f"dropout: kept values are off 1/(1-p) by "
          f"{scale_err}")
    check(all(d > 0.1 for d in differ),
          f"dropout: replays reused a mask (share of elements that "
          f"differ: {differ})")


# bench.py's bert_base configuration (bench_bert_pretrain's arguments)
BERT_BASE = dict(model="bert_base", vocab=30522, batch_size=64,
                 seq_len=128, num_masked=20, hidden=768, layers=12,
                 steps=20, warmup=3, bulk=8, max_length=512)


def last_loss(loss):
    return float(np.asarray(loss.asnumpy()).ravel()[-1])


def timed_windows(call, n1, n2, what, read=last_loss):
    """bench.py's two-window slope: ``n1`` then ``n2`` calls, each window
    ending in a host read (``read``) of the last call's loss; returns
    (seconds a call, naive seconds a call, [window s], "slope" or
    "naive", the last read)."""
    def window(n):
        t0 = time.perf_counter()
        last = None
        for _ in range(n):
            last = call()
        val = read(last)
        check(math.isfinite(val), f"{what}: loss {val} is not finite")
        return time.perf_counter() - t0, val
    t_small, _ = window(n1)
    dt, last = window(n2)
    slope, naive = (dt - t_small) / (n2 - n1), dt / n2
    used = "slope"
    if slope <= 0 or slope < 0.2 * naive:
        slope, used = naive, "naive"
    return slope, naive, [t_small, dt], used, last


def phase_train(mx, dev, ctx, cfg=BERT_BASE):
    """bench.py's bench_bert_pretrain at ``cfg`` on ``ctx``: the captured
    trainer (fuse_step=True) through step and step_multi(repeat=bulk),
    each timed by the two-window slope, then the eager trainer
    (fuse_step=False) on the same model for comparison."""
    import torch
    from mxnet_tpu_torch import models, parallel
    from mxnet_tpu_torch.contrib import amp

    vocab, batch_size = cfg["vocab"], cfg["batch_size"]
    seq_len, num_masked = cfg["seq_len"], cfg["num_masked"]
    hidden, layers = cfg["hidden"], cfg["layers"]
    steps, warmup, bulk = cfg["steps"], cfg["warmup"], cfg["bulk"]
    free_earlier_phases()
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

        def trainer(fuse_step):
            return parallel.DataParallelTrainer(
                model, _pretrain_loss(m), "adam", {"learning_rate": 1e-4},
                mesh=mesh, fuse_step=fuse_step)
        dpt = trainer(True)
        data, label = _pretrain_batch(mx, vocab, b, seq_len, m, ctx)
        first = None
        for _ in range(warmup):
            loss = dpt.step(data, label)
            first = _scalar(loss) if first is None else first
        loss.wait_to_read()
        dpt.step_multi(data, label, repeat=bulk).wait_to_read()

        n1 = max(min(steps // 3, steps - 1), 1)
        torch.cuda.reset_peak_memory_stats(dev)
        replays0 = dpt.replays
        reset_counts()
        step_s, naive_s, windows, used, last = timed_windows(
            lambda: dpt.step(data, label), n1, steps, "train")
        multi_s, multi_naive_s, multi_windows, multi_used, _ = \
            timed_windows(lambda: dpt.step_multi(data, label, repeat=bulk),
                          1, 3, "train step_multi")
        launches = read_counts()
        replays = dpt.replays - replays0
        peak = torch.cuda.max_memory_allocated(dev)
        n_steps = n1 + steps + 4 * bulk
        reset_counts()
        dpt.step(data, label)
        per_replay = read_counts()

        eager = trainer(False)
        for _ in range(2):
            eager.step(data, label)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        eager_s, eager_naive_s, eager_windows, eager_used, _ = \
            timed_windows(lambda: eager.step(data, label), n1, steps,
                          "train eager")
        eager_peak = torch.cuda.max_memory_allocated(dev)
        eager_breakdown = profile_call(lambda: eager.step(data, label))
        breakdown = profile_call(lambda: dpt.step(data, label),
                                 expect=eager_breakdown["kernels"])
        captures = dpt.captures
    finally:
        amp._deinit()

    embed = {id(inner.bert.word_embed.weight),
             id(inner.bert.token_type_embed.weight),
             id(inner.bert.position_embed)}
    n_params = sum(p.numel() for p in model.parameters()
                   if id(p) not in embed)
    flops_v1 = (6 * n_params * seq_len
                + 12 * layers * hidden * seq_len * seq_len)
    flops_v2 = flops_v1 + 6 * num_masked * hidden * vocab

    def rates(per_step_s):
        sps = batch_size / per_step_s
        return {"samples_per_s": sps,
                "mfu_v1": sps * flops_v1 / PEAK_FLOPS["bfloat16"],
                "mfu_v2": sps * flops_v2 / PEAK_FLOPS["bfloat16"]}
    emit(dict({"phase": "train", "model": cfg["model"],
               "dtype": "bfloat16 AMP", "path": "captured (fuse_step=True)",
               "batch_size": batch_size, "seq_len": seq_len,
               "num_masked": num_masked, "vocab": vocab, "layers": layers,
               "params": sum(p.numel() for p in model.parameters()),
               "non_embedding_params": n_params, "weights_init_s": init_s,
               "warmup": warmup, "windows": [n1, steps],
               "window_s": windows, "step_ms": step_s * 1e3,
               "naive_step_ms": naive_s * 1e3, "timing": used,
               "step_multi_repeat": bulk, "step_multi_windows": [1, 3],
               "step_multi_window_s": multi_windows,
               "step_multi_ms_per_step": multi_s / bulk * 1e3,
               "step_multi_naive_ms_per_step": multi_naive_s / bulk * 1e3,
               "step_multi_timing": multi_used,
               "step_multi": rates(multi_s / bulk),
               "eager_step_ms": eager_s * 1e3,
               "eager_naive_step_ms": eager_naive_s * 1e3,
               "eager_window_s": eager_windows, "eager_timing": eager_used,
               "eager": rates(eager_s),
               "first_loss": first, "last_loss": last, **launches,
               "steps_counted": n_steps, "captures": captures,
               "replays_counted": replays,
               "launches_per_replay": per_replay,
               "peak_mem_bytes": peak, "eager_peak_mem_bytes": eager_peak,
               "graph_pool_bytes": dpt.pool_bytes, "card": nvidia_smi()},
              **rates(step_s)))
    emit(dict({"phase": "train_breakdown", "call": "step_b64_s128_replay"},
              **breakdown))
    emit(dict({"phase": "train_breakdown", "call": "step_b64_s128_eager"},
              **eager_breakdown))
    check(last < first, f"train: last loss {last} not below the first "
          f"{first}")
    check(captures == 1, f"train: {captures} captures, want 1 (one "
          "signature, captured after the warm-up and never again)")
    check(replays == n_steps, f"train: {replays} replays in the timed "
          f"windows, want {n_steps}, one a step")
    # bf16 AMP: every K1, K2 and K3 launch on the tensor cores, so every
    # counter (the *_tc_launches too) is layers x steps, counted through
    # the replays
    check(all(n == layers * n_steps for n in launches.values()),
          f"train: launches {launches}, want {layers} x {n_steps} each")
    check(all(n == layers for n in per_replay.values()),
          f"train: launches a replay {per_replay}, want {layers} each")
    return dict(launches, per_replay=per_replay)


def profile_call(fn, reps=3, expect=None, tries=3):
    """Host wall time of ``fn`` (ending in a synchronize; median of
    ``reps``), its time between CUDA events (``event_ms``, median of
    ``reps``), and the device time of one call from a torch.profiler
    window of ``reps`` calls, split into the flash kernels (forward,
    backward), convolutions (cuDNN's kernels, ``CONV_KERNELS``),
    BatchNorm, matrix products and the rest.  Every call runs the same
    kernels, so each must be recorded a multiple of ``reps`` times
    (within 10 %), and, given ``expect`` (the kernels of a call that runs
    a subset of this one's: the eager step beside its replay), at least
    that many a call.  A window that lost events is
    taken again, up to ``tries`` windows; after that the device numbers
    read "not measured"."""
    import torch
    fn()
    torch.cuda.synchronize()
    walls, events = [], []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    for _ in range(reps):
        events.append(cuda_time_ms(fn, reps=1, warmup=0))
    wall_ms = statistics.median(walls)
    row = {"wall_ms": wall_ms, "event_ms": statistics.median(events)}
    for attempt in range(1, tries + 1):
        us, counts = window_kernels(fn, reps)
        per_call = {k: round(n / reps) for k, n in counts.items()}
        lost = {k[:80]: n for k, n in counts.items()
                if per_call[k] < 1 or abs(n - per_call[k] * reps) > 0.1 * reps}
        whole = bool(counts) and not lost and (
            not expect or sum(per_call.values()) >= expect)
        if whole:
            break
    else:
        return dict(row, device_ms="not measured", kernels=None,
                    device_busy_share="not measured",
                    profile_windows=tries, last_window_counts_off=lost,
                    last_window_kernels=sum(counts.values()) / reps)
    fwd = bwd = conv = bn = gemm = other = 0.0
    for key, t in us.items():
        name = key.lower()
        if "flash_fwd" in name:
            fwd += t
        elif "flash_bwd" in name:
            bwd += t
        elif any(c in name for c in CONV_KERNELS):
            conv += t
        elif "batch_norm" in name or "batchnorm" in name:
            bn += t
        elif any(g in name for g in ("gemm", "gemv", "cutlass", "nvjet",
                                     "xmma", "matmul")):
            gemm += t
        else:
            other += t
    device_ms = (fwd + bwd + conv + bn + gemm + other) / 1e3 / reps
    return dict(row, device_ms=device_ms,
                flash_ms=(fwd + bwd) / 1e3 / reps,
                flash_fwd_ms=fwd / 1e3 / reps, flash_bwd_ms=bwd / 1e3 / reps,
                conv_ms=conv / 1e3 / reps, bn_ms=bn / 1e3 / reps,
                gemm_ms=gemm / 1e3 / reps, other_ms=other / 1e3 / reps,
                kernels=sum(per_call.values()),
                device_busy_share=device_ms / wall_ms,
                profile_windows=attempt)


# cuDNN's convolution kernels (forward, data and weight gradients) and its
# layout transforms around them: the "convolution" share of a breakdown
CONV_KERNELS = ("conv", "fprop", "dgrad", "wgrad", "implicit", "cudnn",
                "nchwtonhwc", "nhwctonchw")


# -- phases 24-26: fp16 mixed precision and the optimizers ----------------------

# the valid lengths of a pretraining batch of 64 at S=128: 65 to 128
BERT_LENS = tuple(128 - (37 * i) % 64 for i in range(64))

# the flash kernels' float16 route (F6): BERT's shape as the bf16 rows (the
# kernels line's float16 rows), with a pretraining batch's key padding, and
# Llama training's shape
F16_FLASH_CASES = [
    dict(name="bert_b64_s128_lse_f16", b=64, s_q=128, s_k=128,
         dtype="float16", causal=False, h=12, kv=12, d=64, want_lse=True),
    dict(name="bert_b64_s128_kpad_lse_f16", b=64, s_q=128, s_k=128,
         dtype="float16", causal=False, h=12, kv=12, d=64, want_lse=True,
         kmask_lens=BERT_LENS),
    dict(name="llama_train_s4096_lse_f16", s_q=4096, s_k=4096,
         dtype="float16", causal=True, want_lse=True),
]
F16_BWD_CASES = [
    dict(name="bert_b64_s128_f16", b=64, s_q=128, s_k=128, h=12, kv=12,
         d=64, dtype="float16", causal=False),
    dict(name="bert_b64_s128_kpad_f16", b=64, s_q=128, s_k=128, h=12,
         kv=12, d=64, dtype="float16", causal=False, kmask_lens=BERT_LENS),
    dict(name="llama_train_s4096_f16", s_q=4096, s_k=4096,
         dtype="float16", causal=True),
]
F16_CASE, BWD_F16_CASE = "bert_b64_s128_lse_f16", "bert_b64_s128_f16"
# the AMP loop's tiny BERT (float16 products: float16's tolerance of
# mxnet_tpu/test_utils.py, 1e-2, on the losses and, in relative L2, on
# the weights), and its LAMB
AMP_BERT = dict(vocab_size=96, max_length=128, dropout=0.0, num_layers=2,
                units=64, hidden_size=128, num_heads=2)
AMP_LR = 1e-2
F16_TOL = 1e-2
# the optimizers' MLP, float32: losses within 1e-4 relative and each
# weight within 1e-4 in relative L2 (test_utils' float32 rtol) of the
# CPU's
OPT_MLP = dict(widths=(32, 64, 10), batch_size=16, steps=3)
OPT_TOL = 1e-4
NEW_OPTIMIZERS = [
    ("nag", {"momentum": 0.9}), ("adamw", {"beta1": 0.8}),
    ("adagrad", {}), ("adadelta", {"rho": 0.8}), ("rmsprop", {}),
    ("rmsprop", {"centered": True, "gamma2": 0.8}),
    ("ftrl", {"lamda1": 0.001}), ("signsgd", {}),
    ("signum", {"momentum": 0.8, "wd_lh": 0.01}),
    ("lamb", {"lower_bound": 0.01, "upper_bound": 10.0}), ("test", {})]
FUSED_RULES = ("nag", "rmsprop", "adamw", "adagrad")


@contextlib.contextmanager
def sdpa_plain_calls():
    """Count the calls of the attention's plain path (``sdpa_plain``)
    while inside: a list whose length is the count."""
    from mxnet_tpu_torch.ops import attention
    calls, plain = [], attention.sdpa_plain

    def counted(*args, **kwargs):
        calls.append(args[0].dtype)
        return plain(*args, **kwargs)
    attention.sdpa_plain = counted
    try:
        yield calls
    finally:
        attention.sdpa_plain = plain


def _amp_batch(mx, ctx, b=2, s=128, m=4, vocab=96):
    """A pretraining batch with key padding (the second row 37 short) as
    NDArrays on ``ctx``: (tokens, types, valid lengths, masked positions),
    MLM labels, NSP labels."""
    rng = np.random.RandomState(0)
    data = (rng.randint(0, vocab, (b, s)).astype("f4"),
            rng.randint(0, 2, (b, s)).astype("f4"),
            np.array([s] + [s - 37] * (b - 1), "f4"),
            rng.randint(0, s - 37, (b, m)).astype("f4"))
    labels = np.concatenate([rng.randint(0, vocab, (b, m)),
                             rng.randint(0, 2, (b, 1))], 1).astype("f4")
    return ([mx.nd.array(x, ctx=ctx) for x in data],
            mx.nd.array(labels[:, :m].reshape(-1), ctx=ctx),
            mx.nd.array(labels[:, m], ctx=ctx))


def amp_loop(mx, net, trainer, batch, steps, b):
    """The reference's fp16 AMP loop (record -> loss -> scale_loss ->
    backward -> unscale -> step unless it overflowed), ``steps`` times;
    returns [(loss, the scale it ran at, skipped)]."""
    from mxnet_tpu_torch import autograd
    from mxnet_tpu_torch.contrib import amp
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    sce = SoftmaxCrossEntropyLoss()
    args, mlm_label, nsp_label = batch
    out = []
    for _ in range(steps):
        scale = trainer._amp_loss_scaler.loss_scale
        with autograd.record():
            mlm, nsp = net(*args)
            loss = sce(mlm, mlm_label).mean() + sce(nsp, nsp_label).mean()
            with amp.scale_loss(loss, trainer) as scaled:
                scaled.backward()
        skipped = amp.unscale(trainer)
        if not skipped:
            trainer.step(b)
        out.append((loss, scale, bool(skipped)))
    return out


def _state_values(net):
    return {k: t.detach().float().cpu().numpy()
            for k, t in net.state_dict().items()}


def _amp_bert_parity(mx, dev, steps=3):
    """3 steps of the AMP loop on a tiny BERT with LAMB, card against
    CPU from the same weights."""
    from mxnet_tpu_torch import gluon, models
    from mxnet_tpu_torch.contrib import amp
    runs, start = [], None
    for ctx in (mx.cpu(), mx.gpu(0)):
        amp.init("float16")
        try:
            net = models.BERTForPretrain(models.bert_small(**AMP_BERT))
            net.initialize(mx.init.Xavier(), ctx=ctx, seed=3)
            if start is None:
                start = {k: t.detach().clone()
                         for k, t in net.state_dict().items()}
            else:
                net.load_state_dict(start)
            tr = gluon.Trainer(net.collect_params(), "lamb",
                               {"learning_rate": AMP_LR, "wd": 0.01})
            amp.init_trainer(tr)
            reset_counts()
            with sdpa_plain_calls() as plain:
                loop = amp_loop(mx, net, tr, _amp_batch(mx, ctx), steps, 2)
            runs.append(([(float(l.asnumpy()), s, k) for l, s, k in loop],
                         _state_values(net), read_counts(), len(plain)))
        finally:
            amp._deinit()
    (cpu, cpu_w, _, _), (card, card_w, launches, plain) = runs
    start = {k: t.float().numpy() for k, t in start.items()}
    loss_rel = max(abs(g[0] - c[0]) / abs(c[0]) for g, c in zip(card, cpu))
    zero_start = [k for k in cpu_w if not start[k].any()]
    rels = {k: _rel_l2([card_w[k]], [cpu_w[k]]) for k in cpu_w
            if k not in zero_start}
    bound = float(max(max(np.abs(card_w[k]).max(), np.abs(cpu_w[k]).max())
                      for k in zero_start))
    model_rel = _rel_l2(list(card_w.values()), list(cpu_w.values()))
    row = {"phase": "fp16_parity", "check": "bert_amp_lamb", "steps": steps,
           "cpu": cpu, "gpu": card, "loss_max_rel_diff": loss_rel,
           "weight_max_rel_l2": max(rels.values()),
           "weight_worst": max(rels, key=rels.get), "model_rel_l2": model_rel,
           "zero_start_max_abs": bound, "zero_start_bound": steps * AMP_LR,
           "tol": F16_TOL, "sdpa_plain_calls": plain, **launches}
    emit(row)
    check([c[1:] for c in card] == [c[1:] for c in cpu],
          f"fp16_parity: scales and skip flags {card} differ from the CPU's "
          f"{cpu}")
    check(loss_rel <= F16_TOL, f"fp16_parity: AMP losses differ by {loss_rel}")
    check(max(rels.values()) <= F16_TOL and model_rel <= F16_TOL,
          f"fp16_parity: weights differ: {row['weight_worst']} "
          f"{max(rels.values())}, model {model_rel}")
    check(bound <= steps * AMP_LR, f"fp16_parity: a tensor that starts at 0 "
          f"moved {bound}, past LAMB's bound {steps * AMP_LR}")
    check(plain == 0, f"fp16_parity: {plain} sdpa_plain calls on the card")
    ran = steps * AMP_BERT["num_layers"]
    check(launches["flash_fwd_tc_launches"] == ran
          and launches["flash_bwd_dq_tc_launches"] == ran
          and launches["flash_bwd_dkv_tc_launches"] == ran,
          f"fp16_parity: launches {launches}, want {ran} of K1-K3 each on "
          "the tensor cores")
    return row


def _mp_sgd_parity(mx, dev, steps=3):
    """A net cast to float16 with SGD momentum and multi_precision: the
    float32 master weights' change over ``steps`` steps, card against
    CPU, and each float16 weight the rounding of its master."""
    from mxnet_tpu_torch import autograd, gluon
    from mxnet_tpu_torch.gluon import nn
    rng = np.random.RandomState(1)
    x = rng.randn(16, 32).astype("f4")
    y = rng.randint(0, 10, 16).astype("f4")
    runs, start = [], None
    for ctx in (mx.cpu(), mx.gpu(0)):
        net = nn.HybridSequential()
        with net.name_scope():
            net.add(nn.Dense(64, activation="relu", in_units=32),
                    nn.Dense(10, in_units=64))
        net.initialize(mx.init.Xavier(), ctx=ctx, seed=2)
        params = list(net.collect_params().values())
        if start is None:
            start = [p.data().asnumpy() for p in params]
        for p, v in zip(params, start):
            p.set_data(mx.nd.array(v, ctx=ctx))
        net.cast("float16")
        tr = gluon.Trainer(net.collect_params(), "sgd",
                           {"learning_rate": 0.1, "momentum": 0.9,
                            "multi_precision": True})
        sce = gluon.loss.SoftmaxCrossEntropyLoss()
        xx = mx.nd.array(x, ctx=ctx).astype("float16")
        yy = mx.nd.array(y, ctx=ctx)
        for _ in range(steps):
            with autograd.record():
                loss = sce(net(xx), yy).mean()
            loss.backward()
            tr.step(1)
        states = tr._updater.states
        masters = [states[i][0].asnumpy() for i in range(len(params))]
        halves = [p.data().asnumpy() for p in params]
        runs.append((masters, halves))
    (cpu_m, _), (card_m, card_h) = runs
    moved = _rel_l2([g - s for g, s in zip(card_m, start)],
                    [c - s for c, s in zip(cpu_m, start)])
    exact = all(np.array_equal(h, m.astype("float16"))
                for h, m in zip(card_h, card_m))
    row = {"phase": "fp16_parity", "check": "mp_sgd_momentum",
           "steps": steps, "master_change_rel_l2": moved,
           "float16_is_master_rounding": exact, "tol": F16_TOL}
    emit(row)
    check(moved <= F16_TOL, f"fp16_parity: multi-precision masters moved "
          f"differently from the CPU's: {moved}")
    check(exact, "fp16_parity: a float16 weight is not its master's rounding")
    return row


def phase_fp16_parity(mx, dev):
    """F6 on the card: K1-K3's float16 route against the plain versions
    (BERT's shape, with and without key padding; Llama training's), the
    AMP loop on a tiny BERT with LAMB against the CPU, and multi-precision
    SGD against the CPU."""
    from mxnet_tpu_torch.contrib import amp
    rows = [_flash_case(c, dev, "fp16_parity", events_ms)
            for c in F16_FLASH_CASES]
    bwd_rows = [_flash_bwd_case(c, dev, "fp16_parity", events_ms)
                for c in F16_BWD_CASES]
    check(amp.target_dtype() is None, "fp16_parity: AMP left on")
    bert = _amp_bert_parity(mx, dev)
    mp = _mp_sgd_parity(mx, dev)
    return rows, bwd_rows, dict(bert=bert, mp=mp)


def _opt_mlp(mx, ctx, start=None):
    """The optimizers' MLP on ``ctx`` from ``start`` (numpy weights; made
    on the CPU from seed 4 when None)."""
    from mxnet_tpu_torch.gluon import nn
    w = OPT_MLP["widths"]
    net = nn.HybridSequential()
    with net.name_scope():
        net.add(nn.Dense(w[1], activation="tanh", in_units=w[0]),
                nn.Dense(w[2], in_units=w[1]))
    net.initialize(mx.init.Xavier(), ctx=ctx, seed=4)
    params = list(net.collect_params().values())
    if start is None:
        start = [p.data().asnumpy() for p in params]
    for p, v in zip(params, start):
        p.set_data(mx.nd.array(v, ctx=ctx))
    return net, start


def _opt_run(mx, ctx, name, kw, path, start):
    """``steps`` steps of optimizer ``name`` on the MLP through ``path``:
    "trainer" (record -> backward -> Trainer.step), "compile_step" or
    "dpt" (DataParallelTrainer(fuse_step=True)); (losses, weights, the
    captures)."""
    from mxnet_tpu_torch import autograd, gluon, parallel
    rng = np.random.RandomState(5)
    b = OPT_MLP["batch_size"]
    x = mx.nd.array(rng.randn(b, OPT_MLP["widths"][0]).astype("f4"), ctx=ctx)
    y = mx.nd.array(rng.randint(0, 10, b).astype("f4"), ctx=ctx)
    net, _ = _opt_mlp(mx, ctx, start)
    params = dict(learning_rate=0.01, wd=0.01, clip_gradient=1.0, **kw)
    sce = gluon.loss.SoftmaxCrossEntropyLoss()
    losses, captures = [], None
    if path == "dpt":
        dpt = parallel.DataParallelTrainer(
            net, sce, name, params,
            mesh=parallel.make_mesh({"dp": 1}, devices=[ctx.device]),
            fuse_step=True)
        losses = [float(dpt.step(x, y).asnumpy())
                  for _ in range(OPT_MLP["steps"])]
        captures = dpt.captures
    else:
        tr = gluon.Trainer(net.collect_params(), name, params)
        if path == "compile_step":
            cs = tr.compile_step(net, sce)
            losses = [float(cs.step(x, y).asnumpy().mean())
                      for _ in range(OPT_MLP["steps"])]
            captures = cs.captures
        else:
            for _ in range(OPT_MLP["steps"]):
                with autograd.record():
                    loss = sce(net(x), y)
                loss.backward()
                tr.step(b)
                losses.append(float(loss.asnumpy().mean()))
    return losses, [p.data().asnumpy()
                    for p in net.collect_params().values()], captures


def phase_optimizers_parity(mx, dev):
    """Each optimizer this port added, 3 steps of an MLP on the card
    against the CPU, through gluon.Trainer, compile_step (one capture on
    the card) and, for the four fused rules, DataParallelTrainer(
    fuse_step=True)."""
    from mxnet_tpu_torch.gluon import compiled_step
    compiled_step.clear_fallback_reports()
    _, start = _opt_mlp(mx, mx.cpu())
    rows = []
    for name, kw in NEW_OPTIMIZERS:
        paths = ["trainer", "compile_step"] + (
            ["dpt"] if name in FUSED_RULES and not kw.get("centered")
            else [])
        for path in paths:
            cpu = _opt_run(mx, mx.cpu(), name, kw, path, start)
            card = _opt_run(mx, mx.gpu(0), name, kw, path, start)
            loss_rel = max(abs(g - c) / abs(c)
                           for g, c in zip(card[0], cpu[0]))
            w_rel = max(_rel_l2([g], [c]) for g, c in zip(card[1], cpu[1]))
            moved = _rel_l2(cpu[1], start)
            row = {"phase": "optimizers_parity", "optimizer": name,
                   "kwargs": kw, "path": path, "cpu_losses": cpu[0],
                   "gpu_losses": card[0], "loss_max_rel_diff": loss_rel,
                   "weight_max_rel_l2": w_rel, "moved_rel_l2": moved,
                   "captures": card[2], "tol": OPT_TOL}
            emit(row)
            rows.append(row)
            check(loss_rel <= OPT_TOL and w_rel <= OPT_TOL,
                  f"optimizers_parity: {name} {kw} via {path}: losses "
                  f"{loss_rel}, weights {w_rel}")
            check(moved > 0, f"optimizers_parity: {name} moved nothing")
            if path != "trainer":
                check(card[2] == 1, f"optimizers_parity: {name} via {path}: "
                      f"{card[2]} captures, want 1")
    check_no_fallback("optimizers_parity")
    return rows


BERT_FP16 = dict(model="bert_base", vocab=30522, batch_size=64, seq_len=128,
                 num_masked=20, hidden=768, layers=12, steps=20, warmup=3,
                 max_length=512, lr=1e-4, wd=0.01)


def _bert_fp16_split(per_kernel):
    """A profiled step's device time by kind (ms): the flash kernels, the
    GEMMs, LAMB (the multi-tensor kernels and the norms they feed),
    the rest."""
    total = sum(per_kernel.values())
    flash = sum(t for k, t in per_kernel.items() if "flash_" in k)
    lamb = sum(t for k, t in per_kernel.items()
               if "multi_tensor_apply" in k or "lpnorm" in k.lower())
    gemm = sum(t for k, t in per_kernel.items()
               if _is_gemm(k) and "flash_" not in k)
    return {"device_ms": total, "flash_f16_ms": flash, "gemm_ms": gemm,
            "lamb_ms": lamb, "other_ms": total - flash - gemm - lamb}


def phase_bert_fp16(mx, dev, ctx, cfg=BERT_FP16):
    """BERT-base pretraining under fp16 AMP with the dynamic loss scaler
    and LAMB (You et al. 2019's large-batch recipe), through the
    reference's gluon AMP loop at bench_bert_pretrain's batch, the model
    hybridized: the two-window slope a step, samples/s, the busy share,
    a profiled step's split, peak memory, the loss-scale trajectory and
    the skipped steps; K1-K3 12 launches each a step in float16, no
    sdpa_plain call."""
    import torch
    from mxnet_tpu_torch import gluon, models
    from mxnet_tpu_torch.contrib import amp
    free_earlier_phases()
    mx.random.seed(0)
    b, m, layers = cfg["batch_size"], cfg["num_masked"], cfg["layers"]
    amp.init("float16")
    try:
        inner = models.BERTForPretrain(getattr(models, cfg["model"])(
            vocab_size=cfg["vocab"], max_length=cfg["max_length"],
            dropout=0.1))
        model = _full_len_pretrain(inner)
        model.initialize(mx.init.Xavier(), ctx=ctx)
        model.hybridize()
        tr = gluon.Trainer(model.collect_params(), "lamb",
                           {"learning_rate": cfg["lr"], "wd": cfg["wd"]})
        amp.init_trainer(tr)
        (tokens, types, positions), label = _pretrain_batch(
            mx, cfg["vocab"], b, cfg["seq_len"], m, ctx)
        batch = ([tokens, types, positions],
                 label[:, :m].reshape((-1,)), label[:, m])
        trail = []

        def step():
            (loss, scale, skipped), = amp_loop(mx, model, tr, batch, 1, b)
            trail.append((scale, skipped))
            return loss
        with sdpa_plain_calls() as plain:
            first = [float(step().asnumpy()) for _ in range(cfg["warmup"])]
            n1, n2 = 5, cfg["steps"]
            torch.cuda.reset_peak_memory_stats(dev)
            reset_counts()
            step_s, naive_s, windows, used, last = timed_windows(
                step, n1, n2, "bert_fp16")
            launches = read_counts()
            peak = torch.cuda.max_memory_allocated(dev)
            breakdown = profile_call(step)
            reps = 3
            us, counts = window_kernels(step, reps)
            whole = all(n % reps == 0 for n in counts.values())
            per_kernel = {k: t / reps / 1e3 for k, t in us.items()}
        skips = sum(s for _, s in trail)
        # the first warm-up step the scaler let through
        settled = next((i for i, (_, s) in enumerate(trail[:len(first)])
                        if not s), None)
    finally:
        amp._deinit()
    timed = n1 + n2
    row = {"phase": "bert_fp16", "model": cfg["model"],
           "dtype": "float16 AMP, dynamic loss scale", "optimizer": "lamb",
           "batch_size": b, "seq_len": cfg["seq_len"], "num_masked": m,
           "layers": layers, "path": "gluon loop, hybridized",
           "warmup_losses": first, "last_loss": last,
           "windows": [n1, n2], "window_s": windows,
           "step_ms": step_s * 1e3, "naive_step_ms": naive_s * 1e3,
           "timing": used, "samples_per_s": b / step_s,
           "device_busy_share": breakdown.get("device_busy_share"),
           "split": _bert_fp16_split(per_kernel) if whole
           else "not measured (the profiler lost events)",
           "breakdown": breakdown,
           "peak_mem_bytes": peak, "loss_scales": [s for s, _ in trail],
           "skipped": [k for _, k in trail], "skipped_steps": skips,
           "steps_run": len(trail), "sdpa_plain_calls": len(plain),
           "timed_steps": timed, **launches, "card": nvidia_smi()}
    emit(row)
    check(math.isfinite(last) and all(math.isfinite(v) for v in first),
          "bert_fp16: a loss is not finite")
    check(len(plain) == 0, f"bert_fp16: {len(plain)} sdpa_plain calls")
    check(settled is not None, f"bert_fp16: every warm-up step overflowed: "
          f"scales {row['loss_scales']}")
    check(last < first[settled], f"bert_fp16: the loss did not fall after "
          f"the scaler settled: {first} -> {last}")
    for k in ("flash_fwd_tc_launches", "flash_bwd_dq_tc_launches",
              "flash_bwd_dkv_tc_launches"):
        check(launches[k] == layers * timed,
              f"bert_fp16: {k} {launches[k]}, want {layers} x {timed}")
    return dict(launches, steps=timed, per_step=layers)


# -- phase 2: build -------------------------------------------------------------

def _kernel_name(mangled):
    """``flash_fwd_tc_kernel<bf16,64>`` from a mangled kernel name."""
    m = re.search(r"\d(flash_[a-z0-9_]*?_kernel)I((?:Li\d+E|f|13__nv_bfloat16|"
                  r"6__half)+)E", mangled)
    if m is None:
        return mangled
    args = [a or ("float" if f else "bf16" if b else "f16")
            for a, f, b, _ in re.findall(
                r"Li(\d+)E|(f)|(13__nv_bfloat16)|(6__half)", m.group(2))]
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


def phase_build(names=None):
    """Build the named sources (default: every one; one nvcc each, in
    parallel); per kernel ptxas' registers and spills and the HMMA
    instructions of its SASS.  Every tensor-core kernel must contain
    HMMA, and none may spill at a head dim <= 128.  The tile sizes the
    libraries export must equal the wrappers' constants."""
    from mxnet_tpu_torch import _kernels
    from mxnet_tpu_torch._kernels.build import _lib_path, _nvcc
    from mxnet_tpu_torch.ops import flash_attention as fa
    names = _kernels.sources() if names is None else names
    t0 = time.perf_counter()
    took = _kernels.build(names)
    seconds = time.perf_counter() - t0
    cuobjdump = os.path.join(os.path.dirname(_nvcc()), "cuobjdump")
    per_source = {}
    for n in names:
        kern = _ptxas_report(_kernels.build_log(n))
        sass = subprocess.run([cuobjdump, "-sass", _lib_path(n)],
                              capture_output=True, text=True, timeout=300)
        check(sass.returncode == 0, f"build: cuobjdump {n}: {sass.stderr}")
        for k, count in _hmma_counts(sass.stdout).items():
            kern.setdefault(k, {})["hmma"] = count
        per_source[n] = {"hmma": sum(v.get("hmma", 0) for v in kern.values()),
                         "kernels": kern}
    tiles, want = {}, {}
    if "flash_fwd" in names:
        fwd = fa._kernel()
        tiles["flash_fwd"] = [fwd.mxtpu_flash_fwd_block_q(),
                              fwd.mxtpu_flash_fwd_block_k()]
        want["flash_fwd"] = [fa.FWD_BLOCK_Q, fa.FWD_BLOCK_K]
    if "flash_bwd" in names:
        bwd = fa._bwd_kernels()
        tiles["flash_bwd"] = [bwd.mxtpu_flash_bwd_block_q(),
                              bwd.mxtpu_flash_bwd_block_k()]
        want["flash_bwd"] = [fa.BWD_BLOCK_Q, fa.BWD_BLOCK_K]
    emit({"phase": "build", "sources": names,
          "seconds": seconds, "per_source_s": took, "tiles": tiles,
          "per_source": per_source})
    for n, s in per_source.items():
        for k, v in s["kernels"].items():
            if "_tc_kernel" not in k:
                continue
            check(v.get("hmma", 0) > 0, f"build: {k} has no HMMA instruction")
            if int(re.search(r"(\d+)>", k).group(1)) <= 128:
                check(v.get("spill_stores") == 0 and v.get("spill_loads") == 0,
                      f"build: {k} spills: {v}")
    check(tiles == want,
          f"build: the libraries' tiles {tiles} differ from the wrappers' "
          f"{want}")


# -- the kernels line ------------------------------------------------------------

DESIGN = {
    "tensor_cores": "bf16: mma.sync m16n8k16 on the tensor cores (f32 "
                    "accumulate), 4 warps of 16 rows, tiles by 16-byte "
                    "cp.async, double-buffered, ldmatrix fragments",
    "cuda_cores": "f32 FMAs on the CUDA cores, 256 threads, tiles staged "
                  "in shared memory as f32",
    "tensor_cores_f16": "float16: the bf16 kernel's template with f16 "
                        "operands (mma.sync m16n8k16 .f16, f32 accumulate), "
                        "P and dS rounded to f16",
}


def _ratios(ms, library_ms, bound_ms):
    return {"kernel_over_library": ms / library_ms,
            "bound_over_kernel": bound_ms / ms}


def kernel_entries(rows, bwd_rows, train, serve, llama, f16_rows=(),
                   f16_bwd_rows=(), bert16=None):
    """The flash kernels' entries of the {"kernels": [...]} line: each
    at BERT's training shape in bf16 (the main path's route), with its
    f32 route's numbers at the same shape, K1 also at the serving
    prefill, and each at Llama-3-8B's training shape (``llama_train``:
    its numbers and its launches on that path); then each at BERT's
    shape in float16 (``fp16_parity``'s readings, ``bert_fp16``'s
    launches), with its key-padded and Llama-shaped readings."""
    fwd = {r["case"]: r for r in rows}
    bwd = {r["case"]: r for r in bwd_rows}
    head, serve_row = fwd.get(HEADLINE_CASE), fwd.get(SERVE_CASE)
    b16, b32 = bwd.get(BWD_HEADLINE_CASE), bwd.get("bert_b64_s128_f32")
    f32 = fwd.get("bert_b64_s128_lse_f32")
    l_fwd, l_bwd = fwd.get(LLAMA_TRAIN_CASE), bwd.get(LLAMA_TRAIN_BWD_CASE)
    src = "mxnet_tpu_torch/csrc/"
    entries = []

    def fwd_nums(r):
        return dict({"case": r["case"], "cores": r["cores"],
                     "max_abs_err": r["max_abs_err"],
                     "row_rel_err": r["scaled_err"]["row_rel_max"],
                     "rel_l2_err": r["scaled_err"]["rel_l2"],
                     "ms": r["kernel_ms"],
                     "launch_ms": r["launch_ms"], "plain_ms": r["plain_ms"],
                     "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                     "library_ms": r["library_ms"]},
                    **_ratios(r["kernel_ms"], r["library_ms"], r["bound_ms"]))

    def bwd_nums(r, part):
        err = (r["max_abs_err"]["dq"] if part == "dq" else
               max(r["max_abs_err"]["dk"], r["max_abs_err"]["dv"]))
        ms, est = r[f"{part}_ms"], r[f"library_{part}_share_est_ms"]
        outs = ("dq",) if part == "dq" else ("dk", "dv")
        sc = [r["scaled_err"][o] for o in outs]
        return {"case": r["case"], "cores": r[f"{part}_cores"],
                "max_abs_err": err,
                "row_rel_err": max(e["row_rel_max"] for e in sc),
                "rel_l2_err": max(e["rel_l2"] for e in sc), "ms": ms,
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
    def on_llama(nums, counter):
        return dict(nums, launches=llama.get(counter),
                    launches_per_step=llama.get("per_step"))
    f16 = {r["case"]: r for r in f16_rows}
    f16b = {r["case"]: r for r in f16_bwd_rows}
    if F16_CASE in f16 and BWD_F16_CASE in f16b:
        bert16 = bert16 or {}
        for name, part, site, counter in (
                ("flash_fwd", None, 76, "flash_fwd_tc_launches"),
                ("flash_bwd_dq", "dq", 303, "flash_bwd_dq_tc_launches"),
                ("flash_bwd_dkv", "dkv", 386, "flash_bwd_dkv_tc_launches")):
            def nums(case, part=part):
                return fwd_nums(f16[case]) if part is None \
                    else bwd_nums(f16b[case], part)
            entries.append(dict(
                {"name": name + "_f16", "route": "cuda",
                 "design": DESIGN["tensor_cores_f16"],
                 "source": src + ("flash_fwd.cu" if part is None
                                  else "flash_bwd.cu"),
                 "replaces": f"mxnet_tpu/ops/flash_attention.py:{site}",
                 "dtype": "float16", "launches": bert16.get(counter),
                 "launches_main_path": "bert_fp16",
                 "launches_per_step": bert16.get("per_step"),
                 "key_padding": nums("bert_b64_s128_kpad_lse_f16"
                                     if part is None
                                     else "bert_b64_s128_kpad_f16"),
                 "llama_train_shape": nums("llama_train_s4096_lse_f16"
                                           if part is None
                                           else "llama_train_s4096_f16")},
                **nums(F16_CASE if part is None else BWD_F16_CASE)))
    if None in (head, serve_row, b16, b32, f32, l_fwd, l_bwd):
        return entries
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
              "launches_per_replay": train.get("per_replay", {}).get(
                  "flash_fwd_launches"),
              "serve_launches": serve.get("launches"),
              "generate_fused_launches": serve.get(
                  "generate_fused_launches"),
              "serve": fwd_nums(serve_row),
              "llama_train": on_llama(fwd_nums(l_fwd),
                                      "flash_fwd_tc_launches"),
              "f32": dict(fwd_nums(f32), design=DESIGN["cuda_cores"])},
             **fwd_nums(head)),
        dict({"name": "flash_bwd_dq", "route": "cuda",
              "design": DESIGN["tensor_cores"],
              "source": src + "flash_bwd.cu",
              "replaces": "mxnet_tpu/ops/flash_attention.py:303",
              "launches": train.get("flash_bwd_dq_launches"),
              "tc_launches": train.get("flash_bwd_dq_tc_launches"),
              "launches_per_replay": train.get("per_replay", {}).get(
                  "flash_bwd_dq_launches"),
              "llama_train": on_llama(bwd_nums(l_bwd, "dq"),
                                      "flash_bwd_dq_tc_launches"),
              "f32": dict(bwd_nums(b32, "dq"), design=DESIGN["cuda_cores"]),
              "plain_and_library": whole}, **bwd_nums(b16, "dq")),
        dict({"name": "flash_bwd_dkv", "route": "cuda",
              "design": DESIGN["tensor_cores"],
              "source": src + "flash_bwd.cu",
              "replaces": "mxnet_tpu/ops/flash_attention.py:386",
              "launches": train.get("flash_bwd_dkv_launches"),
              "tc_launches": train.get("flash_bwd_dkv_tc_launches"),
              "launches_per_replay": train.get("per_replay", {}).get(
                  "flash_bwd_dkv_launches"),
              "llama_train": on_llama(bwd_nums(l_bwd, "dkv"),
                                      "flash_bwd_dkv_tc_launches"),
              "f32": dict(bwd_nums(b32, "dkv"), design=DESIGN["cuda_cores"]),
              "plain_and_library": whole}, **bwd_nums(b16, "dkv")),
    ] + entries


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

    # float32 matmuls in full float32, as the kernel's contract (PyTorch's
    # default); cuDNN's TF32 flag stays at PyTorch's default (on): the
    # port's convolutions turn it off themselves, which resnet_parity holds.
    # float16 products accumulate in float32, as the reference's: AMP's
    # init("float16") turns cuBLAS's reduced-precision reduction off
    # itself, and here it is off for the float16 nets outside AMP too
    # (fp16_parity's multi-precision net)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction = False
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
        # serving alone runs only the forward kernel: build only K1
        phase_build(["flash_fwd"] if phases <= SERVING_PHASES else None)

    rows, bwd_rows = phase_kernels(dev) if "kernels" in phases \
        else ([], [])
    if "parity" in phases:
        phase_parity(mx, dev)
    serve = phase_serve(mx, dev) if "serve" in phases else {}
    if "train_parity" in phases:
        phase_train_parity(mx, dev)
    if "train_capture_parity" in phases:
        phase_train_capture_parity(mx, dev)
    if "dropout" in phases:
        phase_dropout(mx, dev)
    train = phase_train(mx, dev, mx.gpu(0)) if "train" in phases \
        else {}
    if "imperative_parity" in phases:
        phase_imperative_parity(mx, dev)
    if "imperative" in phases:
        phase_imperative(mx, dev)
    rtc = phase_rtc(mx, dev) if "rtc" in phases else None
    if "resnet_parity" in phases:
        phase_resnet_parity(mx, dev)
    if "resnet" in phases:
        phase_resnet(mx, dev)
    if "llama_train_parity" in phases:
        phase_llama_train_parity(mx, dev)
    llama = phase_llama_train(mx, dev) if "llama_train" in phases else {}
    if "forecast_parity" in phases:
        phase_forecast_parity(mx, dev)
    if "forecast" in phases:
        phase_forecast(mx, dev)
    if "gan_parity" in phases:
        phase_gan_parity(mx, dev)
    if "gan" in phases:
        phase_gan(mx, dev)
    if "wordlm_parity" in phases:
        phase_wordlm_parity(mx, dev)
    if "wordlm" in phases:
        phase_wordlm(mx, dev)
    if "data" in phases:
        phase_data(mx, dev)
    f16_rows, f16_bwd_rows = [], []
    if "fp16_parity" in phases:
        f16_rows, f16_bwd_rows, _ = phase_fp16_parity(mx, dev)
    if "optimizers_parity" in phases:
        phase_optimizers_parity(mx, dev)
    bert16 = phase_bert_fp16(mx, dev, mx.gpu(0)) if "bert_fp16" in phases \
        else {}

    kernels = kernel_entries(rows, bwd_rows, train, serve, llama, f16_rows,
                             f16_bwd_rows, bert16)
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
