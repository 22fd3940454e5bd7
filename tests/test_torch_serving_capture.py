"""What a CUDA graph needs of the serving bodies, held on the CPU.

A captured body (the Server's prefill, one-step decode and K-step
decode, and ``generate_fused``) is replayed with the values it was
captured with, so it may neither read a value on the host (a sync:
``.item()``, ``nonzero``) nor bring host data into the device (a tensor
made from numpy), and every value that changes between calls must reach
it as a tensor.  ``_StepOps`` (after ``test_torch_compiled_step.py``'s,
with host data added) runs a body under a ``TorchDispatchMode`` that
fails on either and records every op with its non-tensor arguments:
call 1's and call 5's must be equal.

Also: the token sampler (``ops.random_ops.pick_tokens``) against its
distribution and the JAX Server's greedy rows, and the two repairs on
the path (``sdpa_plain``'s scale, the rolling prefill's permutation).
"""
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import mxnet_tpu as jmx
from mxnet_tpu.models import LlamaForCausalLM as JaxLM
from mxnet_tpu.models import llama_tiny as jax_llama_tiny
from mxnet_tpu.serving import Server as JaxServer
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import _capture
from mxnet_tpu_torch.models import LlamaForCausalLM, get_llama, \
    load_jax_params
from mxnet_tpu_torch.ops.attention import _round_scale, sdpa_plain
from mxnet_tpu_torch.ops.random_ops import pick_tokens
from mxnet_tpu_torch.serving import Server

aten = torch.ops.aten
V = 61
CPU = mx.cpu()

# a host sync, or host data entering the body (``lift_fresh``: a tensor
# made from numpy or a Python list, a blocking copy on the card)
_SYNCS = (aten._local_scalar_dense, aten.nonzero, aten.is_nonzero,
          aten.lift_fresh)


def _plain(x):
    """``x`` with every tensor replaced by its kind: what a graph keeps
    of an op's arguments besides the tensors' memory."""
    if isinstance(x, torch.Tensor):
        return ("tensor", x.dtype, tuple(x.shape))
    if isinstance(x, (list, tuple)):
        return tuple(_plain(v) for v in x)
    if isinstance(x, dict):
        return tuple(sorted((k, _plain(v)) for k, v in x.items()))
    if isinstance(x, torch.Generator):
        # the dispatcher hands over a new Python object each call
        return ("generator", x.device, x.initial_seed())
    return x


class _StepOps(TorchDispatchMode):
    """Fails on a host sync or host data; records every op with its
    non-tensor arguments."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func.overloadpacket in _SYNCS:
            raise AssertionError(f"host sync in the body: {func}")
        self.ops.append((str(func), _plain(args), _plain(kwargs)))
        return func(*args, **kwargs)


@pytest.fixture
def recorded_bodies(monkeypatch):
    """Runs call 1 and call 5 of every StepCapture's body under
    ``_StepOps``; yields {(capture name, call): ops}."""
    seen, calls = {}, {}
    run = _capture.StepCapture.run

    def recording(self, body, tensors, static_key=(), generator=None):
        n = calls[id(self)] = calls.get(id(self), 0) + 1
        if n not in (1, 5):
            return run(self, body, tensors, static_key, generator)

        def rec(*args):
            with _StepOps() as mode:
                out = body(*args)
            seen[(self.name, n)] = mode.ops
            return out
        return run(self, rec, tensors, static_key, generator)
    monkeypatch.setattr(_capture.StepCapture, "run", recording)
    yield seen


def _same_ops(seen, name):
    first, fifth = seen[(name, 1)], seen[(name, 5)]
    assert len(first) > 20
    assert first == fifth


@pytest.fixture(scope="module")
def nets():
    jmx.random.seed(0)
    jlm = JaxLM(jax_llama_tiny(vocab_size=V))
    jlm.initialize(jmx.init.Xavier())
    lm = LlamaForCausalLM(get_llama("llama_tiny", vocab_size=V), ctx=CPU)
    load_jax_params(lm, {k: p.data().asnumpy()
                         for k, p in jlm.collect_params().items()})
    return jlm, lm


def _prompt(seed, n):
    return np.random.RandomState(seed).randint(0, V, n).astype("f4")


# -- the captured bodies -------------------------------------------------------

@pytest.mark.parametrize("top_k", [0, 5])
def test_server_bodies_no_host_sync_and_no_baked_value(nets,
                                                       recorded_bodies,
                                                       top_k):
    """The prefill (other prompts, lengths, slots and temperatures), the
    one-step decode and the 3-step decode (other tokens, offsets, active
    slots) of one bucket: no host sync, the same ops and arguments at
    call 1 and call 5."""
    _, lm = nets
    srv = Server(lm, buckets=[(2, 8)], max_new_tokens=16, top_k=top_k,
                 ctx=CPU)
    for i, n in enumerate((5, 8, 3, 7, 6, 2)):
        srv.submit(_prompt(70 + i, n), temperature=0.5 * (i % 3))
    srv.run()
    srv.generate([_prompt(80, 4), _prompt(81, 6)], temperature=0.8,
                 decode_steps=3)
    for name in ("Server_b2x8_prefill", "Server_b2x8_decode",
                 "Server_b2x8_decode3"):
        _same_ops(recorded_bodies, name)


@pytest.mark.parametrize("mode", ["greedy", "sampled_rolling"])
def test_generate_fused_body_no_host_sync_and_no_baked_value(
        recorded_bodies, mode):
    """``generate_fused``'s body at five calls with other prompts (and
    temperatures): no host sync, the same ops and arguments.  The
    rolling case (mistral_tiny, a 128-token prompt past its 32-position
    window) runs the prefill's slot permutation."""
    name = "llama_tiny" if mode == "greedy" else "mistral_tiny"
    mx.random.seed(0)
    lm = LlamaForCausalLM(get_llama(name, vocab_size=V), ctx=CPU)
    lm.initialize(std=0.3, seed=1)
    kw = dict(max_new_tokens=4, rolling=mode != "greedy", seed=3)
    for i in range(5):
        tok = torch.from_numpy(np.random.RandomState(i).randint(
            0, V, (2, 128)).astype("f4"))
        if mode == "greedy":
            lm.generate_fused(tok, **kw)
        else:
            lm.generate_fused(tok, temperature=0.5 + 0.25 * i, top_k=9,
                              **kw)
    (cap_name,) = {n for n, _ in recorded_bodies}
    assert cap_name.startswith("generate_fused")
    _same_ops(recorded_bodies, cap_name)


@pytest.mark.parametrize("fails", [False, True])
def test_capture_runs_with_the_garbage_collector_off(monkeypatch, fails):
    """A collection during a capture could destroy a dead owner's graph,
    which CUDA refuses mid-capture (it invalidates the capture): the
    collector is off while the body is captured and on again after,
    also when the capture fails.  The CUDA calls are stand-ins here."""
    import gc
    from mxnet_tpu_torch.base import MXNetError

    class FakeGraph:
        def register_generator_state(self, gen):
            pass

    class FakeCapture:
        def __init__(self, graph, stream=None):
            pass

        def __enter__(self):
            seen.append(("enter", gc.isenabled()))

        def __exit__(self, *exc):
            return False
    seen = []
    monkeypatch.setattr(torch.cuda, "CUDAGraph", FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph", FakeCapture)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: None)
    monkeypatch.setattr(torch.cuda, "memory_reserved", lambda *a: 0)
    monkeypatch.setattr(_capture.StepCapture, "_stream", lambda s, d: None)

    def body(x):
        seen.append(("body", gc.isenabled()))
        if fails:
            raise RuntimeError("capture invalidated")
        return (x + 1,)
    cap = _capture.StepCapture("gc")
    assert gc.isenabled()
    if fails:
        with pytest.raises(MXNetError, match="could not be captured"):
            cap._capture(body, [torch.zeros(2)], (), None)
    else:
        g = cap._capture(body, [torch.zeros(2)], (), None)
        assert torch.equal(g.outputs[0], torch.ones(2))
    assert seen == [("enter", False), ("body", False)]
    assert gc.isenabled()


# -- the repairs on the path ---------------------------------------------------

def test_sdpa_plain_decode_has_no_host_sync():
    """A decode-shaped call (one query over a masked cache, GQA): the
    scale is rounded on the host, with no torch op."""
    rng = np.random.RandomState(0)
    q = torch.from_numpy(rng.randn(2, 1, 4, 16).astype("f4"))
    k = torch.from_numpy(rng.randn(2, 24, 2, 16).astype("f4"))
    v = torch.from_numpy(rng.randn(2, 24, 2, 16).astype("f4"))
    mask = torch.arange(24).reshape(1, 1, 1, 24) <= torch.tensor(
        [[[[10]]], [[[20]]]])
    want = sdpa_plain(q, k, v, mask, 0.25, False)
    with _StepOps():
        got = sdpa_plain(q, k, v, mask, 0.25, False)
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16, torch.float64])
def test_round_scale_matches_torch(dtype):
    scales = [1 / np.sqrt(d) for d in (16, 64, 72, 80, 128, 256)]
    scales += list(np.random.RandomState(1).rand(2000) * 4)
    for s in scales:
        assert _round_scale(s, dtype) == torch.tensor(s, dtype=dtype).item()


def test_rolling_prefill_has_no_host_data():
    """A prompt longer than the rolling cache: the slot permutation is
    built on the device, and the caches hold the newest position p at
    slot p mod C, as the plain write of each position would."""
    lm = LlamaForCausalLM(get_llama("mistral_tiny", vocab_size=V), ctx=CPU)
    lm.initialize(std=0.3, seed=2)
    tok = torch.from_numpy(np.random.RandomState(3).randint(
        0, V, (1, 100)).astype("f4"))
    full = lm.init_cache(1, 100)
    lm.prefill(tok, full)
    caches = lm.init_cache(1, 104, rolling=True)      # C = 32
    with _StepOps():
        lm.prefill(tok, caches)
    for (rk, rv), (fk, fv) in zip(caches, full):
        for p in range(100 - 32, 100):
            assert torch.equal(rk[0, p % 32], fk[0, p])
            assert torch.equal(rv[0, p % 32], fv[0, p])


# -- the sampler -----------------------------------------------------------------

def test_pick_tokens_seeded_topk_and_greedy_rows():
    """Seeded draws repeat; a sampled row draws inside its top-k set; a
    row at temperature 0 is its argmax."""
    rng = np.random.RandomState(4)
    logits = torch.from_numpy(rng.randn(64, 50).astype("f4") * 3)
    temps = torch.from_numpy(np.where(np.arange(64) % 4 == 0, 0.0,
                                      1.5).astype("f4"))
    draws = []
    for _ in range(2):
        g = torch.Generator().manual_seed(9)
        draws.append(pick_tokens(logits, temps, 5, g))
    assert torch.equal(draws[0], draws[1]) and draws[0].dtype == torch.float32
    top5 = torch.topk(logits, 5, dim=-1).indices
    tok = draws[0].long()
    assert (top5 == tok[:, None]).any(dim=1).all()
    greedy = temps == 0
    assert torch.equal(tok[greedy], logits.argmax(-1)[greedy])
    assert not torch.equal(tok[~greedy], logits.argmax(-1)[~greedy])


def test_pick_tokens_distribution():
    """Gumbel-max draws follow softmax(logits / T) truncated to the top
    k: 40,000 draws of one row, each class within 0.01 of its
    probability."""
    lg = torch.tensor([1.0, 0.5, 0.0, -0.5, -3.0, 2.0])
    n, t, k = 40000, 0.8, 4
    g = torch.Generator().manual_seed(0)
    tok = pick_tokens(lg.expand(n, -1), torch.full((n,), t), k, g).long()
    freq = torch.bincount(tok, minlength=6).double() / n
    want = torch.softmax(lg.double() / t, -1)
    want[torch.argsort(lg)[:6 - k]] = 0.0
    want /= want.sum()
    assert (freq - want).abs().max() < 0.01, (freq, want)


def test_mixed_batch_greedy_rows_equal_jax(nets):
    """A greedy request decoded beside sampled ones gives the JAX
    Server's greedy tokens."""
    jlm, lm = nets
    pg = _prompt(90, 6)
    want = JaxServer(jlm, buckets=[(4, 8)], max_new_tokens=7).generate(
        [pg])[0]
    mx.random.seed(5)
    srv = Server(lm, buckets=[(4, 8)], max_new_tokens=7, top_k=9, ctx=CPU)
    srv.submit(_prompt(91, 4), temperature=1.0)
    rg = srv.submit(pg)
    srv.submit(_prompt(92, 8), temperature=0.6)
    srv.run(decode_steps=3)
    np.testing.assert_array_equal(rg.tokens(), want)


def test_server_sampled_run_repeats_after_reseed(nets):
    """``mx.random.seed`` before each run: the same sampled tokens, in
    range, with one-step and K-step decode alike."""
    _, lm = nets
    prompts = [_prompt(93, 5), _prompt(94, 3), _prompt(95, 8)]
    outs = []
    for k in (1, 1, 4, 4):
        mx.random.seed(7)
        srv = Server(lm, buckets=[(2, 8)], max_new_tokens=6, top_k=12,
                     ctx=CPU)
        outs.append(srv.generate(prompts, temperature=1.2, decode_steps=k))
    for a, b in zip(outs[0], outs[1]):
        np.testing.assert_array_equal(a, b)
        assert ((a >= 0) & (a < V)).all()
    for a, b in zip(outs[2], outs[3]):
        np.testing.assert_array_equal(a, b)
