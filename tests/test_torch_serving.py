"""The port's serving plane: scheduler, KV-cache pool and Server.

The scheduler tests mirror the JAX package's; the Server is held to
the JAX ``Server`` and to the port's own ``generate`` with the same
weights (copied by ``load_jax_params``): greedy tokens equal exactly,
with one decode step a dispatch and with ``decode_steps=K``.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu.models import LlamaForCausalLM as JaxLM
from mxnet_tpu.models import llama_tiny as jax_llama_tiny
from mxnet_tpu.serving import Server as JaxServer
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import telemetry
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.models import LlamaForCausalLM, llama_tiny, \
    load_jax_params
from mxnet_tpu_torch.serving import BucketScheduler, KVCachePool, \
    Request, Server

V = 61
CPU = mx.cpu()


@pytest.fixture(scope="module")
def nets():
    jmx.random.seed(0)
    jlm = JaxLM(jax_llama_tiny(vocab_size=V))
    jlm.initialize(jmx.init.Xavier())
    lm = LlamaForCausalLM(llama_tiny(vocab_size=V), ctx=CPU)
    load_jax_params(lm, {k: p.data().asnumpy()
                         for k, p in jlm.collect_params().items()})
    return jlm, lm


@pytest.fixture(scope="module")
def net(nets):
    return nets[1]


def _prompt(seed, n):
    return np.random.RandomState(seed).randint(0, V, n).astype("f4")


def _server(lm, **kw):
    return Server(lm, ctx=CPU, **kw)


# -- scheduler core (host logic) ----------------------------------------------

def test_bucket_selection():
    """A request lands in the SMALLEST bucket holding its prompt."""
    s = BucketScheduler([(2, 32), (2, 8)], max_new_tokens=4, max_queue=8)
    assert [b.prompt_len for b in s.buckets] == [8, 32]
    assert s.select_bucket(3).prompt_len == 8
    assert s.select_bucket(8).prompt_len == 8
    assert s.select_bucket(9).prompt_len == 32
    assert s.select_bucket(33) is None
    with pytest.raises(MXNetError, match="largest bucket"):
        s.enqueue(Request(np.zeros(40), 4))


def test_admit_evict_finish_matrix():
    """Fill every slot, block the overflow in the queue, free slots by
    finish AND evict, watch FIFO admission refill them."""
    s = BucketScheduler([(2, 8)], max_new_tokens=4, max_queue=8)
    reqs = [Request(np.ones(4), 4) for _ in range(5)]
    for r in reqs:
        s.enqueue(r)
    adm = s.admissions()
    assert [r.id for _, _, r in adm] == [reqs[0].id, reqs[1].id]
    assert s.queue_depth() == 3
    assert s.buckets[0].n_active() == 2
    assert s.admissions() == []
    s.finish(reqs[0])
    s.evict(reqs[1], reason="test")
    assert reqs[1].state == "evicted"
    adm2 = s.admissions()
    assert [r.id for _, _, r in adm2] == [reqs[2].id, reqs[3].id]
    reqs[2].generated = [5]
    s.evict(reqs[2], reason="preempt", requeue=True)
    assert reqs[2].state == "queued" and reqs[2].generated == []
    assert s.queue[0] is reqs[2]
    b = s.buckets[0]
    free = [j for j, r in enumerate(b.requests) if r is None]
    assert all(b.active[j] == 0 and b.offsets[j] == 0 for j in free)


def test_queue_bound():
    s = BucketScheduler([(1, 8)], max_new_tokens=4, max_queue=2)
    s.enqueue(Request(np.ones(4), 4))
    s.enqueue(Request(np.ones(4), 4))
    with pytest.raises(MXNetError, match="queue full"):
        s.enqueue(Request(np.ones(4), 4))


def test_kvcache_pool_contract(net):
    pool = KVCachePool(net, slots=2, cache_len=8, ctx=CPU)
    flat = pool.flat()
    assert len(flat) == 2 * len(net.model.layers)
    assert flat[0].shape == (2, 8, 2, 16)    # tiny GQA: 2 kv heads, d 16
    assert all(t.dtype == torch.float32 for t in flat)
    flat[0].fill_(3.0)
    pool.reset()
    assert all((t == 0).all() for t in pool.flat())
    with pytest.raises(MXNetError, match="floating"):
        KVCachePool(net, slots=1, cache_len=8, ctx=CPU, dtype="int32")


# -- serving correctness -------------------------------------------------------

def test_admission_writes_its_slot_page(net):
    """An admission copies its prefilled page into positions [0, S) of
    its own slot: each slot holds what a prefill of its padded prompt
    writes, and nothing lands past S."""
    srv = _server(net, buckets=[(2, 8)], max_new_tokens=1)
    prompts = [_prompt(62, 5), _prompt(63, 8)]
    reqs = [srv.submit(p) for p in prompts]
    srv.step()                            # two admissions, both done
    assert [r.slot for r in reqs] == [None, None]
    assert all(r.state == "done" for r in reqs)
    pool = srv._pools[(2, 8)]
    for slot, p in enumerate(prompts):
        padded = np.zeros((1, 8), "f4")
        padded[0, :len(p)] = p
        want = net.init_cache(1, 8)
        net.prefill(torch.from_numpy(padded), want,
                    last_pos=torch.tensor([len(p) - 1.0]))
        for (k, v), (wk, wv) in zip(pool.pairs(), want):
            assert torch.equal(k[slot, :8], wk[0])
            assert torch.equal(v[slot, :8], wv[0])
            assert (k[slot, 8:] == 0).all() and (v[slot, 8:] == 0).all()


def test_greedy_parity_with_jax_server_and_generate(nets):
    """Continuously batched greedy decode reproduces the JAX Server and
    the port's single-request generate token for token, across prompt
    lengths sharing one bucket."""
    jlm, lm = nets
    prompts = [_prompt(0, 5), _prompt(1, 8), _prompt(2, 2)]
    outs = _server(lm, buckets=[(2, 8)], max_new_tokens=6).generate(prompts)
    jouts = JaxServer(jlm, buckets=[(2, 8)],
                      max_new_tokens=6).generate(prompts)
    for p, out, jout in zip(prompts, outs, jouts):
        np.testing.assert_array_equal(out, jout)
        ref = lm.generate(p[None], max_new_tokens=6).numpy()[0]
        np.testing.assert_array_equal(out, ref)


def test_flash_bucket_parity_with_jax_server(nets):
    """A 128-token bucket: every admission's prefill takes the flash
    path (its plain version on the CPU)."""
    jlm, lm = nets
    prompts = [_prompt(30, 128), _prompt(31, 77), _prompt(32, 100)]
    outs = _server(lm, buckets=[(2, 128)],
                   max_new_tokens=4).generate(prompts)
    jouts = JaxServer(jlm, buckets=[(2, 128)],
                      max_new_tokens=4).generate(prompts)
    for out, jout in zip(outs, jouts):
        np.testing.assert_array_equal(out, jout)


def test_evicted_slot_garbage_never_leaks(net):
    """A request decoded next to an evicted neighbor's stale K/V gives
    exactly the tokens it gives alone."""
    pa, pb = _prompt(3, 6), _prompt(4, 7)
    ref = _server(net, buckets=[(2, 8)], max_new_tokens=6).generate([pa])[0]
    srv = _server(net, buckets=[(2, 8)], max_new_tokens=6)
    ra = srv.submit(pa)
    rb = srv.submit(pb)
    srv.step()                       # both admitted, one decode step
    assert srv.evict(rb, reason="preempt")
    srv.run()
    np.testing.assert_array_equal(ra.tokens(), ref)
    assert rb.state == "evicted"


def test_model_level_row_isolation(net):
    """Per-slot decode logits are bitwise independent of the other
    rows' cache contents."""
    toks = torch.from_numpy(_prompt(5, 2).reshape(2, 1))
    off = torch.tensor([3.0, 3.0])
    rng = np.random.RandomState(0)
    c_zero, c_garb = [], []
    for k, v in net.init_cache(2, 8):
        kz, vz = k.numpy().copy(), v.numpy().copy()
        kz[0] = rng.randn(*kz[0].shape)
        vz[0] = rng.randn(*vz[0].shape)
        kg, vg = kz.copy(), vz.copy()
        kg[1] = rng.randn(*kg[1].shape) * 1e3
        vg[1] = rng.randn(*vg[1].shape) * 1e3
        c_zero.append((torch.from_numpy(kz), torch.from_numpy(vz)))
        c_garb.append((torch.from_numpy(kg), torch.from_numpy(vg)))
    l_zero = net.decode_step(toks, c_zero, off).numpy()
    l_garb = net.decode_step(toks, c_garb, off).numpy()
    np.testing.assert_array_equal(l_zero[0], l_garb[0])
    assert np.abs(l_zero[1] - l_garb[1]).max() > 0


def test_sampling_seeded_and_in_range(net):
    """Temperature/top-k sampling draws from the seeded device stream:
    same seed, same tokens; all tokens valid; a greedy row in a mixed
    batch stays greedy."""
    prompts = [_prompt(6, 4), _prompt(7, 6)]
    mx.random.seed(42)
    o1 = _server(net, buckets=[(2, 8)], max_new_tokens=5,
                 top_k=10).generate(prompts, temperature=1.0)
    mx.random.seed(42)
    o2 = _server(net, buckets=[(2, 8)], max_new_tokens=5,
                 top_k=10).generate(prompts, temperature=1.0)
    for a, b in zip(o1, o2):
        np.testing.assert_array_equal(a, b)
        assert (a >= 0).all() and (a < V).all()
    s3 = _server(net, buckets=[(2, 8)], max_new_tokens=5, top_k=10)
    rg = s3.submit(prompts[0], temperature=0.0)
    s3.submit(prompts[1], temperature=1.0)
    s3.run()
    ref = net.generate(prompts[0][None], max_new_tokens=5).numpy()[0]
    np.testing.assert_array_equal(rg.tokens(), ref)


def test_eos_finishes_early(net):
    """A request stops at its eos token and frees the slot."""
    p = _prompt(8, 4)
    gen = _server(net, buckets=[(1, 8)],
                  max_new_tokens=6).generate([p])[0][len(p):].astype(int)
    eos, stop_at = int(gen[-1]), int(np.nonzero(gen == gen[-1])[0][0])
    srv = _server(net, buckets=[(1, 8)], max_new_tokens=6, eos_id=eos)
    req = srv.submit(p)
    srv.run()
    assert req.state == "done"
    assert len(req.generated) == stop_at + 1
    assert req.generated[-1] == eos
    assert srv.sched.buckets[0].n_active() == 0


def test_evict_after_finish_is_noop(net):
    """Evicting a request that already finished must not wipe its
    output, flip its state, or leave an eviction's audit trail."""
    telemetry.reset()
    srv = _server(net, buckets=[(1, 4)], max_new_tokens=2)
    r = srv.submit(_prompt(27, 3))
    srv.run()
    assert r.state == "done"
    before = r.tokens().copy()
    assert srv.evict(r, reason="late") is False
    assert r.state == "done"
    np.testing.assert_array_equal(r.tokens(), before)
    snap = telemetry.snapshot()["counters"]
    assert snap.get("mxtpu_serving_requests_evicted_total", 0) == 0
    assert telemetry.events("request_evicted") == []


def test_stats_count_prefills_and_decode_steps(net):
    srv = _server(net, buckets=[(2, 8)], max_new_tokens=3)
    srv.generate([_prompt(40, 3), _prompt(41, 5)])
    st = srv.stats()
    b = st["buckets"]["2x8"]
    assert b["prefills"] == 2
    assert b["decode_steps"] == 2        # both advance in lockstep
    assert b["decode_dispatches"] == 2
    assert b["tokens"] == 6
    assert st["occupancy"] == 0.0 and st["queue_depth"] == 0
    # no graph on the CPU: the bodies run eagerly
    assert (st["captures"], st["replays"], st["graph_pool_bytes"]) == \
        (0, 0, 0)
    assert (b["steady_dispatches"], b["steady_misses"]) == (0, 0)
    srv.generate([_prompt(42, 4)], decode_steps=2)
    b = srv.stats()["buckets"]["2x8"]
    assert (b["decode_steps"], b["decode_dispatches"]) == (4, 3)


# -- decode_steps=K: K decode steps a dispatch ---------------------------------

@pytest.mark.parametrize("k", [1, 4, 7])
def test_decode_steps_parity_with_jax_server(nets, k):
    """``generate(..., decode_steps=K)``: the same greedy tokens as the
    port's one-step decode and as the JAX Server's K-step programs,
    across admissions into freed slots (four prompts, two slots)."""
    jlm, lm = nets
    prompts = [_prompt(50, 5), _prompt(51, 8), _prompt(52, 3),
               _prompt(53, 7)]
    one = _server(lm, buckets=[(2, 8)], max_new_tokens=8).generate(prompts)
    outs = _server(lm, buckets=[(2, 8)],
                   max_new_tokens=8).generate(prompts, decode_steps=k)
    jouts = JaxServer(jlm, buckets=[(2, 8)], max_new_tokens=8).generate(
        prompts, decode_steps=k)
    for out, ref, jout in zip(outs, one, jouts):
        np.testing.assert_array_equal(out, ref)
        np.testing.assert_array_equal(out, jout)


def test_eos_inside_k_finishes_on_time(net):
    """A request whose eos comes in the middle of a K-step dispatch
    stops there: the rows after it stay out of its tokens and its slot
    is free after the dispatch."""
    p = _prompt(54, 4)
    gen = _server(net, buckets=[(1, 8)],
                  max_new_tokens=9).generate([p])[0][len(p):].astype(int)
    # an eos first met at decode row 2 of the first 4-step dispatch
    eos = int(gen[3])
    stop_at = int(np.nonzero(gen == eos)[0][0])
    assert stop_at >= 1
    srv = _server(net, buckets=[(1, 8)], max_new_tokens=9, eos_id=eos)
    req = srv.submit(p)
    srv.step(decode_steps=4)
    assert req.state == "done"
    assert req.generated == [int(t) for t in gen[:stop_at + 1]]
    assert srv.sched.buckets[0].n_active() == 0
    assert srv.sched.buckets[0].offsets[0] == 0.0


def test_decode_steps_one_dispatch_per_bucket(net, monkeypatch):
    """``step(decode_steps=K)``: one decode body call per non-empty
    bucket, each returning (K, slots) tokens; a request advances K
    tokens a round."""
    from mxnet_tpu_torch import _capture
    calls = []
    run = _capture.StepCapture.run

    def counted(self, body, tensors, static_key=(), generator=None):
        out = run(self, body, tensors, static_key, generator)
        calls.append((self.name, tuple(out[0].shape)))
        return out
    monkeypatch.setattr(_capture.StepCapture, "run", counted)
    srv = _server(net, buckets=[(2, 8), (2, 16)], max_new_tokens=13)
    ra = srv.submit(_prompt(55, 5))
    rb = srv.submit(_prompt(56, 12))
    srv.step(decode_steps=4)              # 2 admissions, 2 decodes
    assert calls == [("Server_b2x8_prefill", (1,)),
                     ("Server_b2x16_prefill", (1,)),
                     ("Server_b2x8_decode4", (4, 2)),
                     ("Server_b2x16_decode4", (4, 2))]
    assert len(ra.generated) == len(rb.generated) == 5
    del calls[:]
    srv.step(decode_steps=4)
    assert calls == [("Server_b2x8_decode4", (4, 2)),
                     ("Server_b2x16_decode4", (4, 2))]
    assert len(ra.generated) == len(rb.generated) == 9


def test_steady_state_one_signature_per_variant(net, monkeypatch):
    """Across admit, evict and finish churn, with one-step and K-step
    decode alternating, every variant keeps its own StepCapture and
    hands it one signature (shapes, static key, generator) only: on the
    card each captures once, and ``steady_misses`` stays 0."""
    from mxnet_tpu_torch import _capture
    seen = {}
    run = _capture.StepCapture.run

    def recorded(self, body, tensors, static_key=(), generator=None):
        sig = tuple((tuple(t.shape), t.dtype) for t in tensors)
        seen.setdefault(self.name, set()).add(
            (sig, static_key, id(generator)))
        return run(self, body, tensors, static_key, generator)
    monkeypatch.setattr(_capture.StepCapture, "run", recorded)
    srv = _server(net, buckets=[(2, 8)], max_new_tokens=8)
    srv.generate([_prompt(57, 5)])
    r1 = srv.submit(_prompt(58, 4))
    r2 = srv.submit(_prompt(59, 7))
    srv.step(decode_steps=3)
    srv.evict(r1, reason="churn")
    srv.submit(_prompt(60, 3))
    srv.step()
    srv.step(decode_steps=3)
    srv.run()
    assert r2.state == "done"
    assert set(seen) == {"Server_b2x8_prefill", "Server_b2x8_decode",
                         "Server_b2x8_decode3"}
    assert all(len(v) == 1 for v in seen.values()), seen
    assert set(srv._variants) == {"_b2x8_prefill", "_b2x8_decode",
                                  "_b2x8_decode3"}
    assert srv.stats()["buckets"]["2x8"]["steady_misses"] == 0


def test_decode_steps_checked(net):
    srv = _server(net, buckets=[(1, 8)], max_new_tokens=4)
    srv.submit(_prompt(61, 3))
    with pytest.raises(MXNetError, match="decode_steps"):
        srv.step(decode_steps=0)
