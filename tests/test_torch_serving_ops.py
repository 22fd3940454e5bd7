"""The serving plane's overload, resize and signature protocols against
the JAX package on the CPU: one scenario through both packages' ``Server``
over the same weights (``torch_serving_pair``), tokens, counts, records
and hashes compared exactly.

* **Deadlines.**  Under one fake clock (``time.perf_counter`` of both
  packages' serving modules), ``submit(ttl_ms=)`` sheds the same requests
  with the same estimated waits, and ``step`` evicts the same residents
  and queued requests as ``deadline``.
* **Resize.**  Grow and shrink under churn (the scenario of
  ``tests/test_resize.py``): every surviving request's tokens equal an
  unresized greedy run's, and the records agree; ``ServingAutoscaler``
  fires the same resizes for the same queue depths and occupancies.
* **Signatures.**  ``save_signature`` refuses before any traffic,
  ``warm_start`` round-trips, fails open for the JAX package's reasons
  and refuses the other package's manifest by fingerprint; the
  structural hash equals the JAX package's.
* **The port's own contracts**: the KV pool copies and zeroes in place
  (the captured graphs hold its addresses), and a resize releases the
  old variants.
"""
import json

import numpy as np
import pytest
import torch

from torch_serving_pair import (CPU, FakeClock, build_sides, prompt,
                                record_fields, use_clock)
from mxnet_tpu_torch.serving import KVCachePool


@pytest.fixture(scope="module")
def sides():
    return build_sides()


@pytest.fixture(autouse=True)
def _clean(sides):
    for side in sides:
        side.clean()
    yield
    for side in sides:
        side.clean()


# -- deadlines and shedding ---------------------------------------------------


def _deadline_run(side, clock):
    srv = side.server(buckets=[(2, 8)], max_new_tokens=4, max_queue=16)
    srv.generate([prompt(60, 4)])          # a decode history, 0 s each
    side.telemetry.histogram("mxtpu_serving_decode_seconds").observe(0.8)
    a = srv.submit(prompt(61, 5), ttl_ms=400)
    b = srv.submit(prompt(62, 3))
    srv.step()                             # both admitted
    burst, waits = [], []
    for i, ttl in enumerate((50, 420, 5000, 1500, 300, 20000, 2500)):
        waits.append(srv.estimate_queue_wait())
        try:
            burst.append(srv.submit(prompt(63 + i, 4), ttl_ms=ttl))
        except side.Error as e:
            assert "shed" in str(e)
            burst.append(None)
    clock.advance(0.45)
    srv.step()                             # the deadline sweep
    evicted = [e["reason"] for e in side.telemetry.events(
        "request_evicted")]
    srv.run()
    c = side.telemetry.snapshot()["counters"]
    return {
        "waits": waits,
        "states": [(r.state, r.evict_reason, len(r.generated))
                   if r is not None else None for r in [a, b] + burst],
        "shed": [e["ttl_ms"] for e in side.telemetry.events("shed")],
        "deadline": [(e["ttl_ms"], e["generated"])
                     for e in side.telemetry.events("deadline_evicted")],
        "evicted": evicted,
        "counters": (c["mxtpu_requests_shed_total"],
                     c["mxtpu_deadline_evictions_total"]),
        "tokens": b.tokens(),
    }


def test_deadlines_shed_and_evict_the_same_requests(sides, monkeypatch):
    clock = FakeClock()
    use_clock(monkeypatch, sides, clock)
    out = {side.name: _deadline_run(side, clock) for side in sides}
    port, jax = out["port"], out["jax"]
    np.testing.assert_allclose(port.pop("waits"), jax.pop("waits"),
                               rtol=1e-12)
    np.testing.assert_array_equal(port.pop("tokens"), jax.pop("tokens"))
    assert port == jax
    # the scenario reaches every branch: a shed, a resident and a queued
    # request evicted on their deadline
    assert port["counters"][0] >= 1 and port["deadline"]
    assert port["states"][0][:2] == ("evicted", "deadline")
    assert ("evicted", "deadline", 0) in port["states"][2:]


def test_ttl_must_be_positive(sides):
    for side in sides:
        srv = side.server(buckets=[(1, 8)], max_new_tokens=2)
        with pytest.raises(side.Error, match="ttl_ms"):
            srv.submit(prompt(1, 3), ttl_ms=0)


# -- live resize ---------------------------------------------------------------


def _churn(side):
    srv = side.server(buckets=[(2, 8)], max_new_tokens=6)
    r1 = srv.submit(prompt(0, 5))
    r2 = srv.submit(prompt(1, 7))
    srv.step()
    srv.step()
    before = (list(r1.generated), list(r2.generated))
    grow = srv.resize_slots(4)
    assert (list(r1.generated), list(r2.generated)) == before
    assert grow["prewarmed_variants"] == 2     # prefill + decode
    if side.name == "port":
        assert sorted(srv._variants) == ["_b4x8_decode", "_b4x8_prefill"]
    r3 = srv.submit(prompt(2, 4))
    srv.step()
    srv.evict(r3, reason="churn")
    r4 = srv.submit(prompt(3, 6))
    srv.run()
    reqs = [srv.submit(prompt(10 + i, 5)) for i in range(4)]
    srv.step()
    shrink = srv.resize_slots(2)
    srv.run()
    assert all(r.state == "done" for r in reqs)
    tail = srv.generate([prompt(30, 6)])[0]
    return (record_fields(grow), record_fields(shrink),
            len(side.resize.resizes()),
            [r.tokens() for r in (r1, r2, r4, *reqs)] + [tail])


def test_resize_grow_shrink_churn_matches_jax(sides):
    out = {side.name: _churn(side) for side in sides}
    port, jax = out["port"], out["jax"]
    assert port[:3] == jax[:3]
    assert port[0]["migrated"] == 2 and port[0]["requeued"] == 0
    assert (port[1]["migrated"], port[1]["requeued"]) == (2, 2)
    ref = sides[1].server(buckets=[(2, 8)], max_new_tokens=6).generate(
        [prompt(0, 5), prompt(1, 7), prompt(3, 6)]
        + [prompt(10 + i, 5) for i in range(4)] + [prompt(30, 6)])
    for got, want, r in zip(port[3], jax[3], ref):
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, r)


def test_resize_releases_the_old_variants(sides):
    """After the swap only the new slot count's variants and pools are
    held, and the resize events carry the JAX package's keys."""
    out = {}
    for side in sides:
        srv = side.server(buckets=[(2, 8)], max_new_tokens=3)
        srv.generate([prompt(5, 4)])
        rec = srv.resize_slots(1)
        assert [b.key for b in srv.sched.buckets] == [(1, 8)]
        ev = side.telemetry.events("resize")[-1]
        out[side.name] = (set(ev) - {"prewarm_seconds"}, rec["buckets"])
        if side.name == "port":
            assert list(srv._pools) == [(1, 8)]
            assert srv._pools[(1, 8)].slots == 1
            assert sorted(srv._variants) == ["_b1x8_decode",
                                             "_b1x8_prefill"]
            st = srv.stats()
            assert st["captures"] == 0 and st["graph_pool_bytes"] == 0
    assert out["port"] == out["jax"]


def test_autoscaler_fires_the_same_resizes(sides):
    out = {}
    for side in sides:
        srv = side.server(buckets=[(1, 8)], max_new_tokens=4,
                          max_queue=32)
        srv.generate([prompt(40, 4)])
        auto = side.Autoscaler(srv, min_slots=1, max_slots=8, up_queue=2,
                               down_occupancy=0.3, patience=2,
                               cooldown_s=0.0)
        ticks = []
        for i in range(6):
            srv.submit(prompt(41 + i, 4))
        srv.step()
        for _ in range(2):
            rec = auto.observe()
            ticks.append(rec and (rec["slots_to"],
                                  rec["autoscale_reason"]))
        srv.run()
        for _ in range(2):
            rec = auto.observe()
            ticks.append(rec and (rec["slots_to"],
                                  rec["autoscale_reason"]))
        cold = side.Autoscaler(srv, min_slots=1, max_slots=8, up_queue=1,
                               down_occupancy=0.3, patience=1,
                               cooldown_s=3600.0)
        cold._last_resize = __import__("time").monotonic()
        srv.submit(prompt(50, 4))
        ticks.append(cold.observe())
        srv.run()
        env = side.Autoscaler(srv)
        out[side.name] = (ticks, (env.patience, env.max_slots,
                                  env.up_queue, env.down_occupancy,
                                  env.cooldown_s))
    assert out["port"] == out["jax"]
    assert [t and t[0] for t in out["port"][0]] == [None, 2, None, 1, None]


# -- signatures ---------------------------------------------------------------


def test_save_signature_refuses_before_traffic(sides, tmp_path):
    for side in sides:
        srv = side.server(buckets=[(1, 8)], max_new_tokens=4)
        with pytest.raises(side.Error, match="serve at least one"):
            srv.save_signature(str(tmp_path / f"{side.name}.json"))


@pytest.mark.parametrize("cfg", [
    dict(buckets=[(2, 8)], max_new_tokens=5),
    dict(buckets=[(2, 8), (4, 16)], max_new_tokens=3, top_k=5,
         cache_dtype="bfloat16")])
def test_struct_hash_equals_jax(sides, cfg):
    jax, port = (side.server(**cfg) for side in sides)
    assert port._struct_hash == jax._struct_hash


def test_warm_start_round_trip(sides, tmp_path):
    """A new server warm-started from a manifest serves the same tokens;
    both packages record the same variants."""
    p = prompt(7, 5)
    out = {}
    for side in sides:
        srv = side.server(buckets=[(2, 8)], max_new_tokens=4)
        ref = srv.generate([p], decode_steps=2)[0]
        path = str(tmp_path / f"{side.name}.json")
        srv.save_signature(path)
        m = json.load(open(path))
        warm = side.server(buckets=[(2, 8)], max_new_tokens=4)
        assert warm.warm_start(path) is True
        assert warm.stats()["warm_started"]
        np.testing.assert_array_equal(
            warm.generate([p], decode_steps=2)[0], ref)
        ev = side.telemetry.events("warm_start")[-1]
        out[side.name] = (
            {k: m[k] for k in ("format", "kind", "struct_hash", "top_k",
                               "cache_dtype", "max_new_tokens",
                               "buckets")},
            [(v["suffix"], v["kind"], v["k"]) for v in m["variants"]],
            sorted(s[len(warm.name):] for s in ev["sources"]), ev["ok"])
    assert out["port"] == out["jax"]


def _tamper(path, tmp_path, name, **fields):
    m = json.load(open(path))
    m.update(fields)
    bad = str(tmp_path / name)
    json.dump(m, open(bad, "w"))
    return bad


def test_warm_start_fails_open_for_the_jax_reasons(sides, tmp_path):
    """Unreadable, not a manifest, fingerprint, structural hash, buckets,
    poisoned: each package returns False with a ``warm_start`` event whose
    reason names the same class, never raises, and still serves; each
    refuses the other package's manifest by fingerprint."""
    garbage = str(tmp_path / "garbage.json")
    open(garbage, "w").write("{")
    other = str(tmp_path / "other.json")
    json.dump({"format": 2, "kind": "mxtpu_serving_plane"},
              open(other, "w"))
    manifests, reasons = {}, {}
    for side in sides:
        srv = side.server(buckets=[(2, 8)], max_new_tokens=4)
        srv.generate([prompt(9, 4)])
        path = manifests[side.name] = srv.save_signature(
            str(tmp_path / f"{side.name}.json"))
        fresh = side.server(buckets=[(2, 8)], max_new_tokens=4)
        wider = side.server(buckets=[(4, 8)], max_new_tokens=4)
        cases = [(fresh, garbage), (fresh, other),
                 (fresh, _tamper(path, tmp_path, side.name + "_fp.json",
                                 fingerprint={"x": 1})),
                 (wider, path),
                 (fresh, _tamper(path, tmp_path, side.name + "_b.json",
                                 buckets=[{"slots": 2, "prompt_len": 16,
                                           "cache_len": 20}]))]
        got = []
        for server, p in cases:
            assert server.warm_start(p) is False
            got.append(side.telemetry.events("warm_start")[-1]["reason"])
        side.faults.configure("dispatch_post:nth=1")
        with pytest.raises(side.Error, match="recover"):
            fresh.generate([prompt(9, 4)])
        side.faults.clear()
        assert fresh.warm_start(path) is False
        got.append(side.telemetry.events("warm_start")[-1]["reason"])
        fresh.recover()
        assert len(fresh.generate([prompt(9, 4)])[0]) == 8
        reasons[side.name] = got
    classes = ("unreadable manifest", "not an mxtpu_serving_plane",
               "environment fingerprint mismatch",
               "structural hash mismatch", "bucket mismatch",
               "server is poisoned")
    for name in ("jax", "port"):
        assert [r.startswith(c) for r, c in
                zip(reasons[name], classes)] == [True] * 6, reasons[name]
    # each package refuses the other's manifest by its fingerprint
    jax, port = sides
    for side, path in ((jax, manifests["port"]), (port, manifests["jax"])):
        srv = side.server(buckets=[(2, 8)], max_new_tokens=4)
        assert srv.warm_start(path) is False
        assert side.telemetry.events("warm_start")[-1]["reason"] \
            .startswith("environment fingerprint mismatch")


# -- the port's own contracts -------------------------------------------------


def test_kv_pool_adopts_and_resets_in_place(sides):
    """The captured graphs hold the pool's addresses: ``adopt`` copies
    into the pool's storage (whole tensors, or chosen slots) and
    ``reset`` zeroes it, neither rebinds a tensor; the poison latch
    holds until ``reset``."""
    lm = sides[1].lm
    pool = KVCachePool(lm, 3, 6, ctx=CPU)
    ptrs = [t.data_ptr() for t in pool.flat()]
    assert pool.nbytes() == sum(t.numel() * 4 for t in pool.flat())
    rows = [torch.randn((2,) + t.shape[1:]) for t in pool.flat()]
    pool.adopt(rows, slots=[2, 0])
    for t, r in zip(pool.flat(), rows):
        torch.testing.assert_close(t[2], r[0], rtol=0, atol=0)
        torch.testing.assert_close(t[0], r[1], rtol=0, atol=0)
        assert not t[1].any()
    whole = [torch.ones_like(t) for t in pool.flat()]
    pool.adopt(whole)
    assert all(bool((t == 1).all()) for t in pool.flat())
    pool.poison("boom")
    assert pool.poisoned == "boom"
    pool.reset()
    assert pool.poisoned is None
    assert not any(t.any() for t in pool.flat())
    assert [t.data_ptr() for t in pool.flat()] == ptrs
    with pytest.raises(Exception, match="adopt"):
        pool.adopt(whole[:-1])


def test_stats_carry_the_jax_keys(sides):
    keys = {}
    for side in sides:
        srv = side.server(buckets=[(1, 8)], max_new_tokens=2)
        st = srv.stats()
        assert st["name"] == srv.name and st["name"].startswith(
            "serving_" + side.lm.name + "_")
        assert (st["poisoned"], st["warm_started"]) == (False, False)
        keys[side.name] = set(st)
    assert keys["jax"] <= keys["port"]
