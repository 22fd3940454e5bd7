"""The port's telemetry plane (``mxnet_tpu_torch.telemetry``) against the
JAX package's on the CPU.

* **Metrics.**  The same observations give the same ``snapshot()`` (the
  histograms' sums to 1e-9 relative) and the same ``quantile(0.5/0.99)``;
  each package's ``to_prometheus()`` text, parsed by the other's
  ``parse_prometheus``, gives its own values; JSONL round-trips; a
  disabled plane records nothing; the rings are bounded by
  ``MXTPU_FLIGHT_RECORDER_SIZE``; a dump writes its file.
* **The serving plane's reports.**  After ``tests/test_serving.py``'s
  telemetry scenario, run through both packages' ``Server`` over the same
  weights (``torch_serving_pair``), the counters and the time-to-first-
  token histogram's count are equal; the evict events survive a flood of
  2,000 dispatch events; and every event kind the serving protocols emit
  carries the same keys in both packages (timing values not compared).
"""
import json
import os

import numpy as np
import pytest

from mxnet_tpu import telemetry as jtelemetry
from mxnet_tpu_torch import telemetry

from torch_serving_pair import FakeClock, build_sides, prompt, use_clock

PKGS = (("jax", jtelemetry), ("port", telemetry))


@pytest.fixture(autouse=True)
def _clean():
    for _, t in PKGS:
        t.enable()
        t.reset()
    yield
    for _, t in PKGS:
        t.enable()
        t.reset()


def _observe(t):
    c = t.counter("torch_test_ops_total", "ops")
    c.inc()
    c.inc(2.5)
    g = t.gauge("torch_test_depth", "depth")
    g.set(4)
    g.inc(3)
    g.dec()
    h = t.histogram("torch_test_latency_seconds", "latency")
    for v in (5e-5, 2e-4, 2e-4, 0.004, 0.25, 0.3, 7.0, 500.0):
        h.observe(v)
    e = t.histogram("torch_test_edges", "edges", buckets=(1, 2, 5))
    for v in (1, 2, 2, 3, 9):
        e.observe(v)
    return h, e


def _own(snap):
    """The instruments of these tests: each package's registry also
    holds those of earlier tests in the process."""
    return {kind: {k: v for k, v in group.items()
                   if k.startswith("torch_test_")}
            for kind, group in snap.items()}


def _own_text(text):
    return "\n".join(line for line in text.splitlines()
                     if "torch_test_" in line)


def test_metrics_match_jax():
    snaps, qs = {}, {}
    for name, t in PKGS:
        h, e = _observe(t)
        snaps[name] = t.snapshot()
        qs[name] = [x.quantile(q) for x in (h, e) for q in (0.5, 0.99)]
        assert h.quantile(0.99) >= h.quantile(0.5)
        assert t.histogram("torch_test_unseen").quantile(0.5) is None
    assert qs["port"] == qs["jax"]
    port, jax = (_own(snaps[k]) for k in ("port", "jax"))
    assert port["counters"] == jax["counters"]
    assert port["gauges"] == jax["gauges"]
    assert port["counters"]["torch_test_ops_total"] == 3.5
    assert port["gauges"]["torch_test_depth"] == 6.0
    for k, want in jax["histograms"].items():
        got = dict(port["histograms"][k])
        np.testing.assert_allclose(got.pop("sum"), want["sum"], rtol=1e-9)
        np.testing.assert_allclose(got.pop("avg") or 0.0,
                                   want["avg"] or 0.0, rtol=1e-9)
        assert got == {a: b for a, b in want.items()
                       if a not in ("sum", "avg")}
    assert telemetry.DEFAULT_LATENCY_BUCKETS == \
        jtelemetry.DEFAULT_LATENCY_BUCKETS
    with pytest.raises(ValueError):
        telemetry.counter("torch_test_ops_total").inc(-1)
    with pytest.raises(TypeError):
        telemetry.gauge("torch_test_ops_total")
    with pytest.raises(ValueError):
        telemetry.histogram("torch_test_bad", buckets=(2, 1))


def test_prometheus_text_cross_parses():
    texts, own = {}, {}
    for name, t in PKGS:
        _observe(t)
        texts[name] = _own_text(t.to_prometheus())
        own[name] = t.parse_prometheus(texts[name])
    assert texts["port"] == texts["jax"]
    assert telemetry.parse_prometheus(texts["jax"]) == own["jax"]
    assert jtelemetry.parse_prometheus(texts["port"]) == own["port"]
    parsed = own["port"]
    assert parsed["torch_test_ops_total"] == 3.5
    assert parsed["torch_test_edges_bucket"] == {"1": 1.0, "2": 3.0,
                                                "5": 4.0, "+Inf": 5.0}
    assert parsed["torch_test_latency_seconds_count"] == 8.0


def test_jsonl_round_trip(tmp_path):
    rows = {}
    for name, t in PKGS:
        _observe(t)
        path = str(tmp_path / f"{name}.jsonl")
        assert t.write_jsonl(path) == len(t.snapshot()["counters"]) + \
            len(t.snapshot()["gauges"]) + len(t.snapshot()["histograms"])
        rows[name] = [r for r in t.read_jsonl(path)
                      if r["name"].startswith("torch_test_")]
    assert rows["port"] == rows["jax"]
    exported = telemetry.export_metrics(str(tmp_path / "export.jsonl"))
    assert telemetry.read_jsonl(exported)


def test_disabled_plane_records_nothing():
    telemetry.disable()
    assert not telemetry.enabled()
    telemetry.counter("torch_test_off_total").inc()
    telemetry.histogram("torch_test_off_seconds").observe(1.0)
    telemetry.record_event("poison", where="x")
    assert telemetry.record_step("torch_off", 0.1) is None
    assert telemetry.auto_dump("off") is None
    telemetry.enable()
    snap = telemetry.snapshot()
    assert snap["counters"]["torch_test_off_total"] == 0.0
    assert snap["histograms"]["torch_test_off_seconds"]["count"] == 0
    assert telemetry.events() == []


def test_ring_bounded_by_env(monkeypatch):
    monkeypatch.setenv("MXTPU_FLIGHT_RECORDER_SIZE", "20")
    telemetry.clear_events()
    for i in range(50):
        telemetry.record_event("dispatch", op=f"op{i}")
    telemetry.record_event("request_evicted", reason="kept")
    evs = telemetry.events()
    assert len(evs) == 21
    assert [e["op"] for e in evs[:20]] == [f"op{i}" for i in range(30, 50)]
    assert evs[-1]["reason"] == "kept"
    path = telemetry.dump_flight_recorder()
    assert json.load(open(path))["dropped_events"] == 30
    os.remove(path)


def test_dump_writes_its_file(tmp_path, monkeypatch):
    monkeypatch.setenv("MXTPU_TELEMETRY_EXPORT", str(tmp_path / "out"))
    telemetry.counter("torch_test_dump_total").inc(2)
    telemetry.record_event("poison", where="serving", name="n")
    path = telemetry.dump_flight_recorder(reason="on_demand")
    assert os.path.dirname(path) == str(tmp_path / "out")
    assert telemetry.last_dump() == path
    art = json.load(open(path))
    assert art["reason"] == "on_demand" and art["events"][-1]["kind"] == \
        "poison"
    assert art["metrics"]["counters"]["torch_test_dump_total"] == 2.0
    assert set(art) == {"reason", "pid", "wall_time", "step",
                        "dropped_events", "events", "metrics"}
    auto = telemetry.auto_dump("crash")
    assert auto and json.load(open(auto))["reason"] == "crash"


def test_record_step_matches_jax():
    out = {}
    for name, t in PKGS:
        with t.step_owner(None, "x"):
            assert t.step_owned()
        assert not t.step_owned()
        t.record_step("torch_step", 0.02, dispatches=1, examples=64)
        t.record_step("torch_step", 0.5, dispatches=1, steps=4,
                      path="compiled")
        snap = t.snapshot()
        out[name] = (t.current_step(),
                     {k: v for k, v in snap["counters"].items()
                      if k in ("mxtpu_steps_total",
                               "mxtpu_examples_total")},
                     snap["gauges"]["mxtpu_last_step_dispatches"],
                     snap["histograms"]["mxtpu_torch_step_seconds"]["count"],
                     snap["histograms"]["mxtpu_torch_step_bulk_seconds"][
                         "count"],
                     [sorted(e) for e in t.events("step")],
                     t.prefetch_stall_ratio())
    assert out["port"] == out["jax"]
    assert out["port"][0] == 5


# -- the serving plane's reports -----------------------------------------------


@pytest.fixture(scope="module")
def sides():
    return build_sides()


def test_serving_counters_and_ttft_match_jax(sides):
    """``tests/test_serving.py``'s telemetry scenario in both packages:
    a full queue's ``slot_oom``, a user eviction, then a drain."""
    out = {}
    for side in sides:
        t = side.telemetry
        srv = side.server(buckets=[(1, 4)], max_new_tokens=3, max_queue=1)
        r1 = srv.submit(prompt(22, 3))
        srv.step()
        srv.submit(prompt(23, 2))
        with pytest.raises(side.Error, match="queue full"):
            srv.submit(prompt(24, 2))
        oom = t.events("slot_oom")
        assert oom and oom[-1]["queue_depth"] == 1
        srv.evict(r1, reason="test-evict")
        assert t.events("request_evicted")[-1]["reason"] == "test-evict"
        srv.run()
        snap = t.snapshot()
        ttft = t.histogram("mxtpu_serving_ttft_seconds")
        assert ttft.quantile(0.99) >= ttft.quantile(0.5)
        out[side.name] = (
            {k: v for k, v in snap["counters"].items()
             if k.startswith("mxtpu_serving_")},
            {k: v for k, v in snap["gauges"].items()
             if k.startswith("mxtpu_serving_")},
            {k: snap["histograms"][k]["count"] for k in (
                "mxtpu_serving_ttft_seconds",
                "mxtpu_serving_prefill_seconds",
                "mxtpu_serving_decode_seconds",
                "mxtpu_serving_request_seconds")})
    assert out["port"] == out["jax"]
    counters = out["port"][0]
    assert counters["mxtpu_serving_requests_total"] == 2
    assert counters["mxtpu_serving_requests_completed_total"] == 1
    assert counters["mxtpu_serving_requests_evicted_total"] == 1
    assert out["port"][2]["mxtpu_serving_ttft_seconds"] == 2


def test_evict_events_survive_a_dispatch_flood(sides):
    for side in sides:
        srv = side.server(buckets=[(1, 4)], max_new_tokens=6)
        r = srv.submit(prompt(25, 3))
        srv.step()
        assert srv.evict(r, reason="forensic") is True
        for _ in range(2000):
            side.telemetry.record_event("dispatch", op="flood")
        evs = side.telemetry.events("request_evicted")
        assert [e["reason"] for e in evs] == ["forensic"]


def _every_kind(side, clock, tmp_path):
    """One server through every event kind the serving protocols emit."""
    t = side.telemetry
    srv = side.server(buckets=[(1, 4)], max_new_tokens=3, max_queue=2)
    r1 = srv.submit(prompt(30, 3), ttl_ms=5000)
    srv.step()                                 # a decode history
    srv.submit(prompt(31, 2), ttl_ms=500)      # queued, will expire
    srv.submit(prompt(32, 2))
    with pytest.raises(side.Error, match="queue full"):
        srv.submit(prompt(33, 2))              # slot_oom
    t.histogram("mxtpu_serving_decode_seconds").observe(100.0)
    with pytest.raises(side.Error, match="shed"):
        srv.submit(prompt(34, 2), ttl_ms=1)    # shed
    clock.advance(1.0)
    srv.step()                                 # deadline_evicted
    srv.evict(r1, reason="user")               # request_evicted
    srv.submit(prompt(35, 3))
    side.faults.configure("dispatch_post:nth=1")
    with pytest.raises(side.Error, match="recover"):
        srv.step()                             # poison
    side.faults.clear()
    srv.recover()                              # recovery
    srv.run()
    path = srv.save_signature(str(tmp_path / f"{side.name}.json"))
    side.server(buckets=[(1, 4)], max_new_tokens=3).warm_start(path)
    srv.warm_start(str(tmp_path / "missing.json"))     # warm_start
    kinds = ("slot_oom", "shed", "deadline_evicted", "request_evicted",
             "poison", "recovery", "warm_start", "dispatch",
             "fault_injected")
    out = {}
    for kind in kinds:
        evs = t.events(kind)
        assert evs, kind
        out[kind] = [sorted(e) for e in evs]
    values = {
        "request_evicted": [(e["reason"], e["requeued"], e["generated"])
                            for e in t.events("request_evicted")],
        "deadline_evicted": [(e["ttl_ms"], e["generated"])
                             for e in t.events("deadline_evicted")],
        "shed": [(e["ttl_ms"], e["queue_depth"], e["prompt_len"])
                 for e in t.events("shed")],
        "recovery": [(e["where"], e["poisoned"], e["requeued"])
                     for e in t.events("recovery")],
        "warm_start": [e["ok"] for e in t.events("warm_start")],
        "slot_oom": [(e["queue_depth"], e["prompt_len"])
                     for e in t.events("slot_oom")],
    }
    return out, values


def test_event_kinds_carry_the_jax_keys(sides, monkeypatch, tmp_path):
    clock = FakeClock()
    use_clock(monkeypatch, sides, clock)
    keys, values = {}, {}
    for side in sides:
        keys[side.name], values[side.name] = _every_kind(side, clock,
                                                         tmp_path)
    assert keys["port"].keys() == keys["jax"].keys()
    for kind, want in keys["jax"].items():
        got = keys["port"][kind]
        # the JAX engine also reports the dispatches of its random keys
        if kind != "dispatch":
            assert len(got) == len(want), kind
        assert {tuple(k) for k in got} == {tuple(k) for k in want}, kind
    assert values["port"] == values["jax"]
