"""The port's fault injection (``elastic.faults``) and the serving plane's
failure protocols under it, against the JAX package on the CPU.

* The grammar cases of ``tests/test_elastic.py`` hold in the port, the
  port parses every spec as the JAX package does, and a ``prob=`` plan
  under one seed fires on the same arrivals in both.
* One scenario runs through both packages' ``Server`` over the same
  weights (``torch_serving_pair``): a fault after the launch poisons the
  server, ``step`` refuses until ``recover()``, and the replayed request's
  tokens equal an unfaulted run's exactly; a failed admission requeues
  every pending placement in FIFO order; a fault before the launch is
  retried up to ``MXTPU_DISPATCH_RETRIES`` and raises ``FaultError``
  without it; and the faults of a live resize leave both packages in the
  same state with the same records (tokens, counts and records exact).
"""
import numpy as np
import pytest

from mxnet_tpu.elastic import faults as jfaults
from mxnet_tpu_torch.elastic import faults

from torch_serving_pair import build_sides, prompt, record_fields


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


# -- grammar ------------------------------------------------------------------


def test_fault_grammar():
    n = faults.configure(
        "dispatch:step=7; checkpoint_write:nth=2,times=3; host_copy")
    assert n == 3 and faults.active()
    assert faults.configure(None) == 0 and not faults.active()
    with pytest.warns(RuntimeWarning, match="unknown fault point"):
        faults.configure("dispach:nth=1")
    faults.clear()
    with pytest.raises(ValueError, match="bad fault qualifier"):
        faults.configure("dispatch:bogus=1")
    with pytest.raises(ValueError):
        faults.configure("dispatch:nth=")
    with pytest.raises(ValueError, match="prob must be"):
        faults.configure("dispatch:prob=1.5")


SPECS = ("dispatch:step=7; checkpoint_write:nth=2,times=3; host_copy",
         "dispatch:prob=0.25; resize_swap:prob=0.5,times=2",
         "corrupt_param:device=1,leaf=2,bit=3; dispatch_hang:ms=5",
         "dispatch_post:nth=4\nresize_prewarm:times=0")


@pytest.mark.parametrize("text", SPECS)
def test_specs_parse_as_in_jax(text):
    assert [repr(s) for s in faults._parse(text)] == \
        [repr(s) for s in jfaults._parse(text)]
    assert [(s.point, s.nth, s.step, s.times, s.prob, s.ms)
            for s in faults._parse(text)] == \
        [(s.point, s.nth, s.step, s.times, s.prob, s.ms)
         for s in jfaults._parse(text)]


def test_fault_nth_times_one_shot():
    faults.configure("checkpoint_write:nth=2")
    faults.maybe_fire("checkpoint_write")          # 1st arrival: no
    with pytest.raises(faults.FaultError):
        faults.maybe_fire("checkpoint_write")      # 2nd: fires
    faults.maybe_fire("checkpoint_write")          # one-shot: spent
    assert not faults.active()
    assert faults.fired() == ["checkpoint_write:nth=2"]

    faults.configure("host_copy:times=2")
    for _ in range(2):
        with pytest.raises(faults.FaultError):
            faults.maybe_fire("host_copy")
    faults.maybe_fire("host_copy")                 # times=2 spent
    assert not faults.active()


def test_fault_env_configuration(monkeypatch):
    monkeypatch.setenv("MXTPU_FAULT_INJECT", "host_copy;dispatch:nth=3")
    assert faults.configure_from_env() == 2
    assert faults.active()
    monkeypatch.setenv("MXTPU_FAULT_INJECT", "dispatch:badqual=1")
    with pytest.warns(RuntimeWarning, match="MXTPU_FAULT_INJECT"):
        assert faults.configure_from_env() == 0
    assert not faults.active()
    with pytest.raises(ValueError, match="bad fault qualifier"):
        faults.configure("dispatch:badqual=1")


@pytest.mark.parametrize("seed", [0, 7])
def test_prob_plan_fires_on_the_same_arrivals_as_jax(seed):
    """One spec and one seed: the same arrivals fire in both packages
    over 200 arrivals at each of two points, and ``fired()`` is
    identical."""
    plan = "dispatch:prob=0.3; resize_swap:prob=0.5,times=40"
    hits = {}
    for name, mod in (("jax", jfaults), ("port", faults)):
        mod.configure(plan, seed=seed)
        got = []
        for i in range(200):
            for point in ("dispatch", "resize_swap"):
                try:
                    mod.maybe_fire(point)
                except mod.FaultError:
                    got.append((i, point))
        hits[name] = (got, mod.fired())
        mod.clear()
    assert hits["port"] == hits["jax"]
    assert 40 < len(hits["port"][0]) < 120


# -- the serving plane's failure protocols -----------------------------------


def test_poison_latch_recover_and_exact_replay(sides):
    """A fault after the launch poisons the server; ``step`` refuses
    until ``recover()``, which requeues the resident, and the replayed
    request's tokens equal an unfaulted run's, in both packages."""
    p = prompt(20, 5)
    out = {}
    for side in sides:
        srv = side.server(buckets=[(2, 8)], max_new_tokens=5)
        ref = srv.generate([p])[0]
        req = srv.submit(p)
        srv.step()
        side.faults.configure("dispatch_post:nth=1")
        with pytest.raises(side.Error, match="recover"):
            srv.step()
        side.faults.clear()
        assert srv.stats()["poisoned"]
        with pytest.raises(side.Error, match="recover"):
            srv.step()                      # latched until recovery
        assert srv.recover() == 1
        assert not srv.stats()["poisoned"]
        srv.run()
        np.testing.assert_array_equal(req.tokens(), ref)
        recs = side.telemetry.events("recovery")
        assert [(e["where"], e["poisoned"], e["requeued"])
                for e in recs] == [("serving", True, 1)]
        poison = side.telemetry.events("poison")
        assert len(poison) == 1 and poison[0]["where"] == "serving"
        c = side.telemetry.snapshot()["counters"]
        out[side.name] = (req.tokens(), c["mxtpu_poisons_total"],
                          c["mxtpu_recoveries_total"])
    np.testing.assert_array_equal(out["port"][0], out["jax"][0])
    assert out["port"][1:] == out["jax"][1:] == (1.0, 1.0)


def test_failed_admission_requeues_pending_placements(sides):
    """A fault before the first admission's launch: every placement
    admissions() made goes back to the queue in FIFO order, nothing is
    stranded in a slot, and a later round serves them all exactly."""
    prompts = [prompt(28, 4), prompt(29, 6)]
    refs = sides[1].server(buckets=[(2, 8)],
                           max_new_tokens=4).generate(prompts)
    out = {}
    for side in sides:
        srv = side.server(buckets=[(2, 8)], max_new_tokens=4)
        r1, r2 = [srv.submit(p) for p in prompts]
        side.faults.configure("dispatch:nth=1")
        with pytest.raises(side.faults.FaultError, match="injected fault"):
            srv.step()
        side.faults.clear()
        assert srv.sched.buckets[0].n_active() == 0
        assert [r.id for r in srv.sched.queue] == [r1.id, r2.id]
        assert [r.evict_reason for r in (r1, r2)] == ["admit_aborted"] * 2
        assert not srv.stats()["poisoned"]
        srv.run()
        for r, ref in zip((r1, r2), refs):
            assert r.state == "done"
            np.testing.assert_array_equal(r.tokens(), ref)
        out[side.name] = [r.tokens() for r in (r1, r2)]
    for a, b in zip(out["port"], out["jax"]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("retries", [2, 0])
def test_pre_launch_fault_retried_up_to_the_limit(sides, monkeypatch,
                                                  retries):
    """``MXTPU_DISPATCH_RETRIES=2`` absorbs a fault before the launch (no
    poison, exact tokens); at 0 it raises ``FaultError`` in both
    packages, and the server is not poisoned."""
    monkeypatch.setenv("MXTPU_DISPATCH_RETRIES", str(retries))
    monkeypatch.setenv("MXTPU_DISPATCH_BACKOFF_MS", "1")
    p = prompt(21, 5)
    out = {}
    for side in sides:
        srv = side.server(buckets=[(1, 8)], max_new_tokens=4)
        ref = srv.generate([p])[0]
        req = srv.submit(p)
        srv.step()
        side.faults.configure("dispatch:nth=1")
        if retries:
            srv.run()
            np.testing.assert_array_equal(req.tokens(), ref)
            n = side.telemetry.snapshot()["counters"][
                "mxtpu_dispatch_retries_total"]
        else:
            with pytest.raises(side.faults.FaultError):
                srv.run()
            n = 0.0
        side.faults.clear()
        assert not srv.stats()["poisoned"]
        out[side.name] = (side.faults.fired(), n)
    assert out["port"] == out["jax"]


def test_resize_fault_matrix(sides):
    """Each resize fault point leaves both packages in the same state: a
    fault before the drain aborts on the old slot count; one after it
    heals onto the new count with the residents requeued and replayed
    exactly; a shrink that faults at its swap counts both the overflow
    and the swept residents."""
    out = {}
    for side in sides:
        srv = side.server(buckets=[(2, 8)], max_new_tokens=6)
        srv.generate([prompt(20, 5)])            # every variant recorded
        seen = []
        for point in ("resize_prewarm", "resize_drain"):
            side.faults.configure(point)
            with pytest.raises(side.faults.FaultError):
                srv.resize_slots(4)
            side.faults.clear()
            assert max(b.slots for b in srv.sched.buckets) == 2
            ev = side.telemetry.events("resize_failed")[-1]
            seen.append((ev["phase"], ev["still_on"]))
        srv.generate([prompt(21, 5)])            # still serves
        live = srv.submit(prompt(22, 5))
        srv.step()
        side.faults.configure("resize_reshard")
        rec = srv.resize_slots(4)
        side.faults.clear()
        assert rec["healed"] is True
        assert [b.slots for b in srv.sched.buckets] == [4]
        srv.run()
        assert live.state == "done"
        assert side.telemetry.events("recovery")[-1]["where"] == \
            "resize_heal"
        reqs = [srv.submit(prompt(25 + i, 5)) for i in range(4)]
        srv.step()                               # all 4 slots full
        side.faults.configure("resize_swap")
        rec2 = srv.resize_slots(2)
        side.faults.clear()
        assert rec2["healed"] is True and rec2["requeued"] == 4
        heal = [e for e in side.telemetry.events("request_evicted")
                if e["reason"] == "resize_heal"]
        assert len(heal) >= 2
        srv.run()
        assert all(r.state == "done" for r in reqs)
        out[side.name] = (seen, record_fields(rec), record_fields(rec2),
                          live.tokens(), [r.tokens() for r in reqs])
    ref = sides[1].server(buckets=[(2, 8)], max_new_tokens=6).generate(
        [prompt(22, 5)] + [prompt(25 + i, 5) for i in range(4)])
    port, jax = out["port"], out["jax"]
    assert port[:3] == jax[:3]
    assert port[0] == [("prewarm", "old_config"), ("drain", "old_config")]
    for got, want, r in zip([port[3]] + port[4], [jax[3]] + jax[4], ref):
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, r)
