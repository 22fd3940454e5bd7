"""The sharding planner (``parallel/planner.py``, ``planning.py``)
against the JAX package's: a plan's record, JSON and struct hash equal
across the packages and a file written by either loads in the other;
``spec_for``, ``resolve``, ``coverage`` and ``stage_of`` of
``megatron_rules`` plans for every parameter of ``bert_small`` and
``llama_tiny`` (the port's names are the reference's); the same errors;
``llama_param_rule``, ``sharding_plan``'s memory arithmetic,
``moe_param_rule``, ``diff``, ``diff_records``, ``flat_rows`` and
``placements``.
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu import models as jmodels
from mxnet_tpu import parallel as jpar
from mxnet_tpu.parallel import planner as jplanner

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import models, parallel
from mxnet_tpu_torch.parallel import planner

PLANS = {
    "dp4tp2": dict(axes={"dp": 4, "tp": 2}, rules="megatron",
                   zero_stage=None, decode=("dp",)),
    "pp": dict(axes={"dp": 2, "pp": 2}, rules=[(r"embed", ("dp",))],
               zero_stage=1, stage_rules=[(r"head", 0)],
               precision={"dp_grad": "int8"}),
    "tuple": dict(axes={"dp": 2, "tp": 2, "sp": 2},
                  rules=[(r"weight$", (("dp", "tp"), None)), (r".", ())]),
}


def _plan(pkg, name):
    kw = dict(PLANS[name])
    axes, rules = kw.pop("axes"), kw.pop("rules")
    if rules == "megatron":
        rules = pkg.megatron_rules()
    return pkg.ShardingPlan(axes, rules, **kw)


@pytest.mark.parametrize("name", sorted(PLANS))
def test_plan_files_cross_the_packages(name, tmp_path):
    mine, theirs = _plan(planner, name), _plan(jplanner, name)
    assert mine.to_record() == theirs.to_record()
    assert mine.to_json() == theirs.to_json()
    assert mine.struct_hash() == theirs.struct_hash()
    assert mine.struct_hash(ignore_sizes=True) == \
        theirs.struct_hash(ignore_sizes=True)
    p_path, j_path = str(tmp_path / "p.json"), str(tmp_path / "j.json")
    mine.save(p_path)
    theirs.save(j_path)
    assert jplanner.ShardingPlan.load(p_path) == theirs
    assert planner.ShardingPlan.load(j_path) == mine
    assert repr(mine) == repr(theirs)


def _named_shapes(pkg_models, port):
    """(name, shape) of every parameter of bert_small and llama_tiny (the
    JAX nets after one call, for their deferred shapes)."""
    out = []
    if port:
        with mx.cpu():
            b = models.BERTForPretrain(models.bert_small(
                vocab_size=200, max_length=32, num_layers=2))
            lm = models.LlamaForCausalLM(models.get_llama(
                "llama_tiny", vocab_size=64), tie_embeddings=False)
    else:
        from mxnet_tpu import nd as jnd
        b = jmodels.BERTForPretrain(jmodels.bert_small(
            vocab_size=200, max_length=32, num_layers=2))
        b.initialize(jmx.init.Xavier())
        x = jnd.array(np.zeros((2, 32), "f4"))
        b(x, x, None, jnd.array(np.zeros((2, 4), "f4")))
        lm = jmodels.LlamaForCausalLM(jmodels.get_llama(
            "llama_tiny", vocab_size=64), tie_embeddings=False)
        lm.initialize(jmx.init.Xavier())
        lm(jnd.array(np.zeros((1, 4), "f4")))
    for net in (b, lm):
        out += [(n, tuple(p.shape))
                for n, p in net.collect_params().items()]
    return sorted(out, key=lambda t: _unnumbered(t[0]))


def _unnumbered(name):
    import re
    return re.sub(r"^([a-z]+)\d+_", r"\1_", name)


@pytest.mark.parametrize("axes", [{"dp": 4, "tp": 2}, {"dp": 1, "tp": 8},
                                  {"dp": 2, "tp": 2, "pp": 2}])
def test_megatron_specs_of_every_bert_and_llama_parameter(axes):
    mine = _named_shapes(models, port=True)
    theirs = _named_shapes(jmodels, port=False)
    assert [_unnumbered(n) for n, _ in mine] == \
        [_unnumbered(n) for n, _ in theirs]
    assert [s for _, s in mine] == [s for _, s in theirs]
    p, j = planner.ShardingPlan(axes, planner.megatron_rules()), \
        jplanner.ShardingPlan(axes, jplanner.megatron_rules())
    for (n, shape), (jn, _) in zip(mine, theirs):
        assert p.spec_for(n, shape) == j.spec_for(jn, shape), n
        spec = p.partition_spec(n, shape)
        jspec = j.partition_spec(jn, shape)
        assert (spec is None) == (jspec is None)
        if spec is not None:
            assert tuple(spec) == tuple(jspec)
        assert p.stage_of(n, 2) == j.stage_of(jn, 2)
    strip = lambda res: [tuple(sorted(
        (k, v) for k, v in r.items())) for r in res.values()]
    assert strip(p.resolve(mine)) == strip(j.resolve(theirs))
    cov, jcov = p.coverage(mine), j.coverage(theirs)
    assert not cov["uncovered"] and not jcov["uncovered"]
    assert [r[1:] for r in cov["demoted"]] == \
        [r[1:] for r in jcov["demoted"]]
    assert cov["shadowed"] == jcov["shadowed"]
    assert (p.param_rule() is None) == (j.param_rule() is None)


def test_llama_rule_and_memory_plan_match_jax():
    rule, jrule = parallel.llama_param_rule(), jpar.llama_param_rule()
    mine = _named_shapes(models, port=True)
    for n, shape in mine:
        got, want = rule(n, shape), jrule(n, shape)
        assert (got is None) == (want is None), n
        if got is not None:
            assert tuple(got) == tuple(want), n
    with mx.cpu():
        lm = models.LlamaForCausalLM(models.get_llama(
            "llama_tiny", vocab_size=64, num_layers=4),
            tie_embeddings=False)
    jlm = jmodels.LlamaForCausalLM(jmodels.get_llama(
        "llama_tiny", vocab_size=64, num_layers=4), tie_embeddings=False)
    for kw in (dict(mesh={"tp": 2}, rule=rule),
               dict(mesh={"tp": 2, "pp": 2}, rule=rule, pp_axis="pp")):
        got = parallel.sharding_plan(lm, **kw)
        jkw = dict(kw, rule=jrule)
        want = jpar.sharding_plan(jlm, **jkw)
        for k in ("total_params", "per_stage_bytes", "max_device_bytes"):
            assert got[k] == want[k], k
    plan = parallel.ShardingPlan({"tp": 2, "pp": 2, "dp": 1},
                                 parallel.megatron_rules())
    jplan = jpar.ShardingPlan({"tp": 2, "pp": 2, "dp": 1},
                              jpar.megatron_rules())
    got, want = parallel.sharding_plan(lm, rule=plan), \
        jpar.sharding_plan(jlm, rule=jplan)
    assert got["per_stage_bytes"] == want["per_stage_bytes"]


def test_errors_match_jax():
    for pkg in (planner, jplanner):
        err = mx.MXNetError if pkg is planner else jmx.MXNetError
        for args, kw, match in (
                (({},), {}, "at least one"),
                (({"tp": 2},), {}, "dp_axis"),
                (({"dp": 2}, [("x", ("tp",))]), {}, "names mesh axis"),
                (({"dp": 2}, [("(", ())]), {}, "does not compile"),
                (({"dp": 2},), {"zero_stage": 3}, "zero_stage"),
                (({"dp": 2},), {"precision": {"wire": "int8"}}, "wire leg"),
                (({"dp": 2},), {"stage_rules": [("x", 1)]}, "stage")):
            with pytest.raises(err, match=match):
                pkg.ShardingPlan(*args, **kw)
        with pytest.raises(err, match="format"):
            pkg.ShardingPlan.from_record({"format": 9})
        with pytest.raises(err, match="malformed"):
            pkg.ShardingPlan.from_json("{")


def test_diff_flat_rows_and_records_match_jax():
    a, ja = _plan(planner, "dp4tp2"), _plan(jplanner, "dp4tp2")
    b = planner.ShardingPlan({"dp": 8}, [(r".", ())])
    jb = jplanner.ShardingPlan({"dp": 8}, [(r".", ())])
    shapes = [("x_attn_q_weight", (64, 64)), ("x_innorm_gamma", (64,)),
              ("s", (1,))]
    got = a.diff(b, shapes)
    want = ja.diff(jb, shapes)
    assert [(r["name"], r["from_spec"], r["to_spec"], r["moves"])
            for r in got] == [(r["name"], r["from_spec"], r["to_spec"],
                               r["moves"]) for r in want]
    for shape in [(7,), (3, 5), (8, 8)]:
        assert planner.flat_rows(shape, 4) == jplanner.flat_rows(shape, 4)
    assert planner.diff_records(a.to_record(), b.to_record()) == \
        jplanner.diff_records(ja.to_record(), jb.to_record())
    assert planner.diff_records(a.to_record(), a.to_record()) is None


def test_moe_rule_and_placements():
    from torch.distributed.tensor import Replicate, Shard
    rule, jrule = parallel.moe_param_rule("ep", inner=parallel.
                                          llama_param_rule()), \
        jpar.moe_param_rule("ep", inner=jpar.llama_param_rule())
    for name, shape in (("moe_expert_w1", (4, 8, 16)),
                        ("moe_expert_b1", (4, 16)),
                        ("moe_gate_weight", (8, 4)),
                        ("m_layer0_attn_q_weight", (8, 8))):
        got, want = rule(name, shape), jrule(name, shape)
        assert (got is None) == (want is None)
        if got is not None:
            assert tuple(got) == tuple(want)
    assert planner.placements(("tp", None), ["dp", "tp"]) == \
        [Replicate(), Shard(0)]
    assert planner.placements((None, ("dp", "tp")), ["dp", "tp"]) == \
        [Shard(1), Shard(1)]
    with pytest.raises(mx.MXNetError, match="names axis"):
        planner.placements(("ep",), ["dp"])


def test_plan_from_env_and_note_plan(tmp_path, monkeypatch):
    assert planner.plan_from_env() is None
    path = str(tmp_path / "plan.json")
    _plan(jplanner, "pp").save(path)
    monkeypatch.setenv("MXTPU_SHARDING_PLAN", path)
    assert planner.plan_from_env() == _plan(planner, "pp")
    with open(path, "w") as f:
        f.write("{")
    with pytest.raises(mx.MXNetError, match="malformed"):
        planner.plan_from_env()
    planner.note_plan("t", _plan(planner, "tuple"), [("w", (4, 4))])
    assert planner.plans()["t"]["named_shapes"] == [("w", (4, 4))]
    planner._reset()
    assert planner.plans() == {}
    with mx.cpu():
        mesh, axis = planner.resolve_plan_axis(
            planner.ShardingPlan({"dp": 1, "sp": 1}), None, "x", "sp_axis")
    assert axis == "sp" and mesh.shape == {"dp": 1, "sp": 1}
