"""Tensor and expert parallel layouts of ``DataParallelTrainer``
(``param_sharding=``, ``plan=``) over gloo groups of four ranks, against
the JAX package's trainer on meshes of four virtual CPU devices, with
the same rules, weights and global batches:

* ``test_tp_param_sharding``'s MLP and rule (``tests/test_parallel.py``)
  at dp2 x tp2 and tp4, SGD;
* ``bert_small`` (2 layers, vocab 200, dropout 0) under
  ``ShardingPlan(..., megatron_rules())`` at dp2 x tp2 and tp4, Adam;
* an MoE layer under ``moe_param_rule("ep")`` at dp2 x ep2, SGD, as
  ``tests/test_moe.py::test_moe_expert_parallel_matches_single_device``.

Three steps each; losses and weights agree within rtol 1e-4 and atol
1e-5 (float32; the products run on shards, so sums differ in order).
One spawn of four ranks runs every case.  The constructor's conflicts
(plan with param_sharding, a dp_axis or mesh unlike the plan's,
compression with a rule, the environment's plan) are held in one
process.
"""
import os
import re

import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu import models as jmodels
from mxnet_tpu import nd as jnd
from mxnet_tpu import parallel as jpar
from mxnet_tpu.gluon import nn as jnn
from mxnet_tpu.gluon.block import HybridBlock as JHybridBlock
from mxnet_tpu.gluon.contrib.nn import MoEFFN as JMoEFFN
from mxnet_tpu.gluon.loss import L2Loss as JL2
from mxnet_tpu.gluon.loss import SoftmaxCrossEntropyLoss as JSCE

import torch_dist

STEPS = 3
V, S, M, B = 200, 32, 4, 8
MESHES = {"dp2tp2": {"dp": 2, "tp": 2}, "tp4": {"dp": 1, "tp": 4}}

_WORKER = r'''
import numpy as np
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import models, nd, parallel
from mxnet_tpu_torch.gluon import HybridBlock, nn
from mxnet_tpu_torch.gluon.contrib.nn import MoEFFN
from mxnet_tpu_torch.gluon.loss import L2Loss, SoftmaxCrossEntropyLoss
from mxnet_tpu_torch.parallel.planner import PartitionSpec as P


def mlp_rule(name, shape):
    if name.endswith("weight") and len(shape) == 2 and shape[0] % 4 == 0:
        return P("tp", None)
    return None


class FullLen(HybridBlock):
    def __init__(self, mod, **kw):
        super().__init__(**kw)
        with self.name_scope():
            self.mod = mod

    def hybrid_forward(self, F, tokens, types, positions):
        return self.mod(tokens, types, None, positions)


class MoENet(HybridBlock):
    def __init__(self, **kw):
        super().__init__(**kw)
        with self.name_scope():
            self.moe = MoEFFN(8, 16, num_experts=4, k=1,
                              capacity_factor=8.0)
            self.head = nn.Dense(3, flatten=False, in_units=8)

    def hybrid_forward(self, F, x):
        out, aux = self.moe(x)
        return self.head(out)


def weights(net):
    return {k: p.data().asnumpy() for k, p in net.collect_params().items()}


def set_weights(net, w):
    params = net.collect_params()
    for name, value in w.items():
        params[name].set_data(value)


def run(dpt, x, y):
    return [float(dpt.step(x[i], y[i])) for i in range(len(x))]


def mlp(inp, axes):
    net = nn.HybridSequential(prefix="net_")
    with net.name_scope():
        net.add(nn.Dense(16, activation="relu", in_units=8),
                nn.Dense(4, in_units=16))
    net.initialize(ctx=mx.cpu())
    set_weights(net, inp["mlp_w0"])
    dpt = parallel.DataParallelTrainer(
        net, L2Loss(), "sgd", {"learning_rate": 0.1},
        mesh=parallel.make_mesh(axes), param_sharding=mlp_rule)
    losses = run(dpt, inp["mlp_x"], inp["mlp_y"])
    shard = dpt._dparams["0.weight"].to_local().shape
    return {"losses": losses, "params": weights(net), "shard": shard}


def bert(inp, axes):
    inner = models.BERTForPretrain(models.bert_small(
        vocab_size=inp["V"], max_length=inp["S"], dropout=0.0,
        num_layers=2))
    inner.initialize(mx.init.Xavier(), ctx=mx.cpu())
    models.load_jax_bert_params(inner, inp["bert_w0"])
    sce = SoftmaxCrossEntropyLoss()
    m = inp["M"]

    def loss_fn(outs, label):
        mlm, nsp = outs
        return sce(mlm, label[:, :m].reshape((-1,))).mean() + \
            sce(nsp, label[:, m]).mean()
    plan = parallel.ShardingPlan(axes, parallel.megatron_rules())
    dpt = parallel.DataParallelTrainer(FullLen(inner), loss_fn, "adam",
                                       {"learning_rate": 1e-3}, plan=plan)
    data = tuple(inp[k] for k in ("tokens", "types", "positions"))
    losses = [float(dpt.step(data, inp["label"])) for _ in range(3)]
    return {"losses": losses,
            "params": {k: p.data().asnumpy()
                       for k, p in inner.collect_params().items()},
            "sharded": sum(1 for pl in dpt._placements
                           if any(p.is_shard() for p in pl))}


def moe(inp):
    net = MoENet(prefix="moenet_")
    net.initialize(ctx=mx.cpu())
    set_weights(net, inp["moe_w0"])
    dpt = parallel.DataParallelTrainer(
        net, SoftmaxCrossEntropyLoss(), "sgd", {"learning_rate": 0.1},
        mesh=parallel.make_mesh({"dp": 2, "ep": 2}),
        param_sharding=parallel.moe_param_rule("ep"))
    losses = [float(dpt.step(inp["moe_x"], inp["moe_y"]))
              for _ in range(3)]
    shard = dpt._dparams["moe.expert_w1"].to_local().shape
    return {"losses": losses, "params": weights(net), "shard": shard}


def main(rank, world, inp):
    out = {}
    for tag, axes in inp["meshes"].items():
        out[("mlp", tag)] = mlp(inp, axes)
        out[("bert", tag)] = bert(inp, axes)
    out["moe"] = moe(inp)
    return out
'''


class _JFullLen(JHybridBlock):
    def __init__(self, mod, **kw):
        super().__init__(**kw)
        with self.name_scope():
            self.mod = mod

    def hybrid_forward(self, F, tokens, types, positions):
        return self.mod(tokens, types, None, positions)


class _JMoENet(JHybridBlock):
    def __init__(self, **kw):
        super().__init__(**kw)
        with self.name_scope():
            self.moe = JMoEFFN(8, 16, num_experts=4, k=1,
                               capacity_factor=8.0)
            self.head = jnn.Dense(3, flatten=False, in_units=8)

    def hybrid_forward(self, F, x):
        out, aux = self.moe(x)
        return self.head(out)


def _mlp_rule(name, shape):
    from jax.sharding import PartitionSpec as P
    if name.endswith("weight") and len(shape) == 2 and shape[0] % 4 == 0:
        return P("tp", None)
    return None


def _jweights(net):
    return {k: p.data().asnumpy() for k, p in net.collect_params().items()}


def _jmlp(seed=13):
    np.random.seed(seed)
    jmx.random.seed(seed)
    net = jnn.HybridSequential(prefix="net_")
    with net.name_scope():
        net.add(jnn.Dense(16, activation="relu", in_units=8),
                jnn.Dense(4, in_units=16))
    net.initialize(jmx.init.Xavier(), ctx=jmx.cpu(0))
    return net


def _jbert(x):
    jmx.random.seed(5)
    inner = jmodels.BERTForPretrain(jmodels.bert_small(
        vocab_size=V, max_length=S, dropout=0.0, num_layers=2))
    inner.initialize(jmx.init.Xavier(), ctx=jmx.cpu(0))
    data = tuple(jnd.array(x[k]) for k in ("tokens", "types", "positions"))
    inner(data[0], data[1], None, data[2])
    return inner


def _jmoe():
    np.random.seed(0)
    jmx.random.seed(0)
    net = _JMoENet(prefix="moenet_")
    net.initialize(jmx.init.Xavier(), ctx=jmx.cpu(0))
    net(jnd.array(np.zeros((2, 3, 8), "f4")))
    return net


def _inputs():
    rng = np.random.RandomState(21)
    inp = {"meshes": MESHES, "V": V, "S": S, "M": M,
           "mlp_x": rng.rand(STEPS, 4, 8).astype("f4"),
           "mlp_y": rng.rand(STEPS, 4, 4).astype("f4"),
           "tokens": rng.randint(0, V, (B, S)).astype("f4"),
           "types": rng.randint(0, 2, (B, S)).astype("f4"),
           "positions": rng.randint(0, S, (B, M)).astype("f4"),
           "moe_x": rng.randn(4, 6, 8).astype("f4"),
           "moe_y": rng.randint(0, 3, (4, 6)).astype("f4")}
    inp["label"] = np.concatenate([rng.randint(0, V, (B, M)),
                                   rng.randint(0, 2, (B, 1))],
                                  1).astype("f4")
    inp["mlp_w0"] = _jweights(_jmlp())
    inp["bert_w0"] = _jweights(_jbert(inp))
    inp["moe_w0"] = _jweights(_jmoe())
    return inp


def _jax_mlp(inp, axes):
    net = _jmlp()
    dpt = jpar.DataParallelTrainer(
        net, JL2(), "sgd", {"learning_rate": 0.1},
        mesh=jpar.make_mesh(axes), param_sharding=_mlp_rule)
    losses = [float(dpt.step(jnd.array(inp["mlp_x"][i]),
                             jnd.array(inp["mlp_y"][i])).asnumpy())
              for i in range(STEPS)]
    return {"losses": losses, "params": _jweights(net)}


def _jax_bert(inp, axes):
    """The JAX trainer from ``bert_w0`` (a second net made after the same
    seed does not draw the same weights)."""
    inner = _jbert(inp)
    tail = {_unnumbered(n): v for n, v in inp["bert_w0"].items()}
    for name, p in inner.collect_params().items():
        p.set_data(jnd.array(tail[_unnumbered(name)]))
    sce = JSCE()

    def loss_fn(outs, label):
        mlm, nsp = outs
        return sce(mlm, label[:, :M].reshape((-1,))).mean() + \
            sce(nsp, label[:, M]).mean()
    plan = jpar.ShardingPlan(axes, jpar.megatron_rules())
    dpt = jpar.DataParallelTrainer(_JFullLen(inner), loss_fn, "adam",
                                   {"learning_rate": 1e-3}, plan=plan)
    data = tuple(jnd.array(inp[k]) for k in ("tokens", "types",
                                              "positions"))
    label = jnd.array(inp["label"])
    start = _jweights(inner)
    losses = [float(dpt.step(data, label).asnumpy()) for _ in range(3)]
    return {"losses": losses, "params": _jweights(inner), "start": start}


def _jax_moe(inp):
    net = _jmoe()
    dpt = jpar.DataParallelTrainer(
        net, JSCE(), "sgd", {"learning_rate": 0.1},
        mesh=jpar.make_mesh({"dp": 2, "ep": 2}),
        param_sharding=jpar.moe_param_rule("ep"))
    losses = [float(dpt.step(jnd.array(inp["moe_x"]),
                             jnd.array(inp["moe_y"])).asnumpy())
              for _ in range(3)]
    return {"losses": losses, "params": _jweights(net)}


_STATE = {}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    if not _STATE:
        inp = _inputs()
        _STATE["inp"] = inp
        _STATE["out"] = torch_dist.spawn(4, _WORKER, inp,
                                         tmp_path_factory.mktemp("tp4"),
                                         timeout=240)
    return _STATE["inp"], _STATE["out"]


def _close(got, want, what, names=None, bound=None, start=None):
    """Losses within rtol 1e-4, atol 1e-5, and the weights: element by
    element at the same tolerance after SGD; after Adam (``bound`` is
    its largest move) in relative L2 within 1e-4, since Adam divides each
    element's gradient by its own size and so turns the float32 noise of
    a gradient that is mostly cancellation into a step of up to lr (the
    other Adam trajectory tests compare so); a tensor that starts at 0
    (its ``start``), whose every small gradient's sign is such noise, and
    an attention key bias, which has no gradient in exact arithmetic,
    within ``bound`` of 0 on both sides (twice lr times the steps: with
    its bias corrections Adam's move in a step exceeds lr a little)."""
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-4,
                               atol=1e-5, err_msg=f"{what}: losses")
    for name, w in want["params"].items():
        mine = got["params"][names(name) if names else name]
        if bound is None:
            np.testing.assert_allclose(mine, w, rtol=1e-4, atol=1e-5,
                                       err_msg=f"{what}: {name}")
        elif name.endswith("key_bias") or not np.any(start[name]):
            for side in (mine, w):
                assert np.abs(side).max() <= bound, (what, name)
        else:
            rel = np.linalg.norm(mine - w) / max(np.linalg.norm(w), 1e-12)
            assert rel <= 1e-4, (what, name, rel)


@pytest.mark.parametrize("tag", sorted(MESHES))
def test_tp_param_sharding_mlp_matches_jax(ranks, tag):
    inp, out = ranks
    want = _jax_mlp(inp, MESHES[tag])
    tp = MESHES[tag]["tp"]
    for r in range(4):
        got = out[r][("mlp", tag)]
        _close(got, want, f"rank {r} mlp {tag}")
        # the rule's weight is held as its shard: 16 rows over tp
        assert tuple(got["shard"]) == (16 // tp, 8)


def _unnumbered(name):
    """A parameter name without its leading block's number (each process
    numbers its blocks from its own count)."""
    return re.sub(r"^([a-z]+)\d+_", r"\1_", name)


def _bert_names(want, got):
    """The port's name of each JAX name: equal up to the numbers of the
    leading blocks."""
    by_tail = {_unnumbered(n): n for n in got}
    assert len(by_tail) == len(got) == len(want)
    return lambda name: by_tail[_unnumbered(name)]


@pytest.mark.parametrize("tag", sorted(MESHES))
def test_bert_small_under_megatron_rules_matches_jax(ranks, tag):
    inp, out = ranks
    want = _jax_bert(inp, MESHES[tag])
    assert want["losses"][-1] < want["losses"][0]
    for r in range(4):
        got = out[r][("bert", tag)]
        # q/k/v and ffn1 (weights and biases), out, ffn2: 10 a layer,
        # and the word embedding at least
        assert got["sharded"] >= 2 * 10 + 1, got["sharded"]
        _close(got, want, f"rank {r} bert {tag}",
               _bert_names(want["params"], got["params"]),
               bound=2 * 3 * 1e-3, start=want["start"])


def test_moe_expert_parallel_matches_jax_dp2_ep2(ranks):
    inp, out = ranks
    want = _jax_moe(inp)
    for r in range(4):
        got = out[r]["moe"]
        _close(got, want, f"rank {r} moe")
        assert tuple(got["shard"]) == (2, 8, 16)     # 4 experts over ep2


# -- the constructor's conflicts (one process) --------------------------------

def _port_mlp():
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon import nn
    net = nn.HybridSequential(prefix="net_")
    with net.name_scope():
        net.add(nn.Dense(4, in_units=8))
    net.initialize(ctx=mx.cpu())
    return net


def test_trainer_layout_conflicts_raise_as_jax(tmp_path, monkeypatch):
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import parallel
    from mxnet_tpu_torch.gluon.loss import L2Loss
    plan = parallel.ShardingPlan({"dp": 1, "tp": 1},
                                 parallel.megatron_rules())
    with mx.cpu():
        net = _port_mlp()
        for kwargs, match in (
                ({"plan": plan, "param_sharding": lambda n, s: None},
                 "not both"),
                ({"plan": plan, "dp_axis": "data"}, "conflicts"),
                ({"plan": plan,
                  "mesh": parallel.make_mesh({"dp": 1})}, "do not match"),
                ({"plan": "plan.json"}, "ShardingPlan"),
                ({"param_sharding": parallel.moe_param_rule(),
                  "fuse_step": True, "compression": {"type": "int8"}},
                 "cannot combine")):
            with pytest.raises(mx.MXNetError, match=match):
                parallel.DataParallelTrainer(net, L2Loss(), "sgd",
                                             {"learning_rate": 0.1},
                                             **kwargs)
        # the environment's plan is taken when nothing says otherwise,
        # and ignored (with a warning) beside an explicit unlike mesh
        path = str(tmp_path / "plan.json")
        parallel.ShardingPlan({"dp": 1}, zero_stage=0).save(path)
        monkeypatch.setenv("MXTPU_SHARDING_PLAN", path)
        dpt = parallel.DataParallelTrainer(net, L2Loss(), "sgd",
                                           {"learning_rate": 0.1})
        assert dpt.plan == parallel.ShardingPlan.load(path)
        with pytest.warns(UserWarning, match="explicit mesh axes"):
            dpt = parallel.DataParallelTrainer(
                net, L2Loss(), "sgd", {"learning_rate": 0.1},
                mesh=parallel.make_mesh({"data": 1}), dp_axis="data")
        assert dpt.plan is None


def test_a_rule_without_a_process_group_raises():
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import parallel
    from mxnet_tpu_torch.gluon.loss import L2Loss
    with mx.cpu():
        with pytest.raises(mx.MXNetError, match="process group"):
            parallel.DataParallelTrainer(
                _port_mlp(), L2Loss(), "sgd", {"learning_rate": 0.1},
                param_sharding=parallel.moe_param_rule("dp"))
