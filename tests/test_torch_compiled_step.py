"""The port's captured training step on the CPU: ``DataParallelTrainer``
with ``fuse_step=True`` (``step``, ``step_multi``) and gluon
``Trainer.compile_step``.

On the CPU a captured step runs its step body eagerly (there is no
graph), so these tests hold what a replay depends on:

* ``step_multi`` is K ``step()`` calls bit for bit (losses, weights, Adam
  states, dropout included), and ``step`` after it continues the same
  trajectory;
* the step body does no host sync and bakes in no per-step host value:
  under a ``TorchDispatchMode`` that fails on ``_local_scalar_dense``,
  ``nonzero`` and ``is_nonzero``, the non-tensor arguments of every op at
  step 1 equal those at step 5, with the learning rate, the batch size and
  Adam's step changed in between (a graph replays step 1's arguments, so
  this is what shows that a replay computes step 5);
* the trajectories match the JAX package's eager runs from the same
  weights (dropout 0, the float32 tolerances of ``mxnet_tpu/test_utils``):
  bert_small through ``DataParallelTrainer.step_multi(repeat=3)`` and the
  MLP through ``compile_step`` with SGD and momentum;
* ``CompiledStep``: the learning rate and batch size reach the step
  without changing its static key, momentum changes the key and matches a
  fresh eager run, ``MXTPU_COMPILED_STEP=0`` gives the eager loop, and an
  ineligible step falls back and is reported.
"""
import jax
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import mxnet_tpu as jmx
from mxnet_tpu import engine as jengine
from mxnet_tpu import models as jmodels
from mxnet_tpu import parallel as jparallel
from mxnet_tpu.gluon.block import HybridBlock as JaxHybridBlock
from mxnet_tpu.gluon.loss import SoftmaxCrossEntropyLoss as JaxSCE
from mxnet_tpu.ops import flash_attention as fa_mod
from mxnet_tpu.test_utils import assert_almost_equal
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, gluon, models, nd, parallel
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon import compiled_step as csmod
from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss

CPU = mx.cpu()
B, S, M = 2, 128, 4
aten = torch.ops.aten


# -- helpers ---------------------------------------------------------------------

def _bert_batch(vocab, k=None, seed=0):
    """bench.py's batch (tokens, types, masked positions; labels), or K
    of them stacked."""
    rng = np.random.RandomState(seed)
    lead = (k,) if k else ()
    data = (rng.randint(0, vocab, lead + (B, S)).astype("f"),
            rng.randint(0, 2, lead + (B, S)).astype("f"),
            rng.randint(0, S, lead + (B, M)).astype("f"))
    label = np.concatenate([rng.randint(0, vocab, lead + (B, M)),
                            rng.randint(0, 2, lead + (B, 1))],
                           -1).astype("f")
    return data, label


class _Pretrain(gluon.HybridBlock):
    """bench.py's _FullLenPretrain."""

    def __init__(self, mod, **kw):
        super().__init__(**kw)
        with self.name_scope():
            self.mod = mod

    def hybrid_forward(self, F, t, ty, p):
        return self.mod(t, ty, None, p)


def _pretrain_loss(sce):
    def loss_fn(outs, label):
        mlm, nsp = outs
        return sce(mlm, label[:, :M].reshape((-1,))).mean() + \
            sce(nsp, label[:, M]).mean()
    return loss_fn


def _dpt(vocab=50, layers=1, dropout=0.1, seed=3, fuse_step=True):
    inner = models.BERTForPretrain(models.bert_small(
        vocab_size=vocab, max_length=S, dropout=dropout, num_layers=layers))
    model = _Pretrain(inner).initialize(mx.init.Xavier(), ctx=CPU,
                                        seed=seed)
    return parallel.DataParallelTrainer(
        model, _pretrain_loss(SoftmaxCrossEntropyLoss()), "adam",
        {"learning_rate": 1e-3},
        mesh=parallel.make_mesh({"dp": 1}, devices=[CPU]),
        fuse_step=fuse_step)


def _dpt_state(dpt):
    return ([p.detach().clone() for p in dpt._params],
            [t.clone() for s in dpt._states for t in s])


def _mlp(pkg=mx, widths=(6, 8, 3), dropout=0.0, prefix="mlp_"):
    nn = pkg.gluon.nn
    net = nn.HybridSequential(prefix=prefix)
    with net.name_scope():
        for i, (a, b) in enumerate(zip(widths[:-1], widths[1:])):
            last = i == len(widths) - 2
            net.add(nn.Dense(b, activation=None if last else "relu",
                             in_units=a))
            if dropout and not last:
                net.add(nn.Dropout(dropout))
    if pkg is mx:
        net.initialize(pkg.init.Xavier(), ctx=CPU, seed=7)
    else:
        net.initialize(pkg.init.Xavier(), ctx=pkg.cpu())
    net.hybridize()
    return net


def _mlp_batch(n=4, widths=(6, 8, 3), seed=2):
    rng = np.random.RandomState(seed)
    return (rng.rand(n, widths[0]).astype("f4"),
            rng.randint(0, widths[-1], n).astype("f4"))


def _eager_step(net, trainer, loss_fn, x, y, batch_size):
    with autograd.record():
        loss = loss_fn(net(x), y)
    loss.backward()
    trainer.step(batch_size)
    return loss


def _weights(net):
    return [p.data().asnumpy() for p in net.collect_params().values()]


def _assert_equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


# -- step_multi is K steps -------------------------------------------------------

@pytest.mark.parametrize("form", ["repeat", "stacked"])
def test_step_multi_is_k_steps_bit_for_bit(form):
    """bert_small with dropout 0.1 (the same mx.random stream on both
    sides): K=3 steps through step_multi equal 3 step() calls in losses,
    weights and Adam states, and a step() after step_multi continues the
    trajectory."""
    k = 3
    if form == "repeat":
        data, label = _bert_batch(50)
        batches = [(data, label)] * k
    else:
        data, label = _bert_batch(50, k=k)
        batches = [(tuple(x[i] for x in data), label[i]) for i in range(k)]
    nxt = _bert_batch(50, seed=9)

    mx.random.seed(0)
    one = _dpt()
    want = [one.step(d, l) for d, l in batches]
    want_next = one.step(*nxt)

    mx.random.seed(0)
    multi = _dpt()
    got = multi.step_multi(data, label,
                           repeat=k if form == "repeat" else None)
    assert tuple(got.shape) == (k,)
    assert torch.equal(got, torch.stack(want))
    assert multi.num_update == k
    got_next = multi.step(*nxt)
    assert torch.equal(got_next, want_next)
    wa, sa = _dpt_state(one)
    wb, sb = _dpt_state(multi)
    assert all(torch.equal(x, y) for x, y in zip(wa, wb))
    assert all(torch.equal(x, y) for x, y in zip(sa, sb))
    assert multi.captures == multi.replays == 0          # no graph here


def test_step_multi_checks():
    data, label = _bert_batch(50)
    with pytest.raises(MXNetError, match="fuse_step=True"):
        _dpt(fuse_step=False).step_multi(data, label, repeat=2)
    dpt = _dpt()
    with pytest.raises(MXNetError, match="positive"):
        dpt.step_multi(data, label, repeat=0)
    kdata, klabel = _bert_batch(50, k=2)
    with pytest.raises(MXNetError, match="leading dims"):
        dpt.step_multi(kdata, klabel[:1])
    nd_losses = dpt.step_multi(tuple(nd.array(x, ctx=CPU) for x in data),
                               nd.array(label, ctx=CPU), repeat=2)
    assert isinstance(nd_losses, nd.NDArray) and nd_losses.shape == (2,)


# -- no host sync and no baked step scalar ---------------------------------------

_SYNCS = (aten._local_scalar_dense, aten.nonzero, aten.is_nonzero)


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
    """Fails on a host sync; records every op with its non-tensor
    arguments."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func.overloadpacket in _SYNCS:
            raise AssertionError(f"host sync in the step body: {func}")
        self.ops.append((str(func), _plain(args), _plain(kwargs)))
        return func(*args, **kwargs)


def _record_body(monkeypatch, owner, steps, on_step):
    """Run ``owner``'s step body under ``_StepOps`` at ``steps``;
    ``on_step(i)`` runs step i.  Returns {step: ops}."""
    body = owner._body
    seen = {}
    current = [0]

    def recorded(*args):
        if current[0] not in steps:
            return body(*args)
        with _StepOps() as mode:
            out = body(*args)
        seen[current[0]] = mode.ops
        return out
    monkeypatch.setattr(owner, "_body", recorded)
    for i in range(1, 6):
        current[0] = i
        on_step(i)
    return seen


def test_dpt_step_body_has_no_host_sync_and_no_step_scalar(monkeypatch):
    data, label = _bert_batch(50)
    mx.random.seed(0)
    dpt = _dpt()

    def on_step(i):
        if i == 3:
            dpt.optimizer.learning_rate = 5e-4
        dpt.step(data, label)
    seen = _record_body(monkeypatch, dpt, (1, 5), on_step)
    assert len(seen[1]) > 100
    assert seen[1] == seen[5]
    # and step 5's values reached the update through the device scalars
    lr_t = dpt._scalars[0]
    assert lr_t.item() == pytest.approx(dpt.optimizer.corrected_lr(5),
                                        rel=1e-6)
    assert dpt.optimizer.corrected_lr(5) != dpt.optimizer.corrected_lr(1)


@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_compiled_step_body_has_no_host_sync_and_no_step_scalar(
        monkeypatch, momentum):
    """SGD (the fused form without momentum; with momentum) and a
    dropout MLP: the learning rate changes at step 3 and the batch size
    (rescale_grad) at step 4, and step 5's weights equal those of the
    eager loop with the same changes."""
    x, y = _mlp_batch()
    schedule = {3: ("lr", 0.02), 4: ("batch", 8)}

    def run(compiled, monkeypatch=None):
        mx.random.seed(0)
        net = _mlp(dropout=0.2)
        tr = gluon.Trainer(net.collect_params(), "sgd",
                           {"learning_rate": 0.1, "momentum": momentum})
        lf = gluon.loss.SoftmaxCrossEntropyLoss()
        cs = tr.compile_step(net, lf)
        xx, yy = nd.array(x, ctx=CPU), nd.array(y, ctx=CPU)
        state = {"batch": 4}

        def on_step(i):
            kind, v = schedule.get(i, (None, None))
            if kind == "lr":
                tr.set_learning_rate(v)
            elif kind == "batch":
                state["batch"] = v
            if compiled:
                cs.step(xx, yy, state["batch"])
                assert cs.last_path == "compiled"
            else:
                _eager_step(net, tr, lf, xx, yy, state["batch"])
        if compiled:
            seen = _record_body(monkeypatch, cs, (1, 5), on_step)
        else:
            seen = None
            for i in range(1, 6):
                on_step(i)
        return seen, _weights(net)

    seen, got = run(True, monkeypatch)
    assert len(seen[1]) > 20
    assert seen[1] == seen[5]
    _, want = run(False)
    _assert_equal(got, want)


def test_compiled_adam_step_body_has_no_host_sync_and_matches_eager(
        monkeypatch):
    """``compile_step`` with ``gluon.Trainer(..., "adam")``: the step
    body is graph-safe (no fallback report, no host sync, step 1's and
    step 5's non-tensor op arguments equal although the learning rate,
    the batch size and Adam's step t changed), and step 5's weights and
    losses equal the eager loop's with the same changes."""
    x, y = _mlp_batch()
    schedule = {3: ("lr", 0.02), 4: ("batch", 8)}

    def run(compiled, monkeypatch=None):
        mx.random.seed(0)
        net = _mlp(dropout=0.2)
        tr = gluon.Trainer(net.collect_params(), "adam",
                           {"learning_rate": 0.01, "wd": 1e-3})
        lf = gluon.loss.SoftmaxCrossEntropyLoss()
        cs = tr.compile_step(net, lf)
        xx, yy = nd.array(x, ctx=CPU), nd.array(y, ctx=CPU)
        state = {"batch": 4}
        losses = []

        def on_step(i):
            kind, v = schedule.get(i, (None, None))
            if kind == "lr":
                tr.set_learning_rate(v)
            elif kind == "batch":
                state["batch"] = v
            if compiled:
                losses.append(cs.step(xx, yy, state["batch"]).asnumpy())
                assert cs.last_path == "compiled"
            else:
                losses.append(_eager_step(net, tr, lf, xx, yy,
                                          state["batch"]).asnumpy())
        if compiled:
            seen = _record_body(monkeypatch, cs, (1, 5), on_step)
            assert cs.fallback_reason is None
        else:
            seen = None
            for i in range(1, 6):
                on_step(i)
        assert tr.optimizer.num_update == 5
        return seen, losses, _weights(net)

    csmod.clear_fallback_reports()
    seen, got_l, got = run(True, monkeypatch)
    assert csmod.fallback_reports() == []
    assert len(seen[1]) > 20
    assert seen[1] == seen[5]
    _, want_l, want = run(False)
    _assert_equal(got, want)
    _assert_equal(got_l, want_l)


# -- against the JAX package -----------------------------------------------------

@pytest.fixture
def flash_kernels(monkeypatch):
    monkeypatch.setenv("MXTPU_FLASH_MODE", "always")
    monkeypatch.setattr(fa_mod, "_INTERPRET", True)
    jax.clear_caches()
    jengine.clear_cache()
    yield


class _JaxPretrain(JaxHybridBlock):
    def __init__(self, mod, **kw):
        super().__init__(**kw)
        with self.name_scope():
            self.mod = mod

    def hybrid_forward(self, F, t, ty, p):
        return self.mod(t, ty, None, p)


def test_step_multi_trajectory_matches_jax_eager_steps(flash_kernels):
    """bert_small (2 layers, vocab 200, dropout 0, f32) from the same
    weights: the port's step_multi(repeat=3) losses against three eager
    (fuse_step=False) steps of the JAX package's DataParallelTrainer, fed
    NDArrays as bench.py feeds them; then one more step() each."""
    vocab = 200
    cfg = dict(vocab_size=vocab, max_length=S, dropout=0.0, num_layers=2)
    data, label = _bert_batch(vocab)
    jmx.random.seed(0)
    jinner = jmodels.BERTForPretrain(jmodels.bert_small(**cfg))
    jmodel = _JaxPretrain(jinner)
    jmodel.initialize(jmx.init.Xavier())
    jdata = tuple(jmx.nd.array(x) for x in data)
    jmodel(*jdata)                     # sets the deferred Dense shapes
    params = {k: p.data().asnumpy()
              for k, p in jinner.collect_params().items()}
    jdpt = jparallel.DataParallelTrainer(
        jmodel, _pretrain_loss(JaxSCE()), "adam", {"learning_rate": 1e-3},
        mesh=jparallel.make_mesh({"dp": 1}), fuse_step=False)
    want = [float(jdpt.step(jdata, jmx.nd.array(label)).asnumpy())
            for _ in range(4)]

    inner = models.BERTForPretrain(models.bert_small(**cfg))
    model = _Pretrain(inner).initialize(mx.init.Xavier(), ctx=CPU)
    models.load_jax_bert_params(inner, params)
    dpt = parallel.DataParallelTrainer(
        model, _pretrain_loss(SoftmaxCrossEntropyLoss()), "adam",
        {"learning_rate": 1e-3},
        mesh=parallel.make_mesh({"dp": 1}, devices=[CPU]), fuse_step=True)
    tdata = tuple(nd.array(x, ctx=CPU) for x in data)
    tlabel = nd.array(label, ctx=CPU)
    got = list(dpt.step_multi(tdata, tlabel, repeat=3).asnumpy())
    got.append(float(dpt.step(tdata, tlabel).asnumpy()))
    assert_almost_equal(np.array(got, "f4"), np.array(want, "f4"))
    assert got[3] < got[0]


def test_compile_step_mlp_matches_jax_eager_loop():
    """An MLP (20-16-16-10, batch 32) with SGD, momentum 0.9 and weight
    decay: 3 steps of the port's compile_step against the JAX package's
    record -> backward -> Trainer.step, from the same weights."""
    widths = (20, 16, 16, 10)
    x, y = _mlp_batch(32, widths, seed=0)
    opt = {"learning_rate": 0.05, "momentum": 0.9, "wd": 1e-3}
    jnet, tnet = _mlp(jmx, widths), _mlp(mx, widths)
    models.load_jax_gluon_params(
        tnet, {k: v.data().asnumpy()
               for k, v in jnet.collect_params().items()}, jnet.prefix)
    jtr = jmx.gluon.Trainer(jnet.collect_params(), "sgd", opt,
                            kvstore=None)
    jlf = jmx.gluon.loss.SoftmaxCrossEntropyLoss()
    jx, jy = jmx.nd.array(x), jmx.nd.array(y)
    want = []
    for _ in range(3):
        with jmx.autograd.record():
            loss = jlf(jnet(jx), jy)
        loss.backward()
        jtr.step(32)
        want.append(loss.asnumpy())
    ttr = gluon.Trainer(tnet.collect_params(), "sgd", opt, kvstore=None)
    cs = ttr.compile_step(tnet, gluon.loss.SoftmaxCrossEntropyLoss())
    tx, ty = nd.array(x, ctx=CPU), nd.array(y, ctx=CPU)
    got = [cs.step(tx, ty).asnumpy() for _ in range(3)]
    assert cs.last_path == "compiled"
    for g, w in zip(got, want):
        assert_almost_equal(g, w)
    for g, w in zip(_weights(tnet), _weights(jnet)):
        assert_almost_equal(g, w)
    assert got[2].mean() < got[0].mean()


def test_compile_step_adam_matches_jax_eager_loop():
    """The same MLP with Adam (weight decay): 3 steps of the port's
    compile_step against the JAX package's record -> backward ->
    Trainer.step, from the same weights."""
    widths = (20, 16, 16, 10)
    x, y = _mlp_batch(32, widths, seed=0)
    opt = {"learning_rate": 0.01, "wd": 1e-3}
    jnet, tnet = _mlp(jmx, widths), _mlp(mx, widths)
    models.load_jax_gluon_params(
        tnet, {k: v.data().asnumpy()
               for k, v in jnet.collect_params().items()}, jnet.prefix)
    jtr = jmx.gluon.Trainer(jnet.collect_params(), "adam", opt,
                            kvstore=None)
    jlf = jmx.gluon.loss.SoftmaxCrossEntropyLoss()
    jx, jy = jmx.nd.array(x), jmx.nd.array(y)
    want = []
    for _ in range(3):
        with jmx.autograd.record():
            loss = jlf(jnet(jx), jy)
        loss.backward()
        jtr.step(32)
        want.append(loss.asnumpy())
    ttr = gluon.Trainer(tnet.collect_params(), "adam", opt, kvstore=None)
    cs = ttr.compile_step(tnet, gluon.loss.SoftmaxCrossEntropyLoss())
    tx, ty = nd.array(x, ctx=CPU), nd.array(y, ctx=CPU)
    got = [cs.step(tx, ty).asnumpy() for _ in range(3)]
    assert cs.last_path == "compiled" and cs.fallback_reason is None
    for g, w in zip(got, want):
        assert_almost_equal(g, w)
    for g, w in zip(_weights(tnet), _weights(jnet)):
        assert_almost_equal(g, w)
    assert got[2].mean() < got[0].mean()


# -- CompiledStep ------------------------------------------------------------------

def _compiled_run(steps, change=None, env=None, monkeypatch=None,
                  optimizer="sgd", grad_req=None, multi=None):
    """``steps`` steps of the dropout MLP (SGD, momentum 0.9) through
    compile_step, with ``MXTPU_COMPILED_STEP`` set to ``env`` when given;
    ``change(i, trainer)`` runs before step i and may return its batch
    size.  Returns (cs, losses, weights)."""
    x, y = _mlp_batch()
    mx.random.seed(0)
    net = _mlp(dropout=0.2)
    if grad_req:
        net.collect_params().setattr("grad_req", grad_req)
    tr = gluon.Trainer(net.collect_params(), optimizer,
                       {"learning_rate": 0.1, "momentum": 0.9})
    cs = tr.compile_step(net, gluon.loss.SoftmaxCrossEntropyLoss())
    if env is not None:
        monkeypatch.setenv("MXTPU_COMPILED_STEP", env)
    xx, yy = nd.array(x, ctx=CPU), nd.array(y, ctx=CPU)
    losses = []
    if multi:
        losses = list(cs.step_multi(xx, yy, repeat=steps).asnumpy())
    for i in range(steps if not multi else 0):
        batch = 4
        if change is not None:
            batch = change(i, tr) or 4
        losses.append(cs.step(xx, yy, batch).asnumpy())
    return cs, losses, _weights(net)


def _eager_run(steps, change=None):
    x, y = _mlp_batch()
    mx.random.seed(0)
    net = _mlp(dropout=0.2)
    tr = gluon.Trainer(net.collect_params(), "sgd",
                       {"learning_rate": 0.1, "momentum": 0.9})
    lf = gluon.loss.SoftmaxCrossEntropyLoss()
    xx, yy = nd.array(x, ctx=CPU), nd.array(y, ctx=CPU)
    losses = []
    for i in range(steps):
        batch = 4
        if change is not None:
            batch = change(i, tr) or 4
        losses.append(_eager_step(net, tr, lf, xx, yy, batch).asnumpy())
    return losses, _weights(net)


def test_learning_rate_and_batch_size_reach_the_step_with_one_key():
    """set_learning_rate and a new batch_size change the result exactly
    as in the eager loop, and leave the step's static key (what a graph
    bakes in) as it was: nothing is captured again for them."""
    keys = []

    def change(i, tr):
        keys.append(tr.optimizer.static_key(range(4)))
        if i == 2:
            tr.set_learning_rate(0.03)
        return 8 if i >= 3 else 4
    cs, losses, weights = _compiled_run(5, change)
    assert cs.last_path == "compiled" and cs.fallback_reason is None
    assert len(set(keys)) == 1
    want_losses, want_weights = _eager_run(5, change)
    _assert_equal(losses, want_losses)
    _assert_equal(weights, want_weights)
    _, _, plain = _compiled_run(5)
    assert any(not np.array_equal(a, b) for a, b in zip(weights, plain))


def test_momentum_change_changes_the_key_and_matches_eager():
    keys = []

    def change(i, tr):
        if i == 2:
            tr.optimizer.momentum = 0.5
        keys.append(tr.optimizer.static_key(range(4)))
    cs, _, weights = _compiled_run(4, change)
    assert len(set(keys)) == 2
    _, want = _eager_run(4, change)
    _assert_equal(weights, want)


def test_compiled_step_multi_is_k_steps():
    cs, losses, weights = _compiled_run(3, multi=True)
    assert cs.last_path == "compiled"
    want_losses, want_weights = _eager_run(3)
    _assert_equal(losses, want_losses)
    _assert_equal(weights, want_weights)


def test_escape_hatch_runs_the_eager_loop(monkeypatch):
    csmod.clear_fallback_reports()
    cs, losses, weights = _compiled_run(3, env="0",
                                        monkeypatch=monkeypatch)
    assert cs.last_path == "eager" and cs.fallback_reason is None
    assert csmod.fallback_reports() == []
    monkeypatch.delenv("MXTPU_COMPILED_STEP")
    cs2, losses2, weights2 = _compiled_run(3)
    assert cs2.last_path == "compiled"
    _assert_equal(weights, weights2)
    _assert_equal(losses, losses2)


class _MySGD(mx.optimizer.SGD):
    """A user optimizer: its own update, not graph-safe."""

    def update(self, index, weight, grad, state):
        super().update(index, weight, grad, state)


mx.optimizer.register(_MySGD)


@pytest.mark.parametrize("case", ["optimizer", "grad_req_add"])
def test_ineligible_step_falls_back_and_is_reported(case):
    csmod.clear_fallback_reports()
    if case == "optimizer":
        cs, _, weights = _compiled_run(3, optimizer="_mysgd")
        assert "_MySGD" in cs.fallback_reason
        _, want = _eager_run(3)
        _assert_equal(weights, want)
    else:
        cs, _, _ = _compiled_run(2, grad_req="add")
        assert "grad_req='add'" in cs.fallback_reason
    assert cs.last_path == "eager"
    assert csmod.fallback_reports() == [(cs.name, cs.fallback_reason)]
    csmod.clear_fallback_reports()
    assert csmod.fallback_reports() == []


def test_not_ported_hooks_raise():
    net = _mlp()
    tr = gluon.Trainer(net.collect_params(), "sgd", {"learning_rate": 0.1})
    cs = tr.compile_step(net, gluon.loss.SoftmaxCrossEntropyLoss())
    assert isinstance(cs, gluon.CompiledStep)
    for call in (lambda: cs.save_signature("x"),
                 lambda: cs.warm_start("x"),
                 lambda: cs.recover(None)):
        with pytest.raises(NotImplementedError):
            call()
