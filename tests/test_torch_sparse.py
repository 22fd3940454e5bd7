"""Row-sparse gradients and the lazy update: the port against the JAX
package on the CPU.

``tests/test_sparse.py``'s cases restated against the JAX package (row
sparse and csr construction, ``indices``, ``data``, ``retain``, ``dot``
with duplicates, ``tostype``); ``Embedding(sparse_grad=True)`` under
three steps of lazy SGD, lazy SGD with momentum and lazy Adam from the
same weights (rows no step touched keep their start bit for bit and
their optimizer state stays exactly 0; a row that was looked up but whose
gradient is exactly zero is not touched; ``lazy_update=False`` is the
dense update); ``example/word_lm.py``'s RNNModel at its defaults
(dropout 0) for three Adam steps with the JAX package's weights loaded
from its own ``save_parameters`` file; and ``compile_step`` over a model
with a row-sparse parameter, whose step body stays the same op for op
while the touched rows and a scheduled learning rate change.
"""
import os

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, gluon, nd
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ndarray import sparse
from mxnet_tpu_torch.ndarray.sparse import CSRNDArray, RowSparseNDArray

from test_torch_compiled_step import _record_body

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = mx.cpu()
JCPU = jmx.cpu()
#: float32 tolerance of mxnet_tpu/test_utils.py
RTOL, ATOL = 1e-5, 1e-6


def _both(fn):
    """``fn(pkg, ctx)`` in the JAX package and in the port."""
    return fn(jmx, JCPU), fn(mx, CPU)


def _np(x):
    return x.asnumpy() if hasattr(x, "asnumpy") else np.asarray(x)


# -- the sparse arrays ----------------------------------------------------------

CSR = ([1.0, 2.0, 3.0, 4.0], [1, 3, 0, 2], [0, 2, 3, 3, 4])
RHS = np.random.RandomState(0).randn(4, 5).astype("float32")


def _csr(pkg, ctx):
    return pkg.nd.sparse.csr_matrix(CSR, shape=(4, 4), ctx=ctx)


SPARSE_CASES = {
    "row_sparse_dense_roundtrip": lambda pkg, ctx: [
        (lambda rs: (rs.stype, rs.asnumpy(), rs.indices, rs.data))(
            pkg.nd.sparse.row_sparse_array(
                np.asarray([[0, 0], [1, 2], [0, 0], [3, 4]], "f4"),
                ctx=ctx))],
    "row_sparse_compressed": lambda pkg, ctx: [
        (lambda rs: (rs.is_compressed, rs.shape, rs.indices, rs.data,
                     rs.is_compressed, rs.asnumpy()))(
            pkg.nd.sparse.row_sparse_array(
                (np.asarray([[1., 2.], [3., 4.]], "f4"), [1, 3]),
                shape=(5, 2), ctx=ctx))],
    "csr_compressed_parts": lambda pkg, ctx: [
        (lambda m: (m.is_compressed, m.shape, m.ndim, str(m.dtype),
                    m.indices, m.indptr, m.data, m.is_compressed))(
            _csr(pkg, ctx))],
    "csr_dense_parts": lambda pkg, ctx: [
        (lambda m: (m.stype, m.indices, m.indptr, m.data))(
            pkg.nd.sparse.csr_matrix(np.asarray(
                [[0, 1, 0], [2, 0, 3]], "f4"), ctx=ctx))],
    "csr_dot": lambda pkg, ctx: [
        pkg.nd.sparse.dot(_csr(pkg, ctx), pkg.nd.array(RHS, ctx=ctx)),
        pkg.nd.sparse.dot(_csr(pkg, ctx), pkg.nd.array(RHS, ctx=ctx),
                          transpose_a=True),
        pkg.nd.sparse.dot(_csr(pkg, ctx), pkg.nd.array(RHS[:, 0],
                                                       ctx=ctx))],
    "csr_duplicates_sum": lambda pkg, ctx: [
        (lambda m: (pkg.nd.sparse.dot(m, pkg.nd.ones((1, 1), ctx=ctx)),
                    m.asnumpy()))(pkg.nd.sparse.csr_matrix(
                        ([1.0, 1.0], [0, 0], [0, 2]), shape=(1, 1),
                        ctx=ctx))],
    "csr_generic_op_densifies": lambda pkg, ctx: [
        (lambda m: ((m * 2).asnumpy(), m.is_compressed))(_csr(pkg, ctx))],
    "retain": lambda pkg, ctx: [
        (lambda m: (lambda r, d: (r.is_compressed, r.indices, r.data,
                                  d.asnumpy(), r.asnumpy()))(
            pkg.nd.sparse.retain(m, pkg.nd.array([2., 4.], ctx=ctx)),
            pkg.nd.sparse.retain(m.tostype("row_sparse"),
                                 pkg.nd.array([2., 4.], ctx=ctx))))(
            pkg.nd.sparse.row_sparse_array(
                (np.asarray([[1.], [2.], [3.]], "f4"), [0, 2, 4]),
                shape=(6, 1), ctx=ctx))],
    "tostype_and_zeros": lambda pkg, ctx: [
        (lambda m: (m.tostype("default").stype, m.tostype("csr").stype,
                    m.tostype("default").asnumpy(),
                    pkg.nd.sparse.zeros("row_sparse", (3, 2), ctx=ctx).stype,
                    pkg.nd.sparse.zeros("csr", (3, 2), ctx=ctx).asnumpy()))(
            _csr(pkg, ctx))],
}


def _flat(x):
    if isinstance(x, (list, tuple)):
        return [v for item in x for v in _flat(item)]
    return [x]


@pytest.mark.parametrize("case", sorted(SPARSE_CASES))
def test_sparse_arrays_match_jax(case):
    want, got = _both(SPARSE_CASES[case])
    want, got = _flat(want), _flat(got)
    assert len(want) == len(got)
    for w, g in zip(want, got):
        if isinstance(w, (str, bool, tuple, int)):
            assert g == w
        else:
            np.testing.assert_allclose(_np(g), _np(w), rtol=RTOL, atol=ATOL)
            # int64 indices: the JAX package's arrays are int32 without
            # JAX's x64 mode
            assert _np(g).dtype == _np(w).dtype or \
                _np(g).dtype == np.int64 and _np(w).dtype == np.int32


@pytest.mark.parametrize("bad", ["indptr", "increasing", "range", "shape",
                                 "retain", "dot"])
def test_sparse_validation_matches_jax(bad):
    def run(pkg, ctx):
        sp = pkg.nd.sparse
        if bad == "indptr":
            sp.csr_matrix(([1.0], [0], [0, 1, 1]), shape=(4, 4), ctx=ctx)
        elif bad == "increasing":
            sp.row_sparse_array((np.ones((2, 1), "f4"), [3, 1]),
                                shape=(5, 1), ctx=ctx)
        elif bad == "range":
            sp.row_sparse_array((np.ones((1, 1), "f4"), [9]), shape=(5, 1),
                                ctx=ctx)
        elif bad == "shape":
            sp.row_sparse_array((np.asarray([1., 2.], "f4"), [0, 1]),
                                shape=(5, 2), ctx=ctx)
        elif bad == "retain":
            sp.retain(sp.row_sparse_array(
                (np.ones((2, 1), "f4"), [0, 2]), shape=(4, 1), ctx=ctx),
                np.asarray([9]))
        else:
            sp.dot(_csr(pkg, ctx), pkg.nd.ones((7, 2), ctx=ctx))
    match = {"indptr": "indptr", "increasing": "increasing",
             "range": "range", "shape": "incompatible",
             "retain": "range", "dot": "incompatible"}[bad]
    for pkg, ctx, err in ((jmx, JCPU, jmx.MXNetError),
                          (mx, CPU, MXNetError)):
        with pytest.raises(err, match=match):
            run(pkg, ctx)


def test_dot_under_record_is_the_dense_op_with_gradients():
    def run(pkg, ctx):
        w = pkg.nd.array(np.ones((4, 2), "f4"), ctx=ctx)
        w.attach_grad()
        with pkg.autograd.record():
            loss = pkg.nd.sum(pkg.nd.sparse.dot(_csr(pkg, ctx), w))
        loss.backward()
        return w.grad.asnumpy()
    want, got = _both(run)
    np.testing.assert_allclose(got, want, rtol=RTOL)


def test_attach_grad_row_sparse_types_the_buffer():
    def run(pkg, ctx):
        w = pkg.nd.array(np.arange(18, dtype="f4").reshape(6, 3), ctx=ctx)
        w.attach_grad(stype="row_sparse")
        buf = w.grad
        with pkg.autograd.record():
            y = pkg.nd.sum(pkg.nd.Embedding(
                pkg.nd.array([[1.0, 4.0]], ctx=ctx), w, input_dim=6,
                output_dim=3))
        y.backward()
        return type(w.grad).__name__, w.grad.stype, w.grad.asnumpy(), \
            w.grad.indices.asnumpy(), w.grad is buf
    want, got = _both(run)
    assert got[:2] == want[:2] == ("RowSparseNDArray", "row_sparse")
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_array_equal(got[3], want[3])
    assert got[4]
    with pytest.raises(MXNetError, match="row_sparse"):
        nd.zeros((2, 2), ctx=CPU).attach_grad(stype="csr")


@pytest.mark.parametrize("op", ["sgd_mom_update", "adam_update"])
def test_lazy_update_ops_touch_only_rows(op):
    rng = np.random.RandomState(1)
    w = rng.randn(6, 2).astype("f4")
    m = (rng.randn(6, 2) * 0.1).astype("f4")
    v = (np.abs(rng.randn(6, 2)) * 0.1).astype("f4")
    g = np.zeros((6, 2), "f4")
    g[[0, 5]] = rng.randn(2, 2)

    def run(pkg, ctx, lazy):
        F = pkg.nd
        a = [F.array(x, ctx=ctx) for x in (w, g, m, v)]
        if op == "adam_update":
            F.adam_update(a[0], a[1], a[2], a[3], 0.01, 0.01,
                          lazy_update=lazy, out=[a[0], a[2], a[3]])
        else:
            F.sgd_mom_update(a[0], a[1], a[2], 0.1, 0.01, momentum=0.9,
                             lazy_update=lazy, out=[a[0], a[2]])
        return [x.asnumpy() for x in (a[0], a[2], a[3])]
    for lazy in (True, False):
        want = run(jmx, JCPU, lazy)
        got = run(mx, CPU, lazy)
        for gg, ww in zip(got, want):
            np.testing.assert_allclose(gg, ww, rtol=RTOL, atol=ATOL)
        if lazy:
            untouched = [1, 2, 3, 4]
            for gg, start in zip(got, (w, m, v)):
                np.testing.assert_array_equal(gg[untouched],
                                              start[untouched])


# -- Embedding(sparse_grad=True) under the trainers ------------------------------

VOCAB, DIM = 12, 4
STEP_TOKENS = ([[1, 3, 3, 7]], [[3, 5, 1, 1]], [[7, 7, 2, 5]])
UNTOUCHED = [0, 4, 6, 8, 9, 10, 11]
OPTIMIZERS = {
    "sgd": ("sgd", {"learning_rate": 0.1, "wd": 0.01}),
    "sgd_momentum": ("sgd", {"learning_rate": 0.1, "momentum": 0.9,
                             "wd": 0.01}),
    "adam": ("adam", {"learning_rate": 0.05, "wd": 0.01}),
}
W0 = np.random.RandomState(5).randn(VOCAB, DIM).astype("f4")
SCALE = np.random.RandomState(6).randn(1, 4, DIM).astype("f4")


def _embedding_run(pkg, ctx, optimizer, params, sparse_grad=True,
                   zero_token=None, steps=3):
    """``steps`` steps of ``sum(emb(tokens) * SCALE)`` (zeroed where the
    token is ``zero_token``): (weights, optimizer states, grad stype)."""
    F = pkg.nd
    emb = pkg.gluon.nn.Embedding(VOCAB, DIM, sparse_grad=sparse_grad)
    emb.initialize(ctx=ctx)
    (param,) = emb.collect_params().values()
    param.set_data(F.array(W0, ctx=ctx))
    tr = pkg.gluon.Trainer(emb.collect_params(), optimizer, dict(params))
    stype = None
    for tokens in STEP_TOKENS[:steps]:
        toks = np.asarray(tokens, "f4")
        scale = SCALE.copy()
        if zero_token is not None:
            scale[toks == zero_token] = 0.0
        x, s = F.array(toks, ctx=ctx), F.array(scale, ctx=ctx)
        with pkg.autograd.record():
            loss = F.sum(emb(x) * s)
        loss.backward()
        stype = param.grad().stype
        tr.step(1)
    updater = tr._updaters[0] if pkg is jmx else tr._updater
    state = updater.states.get(0)
    states = [] if state is None else [
        s.asnumpy() for s in (state if isinstance(state, tuple)
                              else (state,))]
    return param.data().asnumpy(), states, stype


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_lazy_embedding_training_matches_jax(name):
    optimizer, params = OPTIMIZERS[name]
    want_w, want_s, want_t = _embedding_run(jmx, JCPU, optimizer, params)
    got_w, got_s, got_t = _embedding_run(mx, CPU, optimizer, params)
    assert got_t == want_t == "row_sparse"
    np.testing.assert_allclose(got_w, want_w, rtol=RTOL, atol=ATOL)
    assert len(got_s) == len(want_s)
    for g, w in zip(got_s, want_s):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)
        np.testing.assert_array_equal(g[UNTOUCHED], 0.0)
    np.testing.assert_array_equal(got_w[UNTOUCHED], W0[UNTOUCHED])
    touched = sorted(set(range(VOCAB)) - set(UNTOUCHED))
    assert np.abs(got_w[touched] - W0[touched]).min() > 1e-6


@pytest.mark.parametrize("name", ["sgd_momentum", "adam"])
def test_a_row_looked_up_with_zero_gradient_is_untouched(name):
    """Token 3 is looked up at every step, but its gradient is exactly
    zero (its scale is zeroed): no weight decay, no state moves."""
    optimizer, params = OPTIMIZERS[name]
    want_w, want_s, _ = _embedding_run(jmx, JCPU, optimizer, params,
                                       zero_token=3)
    got_w, got_s, _ = _embedding_run(mx, CPU, optimizer, params,
                                     zero_token=3)
    np.testing.assert_allclose(got_w, want_w, rtol=RTOL, atol=ATOL)
    for w in (want_w, got_w):
        np.testing.assert_array_equal(w[3], W0[3])
    for s in got_s + want_s:
        np.testing.assert_array_equal(s[3], 0.0)


@pytest.mark.parametrize("name", ["sgd_momentum", "adam"])
def test_lazy_update_off_gives_the_dense_update(name):
    optimizer, params = OPTIMIZERS[name]
    params = dict(params, lazy_update=False)
    want_w, _, _ = _embedding_run(jmx, JCPU, optimizer, params)
    got_w, got_s, stype = _embedding_run(mx, CPU, optimizer, params)
    dense_w, _, dense_t = _embedding_run(mx, CPU, optimizer, params,
                                         sparse_grad=False)
    assert stype == "row_sparse" and dense_t == "default"
    np.testing.assert_allclose(got_w, want_w, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(got_w, dense_w)
    # weight decay moved every row
    assert np.abs(got_w[UNTOUCHED] - W0[UNTOUCHED]).min() > 0


def test_grad_stype_merges_and_retypes_a_made_buffer():
    emb = gluon.nn.Embedding(8, 4)
    emb.initialize(ctx=CPU)
    (param,) = emb.collect_params().values()
    assert param.grad().stype == "default"
    emb.params.get("weight", grad_stype="row_sparse")
    assert param.grad_stype == "row_sparse"
    assert isinstance(param.grad(), RowSparseNDArray)
    emb.params.get("weight")
    assert param.grad_stype == "row_sparse"
    with pytest.raises(MXNetError, match="grad_stype"):
        param.grad_stype = "csr"


# -- example/word_lm.py's model ---------------------------------------------------

def _word_lm(pkg):
    """example/word_lm.py's namespace, importing ``pkg``."""
    path = os.path.join(REPO, "example", "word_lm.py")
    with open(path) as f:
        src = f.read()
    if pkg is mx:
        src = src.replace("mxnet_tpu", "mxnet_tpu_torch")
    ns = {"__name__": f"word_lm_{pkg.__name__}", "__file__": path}
    exec(compile(src, path, "exec"), ns)
    return ns


WORD_LM = dict(vocab=64, embed=32, hidden=64, layers=1, batch=8, seq=16,
               lr=3e-3)


def _word_lm_model(pkg, ctx, ns, seed=0):
    cfg = WORD_LM
    if pkg is jmx:
        jmx.random.seed(seed)
    model = ns["RNNModel"]("lstm", cfg["vocab"], cfg["embed"],
                           cfg["hidden"], cfg["layers"], dropout=0.0,
                           prefix="rnnmodel_")
    model.initialize(pkg.init.Xavier(), ctx=ctx)
    state = model.begin_state(cfg["batch"], ctx)
    model(pkg.nd.zeros((cfg["batch"], cfg["seq"]), ctx=ctx), state)
    return model


def _word_lm_steps(pkg, ctx, ns, model, steps=3):
    cfg = WORD_LM
    trainer = pkg.gluon.Trainer(model.collect_params(), "adam",
                                {"learning_rate": cfg["lr"]})
    sce = pkg.gluon.loss.SoftmaxCrossEntropyLoss()
    corpus = ns["synthetic_corpus"](cfg["vocab"], 2000)
    state = model.begin_state(cfg["batch"], ctx)
    losses = []
    for (data, target), _ in zip(ns["batchify"](corpus, cfg["batch"],
                                                cfg["seq"]), range(steps)):
        x = pkg.nd.array(data, ctx=ctx)
        y = pkg.nd.array(target.reshape(-1), ctx=ctx)
        state = ns["detach"](state)
        with pkg.autograd.record():
            out, state = model(x, state)
            loss = pkg.nd.mean(sce(out.reshape((-1, cfg["vocab"])), y))
        loss.backward()
        trainer.step(1)
        losses.append(float(loss.asnumpy()))
    weights = {k: p.data().asnumpy()
               for k, p in model.collect_params().items()}
    return losses, weights


def _rel_l2(got, want):
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-30))


def test_word_lm_three_lazy_adam_steps_match_jax(tmp_path):
    """The JAX package's weights reach the port through its own
    ``save_parameters`` file; three Adam steps later the losses agree to
    1e-5 and every weight to 1e-5 in relative L2."""
    jns, tns = _word_lm(jmx), _word_lm(mx)
    jmodel = _word_lm_model(jmx, JCPU, jns)
    tmodel = _word_lm_model(mx, CPU, tns)
    f = str(tmp_path / "word_lm.params")
    jmodel.save_parameters(f)
    tmodel.load_parameters(f, ctx=CPU)
    emb = tmodel.collect_params()["rnnmodel_embedding0_weight"]
    assert emb.grad_stype == "row_sparse"
    want_l, want_w = _word_lm_steps(jmx, JCPU, jns, jmodel)
    got_l, got_w = _word_lm_steps(mx, CPU, tns, tmodel)
    np.testing.assert_allclose(got_l, want_l, rtol=1e-5)
    assert sorted(got_w) == sorted(want_w)
    errs = {k: _rel_l2(got_w[k], want_w[k]) for k in want_w}
    assert max(errs.values()) <= 1e-5, errs


# -- compile_step with a row-sparse parameter -------------------------------------

def _sparse_net(seed=4):
    net = gluon.nn.HybridSequential(prefix="spnet_")
    with net.name_scope():
        net.add(gluon.nn.Embedding(VOCAB, DIM, sparse_grad=True),
                gluon.nn.Dense(3, flatten=True, in_units=3 * DIM))
    return net.initialize(mx.init.Xavier(), ctx=CPU, seed=seed)


def _sparse_batches():
    rng = np.random.RandomState(8)
    # each step looks up different rows of the table
    toks = [rng.choice(lo + np.arange(4), (2, 3)) for lo in (0, 4, 8, 0, 6)]
    return [(nd.array(t.astype("f4"), ctx=CPU),
             nd.array(rng.randint(0, 3, 2).astype("f4"), ctx=CPU))
            for t in toks]


@pytest.mark.parametrize("optimizer", ["sgd", "adam"])
def test_compile_step_with_a_row_sparse_parameter(monkeypatch, optimizer):
    """The step body (a graph's content) is op for op the same at step 1
    and step 5 although the touched rows differ and a FactorScheduler
    changes the learning rate every 2 updates; the static key (what a
    capture bakes in) never changes; the weights equal the eager loop's
    bit for bit, and rows no step touched keep their start."""
    batches = _sparse_batches()
    params = {"learning_rate": 0.1, "wd": 0.01}
    if optimizer == "sgd":
        params["momentum"] = 0.9

    def run(compiled):
        net = _sparse_net()
        w0 = {k: p.data().asnumpy() for k, p in
              net.collect_params().items()}
        sched = mx.lr_scheduler.FactorScheduler(step=2, factor=0.5)
        tr = gluon.Trainer(net.collect_params(), optimizer,
                           dict(params, lr_scheduler=sched))
        lf = gluon.loss.SoftmaxCrossEntropyLoss()
        cs = tr.compile_step(net, lf)
        keys, lrs = [], []

        def on_step(i):
            x, y = batches[i - 1]
            keys.append(tr.optimizer.static_key(range(3)))
            if compiled:
                cs.step(x, y)
                assert cs.last_path == "compiled"
            else:
                with autograd.record():
                    loss = lf(net(x), y)
                loss.backward()
                tr.step(2)
            lrs.append(tr.learning_rate)
        if compiled:
            seen = _record_body(monkeypatch, cs, (1, 5), on_step)
        else:
            seen = None
            for i in range(1, 6):
                on_step(i)
        weights = {k: p.data().asnumpy() for k, p in
                   net.collect_params().items()}
        return seen, keys, lrs, w0, weights

    seen, keys, lrs, w0, got = run(True)
    assert len(seen[1]) > 20 and seen[1] == seen[5]
    assert len(set(keys)) == 1
    assert lrs == [0.1, 0.1, 0.05, 0.05, 0.025]
    _, _, want_lrs, _, want = run(False)
    assert want_lrs == lrs
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    emb = "spnet_embedding0_weight"
    touched = sorted({int(t) for x, _ in batches for t in
                      x.asnumpy().ravel()})
    untouched = sorted(set(range(VOCAB)) - set(touched))
    assert untouched
    np.testing.assert_array_equal(got[emb][untouched], w0[emb][untouched])


def test_lazy_adam_keeps_the_parameter_step_count():
    """Adam's t is the parameter's: a row skipped at step 2 and touched
    at step 3 is corrected with t = 3, as the reference does."""
    want, _, _ = _embedding_run(jmx, JCPU, *OPTIMIZERS["adam"])
    got, _, _ = _embedding_run(mx, CPU, *OPTIMIZERS["adam"])
    # token 2 is first touched at step 3, token 5 at step 2
    np.testing.assert_allclose(got[[2, 5]], want[[2, 5]], rtol=RTOL,
                               atol=ATOL)


def test_sparse_namespace_and_classes():
    assert nd.sparse is sparse
    m = sparse.csr_matrix(CSR, shape=(4, 4), ctx=CPU)
    assert isinstance(m, CSRNDArray) and m.context == CPU
    assert isinstance(m._t, torch.Tensor) and not m.is_compressed
