"""The port's Adam and softmax cross-entropy against the JAX package's.

Adam: the same weights and gradients (numpy, seeded) through the JAX
``Adam.update`` and the port's ``mx.optimizer.Adam``, one multi-tensor
``update_multi`` over every parameter or ``update`` one parameter at a
time, with weight decay, gradient clipping and ``rescale_grad``; weights
and both moments agree to rtol=1e-6 after steps 1 and 3 (float32; the
bias-corrected learning rate rounds to float32 on both sides).  Then
``gluon.Trainer(..., "adam")`` with per-parameter ``lr_mult``/``wd_mult``
against the JAX Trainer.  Cross-entropy: values and input gradients to
1e-6.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import autograd, nd
from mxnet_tpu import optimizer as jopt
from mxnet_tpu.gluon.loss import SoftmaxCrossEntropyLoss as JaxSCE
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import optimizer as topt
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss

TOL = 1e-6
SHAPES = [(6, 5), (5,), (3, 4, 2)]
CPU = mx.cpu()
ADAM_KW = [
    dict(),
    dict(wd=0.1, clip_gradient=0.05, rescale_grad=0.5),
    dict(learning_rate=0.05, beta1=0.8, beta2=0.99, epsilon=1e-6, wd=0.01),
]
ADAM_IDS = ["defaults", "wd-clip-rescale", "betas-eps"]


def _adam_steps(kw, multi):
    """Three Adam steps on seeded weights and gradients in both
    packages; checks weights and moments after steps 1 and 3."""
    rng = np.random.RandomState(0)
    weights = [rng.randn(*s).astype("f4") for s in SHAPES]
    jo = jopt.Adam(**kw)
    to = topt.Adam(**kw)
    jw = [nd.array(w) for w in weights]
    js = [jo.create_state(i, w) for i, w in enumerate(jw)]
    tw = [mx.nd.array(w, ctx=CPU) for w in weights]
    ts = [to.create_state(i, w) for i, w in enumerate(tw)]
    idx = list(range(len(SHAPES)))
    for t in (1, 2, 3):
        grads = [rng.randn(*s).astype("f4") * 0.2 for s in SHAPES]
        for i, g in enumerate(grads):
            jo.update(i, jw[i], nd.array(g), js[i])
        tg = [mx.nd.array(g, ctx=CPU) for g in grads]
        if multi:
            to.update_multi(idx, tw, tg, ts)
        else:
            for i in idx:
                to.update(i, tw[i], tg[i], ts[i])
        assert to.num_update == t
        if t in (1, 3):
            for i in idx:
                for got, want in ((tw[i], jw[i]), (ts[i][0], js[i][0]),
                                  (ts[i][1], js[i][1])):
                    np.testing.assert_allclose(got.asnumpy(),
                                               want.asnumpy(),
                                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("kw", ADAM_KW, ids=ADAM_IDS)
def test_adam_matches_jax_update(kw):
    """The multi-tensor update (``gluon.Trainer``'s)."""
    _adam_steps(kw, multi=True)


@pytest.mark.parametrize("kw", ADAM_KW, ids=ADAM_IDS)
def test_adam_per_parameter_matches_jax_update(kw):
    _adam_steps(kw, multi=False)


def test_adam_is_a_registered_optimizer():
    o = topt.create("adam", learning_rate=1e-3, wd=0.01)
    assert isinstance(o, topt.Optimizer) and isinstance(o, topt.Adam)
    assert o.capturable
    assert topt.Optimizer.opt_registry["adam"] is topt.Adam
    # the static attributes a captured update bakes in
    assert o.static_key(()) != topt.create("adam", beta1=0.8).static_key(())


@pytest.mark.parametrize("mults", [(1.0, 1.0), (0.5, 2.0)],
                         ids=["plain", "lr-wd-mult"])
def test_gluon_trainer_adam_matches_jax(mults):
    """``gluon.Trainer(params, "adam")``: one multi-tensor Adam a step,
    each parameter's lr_mult and wd_mult applied, against the JAX
    Trainer over three steps."""
    from mxnet_tpu import gluon as jgluon
    from mxnet_tpu_torch import gluon as tgluon
    rng = np.random.RandomState(3)
    w0 = rng.randn(4, 3).astype("f4")
    b0 = rng.randn(4).astype("f4")
    x = rng.randn(5, 3).astype("f4")

    def run(pkg, gl, ctx):
        net = gl.nn.Dense(4, in_units=3, prefix="adam_")
        net.initialize(ctx=ctx) if ctx is not None else net.initialize()
        params = net.collect_params()
        params["adam_weight"].set_data(pkg.nd.array(w0, ctx=ctx))
        params["adam_bias"].set_data(pkg.nd.array(b0, ctx=ctx))
        params["adam_weight"].lr_mult, params["adam_weight"].wd_mult = mults
        tr = gl.Trainer(params, "adam", {"learning_rate": 0.05, "wd": 0.1})
        out = []
        for _ in range(3):
            with pkg.autograd.record():
                loss = (net(pkg.nd.array(x, ctx=ctx)) ** 2).sum()
            loss.backward()
            tr.step(5)
            out.append([p.data().asnumpy() for p in params.values()])
        return out
    want = run(jmx, jgluon, None)
    got = run(mx, tgluon, CPU)
    for gs, ws in zip(got, want):
        for g, w in zip(gs, ws):
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)


def test_adam_corrected_lr_and_create():
    o = topt.create("adam", learning_rate=1e-4)
    assert o.corrected_lr(1) == pytest.approx(1e-4 * np.sqrt(0.001) / 0.1)
    with pytest.raises(MXNetError, match="Cannot find optimizer"):
        topt.create("nadam")


@pytest.mark.parametrize("shape,dtype", [((8, 50), "float32"),
                                         ((4, 2), "float32"),
                                         ((8, 50), "bfloat16")],
                         ids=["mlm", "nsp", "bf16"])
def test_softmax_cross_entropy_matches_jax(shape, dtype):
    rng = np.random.RandomState(1)
    pred = (rng.randn(*shape) * 3).astype("f4")
    label = rng.randint(0, shape[1], shape[0]).astype("f4")
    label[0] = shape[1] + 5                       # clipped into range
    jp = nd.array(pred).astype(dtype)
    jp.attach_grad()
    with autograd.record():
        jl = JaxSCE()(jp, nd.array(label))
    jl.backward()
    tp = torch.from_numpy(pred).to(getattr(torch, dtype))
    tp.requires_grad_(True)
    tl = SoftmaxCrossEntropyLoss()(tp, torch.from_numpy(label))
    tl.backward(torch.ones_like(tl))
    tol = TOL if dtype == "float32" else 2e-2
    assert tuple(tl.shape) == (shape[0],)
    np.testing.assert_allclose(tl.float().detach().numpy(),
                               jl.astype("float32").asnumpy(),
                               rtol=tol, atol=tol)
    np.testing.assert_allclose(tp.grad.float().numpy(),
                               jp.grad.astype("float32").asnumpy(),
                               rtol=tol, atol=tol)


# -- the optimizers after SGD and Adam ------------------------------------------
#
# Each takes 5 steps on seeded weights and gradients in both packages,
# with weight decay, gradient clipping, rescale_grad and a FactorScheduler
# (each package its own), per parameter (``update``) and as one set
# (``update_multi``, gluon.Trainer's); weights and every state within
# float32's tolerance (mxnet_tpu/test_utils.py: rtol 1e-4, atol 1e-5).
# With multi_precision, float16 weights and gradients: the float32
# master weights and states within float32's tolerance, the float16
# weights within float16's (1e-2, 1e-2).

F32_TOL = (1e-4, 1e-5)
F16_TOL = (1e-2, 1e-2)
COMMON = dict(learning_rate=0.05, wd=0.01, clip_gradient=0.5,
              rescale_grad=0.5)
NEW_OPTIMIZERS = [
    pytest.param("nag", dict(momentum=0.9), id="nag"),
    pytest.param("adamw", dict(beta1=0.8), id="adamw"),
    pytest.param("adagrad", dict(eps=1e-6), id="adagrad"),
    pytest.param("adadelta", dict(rho=0.8, epsilon=1e-4), id="adadelta"),
    pytest.param("rmsprop", dict(gamma1=0.8, epsilon=1e-6,
                                 clip_weights=0.9), id="rmsprop"),
    pytest.param("rmsprop", dict(centered=True, gamma1=0.8, gamma2=0.7),
                 id="rmsprop-centered"),
    pytest.param("ftrl", dict(lamda1=0.01, beta=0.5), id="ftrl"),
    pytest.param("signsgd", {}, id="signsgd"),
    pytest.param("signum", dict(momentum=0.8, wd_lh=0.01), id="signum"),
    pytest.param("lamb", dict(beta1=0.8, lower_bound=0.01, upper_bound=5.0),
                 id="lamb-bounds"),
    pytest.param("lamb", dict(bias_correction=False), id="lamb-no-bias-corr"),
    pytest.param("test", {}, id="test"),
]


def _states(s):
    if s is None:
        return []
    return list(s) if isinstance(s, tuple) else [s]


def _flat(s):
    """Every NDArray of a (multi-precision) state, flattened."""
    out = []
    for x in _states(s):
        out += _flat(x) if isinstance(x, tuple) else [] if x is None else [x]
    return out


def _run_pair(name, kw, dtype, mode, steps=5):
    """``steps`` updates of both packages' optimizer ``name``; yields the
    (got, want, tolerance) pairs of every weight and state after each."""
    from mxnet_tpu import lr_scheduler as jls
    from mxnet_tpu_torch import lr_scheduler as tls
    rng = np.random.RandomState(0)
    mp = dtype == "float16"
    kw = dict(COMMON, **kw, multi_precision=mp)
    jo = jopt.create(name, lr_scheduler=jls.FactorScheduler(2, 0.5), **kw)
    to = topt.create(name, lr_scheduler=tls.FactorScheduler(2, 0.5), **kw)
    w0 = [rng.randn(*s).astype(dtype) for s in SHAPES]
    jw = [nd.array(w, dtype=dtype) for w in w0]
    tw = [mx.nd.array(w, ctx=CPU, dtype=dtype) for w in w0]
    js = [jo.create_state_multi_precision(i, w) for i, w in enumerate(jw)]
    if mode == "trainer":
        updater = topt.get_updater(to)
    else:
        ts = [to.create_state_multi_precision(i, w)
              for i, w in enumerate(tw)]
    idx = list(range(len(SHAPES)))
    for _ in range(steps):
        grads = [rng.randn(*s).astype(dtype) for s in SHAPES]
        for i, g in enumerate(grads):
            jo.update_multi_precision(i, jw[i], nd.array(g, dtype=dtype),
                                      js[i])
        tg = [mx.nd.array(g, ctx=CPU, dtype=dtype) for g in grads]
        if mode == "trainer":
            updater.call_fused(idx, tg, tw)
            ts = [updater.states[i] for i in idx]
        else:
            for i in idx:
                to.update_multi_precision(i, tw[i], tg[i], ts[i])
        for i in idx:
            yield tw[i], jw[i], F16_TOL if mp else F32_TOL
            for a, b in zip(_flat(ts[i]), _flat(js[i])):
                assert a.dtype == b.dtype
                yield a, b, F32_TOL


@pytest.mark.parametrize("dtype", ["float32", "float16"],
                         ids=["f32", "f16-multi-precision"])
@pytest.mark.parametrize("mode", ["per-parameter", "trainer"])
@pytest.mark.parametrize("name,kw", NEW_OPTIMIZERS)
def test_optimizer_matches_jax(name, kw, mode, dtype):
    n = 0
    for got, want, (rtol, atol) in _run_pair(name, kw, dtype, mode):
        np.testing.assert_allclose(got.asnumpy().astype("f4"),
                                   want.asnumpy().astype("f4"), rtol=rtol,
                                   atol=atol)
        n += 1
    assert n > 0


@pytest.mark.parametrize("name,kw", NEW_OPTIMIZERS)
def test_new_optimizers_are_registered_and_capturable(name, kw):
    o = topt.create(name, **kw)
    assert type(o) is topt.Optimizer.opt_registry[name]
    assert type(o).__name__ in jopt.__all__
    assert o.capturable
    # a static attribute of the update is in the capture's key
    assert o.static_key(()) != topt.create(name, **kw,
                                           clip_gradient=0.3).static_key(())


def test_fused_multi_precision_matches_per_parameter():
    """SGD's fused multi-precision pass (the reference's
    ``multi_mp_sgd_mom_update``) and LAMB's per-parameter path under
    multi-precision (the reference has no fused plan for it), through
    ``Updater.call_fused``, equal their per-parameter updates; a set
    that mixes float16 and float32 weights takes the per-parameter
    path."""
    rng = np.random.RandomState(4)
    for name, kw in (("sgd", dict(momentum=0.9)), ("lamb", {})):
        o1 = topt.create(name, multi_precision=True, wd=0.01, **kw)
        o2 = topt.create(name, multi_precision=True, wd=0.01, **kw)
        assert o1._fused_supported(
            [mx.nd.zeros((2,), ctx=CPU, dtype="float16")]) == (name == "sgd")
        dts = ["float16", "float16", "float32"]
        w = [rng.randn(4, 3).astype(d) for d in dts]
        a = [mx.nd.array(x, ctx=CPU, dtype=x.dtype) for x in w]
        b = [mx.nd.array(x, ctx=CPU, dtype=x.dtype) for x in w]
        assert not o1._fused_supported(a)
        u = topt.get_updater(o1)
        s2 = [o2.create_state_multi_precision(i, x) for i, x in enumerate(b)]
        for _ in range(3):
            g = [mx.nd.array(rng.randn(4, 3).astype(d), ctx=CPU, dtype=d)
                 for d in dts]
            u.call_fused([0, 1, 2], g, a)
            u.call_fused([0, 1], g[:2], a[:2])    # all float16
            for i in (0, 1, 2):
                o2.update_multi_precision(i, b[i], g[i], s2[i])
            for i in (0, 1):
                o2.update_multi_precision(i, b[i], g[i], s2[i])
        for x, y in zip(a, b):
            np.testing.assert_allclose(x.asnumpy(), y.asnumpy(), rtol=1e-6,
                                       atol=1e-6)
        assert u.states[0][0].dtype == np.float32   # the master copy


# -- the update ops ---------------------------------------------------------------

def _pair(shape, rng, positive=False):
    x = rng.randn(*shape).astype("f4")
    x = np.abs(x) + 0.1 if positive else x
    return nd.array(x), mx.nd.array(x, ctx=CPU)


UPDATE_OPS = [
    ("nag_mom_update", 3, 0, dict(momentum=0.9)),
    ("mp_sgd_update", 3, 0, {}),
    ("mp_sgd_mom_update", 4, 0, dict(momentum=0.9)),
    ("adamw_update", 4, 1, dict(beta1=0.8)),
    ("rmsprop_update", 3, 1, dict(gamma1=0.8, clip_weights=0.5)),
    ("rmspropalex_update", 5, 1, dict(gamma1=0.8, gamma2=0.7)),
    ("ftrl_update", 4, 1, dict(lamda1=0.05)),
    ("signsgd_update", 2, 0, {}),
    ("signum_update", 3, 0, dict(momentum=0.8, wd_lh=0.01)),
    ("adagrad_update", 3, 1, {}),
    ("adadelta_update", 4, 1, dict(rho=0.8)),
]


@pytest.mark.parametrize("op,n_in,first_positive,kw", UPDATE_OPS,
                         ids=[u[0] for u in UPDATE_OPS])
def test_update_op_matches_jax(op, n_in, first_positive, kw):
    """Each per-parameter update op on the same inputs (states that feed a
    square root positive), its scalars as the reference takes them."""
    rng = np.random.RandomState(7)
    ins = [_pair((5, 4), rng, positive=j >= 2 and first_positive)
           for j in range(n_in)]
    scalars = dict(wd=0.01, rescale_grad=0.5)
    if op != "adadelta_update":
        scalars["lr"] = 0.05
    if op == "adamw_update":
        scalars["eta"] = 1.0
    jouts = getattr(nd, op)(*[a for a, _ in ins], clip_gradient=0.6,
                            **scalars, **kw)
    touts = getattr(mx.nd, op)(*[b for _, b in ins], clip_gradient=0.6,
                               **scalars, **kw)
    jouts = jouts if isinstance(jouts, (list, tuple)) else [jouts]
    touts = touts if isinstance(touts, (list, tuple)) else [touts]
    assert len(jouts) == len(touts)
    for a, b in zip(touts, jouts):
        np.testing.assert_allclose(a.asnumpy(), b.asnumpy(), rtol=1e-5,
                                   atol=1e-6)


def test_lamb_phases_and_multi_ops_match_jax():
    """lamb_update_phase1/_phase2, and the multi-tensor family
    (multi_sgd(_mom), multi_mp_sgd(_mom), multi_adam, multi_lamb,
    multi_sum_sq, multi_lars) with a global-norm clip, against the
    reference's ops."""
    rng = np.random.RandomState(9)
    n = 3
    shapes = [(4, 3), (5,), (2, 2)]

    def arrays(k, positive=False, dtype="f4"):
        out = []
        for s in shapes[:k] if k <= n else shapes * (k // n):
            x = rng.randn(*s).astype("f4")
            x = (np.abs(x) + 0.1) if positive else x
            out.append(x.astype(dtype))
        return out

    def both(xs):
        return ([nd.array(x, dtype=x.dtype) for x in xs],
                [mx.nd.array(x, ctx=CPU, dtype=x.dtype) for x in xs])

    def close(a, b, tol=1e-5):
        a = a if isinstance(a, (list, tuple)) else [a]
        b = b if isinstance(b, (list, tuple)) else [b]
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert x.dtype == y.dtype
            np.testing.assert_allclose(x.asnumpy().astype("f4"),
                                       y.asnumpy().astype("f4"), rtol=tol,
                                       atol=tol)

    w, g, m, v = (both(arrays(1, positive=(k == 3))) for k in range(4))
    kw = dict(beta1=0.8, beta2=0.99, epsilon=1e-6, clip_gradient=0.8)
    jp1 = nd.lamb_update_phase1(w[0][0], g[0][0], m[0][0], v[0][0],
                                wd=0.01, t=3, rescale_grad=0.5, **kw)
    tp1 = mx.nd.lamb_update_phase1(w[1][0], g[1][0], m[1][0], v[1][0],
                                   wd=0.01, t=3, rescale_grad=0.5, **kw)
    close(tp1, jp1)
    r1, r2 = both([np.array(1.5, "f4")]), both([np.array(0.7, "f4")])
    for lb, ub in ((-1.0, -1.0), (0.5, 1.2)):
        close(mx.nd.lamb_update_phase2(w[1][0], tp1[0], r1[1][0], r2[1][0],
                                       lr=0.05, lower_bound=lb,
                                       upper_bound=ub),
              nd.lamb_update_phase2(w[0][0], jp1[0], r1[0][0], r2[0][0],
                                    lr=0.05, lower_bound=lb,
                                    upper_bound=ub))

    lrs = np.array([0.05, 0.02, 0.1], "f4")
    wds = np.array([0.01, 0.0, 0.02], "f4")
    ts = np.array([1, 2, 3], "f4")
    vec = both([lrs, wds, ts, np.array(0.5, "f4")])
    attrs = dict(num_weights=n, clip_gradient=0.8, clip_global_norm=1.0)
    cases = [
        ("multi_sgd_update", [arrays(n), arrays(n)], 3, {}),
        ("multi_sgd_mom_update", [arrays(n), arrays(n), arrays(n)], 3,
         dict(momentum=0.9)),
        ("multi_mp_sgd_update", [arrays(n, dtype="float16"),
                                 arrays(n, dtype="float16"), arrays(n)], 3,
         {}),
        ("multi_mp_sgd_mom_update", [arrays(n, dtype="float16"),
                                     arrays(n, dtype="float16"), arrays(n),
                                     arrays(n)], 3, dict(momentum=0.9)),
        ("multi_adam_update", [arrays(n), arrays(n), arrays(n),
                               arrays(n, positive=True)], 3,
         dict(beta1=0.8)),
        ("multi_lamb_update", [arrays(n), arrays(n), arrays(n),
                               arrays(n, positive=True)], 4,
         dict(beta1=0.8, lower_bound=0.01, upper_bound=5.0)),
    ]
    for op, groups, n_vec, extra in cases:
        flat = [x for grp in groups for x in grp]
        j, t = both(flat)
        scal_j = [vec[0][k] for k in ((0, 1, 3) if n_vec == 3
                                      else (0, 1, 2, 3))]
        scal_t = [vec[1][k] for k in ((0, 1, 3) if n_vec == 3
                                      else (0, 1, 2, 3))]
        close(getattr(mx.nd, op)(*t, *scal_t, **attrs, **extra),
              getattr(nd, op)(*j, *scal_j, **attrs, **extra),
              tol=1e-2 if "mp" in op else 1e-5)
    j, t = both(arrays(n))
    jsq = nd.multi_sum_sq(*j, num_arrays=n)
    tsq = mx.nd.multi_sum_sq(*t, num_arrays=n)
    close(tsq, jsq)
    jg, tg = both(arrays(n))
    gsq = (nd.multi_sum_sq(*jg, num_arrays=n),
           mx.nd.multi_sum_sq(*tg, num_arrays=n))
    close(mx.nd.multi_lars(vec[1][0], tsq, gsq[1], vec[1][1],
                           rescale_grad=0.5, eta=0.01),
          nd.multi_lars(vec[0][0], jsq, gsq[0], vec[0][1], rescale_grad=0.5,
                        eta=0.01))


# -- the fused rules of DataParallelTrainer --------------------------------------

@pytest.mark.parametrize("name,kw", [
    ("nag", dict(momentum=0.9)),
    ("rmsprop", dict(gamma1=0.8)),
    ("adamw", dict(wd=0.01)),
    ("adagrad", {}),
], ids=["nag", "rmsprop", "adamw", "adagrad"])
def test_data_parallel_fused_rules_match_jax(name, kw):
    """The reference's four other fused rules: 3 captured-path steps of an
    MLP through ``DataParallelTrainer(fuse_step=True)`` in both packages
    from the same weights: losses and weights within float32's
    tolerance."""
    from mxnet_tpu import gluon as jgluon
    from mxnet_tpu import parallel as jparallel
    from mxnet_tpu_torch import gluon as tgluon, parallel as tparallel
    rng = np.random.RandomState(11)
    x = rng.randn(8, 6).astype("f4")
    y = rng.randn(8, 3).astype("f4")
    weights = {"w0": rng.randn(5, 6).astype("f4") * 0.3,
               "b0": rng.randn(5).astype("f4") * 0.1,
               "w1": rng.randn(3, 5).astype("f4") * 0.3,
               "b1": rng.randn(3).astype("f4") * 0.1}
    params = dict(learning_rate=0.05, **kw)

    def net(gl, pkg, ctx):
        n = gl.nn.HybridSequential(prefix="fr_")
        with n.name_scope():
            n.add(gl.nn.Dense(5, in_units=6, activation="tanh"),
                  gl.nn.Dense(3, in_units=5))
        n.initialize(ctx=ctx) if ctx is not None else n.initialize()
        for (k, p), v in zip(n.collect_params().items(), weights.values()):
            p.set_data(pkg.nd.array(v, ctx=ctx) if ctx is not None
                       else pkg.nd.array(v))
        return n

    def loss_fn(out, label):
        return ((out - label) ** 2).sum(axis=1)

    jn = net(jgluon, jmx, None)
    jd = jparallel.DataParallelTrainer(
        jn, loss_fn, name, params, mesh=jparallel.make_mesh({"dp": 1}),
        fuse_step=True)
    want = [float(jd.step(nd.array(x), nd.array(y)).asnumpy())
            for _ in range(3)]
    tn = net(tgluon, mx, CPU)
    td = tparallel.DataParallelTrainer(
        tn, loss_fn, name, params,
        mesh=tparallel.make_mesh({"dp": 1}, devices=[CPU]), fuse_step=True)
    got = [float(td.step(mx.nd.array(x, ctx=CPU),
                         mx.nd.array(y, ctx=CPU)).asnumpy())
           for _ in range(3)]
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    for a, b in zip(tn.collect_params().values(),
                    jn.collect_params().values()):
        np.testing.assert_allclose(a.data().asnumpy(), b.data().asnumpy(),
                                   rtol=1e-4, atol=1e-5)
    assert td.num_update == 3


# -- clipping and update counts (ROADMAP queue 3, F10) -----------------------------

@pytest.mark.parametrize("opt_name", ["sgd", "adam"])
def test_trainer_clip_global_norm_matches_jax(opt_name):
    """``Trainer(..., clip_global_norm=)``: three steps with the clip
    active (the rescaled gradients' norm is far above 0.5), against the
    JAX Trainer."""
    from mxnet_tpu import gluon as jgluon
    from mxnet_tpu_torch import gluon as tgluon
    rng = np.random.RandomState(10)
    w0 = rng.randn(4, 3).astype("f4")
    b0 = rng.randn(4).astype("f4")
    x = rng.randn(6, 3).astype("f4") * 3

    def run(pkg, gl, ctx):
        net = gl.nn.Dense(4, in_units=3, prefix="clip_")
        net.initialize(ctx=ctx) if ctx is not None else net.initialize()
        params = net.collect_params()
        params["clip_weight"].set_data(pkg.nd.array(w0, ctx=ctx))
        params["clip_bias"].set_data(pkg.nd.array(b0, ctx=ctx))
        tr = gl.Trainer(params, opt_name, {"learning_rate": 0.1},
                        clip_global_norm=0.5)
        out = []
        for _ in range(3):
            with pkg.autograd.record():
                loss = (net(pkg.nd.array(x, ctx=ctx)) ** 2).sum()
            loss.backward()
            tr.step(2)
            out.append([p.data().asnumpy() for p in params.values()])
        return out
    want = run(jmx, jgluon, None)
    got = run(mx, tgluon, CPU)
    for gs, ws in zip(got, want):
        for g, w in zip(gs, ws):
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="positive"):
        tgluon.Trainer(tgluon.nn.Dense(2, in_units=2).initialize(
            ctx=CPU).collect_params(), "sgd", clip_global_norm=0.0)


def test_optimizer_counts_and_multipliers_match_jax():
    """``begin_num_update``, ``param_idx2name``, ``aggregate_num`` and
    ``clip_global_norm`` are taken; ``set_lr_mult``/``set_wd_mult`` by
    index and by name (a non-weight name's wd_mult 0), as the JAX
    package's SGD updates show."""
    rng = np.random.RandomState(11)
    ws = [rng.randn(3).astype("f4") for _ in range(3)]
    gs = [rng.randn(3).astype("f4") for _ in range(3)]
    kw = dict(learning_rate=0.1, wd=0.2, begin_num_update=5,
              param_idx2name={0: "fc_weight", 1: "fc_bias", 2: "x_gamma"},
              aggregate_num=4, clip_global_norm=None)
    jo, to = jopt.SGD(**kw), topt.SGD(**kw)
    for o in (jo, to):
        assert o.num_update == 5 and o.aggregate_num == 4
        o.set_lr_mult({"fc_bias": 3.0, 2: 0.5})
        o.set_wd_mult({"x_gamma": 2.0})
    assert to.wd_mult == jo.wd_mult == {"fc_bias": 0.0, "x_gamma": 2.0}
    jw = [nd.array(w) for w in ws]
    tw = [mx.nd.array(w, ctx=CPU) for w in ws]
    for i in range(3):
        jo.update(i, jw[i], nd.array(gs[i]), None)
        to.update(i, tw[i], mx.nd.array(gs[i], ctx=CPU), None)
        np.testing.assert_allclose(tw[i].asnumpy(), jw[i].asnumpy(),
                                   rtol=1e-6, atol=1e-7)
    assert to.num_update == jo.num_update == 6
    with pytest.raises(MXNetError, match="dict"):
        topt.SGD(param_idx2name=[1])
