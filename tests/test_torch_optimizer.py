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
    with pytest.raises(MXNetError, match="not ported"):
        topt.create("lamb")


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
