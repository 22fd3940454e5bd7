"""``example/dcgan.py``'s GAN through the port against the JAX package.

The example's own ``build_generator``, ``build_discriminator`` and
``synthetic_batch`` are read from its source, once as written and once
with the package renamed ``mxnet_tpu_torch``, so both packages build the
same nets (here at tiny widths: ngf = ndf = 8, nz = 16, batch 8, 32 x 32
RGB).  The JAX nets are initialized with ``Normal(0.02)`` from a seed
and carried into the port by name.  Then both run the example's loop:
a D step (``disc(real)``, ``disc(gen(z).detach())``, two
``SigmoidBinaryCrossEntropyLoss`` means, ``backward``, Adam lr 2e-4 with
beta1 0.5) and a G step (``disc(gen(z))`` against the real label), with
the same seeded numpy noise (the packages' own draws differ).  After
three such iterations the D and G losses agree within 1e-4 (relative),
and every weight and BatchNorm moving statistic (updated by every
training-mode call: the discriminator's three times an iteration)
within 1e-4 in relative L2, eager and hybridized.  That is
``test_torch_forecast.py``'s rule, not 1e-5: Adam divides each
element's step by the root of its own squared gradients, so where a
gradient is mostly cancellation the two frameworks' float32 sums part
by more.  The generator's first BatchNorm beta, which starts at 0 and
moves by about lr a step, reads 1.5e-6 to 1.8e-5 (one test ordering
to another); every other tensor stays below 1e-6.
"""
import math
import os

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu_torch.models import load_jax_gluon_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = mx.cpu()
NGF = NDF = 8
NZ, B, STEPS, LR = 16, 8, 3, 2e-4
LOSS_RTOL = 1e-4
WEIGHT_TOL = 1e-4


def _example(port):
    """The namespace of example/dcgan.py, for the JAX package or (with
    the package renamed) the port; its ``main`` is not run."""
    with open(os.path.join(REPO, "example", "dcgan.py")) as f:
        src = f.read()
    if port:
        src = src.replace("mxnet_tpu", "mxnet_tpu_torch")
    ns = {"__name__": "dcgan_example", "__file__": os.path.join(
        REPO, "example", "dcgan.py")}
    exec(compile(src, "dcgan.py", "exec"), ns)
    return ns


def _nets(ex, pkg, ctx_kw):
    gen = ex["build_generator"](ngf=NGF)
    disc = ex["build_discriminator"](ndf=NDF)
    for net in (gen, disc):
        net.initialize(pkg.init.Normal(0.02), **ctx_kw)
    return gen, disc


def _rel_l2(got, want):
    got, want = np.asarray(got, "f8"), np.asarray(want, "f8")
    return math.sqrt(float(np.square(got - want).sum())
                     / max(float(np.square(want).sum()), 1e-30))


def _train(pkg, ex, gen, disc, ctx_kw, hybridize):
    """The example's loop for STEPS iterations with seeded numpy noise:
    (D losses, G losses, {param: value} of both nets after)."""
    nd, autograd, gluon = pkg.nd, pkg.autograd, pkg.gluon
    if hybridize:
        gen.hybridize()
        disc.hybridize()
    g_tr = gluon.Trainer(gen.collect_params(), "adam",
                         {"learning_rate": LR, "beta1": 0.5})
    d_tr = gluon.Trainer(disc.collect_params(), "adam",
                         {"learning_rate": LR, "beta1": 0.5})
    bce = gluon.loss.SigmoidBinaryCrossEntropyLoss()
    rng = np.random.RandomState(0)
    noise = np.random.RandomState(1)
    real_label = nd.ones((B,), **ctx_kw)
    fake_label = nd.zeros((B,), **ctx_kw)
    d_losses, g_losses = [], []
    for _ in range(STEPS):
        real = nd.array(ex["synthetic_batch"](rng, B), **ctx_kw)
        z = nd.array(noise.randn(B, NZ, 1, 1).astype("f4"), **ctx_kw)
        with autograd.record():
            out_r = disc(real).reshape((-1,))
            fake = gen(z)
            out_f = disc(fake.detach()).reshape((-1,))
            d_loss = (nd.mean(bce(out_r, real_label))
                      + nd.mean(bce(out_f, fake_label)))
        d_loss.backward()
        d_tr.step(B)
        with autograd.record():
            out = disc(gen(z)).reshape((-1,))
            g_loss = nd.mean(bce(out, real_label))
        g_loss.backward()
        g_tr.step(B)
        d_losses.append(float(d_loss.asnumpy()))
        g_losses.append(float(g_loss.asnumpy()))
    return d_losses, g_losses, _values(gen, disc)


def _values(*nets):
    return {k: p.data().asnumpy() for net in nets
            for k, p in net.collect_params().items()}


@pytest.fixture(scope="module")
def examples():
    return _example(False), _example(True)


def _pair(examples):
    jex, tex = examples
    jmx.random.seed(5)
    jgen, jdisc = _nets(jex, jmx, {})
    z = jmx.nd.array(np.zeros((B, NZ, 1, 1), "f4"))
    jdisc(jgen(z))                       # the deferred shapes
    tgen, tdisc = _nets(tex, mx, {"ctx": CPU})
    tdisc(tgen(mx.nd.array(np.zeros((B, NZ, 1, 1), "f4"), ctx=CPU)))
    for jnet, tnet, prefix in ((jgen, tgen, "gen_"),
                               (jdisc, tdisc, "disc_")):
        assert sorted(tnet.collect_params().keys()) == \
            sorted(jnet.collect_params().keys())
        load_jax_gluon_params(tnet, {k: p.data().asnumpy() for k, p in
                                     jnet.collect_params().items()},
                              jax_prefix=prefix)
    return (jgen, jdisc), (tgen, tdisc)


@pytest.mark.parametrize("hybridize", [False, True],
                         ids=["eager", "hybridized"])
def test_three_gan_iterations_match_jax(examples, hybridize):
    (jgen, jdisc), (tgen, tdisc) = _pair(examples)
    initial = _values(jgen, jdisc)
    # the JAX nets hybridized in both cases: the reference's compiled
    # programs, where its eager ops would each compile on their own
    jd, jg, jw = _train(jmx, examples[0], jgen, jdisc, {}, True)
    td, tg, tw = _train(mx, examples[1], tgen, tdisc, {"ctx": CPU},
                        hybridize)
    np.testing.assert_allclose(td, jd, rtol=LOSS_RTOL)
    np.testing.assert_allclose(tg, jg, rtol=LOSS_RTOL)
    assert sorted(tw) == sorted(jw)
    stats = [k for k in jw if k.endswith(("running_mean", "running_var"))]
    assert len(stats) == 2 * 5             # 3 BatchNorms in G, 2 in D
    errs = {k: _rel_l2(tw[k], jw[k]) for k in jw}
    assert max(errs.values()) <= WEIGHT_TOL, \
        {k: e for k, e in errs.items() if e > WEIGHT_TOL}
    # the nets moved: Adam changed every trainable weight
    for k in jw:
        if not k.endswith(("running_mean", "running_var")):
            assert np.abs(tw[k] - initial[k]).max() > 0, k


def test_batchnorm_moving_statistics_after_two_calls_match_jax(examples):
    """One D step calls the discriminator twice in training mode (real,
    then fake): both packages update the moving statistics twice, with
    the batch's biased variance and momentum 0.9."""
    (jgen, jdisc), (tgen, tdisc) = _pair(examples)
    initial = _values(jdisc)
    ex = examples[0]
    real = ex["synthetic_batch"](np.random.RandomState(2), B)
    z = np.random.RandomState(3).randn(B, NZ, 1, 1).astype("f4")
    out = {}
    for pkg, gen, disc, kw in ((jmx, jgen, jdisc, {}),
                               (mx, tgen, tdisc, {"ctx": CPU})):
        with pkg.autograd.record():
            disc(pkg.nd.array(real, **kw))
            disc(gen(pkg.nd.array(z, **kw)).detach())
        out[pkg] = {k: v for k, v in _values(disc).items()
                    if k.endswith(("running_mean", "running_var"))}
    assert len(out[mx]) == 4
    for k, v in out[jmx].items():
        assert not np.array_equal(v, initial[k])
        np.testing.assert_allclose(out[mx][k], v, rtol=1e-4, atol=1e-6,
                                   err_msg=k)
