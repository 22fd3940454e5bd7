"""Helpers of the port's model-zoo and detector tests: a JAX block and
its port twin built under one prefix from the same weights, and their
outputs, gradients and parameters compared at the float32 tolerances of
``mxnet_tpu/test_utils.py`` (rtol 1e-4, atol 1e-5).  The JAX block is
hybridized for its training-mode calls and gradients: its compiled
program takes a quarter to a fifth of the time of its eager ops' (one
compilation an op and shape).

The two packages draw dropout from different streams, so numerics are
compared with every ``Dropout`` at rate 0 (ROADMAP's parity rule).
"""
import copy

import numpy as np

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import models, nd

import torch_threads  # noqa: F401  (a worker's share of the cores)

CPU = mx.cpu()
F32 = dict(rtol=1e-4, atol=1e-5)


def close(got, want, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               err_msg=what, **F32)


def values(net):
    return {k: p.data().asnumpy() for k, p in net.collect_params().items()}


def _jax_blocks(block):
    yield block
    for child in block._children.values():
        yield from _jax_blocks(child)


def no_dropout(jnet, tnet):
    """Every Dropout of both nets at rate 0."""
    for blk in (*_jax_blocks(jnet), *tnet.modules()):
        if type(blk).__name__ == "Dropout":
            blk._rate = 0.0


def pair(build_jax, build_port, x, one_prefix=True):
    """(JAX block, port block): each called once on ``x`` in predict
    mode (the deferred shapes), the JAX weights carried into the port's
    by name (every name under the JAX block's prefix unless
    ``one_prefix`` is False: a net over a zoo backbone made outside it
    keeps the backbone's names)."""
    jnet = build_jax()
    jnet.initialize(jmx.init.Xavier())
    jnet(jmx.nd.array(x))
    tnet = build_port()
    tnet.initialize(mx.init.Xavier(), ctx=CPU, seed=0)
    tnet(nd.array(x, ctx=CPU))
    models.load_jax_gluon_params(tnet, values(jnet),
                                 jnet.prefix if one_prefix else None)
    return jnet, tnet


def assert_params_equal(tnet, jnet):
    want = values(jnet)
    got = values(tnet)
    assert list(got) == list(want)
    for k, v in got.items():
        close(v, want[k], k)


def check_forward(jnet, tnet, x, train=True):
    """Predict-mode outputs; then (``train``) a training-mode forward
    and the running statistics after it."""
    close(tnet(nd.array(x, ctx=CPU)).asnumpy(),
          jnet(jmx.nd.array(x)).asnumpy(), "predict")
    if not train:
        return
    no_dropout(jnet, tnet)
    jnet.hybridize()
    with mx.autograd.record():
        got = tnet(nd.array(x, ctx=CPU))
    with jmx.autograd.record():
        want = jnet(jmx.nd.array(x))
    close(got.asnumpy(), want.asnumpy(), "train")
    assert_params_equal(tnet, jnet)


def _grads(pkg, net, x, ctx, train):
    with pkg.autograd.record(train_mode=train):
        out = net(pkg.nd.array(x, ctx=ctx))
        ramp = np.linspace(-1.0, 1.0, out.size, dtype="f4").reshape(
            out.shape)
        ramp /= np.linalg.norm(ramp)
        loss = (out * pkg.nd.array(ramp, ctx=ctx)).sum()
    loss.backward()
    return {k: p.grad().asnumpy() for k, p in net.collect_params().items()
            if p.grad_req != "null"}


def check_grads(jnet, tnet, x, train=True):
    """Gradients of sum(out * ramp) for every parameter (dropout off;
    the ramp runs from -1 to 1, scaled to a unit L2 norm, so that a
    gradient's size does not grow with the output's), in training mode
    (then the running statistics the forward moved) or in predict
    mode."""
    no_dropout(jnet, tnet)
    jnet.hybridize()
    want = _grads(jmx, jnet, x, jmx.cpu(), train)
    got = _grads(mx, tnet, x, CPU, train)
    assert list(got) == list(want)
    for k, g in got.items():
        close(g, want[k], k)
    assert_params_equal(tnet, jnet)


def train_steps(pkg, net, batches, loss_of, lr, ctx, observe=None):
    """One Adam step at ``lr`` a batch through the gluon loop (record,
    ``loss_of(net, *arrays)``, backward, ``Trainer.step``); returns the
    losses.  With ``observe``, ``loss_of`` returns (loss, a value), and
    ``observe`` gets the value as a numpy array at each step."""
    trainer = pkg.gluon.Trainer(net.collect_params(), "adam",
                                {"learning_rate": lr})
    losses = []
    for arrays in batches:
        arrays = [pkg.nd.array(a, ctx=ctx, dtype=a.dtype) for a in arrays]
        with pkg.autograd.record():
            loss = loss_of(net, *arrays)
        if observe is not None:
            loss, seen = loss
            observe(seen.asnumpy())
        loss.backward()
        trainer.step(arrays[0].shape[0])
        losses.append(float(loss.asnumpy().ravel()[0]))
    return losses


def _with_loss(jnet, loss_of):
    """The JAX net and its loss as one hybridized block: its training
    call is one compiled program and its backward one more, where the
    loss's eager ops would each compile on their own (in float32 and
    again in float64)."""
    class WithLoss(jmx.gluon.HybridBlock):
        def __init__(self):
            super().__init__(prefix="withloss_")
            self.net = jnet

        def hybrid_forward(self, F, *arrays):
            return loss_of("jax", self.net, *arrays)

    block = WithLoss()
    block.hybridize()
    return lambda _net, *arrays: block(*arrays)


def _copy_into(dst, src_values):
    for p, v in zip(dst.collect_params().values(), src_values):
        p.set_data(v)


def trajectories(build_port, jnet, tnet, x, batches, loss_of, lr,
                 prepare=None, observe=None):
    """Adam steps at ``lr`` over ``batches`` (numpy float32 arrays) from
    one start in four runs: the JAX package's ``jnet`` and the port's
    ``tnet`` (their weights equal: ``pair``), and a float64 twin of each
    (the port's ``build_port()``, called on ``x``, its values set from the
    float32 net's; the JAX one a copy of ``jnet``; each cast, the JAX one
    under ``jax.enable_x64``).  Both packages' nets are hybridized, and
    the JAX runs compute net and loss in one hybridized block
    (``_with_loss``), so a value the test reads on the host goes to
    ``observe`` (see ``train_steps``).  ``loss_of(zoo, net, *arrays)``
    computes the loss with the package's model module (``zoo`` is
    ``"jax"`` or ``"port"``); ``prepare(net)`` is called on each JAX net
    first, to build what the model caches on its first call outside the
    compiled program.  Returns {"jax", "jax_f64", "port", "port_f64"}:
    (losses, net)."""
    import jax
    import torch
    f64 = [[a.astype("f8") for a in b] for b in batches]
    start = list(values(jnet).values())
    dnet = build_port()
    dnet.initialize(mx.init.Xavier(), ctx=CPU, seed=0)
    dnet(nd.array(x, ctx=CPU))
    _copy_into(dnet, start)
    dnet.to(torch.float64)
    tnet.hybridize()
    runs = {}
    # a copy of the JAX net, whose shapes are made: a new one would make
    # them by an eager call, every op compiled again under x64
    jdnet = copy.deepcopy(jnet, {id(d): d for d in jax.devices()})
    with jax.enable_x64(True):
        jdnet.cast("float64")
        jdnet.hybridize()
        if prepare is not None:
            prepare(jdnet)
        runs["jax_f64"] = (train_steps(
            jmx, jdnet, f64, _with_loss(jdnet, loss_of), lr,
            jmx.cpu(), observe), jdnet)
    jnet.hybridize()
    if prepare is not None:
        prepare(jnet)
    runs["jax"] = (train_steps(jmx, jnet, batches,
                               _with_loss(jnet, loss_of), lr,
                               jmx.cpu(), observe), jnet)
    runs["port"] = (train_steps(mx, tnet, batches,
                                lambda *a: loss_of("port", *a), lr, CPU,
                                observe), tnet)
    runs["port_f64"] = (train_steps(mx, dnet, f64,
                                    lambda *a: loss_of("port", *a), lr,
                                    CPU, observe), dnet)
    return runs


def _rel(got, want):
    return float(np.linalg.norm(np.asarray(got, "f8") - want)
                 / max(np.linalg.norm(want), 1e-30))


def hold_trajectory(runs, tol=1e-4, tol64=1e-6):
    """The trajectory rule of the detector tests over ``trajectories``'
    runs.  In float64 the port's losses are within rtol ``tol64`` (the
    float64 rtol of ``mxnet_tpu/test_utils.py``) of the JAX package's,
    and each weight within ``tol64`` in relative L2: the two compute the
    same function.  In float32 the port's distance to its own float64
    run, in the losses and each weight, is within the larger of ``tol``
    and 4 times the JAX package's distance to its float64 run: the
    port's float32 arithmetic is no coarser than the reference's.  (On
    these nets float32 parts from float64 by more than ``tol`` after a
    few Adam steps in both packages: BatchNorm over small maps, and the
    parameters that start at 0, BatchNorm's offsets and the biases,
    whose small gradients' rounding shows as a share of a small norm
    once Adam normalises their steps.)"""
    (jl, jnet), (jdl, jdnet), (tl, tnet), (dl, dnet) = (
        runs[k] for k in ("jax", "jax_f64", "port", "port_f64"))
    np.testing.assert_allclose(dl, jdl, rtol=tol64)
    spread = float(np.abs(np.divide(jl, jdl) - 1).max())
    np.testing.assert_allclose(tl, dl, rtol=max(tol, 4 * spread))
    nets = [list(values(n).values()) for n in (jnet, jdnet, tnet, dnet)]
    assert len({len(v) for v in nets}) == 1
    for name, jw, jdw, w, dw in zip(values(tnet), *nets):
        assert _rel(dw, jdw) <= tol64, name
        assert _rel(w, dw) <= max(tol, 4 * _rel(jw, jdw)), name
