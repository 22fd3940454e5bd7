"""The port's kvstore, several contexts a parameter and the gluon
Trainer's kvstore path against the JAX package's, case by case of
``tests/test_kvstore.py``, on the CPU.

Each case runs once through each package (``jmx``, ``tmx``) on the same
numpy inputs and the results are held to each other; a training loop
starts the port's net from the JAX net's weights.
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

import torch_parity  # noqa: F401  (a worker's share of the cores)

SHAPE = (4, 4)
PKGS = {"jax": jmx, "torch": tmx}


def both(fn, rtol=1e-6, atol=1e-7):
    """``fn(mx)`` in both packages (inside the CPU scope); the numpy
    results must agree.  Returns the port's."""
    outs = {}
    for name, mx in PKGS.items():
        with mx.cpu():
            res = fn(mx)
        outs[name] = [np.asarray(r) for r in
                      (res if isinstance(res, (list, tuple)) else [res])]
    for j, t in zip(outs["jax"], outs["torch"]):
        np.testing.assert_allclose(t, j, rtol=rtol, atol=atol)
    return outs["torch"]


def test_single_kv_pair():
    def fn(mx):
        kv = mx.kv.create("local")
        kv.init(3, mx.nd.ones(SHAPE))
        a = mx.nd.zeros(SHAPE)
        kv.pull(3, out=a)
        first = a.asnumpy()
        kv.push(3, mx.nd.ones(SHAPE) * 8)
        kv.pull(3, out=a)
        return first, a.asnumpy()
    first, second = both(fn)
    assert (first == 1).all() and (second == 8).all()


def test_list_kv_pairs():
    def fn(mx):
        kv = mx.kv.create("local")
        keys = [5, 7, 9]
        kv.init(keys, [mx.nd.ones(SHAPE)] * 3)
        kv.push(keys, [mx.nd.ones(SHAPE) * 4] * 3)
        outs = [mx.nd.zeros(SHAPE) for _ in keys]
        kv.pull(keys, out=outs)
        return [o.asnumpy() for o in outs]
    assert all((o == 4).all() for o in both(fn))


@pytest.mark.parametrize("ndev", [2, 4])
def test_aggregation_over_contexts(ndev):
    def fn(mx):
        devs = [mx.cpu(i) for i in range(ndev)]
        kv = mx.kv.create("device")
        kv.init("a", mx.nd.zeros(SHAPE))
        kv.push("a", [mx.nd.ones(SHAPE, ctx=d) * (i + 1)
                      for i, d in enumerate(devs)])
        outs = [mx.nd.zeros(SHAPE, ctx=d) for d in devs]
        kv.pull("a", out=outs)
        assert [o.context for o in outs] == devs
        return [o.asnumpy() for o in outs]
    assert all((v == ndev * (ndev + 1) / 2).all() for v in both(fn))


def test_updater_pushpull_and_broadcast():
    def fn(mx):
        kv = mx.kv.create("local")
        kv.init("w", mx.nd.ones(SHAPE))

        def update(key, grad, weight):
            weight += grad * 2
        kv._set_updater(update)
        kv.push("w", mx.nd.ones(SHAPE))
        out = mx.nd.zeros(SHAPE)
        kv.pull("w", out=out)
        pp = mx.nd.ones(SHAPE) * 0.5
        kv.pushpull("w", pp)
        b = mx.nd.zeros(SHAPE)
        kv.broadcast("b", mx.nd.ones(SHAPE) * 7, out=b)
        return out.asnumpy(), pp.asnumpy(), b.asnumpy()
    out, pp, b = both(fn)
    assert (out == 3).all() and (pp == 4).all() and (b == 7).all()


@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_set_optimizer_and_its_states(opt, tmp_path):
    def fn(mx):
        kv = mx.kv.create("local")
        kv.init("0", mx.nd.ones(SHAPE))
        kv.set_optimizer(mx.optimizer.create(opt, learning_rate=0.1))
        rng = np.random.RandomState(1)
        outs = []
        for _ in range(3):
            kv.push("0", mx.nd.array(rng.randn(*SHAPE).astype("f4")))
            out = mx.nd.zeros(SHAPE)
            kv.pull("0", out=out)
            outs.append(out.asnumpy())
        path = str(tmp_path / f"{mx.__name__}.states")
        kv.save_optimizer_states(path)
        kv.load_optimizer_states(path)
        return outs
    both(fn, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("cfg", [{"type": "2bit", "threshold": 0.5},
                                 {"type": "2bit", "threshold": 0.1},
                                 {"type": "int8"}])
def test_gradient_compression_with_residuals(cfg):
    """Three pushes from two contexts: each push is compressed with its
    own residual, as the reference's."""
    def fn(mx):
        kv = mx.kv.create("device")
        kv.set_gradient_compression(dict(cfg))
        kv.init("g", mx.nd.zeros((64,)))
        rng = np.random.RandomState(0)
        outs = []
        for _ in range(3):
            kv.push("g", [mx.nd.array(rng.randn(64).astype("f4") * 0.4,
                                      ctx=mx.cpu(i)) for i in range(2)])
            out = mx.nd.zeros((64,))
            kv.pull("g", out=out)
            outs.append(out.asnumpy())
        return outs
    both(fn, rtol=1e-6, atol=1e-6)


def test_reference_compression_cases():
    def fn(mx):
        kv = mx.kv.create("local")
        kv.init("g", mx.nd.zeros((3,)))
        kv.set_gradient_compression({"type": "2bit", "threshold": 0.5})
        kv.push("g", mx.nd.array([0.7, -0.9, 0.2]))
        out = mx.nd.zeros((3,))
        kv.pull("g", out=out)
        first = out.asnumpy()
        kv.push("g", mx.nd.array([0.2, -0.2, 0.2]))
        kv.pull("g", out=out)
        return first, out.asnumpy()
    first, second = both(fn)
    np.testing.assert_allclose(first, [0.5, -0.5, 0.0])
    np.testing.assert_allclose(second, [0.0, -0.5, 0.0], atol=1e-7)
    with pytest.raises(ValueError, match="unsupported"):
        tmx.kv.create("local").set_gradient_compression({"type": "fp4"})


def test_dist_sync_in_one_process():
    for name in ("dist_sync", "dist_tpu_sync", "dist_sync_device", "dist"):
        kv = tmx.kv.create(name)
        assert (kv.rank, kv.num_workers, kv.is_distributed) == (0, 1, True)
    def fn(mx):
        kv = mx.kv.create("dist_tpu_sync")
        kv.init("x", mx.nd.ones((2, 2)))
        kv.push("x", [mx.nd.ones((2, 2)), mx.nd.ones((2, 2))])
        out = mx.nd.zeros((2, 2))
        kv.pull("x", out=out)
        kv._barrier()
        return out.asnumpy()
    assert (both(fn)[0] == 2).all()
    with pytest.raises(tmx.MXNetError, match="dist_tpu_sync"):
        tmx.kv.create("dist_async")


def test_row_sparse_pull():
    def fn(mx):
        kv = mx.kv.create("local")
        kv.init("rs", mx.nd.array(np.arange(12).reshape(4, 3)))
        outs = []
        for rows in ([1, 3], [0], [2, 2, 0]):
            out = mx.nd.zeros((4, 3))
            kv.row_sparse_pull("rs", out=out, row_ids=mx.nd.array(rows))
            outs.append(out.asnumpy())
        return outs
    got = both(fn)
    want = np.zeros((4, 3))
    want[[1, 3]] = np.arange(12).reshape(4, 3)[[1, 3]]
    np.testing.assert_array_equal(got[0], want)


def test_multi_context_parameter():
    for mx in (jmx, tmx):
        devs = [mx.cpu(i) for i in range(2)]
        net = mx.gluon.nn.Dense(4, in_units=3)
        net.initialize(ctx=devs)
        p = list(net.collect_params().values())[0]
        assert p.list_ctx() == devs
        assert len(p.list_data()) == 2 and len(p.list_grad()) == 2
        np.testing.assert_array_equal(p.list_data()[0].asnumpy(),
                                      p.list_data()[1].asnumpy())
        assert p.data(devs[1]) is p.list_data()[1]
        for d in devs:
            y = net(mx.nd.ones((2, 3), ctx=d))
            assert y.context == d
        with pytest.raises(mx.MXNetError):
            p.data(mx.cpu(5))


def test_each_context_fills_its_own_gradient():
    """A backward on context i writes the gradient of the copy on i."""
    devs = [tmx.cpu(0), tmx.cpu(1)]
    net = tmx.gluon.nn.Dense(2, in_units=3)
    net.initialize(ctx=devs)
    p = net.collect_params()[net.prefix + "weight"]
    for i, d in enumerate(devs):
        with tmx.autograd.record():
            y = net(tmx.nd.ones((1, 3), ctx=d) * (i + 1))
        y.backward()
    g0, g1 = (g.asnumpy() for g in p.list_grad())
    np.testing.assert_allclose(g0, 1.0)
    np.testing.assert_allclose(g1, 2.0)


def _train(mx, ctx_list, opt, w0, x, y, steps, kvstore="device",
           compression=None):
    net = mx.gluon.nn.Dense(y.shape[1], in_units=x.shape[1],
                            prefix="dense_")
    net.initialize(ctx=ctx_list)
    for p, v in zip(net.collect_params().values(), w0):
        p.set_data(mx.nd.array(v))
    tr = mx.gluon.Trainer(net.collect_params(), opt,
                          {"learning_rate": 0.1}, kvstore=kvstore,
                          compression_params=compression)
    loss_fn = mx.gluon.loss.L2Loss()
    for _ in range(steps):
        xs = mx.gluon.utils.split_and_load(mx.nd.array(x), ctx_list)
        ys = mx.gluon.utils.split_and_load(mx.nd.array(y), ctx_list)
        with mx.autograd.record():
            losses = [loss_fn(net(a), b) for a, b in zip(xs, ys)]
        for l in losses:
            l.backward()
        tr.step(batch_size=x.shape[0])
    return [p.data().asnumpy() for p in net.collect_params().values()]


@pytest.mark.parametrize("opt", ["sgd", "adam"])
@pytest.mark.parametrize("ndev", [1, 2, 4])
def test_split_and_load_training_matches_one_context_and_jax(opt, ndev):
    """split_and_load over ``ndev`` contexts, a backward each and
    ``Trainer.step`` equal one context's training and the JAX
    package's; Adam's counts advance once a step, not once a copy."""
    rng = np.random.RandomState(42)
    x = rng.rand(8, 3).astype("f4")
    y = rng.rand(8, 2).astype("f4")
    w0 = [rng.randn(2, 3).astype("f4") * 0.5, np.zeros(2, "f4")]

    def run(mx, n):
        with mx.cpu():
            return _train(mx, [mx.cpu(i) for i in range(n)], opt, w0, x,
                          y, 4)
    for t, j, one in zip(run(tmx, ndev), run(jmx, ndev), run(tmx, 1)):
        np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(t, one, rtol=1e-5, atol=1e-6)


def test_trainer_with_compression_matches_jax():
    rng = np.random.RandomState(7)
    x = rng.rand(8, 3).astype("f4")
    y = rng.rand(8, 2).astype("f4")
    w0 = [rng.randn(2, 3).astype("f4") * 0.5, np.zeros(2, "f4")]
    for cfg in ({"type": "2bit", "threshold": 0.05}, {"type": "int8"}):
        got = []
        for mx in (jmx, tmx):
            with mx.cpu():
                got.append(_train(mx, [mx.cpu(0), mx.cpu(1)], "sgd", w0, x,
                                  y, 3, compression=dict(cfg)))
        for j, t in zip(*got):
            np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-6)


def test_trainer_save_and_load_states_on_two_contexts(tmp_path):
    rng = np.random.RandomState(3)
    x = rng.rand(4, 3).astype("f4")
    devs = [tmx.cpu(0), tmx.cpu(1)]
    net = tmx.gluon.nn.Dense(2, in_units=3)
    net.initialize(ctx=devs)
    tr = tmx.gluon.Trainer(net.collect_params(), "adam",
                           {"learning_rate": 0.1})
    for _ in range(2):
        xs = tmx.gluon.utils.split_and_load(
            tmx.nd.array(x, ctx=tmx.cpu()), devs)
        with tmx.autograd.record():
            ls = [net(a).sum() for a in xs]
        for l in ls:
            l.backward()
        tr.step(4)
    path = str(tmp_path / "t.states")
    tr.save_states(path)
    tr.load_states(path)
    assert tr.optimizer._index_update_count[0] == 2
    assert all(u.optimizer is tr.optimizer for u in tr._updaters)


def test_allreduce_collective():
    mesh = tmx.parallel.make_mesh({"dp": 1}, devices=[tmx.cpu()])
    vals = [tmx.nd.full((2, 2), i, ctx=tmx.cpu(0)) for i in range(8)]
    out = tmx.parallel.collectives.allreduce(vals, axis="dp", mesh=mesh)
    for o in out:
        np.testing.assert_allclose(o.asnumpy(), sum(range(8)))


@pytest.mark.parametrize("cfg", [{"type": "2bit", "threshold": 0.3},
                                 {"type": "int8"}])
def test_compression_codec_matches_jax(cfg):
    """``compress``, ``encode`` and ``decode`` of the port's
    GradientCompression equal the JAX package's on the same pushes, the
    residuals carried across three of them."""
    import jax.numpy as jnp
    from mxnet_tpu.kvstore.compression import GradientCompression as JGC
    from mxnet_tpu_torch.kvstore.compression import GradientCompression
    import torch
    rng = np.random.RandomState(3)
    j, t = JGC(dict(cfg)), GradientCompression(dict(cfg))
    for _ in range(3):
        g = rng.randn(2, 33).astype("f4") * 0.5
        np.testing.assert_allclose(
            t.compress("k", torch.from_numpy(g)).numpy(),
            np.asarray(j.compress("k", jnp.asarray(g))), rtol=1e-6,
            atol=1e-7)
        tc, ts = t.encode("e", torch.from_numpy(g))
        jc, js = j.encode("e", jnp.asarray(g))
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-7)
    codes = rng.randint(-127, 128, (3, 7)).astype("i1")
    scales = rng.rand(3).astype("f4")
    np.testing.assert_allclose(
        GradientCompression.decode(torch.from_numpy(codes),
                                   torch.from_numpy(scales)).numpy(),
        np.asarray(JGC.decode(jnp.asarray(codes), jnp.asarray(scales))),
        rtol=1e-6)


def test_hybridized_block_on_two_contexts():
    """A hybridized block whose parameters have copies on two contexts
    runs inline (a graph holds one copy) and computes with each
    context's copy."""
    devs = [tmx.cpu(0), tmx.cpu(1)]
    net = tmx.gluon.nn.HybridSequential()
    net.add(tmx.gluon.nn.Dense(3, in_units=2))
    net.initialize(ctx=devs)
    net.hybridize()
    w = net[0].weight
    w.data(devs[1])[:] = w.data(devs[0]) * 2
    x = np.ones((1, 2), "f4")
    y0 = net(tmx.nd.array(x, ctx=devs[0])).asnumpy()
    y1 = net(tmx.nd.array(x, ctx=devs[1])).asnumpy()
    b = net[0].bias.data().asnumpy()
    np.testing.assert_allclose(y1 - b, 2 * (y0 - b), rtol=1e-6)
    assert net._cached_op is None
