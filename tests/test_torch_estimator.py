"""``gluon.contrib.estimator``: the port against the JAX package on the
CPU, with ``tests/test_estimator.py``'s fit patterns.

The handlers fire in the JAX package's order; a fit from the JAX
package's weights (carried by its ``save_parameters`` file) over the
same shuffled batches gives its training and validation metrics; the
batch quota, validation, logging and early stopping work as there; the
checkpoint handler writes ``{prefix}-epochN.params`` and
``{prefix}-best.params``, and the best file reloads into a fresh net to
the same outputs bit for bit.
"""
import logging
import os
import re

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import gluon, nd

CPU = mx.cpu()
JCPU = jmx.cpu()


def _arrays(n=192, d=8, classes=3, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, d).astype("f4")
    w = rng.randn(d, classes).astype("f4")
    return x, (x @ w).argmax(axis=1).astype("f4")


def _loaders(pkg, ctx):
    x, y = _arrays()
    ds = pkg.gluon.data.ArrayDataset(pkg.nd.array(x, ctx=ctx),
                                     pkg.nd.array(y, ctx=ctx))
    return pkg.gluon.data.DataLoader(ds, batch_size=32, shuffle=True), \
        pkg.gluon.data.DataLoader(ds, batch_size=64)


def _net(pkg, ctx, seed=0):
    if pkg is jmx:
        jmx.random.seed(seed)
    net = pkg.gluon.nn.HybridSequential(prefix="est_")
    with net.name_scope():
        net.add(pkg.gluon.nn.Dense(32, activation="relu"),
                pkg.gluon.nn.Dense(3))
    kw = {} if pkg is jmx else {"seed": seed}
    net.initialize(pkg.init.Xavier(), ctx=ctx, **kw)
    net(pkg.nd.zeros((1, 8), ctx=ctx))
    net.hybridize()
    return net


def _estimator(pkg, net, ctx, lr=0.05):
    est_mod = pkg.gluon.contrib.estimator
    return est_mod.Estimator(
        net, pkg.gluon.loss.SoftmaxCrossEntropyLoss(),
        metrics=pkg.metric.Accuracy(), context=ctx,
        trainer=pkg.gluon.Trainer(net.collect_params(), "adam",
                                  {"learning_rate": lr}))


def _recorder(pkg, log):
    e = pkg.gluon.contrib.estimator

    class Recorder(e.TrainBegin, e.TrainEnd, e.EpochBegin, e.EpochEnd,
                   e.BatchBegin, e.BatchEnd):
        def train_begin(self, estimator, *a, **kw):
            log.append("train_begin")

        def train_end(self, estimator, *a, **kw):
            log.append("train_end")

        def epoch_begin(self, estimator, *a, **kw):
            log.append("epoch_begin")

        def epoch_end(self, estimator, *a, **kw):
            log.append(("epoch_end", round(
                estimator.train_loss_metric.get()[1], 4)))

        def batch_begin(self, estimator, *a, **kw):
            log.append("batch_begin")

        def batch_end(self, estimator, *a, **kw):
            log.append(("batch_end", kw["pred"].shape))
    return Recorder()


def _fit(pkg, ctx, start, epochs=3):
    """A fit from the weights of the file ``start`` over batches shuffled
    under one numpy seed: (handler log, metrics, validation results, the
    default handlers' order)."""
    net = _net(pkg, ctx, seed=9)
    net.load_parameters(start, ctx=ctx)
    with ctx:
        train, val = _loaders(pkg, ctx)
        est = _estimator(pkg, net, ctx)
        log = []
        np.random.seed(5)
        est.fit(train, val_data=val, epochs=epochs,
                event_handlers=[_recorder(pkg, log)])
        order = [type(h).__name__ for h in est._prepare_handlers(
            val, epochs, None, [_recorder(pkg, [])])]
        metrics = [m.get() for m in (*est.train_metrics,
                                     est.train_loss_metric,
                                     *est.val_metrics)]
        results = est.evaluate(val)
    return log, metrics, results, order


def _names(pairs):
    """The metric names without the loss block's instance number (each
    package numbers its own blocks)."""
    return [re.sub(r"\d+$", "", n) for n, _ in pairs]


def test_fit_matches_jax_handler_order_and_metrics(tmp_path):
    start = str(tmp_path / "start.params")
    _net(jmx, JCPU).save_parameters(start)
    want = _fit(jmx, JCPU, start)
    got = _fit(mx, CPU, start)
    (wl, wm, wr, wo), (gl, gm, gr, go) = want, got
    assert go == wo
    assert go[0] == "ValidationHandler"
    assert [e if isinstance(e, str) else e[0] for e in gl] == \
        [e if isinstance(e, str) else e[0] for e in wl]
    assert [e[1] for e in gl if e[0] == "batch_end"] == \
        [e[1] for e in wl if e[0] == "batch_end"]
    assert _names(gm) == _names(wm)
    np.testing.assert_allclose([v for _, v in gm], [v for _, v in wm],
                               rtol=1e-4)
    assert _names(gr) == _names(wr)
    np.testing.assert_allclose([v for _, v in gr], [v for _, v in wr],
                               rtol=1e-4)
    assert dict(gr)["validation accuracy"] > 0.9


def test_batches_quota_stops_midway():
    e = gluon.contrib.estimator
    seen = []

    class Counter(e.StoppingHandler):
        def batch_end(self, estimator, *a, **kw):
            super().batch_end(estimator, *a, **kw)
            seen.append(1)
    with CPU:
        train, _ = _loaders(mx, CPU)
        est = _estimator(mx, _net(mx, CPU), CPU)
        est.fit(train, batches=3, epochs=50,
                event_handlers=[Counter(max_batch=3)])
    assert len(seen) == 3


def test_checkpoint_best_reloads_to_the_same_outputs(tmp_path):
    e = gluon.contrib.estimator
    with CPU:
        train, _ = _loaders(mx, CPU)
        est = _estimator(mx, _net(mx, CPU), CPU)
        ckpt = e.CheckpointHandler(str(tmp_path), model_prefix="toy",
                                   monitor=est.train_loss_metric,
                                   save_best=True)
        est.fit(train, epochs=2, event_handlers=[ckpt])
        for name in ("toy-epoch0", "toy-epoch1", "toy-best"):
            assert os.path.exists(tmp_path / f"{name}.params")
        best = str(tmp_path / "toy-best.params")
        fresh = _net(mx, CPU, seed=3)
        fresh.load_parameters(best)
        x = nd.array(_arrays()[0][:16], ctx=CPU)
        ref = _net(mx, CPU, seed=4)
        ref.load_parameters(best)
        np.testing.assert_array_equal(fresh(x).asnumpy(), ref(x).asnumpy())
        # the JAX package reads the port's checkpoint to equal outputs
        jnet = _net(jmx, JCPU, seed=5)
        jnet.load_parameters(best)
        np.testing.assert_allclose(
            jnet(jmx.nd.array(x.asnumpy(), ctx=JCPU)).asnumpy(),
            fresh(x).asnumpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_early_stopping_fires(pkg):
    pkg, ctx = (jmx, JCPU) if pkg == "jax" else (mx, CPU)
    e = pkg.gluon.contrib.estimator
    with ctx:
        train, _ = _loaders(pkg, ctx)
        est = _estimator(pkg, _net(pkg, ctx), ctx)
        es = e.EarlyStoppingHandler(monitor=est.train_loss_metric,
                                    patience=1, min_delta=100.0)
        epochs = []
        est.fit(train, epochs=50, event_handlers=[es, _recorder(pkg,
                                                                epochs)])
    assert es.stop_training and est.stop_training
    assert sum(1 for x in epochs if x == "epoch_begin") == 2


def test_validation_and_logging_handlers(caplog):
    e = gluon.contrib.estimator
    calls = []
    with CPU:
        train, val = _loaders(mx, CPU)
        est = _estimator(mx, _net(mx, CPU), CPU)
        est.fit(train, val_data=None, epochs=1, event_handlers=[])
        vh = e.ValidationHandler(val, lambda d: calls.append(1),
                                 epoch_period=1)
        lh = e.LoggingHandler(log_interval=2,
                              metrics=[est.train_loss_metric])
        with caplog.at_level(logging.INFO,
                             logger="mxnet_tpu_torch.estimator"):
            est.fit(train, epochs=2, event_handlers=[vh, lh])
    assert len(calls) == 2
    assert any("batch 2" in r.message for r in caplog.records)


def test_metrics_type_checked_and_default_trainer():
    with pytest.raises(ValueError):
        gluon.contrib.estimator.Estimator(
            _net(mx, CPU), gluon.loss.SoftmaxCrossEntropyLoss(),
            metrics="accuracy")
    with CPU:
        net = gluon.nn.Dense(3, in_units=8)
        est = gluon.contrib.estimator.Estimator(
            net, gluon.loss.SoftmaxCrossEntropyLoss())
    assert isinstance(est.trainer, gluon.Trainer)
    assert est.trainer.optimizer.learning_rate == 1e-3
    assert [m.name for m in est.train_metrics] == ["training accuracy"]
    assert list(net.collect_params().values())[0].data().context == CPU
