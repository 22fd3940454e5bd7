"""``mx.metric`` and ``mx.lr_scheduler``: the port against the JAX
package on the CPU.

Every metric of ``metric.py`` on the same labels and predictions, over
two updates (``tests/test_metric_loss_io.py``'s cases among them:
accuracy, top-k, F1, MCC, perplexity with ``ignore_label``, the
regression metrics, composite and ``create``, reset and NaN); every
scheduler's learning rate over 200 updates, with and without warm-up;
and an optimizer whose ``lr_scheduler`` gives each update its rate.
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx

CPU = mx.cpu()
JCPU = jmx.cpu()
RNG = np.random.RandomState(0)
PROBS = RNG.dirichlet(np.ones(4), size=10).astype("f4")
CLASSES = RNG.randint(0, 4, 10).astype("f4")
BIN = RNG.dirichlet(np.ones(2), size=12).astype("f4")
BIN_LABEL = RNG.randint(0, 2, 12).astype("f4")
REG_PRED = RNG.randn(9, 2).astype("f4")
REG_LABEL = RNG.randn(9, 2).astype("f4")
PPL_LABEL = CLASSES.copy()
PPL_LABEL[[2, 5]] = 3.0


def _updates(pkg, ctx, metric, pairs):
    """``metric`` updated with each (labels, preds) of ``pairs``, as
    NDArrays; returns what ``get`` and ``get_name_value`` give."""
    arr = lambda a: pkg.nd.array(a, ctx=ctx)
    for labels, preds in pairs:
        metric.update([arr(lbl) for lbl in labels],
                      [arr(p) for p in preds])
    return metric.get(), metric.get_name_value()


METRICS = {
    "accuracy": (lambda m: m.Accuracy(), [([CLASSES], [PROBS])] * 2),
    "accuracy_label_shape": (lambda m: m.Accuracy(),
                             [([CLASSES], [PROBS.argmax(1)])]),
    "top_k": (lambda m: m.TopKAccuracy(top_k=2), [([CLASSES], [PROBS])]),
    "f1_binary": (lambda m: m.F1(), [([BIN_LABEL], [BIN])] * 2),
    "f1_micro": (lambda m: m.F1(average="micro"),
                 [([BIN_LABEL[:6]], [BIN[:6]]), ([BIN_LABEL], [BIN])]),
    "mcc": (lambda m: m.MCC(), [([BIN_LABEL], [BIN])]),
    "mcc_micro": (lambda m: m.MCC(average="micro"),
                  [([BIN_LABEL[:6]], [BIN[:6]]), ([BIN_LABEL], [BIN])]),
    "perplexity": (lambda m: m.Perplexity(ignore_label=None),
                   [([CLASSES], [PROBS])] * 2),
    "perplexity_ignore_label": (lambda m: m.Perplexity(ignore_label=3),
                                [([PPL_LABEL], [PROBS])]),
    "mae": (lambda m: m.MAE(), [([REG_LABEL], [REG_PRED])] * 2),
    "mse": (lambda m: m.MSE(), [([REG_LABEL], [REG_PRED])]),
    "rmse": (lambda m: m.RMSE(), [([REG_LABEL], [REG_PRED])]),
    "cross_entropy": (lambda m: m.CrossEntropy(), [([CLASSES], [PROBS])]),
    "nll": (lambda m: m.NegativeLogLikelihood(), [([CLASSES], [PROBS])]),
    "pearson": (lambda m: m.PearsonCorrelation(),
                [([REG_LABEL[:, 0]], [REG_PRED[:, 0]])]),
    "loss": (lambda m: m.Loss(), [([], [REG_PRED])] * 2),
    "composite_create": (lambda m: m.create(["accuracy", "ce"]),
                         [([CLASSES], [PROBS])]),
    "create_by_name": (lambda m: m.create("top_k_acc", top_k=3),
                       [([CLASSES], [PROBS])]),
    "custom_np": (lambda m: m.np(lambda label, pred: float(
        np.abs(label - pred.argmax(1)).sum()), name="dist"),
                  [([CLASSES], [PROBS])] * 2),
    "create_callable": (lambda m: m.create(lambda label, pred: float(
        (pred.argmax(1) == label).mean())), [([CLASSES], [PROBS])]),
    "reset_is_nan": (lambda m: m.Accuracy(), []),
}


@pytest.mark.parametrize("name", sorted(METRICS))
def test_metrics_match_jax(name):
    make, pairs = METRICS[name]
    want = _updates(jmx, JCPU, make(jmx.metric), pairs)
    got = _updates(mx, CPU, make(mx.metric), pairs)
    (wn, wv), (gn, gv) = want[0], got[0]
    assert gn == wn
    np.testing.assert_allclose(np.asarray(gv, "f8"), np.asarray(wv, "f8"),
                               rtol=1e-6, equal_nan=True)
    assert [n for n, _ in got[1]] == [n for n, _ in want[1]]


def test_reset_local_and_str():
    for pkg, ctx in ((jmx, JCPU), (mx, CPU)):
        f1 = pkg.metric.F1(average="micro")
        label = pkg.nd.array([1, 0], ctx=ctx)
        pred = pkg.nd.array([[0.2, 0.8], [0.9, 0.1]], ctx=ctx)
        f1.update([label], [pred])
        f1.reset_local()
        f1.update([label], [pred])
        assert f1.num_inst == 2
        assert "f1" in str(f1)
    assert mx.metric.Accuracy().get_config() == \
        jmx.metric.Accuracy().get_config()


def test_metric_errors_match_jax():
    for pkg, err in ((jmx, jmx.MXNetError), (mx, mx.MXNetError)):
        with pytest.raises(err, match="not registered"):
            pkg.metric.create("no_such_metric")
        with pytest.raises(ValueError, match="does not match"):
            pkg.metric.check_label_shapes([1, 2], [1])


# -- learning-rate schedulers --------------------------------------------------------

SCHEDULERS = {
    "factor": lambda s: s.FactorScheduler(step=10, factor=0.5,
                                          stop_factor_lr=1e-3, base_lr=1.0),
    "factor_warmup": lambda s: s.FactorScheduler(
        step=7, factor=0.9, base_lr=0.5, warmup_steps=20,
        warmup_begin_lr=0.05),
    "multifactor": lambda s: s.MultiFactorScheduler(step=[5, 10, 150],
                                                    factor=0.1, base_lr=1.0),
    "multifactor_warmup_constant": lambda s: s.MultiFactorScheduler(
        step=[30, 60], factor=0.5, base_lr=0.2, warmup_steps=25,
        warmup_begin_lr=0.01, warmup_mode="constant"),
    "poly": lambda s: s.PolyScheduler(max_update=150, base_lr=0.3, pwr=2,
                                      final_lr=0.01),
    "poly_warmup": lambda s: s.PolyScheduler(max_update=180, base_lr=0.3,
                                             pwr=1, warmup_steps=40),
    "cosine": lambda s: s.CosineScheduler(max_update=170, base_lr=1.0,
                                          final_lr=0.05),
    "cosine_warmup": lambda s: s.CosineScheduler(
        max_update=100, base_lr=1.0, final_lr=0.1, warmup_steps=10,
        warmup_begin_lr=0.0),
}


@pytest.mark.parametrize("name", sorted(SCHEDULERS))
def test_scheduler_sequences_match_jax(name):
    want = SCHEDULERS[name](jmx.lr_scheduler)
    got = SCHEDULERS[name](mx.lr_scheduler)
    seq = [(got(t), want(t)) for t in range(1, 201)]
    for t, (g, w) in enumerate(seq, 1):
        assert g == pytest.approx(w, rel=1e-12), t
    assert len({g for g, _ in seq}) > 2


def test_scheduler_checks_match_jax():
    for pkg, err in ((jmx, jmx.MXNetError), (mx, mx.MXNetError)):
        with pytest.raises(err):
            pkg.lr_scheduler.LRScheduler(warmup_steps=-1)
        with pytest.raises(err):
            pkg.lr_scheduler.FactorScheduler(step=0)


@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_optimizer_learning_rate_follows_its_scheduler(opt):
    """``learning_rate`` is the scheduler's at the update count, the
    optimizer's ``learning_rate`` its base, and ``set_learning_rate``
    refuses while a scheduler is set (as the JAX package)."""
    rates = {}
    for pkg in (jmx, mx):
        sched = pkg.lr_scheduler.FactorScheduler(step=2, factor=0.5)
        o = pkg.optimizer.create(opt, learning_rate=0.4, lr_scheduler=sched)
        assert sched.base_lr == 0.4
        seq = []
        for i in range(6):
            o._update_count(0)
            seq.append(o.learning_rate)
        rates[pkg] = seq
        with pytest.raises(pkg.MXNetError, match="LRScheduler"):
            o.set_learning_rate(0.1)
    assert rates[mx] == rates[jmx]
    assert rates[mx][0] == 0.4 and rates[mx][-1] < 0.4
