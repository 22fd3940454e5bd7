"""The 2bit exchange under Adam on BERT: the port at dp=2 (a gloo group
of two ranks) against the JAX package's ``make_mesh({"dp": 2})`` (two
virtual CPU devices), for ``STEPS`` steps of ``bert_small`` (2 layers,
vocab 200, f32, dropout 0) from the same weights on the same global
batch, at the 2bit threshold and learning rate of ``chip_smoke.py``'s
``dp`` phase.  Each rank's residuals are carried across every step, so
a fault in them shows as a trajectory that leaves the reference's.  The
losses agree step by step within rtol 1e-4 and atol 1e-5 (the float32
tolerance of the other data-parallel tests), and the loss falls on both
sides: without gradient noise (dropout 0, one batch) this optimizer
trains this model.
"""
import numpy as np

import mxnet_tpu as jmx
from mxnet_tpu import models as jmodels
from mxnet_tpu import nd as jnd
from mxnet_tpu import parallel as jpar
from mxnet_tpu.gluon.block import HybridBlock as JHybridBlock
from mxnet_tpu.gluon.loss import SoftmaxCrossEntropyLoss as JSCE

import torch_dist

V, S, M, B = 200, 128, 4, 4
STEPS = 25
LR = 1e-4
THRESHOLD = 1e-3
COMP = {"type": "2bit", "threshold": THRESHOLD}

_WORKER = r'''
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import models, nd, parallel
from mxnet_tpu_torch.gluon import HybridBlock
from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss


class FullLen(HybridBlock):
    def __init__(self, mod, **kw):
        super().__init__(**kw)
        with self.name_scope():
            self.mod = mod

    def hybrid_forward(self, F, tokens, types, positions):
        return self.mod(tokens, types, None, positions)


def main(rank, world, inp):
    inner = models.BERTForPretrain(models.bert_small(
        vocab_size=inp["V"], max_length=inp["S"], dropout=0.0,
        num_layers=2))
    inner.initialize(mx.init.Xavier(), ctx=mx.cpu())
    models.load_jax_bert_params(inner, inp["w0"])
    model = FullLen(inner)
    sce = SoftmaxCrossEntropyLoss()
    m = inp["M"]

    def loss_fn(outs, label):
        mlm, nsp = outs
        return sce(mlm, label[:, :m].reshape((-1,))).mean() + \
            sce(nsp, label[:, m]).mean()
    dpt = parallel.DataParallelTrainer(
        model, loss_fn, "adam", {"learning_rate": inp["lr"]},
        mesh=parallel.make_mesh({"dp": 2}), fuse_step=True,
        compression=inp["comp"])
    data = tuple(nd.array(inp[k]) for k in ("tokens", "types", "positions"))
    label = nd.array(inp["label"])
    return [float(dpt.step(data, label).asnumpy())
            for _ in range(inp["steps"])]
'''


class _JFullLen(JHybridBlock):
    def __init__(self, mod, **kw):
        super().__init__(**kw)
        with self.name_scope():
            self.mod = mod

    def hybrid_forward(self, F, tokens, types, positions):
        return self.mod(tokens, types, None, positions)


def _batch():
    rng = np.random.RandomState(0)
    return dict(
        tokens=rng.randint(0, V, (B, S)).astype("f4"),
        types=rng.randint(0, 2, (B, S)).astype("f4"),
        positions=rng.randint(0, S, (B, M)).astype("f4"),
        label=np.concatenate([rng.randint(0, V, (B, M)),
                              rng.randint(0, 2, (B, 1))], 1).astype("f4"))


def _jax_losses(x):
    """The JAX package's trajectory, and its initial weights."""
    jmx.random.seed(0)
    inner = jmodels.BERTForPretrain(jmodels.bert_small(
        vocab_size=V, max_length=S, dropout=0.0, num_layers=2))
    inner.initialize(jmx.init.Xavier(), ctx=jmx.cpu(0))
    data = tuple(jnd.array(x[k]) for k in ("tokens", "types", "positions"))
    inner(data[0], data[1], None, data[2])
    w0 = {k: p.data().asnumpy() for k, p in inner.collect_params().items()}
    sce = JSCE()

    def loss_fn(outs, label):
        mlm, nsp = outs
        return sce(mlm, label[:, :M].reshape((-1,))).mean() + \
            sce(nsp, label[:, M]).mean()
    dpt = jpar.DataParallelTrainer(
        _JFullLen(inner), loss_fn, "adam", {"learning_rate": LR},
        mesh=jpar.make_mesh({"dp": 2}), fuse_step=True, compression=COMP)
    label = jnd.array(x["label"])
    losses = [float(dpt.step(data, label).asnumpy()) for _ in range(STEPS)]
    return losses, w0


def test_twobit_adam_bert_trajectory_matches_jax_dp2(tmp_path):
    x = _batch()
    want, w0 = _jax_losses(x)
    inp = dict(x, w0=w0, V=V, S=S, M=M, lr=LR, comp=COMP, steps=STEPS)
    out = torch_dist.spawn(2, _WORKER, inp, tmp_path)
    for r in range(2):
        np.testing.assert_allclose(out[r], want, rtol=1e-4, atol=1e-5,
                                   err_msg=f"rank {r}")
    print("2bit Adam bert_small dp=2 losses, JAX:",
          " ".join(f"{v:.6f}" for v in want))
    print("port rank 0:", " ".join(f"{v:.6f}" for v in out[0]))
    assert want[-1] < want[0] and out[0][-1] < out[0][0]


_DROPOUT_WORKER = r'''
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import models, nd, parallel
from mxnet_tpu_torch.gluon import HybridBlock
from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss


class FullLen(HybridBlock):
    def __init__(self, mod, **kw):
        super().__init__(**kw)
        with self.name_scope():
            self.mod = mod

    def hybrid_forward(self, F, tokens, types, positions):
        return self.mod(tokens, types, None, positions)


def main(rank, world, inp):
    mx.random.seed(0)
    inner = models.BERTForPretrain(models.bert_small(
        vocab_size=inp["V"], max_length=inp["S"], dropout=0.1,
        num_layers=2))
    inner.initialize(mx.init.Xavier(), ctx=mx.cpu())
    models.load_jax_bert_params(inner, inp["w0"])
    model = FullLen(inner)
    sce = SoftmaxCrossEntropyLoss()
    m = inp["M"]

    def loss_fn(outs, label):
        mlm, nsp = outs
        return sce(mlm, label[:, :m].reshape((-1,))).mean() + \
            sce(nsp, label[:, m]).mean()
    data = tuple(nd.array(inp[k]) for k in ("tokens", "types", "positions"))
    label = nd.array(inp["label"])
    before = float(loss_fn(model(*data), label).asnumpy())
    dpt = parallel.DataParallelTrainer(
        model, loss_fn, "adam", {"learning_rate": inp["lr"]},
        mesh=parallel.make_mesh({"dp": 1}), fuse_step=True,
        compression=inp["comp"])
    for _ in range(inp["steps"]):
        dpt.step(data, label)
    return before, float(loss_fn(model(*data), label).asnumpy())
'''


def test_twobit_adam_under_dropout_moves_the_loss_as_jax(tmp_path):
    """ROADMAP R12 (once F16) at a size that runs in seconds: bert_small
    (2 layers, vocab 200) at dropout 0.1, 2bit Adam at chip_smoke's dp
    threshold and rate, 20 steps at dp = 1 (the JAX package's fused step
    cannot draw dropout on a mesh of two devices, R13) in a launched job of
    one rank.  The dropout streams differ, so the predict-mode loss on the
    batch is compared by its change: both fall, the port's change within
    a factor of 2 of the JAX package's (at batch 8, over three seeds each
    of bert_small and bert_base, the two packages' changes lay within a
    factor of 1.6: tests/torch_twobit_dropout.py)."""
    x = _batch()
    jmx.random.seed(0)
    inner = jmodels.BERTForPretrain(jmodels.bert_small(
        vocab_size=V, max_length=S, dropout=0.1, num_layers=2))
    inner.initialize(jmx.init.Xavier(), ctx=jmx.cpu(0))
    data = tuple(jnd.array(x[k]) for k in ("tokens", "types", "positions"))
    inner(data[0], data[1], None, data[2])
    w0 = {k: p.data().asnumpy() for k, p in inner.collect_params().items()}
    sce = JSCE()

    def loss_fn(outs, label):
        mlm, nsp = outs
        return sce(mlm, label[:, :M].reshape((-1,))).mean() + \
            sce(nsp, label[:, M]).mean()
    net = _JFullLen(inner)
    label = jnd.array(x["label"])
    j_before = float(loss_fn(net(*data), label).asnumpy())
    dpt = jpar.DataParallelTrainer(net, loss_fn, "adam", {"learning_rate": LR},
                                   mesh=jpar.make_mesh({"dp": 1}),
                                   fuse_step=True, compression=COMP)
    for _ in range(20):
        dpt.step(data, label)
    j_after = float(loss_fn(net(*data), label).asnumpy())
    inp = dict(x, w0=w0, V=V, S=S, M=M, lr=LR, comp=COMP, steps=20)
    p_before, p_after = torch_dist.spawn(1, _DROPOUT_WORKER, inp,
                                         tmp_path)[0]
    np.testing.assert_allclose(p_before, j_before, rtol=1e-5)
    j_change, p_change = j_after - j_before, p_after - p_before
    print(f"2bit Adam, dropout 0.1, 20 steps: JAX {j_before:.4f} -> "
          f"{j_after:.4f}, port {p_before:.4f} -> {p_after:.4f}")
    assert j_change < 0 and p_change < 0
    assert 0.5 <= p_change / j_change <= 2.0, (j_change, p_change)
