"""The 2bit step under dropout in both packages (ROADMAP R12, once F16):
the JAX package's ``DataParallelTrainer(compression={"type": "2bit",
...})`` on a mesh of one device and the port's on a gloo group of one
rank, from the same weights on the same batch, at ``chip_smoke.py``'s dp
settings (Adam 1e-4, threshold 1e-3, dropout 0.1).  The dropout streams differ, so each
seed's predict-mode loss on the batch is read before and after the steps,
and the two changes are compared.  One device and one rank: the JAX
package's fused step cannot draw dropout on a mesh of two devices (its key
lies on one device; ROADMAP R13).

    JAX_PLATFORMS=cpu python tests/torch_twobit_dropout.py \\
        --model bert_small --layers 2 --vocab 200 --batch 8
    JAX_PLATFORMS=cpu python tests/torch_twobit_dropout.py \\
        --model bert_base --layers 12 --vocab 30522 --batch 8

Prints one line a seed and the JSON of every reading.
"""
import argparse
import json
import os
import sys
import tempfile
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.dirname(HERE))

import numpy as np  # noqa: E402

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
    mx.random.seed(inp["seed"])
    inner = models.BERTForPretrain(getattr(models, inp["model"])(
        vocab_size=inp["vocab"], max_length=inp["seq"],
        dropout=inp["dropout"], num_layers=inp["layers"]))
    inner.initialize(mx.init.Xavier(), ctx=mx.cpu())
    models.load_jax_bert_params(inner, inp["w0"])
    model = FullLen(inner)
    sce = SoftmaxCrossEntropyLoss()
    m = inp["m"]

    def loss_fn(outs, label):
        mlm, nsp = outs
        return sce(mlm, label[:, :m].reshape((-1,))).mean() + \
            sce(nsp, label[:, m]).mean()
    data = tuple(nd.array(inp[k]) for k in ("tokens", "types", "positions"))
    label = nd.array(inp["label"])

    def predict():
        return float(loss_fn(model(*data), label).asnumpy())
    before = predict()
    dpt = parallel.DataParallelTrainer(
        model, loss_fn, "adam", {"learning_rate": inp["lr"]},
        mesh=parallel.make_mesh({"dp": 1}), fuse_step=True,
        compression=inp["comp"])
    for _ in range(inp["steps"]):
        dpt.step(data, label)
    return before, predict()
'''


def _batch(vocab, b, seq, m):
    rng = np.random.RandomState(0)
    return dict(
        tokens=rng.randint(0, vocab, (b, seq)).astype("f4"),
        types=rng.randint(0, 2, (b, seq)).astype("f4"),
        positions=rng.randint(0, seq, (b, m)).astype("f4"),
        label=np.concatenate([rng.randint(0, vocab, (b, m)),
                              rng.randint(0, 2, (b, 1))], 1).astype("f4"))


def _jax(args, x, comp, seed):
    """The JAX package's readings (before, after) and its initial
    weights."""
    import mxnet_tpu as jmx
    from mxnet_tpu import models as jmodels
    from mxnet_tpu import nd as jnd
    from mxnet_tpu import parallel as jpar
    from mxnet_tpu.gluon.block import HybridBlock
    from mxnet_tpu.gluon.loss import SoftmaxCrossEntropyLoss

    class FullLen(HybridBlock):
        def __init__(self, mod, **kw):
            super().__init__(**kw)
            with self.name_scope():
                self.mod = mod

        def hybrid_forward(self, F, tokens, types, positions):
            return self.mod(tokens, types, None, positions)

    jmx.random.seed(seed)
    inner = jmodels.BERTForPretrain(getattr(jmodels, args.model)(
        vocab_size=args.vocab, max_length=args.seq, dropout=args.dropout,
        num_layers=args.layers))
    inner.initialize(jmx.init.Xavier(), ctx=jmx.cpu(0))
    data = tuple(jnd.array(x[k]) for k in ("tokens", "types", "positions"))
    inner(data[0], data[1], None, data[2])
    w0 = {k: p.data().asnumpy() for k, p in inner.collect_params().items()}
    sce = SoftmaxCrossEntropyLoss()

    def loss_fn(outs, label):
        mlm, nsp = outs
        return sce(mlm, label[:, :args.m].reshape((-1,))).mean() + \
            sce(nsp, label[:, args.m]).mean()
    net = FullLen(inner)
    label = jnd.array(x["label"])

    def predict():
        return float(loss_fn(net(*data), label).asnumpy())
    before = predict()
    dpt = jpar.DataParallelTrainer(net, loss_fn, "adam",
                                   {"learning_rate": args.lr},
                                   mesh=jpar.make_mesh({"dp": 1}),
                                   fuse_step=True, compression=comp)
    for _ in range(args.steps):
        dpt.step(data, label)
    return (before, predict()), w0


def main():
    import torch_dist
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="bert_small")
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--vocab", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--m", type=int, default=4)
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--threshold", type=float, default=1e-3)
    ap.add_argument("--dropout", type=float, default=0.1)
    ap.add_argument("--dense", action="store_true",
                    help="no compression (the control)")
    ap.add_argument("--seeds", default="0,1,2")
    args = ap.parse_args()
    comp = None if args.dense else {"type": "2bit",
                                    "threshold": args.threshold}
    x = _batch(args.vocab, args.batch, args.seq, args.m)
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.time()
        (jb, ja), w0 = _jax(args, x, comp, seed)
        inp = dict(x, w0=w0, model=args.model, vocab=args.vocab,
                   seq=args.seq, m=args.m, layers=args.layers,
                   dropout=args.dropout, lr=args.lr, comp=comp,
                   steps=args.steps, seed=seed)
        with tempfile.TemporaryDirectory() as tmp:
            pb, pa = torch_dist.spawn(1, _WORKER, inp, tmp,
                                      timeout=3600)[0]
        rows.append({"seed": seed, "jax": [jb, ja], "port": [pb, pa]})
        print(f"seed {seed}: JAX {jb:.4f} -> {ja:.4f} ({ja - jb:+.4f}), "
              f"port {pb:.4f} -> {pa:.4f} ({pa - pb:+.4f}) "
              f"[{time.time() - t0:.0f} s]", flush=True)
    print(json.dumps({"args": vars(args), "rows": rows}))


if __name__ == "__main__":
    main()
