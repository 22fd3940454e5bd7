"""Faster R-CNN at ``chip_smoke.py``'s rcnn widths (base 64, anchors
32-512, 300 proposals, 7 x 7 RoIs, 20 classes) in both packages on the
CPU, float32, hybridized: the same weights (the JAX net's, carried by
name) and the rcnn phase's batch (``chip_smoke._boxes_batch``, its seed,
batch 4, up to 8 squares an image) at a smaller square side, trained by
Adam at each learning rate.  Prints each package's losses a step: whether
the reference's loss also leaves its fixed batch at a rate where the
port's does.

    JAX_PLATFORMS=cpu python tests/torch_rcnn_lr.py --size 200 \\
        --steps 25 --lrs 1e-3,2e-5

Prints one line a package and rate, then the JSON of every reading.
"""
import argparse
import json
import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.dirname(HERE))

import numpy as np  # noqa: E402


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--size", type=int, default=200)
    ap.add_argument("--steps", type=int, default=25)
    ap.add_argument("--lrs", default="1e-3,2e-5")
    args = ap.parse_args()

    import mxnet_tpu as jmx
    from mxnet_tpu.models import rcnn as jrcnn
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.models import rcnn
    import chip_smoke
    from torch_zoo import CPU, pair, train_steps

    cfg = chip_smoke.RCNN
    x, y = chip_smoke._boxes_batch(np.random.RandomState(cfg["seed"]),
                                   cfg["batch_size"], args.size, 8,
                                   cfg["classes"])
    widths = dict(image_size=args.size, base_channels=cfg["base_channels"],
                  anchor_sizes=cfg["anchor_sizes"],
                  num_proposals=cfg["proposals"], roi_size=cfg["roi"],
                  prefix="rcnn_")

    def loss_of(zoo):
        return lambda net, a, b: zoo.FasterRCNNLoss(net)(net(a), b)

    out = {"size": args.size, "steps": args.steps,
           "batch_size": cfg["batch_size"], "runs": {}}
    for lr in (float(v) for v in args.lrs.split(",")):
        jnet, tnet = pair(lambda: jrcnn.FasterRCNN(cfg["classes"], **widths),
                          lambda: rcnn.FasterRCNN(cfg["classes"], **widths),
                          x)
        jnet.hybridize()
        tnet.hybridize()
        for pkg, zoo, net, ctx, who in ((jmx, jrcnn, jnet, jmx.cpu(), "jax"),
                                        (mx, rcnn, tnet, CPU, "port")):
            t0 = time.perf_counter()
            losses = train_steps(pkg, net, [(x, y)] * args.steps,
                                 loss_of(zoo), lr, ctx)
            out["runs"][f"{who}@{lr:g}"] = losses
            print(f"{who} lr {lr:g} ({time.perf_counter() - t0:.1f} s): "
                  + " ".join(f"{v:.4g}" for v in losses), flush=True)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
