"""The port's launcher (``python -m mxnet_tpu_torch.launch``) and its
``dist_sync`` kvstore across processes, on the CPU over gloo: the
launcher cases of ``tests/test_dist_local.py``, rank 0's weights
broadcast at ``init``, the cross-process sum with and without int8
compression, and ``SyncBatchNorm`` under a ``dist_sync``
``gluon.Trainer`` against the JAX package's dp=2 mesh, which normalises
over the global batch."""
import os
import sys

import numpy as np
import pytest

import torch_dist
import torch_threads

REPO = torch_dist.REPO


def _launch(n, args, tmp_path, timeout=120, env=None):
    e = torch_threads.child_env(
        PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
        **(env or {}))
    e["OMP_NUM_THREADS"] = "1"
    return torch_dist.run_group(
        [sys.executable, "-m", "mxnet_tpu_torch.launch", "-n", str(n),
         *args], timeout=timeout, env=e, cwd=str(tmp_path))


def _script(tmp_path, body):
    path = tmp_path / "worker.py"
    path.write_text("import os, sys\nimport numpy as np\n"
                    "import mxnet_tpu_torch as mx\n"
                    "from mxnet_tpu_torch import nd\n"
                    "with mx.cpu():\n" +
                    "".join("    " + line + "\n"
                            for line in body.strip().splitlines()))
    return str(path)


def test_launch_local_two_workers(tmp_path):
    worker = _script(tmp_path, """
kv = mx.kv.create("dist_sync")
env = [os.environ[k] for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK",
       "MASTER_ADDR", "MASTER_PORT", "MXTPU_DIST_PROC_ID",
       "DMLC_NUM_WORKER")]
assert env[0] == env[2] == env[5] and env[1] == env[6] == "2", env
print(f"WORKER_OK rank={kv.rank}/{kv.num_workers}")
""")
    res = _launch(2, [sys.executable, worker], tmp_path)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-2000:]
    assert "[worker 0] WORKER_OK rank=0/2" in res.stdout
    assert "[worker 1] WORKER_OK rank=1/2" in res.stdout


def test_launcher_rejects_remote_modes(tmp_path):
    for mode in ("ssh", "mpi", "yarn"):
        res = _launch(2, ["--launcher", mode, "echo", "hi"], tmp_path)
        assert res.returncode != 0
        assert "capability gap" in res.stderr


def test_launcher_propagates_worker_failure(tmp_path):
    res = _launch(2, [sys.executable, "-c", "import sys; sys.exit(3)"],
                  tmp_path)
    assert res.returncode == 1
    assert "exited with 3" in res.stderr


def test_worker_crash_is_detected_not_hung(tmp_path):
    """Rank 1 dies after round 1: the launcher reports its code, and rank
    0's next collective raises instead of waiting for ever."""
    worker = _script(tmp_path, """
kv = mx.kv.create("dist_sync")
kv.init("x", nd.ones((4,)))
out = nd.zeros((4,))
kv.push("x", nd.ones((4,)))
kv.pull("x", out=out)
print("ROUND1_OK", flush=True)
if kv.rank == 1:
    os._exit(17)
try:
    kv.push("x", nd.ones((4,)))
    kv.pull("x", out=out)
    print("SURVIVOR_NO_ERROR", flush=True)
except Exception as e:
    print("SURVIVOR_DETECTED_FAILURE", type(e).__name__, flush=True)
    sys.exit(1)
""")
    res = _launch(2, [sys.executable, worker], tmp_path)
    assert res.returncode != 0
    assert "exited with 17" in res.stderr
    assert res.stdout.count("ROUND1_OK") == 2
    assert "SURVIVOR_DETECTED_FAILURE" in res.stdout, res.stdout[-2000:]
    assert "SURVIVOR_NO_ERROR" not in res.stdout


_KV_WORKER = r'''
import numpy as np
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import nd


def main(rank, world, inp):
    kv = mx.kv.create("dist_sync")
    assert (kv.rank, kv.num_workers, kv.is_distributed) == (rank, world,
                                                            True)
    out = {}
    # every rank inits with its own value: rank 0's is broadcast
    kv.init("w", nd.array(inp["w0"][rank]))
    w = nd.zeros((6,))
    kv.pull("w", out=w)
    out["init"] = w.asnumpy()
    kv.push("w", [nd.array(v) for v in inp["push"][rank]])
    kv.pull("w", out=w)
    out["sum"] = w.asnumpy()
    kv2 = mx.kv.create("dist_tpu_sync")
    kv2.set_gradient_compression({"type": "int8"})
    kv2.init("g", nd.zeros((6,)))
    out["int8"] = []
    for step in range(2):
        kv2.push("g", nd.array(inp["grads"][step][rank]))
        kv2.pull("g", out=w)
        out["int8"].append(w.asnumpy())
    kv._barrier()
    return out
'''


def test_dist_sync_kvstore_over_two_processes(tmp_path):
    rng = np.random.RandomState(5)
    inp = {"w0": rng.randn(2, 6).astype("f4"),
           "push": rng.randn(2, 2, 6).astype("f4"),
           "grads": rng.randn(2, 2, 6).astype("f4")}
    out = torch_dist.spawn(2, _KV_WORKER, inp, tmp_path)
    # the int8 codec of the JAX package, run on each rank's push with
    # its residual, then the decoded sum
    res = np.zeros((2, 6), "f4")
    want = []
    for step in range(2):
        total = np.zeros(6, "f4")
        for r in range(2):
            g = inp["grads"][step][r] + res[r]
            scale = np.float32(max(np.abs(g).max() / np.float32(127),
                                   1e-20))
            codes = np.clip(np.round(g / scale), -127, 127)
            res[r] = g - codes.astype("f4") * scale
            total = total + codes.astype("f4") * scale
        want.append(total)
    for r in range(2):
        np.testing.assert_array_equal(out[r]["init"], inp["w0"][0])
        np.testing.assert_allclose(out[r]["sum"],
                                   inp["push"].sum(axis=(0, 1)),
                                   rtol=1e-6, atol=1e-6)
        for got, w in zip(out[r]["int8"], want):
            np.testing.assert_allclose(got, w, rtol=1e-6, atol=1e-6)


_SYNCBN_WORKER = r'''
import numpy as np
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, gluon, nd
from mxnet_tpu_torch.gluon.contrib.nn import SyncBatchNorm


def main(rank, world, inp):
    net = gluon.nn.HybridSequential(prefix="net_")
    with net.name_scope():
        net.add(gluon.nn.Dense(8, in_units=4), SyncBatchNorm(in_channels=8),
                gluon.nn.Dense(2, in_units=8))
    net.initialize(ctx=mx.cpu())
    for name, value in inp["w0"].items():
        net.collect_params()[name].set_data(value)
    tr = gluon.Trainer(net.collect_params(), "sgd", {"learning_rate": 0.1},
                       kvstore="dist_sync")
    loss_fn = gluon.loss.L2Loss()
    b = inp["x"].shape[1] // world
    for x, y in zip(inp["x"], inp["y"]):
        with autograd.record():
            loss = loss_fn(net(nd.array(x[rank * b:(rank + 1) * b])),
                           nd.array(y[rank * b:(rank + 1) * b]))
        loss.backward()
        tr.step(x.shape[0])
    return {k: p.data().asnumpy() for k, p in net.collect_params().items()}
'''


def test_sync_batchnorm_under_a_dist_sync_trainer(tmp_path):
    """Two processes, each with half of every batch, train what the JAX
    package's dp=2 ``DataParallelTrainer`` trains on the whole batch:
    SyncBatchNorm's statistics (and so its running statistics) are the
    global batch's."""
    import mxnet_tpu as jmx
    from mxnet_tpu import parallel as jpar
    from mxnet_tpu.gluon import nn as jnn
    from mxnet_tpu.gluon.contrib.nn import SyncBatchNorm as JSyncBN
    from mxnet_tpu.gluon.loss import L2Loss
    rng = np.random.RandomState(2)
    x = rng.randn(3, 8, 4).astype("f4") * 2 + 1
    y = rng.randn(3, 8, 2).astype("f4")
    jmx.random.seed(4)
    jnet = jnn.HybridSequential(prefix="net_")
    with jnet.name_scope():
        jnet.add(jnn.Dense(8, in_units=4), JSyncBN(in_channels=8),
                 jnn.Dense(2, in_units=8))
    jnet.initialize(jmx.init.Xavier(), ctx=jmx.cpu(0))
    w0 = {k: p.data().asnumpy() for k, p in jnet.collect_params().items()}
    dpt = jpar.DataParallelTrainer(jnet, L2Loss(), "sgd",
                                   {"learning_rate": 0.1},
                                   mesh=jpar.make_mesh({"dp": 2}))
    for xb, yb in zip(x, y):
        dpt.step(jmx.nd.array(xb), jmx.nd.array(yb))
    want = {k: p.data().asnumpy() for k, p in jnet.collect_params().items()}
    out = torch_dist.spawn(2, _SYNCBN_WORKER, {"w0": w0, "x": x, "y": y},
                           tmp_path)
    for r in range(2):
        assert sorted(out[r]) == sorted(want)
        for k, w in want.items():
            np.testing.assert_allclose(out[r][k], w, rtol=1e-5, atol=1e-5,
                                       err_msg=f"rank {r} {k}")
