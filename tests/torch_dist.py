"""Run the port in W processes over a gloo group on the CPU.

``spawn(n, source, inputs, tmp_path)`` writes ``source`` (which defines
``main(rank, world, inputs)``, returning a picklable result) to a file
and starts ``n`` Python processes on it, each inside ``with mx.cpu():``
with a process group of ``n`` ranks over a file store under
``tmp_path`` (so groups that tests start at the same time under
pytest-xdist never meet), one torch thread each.  It waits at most
``timeout`` seconds, kills whatever still runs, and returns every rank's
result; a rank that failed fails the test with its output.
"""
import os
import pickle
import signal
import subprocess
import sys
import time

import torch_threads

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_RUNNER = r"""
import os, pickle, runpy, sys
import torch
torch.set_num_threads(1)
import mxnet_tpu_torch as mx
rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
with open(sys.argv[2], "rb") as f:
    inputs = pickle.load(f)
with mx.cpu():
    assert mx.kvstore.init_distributed()
    out = runpy.run_path(sys.argv[1])["main"](rank, world, inputs)
with open(sys.argv[3] % rank, "wb") as f:
    pickle.dump(out, f)
import torch.distributed as dist
dist.barrier()
dist.destroy_process_group()
"""


def run_group(cmd, timeout=120, **kwargs):
    """``subprocess.run(cmd)`` in a session of its own: past ``timeout``
    the whole session (a launcher and its workers) is killed.  Returns
    the CompletedProcess; a timeout fails the test."""
    p = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                         text=True, start_new_session=True, **kwargs)
    try:
        out, err = p.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(p.pid, signal.SIGKILL)
        p.communicate()
        raise AssertionError(f"{cmd[:4]} ran past {timeout} s")
    finally:
        try:
            os.killpg(p.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
    return subprocess.CompletedProcess(cmd, p.returncode, out, err)


def spawn(n, source, inputs, tmp_path, timeout=120, env=None):
    tmp = str(tmp_path)
    script = os.path.join(tmp, "dist_case.py")
    runner = os.path.join(tmp, "dist_runner.py")
    data = os.path.join(tmp, "dist_inputs.pkl")
    out = os.path.join(tmp, "dist_out_%d.pkl")
    store = os.path.join(tmp, "dist_store")
    with open(script, "w") as f:
        f.write(source)
    with open(runner, "w") as f:
        f.write(_RUNNER)
    with open(data, "wb") as f:
        pickle.dump(inputs, f)
    procs = []
    try:
        for r in range(n):
            e = torch_threads.child_env(
                PYTHONPATH=REPO + os.pathsep + os.environ.get(
                    "PYTHONPATH", ""),
                RANK=str(r), WORLD_SIZE=str(n), LOCAL_RANK=str(r),
                MXTPU_DIST_INIT="file://" + store,
                **(env or {}))
            e["OMP_NUM_THREADS"] = "1"
            e.pop("MASTER_ADDR", None)
            procs.append(subprocess.Popen(
                [sys.executable, runner, script, data, out], env=e,
                cwd=tmp, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
        deadline = time.monotonic() + timeout
        logs = []
        for p in procs:
            left = max(1.0, deadline - time.monotonic())
            try:
                logs.append(p.communicate(timeout=left)[0])
            except subprocess.TimeoutExpired:
                raise AssertionError(
                    f"a group of {n} ranks ran past {timeout} s")
        for r, (p, log) in enumerate(zip(procs, logs)):
            assert p.returncode == 0, f"rank {r} failed:\n{log[-4000:]}"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    results = []
    for r in range(n):
        with open(out % r, "rb") as f:
            results.append(pickle.load(f))
    return results
