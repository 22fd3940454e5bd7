"""Start a job of N worker processes on this machine (parity: the
reference's ``tools/launch.py --launcher local``).

    python -m mxnet_tpu_torch.launch -n 2 python train.py --kv-store dist_sync

Each worker gets the rendezvous that ``torch.distributed`` reads,
``MASTER_ADDR`` (127.0.0.1), ``MASTER_PORT`` (a free port), ``RANK``,
``WORLD_SIZE`` and ``LOCAL_RANK`` (its card: ``gpu(LOCAL_RANK)`` is its
default context), plus the reference's ``MXTPU_DIST_*`` and ``DMLC_*``
names.  A worker joins the group when it makes a ``dist_*`` kvstore or a
mesh of more than one rank (``kvstore.init_distributed``).  Every line a
worker prints comes out prefixed ``[worker N]``.  When a worker fails,
the others are stopped (so none waits forever on a dead peer) and the
launcher exits 1 naming each failed worker's code.  ``--launcher
ssh``/``mpi``/``yarn`` are not provided, as in the reference.
"""
from __future__ import annotations

import argparse
import os
import signal
import socket
import subprocess
import sys
import threading
import time

__all__ = ["launch_local", "main"]

#: seconds the other workers get to end after one failed
GRACE = 5.0


def _free_port():
    s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _stream(proc, rank):
    for line in iter(proc.stdout.readline, b""):
        sys.stdout.write(f"[worker {rank}] {line.decode(errors='replace')}")
        sys.stdout.flush()


def _worker_env(rank, n, port):
    env = dict(os.environ)
    coord = f"127.0.0.1:{port}"
    env.update({
        "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
        "RANK": str(rank), "WORLD_SIZE": str(n), "LOCAL_RANK": str(rank),
        "LOCAL_WORLD_SIZE": str(n),
        "MXTPU_DIST_COORDINATOR": coord,
        "MXTPU_DIST_NUM_PROCS": str(n), "MXTPU_DIST_PROC_ID": str(rank),
        "DMLC_ROLE": "worker", "DMLC_NUM_WORKER": str(n),
        "DMLC_NUM_SERVER": "0", "DMLC_PS_ROOT_URI": "127.0.0.1",
        "DMLC_PS_ROOT_PORT": str(port),
    })
    return env


def launch_local(num_workers, command):
    """Run ``num_workers`` copies of ``command``; returns their exit
    codes.  After the first failure the others have ``GRACE`` seconds to
    end (a collective with a dead peer raises), then get SIGTERM, and
    SIGKILL ``GRACE`` seconds later."""
    port = _free_port()
    procs, threads = [], []
    for rank in range(num_workers):
        p = subprocess.Popen(command,
                             env=_worker_env(rank, num_workers, port),
                             stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT)
        t = threading.Thread(target=_stream, args=(p, rank), daemon=True)
        t.start()
        procs.append(p)
        threads.append(t)
    codes = [None] * num_workers
    failed_at = None
    termed = False
    try:
        while any(c is None for c in codes):
            for i, p in enumerate(procs):
                if codes[i] is None:
                    codes[i] = p.poll()
            if failed_at is None and any(c not in (None, 0)
                                         for c in codes):
                failed_at = time.monotonic()
            if failed_at is not None:
                # the others get GRACE s to see the failure themselves
                waited = time.monotonic() - failed_at
                for i, p in enumerate(procs):
                    if codes[i] is not None:
                        continue
                    if waited > 2 * GRACE:
                        p.kill()
                    elif waited > GRACE and not termed:
                        p.send_signal(signal.SIGTERM)
                termed = termed or waited > GRACE
            time.sleep(0.05)
    except KeyboardInterrupt:
        for p in procs:
            p.kill()
        raise
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for t in threads:
        t.join(timeout=5)
    return codes


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m mxnet_tpu_torch.launch",
        description="Launch a distributed job of local worker processes.")
    ap.add_argument("-n", "--num-workers", type=int, required=True,
                    help="number of worker processes")
    ap.add_argument("-s", "--num-servers", type=int, default=0,
                    help="accepted as in the reference; there is no "
                         "server role (ignored)")
    ap.add_argument("--launcher", default="local",
                    choices=["local", "ssh", "mpi", "yarn"],
                    help="only 'local' is provided")
    ap.add_argument("command", nargs=argparse.REMAINDER)
    args = ap.parse_args(argv)
    if args.launcher != "local":
        ap.error(f"--launcher {args.launcher} is a capability gap of the "
                 "port: only --launcher local (workers on this machine) "
                 "is provided")
    if not args.command:
        ap.error("no command given")
    if args.num_workers < 1:
        ap.error("-n must be at least 1")
    if args.num_servers:
        print("launch: note: -s/--num-servers ignored (no server role)",
              file=sys.stderr)
    codes = launch_local(args.num_workers, args.command)
    bad = [(i, c) for i, c in enumerate(codes) if c != 0]
    for i, c in bad:
        print(f"launch: worker {i} exited with {c}", file=sys.stderr)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
