"""The JAX package's example scripts run through the port on the CPU.

Each script is copied with ``mxnet_tpu`` renamed ``mxnet_tpu_torch`` and
run in a child process inside ``with mx.cpu():`` (the port's entry
points default to the card), with the repository on ``PYTHONPATH``.
The arguments and the asserted output are ``tests/test_examples.py``'s
for the same script (``image_classification`` also with a second zoo
model, ``mobilenetv2_0.25``, under the resnet18 case's arguments; a
case ``<script>:<model>``).  All sixteen of ``example/`` run here:
``distributed_training`` and ``llama_spmd_finetune`` in several workers
through ``python -m mxnet_tpu_torch.launch``, the others in one process.
"""
import os
import subprocess
import sys

import pytest

import torch_dist
import torch_threads

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

RUNNER = """\
import runpy, sys
import mxnet_tpu_torch as mx
path = sys.argv[1]
sys.argv = sys.argv[1:]
with mx.cpu():
    runpy.run_path(path, run_name="__main__")
"""

# script -> (arguments, a line the run prints)
EXAMPLES = {
    "dcgan": (["--steps", "6", "--batch-size", "8"], "images/sec"),
    "recommender_mf": (["--steps", "60", "--batch-size", "256"],
                       "held-out RMSE="),
    "llama_generate": (["--steps", "60", "--new-tokens", "4"],
                       "tokens/sec decode"),
    "forecasting_deepar": (["--steps", "20", "--batch-size", "16",
                            "--num-samples", "20"], "coverage"),
    "image_classification": (["--model", "resnet18_v1", "--image-size",
                              "64", "--batch-size", "8", "--steps", "2"],
                             "images/sec"),
    "image_classification:mobilenetv2_0.25": (
        ["--model", "mobilenetv2_0.25", "--image-size", "64",
         "--batch-size", "8", "--steps", "2"], "images/sec"),
    "bert_pretrain": (["--config", "bert_small", "--vocab", "500",
                       "--batch-size", "2", "--seq-len", "32",
                       "--num-masked", "4", "--steps", "2"],
                      "samples/sec"),
    "actor_critic": (["--episodes", "80"], "avg reward"),
    # unmodified: nn.Embedding(sparse_grad=True) takes the lazy Adam
    "word_lm": (["--steps", "40"], "perplexity"),
    "train_mnist": (["--synthetic", "--epochs", "1"],
                    "validation accuracy="),
    "estimator_fit": (["--synthetic", "--epochs", "3"],
                      "final validation accuracy"),
    "nmt_translate": (["--steps", "30", "--batch-size", "16"],
                      "exact-match"),
    "segmentation_fcn": (["--steps", "8", "--batch-size", "4"], "pixAcc="),
    "ssd_train": (["--steps", "12", "--batch-size", "4"], "top-det IoU"),
    "int8_inference": (["--train-steps", "24"], "INT8 INFERENCE OK"),
}


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_example_runs_through_the_port(name, tmp_path):
    args, expect = EXAMPLES[name]
    name = name.split(":")[0]
    with open(os.path.join(REPO, "example", f"{name}.py")) as f:
        src = f.read()
    script = tmp_path / f"{name}.py"
    script.write_text(src.replace("mxnet_tpu", "mxnet_tpu_torch"))
    runner = tmp_path / "run_example.py"
    runner.write_text(RUNNER)
    env = torch_threads.child_env(
        PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    res = subprocess.run([sys.executable, str(runner), str(script), *args],
                         capture_output=True, text=True, timeout=300,
                         cwd=str(tmp_path), env=env)
    assert res.returncode == 0, res.stdout[-1500:] + res.stderr[-1500:]
    assert expect in res.stdout


def test_distributed_training_through_the_launcher(tmp_path):
    """``example/distributed_training.py`` in two workers: each trains on
    its half of the data over the ``dist_tpu_sync`` kvstore and prints a
    final loss under 1e-3 (``tests/test_examples.py``'s assertion)."""
    with open(os.path.join(REPO, "example", "distributed_training.py")) as f:
        src = f.read()
    script = tmp_path / "distributed_training.py"
    script.write_text(src.replace("mxnet_tpu", "mxnet_tpu_torch"))
    runner = tmp_path / "run_example.py"
    runner.write_text(RUNNER)
    env = torch_threads.child_env(
        PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    env["OMP_NUM_THREADS"] = "1"
    res = torch_dist.run_group(
        [sys.executable, "-m", "mxnet_tpu_torch.launch", "-n", "2",
         sys.executable, str(runner), str(script)], timeout=120,
        cwd=str(tmp_path), env=env)
    assert res.returncode == 0, res.stdout[-1500:] + res.stderr[-1500:]
    assert res.stdout.count("final loss") == 2


def test_llama_spmd_finetune_through_the_launcher(tmp_path):
    """``example/llama_spmd_finetune.py`` (TP, PP = 2, 4) in eight
    workers, one a rank of its (tp, pp) mesh, with
    ``tests/test_examples.py``'s arguments: each writes its synthetic
    checkpoint, trains the stacked layers and takes part in the
    resharded save, which rank 0 writes and reports.  The script's own
    ``import jax`` stays: only the port's modules must not import it."""
    with open(os.path.join(REPO, "example", "llama_spmd_finetune.py")) as f:
        src = f.read()
    script = tmp_path / "llama_spmd_finetune.py"
    script.write_text(src.replace("mxnet_tpu", "mxnet_tpu_torch"))
    runner = tmp_path / "run_example.py"
    runner.write_text(RUNNER)
    env = torch_threads.child_env(
        PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    env["OMP_NUM_THREADS"] = "1"
    env["TMPDIR"] = str(tmp_path)
    res = torch_dist.run_group(
        [sys.executable, "-m", "mxnet_tpu_torch.launch", "-n", "8",
         sys.executable, str(runner), str(script), "--steps", "2",
         "--seq", "16", "--batch", "4"], timeout=240,
        cwd=str(tmp_path), env=env)
    assert res.returncode == 0, res.stdout[-1500:] + res.stderr[-1500:]
    assert "[worker 0] resharded save" in res.stdout
    assert res.stdout.count("step 1: loss") == 8
