"""The port stands alone: it never imports JAX or the JAX package, and
its entry points run on the card unless the caller asks for the CPU."""
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch import models, parallel
from mxnet_tpu_torch.models import LlamaForCausalLM, llama_tiny
from mxnet_tpu_torch.ops import flash_attention as tfa
from mxnet_tpu_torch.serving import Server

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+mxnet_tpu(?!\w)|"
    r"from\s+mxnet_tpu(?!\w))", re.M)

_CHILD = r"""
import sys
import numpy as np
import mxnet_tpu_torch as mx
from mxnet_tpu_torch.models import LlamaForCausalLM, llama_tiny
from mxnet_tpu_torch.serving import Server
lm = LlamaForCausalLM(llama_tiny(vocab_size=61), ctx=mx.cpu())
srv = Server(lm, buckets=[(2, 8)], max_new_tokens=3, ctx=mx.cpu())
outs = srv.generate([np.arange(5, dtype="f4"), np.arange(3, dtype="f4")])
assert [len(o) for o in outs] == [8, 6], outs
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.")
             or m == "mxnet_tpu" or m.startswith("mxnet_tpu."))
print("FOREIGN", bad)
"""

_CHILD_TRAIN = r"""
import sys
import numpy as np
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import models, parallel
from mxnet_tpu_torch.contrib import amp
from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
net = models.BERTForPretrain(models.bert_small(
    vocab_size=50, max_length=128, num_layers=1))
net.initialize(mx.init.Xavier(), ctx=mx.cpu())
sce = SoftmaxCrossEntropyLoss()
amp.init("bfloat16")
dpt = parallel.DataParallelTrainer(
    net, lambda o, y: sce(o[0], y[:, :2].reshape(-1)).mean()
    + sce(o[1], y[:, 2]).mean(), "adam", {"learning_rate": 1e-4},
    mesh=parallel.make_mesh({"dp": 1}, devices=[mx.cpu()]), fuse_step=True)
rng = np.random.RandomState(0)
tok = rng.randint(0, 50, (2, 128)).astype("f4")
loss = dpt.step((tok, 0 * tok, None, tok[:, :2]), tok[:, :3])
amp._deinit()
assert np.isfinite(loss.item()), loss
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.")
             or m == "mxnet_tpu" or m.startswith("mxnet_tpu."))
print("FOREIGN", bad)
"""


_CHILD_IMPERATIVE = r"""
import sys
import numpy as np
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, gluon, nd, rtc, test_utils
net = gluon.nn.HybridSequential()
with net.name_scope():
    net.add(gluon.nn.Dense(8, activation="relu", in_units=4),
            gluon.nn.Dense(3, in_units=8))
net.initialize(mx.init.Xavier(), ctx=mx.cpu())
net.hybridize()
trainer = gluon.Trainer(net.collect_params(), "sgd",
                        {"learning_rate": 0.1, "momentum": 0.9})
loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
x = nd.random.uniform(shape=(16, 4), ctx=mx.cpu())
y = nd.array(np.arange(16) % 3, ctx=mx.cpu())
losses = []
for _ in range(5):
    with autograd.record():
        loss = loss_fn(net(x), y)
    loss.backward()
    trainer.step(16)
    losses.append(loss.mean().asscalar())
assert losses[-1] < losses[0], losses
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.")
             or m == "mxnet_tpu" or m.startswith("mxnet_tpu."))
print("FOREIGN", bad)
"""


def _sources():
    pkg = os.path.join(REPO, "mxnet_tpu_torch")
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(pkg):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _run_child(code):
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "FOREIGN []" in r.stdout, r.stdout


def test_serving_in_a_fresh_process_loads_no_jax():
    _run_child(_CHILD)


def test_training_in_a_fresh_process_loads_no_jax():
    """A bf16-AMP BERT training step imports neither JAX nor the JAX
    package."""
    _run_child(_CHILD_TRAIN)


def test_imperative_path_in_a_fresh_process_loads_no_jax():
    """mx.nd, autograd, gluon.Trainer and mx.rtc import neither JAX nor
    the JAX package."""
    _run_child(_CHILD_IMPERATIVE)


def test_no_source_imports_jax_or_the_jax_package():
    offenders = []
    for path in _sources():
        with open(path) as f:
            for m in FORBIDDEN.finditer(f.read()):
                offenders.append(f"{os.path.relpath(path, REPO)}: "
                                 f"{m.group(0).strip()}")
    assert len(_sources()) > 10
    assert offenders == []


@pytest.mark.parametrize("entry", ["LlamaForCausalLM", "Server",
                                   "context", "BERT.initialize",
                                   "make_mesh", "nd.array", "nd.zeros",
                                   "nd.random.normal", "gluon.initialize",
                                   "rtc.launch"])
def test_entry_points_default_to_the_card(entry):
    """Without a card and without ctx=mx.cpu(), entry points raise
    instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default context is "
                    "valid here")
    with pytest.raises(MXNetError, match="CUDA"):
        if entry == "LlamaForCausalLM":
            LlamaForCausalLM(llama_tiny(vocab_size=61))
        elif entry == "Server":
            lm = LlamaForCausalLM(llama_tiny(vocab_size=61), ctx=mx.cpu())
            Server(lm, buckets=[(1, 8)], max_new_tokens=2)
        elif entry == "BERT.initialize":
            models.BERTForPretrain(models.bert_small()).initialize(
                mx.init.Xavier())
        elif entry == "make_mesh":
            parallel.make_mesh({"dp": 1})
        elif entry == "nd.array":
            mx.nd.array([1.0, 2.0])
        elif entry == "nd.zeros":
            mx.nd.zeros((2, 2))
        elif entry == "nd.random.normal":
            mx.nd.random.normal(shape=(2,))
        elif entry == "gluon.initialize":
            mx.gluon.nn.Dense(2, in_units=3).initialize()
        elif entry == "rtc.launch":
            k = mx.rtc.CudaKernel(None, "k", "k", "float *y")
            k.launch([mx.nd.zeros((2,), ctx=mx.cpu())], mx.gpu(0),
                     (1, 1, 1), (2, 1, 1))
        else:
            mx.current_context().device


def test_cpu_scope_sets_the_default_context():
    with mx.cpu():
        lm = LlamaForCausalLM(llama_tiny(vocab_size=61))
        assert lm.device == torch.device("cpu")
        srv = Server(lm, buckets=[(1, 8)], max_new_tokens=2)
    assert srv.ctx == mx.cpu()


def test_cpu_flash_attention_launches_no_kernel():
    tfa.flash_fwd_launches = tfa.flash_bwd_launches = 0
    rng = np.random.RandomState(0)
    q, k, v = (torch.from_numpy(rng.randn(1, 128, 2, 64).astype("f4"))
               for _ in range(3))
    q.requires_grad_(True)
    out = mx.ops.dot_product_attention(q, k, v, causal=True)
    out.sum().backward()
    assert out.shape == (1, 128, 2, 64)
    assert tfa.flash_fwd_launches == tfa.flash_bwd_launches == 0


def test_model_must_come_from_get_llama():
    lm = LlamaForCausalLM(llama_tiny(vocab_size=61), ctx=mx.cpu())
    with pytest.raises(MXNetError, match="meta"):
        LlamaForCausalLM(lm.model, ctx=mx.cpu())
