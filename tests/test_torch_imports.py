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

import torch_threads

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+mxnet_tpu(?!\w)|"
    r"from\s+mxnet_tpu(?!\w))", re.M)

_CHILD = r"""
import sys
import numpy as np
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import elastic, telemetry
from mxnet_tpu_torch.models import LlamaForCausalLM, llama_tiny
from mxnet_tpu_torch.serving import Server
lm = LlamaForCausalLM(llama_tiny(vocab_size=61), ctx=mx.cpu())
srv = Server(lm, buckets=[(2, 8)], max_new_tokens=3, ctx=mx.cpu())
outs = srv.generate([np.arange(5, dtype="f4"), np.arange(3, dtype="f4")])
assert [len(o) for o in outs] == [8, 6], outs
req = srv.submit(np.arange(4, dtype="f4"), ttl_ms=60000)
srv.step()
elastic.faults.configure("dispatch_post:nth=1")
try:
    srv.step()
except mx.base.MXNetError:
    pass
assert srv.stats()["poisoned"] and srv.recover() == 1
assert srv.resize_slots(1)["slots_to"] == 1
srv.run()
assert req.state == "done"
snap = telemetry.snapshot()["counters"]
assert snap["mxtpu_recoveries_total"] == 1, snap
elastic.ServingAutoscaler(srv).observe()
assert elastic.integrity.token_checksum([1], [2])
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


_CHILD_NMT = r"""
import sys
import numpy as np
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, gluon, nd
from mxnet_tpu_torch.models import nmt_tiny
net = nmt_tiny(13, max_length=16, share_embed=True)
net.initialize(mx.init.Xavier(), ctx=mx.cpu())
net.hybridize()
tr = gluon.Trainer(net.collect_params(), "adam", {"learning_rate": 1e-2})
src = nd.array(np.random.RandomState(0).randint(3, 13, (4, 5)), ctx=mx.cpu())
tgt = nd.array(np.ones((4, 6)), ctx=mx.cpu())
with autograd.record():
    loss = net.loss(src, tgt, tgt, nd.array([5, 4, 3, 5], ctx=mx.cpu()))
loss.backward()
tr.step(4)
top = nd.topk(nd.cumsum(src, axis=1), k=2, ret_typ="both")
samples, scores, lens = net.translate(src, 1, 2, beam_size=2, max_len=6)
assert samples.shape[:2] == (4, 2) and len(top) == 2
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.")
             or m == "mxnet_tpu" or m.startswith("mxnet_tpu."))
print("FOREIGN", bad)
"""


_CHILD_VISION = r"""
import sys
import numpy as np
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, gluon, nd
from mxnet_tpu_torch.models import (MultiBoxLoss, SoftmaxSegLoss,
                                    SegmentationMetric, fcn_tiny, ssd_tiny)
cpu = mx.cpu()
net = fcn_tiny(nclass=3)
net.initialize(mx.init.Xavier(), ctx=cpu)
net.hybridize()
x = nd.array(np.random.RandomState(0).rand(2, 3, 32, 32), ctx=cpu)
y = nd.array(np.random.RandomState(1).randint(-1, 3, (2, 32, 32)), ctx=cpu)
with autograd.record():
    loss = SoftmaxSegLoss()(net(x), y)
loss.backward()
metric = SegmentationMetric(3)
metric.update(y, net.predict(x))
ssd = ssd_tiny(num_classes=1)
ssd.initialize(mx.init.Xavier(), ctx=cpu)
anchors, cls_preds, loc_preds = ssd(x)
labels = nd.array([[[0, 0.1, 0.1, 0.5, 0.5]]] * 2, ctx=cpu)
loc_t, loc_m, cls_t = nd.contrib.MultiBoxTarget(anchors, labels, cls_preds)
det = nd.contrib.MultiBoxDetection(nd.softmax(cls_preds, axis=1), loc_preds,
                                   anchors)
assert det.shape[0] == 2 and np.isfinite(metric.get()[1][0])
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.")
             or m == "mxnet_tpu" or m.startswith("mxnet_tpu."))
print("FOREIGN", bad)
"""


_CHILD_INT8 = r"""
import sys
import numpy as np
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import nd
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.contrib import quantization
from mxnet_tpu_torch.gluon.contrib import cnn
from mxnet_tpu_torch.gluon.model_zoo import model_store, vision
with mx.cpu():
    net = vision.resnet18_v1(classes=4, thumbnail=True)
    net.initialize(mx.init.Xavier())
    x = nd.array(np.random.RandomState(0).rand(2, 3, 16, 16))
    qnet = quantization.quantize_net(net, calib_data=iter([x]),
                                     calib_mode="entropy")
    assert qnet(x).shape == (2, 4) and len(qnet.layer_map) == 40
    dc = cnn.DeformableConvolution(4, 3, padding=1)
    dc.initialize()
    assert dc(x).shape == (2, 4, 16, 16)
    assert nd.linalg_gemm2(x[0], x[1]).shape == (3, 16, 16)
try:
    model_store.get_model_file("resnet18_v1", root="/nonexistent")
except MXNetError:
    pass
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
    env = torch_threads.child_env(PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "FOREIGN []" in r.stdout, r.stdout


def test_serving_in_a_fresh_process_loads_no_jax():
    """Serving with its failure and resize protocols, telemetry and
    elastic import neither JAX nor the JAX package."""
    _run_child(_CHILD)


def test_training_in_a_fresh_process_loads_no_jax():
    """A bf16-AMP BERT training step imports neither JAX nor the JAX
    package."""
    _run_child(_CHILD_TRAIN)


def test_imperative_path_in_a_fresh_process_loads_no_jax():
    """mx.nd, autograd, gluon.Trainer and mx.rtc import neither JAX nor
    the JAX package."""
    _run_child(_CHILD_IMPERATIVE)


def test_nmt_and_the_new_ops_in_a_fresh_process_load_no_jax():
    """TransformerNMT's training step and translation, nd.topk and
    nd.cumsum import neither JAX nor the JAX package."""
    _run_child(_CHILD_NMT)


def test_segmentation_and_detection_in_a_fresh_process_load_no_jax():
    """fcn_tiny's training step, predict and SegmentationMetric, ssd_tiny
    with MultiBoxTarget and MultiBoxDetection import neither JAX nor the
    JAX package."""
    _run_child(_CHILD_VISION)


def test_int8_and_the_registry_tail_in_a_fresh_process_load_no_jax():
    """contrib.quantization's quantize_net on a resnet18_v1 thumbnail,
    gluon.contrib.cnn's DeformableConvolution, a linalg op and
    model_zoo.model_store import neither JAX nor the JAX package."""
    _run_child(_CHILD_INT8)


_CHILD_DP = r"""
import sys
import numpy as np
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import gluon, kvstore, launch, nd, parallel, runtime
from mxnet_tpu_torch.gluon.contrib.nn import SyncBatchNorm
from mxnet_tpu_torch.parallel import collectives, zero
with mx.cpu():
    kv = mx.kv.create("device")
    kv.set_gradient_compression({"type": "2bit", "threshold": 0.5})
    kv.init("w", nd.zeros((4,)))
    kv.push("w", [nd.ones((4,), ctx=mx.cpu(i)) for i in range(2)])
    net = gluon.nn.HybridSequential()
    net.add(gluon.nn.Dense(4, in_units=3), SyncBatchNorm(in_channels=4))
    net.initialize(ctx=[mx.cpu(0), mx.cpu(1)])
    dense = gluon.nn.Dense(2, in_units=3)
    dense.initialize(ctx=mx.cpu())
    dpt = parallel.DataParallelTrainer(
        dense, lambda o, y: (o - y).square(), "sgd", fuse_step=True,
        compression={"type": "int8"},
        mesh=parallel.make_mesh({"dp": 1}, devices=[mx.cpu()]))
    dpt.step(np.ones((2, 3), "f4"), np.zeros((2, 2), "f4"))
assert runtime.Features().is_enabled("DIST_KVSTORE")
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.")
             or m == "mxnet_tpu" or m.startswith("mxnet_tpu."))
print("FOREIGN", bad)
"""


def test_data_parallel_modules_in_a_fresh_process_load_no_jax():
    """mx.kv, the launcher, parallel's collectives, ZeRO and trainer,
    SyncBatchNorm and mx.runtime import neither JAX nor the JAX
    package."""
    _run_child(_CHILD_DP)


#: queue 1 item 1.4: names of ported modules that the port lacked
ITEM_1_4 = ("ndarray.contrib.boolean_mask", "ndarray.contrib.fft",
            "ndarray.contrib.ifft", "context.cpu_pinned", "cpu_pinned",
            "runtime.Feature", "runtime.Features", "runtime.feature_list",
            "test_utils.same", "test_utils.almost_equal",
            "test_utils.rand_shape_nd", "test_utils.check_consistency",
            "base.integer_types", "base.string_types", "envs.registry",
            "serving.servers", "kv.create", "kvstore.KVStore",
            "parallel.set_mesh", "parallel.current_mesh",
            "parallel.mesh_shape")


@pytest.mark.parametrize("path", ITEM_1_4)
def test_item_1_4_names_exist_in_both_packages(path):
    import mxnet_tpu as jmx
    for pkg in (jmx, mx):
        obj = pkg
        for part in path.split("."):
            obj = getattr(obj, part)
        assert obj is not None


_CHILD_SPMD = r"""
import sys, tempfile
import numpy as np
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import nd, parallel
from mxnet_tpu_torch.gluon.contrib.nn import MoEFFN
from mxnet_tpu_torch.models import hf_loader, llama_spmd
from mxnet_tpu_torch.models.llama import LlamaForCausalLM, get_llama
with mx.cpu():
    plan = parallel.ShardingPlan({"dp": 1, "tp": 1}, parallel.megatron_rules())
    mesh = parallel.make_mesh({"tp": 1, "pp": 1})
    net = LlamaForCausalLM(get_llama("llama_tiny", vocab_size=61,
                                     num_layers=2), ctx=mx.cpu())
    d = tempfile.mkdtemp()
    hf_loader.export_hf_llama(net, d, max_shard_bytes=1 << 16)
    params, specs, cfg = llama_spmd.load_llama_stacked(d, mesh, 4, 2)
    toks = np.zeros((2, 8), "i8")
    loss, params = llama_spmd.train_step(params, toks, cfg, mesh, specs)
    import torch
    q = torch.zeros(1, 4, 2, 8)
    parallel.ring_attention(q, q, q, mesh=parallel.make_mesh({"sp": 1}))
    MoEFFN(8, 16, 2)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.")
             or m == "mxnet_tpu" or m.startswith("mxnet_tpu."))
print("FOREIGN", bad)
"""


def test_parallel_breadth_in_a_fresh_process_loads_no_jax():
    """The planner, llama_spmd's steps (the pipeline), hf_loader, ring
    attention and MoEFFN import neither JAX nor the JAX package."""
    _run_child(_CHILD_SPMD)


#: queue 1 item 4 and hf_loader: public names both packages have
ITEM_4 = ("parallel.ShardingPlan", "parallel.megatron_rules",
          "parallel.moe_param_rule", "parallel.llama_param_rule",
          "parallel.sharding_plan", "parallel.pipeline_apply",
          "parallel.pipeline_value_and_grad", "parallel.ring_attention",
          "parallel.ring_attention_sharded", "parallel.planner.plan_from_env",
          "parallel.planner.resolve_plan_axis", "parallel.planner.flat_rows",
          "parallel.planner.note_plan", "parallel.planner.plans",
          "parallel.planner.diff_records", "parallel.planner.SCALAR",
          "parallel.planner.resolve_shardings",
          "parallel.collectives.vocab_parallel_softmax_ce",
          "nd._contrib_MoEFFN", "nd.contrib.MoEFFN",
          "gluon.contrib.nn.MoEFFN", "models.hf_loader.read_safetensors",
          "models.hf_loader.write_safetensors",
          "models.hf_loader.write_safetensors_sharded",
          "models.hf_loader.load_hf_llama", "models.hf_loader.export_hf_llama",
          "models.hf_loader.load_hf_bert", "models.hf_loader.export_hf_bert",
          "models.load_hf_llama", "models.export_hf_llama",
          "models.read_safetensors", "models.llama_spmd.load_llama_stacked",
          "models.llama_spmd.make_stage_fn",
          "models.llama_spmd.make_chunked_loss",
          "models.llama_spmd.forward_logits", "models.llama_spmd.train_step",
          "models.llama_spmd.save_llama_stacked")


@pytest.mark.parametrize("path", ITEM_4)
def test_item_4_names_exist_in_both_packages(path):
    import mxnet_tpu as jmx
    import mxnet_tpu.models.llama_spmd  # noqa: F401 (not imported eagerly)
    import mxnet_tpu.parallel.planner  # noqa: F401
    for pkg in (jmx, mx):
        obj = pkg
        for part in path.split("."):
            obj = getattr(obj, part)
        assert obj is not None


_CHILD_ZOO = r"""
import sys
import numpy as np
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, nd
from mxnet_tpu_torch.gluon.model_zoo import vision
from mxnet_tpu_torch.models import (FasterRCNNLoss, PCKMetric,
                                    PoseHeatmapLoss, YOLOv3Loss,
                                    faster_rcnn_tiny, gaussian_heatmaps,
                                    simple_pose_tiny, yolo3_tiny)
with mx.cpu():
    for name in ("vgg11", "alexnet", "squeezenet1.1", "mobilenet0.25",
                 "mobilenetv2_0.25", "densenet121", "inceptionv3"):
        vision.get_model(name, classes=4)
    x = nd.array(np.random.RandomState(0).rand(2, 3, 64, 64))
    y = nd.array(np.array([[[0, 0.1, 0.1, 0.5, 0.5]]] * 2, "f4"))
    for net, loss in ((yolo3_tiny(image_size=64), YOLOv3Loss),
                      (faster_rcnn_tiny(), FasterRCNNLoss)):
        net.initialize(mx.init.Xavier())
        with autograd.record():
            loss(net)(net(x), y).backward()
        net.decode(net(x))
    pose = simple_pose_tiny(2)
    pose.initialize(mx.init.Xavier())
    kp = np.array([[[0.5, 0.5, 1.0], [0.2, 0.2, 1.0]]] * 2, "f4")
    hm = nd.array(gaussian_heatmaps(kp, 32))
    PoseHeatmapLoss()(pose(x), hm, nd.array(kp[:, :, 2]))
    metric = PCKMetric()
    metric.update(kp, pose.predict(x))
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.")
             or m == "mxnet_tpu" or m.startswith("mxnet_tpu."))
print("FOREIGN", bad)
"""


def test_model_breadth_in_a_fresh_process_loads_no_jax():
    """The vision zoo's families, YOLOv3, Faster R-CNN and SimplePose with
    their losses, decoders and metric import neither JAX nor the JAX
    package."""
    _run_child(_CHILD_ZOO)


def _public(module):
    names = getattr(module, "__all__", None)
    return sorted(names if names is not None else
                  [n for n in dir(module) if not n.startswith("_")])


#: queue 1 item 5: the modules whose public names the port holds
ITEM_5 = ("gluon.model_zoo.vision", "gluon.model_zoo.vision.vgg",
          "gluon.model_zoo.vision.alexnet",
          "gluon.model_zoo.vision.squeezenet",
          "gluon.model_zoo.vision.mobilenet",
          "gluon.model_zoo.vision.densenet",
          "gluon.model_zoo.vision.inception", "models", "models.yolo",
          "models.rcnn", "models.pose")


@pytest.mark.parametrize("path", ITEM_5)
def test_item_5_names_exist_in_both_packages(path):
    """Every public name of the JAX module (its ``__all__``, else its
    names without a leading underscore) is in the port's."""
    import importlib
    jmod = importlib.import_module("mxnet_tpu." + path)
    tmod = importlib.import_module("mxnet_tpu_torch." + path)
    missing = [n for n in _public(jmod) if not hasattr(tmod, n)]
    assert missing == []


#: queue 1 item 6: the serving plane's modules and the parts of the
#: telemetry and elastic planes it runs on.  What the port still lacks of
#: the JAX modules' public names, each with the queue item that brings it
ITEM_6 = {
    "serving": {}, "serving.server": {}, "serving.scheduler": {},
    "serving.kvcache": {},
    "telemetry": {"memory": "item 7", "health": "item 7"},
    "telemetry.metrics": {}, "telemetry.recorder": {},
    "elastic": {"CheckpointManager": "item 7",
                "ResizeController": "item 7", "Guardian": "item 7",
                "PreemptionGuard": "item 7", "guardian": "item 7",
                "chaos": "item 7", "reshard": "item 7"},
    "elastic.faults": {n: "item 7" for n in (
        "HANG_DEFAULT_MS", "corrupt_armed", "corrupt_due",
        "nonfinite_due", "note_corruption_applied", "preempt_due")},
    "elastic.resize": {"ResizeController": "item 7",
                       "mesh_desc": "item 7"},
    "elastic.integrity": {n: "item 7" for n in (
        "IntegritySpec", "action", "agreement", "body_rows", "build_spec",
        "corrupt_param_host", "ctl_vector", "fingerprint", "jit_block",
        "quarantine", "quarantine_mesh", "respond", "trace_signature")},
    "elastic.manager": {n: "item 7" for n in (
        "CheckpointManager", "align_params", "known_dirs", "ls_dir",
        "managers_created", "prune_dir", "read_arrays", "timed_recover",
        "verify_dir", "write_arrays")},
}


@pytest.mark.parametrize("path", sorted(ITEM_6))
def test_item_6_names_exist_in_both_packages(path):
    """Every public name of the JAX module is in the port's, except those
    listed as still missing (and those are missing)."""
    import importlib
    jmod = importlib.import_module("mxnet_tpu." + path)
    tmod = importlib.import_module("mxnet_tpu_torch." + path)
    missing = [n for n in _public(jmod) if not hasattr(tmod, n)]
    assert missing == sorted(ITEM_6[path])


def test_server_plan_is_still_missing():
    """``Server(plan=)`` and ``KVCachePool(sharding=)`` wait for queue 1
    item 6's last entry: the card machine has one card, so decode never
    shards there."""
    import inspect
    from mxnet_tpu import serving as jserving
    from mxnet_tpu_torch import serving
    for cls, arg in (("Server", "plan"), ("KVCachePool", "sharding")):
        assert arg in inspect.signature(getattr(jserving, cls)).parameters
        assert arg not in inspect.signature(getattr(serving, cls)).parameters


def test_get_model_holds_the_reference_names():
    from mxnet_tpu.gluon.model_zoo import vision as jvision
    from mxnet_tpu_torch.gluon.model_zoo import vision
    assert sorted(vision._models) == sorted(jvision._models)
    assert len(vision._models) == 34


#: what the port's registry still lacks of the JAX package's: nothing
#: since the MoE layer's op came with ROADMAP queue 1 item 4
STILL_MISSING = ()


def _vision_and_detection():
    """The 27 names of the vision and detection groups (ROADMAP queue 1
    item 2.7), as the files that hold them against the JAX package list
    them."""
    from test_torch_detection import DETECTION_OPS
    from test_torch_vision_ops import VISION_OPS
    return sorted(VISION_OPS | DETECTION_OPS)


@pytest.mark.parametrize("name", _vision_and_detection())
def test_vision_and_detection_names_resolve(name):
    """Each name through ``nd``, ``nd.contrib`` (a ``_contrib_`` one also
    without its prefix) and ``F`` inside a ``hybrid_forward``."""
    from mxnet_tpu_torch.ops.registry import get_op
    op = get_op(name)
    assert callable(getattr(mx.nd, name))
    short = name[len("_contrib_"):] if name.startswith("_contrib_") \
        else None
    if short is not None:
        assert callable(getattr(mx.nd.contrib, short))
    assert op.name in (name, "_contrib_" + name)
    seen = []

    class Probe(mx.gluon.HybridBlock):
        def hybrid_forward(self, F, x):
            seen.append(getattr(F, name))
            return x

    Probe()(mx.nd.zeros((1,), ctx=mx.cpu()))
    assert callable(seen[0])


def test_the_registry_lacks_exactly_the_queued_names():
    import mxnet_tpu.ops.registry as jreg
    from mxnet_tpu_torch.ops.registry import list_ops
    port, ref = set(list_ops()), set(jreg.list_ops())
    names = _vision_and_detection()
    assert len(STILL_MISSING) == 0 and len(names) == 27
    assert set(names) <= port
    assert sorted(ref - port) == sorted(STILL_MISSING)
    assert len(port & ref) == 288


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
                                   "rtc.launch", "nmt.initialize",
                                   "nd.linspace"])
def test_entry_points_default_to_the_card(entry):
    """Without a card and without ctx=mx.cpu(), entry points raise
    instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default context is "
                    "valid here")
    with pytest.raises(MXNetError, match="CUDA"):
        if entry == "LlamaForCausalLM":
            # the constructor makes no weights; initialize places them
            LlamaForCausalLM(llama_tiny(vocab_size=61)).initialize(
                mx.init.Xavier())
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
        elif entry == "nmt.initialize":
            models.nmt_tiny(13).initialize(mx.init.Xavier())
        elif entry == "nd.linspace":
            mx.nd.linspace(0.0, 1.0, 5)
        elif entry == "rtc.launch":
            k = mx.rtc.CudaKernel(None, "k", "k", "float *y")
            k.launch([mx.nd.zeros((2,), ctx=mx.cpu())], mx.gpu(0),
                     (1, 1, 1), (2, 1, 1))
        else:
            mx.current_context().device


def test_cpu_scope_sets_the_default_context():
    with mx.cpu():
        lm = LlamaForCausalLM(llama_tiny(vocab_size=61)).initialize(
            mx.init.Xavier())
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
