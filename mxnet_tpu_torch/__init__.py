"""mxnet_tpu_torch: the PyTorch / CUDA port of mxnet_tpu.

It serves Llama-family models through ``serving.Server``, pretrains
BERT through ``parallel.DataParallelTrainer``, and has MXNet's imperative
front door: ``mx.nd`` NDArrays over torch tensors, ``mx.autograd``,
gluon Blocks with named Parameters and ``gluon.Trainer``.  Attention runs
flash-attention kernels written by hand in CUDA C++ for Hopper: the
forward (``csrc/flash_fwd.cu``) and the backward (``csrc/flash_bwd.cu``),
built with nvcc at first use; ``mx.rtc.CudaModule`` compiles user CUDA
kernels with NVRTC.  Entry points run on ``gpu(0)`` unless the caller
passes ``ctx=mx.cpu()``; without a card and without that, they raise
``MXNetError``.

    from mxnet_tpu_torch import nd, autograd, gluon
    net = gluon.nn.HybridSequential()
    with net.name_scope():
        net.add(gluon.nn.Dense(10, in_units=784))
    net.initialize(mx.init.Xavier(), ctx=mx.gpu(0))
    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": 0.05})

    import mxnet_tpu_torch as mx
    lm = mx.models.LlamaForCausalLM(mx.models.llama_tiny(vocab_size=61),
                                    ctx=mx.gpu(0))
    srv = mx.serving.Server(lm, buckets=[(2, 128)], max_new_tokens=8)

    net = mx.models.BERTForPretrain(mx.models.bert_base())
    net.initialize(mx.initializer.Xavier(), ctx=mx.gpu(0))
"""
from . import (autograd, base, context, contrib, envs, gluon, initializer,
               lr_scheduler, metric, models, ndarray, ops, optimizer,
               parallel, random, rtc, serving, test_utils)
from .base import MXNetError
from .context import Context, cpu, current_context, gpu, num_gpus

init = initializer
nd = ndarray

__version__ = "0.1.0"

__all__ = ["MXNetError", "Context", "cpu", "gpu", "current_context",
           "num_gpus",
           "autograd", "base", "context", "contrib", "envs", "gluon", "init",
           "initializer", "lr_scheduler", "metric", "models", "nd", "ndarray",
           "ops", "optimizer", "parallel", "random", "rtc", "serving",
           "test_utils"]
