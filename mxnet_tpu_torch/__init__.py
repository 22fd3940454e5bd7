"""mxnet_tpu_torch: the PyTorch / CUDA port of mxnet_tpu.

It serves Llama-family models through ``serving.Server`` and pretrains
BERT through ``parallel.DataParallelTrainer``.  Attention runs
flash-attention kernels written by hand in CUDA C++ for Hopper: the
forward (``csrc/flash_fwd.cu``) and the backward (``csrc/flash_bwd.cu``),
built with nvcc at first use.  Entry points run on ``gpu(0)`` unless the
caller passes ``ctx=mx.cpu()``; without a card and without that, they
raise ``MXNetError``.

    import mxnet_tpu_torch as mx
    lm = mx.models.LlamaForCausalLM(mx.models.llama_tiny(vocab_size=61))
    srv = mx.serving.Server(lm, buckets=[(2, 128)], max_new_tokens=8)

    net = mx.models.BERTForPretrain(mx.models.bert_base())
    net.initialize(mx.initializer.Xavier(), ctx=mx.gpu(0))
"""
from . import (base, context, contrib, envs, gluon, initializer, models,
               ops, optimizer, parallel, random, serving)
from .base import MXNetError
from .context import Context, cpu, current_context, gpu

init = initializer

__version__ = "0.1.0"

__all__ = ["MXNetError", "Context", "cpu", "gpu", "current_context",
           "base", "context", "contrib", "envs", "gluon", "init",
           "initializer", "models", "ops", "optimizer", "parallel",
           "random", "serving"]
