"""mxnet_tpu_torch: the PyTorch / CUDA port of mxnet_tpu.

It serves Llama-family models through ``serving.Server``; prefill
attention runs a flash-attention forward kernel written by hand in CUDA
C++ for Hopper (``csrc/flash_fwd.cu``), built with nvcc at first use.
Entry points run on ``gpu(0)`` unless the caller passes
``ctx=mx.cpu()``; without a card and without that, they raise
``MXNetError``.

    import mxnet_tpu_torch as mx
    lm = mx.models.LlamaForCausalLM(mx.models.llama_tiny(vocab_size=61))
    srv = mx.serving.Server(lm, buckets=[(2, 128)], max_new_tokens=8)
"""
from . import base, context, envs, models, ops, random, serving
from .base import MXNetError
from .context import Context, cpu, current_context, gpu

__version__ = "0.1.0"

__all__ = ["MXNetError", "Context", "cpu", "gpu", "current_context",
           "base", "context", "envs", "models", "ops", "random",
           "serving"]
