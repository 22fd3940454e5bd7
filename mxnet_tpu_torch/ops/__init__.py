"""Operators: the op registry with the imperative path's ops (tensor,
nn with the vision group, the detection ops, the int8 quantization ops
and products, optimizer updates,
sampling, the recurrent layers' fused recurrence), and attention (with
the flash kernels)."""
from . import (attention, det, flash_attention, moe, nn, optimizer_ops,
               quantization_ops, random_ops, registry, rnn, tensor)
from .attention import dot_product_attention, rope, sdpa_plain

__all__ = ["attention", "det", "flash_attention", "moe", "nn", "optimizer_ops",
           "quantization_ops", "random_ops", "registry", "rnn", "tensor", "dot_product_attention",
           "rope", "sdpa_plain"]
