"""Operators: the op registry with the imperative path's ops (tensor,
nn, optimizer updates, sampling, the recurrent layers' fused
recurrence), and attention (with the flash kernels)."""
from . import (attention, flash_attention, nn, optimizer_ops, random_ops,
               registry, rnn, tensor)
from .attention import dot_product_attention, rope, sdpa_plain

__all__ = ["attention", "flash_attention", "nn", "optimizer_ops",
           "random_ops", "registry", "rnn", "tensor", "dot_product_attention",
           "rope", "sdpa_plain"]
