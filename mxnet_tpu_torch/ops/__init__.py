"""Operators: the op registry with the imperative path's ops (tensor,
nn, optimizer updates, sampling), and attention (with the flash
kernels)."""
from . import (attention, flash_attention, nn, optimizer_ops, random_ops,
               registry, tensor)
from .attention import dot_product_attention, rope, sdpa_plain

__all__ = ["attention", "flash_attention", "nn", "optimizer_ops",
           "random_ops", "registry", "tensor", "dot_product_attention",
           "rope", "sdpa_plain"]
