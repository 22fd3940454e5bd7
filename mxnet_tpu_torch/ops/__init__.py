"""Operators: attention (with the flash kernel) and the plain ops of the
Llama path."""
from . import attention, flash_attention, nn
from .attention import dot_product_attention, rope, sdpa_plain

__all__ = ["attention", "flash_attention", "nn", "dot_product_attention",
           "rope", "sdpa_plain"]
