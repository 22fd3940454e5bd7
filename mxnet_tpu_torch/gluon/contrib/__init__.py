"""Contrib blocks: the transformer encoder."""
from . import nn

__all__ = ["nn"]
