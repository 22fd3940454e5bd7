"""Contrib: automatic mixed precision."""
from . import amp

__all__ = ["amp"]
