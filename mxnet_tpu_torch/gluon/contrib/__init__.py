"""Contrib blocks: the transformer encoder, and the Estimator."""
from . import estimator, nn

__all__ = ["estimator", "nn"]
