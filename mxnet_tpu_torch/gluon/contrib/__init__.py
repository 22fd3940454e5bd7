"""Contrib blocks: the transformer encoder, the Estimator and the
deformable convolution."""
from . import cnn, estimator, nn

__all__ = ["cnn", "estimator", "nn"]
