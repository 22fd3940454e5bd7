"""Basic layers and the sequential containers."""
from .basic_layers import (Dense, Dropout, Embedding, HybridSequential,
                           LayerNorm, Sequential)

__all__ = ["Dense", "Dropout", "Embedding", "HybridSequential",
           "LayerNorm", "Sequential"]
