"""Basic, convolution, pooling and activation layers and the sequential
containers."""
from .activations import Activation
from .basic_layers import (BatchNorm, Dense, Dropout, Embedding, Flatten,
                           HybridSequential, LayerNorm, Sequential)
from .conv_layers import (AvgPool2D, Conv1D, Conv2D, Conv3D,
                          GlobalAvgPool2D, MaxPool2D)

__all__ = ["Activation", "AvgPool2D", "BatchNorm", "Conv1D", "Conv2D",
           "Conv3D", "Dense", "Dropout", "Embedding", "Flatten",
           "GlobalAvgPool2D", "HybridSequential", "LayerNorm", "MaxPool2D",
           "Sequential"]
