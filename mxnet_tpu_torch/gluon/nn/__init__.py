"""``gluon.nn``: the basic, normalisation, convolution, pooling,
padding and activation layers and the sequential and concatenating
containers, the JAX package's 42 names."""
from .activations import (ELU, GELU, SELU, Activation, LeakyReLU, PReLU,
                          SiLU, Swish)
from .basic_layers import (BatchNorm, Concatenate, Dense, Dropout,
                           Embedding, Flatten, GroupNorm, HybridConcatenate,
                           HybridLambda, HybridSequential, Identity,
                           InstanceNorm, Lambda, LayerNorm, Sequential)
from .conv_layers import (AvgPool1D, AvgPool2D, AvgPool3D, Conv1D,
                          Conv1DTranspose, Conv2D, Conv2DTranspose, Conv3D,
                          Conv3DTranspose, GlobalAvgPool1D, GlobalAvgPool2D,
                          GlobalAvgPool3D, GlobalMaxPool1D, GlobalMaxPool2D,
                          GlobalMaxPool3D, MaxPool1D, MaxPool2D, MaxPool3D,
                          ReflectionPad2D)

__all__ = [
    "Sequential", "HybridSequential", "Dense", "Dropout", "BatchNorm",
    "LayerNorm", "InstanceNorm", "GroupNorm", "Embedding",
    "Flatten", "Lambda",
    "HybridLambda", "HybridConcatenate", "Concatenate", "Identity",
    "Activation", "LeakyReLU", "PReLU", "ELU", "SELU", "Swish", "GELU",
    "SiLU",
    "Conv1D", "Conv2D", "Conv3D", "Conv1DTranspose", "Conv2DTranspose",
    "Conv3DTranspose", "MaxPool1D", "MaxPool2D", "MaxPool3D", "AvgPool1D",
    "AvgPool2D", "AvgPool3D", "GlobalMaxPool1D", "GlobalMaxPool2D",
    "GlobalMaxPool3D", "GlobalAvgPool1D", "GlobalAvgPool2D",
    "GlobalAvgPool3D", "ReflectionPad2D",
]
