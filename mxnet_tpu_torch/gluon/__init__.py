"""Gluon: ``Block``/``HybridBlock`` (hybridized: a ``CachedOp`` of graph
replays) with names and ``collect_params``, ``Parameter``/
``ParameterDict`` with deferred shapes and sharing, ``Constant``, basic, convolution and pooling
layers and containers, the transformer blocks (``gluon.contrib.nn``),
the recurrent cells and layers (``gluon.rnn``), the vision model zoo's
ResNets, losses, ``Trainer`` and its captured step (``CompiledStep``),
``gluon.data`` (datasets, the ``DataLoader``, vision), ``gluon.utils``
and the ``Estimator`` (``gluon.contrib.estimator``)."""
from . import contrib, data, loss, model_zoo, nn, rnn, utils
from .block import Block, CachedOp, HybridBlock
from .compiled_step import CompiledStep
from .parameter import (Constant, DeferredInitializationError, Parameter,
                        ParameterDict)
from .trainer import Trainer

__all__ = ["Block", "CachedOp", "CompiledStep", "Constant",
           "DeferredInitializationError", "HybridBlock", "Parameter",
           "ParameterDict", "Trainer", "contrib", "data", "loss", "model_zoo",
           "nn", "rnn", "utils"]
