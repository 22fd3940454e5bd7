"""Gluon: ``Block``/``HybridBlock`` (hybridized: a ``CachedOp`` of graph
replays) with names and ``collect_params``, ``Parameter``/
``ParameterDict`` with deferred shapes, basic, convolution and pooling
layers and containers, the transformer blocks (``gluon.contrib.nn``),
the recurrent cells and layers (``gluon.rnn``), the vision model zoo's
ResNets, losses, ``Trainer`` and its captured step (``CompiledStep``)."""
from . import contrib, loss, model_zoo, nn, rnn
from .block import Block, CachedOp, HybridBlock
from .compiled_step import CompiledStep
from .parameter import Parameter, ParameterDict
from .trainer import Trainer

__all__ = ["Block", "CachedOp", "CompiledStep", "HybridBlock", "Parameter",
           "ParameterDict", "Trainer", "contrib", "loss", "model_zoo", "nn",
           "rnn"]
