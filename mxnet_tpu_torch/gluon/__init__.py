"""Gluon: ``Block``/``HybridBlock`` with names and ``collect_params``,
``Parameter``/``ParameterDict``, basic layers and containers, the
transformer blocks (``gluon.contrib.nn``), losses, ``Trainer`` and its
captured step (``CompiledStep``)."""
from . import contrib, loss, nn
from .block import Block, HybridBlock
from .compiled_step import CompiledStep
from .parameter import Parameter, ParameterDict
from .trainer import Trainer

__all__ = ["Block", "CompiledStep", "HybridBlock", "Parameter",
           "ParameterDict", "Trainer", "contrib", "loss", "nn"]
