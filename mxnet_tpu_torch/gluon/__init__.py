"""Gluon: ``Block``/``HybridBlock`` with names and ``collect_params``,
``Parameter``/``ParameterDict``, basic layers and containers, the
transformer blocks (``gluon.contrib.nn``), losses and ``Trainer``."""
from . import contrib, loss, nn
from .block import Block, HybridBlock
from .parameter import Parameter, ParameterDict
from .trainer import Trainer

__all__ = ["Block", "HybridBlock", "Parameter", "ParameterDict", "Trainer",
           "contrib", "loss", "nn"]
