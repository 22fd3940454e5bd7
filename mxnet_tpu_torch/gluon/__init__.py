"""Gluon: ``Block`` with ``initialize``, basic layers, the transformer
blocks (``gluon.contrib.nn``) and losses."""
from . import contrib, loss, nn
from .block import Block

__all__ = ["Block", "contrib", "loss", "nn"]
