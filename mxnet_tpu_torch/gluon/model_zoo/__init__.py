"""``gluon.model_zoo``: the vision models (ResNets so far)."""
from . import vision
from .vision import get_model

__all__ = ["get_model", "vision"]
