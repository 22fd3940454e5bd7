"""``gluon.model_zoo``: the vision models."""
from . import model_store, vision
from .vision import get_model

__all__ = ["get_model", "model_store", "vision"]
