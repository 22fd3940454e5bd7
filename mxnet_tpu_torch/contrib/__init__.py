"""Contrib: automatic mixed precision and int8 quantization
(``quantization`` is imported at its first use: it needs ``gluon``,
which needs the operators that ``amp`` serves)."""
import importlib

from . import amp

__all__ = ["amp", "quantization"]


def __getattr__(name):
    if name == "quantization":
        return importlib.import_module(".quantization", __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
