"""Base utilities: the framework's exception type and dtype names."""
from __future__ import annotations

import numbers

import numpy as np
import torch

__all__ = ["MXNetError", "torch_dtype", "numpy_dtype", "numeric_types"]

numeric_types = (numbers.Number, np.generic)


class MXNetError(RuntimeError):
    """Error raised by the framework (parity with mxnet.base.MXNetError)."""


_DTYPES = {"float32": torch.float32, "float16": torch.float16,
           "bfloat16": torch.bfloat16, "float64": torch.float64,
           "int32": torch.int32, "int64": torch.int64, "int8": torch.int8,
           "uint8": torch.uint8, "int16": torch.int16, "bool": torch.bool}
_NAMES = {v: k for k, v in _DTYPES.items()}


def torch_dtype(dtype) -> torch.dtype:
    """A ``torch.dtype`` from a numpy-style name, a numpy dtype or type,
    or a ``torch.dtype``."""
    if isinstance(dtype, torch.dtype):
        return dtype
    name = getattr(dtype, "name", None) or getattr(dtype, "__name__", None)
    try:
        return _DTYPES[str(name or dtype)]
    except KeyError:
        raise MXNetError(f"unsupported dtype {dtype!r}") from None


def dtype_name(dtype: torch.dtype) -> str:
    """The numpy-style name of a ``torch.dtype``."""
    return _NAMES[dtype]


def numpy_dtype(dtype: torch.dtype) -> np.dtype:
    """The numpy dtype of a ``torch.dtype`` (bfloat16 through
    ``ml_dtypes``, numpy having none)."""
    if dtype == torch.bfloat16:
        try:
            import ml_dtypes
        except ImportError:
            raise MXNetError("bfloat16 has no numpy dtype without the "
                             "ml_dtypes package") from None
        return np.dtype(ml_dtypes.bfloat16)
    return np.dtype(_NAMES[dtype])
