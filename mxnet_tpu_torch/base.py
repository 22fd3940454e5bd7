"""Base utilities: the framework's exception type and dtype names."""
from __future__ import annotations

import torch

__all__ = ["MXNetError", "torch_dtype"]


class MXNetError(RuntimeError):
    """Error raised by the framework (parity with mxnet.base.MXNetError)."""


_DTYPES = {"float32": torch.float32, "float16": torch.float16,
           "bfloat16": torch.bfloat16, "float64": torch.float64,
           "int32": torch.int32, "int64": torch.int64}


def torch_dtype(dtype) -> torch.dtype:
    """A ``torch.dtype`` from a numpy-style name or a ``torch.dtype``."""
    if isinstance(dtype, torch.dtype):
        return dtype
    try:
        return _DTYPES[str(dtype)]
    except KeyError:
        raise MXNetError(f"unsupported dtype {dtype!r}") from None
