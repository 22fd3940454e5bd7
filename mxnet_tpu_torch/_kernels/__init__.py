"""Hand-written CUDA kernels: build at first use, load with ctypes."""
from .build import build, build_log, load, sources

__all__ = ["build", "build_log", "load", "sources"]
