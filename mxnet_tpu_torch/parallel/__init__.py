"""Data-parallel training on a device mesh (the one-device path)."""
from .mesh import Mesh, make_mesh
from .trainer import DataParallelTrainer

__all__ = ["DataParallelTrainer", "Mesh", "make_mesh"]
