"""Data parallel across ranks: the mesh over the process group, the
collectives over NCCL (a card) or gloo (the CPU), ZeRO's slices and
``DataParallelTrainer`` (dense, compressed and ZeRO steps)."""
from . import collectives, zero
from .collectives import (quantized_psum, quantized_reduce_scatter,
                          reduce_scatter, twobit_psum,
                          vocab_parallel_softmax_ce)
from .mesh import Mesh, current_mesh, make_mesh, mesh_shape, set_mesh
from .trainer import DataParallelTrainer

__all__ = ["DataParallelTrainer", "Mesh", "make_mesh", "set_mesh",
           "current_mesh", "mesh_shape", "collectives", "zero",
           "quantized_psum", "quantized_reduce_scatter", "reduce_scatter",
           "twobit_psum", "vocab_parallel_softmax_ce"]
