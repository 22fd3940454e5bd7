"""``gluon.data``: datasets, samplers, the ``DataLoader`` and
``gluon.data.vision`` (as the JAX package's ``gluon/data/``)."""
from . import vision
from .dataloader import DataLoader
from .dataset import ArrayDataset, Dataset, SimpleDataset
from .sampler import BatchSampler, RandomSampler, Sampler, SequentialSampler

__all__ = ["Dataset", "ArrayDataset", "SimpleDataset", "Sampler",
           "SequentialSampler", "RandomSampler", "BatchSampler",
           "DataLoader", "vision"]
