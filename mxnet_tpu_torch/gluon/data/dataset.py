"""Datasets, as the JAX package's ``gluon/data/dataset.py``: ``Dataset``
(``filter``, ``shard``, ``take``, ``transform``, ``transform_first``),
``SimpleDataset`` and ``ArrayDataset``.  ``RecordFileDataset`` waits for
``recordio`` (ROADMAP queue 1 item 11)."""
from __future__ import annotations

from ... import ndarray as nd

__all__ = ["Dataset", "ArrayDataset", "SimpleDataset"]


class Dataset:
    """Abstract dataset: __getitem__ + __len__."""

    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError

    def filter(self, fn):
        return SimpleDataset([self[i] for i in range(len(self))
                              if fn(self[i])])

    def shard(self, num_shards, index):
        assert 0 <= index < num_shards
        length = len(self)
        shard_len = length // num_shards
        rest = length % num_shards
        start = shard_len * index + min(index, rest)
        end = start + shard_len + (index < rest)
        return _SlicedDataset(self, start, end)

    def take(self, count):
        return _SlicedDataset(self, 0, min(count, len(self)))

    def transform(self, fn, lazy=True):
        trans = _LazyTransformDataset(self, fn)
        if lazy:
            return trans
        return SimpleDataset([trans[i] for i in range(len(trans))])

    def transform_first(self, fn, lazy=True):
        def base_fn(x, *args):
            if args:
                return (fn(x),) + args
            return fn(x)
        return self.transform(base_fn, lazy)


class _SlicedDataset(Dataset):
    def __init__(self, dataset, start, end):
        self._dataset = dataset
        self._start = start
        self._end = end

    def __len__(self):
        return self._end - self._start

    def __getitem__(self, idx):
        if idx >= len(self):
            raise IndexError
        return self._dataset[self._start + idx]


class _LazyTransformDataset(Dataset):
    def __init__(self, dataset, fn):
        self._dataset = dataset
        self._fn = fn

    def __len__(self):
        return len(self._dataset)

    def __getitem__(self, idx):
        item = self._dataset[idx]
        if isinstance(item, tuple):
            return self._fn(*item)
        return self._fn(item)


class SimpleDataset(Dataset):
    """Wrap any indexable as a Dataset."""

    def __init__(self, data):
        self._data = data

    def __len__(self):
        return len(self._data)

    def __getitem__(self, idx):
        return self._data[idx]


class ArrayDataset(Dataset):
    """Zip of equal-length arrays/datasets (parity: ArrayDataset)."""

    def __init__(self, *args):
        assert len(args) > 0
        self._length = len(args[0])
        self._data = []
        for i, data in enumerate(args):
            assert len(data) == self._length, \
                f"All arrays must have the same length; input {i} has " \
                f"length {len(data)} while the first has {self._length}."
            if isinstance(data, nd.NDArray) and data.ndim == 1:
                data = data.asnumpy()
            self._data.append(data)

    def __getitem__(self, idx):
        if len(self._data) == 1:
            return self._data[0][idx]
        return tuple(data[idx] for data in self._data)

    def __len__(self):
        return self._length
