"""Vision datasets, as the JAX package's ``gluon/data/vision/datasets.py``:
MNIST, FashionMNIST, CIFAR10 and CIFAR100 (HWC uint8 images, int32
labels).  Nothing is downloaded: a dataset reads the reference's files
from ``root`` (MNIST's idx files, gzipped or not; CIFAR's binary
batches), or with ``synthetic=N`` makes N seeded samples of the real
shapes and types, the same ones the JAX package makes.
``ImageFolderDataset`` and ``ImageRecordDataset`` wait for ``image`` and
``recordio`` (ROADMAP queue 1 item 11).
"""
from __future__ import annotations

import gzip
import os
import struct

import numpy as np

from ....base import MXNetError
from ..dataset import Dataset

__all__ = ["MNIST", "FashionMNIST", "CIFAR10", "CIFAR100"]


class _DownloadedDataset(Dataset):
    def __init__(self, root, train, transform, synthetic=None):
        self._transform = transform
        self._train = train
        self._data = None
        self._label = None
        self._synthetic = synthetic
        self._root = os.path.expanduser(root)
        self._get_data()

    def __getitem__(self, idx):
        from .... import ndarray as nd
        img = nd.array(self._data[idx], dtype=self._data.dtype.name)
        label = self._label[idx]
        if self._transform is not None:
            return self._transform(img, label)
        return img, label

    def __len__(self):
        return len(self._label)

    def _get_data(self):
        raise NotImplementedError


class MNIST(_DownloadedDataset):
    """MNIST (28x28x1 uint8 HWC images, int32 labels)."""

    _shape = (28, 28, 1)
    _classes = 10

    def __init__(self, root=os.path.join("~", ".mxnet", "datasets", "mnist"),
                 train=True, transform=None, synthetic=None):
        self._train_data = ("train-images-idx3-ubyte.gz",)
        self._train_label = ("train-labels-idx1-ubyte.gz",)
        self._test_data = ("t10k-images-idx3-ubyte.gz",)
        self._test_label = ("t10k-labels-idx1-ubyte.gz",)
        super().__init__(root, train, transform, synthetic)

    def _get_data(self):
        if self._synthetic is not None:
            rng = np.random.RandomState(42 if self._train else 43)
            n = self._synthetic
            self._data = rng.randint(
                0, 256, (n,) + self._shape).astype(np.uint8)
            self._label = rng.randint(0, self._classes, n).astype(np.int32)
            return
        data_file = (self._train_data if self._train
                     else self._test_data)[0]
        label_file = (self._train_label if self._train
                      else self._test_label)[0]
        data_path = os.path.join(self._root, data_file)
        label_path = os.path.join(self._root, label_file)
        for p in (data_path, label_path):
            if not os.path.exists(p) and not os.path.exists(p[:-3]):
                raise MXNetError(
                    f"{p} not found and no network access; place the file "
                    f"there or pass synthetic=N for generated data")

        def _open(p):
            if os.path.exists(p):
                return gzip.open(p, "rb")
            return open(p[:-3], "rb")

        with _open(label_path) as fin:
            struct.unpack(">II", fin.read(8))
            label = np.frombuffer(fin.read(), dtype=np.uint8) \
                .astype(np.int32)
        with _open(data_path) as fin:
            struct.unpack(">IIII", fin.read(16))
            data = np.frombuffer(fin.read(), dtype=np.uint8)
            data = data.reshape(len(label), 28, 28, 1)
        self._data = data
        self._label = label


class FashionMNIST(MNIST):
    def __init__(self, root=os.path.join("~", ".mxnet", "datasets",
                                         "fashion-mnist"),
                 train=True, transform=None, synthetic=None):
        super().__init__(root, train, transform, synthetic)


class CIFAR10(_DownloadedDataset):
    """CIFAR10 (32x32x3 uint8 HWC images, int32 labels)."""

    _shape = (32, 32, 3)
    _classes = 10
    _archive = "cifar-10-binary.tar.gz"

    def __init__(self, root=os.path.join("~", ".mxnet", "datasets",
                                         "cifar10"),
                 train=True, transform=None, synthetic=None):
        super().__init__(root, train, transform, synthetic)

    def _read_batch(self, filename):
        with open(filename, "rb") as fin:
            data = np.frombuffer(fin.read(), dtype=np.uint8).reshape(
                -1, 3072 + 1)
        return data[:, 1:].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1), \
            data[:, 0].astype(np.int32)

    def _get_data(self):
        if self._synthetic is not None:
            rng = np.random.RandomState(44 if self._train else 45)
            n = self._synthetic
            self._data = rng.randint(
                0, 256, (n,) + self._shape).astype(np.uint8)
            self._label = rng.randint(0, self._classes, n).astype(np.int32)
            return
        if self._train:
            files = [os.path.join(self._root, f"data_batch_{i}.bin")
                     for i in range(1, 6)]
        else:
            files = [os.path.join(self._root, "test_batch.bin")]
        for f in files:
            if not os.path.exists(f):
                raise MXNetError(
                    f"{f} not found and no network access; place CIFAR "
                    "binary batches there or pass synthetic=N")
        data, label = zip(*[self._read_batch(f) for f in files])
        self._data = np.concatenate(data)
        self._label = np.concatenate(label)


class CIFAR100(CIFAR10):
    _classes = 100

    def __init__(self, root=os.path.join("~", ".mxnet", "datasets",
                                         "cifar100"),
                 fine_label=False, train=True, transform=None,
                 synthetic=None):
        self._fine_label = fine_label
        super().__init__(root, train, transform, synthetic)
