"""``gluon.data.vision``: the vision datasets and transforms."""
from . import transforms
from .datasets import CIFAR10, CIFAR100, MNIST, FashionMNIST

__all__ = ["MNIST", "FashionMNIST", "CIFAR10", "CIFAR100", "transforms"]
