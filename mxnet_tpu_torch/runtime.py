"""Feature detection (parity: ``mx.runtime``): ``Features()`` lists this
build's capabilities under the reference's feature names, so code that
asks ``Features().is_enabled("CUDA")`` runs unchanged.  The answers are
the PyTorch build's and this machine's: CUDA and cuDNN when a card is
usable, NCCL when ``torch.distributed`` has it, the distributed kvstore
when ``torch.distributed`` is built in."""
from __future__ import annotations

from collections import OrderedDict

import torch

__all__ = ["Feature", "Features", "feature_list"]


class Feature:
    def __init__(self, name, enabled):
        self.name = name
        self.enabled = enabled

    def __repr__(self):
        return f"[{'✔' if self.enabled else '✖'} {self.name}]"


def _nccl():
    import torch.distributed as dist
    return dist.is_available() and dist.is_nccl_available() \
        and torch.cuda.is_available()


def _has(mod):
    try:
        __import__(mod)
        return True
    except ImportError:
        return False


def _detect():
    import torch.distributed as dist
    cuda = torch.cuda.is_available()
    feats = OrderedDict()
    for name, on in (
            ("CUDA", cuda),
            ("CUDNN", cuda and torch.backends.cudnn.is_available()),
            ("NCCL", _nccl()),
            ("CUDA_RTC", cuda),
            ("DIST_KVSTORE", dist.is_available()),
            ("INT64_TENSOR_SIZE", True),
            ("INT8", True),
            ("F16", True),
            ("F16C", True),
            ("OPENCV", _has("cv2")),
            ("OPENMP", torch.backends.openmp.is_available()),
            ("SIGNAL_HANDLER", True),
            ("PROFILER", True),
            ("TENSORRT", False),
            ("MKLDNN", torch.backends.mkldnn.is_available()),
            ("CAFFE", False)):
        feats[name] = Feature(name, bool(on))
    return feats


class Features(OrderedDict):
    """``mx.runtime.Features().is_enabled("CUDA")``; one instance a
    process."""

    instance = None

    def __new__(cls):
        if cls.instance is None:
            cls.instance = super().__new__(cls)
            OrderedDict.__init__(cls.instance, _detect())
        return cls.instance

    def __init__(self):
        pass

    def __repr__(self):
        return str(list(self.values()))

    def is_enabled(self, feature_name: str) -> bool:
        feature_name = feature_name.upper()
        if feature_name not in self:
            raise RuntimeError(f"Feature {feature_name!r} does not exist")
        return self[feature_name].enabled


def feature_list():
    return list(Features().values())
