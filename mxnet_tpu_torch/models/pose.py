"""Pose estimation, as the JAX package's ``models/pose.py``: SimplePose
(Xiao et al. 2018; GluonCV's ``simple_pose_resnet*``), a zoo backbone cut
at its stride-32 features, stride-2 deconvolutions and a 1x1 head with a
heatmap a keypoint.  Training regresses Gaussian heatmaps under a
visibility-masked L2 loss; ``predict`` takes each heatmap's argmax (the
quarter-pixel shift toward the second-highest neighbour left out, as the
JAX package does)."""
from __future__ import annotations

import numpy as np

from ..gluon import nn
from ..gluon.block import HybridBlock
from ..metric import EvalMetric
from .feature import truncate_features

__all__ = ["SimplePose", "PoseHeatmapLoss", "gaussian_heatmaps",
           "PCKMetric", "simple_pose_tiny"]


class SimplePose(HybridBlock):
    """A backbone's stages, ``num_deconv`` stride-2 4x4 deconvolutions
    (each with BN and ReLU), and a 1x1 convolution to a heatmap a
    keypoint.  ``backbone`` is a fully convolutional zoo net whose
    classifier is dropped; with three deconvolutions over stride-32
    features the heatmaps are a quarter of the input's size."""

    def __init__(self, num_keypoints, backbone, deconv_channels=64,
                 num_deconv=3, **kwargs):
        super().__init__(**kwargs)
        self.num_keypoints = num_keypoints
        with self.name_scope():
            # a plain list and one register_child each: the blocks'
            # second parent
            self._backbone = truncate_features(backbone, reject_dense=False)
            for i, b in enumerate(self._backbone):
                self.register_child(b, f"bb{i}")
            self.deconv = nn.HybridSequential(prefix="deconv_")
            with self.deconv.name_scope():
                for _ in range(num_deconv):
                    self.deconv.add(
                        nn.Conv2DTranspose(deconv_channels, 4, strides=2,
                                           padding=1, use_bias=False),
                        nn.BatchNorm(),
                        nn.Activation("relu"))
            self.head = nn.Conv2D(num_keypoints, 1, prefix="head_")

    def forward(self, x):
        for b in self._backbone:
            x = b(x)
        return self.head(self.deconv(x))        # (B, K, H', W')

    def predict(self, x):
        """Keypoints in [0, 1]: (B, K, 2) as (x, y), each heatmap's
        argmax cell's center."""
        from .. import ndarray as nd
        hm = self(x)
        b, k, h, w = hm.shape
        idx = nd.argmax(hm.reshape((b, k, h * w)), axis=-1)   # (B, K)
        ys = nd.floor(idx / w)
        xs = idx - ys * w
        return nd.stack((xs + 0.5) / w, (ys + 0.5) / h, axis=-1)


def gaussian_heatmaps(keypoints, heatmap_size, sigma=1.5):
    """(B, K, 3) [x, y, visible] in [0, 1] -> (B, K, H, W) float32
    Gaussian targets, computed in numpy (targets are data)."""
    kp = np.asarray(keypoints, "f4")
    b, k, _ = kp.shape
    h = w = int(heatmap_size)
    ys, xs = np.mgrid[0:h, 0:w].astype("f4") + 0.5
    out = np.zeros((b, k, h, w), "f4")
    for i in range(b):
        for j in range(k):
            x, y, v = kp[i, j]
            if v <= 0:
                continue
            d2 = (xs - x * w) ** 2 + (ys - y * h) ** 2
            out[i, j] = np.exp(-d2 / (2.0 * sigma ** 2))
    return out


class PoseHeatmapLoss:
    """L2 between predicted and target heatmaps, masked by the keypoints'
    visibility."""

    def __call__(self, pred, target, visible):
        from .. import ndarray as nd
        per_kp = nd.mean((pred - target) ** 2, axis=(2, 3))   # (B, K)
        vis = visible.astype("float32")
        n = nd.maximum(nd.sum(vis), nd.ones((1,), ctx=pred.context))
        return nd.sum(per_kp * vis) / n


class PCKMetric(EvalMetric):
    """Percentage of Correct Keypoints: the share of visible keypoints
    predicted within ``threshold`` (in [0, 1] coordinates) of the
    label."""

    def __init__(self, threshold=0.1):
        self.threshold = float(threshold)
        super().__init__(name=f"PCK@{threshold}")

    def update(self, labels, preds):
        if not isinstance(labels, (list, tuple)):
            labels, preds = [labels], [preds]
        for kp, pred in zip(labels, preds):
            kp = np.asarray(kp.asnumpy() if hasattr(kp, "asnumpy") else kp,
                            "f4")
            pred = np.asarray(pred.asnumpy() if hasattr(pred, "asnumpy")
                              else pred, "f4")
            vis = kp[:, :, 2] > 0
            dist = np.sqrt(((pred - kp[:, :, :2]) ** 2).sum(-1))
            self._inc(float((dist[vis] < self.threshold).sum()),
                      int(vis.sum()))


def simple_pose_tiny(num_keypoints=4):
    """Test-size SimplePose over the thumbnail resnet18."""
    from ..gluon.model_zoo import vision
    return SimplePose(num_keypoints,
                      vision.resnet18_v1(classes=10, thumbnail=True),
                      deconv_channels=32, num_deconv=2)
