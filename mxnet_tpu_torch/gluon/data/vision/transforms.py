"""Vision transforms, as the JAX package's
``gluon/data/vision/transforms.py``: per-sample host work on HWC images
(``ToTensor`` makes CHW float32 in [0, 1]).  Each is a ``Block``; called
with an NDArray it gets the tensor and returns one, which the Block
returns as an NDArray.  The random ones draw from numpy's global RNG in
the reference's order, so one ``np.random.seed`` gives both packages the
same crops and flips.

``Resize`` (and the resizes inside the crops) computes what the JAX
package's ``jax.image.resize`` computes, in numpy float32: linear
interpolation with a triangle filter widened by the downscaling factor
(antialiasing), half-pixel centres, the filter weights normalised over
the input, and ``"nearest"`` for ``interpolation=0``.
``torch.nn.functional.interpolate`` differs from it at the edges and in
its antialiasing.
"""
from __future__ import annotations

import numpy as np
import torch

from ....ndarray.ndarray import NDArray
from ....ops.nn import linear_resize_weights
from ...block import Block
from ...nn import Sequential

__all__ = ["Compose", "Cast", "ToTensor", "Normalize", "Resize",
           "CenterCrop", "RandomResizedCrop", "RandomFlipLeftRight",
           "RandomFlipTopBottom", "RandomBrightness", "RandomContrast"]


def _asnp(x):
    if isinstance(x, NDArray):
        return x.asnumpy()
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _out(a, dtype=None):
    a = np.ascontiguousarray(a if dtype is None else a.astype(dtype))
    return torch.from_numpy(a)


class Compose(Sequential):
    """The transforms one after the other."""

    def __init__(self, transforms):
        super().__init__()
        for t in transforms:
            self.add(t)


class Cast(Block):
    def __init__(self, dtype="float32"):
        super().__init__()
        self._dtype = dtype

    def forward(self, x):
        return _out(_asnp(x), self._dtype)


class ToTensor(Block):
    """HWC uint8 in [0, 255] to CHW float32 in [0, 1] (NHWC to NCHW)."""

    def forward(self, x):
        img = _asnp(x).astype("float32") / 255.0
        if img.ndim == 3:
            img = img.transpose(2, 0, 1)
        elif img.ndim == 4:
            img = img.transpose(0, 3, 1, 2)
        return _out(img)


class Normalize(Block):
    """``(x - mean) / std`` per channel of a CHW image."""

    def __init__(self, mean=0.0, std=1.0):
        super().__init__()
        self._mean = np.asarray(mean, dtype="float32")
        self._std = np.asarray(std, dtype="float32")

    def forward(self, x):
        img = _asnp(x).astype("float32")
        return _out((img - self._mean.reshape(-1, 1, 1))
                    / self._std.reshape(-1, 1, 1))


def _nearest_index(m, n):
    return np.floor((np.arange(n, dtype=np.float32) + np.float32(0.5))
                    * np.float32(m) / np.float32(n)).astype(np.int64)


def _resize_np(img, size, interp=1):
    """An HWC (or HW) image resized to ``size`` = (w, h), in float32, as
    ``jax.image.resize(img, (h, w, c), "linear" or "nearest")``."""
    out = np.asarray(img, dtype="float32")
    for axis, n in ((0, size[1]), (1, size[0])):
        m = out.shape[axis]
        if m == n:
            continue
        if interp == 0:
            out = np.take(out, _nearest_index(m, n), axis=axis)
        else:
            w = linear_resize_weights(m, n)
            out = np.moveaxis(np.tensordot(w, np.moveaxis(out, axis, 0),
                                           axes=([0], [0])), 0, axis)
    return out.astype("float32")


class Resize(Block):
    """Resize to ``size`` = (w, h) (or an int for both); ``keep_ratio``
    fits the image inside that box."""

    def __init__(self, size, keep_ratio=False, interpolation=1):
        super().__init__()
        if isinstance(size, int):
            size = (size, size)
        self._size = size
        self._keep = keep_ratio
        self._interpolation = interpolation

    def forward(self, x):
        img = _asnp(x)
        w, h = self._size
        if self._keep:
            ih, iw = img.shape[:2]
            scale = min(w / iw, h / ih)
            h, w = max(int(ih * scale), 1), max(int(iw * scale), 1)
        out = _resize_np(img, (w, h), self._interpolation)
        if img.dtype == np.uint8:
            return _out(np.clip(out, 0, 255), "uint8")
        return _out(out)


class CenterCrop(Block):
    """The centre ``size`` = (w, h) crop; a smaller image is resized up
    first."""

    def __init__(self, size, interpolation=1):
        super().__init__()
        if isinstance(size, int):
            size = (size, size)
        self._size = size
        self._interpolation = interpolation

    def forward(self, x):
        img = _asnp(x)
        w, h = self._size
        ih, iw = img.shape[:2]
        if ih < h or iw < w:
            img = _resize_np(img, (max(w, iw), max(h, ih)),
                             self._interpolation)
            ih, iw = img.shape[:2]
        y0, x0 = (ih - h) // 2, (iw - w) // 2
        return _out(img[y0:y0 + h, x0:x0 + w])


class RandomResizedCrop(Block):
    """A random crop of random area and aspect ratio, resized to
    ``size``; after 10 misses the centre crop."""

    def __init__(self, size, scale=(0.08, 1.0), ratio=(3.0 / 4.0, 4.0 / 3.0),
                 interpolation=1):
        super().__init__()
        if isinstance(size, int):
            size = (size, size)
        self._size = size
        self._scale = scale
        self._ratio = ratio
        self._interpolation = interpolation

    def forward(self, x):
        img = _asnp(x)
        ih, iw = img.shape[:2]
        area = ih * iw
        for _ in range(10):
            target_area = np.random.uniform(*self._scale) * area
            log_ratio = (np.log(self._ratio[0]), np.log(self._ratio[1]))
            aspect = np.exp(np.random.uniform(*log_ratio))
            w = int(round(np.sqrt(target_area * aspect)))
            h = int(round(np.sqrt(target_area / aspect)))
            if w <= iw and h <= ih:
                x0 = np.random.randint(0, iw - w + 1)
                y0 = np.random.randint(0, ih - h + 1)
                crop = img[y0:y0 + h, x0:x0 + w]
                out = _resize_np(crop, self._size, self._interpolation)
                return _out(np.clip(out, 0, 255), img.dtype)
        return CenterCrop(self._size, self._interpolation).forward(img)


class RandomFlipLeftRight(Block):
    def forward(self, x):
        if np.random.rand() < 0.5:
            return _out(_asnp(x)[:, ::-1])
        return x


class RandomFlipTopBottom(Block):
    def forward(self, x):
        if np.random.rand() < 0.5:
            return _out(_asnp(x)[::-1])
        return x


class RandomBrightness(Block):
    """Pixels times a factor drawn from [1 - b, 1 + b], as uint8."""

    def __init__(self, brightness):
        super().__init__()
        self._args = (max(0, 1 - brightness), 1 + brightness)

    def forward(self, x):
        alpha = np.random.uniform(*self._args)
        img = _asnp(x).astype("float32") * alpha
        return _out(np.clip(img, 0, 255), "uint8")


class RandomContrast(Block):
    """Pixels pulled from or pushed to their mean by a factor drawn from
    [1 - c, 1 + c], as uint8."""

    def __init__(self, contrast):
        super().__init__()
        self._args = (max(0, 1 - contrast), 1 + contrast)

    def forward(self, x):
        alpha = np.random.uniform(*self._args)
        img = _asnp(x).astype("float32")
        gray = img.mean()
        img = gray + alpha * (img - gray)
        return _out(np.clip(img, 0, 255), "uint8")
