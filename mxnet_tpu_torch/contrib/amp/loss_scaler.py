"""The dynamic loss scaler of float16 training (parity:
``contrib/amp/loss_scaler.py``)."""
from __future__ import annotations

__all__ = ["LossScaler"]


class LossScaler:
    """Starts at ``init_scale`` (2^16); halves on a step whose gradients
    are not all finite (never below 1) and doubles after ``scale_window``
    clean steps in a row (never above 2^24)."""

    def __init__(self, init_scale=2.0 ** 16, scale_factor=2.0,
                 scale_window=2000):
        self.loss_scale = init_scale
        self._scale_factor = scale_factor
        self._scale_window = scale_window
        self._unskipped = 0

    def has_overflow(self, params):
        """True when any of ``params`` (NDArrays, the gradients) holds an
        inf or a NaN, read once on the host through ``all_finite``;
        moves the scale."""
        if not params:
            return False
        from ... import ndarray as nd
        is_overflow = not bool(nd.all_finite(*params).asscalar())
        if is_overflow:
            self.loss_scale = max(self.loss_scale / self._scale_factor, 1.0)
            self._unskipped = 0
        else:
            self._unskipped += 1
            if self._unskipped >= self._scale_window:
                self.loss_scale = min(self.loss_scale * self._scale_factor,
                                      2.0 ** 24)
                self._unskipped = 0
        return is_overflow
