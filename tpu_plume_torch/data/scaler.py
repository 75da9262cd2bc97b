"""Min-max scaler with the reference's persistence format (the port's copy
of ``tpu_plume/data/scaler.py``).

The reference fits sklearn's ``MinMaxScaler`` globally over all training
windows (PPOV2.0/train_lstm.py:18-29) and persists only ``data_min_`` to
``model/scaler_params.npy`` (train_lstm.py:99); at eval time it re-fits a
scaler on that single value (PPOV2.0/evaluate_with_lstm.py:52-55), which
degenerates to a pure shift (sklearn's zero-range guard sets scale=1).

This scaler fits and transforms as sklearn's does, saves both
``[data_min, data_max]``, and still loads the reference's 1-element file as
that shift-only scaler.
"""

from __future__ import annotations

import numpy as np


class MinMaxScaler:
    def __init__(self, feature_range=(0.0, 1.0)):
        self.feature_range = feature_range
        self.data_min_: float | None = None
        self.data_max_: float | None = None

    def fit(self, x: np.ndarray) -> "MinMaxScaler":
        x = np.asarray(x, np.float64)
        self.data_min_ = float(np.min(x))
        self.data_max_ = float(np.max(x))
        return self

    @property
    def _scale(self) -> float:
        lo, hi = self.feature_range
        rng = self.data_max_ - self.data_min_
        # sklearn's _handle_zeros_in_scale: a zero range scales by 1
        return (hi - lo) / rng if rng > 0 else (hi - lo)

    def transform(self, x: np.ndarray) -> np.ndarray:
        lo, _ = self.feature_range
        return (np.asarray(x, np.float64) - self.data_min_) * self._scale + lo

    def inverse_transform(self, x: np.ndarray) -> np.ndarray:
        lo, _ = self.feature_range
        return (np.asarray(x, np.float64) - lo) / self._scale + self.data_min_

    def fit_transform(self, x: np.ndarray) -> np.ndarray:
        return self.fit(x).transform(x)

    def save(self, path: str):
        np.save(path, np.array([self.data_min_, self.data_max_]))

    @classmethod
    def load(cls, path: str) -> "MinMaxScaler":
        params = np.atleast_1d(np.load(path))
        s = cls()
        if params.size >= 2:
            s.data_min_, s.data_max_ = float(params[0]), float(params[1])
        else:
            # the reference's 1-element file: the shift-only scaler
            s.data_min_ = s.data_max_ = float(params[0])
        return s
