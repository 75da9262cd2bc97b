"""Post-hoc source localization from evaluation flights (port of
``tpu_plume/evaluation/localize.py``): the trained
``GaussianParamPredictor`` reads the tail window of each flight's own
(x, y, conc) history and predicts its source, a far tighter localization
than the flight's final deviation.
"""

from __future__ import annotations

import numpy as np
import torch


def localize_from_trajectories(
    trajectories: np.ndarray,
    model,
    window: int = 64,
    grid_size: float = 500.0,
    conc_peak: float = 100.0,
) -> np.ndarray:
    """Source positions f32[K, 2] (grid units) predicted by ``model`` (a
    ``GaussianParamPredictor``, run on the device its parameters lie on)
    from NaN-padded evaluation trajectories [K, T, 3] of (x, y, conc)."""
    # the last min(len, window) valid steps of each flight (the valid rows
    # are the prefix), front-aligned and zero-padded
    lengths = np.isfinite(trajectories[..., 0]).sum(axis=1)       # [K]
    eff = np.minimum(lengths, window)
    start = np.maximum(lengths - window, 0)
    idx = start[:, None] + np.arange(window)[None, :]             # [K, W]
    idx = np.minimum(idx, np.maximum(lengths - 1, 0)[:, None])
    rows = np.take_along_axis(
        trajectories, idx[..., None], axis=1).astype(np.float32)  # [K, W, 3]
    mask = (np.arange(window)[None, :] < eff[:, None])[..., None]
    scale = np.array([grid_size, grid_size, conc_peak], np.float32)
    feats = np.where(mask, np.nan_to_num(rows) / scale, 0.0)
    # an all-NaN episode predicts from zeros at length 1
    lens = np.maximum(eff, 1).astype(np.int32)
    dev = next(model.parameters()).device
    with torch.no_grad():
        pred = model(torch.from_numpy(feats.astype(np.float32)).to(dev),
                     torch.from_numpy(lens).to(dev))
    return pred[:, :2].cpu().numpy() * grid_size
