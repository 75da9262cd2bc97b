"""Trajectory datasets for the stop-LSTM trainers (the port's copy of
``tpu_plume/data/datasets.py``).

Each loader of the JAX package is split in two: the h5py reader
(``load_*``, which reads a ``training_data.nc``) and a numpy body over the
variables it reads (``x``, ``y``, ``concentration``, ``source_*``,
``gaussian_sigma``, ``peak_concentration``), which takes any mapping of
those names to arrays: ``read_nc``'s dict, or the arrays a capture holds in
memory (``EpisodeArrays.arrays()``) on a machine without h5py.  Outputs and
``np.random.Generator`` calls are the JAX package's, in the same order:

  - ``load_raw_sequences``       (PPOV2.0/data_loader.py:5-22)
  - ``load_trajectory_segments`` (PPOV2.1/model.py:68-90)
  - ``load_enhanced_samples``    (PPOV2.1/model.py:92-111)
  - ``source_window_dataset``    (the source localizer's windows)
  - ``calculate_dynamic_label``  (PPOV2.1/model.py:113-127)

plus the fixed-shape window builders that turn the ragged episodes into
dense [num_windows, window] arrays.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np

from tpu_plume_torch.data.netcdf import DEFAULT_SIGMA, require_h5py


def read_variables(nc_path: str, names) -> dict[str, np.ndarray]:
    """The variables ``names`` of a trajectory file that it holds."""
    h5py = require_h5py("reading NetCDF files")
    with h5py.File(nc_path, "r") as nc:
        return {n: np.asarray(nc[n]) for n in names if n in nc}


def raw_sequences(nc: Mapping):
    """Per-episode valid concentration sequence and source concentration
    (valid steps: where x is not NaN, data_loader.py:12-17)."""
    x, conc, src = nc["x"], nc["concentration"], nc["source_concentration"]
    sequences, source_concs = [], []
    for ep in range(x.shape[0]):
        steps = np.where(~np.isnan(x[ep]))[0]
        if len(steps) == 0:
            continue
        sequences.append(conc[ep, : steps[-1] + 1].tolist())
        source_concs.append(src[ep])
    return sequences, np.array(source_concs)


def load_raw_sequences(nc_path: str):
    return raw_sequences(read_variables(
        nc_path, ("x", "concentration", "source_concentration")))


def trajectory_segments(nc: Mapping, tail_steps: int = 60,
                        window_size: int = 20):
    """Sliding-window (positions, concentrations, source_pos, sigma)
    segments over every valid trajectory (PPOV2.1/model.py:68-90)."""
    x, y, conc = nc["x"], nc["y"], nc["concentration"]
    sx, sy = nc["source_x"], nc["source_y"]
    sigma = nc.get("gaussian_sigma")
    segments = []
    for ep in range(x.shape[0]):
        valid = np.where(~np.isnan(x[ep]))[0]
        if len(valid) < window_size:
            continue
        xs, ys, cs = x[ep, valid], y[ep, valid], conc[ep, valid]
        source_pos = np.array([sx[ep], sy[ep]])
        sig = float(sigma[ep]) if sigma is not None else DEFAULT_SIGMA
        for i in range(0, len(valid) - window_size + 1):
            segments.append({
                "positions": np.column_stack(
                    (xs[i : i + window_size], ys[i : i + window_size])),
                "concentrations": cs[i : i + window_size],
                "source_pos": source_pos,
                "sigma": sig,
            })
    return segments


def load_trajectory_segments(nc_path: str, tail_steps: int = 60,
                             window_size: int = 20):
    return trajectory_segments(read_variables(
        nc_path, ("x", "y", "concentration", "source_x", "source_y",
                  "gaussian_sigma")), tail_steps, window_size)


def enhanced_samples(nc: Mapping, window_size: int = 120):
    """Windows with (source_x, source_y, sigma, peak) regression targets
    (PPOV2.1/model.py:92-111); none without the V2.1 variables."""
    if "gaussian_sigma" not in nc:
        return []
    conc_all = nc["concentration"]
    samples = []
    for ep in range(conc_all.shape[0]):
        conc = conc_all[ep][~np.isnan(conc_all[ep])]
        target = np.array([float(nc["source_x"][ep]),
                           float(nc["source_y"][ep]),
                           float(nc["gaussian_sigma"][ep]),
                           float(nc["peak_concentration"][ep])])
        for i in range(window_size, len(conc)):
            samples.append({"window_conc": conc[i - window_size : i],
                            "target": target})
    return samples


def load_enhanced_samples(nc_path: str, window_size: int = 120):
    return enhanced_samples(read_variables(
        nc_path, ("concentration", "source_x", "source_y", "gaussian_sigma",
                  "peak_concentration")), window_size)


def source_windows(
    nc: Mapping,
    window_size: int = 64,
    per_episode: int = 6,
    grid_size: float = 500.0,
    conc_peak: float = 100.0,
    rng: np.random.Generator | None = None,
):
    """[N, W, 3] windows of normalized (x, y, conc) flight samples with
    [N, 2] normalized source-position targets: the supervised dataset of
    the ``GaussianParamPredictor`` source localizer.

    The writer overwrites each trajectory's final row with the source
    coordinates; that row is dropped here or the targets would leak into
    the inputs.  Window lengths are drawn in [min_length, window_size]
    (zero-padded past the length, returned in ``lengths``); each episode's
    first window is its tail at full length.

    Returns ``(feats [N, W, 3], lengths [N], targets [N, 2], groups [N])``,
    ``groups`` the episode of each window (windows of one flight overlap,
    so train/val splits are made by group)."""
    rng = rng or np.random.default_rng(0)
    min_length = max(8, window_size // 4)
    x, y, conc = nc["x"], nc["y"], nc["concentration"]
    sx, sy = nc["source_x"], nc["source_y"]
    feats, lengths, targets, groups = [], [], [], []
    for ep in range(x.shape[0]):
        valid = np.where(~np.isnan(x[ep]))[0][:-1]  # drop the source row
        if len(valid) < min_length:
            continue
        tr = np.column_stack((x[ep, valid] / grid_size,
                              y[ep, valid] / grid_size,
                              conc[ep, valid] / conc_peak)).astype(np.float32)
        tgt = np.array([sx[ep] / grid_size, sy[ep] / grid_size], np.float32)
        for j in range(per_episode):
            length = int(rng.integers(min_length,
                                      min(window_size, len(valid)) + 1))
            if j == 0:
                length = min(window_size, len(valid))
            e = (len(valid) if j == 0
                 else int(rng.integers(length, len(valid) + 1)))
            w = np.zeros((window_size, 3), np.float32)
            w[:length] = tr[e - length : e]
            feats.append(w)
            lengths.append(length)
            targets.append(tgt)
            groups.append(ep)
    if not feats:
        return (np.zeros((0, window_size, 3), np.float32),
                np.zeros((0,), np.int32), np.zeros((0, 2), np.float32),
                np.zeros((0,), np.int32))
    return (np.stack(feats), np.asarray(lengths, np.int32), np.stack(targets),
            np.asarray(groups, np.int32))


def source_window_dataset(nc_path: str, window_size: int = 64,
                          per_episode: int = 6, grid_size: float = 500.0,
                          conc_peak: float = 100.0,
                          rng: np.random.Generator | None = None):
    return source_windows(
        read_variables(nc_path, ("x", "y", "concentration", "source_x",
                                 "source_y")),
        window_size, per_episode, grid_size, conc_peak, rng)


def calculate_dynamic_label(segment: dict, conc_peak: float = 100.0) -> float:
    """Distance/trend/concentration composite stop label
    (PPOV2.1/model.py:113-127)."""
    conc = np.asarray(segment["concentrations"], np.float64)
    pos = np.asarray(segment["positions"])
    src = np.asarray(segment["source_pos"])
    dist = np.linalg.norm(pos[-1] - src)
    dist_score = np.exp(-dist / 50.0)
    grad = np.gradient(conc)
    trend_score = np.tanh(np.mean(grad[-3:]) / 5.0)
    conc_score = np.clip(conc[-1] / conc_peak, 0, 1)
    label = 0.4 * dist_score + 0.3 * (trend_score + 1) / 2 + 0.3 * conc_score
    return float(np.clip(label, 0.01, 0.99))


# ---------------------------------------------------------------------------
# Dense fixed-shape dataset builders
# ---------------------------------------------------------------------------


def tail_window_dataset(sequences, source_concs, window: int):
    """V2.0 SequenceDataset: the last ``window`` steps of each long-enough
    sequence, target = source concentration (PPOV2.0/train_lstm.py:12-50).
    Returns (features f32[M, window], targets f32[M])."""
    feats, targs = [], []
    for seq, sc in zip(sequences, source_concs):
        if len(seq) >= window:
            feats.append(np.asarray(seq[-window:], np.float32))
            targs.append(np.float32(sc))
    if not feats:
        return np.zeros((0, window), np.float32), np.zeros((0,), np.float32)
    return np.stack(feats), np.asarray(targs)


def peak_stop_dataset(
    segments,
    window_size: int = 20,
    stop_radius: float = 10.0,
    max_episodes: int = 1000,
    conc_norm: float = 100.0,
    rng: np.random.Generator | None = None,
    bug_compat: bool = False,
):
    """V2.1 TrajectoryDataset: per episode one negative (first window,
    stop=0) and one positive (last window, stop = dist <= stop_radius)
    sample, labels (peak/100, stop) (PPOV2.1/train_lstm.py:11-74).
    Episodes are told apart by their source position; at most
    ``max_episodes`` random episodes are drawn.

    ``bug_compat=True`` reproduces the reference's quirk: it takes only an
    episode's first window (train_lstm.py:41), so its "positive last
    window" is the negative's array and the stop label is computed at step
    ``window_size-1``.  The default takes the episode's true tail.
    Returns (features f32[M, window], labels f32[M, 2])."""
    rng = rng or np.random.default_rng(0)
    episodes: dict[tuple, list] = {}
    for seg in segments:
        episodes.setdefault(tuple(seg["source_pos"]), []).append(seg)
    groups = list(episodes.values())
    if len(groups) > max_episodes:
        idx = rng.choice(len(groups), size=max_episodes, replace=False)
        groups = [groups[i] for i in idx]
    feats, labels = [], []
    for ep_segs in groups:
        head = ep_segs[0]
        tail = head if bug_compat else ep_segs[-1]
        conc_head = np.asarray(head["concentrations"], np.float32)
        conc_tail = np.asarray(tail["concentrations"], np.float32)
        if len(conc_head) < window_size or len(conc_tail) < window_size:
            continue
        feats.append(conc_head[:window_size] / conc_norm)
        labels.append([conc_head[window_size - 1] / conc_norm, 0.0])
        feats.append(conc_tail[-window_size:] / conc_norm)
        last_pos = np.asarray(tail["positions"])[-1]
        stop = 1.0 if np.linalg.norm(last_pos - tail["source_pos"]) <= stop_radius else 0.0
        labels.append([conc_tail[-1] / conc_norm, stop])
    if not feats:
        return np.zeros((0, window_size), np.float32), np.zeros((0, 2), np.float32)
    return np.stack(feats), np.asarray(labels, np.float32)
