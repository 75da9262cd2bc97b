"""Per-episode CSV stats and the per-iteration scalar log (the port's copy of
``tpu_plume/obsv/metrics.py``: ``EpisodeCSVLogger`` column for column, and
``TrainLogger`` with its TensorBoard scalars and histograms)."""

from __future__ import annotations

import csv
import os
import sys
from typing import IO

import numpy as np

# Reference column order (PPOV2.0/train_ppo2.0.py:129-135).
EPISODE_COLUMNS = [
    "Episode",
    "Total_Reward",
    "Success",
    "Conc_Reward",
    "Explore_Reward",
    "Move_Penalty",
    "TKE_Penalty",
    "Boundary_Penalty",
    "Steps",
    "Final_Conc",
    "Current_Radius",
]


class EpisodeCSVLogger:
    """Streams completed-episode rows in the reference's training_results
    CSV schema."""

    def __init__(self, path: str, append: bool = False):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        resume = append and os.path.exists(path) and os.path.getsize(path) > 0
        self.count = 0
        if resume:
            # Continue the Episode numbering from the existing rows.
            with open(path, newline="") as fh:
                self.count = max(sum(1 for _ in fh) - 1, 0)
        self._fh: IO = open(path, "a" if resume else "w", newline="")
        self._writer = csv.writer(self._fh)
        if not resume:
            self._writer.writerow(EPISODE_COLUMNS)

    def log_records(self, records: dict) -> int:
        """Append the rows where ``done`` is True of a batch of masked
        episode-record arrays (host numpy), in order."""
        done = np.asarray(records["done"]).reshape(-1)
        if not done.any():
            return 0
        idx = np.nonzero(done)[0]
        cols = {
            k: np.asarray(v).reshape(-1)[idx]
            for k, v in records.items()
            if k != "done"
        }
        for i in range(len(idx)):
            self.count += 1
            self._writer.writerow(
                [
                    self.count,
                    float(cols["total_reward"][i]),
                    int(cols["success"][i]),
                    float(cols["conc_reward"][i]),
                    float(cols["explore_reward"][i]),
                    float(cols["move_penalty"][i]),
                    float(cols["tke_penalty"][i]),
                    float(cols["boundary_penalty"][i]),
                    int(cols["steps"][i]),
                    float(cols["final_conc"][i]),
                    float(cols["radius"][i]),
                ]
            )
        return len(idx)

    def close(self):
        self._fh.close()


class TrainLogger:
    """Iteration-level scalar log: ``train_log.csv`` in the run directory,
    appended to with ``append`` (a resumed run), and with
    ``use_tensorboard`` the same scalars and the histograms of
    ``log_histograms`` in ``out_dir/tb``.  Where ``torch.utils.tensorboard``
    does not import, the log goes on with the CSV alone and says so in one
    line on stderr."""

    def __init__(self, out_dir: str, use_tensorboard: bool = False,
                 append: bool = False):
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(out_dir, "train_log.csv")
        resume = append and os.path.exists(path) and os.path.getsize(path) > 0
        self._fh = open(path, "a" if resume else "w", newline="")
        self._skip_header = resume
        self._csv = csv.writer(self._fh)
        self._keys: list[str] | None = None
        self._tb = None
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError as err:
                print(f"--tensorboard: torch.utils.tensorboard does not "
                      f"import ({err}); logging train_log.csv alone",
                      file=sys.stderr)
            else:
                self._tb = SummaryWriter(os.path.join(out_dir, "tb"))

    def log_histograms(self, step: int, named: dict, prefix: str = "params"):
        """A histogram of each named tensor or array of ``named``, as
        ``prefix/name`` (TensorBoard only)."""
        if self._tb is None:
            return
        for name, value in named.items():
            if isinstance(value, np.ndarray):
                value = value.astype(np.float32, copy=False)
            else:
                value = value.detach().float().cpu().numpy()
            self._tb.add_histogram(f"{prefix}/{name}", value, step)

    def log(self, step: int, scalars: dict):
        if self._keys is None:
            self._keys = sorted(scalars)
            if not self._skip_header:
                self._csv.writerow(["step"] + self._keys)
        self._csv.writerow(
            [step] + [f"{float(scalars.get(k, float('nan'))):.6g}"
                      for k in self._keys])
        self._fh.flush()
        if self._tb is not None:
            for k, v in scalars.items():
                self._tb.add_scalar(k, float(v), step)

    def close(self):
        self._fh.close()
        if self._tb is not None:
            self._tb.close()
