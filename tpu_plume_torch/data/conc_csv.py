"""Ragged concentration-sequence CSV, the V1.2 capture format (the port's
copy of ``tpu_plume/data/conc_csv.py``).

PPOV1.2 appends one ragged row per episode to ``data.csv``: the per-step
concentrations, then the episode's source concentration as the last column
(PPOV1.2/ppo注释版.py:115-124, 431-434); its LSTM prototype reads "all
columns but the last = sequence, the last = label" (PPOV1.2/new.LSTM.py:
18-24).
"""

from __future__ import annotations

import csv

import numpy as np


def save_conc_rows(path: str, sequences, source_concs, append: bool = False):
    """Write ragged rows: seq values..., source_conc (each value as
    ``f"{float(v):.6g}"``)."""
    fmt = "{:.6g}".format
    with open(path, "a" if append else "w", newline="") as fh:
        csv.writer(fh).writerows(
            [*map(fmt, np.asarray(seq, np.float64).tolist()), fmt(float(src))]
            for seq, src in zip(sequences, source_concs))


def load_conc_rows(path: str):
    """Returns (sequences: list[np.ndarray], source_concs: np.ndarray)."""
    sequences, sources = [], []
    with open(path, newline="") as fh:
        for row in csv.reader(fh):
            if not row:
                continue
            vals = np.asarray([float(v) for v in row], np.float32)
            sequences.append(vals[:-1])
            sources.append(vals[-1])
    return sequences, np.asarray(sources, np.float32)
