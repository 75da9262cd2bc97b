"""Expert demonstration IO (the port's copy of ``tpu_plume/data/expert.py``):
the reference's ``expert_data.npz`` contract
(PPOV1.1/generate_expert_data.py:54-60; loaded by get_expert_data,
PPOV1.1/model.py:193-198): arrays ``states`` f32[M, obs_dim] and
``actions`` i64[M]."""

from __future__ import annotations

import numpy as np


def save_expert_data(path: str, states: np.ndarray, actions: np.ndarray):
    np.savez(
        path,
        states=np.asarray(states, np.float32),
        actions=np.asarray(actions, np.int64),
    )


def load_expert_data(path: str):
    data = np.load(path)
    return (np.asarray(data["states"], np.float32),
            np.asarray(data["actions"], np.int64))
