"""Learned terminal guidance over N episodes (port of
``tpu_plume/evaluation/learned_guide.py``): the trained
``GaussianParamPredictor`` source localizer runs inside the eval loop and
drives the same crossing-phase controller as the model-fit guide.

  - Each episode carries a chronological window [W, dim] of its own
    normalized (x, y, conc) samples (with ``features="xycd"`` also the
    deltas from the last ingested row), filled front to back, then
    shifted: the zero-tail padding and lengths the localizer was trained
    on (``train_source_lstm``).
  - Every step the localizer reruns on every episode's window (one
    ``nn.LSTM`` call on [N, W, dim], cuDNN on the card); its (mu_x, mu_y)
    is the live estimate.
  - A stability gate: every ``check_every`` steps (from ``min_window``)
    the estimate is compared with the last checked one, and the guide
    steers (``guidance.phase_action``) while they agree to ``stable_tol``
    px.

JAX steps one episode under ``vmap``; here the window is [N, W, dim] and
the other registers [N] or [N, 2], updated with ``torch.where``, with no
host read.  ``derive_learned_guide_config`` and ``load_localizer_meta``
read the localizer's measured validation error from
``localizer_meta.npz``, which ``train_source_lstm`` writes beside
``gaussian_params.pt``.
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass

import numpy as np
import torch

from tpu_plume_torch.core.config import EnvConfig
from tpu_plume_torch.evaluation.guidance import norm2, phase_action


@dataclass
class LearnedGuideState:
    window: torch.Tensor    # f32[N, W, dim] chronological normalized rows
    count: torch.Tensor     # i32[N] samples ingested
    est: torch.Tensor       # f32[N, 2] current localizer output (grid units)
    est_prev: torch.Tensor  # f32[N, 2] estimate at the last stability check
    est_ok: torch.Tensor    # bool[N] stability gate open
    mode: torch.Tensor      # i32[N] 1 while overriding


def derive_learned_guide_config(val_median_err_px: float,
                                window: int = 64) -> dict:
    """The stability gate from the localizer's measured validation error
    (JAX's rule): ``stable_tol`` 0.6x the median error clamped to [4, 32]
    px, ``check_every`` ``window // 16`` (at least 2) and ``min_window``
    ``window // 8`` (at least 8)."""
    return {
        "stable_tol": float(np.clip(0.6 * val_median_err_px, 4.0, 32.0)),
        "check_every": max(2, window // 16),
        "min_window": max(8, window // 8),
    }


def load_localizer_meta(ckpt_dir: str) -> dict | None:
    """``localizer_meta.npz`` beside a localizer checkpoint: in
    ``ckpt_dir`` or in its parent (the run dir, or the checkpoint in it);
    None when there is none."""
    for d in (ckpt_dir, os.path.dirname(ckpt_dir.rstrip("/"))):
        p = os.path.join(d, "localizer_meta.npz")
        if os.path.exists(p):
            with np.load(p) as z:
                return {k: z[k].item() for k in z.files}
    return None


def make_learned_guide(
    cfg: EnvConfig,
    model,
    *,
    window: int = 64,
    min_window: int = 16,
    check_every: int = 8,
    stable_tol: float = 6.0,
    terminate_radius: float = 50.0,
    success_radius: float = 40.0,
    features: str = "xyc",
):
    """``(init_state, step_fn)`` for ``evaluate_policy``'s guide hook,
    ``step_fn(state, pos, conc, policy_action) -> (state', action, gate
    open)``.  ``model(x [N, W, dim], lengths [N]) -> [N, 4]`` is the
    localizer (a ``GaussianParamPredictor`` in eval mode on the eval's
    device), whose input width ``features`` gives (3 for ``xyc``, 6 for
    ``xycd``).  The dive geometry is the model-fit guide's."""
    dim = 6 if features == "xycd" else 3
    deep_target = min(success_radius - 10.0, 0.8 * terminate_radius)
    setup_distance = deep_target + cfg.grid_size * cfg.move_frac - 1.0

    def init() -> LearnedGuideState:
        return LearnedGuideState(
            window=torch.zeros(window, dim, dtype=torch.float32),
            count=torch.zeros((), dtype=torch.int32),
            est=torch.zeros(2, dtype=torch.float32),
            est_prev=torch.full((2,), -1e6, dtype=torch.float32),
            est_ok=torch.zeros((), dtype=torch.bool),
            mode=torch.zeros((), dtype=torch.int32),
        )

    def step(gs: LearnedGuideState, pos, conc, policy_action):
        n, dev = pos.shape[0], pos.device
        feat = torch.stack([pos[:, 0] / cfg.grid_size,
                            pos[:, 1] / cfg.grid_size,
                            conc / cfg.conc_peak], -1).to(torch.float32)
        if dim == 6:
            # deltas from the last ingested row
            prev_idx = torch.clamp(torch.clamp(gs.count, max=window) - 1,
                                   0, window - 1).to(torch.int64)
            prev = gs.window[torch.arange(n, device=dev), prev_idx, :3]
            delta = torch.where((gs.count > 0)[:, None], feat - prev, 0.0)
            feat = torch.cat([feat, delta], -1)
        # chronological insert: front-fill until full, then shift left
        filling = gs.count < window
        idx = torch.clamp(gs.count, max=window - 1)
        slot = torch.arange(window, device=dev)[None] == idx[:, None]
        filled = torch.where(slot[..., None], feat[:, None, :], gs.window)
        shifted = torch.cat([gs.window[:, 1:], feat[:, None, :]], 1)
        win = torch.where(filling[:, None, None], filled, shifted)
        count = gs.count + 1
        length = torch.clamp(count, max=window)

        est = model(win, length)[:, :2] * cfg.grid_size
        do_check = (count % check_every == 0) & (count >= min_window)
        stable = norm2(est - gs.est_prev) <= stable_tol
        est_ok = torch.where(do_check, stable, gs.est_ok)
        est_prev = torch.where(do_check[:, None], est, gs.est_prev)

        g_action = phase_action(pos[:, :2], est, cfg, terminate_radius,
                                deep_target, setup_distance)
        action = torch.where(est_ok, g_action, policy_action).to(
            policy_action.dtype)
        gs = dataclasses.replace(gs, window=win, count=count, est=est,
                                 est_prev=est_prev, est_ok=est_ok,
                                 mode=est_ok.to(torch.int32))
        return gs, action, est_ok

    return init(), step
