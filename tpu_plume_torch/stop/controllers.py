"""Dynamic-stop controllers as state machines over N episodes (port of
``tpu_plume/stop/controllers.py``), usable inside the evaluation loop on
the eval's device.

Three gates, matching the reference's three generations:

  - ``threshold_*``  -- V2.0 ``ThresholdController``
    (PPOV2.0/evaluate_with_lstm.py:10-37): every 10 steps re-predict the
    source concentration from the last-10 window, threshold = prediction *
    0.95; stop once step >= 20 and (current conc >= threshold or window
    mean >= threshold).
  - ``peak_stop_*``  -- V2.1 ``PeakAndStopPredictor`` gate
    (PPOV2.1/evaluate_with_lstm.py:73-81): stop when stop_prob > 0.8 on the
    last-20 conc window / 100.
  - ``heuristic_*``  -- V1.1 ``ModelEvaluator._check_stop_condition``
    (PPOV1.1/evaluate_model.py:25-37): position std over the last 10 steps
    < 2.0 and conc > 0.8 * peak.

``*_init`` returns the state of one episode (tensors without the env
axis), as JAX's does; ``broadcast`` gives each of N episodes its copy on a
device.  ``*_step`` takes the batched state [N, ...], the raw
concentrations f32[N] (and positions f32[N, 2] for the heuristic) and
returns ``(state', stop bool[N])``; JAX's steps one episode and is vmapped.
Predictors are callables over the batch: ``window f32[N, W] ->
prediction f32[N]`` (threshold) or ``-> (peak f32[N], stop_prob f32[N])``
(peak-stop).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from tpu_plume_torch.core.config import EvalConfig, StopConfig
from tpu_plume_torch.core.tree import tree_map


def _push(ring: torch.Tensor, value: torch.Tensor) -> torch.Tensor:
    """Roll each episode's ring [N, W, ...] one slot back and write
    ``value`` [N, ...] into its last slot."""
    return torch.cat([ring[:, 1:], value[:, None]], dim=1)


def broadcast(state, n: int, device):
    """Each of ``n`` episodes' copy of the one-episode ``state`` (a tensor
    or a dataclass of tensors) on ``device``."""
    return tree_map(
        lambda x: x.to(device).expand((n,) + tuple(x.shape)).clone(), state)


# ---------------------------------------------------------------------------
# V2.0 threshold controller
# ---------------------------------------------------------------------------


@dataclass
class ThresholdState:
    window: torch.Tensor         # f32[W] last W raw concentrations
    count: torch.Tensor          # i32 steps observed
    threshold: torch.Tensor      # f32 current threshold
    has_threshold: torch.Tensor  # bool


def threshold_init(cfg: StopConfig) -> ThresholdState:
    return ThresholdState(
        window=torch.zeros(cfg.evaluate_window, dtype=torch.float32),
        count=torch.zeros((), dtype=torch.int32),
        threshold=torch.zeros((), dtype=torch.float32),
        has_threshold=torch.zeros((), dtype=torch.bool),
    )


def threshold_step(state: ThresholdState, conc: torch.Tensor,
                   predict_fn: Callable[[torch.Tensor], torch.Tensor],
                   cfg: StopConfig):
    """``predict_fn`` maps the raw last-W windows f32[N, W] to the
    predicted source concentrations f32[N] (scaling is the predictor's
    business)."""
    window = _push(state.window, conc)
    count = state.count + 1
    # Every 10 steps, once >= max(window, min_activate) steps seen
    # (evaluate_with_lstm.py:19-26, 90-91).
    refresh = (count % cfg.evaluate_window == 0) & (
        count >= max(cfg.evaluate_window, cfg.min_activate_steps))
    pred = predict_fn(window)
    threshold = torch.where(refresh, pred * cfg.threshold_scale,
                            state.threshold)
    has_threshold = state.has_threshold | refresh
    stop = ((count >= cfg.min_activate_steps) & has_threshold
            & ((conc >= threshold) | (window.mean(-1) >= threshold)))
    return ThresholdState(window=window, count=count, threshold=threshold,
                          has_threshold=has_threshold), stop


# ---------------------------------------------------------------------------
# V2.1 peak+stop gate
# ---------------------------------------------------------------------------


@dataclass
class PeakStopState:
    window: torch.Tensor     # f32[W] last W raw concentrations
    count: torch.Tensor      # i32
    peak_pred: torch.Tensor  # f32 latest peak prediction (diagnostic)


def peak_stop_init(cfg: StopConfig) -> PeakStopState:
    return PeakStopState(
        window=torch.zeros(cfg.peak_stop_window, dtype=torch.float32),
        count=torch.zeros((), dtype=torch.int32),
        peak_pred=torch.full((), float("nan"), dtype=torch.float32),
    )


def peak_stop_step(state: PeakStopState, conc: torch.Tensor,
                   predict_fn: Callable, cfg: StopConfig):
    """``predict_fn`` maps the normalized windows f32[N, W] to (peak,
    stop_prob), each f32[N]."""
    window = _push(state.window, conc)
    count = state.count + 1
    peak, stop_prob = predict_fn(window / cfg.conc_norm)
    ready = count >= cfg.peak_stop_window
    stop = ready & (stop_prob > cfg.peak_stop_prob)
    peak_pred = torch.where(ready, peak, state.peak_pred)
    return PeakStopState(window=window, count=count,
                         peak_pred=peak_pred), stop


# ---------------------------------------------------------------------------
# V1.1 heuristic stop
# ---------------------------------------------------------------------------


@dataclass
class HeuristicStopState:
    positions: torch.Tensor  # f32[W, 2] last W positions
    count: torch.Tensor      # i32


def heuristic_stop_init(cfg: EvalConfig) -> HeuristicStopState:
    return HeuristicStopState(
        positions=torch.zeros(cfg.heuristic_position_window, 2,
                              dtype=torch.float32),
        count=torch.zeros((), dtype=torch.int32),
    )


def heuristic_stop_step(state: HeuristicStopState, pos: torch.Tensor,
                        conc: torch.Tensor, conc_peak: float,
                        cfg: EvalConfig):
    """Stability + concentration gate (evaluate_model.py:25-37) on planar
    positions f32[N, 2].

    ``conc`` is the true concentration at the agent's cell.  (The reference
    feeds ``info['concentration_reward'] * CONC_PEAK``, evaluate_model.py:61;
    corrected here as in the JAX package.)  The position std is the
    population std (ddof 0) of each axis over the window, as ``jnp.std``.

    A 3-D position does not fit the planar ring: JAX's gate fails there on
    the broadcast of a 3-vector into a 2-slot row, and this one raises."""
    if pos.shape[-1] != state.positions.shape[-1]:
        raise ValueError(
            f"the heuristic stop gate keeps a ring of planar positions "
            f"[W, {state.positions.shape[-1]}] and cannot take positions "
            f"of width {pos.shape[-1]} (3-D flight); the JAX package's gate "
            f"fails there too, on the broadcast of the position into the "
            f"ring's row")
    positions = _push(state.positions, pos)
    count = state.count + 1
    pos_std = positions.std(dim=1, correction=0).mean(-1)
    ready = count >= cfg.heuristic_position_window
    stop = (ready & (pos_std < cfg.heuristic_stability_threshold)
            & (conc > cfg.heuristic_conc_frac * conc_peak))
    return HeuristicStopState(positions=positions, count=count), stop
