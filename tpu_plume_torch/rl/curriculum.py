"""Curriculum controller as a host-side state transition (port of
``tpu_plume/rl/curriculum.py``).

A success window of ``window_size`` episodes; when it fills, (a) the
exploration bonus decays by decay^(1 + success_rate) with a floor, (b) the
goal radius shrinks by radius_decay^(2 + 3 (rate - 0.6)) when rate > 0.6 or
expands by 1.1x when rate < 0.25, (c) an anti-oscillation clamp limits each
radius move to +-5, and the window restarts.  With N envs finishing
episodes together, an iteration can complete many windows, so the
transition fires ``count // window_size`` times, each at the aggregate rate;
the remainder carries over with proportional successes.

The state is a handful of scalars, kept on the host in float32 numpy so the
arithmetic is the JAX package's float32 arithmetic; the counts come from one
device-to-host read per iteration.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from tpu_plume_torch.core.config import CurriculumConfig

_f32 = np.float32


@dataclass
class CurriculumState:
    radius: np.float32          # current goal radius
    explore_bonus: np.float32   # current exploration bonus
    success_count: int          # successes in the open window
    episode_count: int          # episodes in the open window
    num_updates: int            # windows closed so far (diagnostics)


def curriculum_init(cfg: CurriculumConfig,
                    explore_bonus_init: float) -> CurriculumState:
    return CurriculumState(_f32(cfg.initial_radius), _f32(explore_bonus_init),
                           0, 0, 0)


def _carry_over(count: int, n_fires: int, rate: np.float32,
                cfg: CurriculumConfig):
    """(success_count, episode_count) of the window left open."""
    rem_count = count - n_fires * cfg.window_size
    rem_succ = int(np.round(rate * _f32(rem_count)))
    return rem_succ, rem_count


def curriculum_update(state: CurriculumState, new_successes: int,
                      new_episodes: int,
                      cfg: CurriculumConfig) -> CurriculumState:
    if cfg.variant == "simple":
        return _curriculum_update_simple(state, new_successes, new_episodes,
                                         cfg)
    succ = state.success_count + int(new_successes)
    count = state.episode_count + int(new_episodes)
    rate = _f32(succ) / max(_f32(count), _f32(1.0))
    n_fires = count // cfg.window_size

    radius, bonus = state.radius, state.explore_bonus
    for _ in range(n_fires):
        # (a) exploration-bonus decay.
        bonus = max(bonus * _f32(cfg.explore_decay_factor) ** (_f32(1.0) + rate),
                    _f32(cfg.explore_bonus_floor))
        # (b) radius shrink / expand.
        if rate > cfg.success_threshold:
            shrink = radius * _f32(cfg.radius_decay) ** (
                _f32(2.0) + _f32(3.0) * (rate - _f32(cfg.success_threshold)))
            new_radius = max(_f32(cfg.min_radius), shrink)
        elif rate < cfg.expand_below:
            new_radius = min(_f32(cfg.initial_radius),
                             radius * _f32(cfg.expand_rate))
        else:
            new_radius = radius
        # (c) anti-oscillation clamp against the radius the window ran at.
        delta = new_radius - radius
        if abs(delta) > cfg.anti_oscillation_clamp:
            new_radius = radius + _f32(cfg.anti_oscillation_clamp) * np.sign(delta)
        radius = _f32(new_radius)

    if n_fires > 0:
        succ, count = _carry_over(count, n_fires, rate, cfg)
    return CurriculumState(_f32(radius), _f32(bonus), succ, count,
                           state.num_updates + n_fires)


def _curriculum_update_simple(state: CurriculumState, new_successes: int,
                              new_episodes: int,
                              cfg: CurriculumConfig) -> CurriculumState:
    """PPOV1.0 controller: the explore bonus decays every episode (batched:
    decay^new_episodes); the radius only shrinks, by radius_decay per closed
    window whose success rate exceeds the threshold."""
    succ = state.success_count + int(new_successes)
    count = state.episode_count + int(new_episodes)
    n_fires = count // cfg.window_size
    rate = _f32(succ) / max(_f32(count), _f32(1.0))

    bonus = max(state.explore_bonus
                * _f32(cfg.explore_decay_factor) ** _f32(new_episodes),
                _f32(cfg.explore_bonus_floor))
    shrinks = n_fires if rate > cfg.success_threshold else 0
    radius = max(_f32(cfg.min_radius),
                 state.radius * _f32(cfg.radius_decay) ** _f32(shrinks))
    if n_fires > 0:
        succ, count = _carry_over(count, n_fires, rate, cfg)
    return CurriculumState(_f32(radius), _f32(bonus), succ, count,
                           state.num_updates + shrinks)
