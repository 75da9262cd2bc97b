"""MethaneEnv over a batch of N envs (port of ``tpu_plume/env/methane.py``:
the analytic isotropic or anisotropic plume of one or S sources, and gridded
banks, in 2-D or 3-D flight).

    reset_from_draws(u_src, u_wind, bits, cfg, radius, explore_bonus, bank) -> (EnvState, obs)
    step_noise(state, action, turb_noise, cfg, bank)                -> (EnvState, Transition)
    auto_reset_from_draws(state, obs, done, u_src, u_wind, bits, cfg, bank) -> (EnvState, obs)

Every tensor carries the env axis first.  The functions return new states
and do not modify their inputs.  ``bank`` is the ``FieldBank`` of
``plume_model="gridded"`` (None otherwise).  Observation layout, all
nominally in [0, 1]: [x/G, y/G, conc/peak, tke/(3*TI), t/max_steps,
explore_level], with z/domain_height after (x, y) in 3-D flight (``env_3d``),
plus [dconc/peak, one-hot(prev action)] with ``obs_memory``.  3-D flight
adds +z and -z actions of ``z_move_step``; success stays a horizontal gate,
at the nearest source of a multi-source field.  ``u_wind`` holds the wind
uniforms of the fields that have a wind (``ops.plume.reads_wind``), and may
be None for the others.

The visit grid is read and written by direct indexing at each env's explore
cell; the JAX package uses one-hot masks there, with the same counts.
"""

from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass

import torch

from tpu_plume_torch.core.config import EnvConfig
from tpu_plume_torch.core.support import check_env
from tpu_plume_torch.fields.analytic import (
    FieldState,
    new_field_from_draws,
    sample_conc_tke,
)
from tpu_plume_torch.fields.gridded import bank_wind
from tpu_plume_torch.ops import plume


@dataclass
class EnvState:
    pos: torch.Tensor            # f32[N, pos_dim] agent position
    t: torch.Tensor              # i32[N] step count within episode
    visited: torch.Tensor        # i32[N, D, D] per-cell visit counts
    field: FieldState            # per-episode plume
    radius: torch.Tensor         # f32[N] curriculum success radius
    explore_bonus: torch.Tensor  # f32[N] curriculum exploration bonus
    # Field sample at the current cell (the field is deterministic, so the
    # cache is exact) and the one-step memory of obs_memory.
    conc: torch.Tensor           # f32[N]
    tke: torch.Tensor            # f32[N]
    prev_conc: torch.Tensor      # f32[N] concentration before the last move
    prev_action: torch.Tensor    # i64[N] last action taken

    def replace(self, **kw) -> "EnvState":
        return dataclasses.replace(self, **kw)


@dataclass
class RewardInfo:
    """Per-step reward decomposition plus terminal diagnostics, each [N]."""

    concentration_reward: torch.Tensor
    explore_reward: torch.Tensor
    move_penalty: torch.Tensor
    tke_penalty: torch.Tensor
    boundary_penalty: torch.Tensor
    reached: torch.Tensor        # bool: within curriculum radius this step
    distance: torch.Tensor       # distance to source after the move
    conc_raw: torch.Tensor       # unnormalized concentration at the new cell


@dataclass
class Transition:
    obs: torch.Tensor            # f32[N, obs_dim] observation after the step
    reward: torch.Tensor         # f32[N] total shaped reward
    done: torch.Tensor           # bool[N] reached or max_steps
    info: RewardInfo


def select(mask: torch.Tensor, a, b):
    """Per-env ``where(mask, a, b)`` over tensors or (nested) dataclasses of
    tensors whose first axis is the env axis; a field None in both stays
    None."""
    if a is None and b is None:
        return None
    if dataclasses.is_dataclass(a):
        return type(a)(**{f.name: select(mask, getattr(a, f.name),
                                         getattr(b, f.name))
                          for f in dataclasses.fields(a)})
    m = mask.reshape(mask.shape + (1,) * (a.dim() - 1))
    return torch.where(m, a, b)


def _explore_index(pos: torch.Tensor, cfg: EnvConfig):
    """(env rows, cx, cy) indexing each env's explore cell in the visit grid."""
    c = torch.clamp(torch.floor(pos / cfg.cell_size).to(torch.int64), 0,
                    cfg.grid_divisions - 1)
    rows = torch.arange(pos.shape[0], device=pos.device)
    return rows, c[:, 0], c[:, 1]


@functools.lru_cache(maxsize=16)
def _action_table(move_step: float, z_move_step: float | None,
                  device: torch.device) -> torch.Tensor:
    """stay / +y / -y / +x / -x, and +z / -z in 3-D flight (``z_move_step``
    not None)."""
    m = move_step
    rows = [[0.0, 0.0], [0.0, m], [0.0, -m], [m, 0.0], [-m, 0.0]]
    if z_move_step is not None:
        zm = z_move_step
        rows = [r + [0.0] for r in rows] + [[0.0, 0.0, zm], [0.0, 0.0, -zm]]
    return torch.tensor(rows, dtype=torch.float32, device=device)


def action_table(cfg: EnvConfig, device) -> torch.Tensor:
    """f32[num_actions, pos_dim] displacement of each action."""
    return _action_table(cfg.move_step,
                         cfg.z_move_step if cfg.env_3d else None,
                         torch.device(device))


def observe(state: EnvState, cfg: EnvConfig) -> torch.Tensor:
    rows, cx, cy = _explore_index(state.pos, cfg)
    visits = state.visited[rows, cx, cy].to(torch.float32)
    explore_level = torch.clamp(visits / cfg.explore_visit_norm, max=1.0)
    parts = [state.pos[:, 0] / cfg.grid_size, state.pos[:, 1] / cfg.grid_size]
    if cfg.env_3d:
        parts.append(state.pos[:, 2] / cfg.domain_height)
    obs = torch.stack(parts + [
        state.conc / cfg.conc_peak,
        state.tke / (cfg.turbulence_intensity * 3.0),
        state.t.to(torch.float32) / cfg.max_steps,
        explore_level,
    ], dim=-1)
    if cfg.obs_memory:
        delta = (state.conc - state.prev_conc) / cfg.conc_peak
        prev_oh = torch.nn.functional.one_hot(
            state.prev_action, cfg.num_actions).to(torch.float32)
        obs = torch.cat([obs, delta[:, None], prev_oh], dim=-1)
    return obs


def _fresh_state(field: FieldState, radius, explore_bonus, cfg: EnvConfig,
                 bank) -> EnvState:
    n = field.seed.shape[0]
    dev = field.seed.device
    pos = torch.zeros(n, cfg.pos_dim, dtype=torch.float32, device=dev)
    t = torch.zeros(n, dtype=torch.int32, device=dev)
    conc0, tke0 = sample_conc_tke(field, pos, cfg, bank, t)
    d = cfg.grid_divisions
    return EnvState(
        pos=pos,
        t=t,
        visited=torch.zeros(n, d, d, dtype=torch.int32, device=dev),
        field=field,
        radius=radius,
        explore_bonus=explore_bonus,
        conc=conc0,
        tke=tke0,
        prev_conc=conc0,
        prev_action=torch.zeros(n, dtype=torch.int64, device=dev),
    )


def reset_from_draws(u_src: torch.Tensor, u_wind: torch.Tensor | None,
                     bits: torch.Tensor, cfg: EnvConfig,
                     radius: float | None = None,
                     explore_bonus: float | None = None, bank=None):
    """Fresh episodes for N envs from uniform draws u_src f32[N, 2], wind
    uniforms u_wind f32[N, 2] (or None) and seeds ``bits`` int32[N]: new
    source, wind and field (or bank row), agent at the origin, cleared
    visit grid."""
    check_env(cfg)
    n, dev = bits.shape[0], bits.device
    radius = cfg.initial_radius if radius is None else radius
    explore_bonus = (cfg.explore_bonus_init if explore_bonus is None
                     else explore_bonus)
    state = _fresh_state(
        new_field_from_draws(u_src, u_wind, bits, cfg, bank),
        torch.full((n,), radius, dtype=torch.float32, device=dev),
        torch.full((n,), explore_bonus, dtype=torch.float32, device=dev),
        cfg, bank,
    )
    return state, observe(state, cfg)


def step_noise(state: EnvState, action: torch.Tensor, turb_noise: torch.Tensor,
               cfg: EnvConfig, bank=None):
    """One step of every env with its turbulence-displacement normals
    turb_noise f32[N, pos_dim] given by the caller."""
    check_env(cfg)
    if cfg.elastic_walls and cfg.env_3d:
        raise ValueError("elastic_walls (v1_0) is a 2-D-only reward variant")
    g = float(cfg.grid_size)
    move_step = cfg.move_step
    tke_norm = cfg.turbulence_intensity * 3.0
    t_new = state.t + 1

    # Concentration before the move: the cached sample at the old cell.
    prev_conc, prev_tke = state.conc, state.tke
    prev_conc_n = prev_conc / cfg.conc_peak

    table = action_table(cfg, state.pos.device)
    delta = table[action]
    delta_norm = torch.sqrt((delta * delta).sum(-1))
    if cfg.reward_variant == "v1_0":
        move_penalty = torch.full_like(delta_norm, -cfg.v10_flat_move_penalty)
    elif cfg.env_3d:
        # vertical steps are full moves despite the smaller step size
        moved = (delta_norm > 0.0).to(torch.float32)
        move_penalty = -cfg.move_penalty_coef * (1.0 - moved)
    else:
        move_penalty = -cfg.move_penalty_coef * (1.0 - delta_norm / move_step)

    # Stochastic turbulence displacement from TKE at the old cell.
    turb_eff = (move_step * cfg.turb_displacement_coef * turb_noise
                * prev_tke[:, None] / tke_norm)
    raw = state.pos + delta + turb_eff
    # Horizontal advection by the bank's wind or the field's; a field
    # without wind (None) has a zero wind, which adds nothing.
    if cfg.wind_advect_coef:
        if cfg.plume_model == "gridded":
            wind = bank_wind(bank, state.field.idx, t_new)
        else:
            wind = state.field.wind
        if wind is not None:
            advect = cfg.wind_advect_coef * wind
            if cfg.env_3d:
                advect = torch.cat([advect, torch.zeros_like(advect[:, :1])],
                                   -1)
            raw = raw + advect

    if cfg.elastic_walls:
        # V1.0 bounce-back walls: clip to a 10% margin, then revert the whole
        # move if any coordinate left the domain.
        cand = torch.clamp(raw, -0.1 * g, 1.1 * g)
        out = ((cand < 0.0) | (cand > g)).any(-1)
        new_pos = torch.where(out[:, None], state.pos, cand)
    elif cfg.env_3d:
        new_pos = torch.cat([
            torch.clamp(raw[:, :2], 0.0, g - cfg.clip_edge_eps),
            torch.clamp(raw[:, 2:], 0.0, cfg.domain_height)], -1)
    else:
        new_pos = torch.clamp(raw, 0.0, g - cfg.clip_edge_eps)

    cur_conc, cur_tke = sample_conc_tke(state.field, new_pos, cfg, bank, t_new)
    cur_conc_n = cur_conc / cfg.conc_peak
    border_units = torch.minimum(
        torch.minimum(new_pos[:, 0], g - new_pos[:, 0]),
        torch.minimum(new_pos[:, 1], g - new_pos[:, 1]),
    )
    zero = torch.zeros_like(border_units)
    if cfg.reward_variant == "v1_0":
        boundary_penalty = torch.where(
            border_units < cfg.v10_boundary_margin_frac * g,
            torch.full_like(zero, -cfg.v10_boundary_penalty), zero)
    else:
        conc_gradient = (cur_conc_n - prev_conc_n) / (delta_norm + 1e-6)
        boundary_dist = border_units / g
        boundary_penalty = torch.where(
            (boundary_dist < cfg.boundary_decay_start)
            & (conc_gradient < cfg.boundary_gradient_gate),
            -cfg.boundary_penalty
            * (cfg.boundary_decay_start - boundary_dist) ** 2,
            zero,
        )

    # Exploration bookkeeping at the new cell: the visit is counted first,
    # then explore_level and the attenuation read the post-increment count.
    rows, cx, cy = _explore_index(new_pos, cfg)
    visited = state.visited.clone()
    visited[rows, cx, cy] += 1
    visits = visited[rows, cx, cy].to(torch.float32)
    explore_level = torch.clamp(visits / cfg.explore_visit_norm, max=1.0)
    if cfg.reward_variant == "v1_0":
        explore_reward = state.explore_bonus / (visits + 1.0)
    else:
        explore_reward = (state.explore_bonus * (1.0 - explore_level)
                          / (visits ** cfg.explore_visit_pow + 1.0))

    new_state = state.replace(
        pos=new_pos, t=t_new, visited=visited, conc=cur_conc, tke=cur_tke,
        prev_conc=prev_conc, prev_action=action,
    )
    obs = observe(new_state, cfg)

    tke_n = cur_tke / tke_norm
    if cfg.reward_variant == "delta":
        # README reward R = dCH4 - 0.2 |dtheta|: the concentration change,
        # and a heading-change penalty (1 - cos dtheta)/2 on the move term.
        conc_reward = cfg.conc_reward_coef * (cur_conc_n - prev_conc_n)
        if cfg.inplume_bonus > 0.0:
            conc_reward = conc_reward + cfg.inplume_bonus * (
                cur_conc_n >= cfg.inplume_conc_floor).to(torch.float32)
        d_prev = table[state.prev_action]
        dot = (d_prev * delta).sum(-1)
        norms = torch.sqrt((d_prev * d_prev).sum(-1)) * delta_norm
        cos = torch.where(norms > 0.0, dot / torch.clamp(norms, min=1e-6),
                          torch.ones_like(norms))
        move_penalty = move_penalty - cfg.readme_turn_penalty * 0.5 * (1.0 - cos)
    else:
        conc_reward = cfg.conc_reward_coef * cur_conc_n
    tke_penalty = -cfg.tke_penalty_factor * tke_n
    total_reward = (conc_reward + explore_reward + move_penalty + tke_penalty
                    + boundary_penalty)

    # Terminal bonus within the (horizontal) curriculum radius of the
    # nearest source: min(500, 150 R0/R), or the uncapped 100 R0/R of V1.0,
    # plus the optional depth and gate terms.
    if cfg.num_sources > 1:
        d = new_pos[:, None, :2] - plume.all_sources(
            state.field.source, state.field.seed, cfg)
        distance = torch.sqrt((d * d).sum(-1)).amin(-1)
    else:
        d = new_pos[:, :2] - state.field.source
        distance = torch.sqrt((d * d).sum(-1))
    reached = distance <= state.radius
    if cfg.reward_variant == "v1_0":
        terminal_bonus = 100.0 * (cfg.initial_radius / state.radius)
    else:
        terminal_bonus = torch.clamp(
            cfg.terminal_bonus_coef * (cfg.initial_radius / state.radius),
            max=cfg.terminal_bonus_cap)
    if cfg.terminal_depth_coef:
        depth = torch.clamp(state.radius - distance, min=0.0) / state.radius
        if cfg.terminal_depth_power != 1.0:
            depth = depth ** cfg.terminal_depth_power
        terminal_bonus = terminal_bonus + cfg.terminal_depth_coef * depth
    if cfg.terminal_gate_radius:
        terminal_bonus = terminal_bonus * (
            distance <= cfg.terminal_gate_radius).to(torch.float32)
    total_reward = total_reward + torch.where(reached, terminal_bonus, zero)

    done = (t_new >= cfg.max_steps) | reached
    info = RewardInfo(
        concentration_reward=conc_reward,
        explore_reward=explore_reward,
        move_penalty=move_penalty,
        tke_penalty=tke_penalty,
        boundary_penalty=boundary_penalty,
        reached=reached,
        distance=distance,
        conc_raw=cur_conc,
    )
    return new_state, Transition(obs=obs, reward=total_reward, done=done,
                                 info=info)


def auto_reset_from_draws(state: EnvState, obs: torch.Tensor,
                          done: torch.Tensor, u_src: torch.Tensor,
                          u_wind: torch.Tensor | None, bits: torch.Tensor,
                          cfg: EnvConfig, bank=None):
    """Swap a fresh episode (from the draws) into every env where ``done``,
    carrying the curriculum values; ``obs`` is the post-step observation."""
    fresh = _fresh_state(new_field_from_draws(u_src, u_wind, bits, cfg, bank),
                         state.radius, state.explore_bonus, cfg, bank)
    fresh_obs = observe(fresh, cfg)
    return select(done, fresh, state), select(done, fresh_obs, obs)
