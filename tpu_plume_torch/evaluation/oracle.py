"""Scripted oracle policies over N episodes (port of
``tpu_plume/evaluation/oracle.py``).

The privileged teachers (``naive``, ``look1``, ``phase``) read each
episode's true source; ``raster`` reads only the agent's own position and
step count.  JAX writes one episode and vmaps it; here each oracle steps
the batch: ``fn(env_state) -> i64[N]`` from the episode-first
``EnvState``, with no host read, so it replaces the policy's forward in
``evaluate_policy(oracle=)`` and ``generate_expert_data(oracle=)``.  Ties
go to the first action, as ``jnp.argmin`` / ``jnp.argmax`` give them.
"""

from __future__ import annotations

import torch

from tpu_plume_torch.core.config import EnvConfig
from tpu_plume_torch.env.methane import action_table
from tpu_plume_torch.evaluation.guidance import norm2

ORACLE_KINDS = ("naive", "look1", "phase", "raster")


def staircase(to: torch.Tensor) -> torch.Tensor:
    """i64[N]: the move along the larger |component| of ``to`` [N, 2]
    (the x move where they tie)."""
    return torch.where(
        torch.abs(to[:, 0]) >= torch.abs(to[:, 1]),
        torch.where(to[:, 0] > 0, 3, 4),
        torch.where(to[:, 1] > 0, 1, 2))


def make_oracle(
    kind: str,
    cfg: EnvConfig,
    *,
    terminate_radius: float | None = None,
    success_radius: float = 40.0,
    target_depth: float = 31.0,
    raster_band_scale: float = 1.12,
):
    """``fn(env_state) -> i64[N]`` of one oracle policy (JAX's
    ``make_oracle``, whose docstring gives each kind's rule):

    naive  -- the staircase toward the source;
    look1  -- a deep landing (closest to ``target_depth``) where one
              exists, else the staircase;
    phase  -- look1, else the non-crossing move whose next step can land
              deepest;
    raster -- the non-privileged boustrophedon surveyor, descending first.

    ``terminate_radius=None`` reads each episode's ``state.radius``, with
    the success radius and target depth at 0.8x and 0.62x of it; explicit
    values pin the geometry.  The z component of 3-D flight is ignored."""
    if kind not in ORACLE_KINDS:
        raise ValueError(f"unknown oracle {kind!r}; pick from {ORACLE_KINDS}")
    m = float(cfg.move_step)
    dynamic = terminate_radius is None

    def geometry(state):
        if dynamic:
            tr = state.radius[:, None]
            return tr, 0.8 * tr, 0.62 * tr
        return terminate_radius, success_radius, target_depth

    if kind == "raster":
        g = float(cfg.grid_size)
        band_h = raster_band_scale * float(cfg.plume_sigma)
        # the first grid/move steps descend, anchoring the serpentine at 0
        t_desc = int(g / m)

        def act_raster(state) -> torch.Tensor:
            x, y = state.pos[:, 0], state.pos[:, 1]
            band = torch.floor(y / band_h).to(torch.int32)
            going_right = band % 2 == 0
            turn = torch.where(going_right, x >= g - 1.2 * m, x <= 1.2 * m)
            sweep = torch.where(turn, 1, torch.where(going_right, 3, 4))
            return torch.where(state.t < t_desc, 2, sweep).to(torch.int64)

        return act_raster

    def act(state) -> torch.Tensor:
        pos = state.pos[:, :2]
        src = state.field.source[:, :2]
        stair = staircase(src - pos)
        if kind == "naive":
            return stair
        tr, success_r, target_d = geometry(state)
        deltas = action_table(cfg, pos.device)[:5, :2]   # the plane's moves
        land = pos[:, None, :] + deltas[None]                  # [N, 5, 2]
        ld = norm2(land - src[:, None, :])                     # [N, 5]
        crossing = ld <= tr
        deep = crossing & (ld <= success_r)
        a_deep = torch.argmin(torch.where(deep, torch.abs(ld - target_d),
                                          1e9), dim=-1)
        any_deep = deep.any(-1)
        if kind == "look1":
            return torch.where(any_deep, a_deep, stair)
        # phase: the non-crossing move whose next step lands nearest the
        # target depth; without a next-step deep landing, close the distance
        ld2 = norm2(land[:, :, None, :] + deltas[None, None]
                    - src[:, None, None, :])                   # [N, 5, 5]
        sr2 = success_r[..., None] if dynamic else success_r
        td2 = target_d[..., None] if dynamic else target_d
        deep2 = (ld2 <= sr2) & (ld2 >= m)
        best_next = torch.where(deep2, torch.abs(ld2 - td2), 1e9).amin(-1)
        score = torch.where(deep2.any(-1), -best_next, -100.0 - ld)
        score = torch.where(crossing, -1e18, score)   # never cross shallow
        return torch.where(any_deep, a_deep, torch.argmax(score, dim=-1))

    return act
