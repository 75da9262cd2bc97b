"""The yardstick's arithmetic: the H100's published peaks and the work of
each measured function counted from its shapes and inputs.

Frozen copies, kept here so that a change to the program cannot change
what it is measured against: ``env_step_bytes`` of
``tpu_plume_torch/ops/plume.py``, the corner count of
``tpu_plume_torch/ops/gather.py`` ``sample_moved_bytes``, and
``chip_smoke.py``'s ``ppo_bound`` and operation counts.  Everything here
is plain Python or PyTorch and runs on any device.
"""

from __future__ import annotations

import torch

# Published H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit).
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

# Operations of one plume query, each transcendental counted as one: about
# 12 for the Gaussian base, 69 integer operations for three two-round cell
# hashes, 9 to turn the hashes into uniforms, 8 for Box-Muller, 6 for the
# wave term and 9 for turbulence, clip and TKE.
PLUME_OPS_PER_QUERY = 113
# Operations of one env step beside its plume samples: the action sample,
# the move and its clip, the visit, reward terms, terminal bonus and obs.
ENV_STEP_OPS = 90
# LayerNorm, ReLU and their backward: operations per hidden unit and row.
PPO_ELEMENTWISE_OPS = 22


def env_step_bytes(num_actions: int, pos_dim: int, obs_dim: int,
                   divisions: int, n: int, dones: int) -> int:
    """Bytes one analytic env step of ``n`` envs must move, ``dones`` of
    them finishing, on a field without wind, v1_1 reward, sampled actions:
    each input read and each output written once.  Per env: the logits and
    the Gumbel row, the value, the displacement normals; pos, t, the visit
    cell, source, seed, conc, tke, radius, explore bonus and the six totals
    read; the trajectory row and the record row written; the state and the
    next obs written.  A finished env also reads its reset draws, writes
    its new field and clears its visit grid in place of the visit cell."""
    a, d, p = num_actions, divisions, 4 * pos_dim
    reads = 4 * a * 2 + 4 + p + p + 4 + 4 + 8 + 4 + 4 + 4 + 4 + 4 + 6 * 4
    traj = 8 + 4 + 4 + 4 + 1 + p + 4
    record = 1 + 4 + 6 * 4 + 4 + 8 + 4 + 4
    state = p + 4 + 4 + 4 + 4 + 8 + 6 * 4 + 4 * obs_dim
    per_env = reads + traj + record + state
    return n * per_env + (n - dones) * 4 + dones * (8 + 4 + 8 + 4 + 4 * d * d)


def env_step_ops(n: int, dones: int) -> int:
    """Operations of one analytic isotropic env step: a plume query and the
    step's own work per env, and the reset's plume query per finished env."""
    return n * (PLUME_OPS_PER_QUERY + ENV_STEP_OPS) + dones * PLUME_OPS_PER_QUERY


def least_seconds(nbytes: float, ops: float = 0.0) -> float:
    """The least time the card needs for ``nbytes`` and ``ops``."""
    return max(nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S)


def _axis_lo(coord: torch.Tensor, size: int) -> torch.Tensor:
    c = torch.clamp(coord, 0.0, size - 1.0)
    return torch.clamp(torch.floor(c).to(torch.int64), 0, max(size - 2, 0))


def trilinear_corners(shape, rows: torch.Tensor, z: torch.Tensor,
                      x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """int64 offsets, in a contiguous stack of ``shape`` [R, Z, H, W], of
    the 8 corners a trilinear read at level coordinate ``z`` and cell
    coordinates (x, y) of rows ``rows`` touches (clamped to the grid)."""
    _, zd, h, w = shape
    z0 = _axis_lo(z, zd)
    x0 = _axis_lo(x, h)
    y0 = _axis_lo(y, w)
    out = []
    for zi in (z0, torch.clamp(z0 + 1, max=zd - 1)):
        base = ((rows.to(torch.int64) * zd + zi) * h + x0) * w + y0
        out += [base + dx * w + dy for dx in (0, 1) for dy in (0, 1)]
    return torch.cat(out)


def bank_sample_bytes(bank_shape, steps_per_frame: float, z_extent: float,
                      rows: torch.Tensor, pos: torch.Tensor,
                      t: torch.Tensor) -> int:
    """Bytes one sub-cell sample of a 3-D bank [K, F, Z, H, W] must move at
    least: each query's row, pos (3 floats), t and seed read and its conc
    and tke written once, and each bank cell that the queries' corners
    touch at frames t0 and t0 + 1 read once."""
    k, nf, nz, h, w = bank_shape
    tf = t.to(torch.float32) / torch.full_like(t, steps_per_frame,
                                               dtype=torch.float32)
    t0 = torch.clamp(torch.floor(tf).to(torch.int64), 0, nf - 2)
    zf = pos[:, 2] * ((nz - 1) / max(z_extent, 1e-9))
    row0 = rows.to(torch.int64) * nf + t0
    shape = (k * nf, nz, h, w)
    corners = torch.cat([
        trilinear_corners(shape, r, zf, pos[:, 0], pos[:, 1])
        for r in (row0, row0 + 1)])
    n = pos.shape[0]
    return n * (4 * 3 + 4 * 5) + 4 * torch.unique(corners).numel()


def mlp_macs(obs_dim: int, hidden: list, num_actions: int) -> int:
    """Multiply-adds of one forward row of the policy: obs -> hidden... ->
    {actions, 1}."""
    widths = [obs_dim] + list(hidden)
    macs = sum(a * b for a, b in zip(widths, widths[1:]))
    return macs + widths[-1] * (num_actions + 1)


def lstm_macs(obs_dim: int, embed: int, hidden: int, num_actions: int) -> int:
    """Multiply-adds of one forward row of the recurrent policy, obs E + E
    4H + H 4H + H (A + 1): the encoder, both sides of the four gates and
    the heads (LayerNorms and gate nonlinearities are not products)."""
    e, h = embed, hidden
    return obs_dim * e + e * 4 * h + h * 4 * h + h * (num_actions + 1)


def train_flops(macs_per_row: int, n: int, t: int, epochs: int) -> int:
    """The policy's matmul FLOPs of one training iteration, given its
    multiply-adds per row (the reference policy's ``macs_per_row``): 2 x
    the multiply-adds of the rollout's N x T forward rows and the
    bootstrap's N, and of the update's epochs x N x T rows at 3 forward
    costs (the forward and the backward's two products).  Recompute is not
    counted."""
    rows = n * t + n + 3 * epochs * n * t
    return 2 * macs_per_row * rows


def ppo_bound_seconds(b: int, d: int, h1: int, h2: int, a: int) -> float:
    """Least seconds of one minibatch's PPO gradients of ``b`` rows in f32
    (``chip_smoke.py`` ``ppo_bound``): each product's multiply-adds,
    forward and backward, plus PPO_ELEMENTWISE_OPS per hidden unit and row,
    at the f32 rate; or the batch read once (obs, i64 actions, four f32
    columns) and the params read and their gradients written once."""
    fwd = 2 * (d * h1 + h1 * h2 + h2 * (a + 1))
    bwd = (2 * 2 * h2 * (a + 1) + 2 * 2 * h1 * h2 + 2 * d * h1
           + PPO_ELEMENTWISE_OPS * (h1 + h2))
    ops = b * (fwd + bwd)
    params = d * h1 + 3 * h1 + h1 * h2 + 3 * h2 + (a + 1) * h2 + a + 1
    nbytes = b * (4 * d + 8 + 16) + 2 * 4 * params
    return least_seconds(nbytes, ops)
