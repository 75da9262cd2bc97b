"""The analytic isotropic plume of one source, in 2-D flight: peak *
exp(-d^2 / (2 sigma^2)) at the agent's grid cell, plus the cell-hashed
turbulence, clipped to [0, peak]; no wind."""

from __future__ import annotations

import torch

from plumebench.reference.prng import cell_of, turbulence


def new_field(u_src, u_wind, bits, env: dict, bank) -> dict:
    """Source uniform in [padding, grid - padding)^2 from ``u_src`` f32[N,
    2]; the turbulence seed ``bits`` i32[N]."""
    lo = env["source_padding"]
    hi = env["grid_size"] - env["source_padding"]
    return {"source": lo + (hi - lo) * u_src, "seed": bits}


def sample(field: dict, pos, t, env: dict, bank):
    """(conc, tke) f32[N] at the cells of ``pos``."""
    ix, iy = cell_of(pos, env["grid_size"])
    dx = ix.to(torch.float32) - field["source"][:, 0]
    dy = iy.to(torch.float32) - field["source"][:, 1]
    d2 = dx * dx + dy * dy
    base = env["conc_peak"] * torch.exp(-d2 / (2.0 * env["plume_sigma"] ** 2))
    turb = turbulence(field["seed"], ix, iy, env)
    return torch.clamp(base + turb, 0.0, env["conc_peak"]), turb


def wind(field: dict, t, env: dict, bank):
    return None
