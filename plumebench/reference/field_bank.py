"""A time-varying 3-D bank [K, F, Z, G, G] read between cells: trilinear in
(z, x, y) at frames t0 and t0 + 1 of the env step, lerped by the frame
weight, plus the turbulence hashed at the grid cell, clipped to [0, peak];
the per-frame wind lerped the same way.  ``bank`` is the benchmark's
dict of the bank's tensors and scalars (``plumebench.inputs.make_bank``)."""

from __future__ import annotations

import torch

from plumebench.reference.prng import cell_of, turbulence


def new_field(u_src, u_wind, bits, env: dict, bank: dict) -> dict:
    """Bank row min(floor(u_src[:, 0] K), K - 1) and its source; the
    turbulence seed ``bits``."""
    k = bank["conc"].shape[0]
    idx = torch.clamp((u_src[:, 0] * k).to(torch.int32), max=k - 1)
    return {"source": bank["source"][idx], "seed": bits, "idx": idx}


def _frame(bank: dict, t, num_frames: int):
    """(t0 i32, ft f32): the lower frame of env step ``t`` and its weight."""
    tf = t.to(torch.float32)
    tf = tf / torch.full_like(tf, bank["steps_per_frame"])
    t0 = torch.clamp(torch.floor(tf).to(torch.int32), 0, max(num_frames - 2, 0))
    return t0, torch.clamp(tf - t0, 0.0, 1.0)


def _axis(coord, size: int):
    c = torch.clamp(coord, 0.0, size - 1.0)
    c0 = torch.clamp(torch.floor(c).to(torch.int32), 0, max(size - 2, 0))
    return c0, c - c0


def _plane(flat, base, w, fx, fy):
    v00 = flat[base]
    v01 = flat[base + 1]
    v10 = flat[base + w]
    v11 = flat[base + w + 1]
    return (v00 * (1 - fx) * (1 - fy) + v01 * (1 - fx) * fy
            + v10 * fx * (1 - fy) + v11 * fx * fy)


def _trilinear(volumes, rows, zc, x, y):
    """Rows ``rows`` of ``volumes`` [R, Z, H, W] at (zc, x, y) in index
    units, clamped to the grid."""
    _, zd, h, w = volumes.shape
    z0, fz = _axis(zc, zd)
    x0, fx = _axis(x, h)
    y0, fy = _axis(y, w)
    z1 = torch.clamp(z0 + 1, max=zd - 1)
    flat = volumes.reshape(-1)

    def offsets(z):
        return ((rows.to(torch.int64) * zd + z) * h + x0) * w + y0

    p0 = _plane(flat, offsets(z0), w, fx, fy)
    p1 = _plane(flat, offsets(z1), w, fx, fy)
    return p0 * (1 - fz) + p1 * fz


def sample(field: dict, pos, t, env: dict, bank: dict):
    """(conc, tke) f32[N] between cells at ``pos`` f32[N, 3] and env step
    ``t`` i32[N]."""
    conc = bank["conc"]
    k, nf, nz, h, w = conc.shape
    x, y = pos[:, 0], pos[:, 1]
    zc = pos[:, 2] * ((nz - 1) / max(bank["z_extent"], 1e-9))
    volumes = conc.view(k * nf, nz, h, w)
    t0, ft = _frame(bank, t, nf)
    row0 = field["idx"] * nf + t0
    a = _trilinear(volumes, row0, zc, x, y)
    b = _trilinear(volumes, row0 + 1, zc, x, y)
    base = (1.0 - ft) * a + ft * b
    ix, iy = cell_of(pos, env["grid_size"])
    turb = turbulence(field["seed"], ix, iy, env)
    return torch.clamp(base + turb, 0.0, env["conc_peak"]), turb


def wind(field: dict, t, env: dict, bank: dict):
    """The bank's wind f32[N, 2] of each env's row at env step ``t``."""
    w = bank["wind"]
    t0, ft = _frame(bank, t, w.shape[1])
    a = w[field["idx"], t0]
    b = w[field["idx"], torch.clamp(t0 + 1, max=w.shape[1] - 1)]
    return (1.0 - ft[..., None]) * a + ft[..., None] * b
