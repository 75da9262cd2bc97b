"""The per-cell hash draws of the field's turbulence: a counter-based
32-bit hash of (field seed, ix, iy, salt), computed in int64 holding values
in [0, 2^32) and masked to 32 bits after every multiply and add (a multiply
split into 16-bit halves of the constant, so no product overflows)."""

from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF
_M1 = 0x7FEB352D
_M2 = 0x846CA68B
_C1 = 0x9E3779B9
_C2 = 0x85EBCA6B
_C3 = 0xC2B2AE35
_TWO_PI = 6.283185307179586
_INV_2_24 = 1.0 / (1 << 24)

SALT_NORMAL = 0   # and 1: Box-Muller's two uniforms
SALT_UNIFORM = 2


def as_u32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int64) & MASK32


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    lo = a * (c & 0xFFFF)
    hi = ((a * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK32


def _avalanche(h: torch.Tensor) -> torch.Tensor:
    h = h ^ (h >> 16)
    h = _mul32(h, _M1)
    h = h ^ (h >> 15)
    h = _mul32(h, _M2)
    return h ^ (h >> 16)


def hash_cell(seed, ix, iy, salt: int) -> torch.Tensor:
    seed = as_u32(seed)
    h = seed ^ _mul32(as_u32(ix), _C1) ^ _mul32(as_u32(iy), _C2)
    h = h ^ ((salt * _C3) & MASK32)
    h = _avalanche(h)
    return _avalanche((h + seed) & MASK32)


def cell_uniform(seed, ix, iy, salt: int) -> torch.Tensor:
    """Uniform in [0, 1) from the hash's top 24 bits."""
    return (hash_cell(seed, ix, iy, salt) >> 8).to(torch.float32) * _INV_2_24


def cell_normal(seed, ix, iy, salt: int) -> torch.Tensor:
    """Box-Muller normal from the uniforms of ``salt`` and ``salt + 1``."""
    u1 = torch.clamp(cell_uniform(seed, ix, iy, salt), min=1e-7)
    u2 = cell_uniform(seed, ix, iy, salt + 1)
    return torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(_TWO_PI * u2)


def cell_of(pos: torch.Tensor, grid: int):
    """Integer cell (ix, iy) of positions f32[N, >= 2]."""
    ij = torch.clamp(torch.floor(pos[:, :2]).to(torch.int32), 0, grid - 1)
    return ij[:, 0], ij[:, 1]


def turbulence(seed, ix, iy, env: dict) -> torch.Tensor:
    """TI * (|N| + 0.3 sin(0.05 ix) cos(0.07 iy) + 0.2 U) at integer cells
    (the V1.1+ form: the normal's magnitude)."""
    fx = ix.to(torch.float32)
    fy = iy.to(torch.float32)
    n = torch.abs(cell_normal(seed, ix, iy, SALT_NORMAL))
    u = cell_uniform(seed, ix, iy, SALT_UNIFORM)
    wave = 0.3 * torch.sin(0.05 * fx) * torch.cos(0.07 * fy)
    return env["turbulence_intensity"] * (n + wave + 0.2 * u)
