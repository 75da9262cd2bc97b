"""Stateless procedural randomness for field evaluation (port of
``tpu_plume/core/prng.py``).

The turbulence is a pure function of ``(field_seed, ix, iy)`` through a
counter-based 32-bit hash.  PyTorch has no ``>>`` for uint32 on the CPU, so
this plain version computes in int64 holding values in [0, 2^32) and masks
to 32 bits after every multiply and add.  A multiply is split into 16-bit
halves of the constant so no int64 product overflows.  The bits are equal to
the JAX package's; ``tpu_plume_torch/csrc/plume.cu`` does the same arithmetic
in native ``uint32_t``.

Seeds may arrive as int32 holding the uint32 bit pattern (how the env
stores them) or as int64 in [0, 2^32); both are widened to the latter.
"""

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


def as_u32(x: torch.Tensor) -> torch.Tensor:
    """Integer tensor -> int64 holding its low 32 bits in [0, 2^32)."""
    return x.to(torch.int64) & MASK32


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a * c) mod 2^32 for ``a`` in [0, 2^32) and a 32-bit constant ``c``."""
    lo = a * (c & 0xFFFF)
    hi = ((a * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK32


def _avalanche(h: torch.Tensor) -> torch.Tensor:
    """Full-avalanche 32-bit mix (lowbias32 variant)."""
    h = h ^ (h >> 16)
    h = _mul32(h, _M1)
    h = h ^ (h >> 15)
    h = _mul32(h, _M2)
    h = h ^ (h >> 16)
    return h


def hash_cell(seed: torch.Tensor, ix: torch.Tensor, iy: torch.Tensor,
              salt: int) -> torch.Tensor:
    """Hash (seed, ix, iy, salt) -> int64 bits in [0, 2^32). Broadcasts."""
    seed = as_u32(seed)
    h = seed ^ _mul32(as_u32(ix), _C1) ^ _mul32(as_u32(iy), _C2)
    h = h ^ ((salt * _C3) & MASK32)
    h = _avalanche(h)
    # Second round, re-salted with the seed, to decorrelate structured inputs.
    return _avalanche((h + seed) & MASK32)


def bits_to_uniform(bits: torch.Tensor) -> torch.Tensor:
    """32-bit hash -> float32 uniform in [0, 1) from the top 24 bits."""
    return (bits >> 8).to(torch.float32) * _INV_2_24


def cell_uniform(seed, ix, iy, salt: int) -> torch.Tensor:
    return bits_to_uniform(hash_cell(seed, ix, iy, salt))


def cell_normal(seed, ix, iy, salt: int) -> torch.Tensor:
    """Standard normal via Box-Muller from two independent uniforms."""
    u1 = cell_uniform(seed, ix, iy, salt)
    u2 = cell_uniform(seed, ix, iy, salt + 1)
    u1 = torch.clamp(u1, min=1e-7)
    r = torch.sqrt(-2.0 * torch.log(u1))
    return r * torch.cos(_TWO_PI * u2)
