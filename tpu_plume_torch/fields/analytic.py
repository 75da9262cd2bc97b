"""Analytic methane-plume field, batched over N episodes (port of
``tpu_plume/fields/analytic.py``, isotropic model).

    base(ix, iy)  = peak * exp(-((ix-sx)^2 + (iy-sy)^2) / (2 sigma^2))
    turb(ix, iy)  = TI * (|N(0,1)| + 0.3 sin(0.05 ix) cos(0.07 iy) + 0.2 U(0,1))
    conc          = clip(base + turb, 0, peak)
    tke           = turb                      (V1.1+)
    turb normal is signed and tke = |turb|*2  (V1.0)

The turbulence is a pure function of ``(field seed, ix, iy)``, so a field is
a float source and one 32-bit seed per episode.  The sample itself is the
kernel of ``tpu_plume_torch.ops.plume``.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from tpu_plume_torch.core.config import EnvConfig
from tpu_plume_torch.core.support import check_env
from tpu_plume_torch.ops import plume


@dataclass
class FieldState:
    """Per-episode plume fields of N envs."""

    source: torch.Tensor   # f32[N, 2]
    seed: torch.Tensor     # int32[N], the uint32 turbulence seed's bits


def new_field_from_draws(u_src: torch.Tensor, bits: torch.Tensor,
                         cfg: EnvConfig) -> FieldState:
    """Fresh fields from uniform draws u_src f32[N, 2] in [0, 1) and seeds
    ``bits`` int32[N]: source ~ U(padding, grid - padding)^2."""
    check_env(cfg)
    lo = cfg.source_padding
    hi = cfg.grid_size - cfg.source_padding
    return FieldState(source=lo + (hi - lo) * u_src, seed=bits)


def sample_conc_tke(field: FieldState, pos: torch.Tensor, cfg: EnvConfig):
    """Concentration and TKE f32[N] at the grid cells of positions
    f32[N, 2]: the CUDA kernel on the card, its plain version on the CPU."""
    return plume.sample_plume(pos, field.source, field.seed, cfg)
