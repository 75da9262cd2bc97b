"""Plume fields, batched over N episodes (port of
``tpu_plume/fields/analytic.py``: the isotropic and anisotropic analytic
models of one or S sources, in 2-D or 3-D flight, and the gridded model).

    base(ix, iy)  = peak * exp(-((ix-sx)^2 + (iy-sy)^2) / (2 sigma^2))
                    (isotropic), the Gaussian dispersion in the episode's
                    wind (anisotropic), min(peak, sum of each source's
                    strength times its base) for S sources, or the bank row
                    at the agent (gridded)
    turb(ix, iy)  = TI * (|N(0,1)| + 0.3 sin(0.05 ix) cos(0.07 iy) + 0.2 U(0,1))
    conc          = clip(base + turb, 0, peak)
    tke           = turb                      (V1.1+)
    turb normal is signed and tke = |turb|*2  (V1.0)

The turbulence, the extra sources and their strengths are pure functions of
the field's seed, so a field is a primary source, one 32-bit seed, a wind
(anisotropic model) and, for the gridded model, a bank row per episode.  The
analytic sample is the kernel of ``tpu_plume_torch.ops.plume``, whose plain
version holds the models' arithmetic; the gridded sample reads the bank
(``fields.gridded``) and adds the same turbulence, cell-hashed also when the
bank is read between cells, where the whole sample is one launch of the
sample kernel of ``tpu_plume_torch.ops.gather``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from tpu_plume_torch.core.config import EnvConfig
from tpu_plume_torch.core.support import check_env
from tpu_plume_torch.fields.gridded import sample_bank
from tpu_plume_torch.ops import gather, plume


@dataclass
class FieldState:
    """Per-episode plume fields of N envs."""

    source: torch.Tensor   # f32[N, 2] the primary source
    seed: torch.Tensor     # int32[N], the uint32 turbulence seed's bits
    idx: torch.Tensor | None = None    # i32[N] bank row; None off the bank
    # f32[N, 2] advection velocity (grid units per step) of the anisotropic
    # model with a wind speed range above 0; None where the JAX package's
    # wind is zero (``plume.reads_wind``).
    wind: torch.Tensor | None = None


def _need_bank(bank):
    if bank is None:
        raise ValueError('plume_model="gridded" requires a FieldBank')


def wind_from_draws(u_wind: torch.Tensor, cfg: EnvConfig) -> torch.Tensor:
    """Winds f32[N, 2] from uniforms u_wind f32[N, 2]: speed w_lo + (w_hi -
    w_lo) u_wind[:, 0] in the direction 2 pi u_wind[:, 1]
    (``tpu_plume/fields/analytic.py:90-93``)."""
    w_lo, w_hi = cfg.wind_speed_range
    speed = w_lo + (w_hi - w_lo) * u_wind[:, 0]
    theta = 2.0 * math.pi * u_wind[:, 1]
    return speed[:, None] * torch.stack([torch.cos(theta), torch.sin(theta)],
                                        -1)


def new_field_from_draws(u_src: torch.Tensor, u_wind: torch.Tensor | None,
                         bits: torch.Tensor, cfg: EnvConfig,
                         bank=None) -> FieldState:
    """Fresh fields from uniform draws u_src f32[N, 2] in [0, 1), wind
    uniforms u_wind f32[N, 2] (read only where the field has a wind;
    None otherwise) and seeds ``bits`` int32[N]: source ~ U(padding, grid -
    padding)^2, or, for the gridded model, bank row min(floor(u_src[:, 0]
    K), K-1) and its source (``tpu_plume/fields/analytic.py:75-102``)."""
    check_env(cfg)
    wind = None
    if plume.reads_wind(cfg):
        if u_wind is None:
            raise ValueError(f"a field of plume_model={cfg.plume_model!r} "
                             f"with wind_speed_range={cfg.wind_speed_range} "
                             f"needs u_wind draws")
        wind = wind_from_draws(u_wind, cfg)
    if cfg.plume_model == "gridded":
        _need_bank(bank)
        k = bank.conc.shape[0]
        idx = torch.clamp((u_src[:, 0] * k).to(torch.int32), max=k - 1)
        return FieldState(source=bank.source[idx], seed=bits, idx=idx)
    lo = cfg.source_padding
    hi = cfg.grid_size - cfg.source_padding
    return FieldState(source=lo + (hi - lo) * u_src, seed=bits, wind=wind)


def sample_conc_tke(field: FieldState, pos: torch.Tensor, cfg: EnvConfig,
                    bank=None, t: torch.Tensor | None = None):
    """Concentration and TKE f32[N] at positions f32[N, pos_dim].

    Analytic: the CUDA kernel on the card, its plain version on the CPU, at
    the grid cell (and, in 3-D flight, the height pos[:, 2]).  Gridded: the
    bank row at env step ``t`` (and height pos[:, 2] in 3-D flight), at the
    grid cell, or, with ``cfg.subcell_sampling``, at the float position:
    one launch of the sample kernel on the card, its plain version on the
    CPU."""
    if cfg.plume_model != "gridded":
        return plume.sample_plume(pos, field.source, field.seed, cfg,
                                  field.wind)
    _need_bank(bank)
    if cfg.subcell_sampling:
        return gather.sample_bank_conc_tke(bank, field.idx, pos, t,
                                           field.seed, cfg)
    ix, iy = plume.cell_of(pos[:, :2], cfg.grid_size)
    z = pos[:, 2] if cfg.env_3d else None
    base = sample_bank(bank, field.idx, ix, iy, t, z)
    turb = plume.turbulence(field.seed, ix, iy, cfg)
    conc = torch.clamp(base + turb, 0.0, cfg.conc_peak)
    tke = torch.abs(turb) * 2.0 if cfg.tke_abs_times_two else turb
    return conc, tke
