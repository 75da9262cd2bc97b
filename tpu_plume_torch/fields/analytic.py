"""Plume fields, batched over N episodes (port of
``tpu_plume/fields/analytic.py``: the isotropic model, the gridded model,
and the single-source anisotropic dispersion the bank synthesizers use).

    base(ix, iy)  = peak * exp(-((ix-sx)^2 + (iy-sy)^2) / (2 sigma^2))
                    (isotropic), or the bank row at the agent (gridded)
    turb(ix, iy)  = TI * (|N(0,1)| + 0.3 sin(0.05 ix) cos(0.07 iy) + 0.2 U(0,1))
    conc          = clip(base + turb, 0, peak)
    tke           = turb                      (V1.1+)
    turb normal is signed and tke = |turb|*2  (V1.0)

The turbulence is a pure function of ``(field seed, ix, iy)``, so a field is
a source, one 32-bit seed and, for the gridded model, a bank row per
episode.  The isotropic sample is the kernel of ``tpu_plume_torch.ops.plume``;
the gridded sample reads the bank (``fields.gridded``) and adds the same
turbulence, cell-hashed also when the bank is read between cells, where
the whole sample is one launch of the sample kernel of
``tpu_plume_torch.ops.gather``.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from tpu_plume_torch.core.config import EnvConfig
from tpu_plume_torch.core.support import check_env, check_sources
from tpu_plume_torch.fields.gridded import sample_bank
from tpu_plume_torch.ops import gather, plume


@dataclass
class FieldState:
    """Per-episode plume fields of N envs."""

    source: torch.Tensor   # f32[N, 2]
    seed: torch.Tensor     # int32[N], the uint32 turbulence seed's bits
    idx: torch.Tensor | None = None   # i32[N] bank row; None off the bank


def _need_bank(bank):
    if bank is None:
        raise ValueError('plume_model="gridded" requires a FieldBank')


def new_field_from_draws(u_src: torch.Tensor, bits: torch.Tensor,
                         cfg: EnvConfig, bank=None) -> FieldState:
    """Fresh fields from uniform draws u_src f32[N, 2] in [0, 1) and seeds
    ``bits`` int32[N]: source ~ U(padding, grid - padding)^2, or, for the
    gridded model, bank row min(floor(u_src[:, 0] K), K-1) and its source."""
    check_env(cfg)
    if cfg.plume_model == "gridded":
        _need_bank(bank)
        k = bank.conc.shape[0]
        idx = torch.clamp((u_src[:, 0] * k).to(torch.int32), max=k - 1)
        return FieldState(source=bank.source[idx], seed=bits, idx=idx)
    lo = cfg.source_padding
    hi = cfg.grid_size - cfg.source_padding
    return FieldState(source=lo + (hi - lo) * u_src, seed=bits)


def sample_conc_tke(field: FieldState, pos: torch.Tensor, cfg: EnvConfig,
                    bank=None, t: torch.Tensor | None = None):
    """Concentration and TKE f32[N] at positions f32[N, pos_dim].

    Isotropic: the CUDA kernel on the card, its plain version on the CPU,
    at the grid cell.  Gridded: the bank row at env step ``t`` (and height
    pos[:, 2] in 3-D flight), at the grid cell, or, with
    ``cfg.subcell_sampling``, at the float position: one launch of the
    sample kernel on the card, its plain version on the CPU."""
    if cfg.plume_model != "gridded":
        return plume.sample_plume(pos, field.source, field.seed, cfg)
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


def anisotropic_base(source: torch.Tensor, wind: torch.Tensor, fx, fy,
                     cfg: EnvConfig, z=None) -> torch.Tensor:
    """Gaussian dispersion of one source f32[2] in wind f32[2] at cells
    (fx, fy) (``_aniso_kernel``, ``tpu_plume/fields/analytic.py:200-223``):
    crosswind spread sigma_y = max(sigma_y_min, 0.3 d^0.71) growing with
    the downwind distance d, the centerline decaying by mass conservation,
    and a compact kernel of sigma_y_min around and upwind of the source.
    With a height ``z`` the plume gains the vertical profile
    exp(-(z - source_z)^2 / (2 sigma_z^2)), sigma_z growing like sigma_y.
    Broadcasts over fx, fy and z."""
    check_sources(cfg)
    r0 = fx - source[0]
    r1 = fy - source[1]
    speed = torch.sqrt(wind[0] * wind[0] + wind[1] * wind[1]) + 1e-8
    u = wind / speed
    downwind = r0 * u[0] + r1 * u[1]
    r2 = r0 ** 2 + r1 ** 2
    cross2 = torch.clamp(r2 - downwind ** 2, min=0.0)
    d = torch.clamp(downwind, min=0.0)
    sigma = torch.clamp(cfg.sigma_y_coef * d ** cfg.sigma_y_exp,
                        min=cfg.sigma_y_min)
    centerline = cfg.conc_peak * (cfg.sigma_y_min / sigma)
    vert = blob_vert = 1.0
    if z is not None:
        dz = z - cfg.source_z
        sigma_z = torch.clamp(cfg.sigma_z_coef * d ** cfg.sigma_z_exp,
                              min=cfg.sigma_z_min)
        centerline = centerline * (cfg.sigma_z_min / sigma_z)
        vert = torch.exp(-(dz * dz) / (2.0 * sigma_z ** 2))
        blob_vert = torch.exp(-(dz * dz) / (2.0 * cfg.sigma_z_min ** 2))
    plume_val = centerline * torch.exp(-cross2 / (2.0 * sigma ** 2)) * vert
    blob = cfg.conc_peak * torch.exp(-r2 / (2.0 * cfg.sigma_y_min ** 2)) * blob_vert
    return torch.where(downwind >= 0.0, torch.maximum(plume_val, blob), blob)
