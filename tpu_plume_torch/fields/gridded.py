"""Gridded plume fields: a device-resident bank of mean-concentration grids
(port of ``tpu_plume/fields/gridded.py``).

Each episode samples a row of a ``FieldBank`` and the env reads the row at
the agent's position.  Banks are synthesized here from a
``torch.Generator`` (``synthesize_*``); each synthesizer's body, given its
draws, is a function of its own (``build_*``), so the tests feed it the JAX
package's draws.  ``ingest_netcdf`` reads a bank from a NetCDF/HDF5 file
and ``export_bank_netcdf`` writes one, through h5py, imported where a file
is opened.

Two reads:
  - ``sample_bank``: the grid cell, linear in t (4-D banks) and in t and z
    (5-D banks), by plain tensor indexing, as the JAX package leaves it to
    an XLA gather;
  - ``sample_bank_points``: sub-cell samples at float (x, y, z, t) points,
    through the bilinear and trilinear gather kernels of
    ``tpu_plume_torch.ops.gather`` (``gather.bank_points``).  The env's
    sub-cell sample does not come here: it is one launch of the sample
    kernel (``gather.sample_bank_conc_tke``), whose launch a bank on the
    card keeps (``FieldBank.sampler``), and in the rollout on the card a
    part of the bank step kernel's one launch a step
    (``ops.plume.BankStepper``).

The JAX package's packed layout (``pack_time_levels``, ``maybe_pack``,
``conc_packed``) and its "packed" and "fused" formulations are not ported:
they are TPU layouts that cut the number of XLA gathers (a 4.1 GB copy of
the wrf_les_3d bank) and that no kernel here reads.  Every ``gather_mode``
the JAX package accepts is accepted here and samples the same function
through the kernels; the JAX package holds all of its modes to one
function (``tests/test_fields_ops.py:312-357``).
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass

import torch

from tpu_plume_torch.core.config import EnvConfig
from tpu_plume_torch.core.support import GATHER_MODES
from tpu_plume_torch.ops import gather, plume


@dataclass(frozen=True)
class FieldBank:
    """A bank of K plume fields on one device.

    ``conc`` layouts (f32, contiguous):
      [K, H, W]          static 2-D fields;
      [K, T, H, W]       time-varying 2-D fields, linear over frames at
                         ``steps_per_frame`` env steps a frame;
      [K, T, Z, H, W]    time-varying 3-D volumes whose z axis spans
                         ``z_extent`` grid units, linear between levels.
    ``wind`` is None, f32[K, 2] or f32[K, T, 2] (per frame).  Frozen, so
    that the launch a bank on the card keeps (``sampler``) stays true of
    it."""

    conc: torch.Tensor
    source: torch.Tensor              # f32[K, 2] source position per field
    wind: torch.Tensor | None = None
    steps_per_frame: float = 1.0
    z_extent: float = 0.0
    _sampler: gather.BankSampler | None = dataclasses.field(
        default=None, init=False, repr=False, compare=False)

    def to(self, device) -> "FieldBank":
        return dataclasses.replace(
            self, conc=self.conc.to(device), source=self.source.to(device),
            wind=None if self.wind is None else self.wind.to(device))

    def sampler(self, cfg: EnvConfig) -> gather.BankSampler:
        """The sample kernel's launch over this bank on the card for the
        field scalars of ``cfg`` (whose bank read the bank step kernel
        takes too): validated and cached at first use, kept while ``cfg``'s
        scalars stay the same."""
        s = self._sampler
        if s is None or not s.serves(cfg):
            s = gather.BankSampler(self, cfg)
            object.__setattr__(self, "_sampler", s)
        return s


def sample_bank(bank: FieldBank, idx, ix, iy, t=None, z=None) -> torch.Tensor:
    """Bank rows ``idx`` at integer cells (ix, iy), linear in t (4-D banks)
    and in t and z (5-D banks).  Broadcasts."""
    conc = bank.conc
    if conc.dim() == 3:
        return conc[idx, ix, iy]
    t0, ft = gather.frame_weights(bank, t, ix)
    if conc.dim() == 4:
        a = conc[idx, t0, ix, iy]
        b = conc[idx, t0 + 1, ix, iy]
        return (1.0 - ft) * a + ft * b
    z0, fz = gather.level_weights(bank, z, ix)
    z1 = torch.clamp(z0 + 1, max=conc.shape[2] - 1)

    def at(ti, zi):
        return conc[idx, ti, zi, ix, iy]

    lo = (1.0 - fz) * at(t0, z0) + fz * at(t0, z1)
    hi = (1.0 - fz) * at(t0 + 1, z0) + fz * at(t0 + 1, z1)
    return (1.0 - ft) * lo + ft * hi


def sample_bank_points(bank: FieldBank, idx: torch.Tensor, x: torch.Tensor,
                       y: torch.Tensor, t=None, z=None, *,
                       gather_mode: str = "auto") -> torch.Tensor:
    """Sub-cell samples f32[N] of bank rows ``idx`` i32[N] at float points:
    bilinear in (x, y), linear in z (5-D banks) and in t (4-D and 5-D
    banks), clamped to the grid (``gather.bank_points``).  Through the
    gather kernels on the card, their plain versions on the CPU; every
    ``gather_mode`` samples this one function."""
    if gather_mode not in GATHER_MODES:
        raise ValueError(f"gather_mode must be one of {GATHER_MODES}, got "
                         f"{gather_mode!r}")
    return gather.bank_points(bank, idx, x, y, t, z)


def bank_wind(bank: FieldBank, idx: torch.Tensor, t=None) -> torch.Tensor:
    """Per-episode horizontal wind f32[N, 2] of rows ``idx``, linear over
    frames for per-frame wind; zeros when the bank carries none."""
    if bank.wind is None:
        return torch.zeros(idx.shape + (2,), dtype=torch.float32,
                           device=idx.device)
    if bank.wind.dim() == 2:
        return bank.wind[idx]
    num_frames = bank.wind.shape[1]
    tf = gather.frame_coord(bank, t, idx)
    t0 = torch.clamp(torch.floor(tf).to(torch.int32), 0,
                     max(num_frames - 2, 0))
    ft = torch.clamp(tf - t0, 0.0, 1.0)
    a = bank.wind[idx, t0]
    b = bank.wind[idx, torch.clamp(t0 + 1, max=num_frames - 1)]
    return (1.0 - ft[..., None]) * a + ft[..., None] * b


# --- synthesis --------------------------------------------------------------


def _uniform(generator: torch.Generator, shape, lo: float, hi: float):
    u = torch.rand(shape, generator=generator, device=generator.device)
    return lo + (hi - lo) * u


def _grid(g: int, device):
    """Cell coordinates (ix [g, 1], iy [1, g]) as f32."""
    r = torch.arange(g, dtype=torch.int32, device=device).to(torch.float32)
    return r[:, None], r[None, :]


def _draw_sources(generator, cfg: EnvConfig, num_fields: int, g: int):
    lo, hi = cfg.source_padding, g - cfg.source_padding
    return _uniform(generator, (num_fields, 2), lo, hi)


def _winds(theta: torch.Tensor) -> torch.Tensor:
    return torch.stack([torch.cos(theta), torch.sin(theta)], dim=-1)


def build_static_bank(sources: torch.Tensor, theta: torch.Tensor,
                      cfg: EnvConfig) -> FieldBank:
    """``synthesize_bank``'s body: one anisotropic plume per source with a
    unit wind at angle ``theta`` f32[K]."""
    fx, fy = _grid(cfg.grid_size, sources.device)
    winds = _winds(theta)
    conc = torch.stack([plume.anisotropic_kernel(s, wnd, fx, fy, cfg)
                        for s, wnd in zip(sources, winds)])
    return FieldBank(conc=conc.contiguous(), source=sources)


def synthesize_bank(generator: torch.Generator, cfg: EnvConfig,
                    num_fields: int = 64) -> FieldBank:
    """A static anisotropic-dispersion bank [K, G, G] (sigma_y = 0.3 x^0.71
    plumes with random wind directions) on the generator's device."""
    sources = _draw_sources(generator, cfg, num_fields, cfg.grid_size)
    theta = _uniform(generator, (num_fields,), 0.0, 2 * math.pi)
    return build_static_bank(sources, theta, cfg)


def _frame_thetas(theta0, veer, num_frames):
    tfs = torch.linspace(0.0, 1.0, num_frames, device=theta0.device)
    return theta0[:, None] + veer[:, None] * tfs[None, :]


def build_time_varying_bank(sources, theta0, veer, cfg: EnvConfig,
                            num_frames: int = 16,
                            steps_per_frame: float = 64.0,
                            grid: int | None = None) -> FieldBank:
    """``synthesize_time_varying_bank``'s body: the wind veers from
    ``theta0`` by ``veer`` radians across the frames."""
    fx, fy = _grid(grid or cfg.grid_size, sources.device)
    thetas = _frame_thetas(theta0, veer, num_frames)
    wind = _winds(thetas)                                    # [K, T, 2]
    conc = torch.stack([
        torch.stack([plume.anisotropic_kernel(s, wnd, fx, fy, cfg)
                     for wnd in ws])
        for s, ws in zip(sources, wind)])
    return FieldBank(conc=conc.contiguous(), source=sources, wind=wind,
                     steps_per_frame=steps_per_frame)


def synthesize_time_varying_bank(generator: torch.Generator, cfg: EnvConfig,
                                 num_fields: int = 8, num_frames: int = 16,
                                 steps_per_frame: float = 64.0,
                                 grid: int | None = None) -> FieldBank:
    """Time-varying anisotropic plumes [K, T, G, G] whose wind direction
    veers across the frames."""
    g = grid or cfg.grid_size
    sources = _draw_sources(generator, cfg, num_fields, g)
    theta0 = _uniform(generator, (num_fields,), 0.0, 2 * math.pi)
    veer = _uniform(generator, (num_fields,), -1.0, 1.0)
    return build_time_varying_bank(sources, theta0, veer, cfg, num_frames,
                                   steps_per_frame, g)


def build_3d_bank(sources, theta0, veer, cfg: EnvConfig, num_frames: int = 8,
                  num_levels: int = 8, steps_per_frame: float = 128.0,
                  z_extent: float | None = None, grid: int | None = None,
                  wind_speed: float = 2.0) -> FieldBank:
    """``synthesize_3d_bank``'s body: veering wind of ``wind_speed`` and the
    Gaussian-dispersion vertical profile at ``num_levels`` heights evenly
    over [0, z_extent]; built one frame at a time."""
    dev = sources.device
    fx, fy = _grid(grid or cfg.grid_size, dev)
    ze = cfg.domain_height if z_extent is None else z_extent
    levels = torch.linspace(0.0, ze, num_levels, device=dev)[:, None, None]
    wind = wind_speed * _winds(_frame_thetas(theta0, veer, num_frames))
    g = fx.shape[0]
    conc = torch.empty(len(sources), num_frames, num_levels, g, g,
                       dtype=torch.float32, device=dev)
    for k, s in enumerate(sources):
        for f in range(num_frames):
            conc[k, f] = plume.anisotropic_kernel(s, wind[k, f], fx, fy, cfg,
                                                  z=levels)
    return FieldBank(conc=conc, source=sources, wind=wind,
                     steps_per_frame=steps_per_frame, z_extent=ze)


def synthesize_3d_bank(generator: torch.Generator, cfg: EnvConfig,
                       num_fields: int = 4, num_frames: int = 8,
                       num_levels: int = 8, steps_per_frame: float = 128.0,
                       z_extent: float | None = None, grid: int | None = None,
                       wind_speed: float = 2.0) -> FieldBank:
    """A time-varying 3-D volume bank [K, T, Z, G, G]: anisotropic plumes
    with veering per-frame wind and a vertical profile, in the layout of
    real WRF-LES output."""
    g = grid or cfg.grid_size
    sources = _draw_sources(generator, cfg, num_fields, g)
    theta0 = _uniform(generator, (num_fields,), 0.0, 2 * math.pi)
    veer = _uniform(generator, (num_fields,), -1.0, 1.0)
    return build_3d_bank(sources, theta0, veer, cfg, num_frames, num_levels,
                         steps_per_frame, z_extent, g, wind_speed)


@dataclass
class LesDraws:
    """The draws of ``synthesize_les_bank``: per field f32[K], per puff
    f32[K, P]."""

    sources: torch.Tensor
    theta0: torch.Tensor
    bend: torch.Tensor
    phase: torch.Tensor
    puff_phase: torch.Tensor
    puff_rate: torch.Tensor
    veer: torch.Tensor


def build_les_bank(d: LesDraws, cfg: EnvConfig, num_frames: int = 16,
                   steps_per_frame: float = 64.0, grid: int | None = None,
                   meander_amp: float = 35.0,
                   meander_wavelength: float = 160.0,
                   width_gain: float = 0.12,
                   intermittency: float = 1.5) -> FieldBank:
    """``synthesize_les_bank``'s body: meandering, curved centerlines with
    intermittent advecting puffs, outside the Gaussian-ribbon family; each
    field scaled so its maximum is ``cfg.conc_peak``."""
    dev = d.sources.device
    g = grid or cfg.grid_size
    ix, iy = _grid(g, dev)
    num_puffs = d.puff_phase.shape[1]
    s_max = 1.1 * g
    spacing = s_max / num_puffs
    tfs = torch.linspace(0.0, 1.0, num_frames, device=dev)
    puffs = torch.arange(num_puffs, device=dev).to(torch.float32)
    lam = meander_wavelength

    def one_frame(k, tf):
        src, th = d.sources[k], d.theta0[k] + d.veer[k] * tf
        dx, dy = ix - src[0], iy - src[1]
        s = dx * torch.cos(th) + dy * torch.sin(th)         # downstream
        n = -dx * torch.sin(th) + dy * torch.cos(th)        # crosswind
        ramp = torch.clamp(s / lam, 0.0, 1.0)
        center = (meander_amp * ramp
                  * torch.sin(2 * math.pi * (s / lam - tf) + d.phase[k])
                  + d.bend[k] * s * s / s_max)
        sig_n = 2.0 + width_gain * torch.clamp(s, min=0.0)
        sig_s = 3.0 * sig_n
        sj = torch.remainder(puffs * spacing + tf * 2.0 * spacing, s_max)
        env = torch.clamp(torch.sin(2 * math.pi * (d.puff_rate[k] * tf)
                                    + d.puff_phase[k]), min=0.0) ** intermittency
        amp = env * 30.0 / (sj + 30.0)
        blob = amp[:, None, None] * torch.exp(
            -((s[None] - sj[:, None, None]) ** 2 / (2.0 * sig_s[None] ** 2)
              + (n[None] - center[None]) ** 2 / (2.0 * sig_n[None] ** 2)))
        near = torch.exp(-(dx * dx + dy * dy) / (2.0 * 3.0 ** 2))
        return torch.sum(blob, dim=0) * (s > -5.0) + near

    fields = []
    for k in range(len(d.sources)):
        f = torch.stack([one_frame(k, tf) for tf in tfs])
        fields.append(f * (cfg.conc_peak / torch.clamp(f.max(), min=1e-6)))
    wind = _winds(d.theta0[:, None] + d.veer[:, None] * tfs[None, :])
    return FieldBank(conc=torch.stack(fields), source=d.sources, wind=wind,
                     steps_per_frame=steps_per_frame)


def synthesize_les_bank(generator: torch.Generator, cfg: EnvConfig,
                        num_fields: int = 16, num_frames: int = 16,
                        steps_per_frame: float = 64.0, grid: int | None = None,
                        num_puffs: int = 12, **shape) -> FieldBank:
    """A model-mismatch surrogate for WRF-LES output [K, T, G, G]
    (``build_les_bank`` says what it holds); ``shape`` passes
    ``meander_amp``, ``meander_wavelength``, ``width_gain`` and
    ``intermittency`` on."""
    g = grid or cfg.grid_size
    two_pi = 2 * math.pi
    draws = LesDraws(
        sources=_draw_sources(generator, cfg, num_fields, g),
        theta0=_uniform(generator, (num_fields,), 0.0, two_pi),
        bend=_uniform(generator, (num_fields,), -0.6, 0.6),
        phase=_uniform(generator, (num_fields,), 0.0, two_pi),
        puff_phase=_uniform(generator, (num_fields, num_puffs), 0.0, two_pi),
        puff_rate=_uniform(generator, (num_fields, num_puffs), 0.5, 2.0),
        veer=_uniform(generator, (num_fields,), -0.5, 0.5),
    )
    return build_les_bank(draws, cfg, num_frames, steps_per_frame, g, **shape)


def ingest_netcdf(
    path: str,
    conc_var: str = "concentration",
    source_x_var: str = "source_x",
    source_y_var: str = "source_y",
    wind_u_var: str = "wind_u",
    wind_v_var: str = "wind_v",
    scale_to_peak: float | None = None,
    steps_per_frame: float | None = None,
    z_extent: float | None = None,
    device="cpu",
) -> FieldBank:
    """A bank from a NetCDF/HDF5 file on ``device``: ``conc_var`` of shape
    [K, H, W], [K, T, H, W] or [K, T, Z, H, W] (without the leading K, K=1)
    plus per-field source coordinates and, if present, wind components [K,
    T] (or [K] / [T]).  Packed integers are unpacked by their
    ``scale_factor`` / ``add_offset`` after the ``_FillValue`` cells are
    masked; missing cells are zero.  Source coordinates come from a
    variable, else a global attribute.  Optionally rescaled so that max ==
    ``scale_to_peak``.  ``steps_per_frame`` / ``z_extent`` default to the
    file attributes of those names (then 1.0 / num_levels - 1).  The file
    is read through h5py (``tpu_plume/fields/gridded.py`` ``ingest_netcdf``);
    the bank is built by ``convert.field_bank_from_numpy``."""
    import h5py
    import numpy as np

    from tpu_plume_torch.convert import field_bank_from_numpy

    with h5py.File(path, "r") as f:
        var = f[conc_var]
        conc = np.asarray(var, np.float64)
        vattrs = dict(var.attrs)
        if "_FillValue" in vattrs:
            # _FillValue matches the raw (packed) value: mask before unpacking
            fill = float(np.asarray(vattrs["_FillValue"]))
            conc = np.where(conc == fill, np.nan, conc)
        if "scale_factor" in vattrs or "add_offset" in vattrs:
            conc = (conc * float(np.asarray(vattrs.get("scale_factor", 1.0)))
                    + float(np.asarray(vattrs.get("add_offset", 0.0))))
        conc = np.nan_to_num(conc, nan=0.0).astype(np.float32)
        if conc.ndim == 2:            # [H, W] -> [1, H, W]
            conc = conc[None]
        attrs = dict(f.attrs)

        def read_coord(name):
            if name in f:
                return np.atleast_1d(np.asarray(f[name], np.float32))
            if name in attrs:
                return np.atleast_1d(np.asarray(attrs[name], np.float32))
            raise KeyError(
                f"{name} not found in {path} (neither variable nor attribute)")

        sx = read_coord(source_x_var)
        sy = read_coord(source_y_var)
        wind = None
        if wind_u_var in f and wind_v_var in f:
            wind = np.stack([np.asarray(f[wind_u_var], np.float32),
                             np.asarray(f[wind_v_var], np.float32)], axis=-1)
    k = sx.shape[0]
    if conc.shape[0] != k and conc.ndim >= 3:
        # stored without the K axis ([T, H, W] / [T, Z, H, W])
        if k == 1:
            conc = conc[None]
        else:
            raise ValueError(f"{k} sources for conc shape {conc.shape} in {path}")
    if scale_to_peak is not None and conc.max() > 0:
        conc = conc * (scale_to_peak / conc.max())
    source = np.stack([sx, sy], axis=-1)
    if source.shape[0] != conc.shape[0]:
        raise ValueError(
            f"{source.shape[0]} sources for {conc.shape[0]} fields in {path}")
    if wind is not None and wind.shape[0] != conc.shape[0]:
        if conc.shape[0] == 1:
            wind = wind[None]           # [T, 2] -> [1, T, 2]
        else:
            raise ValueError(f"wind shape {wind.shape} mismatches K={conc.shape[0]}")
    if steps_per_frame is None:
        steps_per_frame = float(attrs.get("steps_per_frame", 1.0))
    if z_extent is None:
        z_extent = float(attrs.get(
            "z_extent", conc.shape[2] - 1 if conc.ndim == 5 else 0.0))
    return field_bank_from_numpy(conc, source, wind, steps_per_frame,
                                 z_extent, device)


def export_bank_netcdf(bank: FieldBank, path: str) -> None:
    """Write a bank in ``ingest_netcdf``'s format (h5py), as the JAX
    package's ``export_bank_netcdf`` writes it."""
    import h5py

    conc = bank.conc.detach().cpu().numpy()
    src = bank.source.detach().cpu().numpy()
    with h5py.File(path, "w") as f:
        f.create_dataset("concentration", data=conc, compression="gzip")
        f.create_dataset("source_x", data=src[:, 0])
        f.create_dataset("source_y", data=src[:, 1])
        if bank.wind is not None:
            wind = bank.wind.detach().cpu().numpy()
            f.create_dataset("wind_u", data=wind[..., 0])
            f.create_dataset("wind_v", data=wind[..., 1])
        f.attrs["steps_per_frame"] = float(bank.steps_per_frame)
        f.attrs["z_extent"] = float(bank.z_extent)
