"""Analytic plume sample, and the analytic env step built around it: the
port of ``tpu_plume/ops/pallas_plume.py``, with the analytic models of
``tpu_plume/fields/analytic.py`` (the isotropic Gaussian, the anisotropic
dispersion in a per-episode wind, S sources hashed from the seed, and the
vertical profile of 3-D flight).

Two wrappers reach the kernels of ``tpu_plume_torch/csrc/plume.cu``:

- ``sample_plume(pos, source, seed, cfg, wind)`` returns ``(conc, tke)`` at
  each query's grid cell (and height, in 3-D flight).  On a CUDA tensor it
  launches ``plume_sample_kernel`` or raises; on a CPU tensor it runs
  ``sample_plume_plain``, the same function in plain PyTorch, which is also
  the yardstick the kernel is held against on the card.
- ``EnvStepper`` launches ``env_step_kernel``: one analytic env step of every
  env per launch (action sample, move, plume sample, reward, auto-reset,
  trajectory rows), the rollout's step on the card with the analytic plume;
  a guided rollout gives each launch the guide's executed actions.
  Its plain version is ``tpu_plume_torch.rollout.rollout.env_step_plain``,
  which the rollout runs on the CPU.

Both entry points are METH_FASTCALL functions of an extension module
(``build.load_module``).  ``launches`` counts launches of the sample kernel
and ``env_step_launches`` those of the env-step kernel (and nothing else),
so a run can show that its env steps went through the kernels.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from tpu_plume_torch.core import prng
from tpu_plume_torch.core.config import EnvConfig

# Salts of the per-cell hash draws (tpu_plume/fields/analytic.py:28-31).
SALT_NORMAL = 0   # uses 0 and 1 (Box-Muller needs two uniforms)
SALT_UNIFORM = 2
SALT_SRC = 3      # uses 3, 4 and 5 (extra source positions and strengths)

# The kernels' limit on ``EnvConfig.num_sources`` (csrc/plume.cu).
MAX_SOURCES = 8

# Bytes one query of the isotropic 2-D sample moves: pos f32[2], source
# f32[2], seed i32 read; conc and tke f32 written.
BYTES_PER_QUERY = 28

launches = 0
env_step_launches = 0

_F32, _I32, _I64, _BOOL = torch.float32, torch.int32, torch.int64, torch.bool


def cell_of(pos: torch.Tensor, grid_size: int):
    """Integer grid cell (ix, iy) of float positions f32[..., 2]."""
    ij = torch.clamp(torch.floor(pos).to(torch.int32), 0, grid_size - 1)
    return ij[..., 0], ij[..., 1]


def turbulence(seed: torch.Tensor, ix: torch.Tensor, iy: torch.Tensor,
               cfg: EnvConfig) -> torch.Tensor:
    """TI * (|N| or N + 0.3 sin(0.05 ix) cos(0.07 iy) + 0.2 U) at integer
    cells, N and U hashed from (seed, ix, iy) (``_turbulence``,
    ``tpu_plume/fields/analytic.py:148-156``)."""
    fx = ix.to(torch.float32)
    fy = iy.to(torch.float32)
    n = prng.cell_normal(seed, ix, iy, SALT_NORMAL)
    if not cfg.turbulence_signed_normal:
        n = torch.abs(n)
    u = prng.cell_uniform(seed, ix, iy, SALT_UNIFORM)
    wave = 0.3 * torch.sin(0.05 * fx) * torch.cos(0.07 * fy)
    return cfg.turbulence_intensity * (n + wave + 0.2 * u)


def reads_wind(cfg: EnvConfig) -> bool:
    """Whether ``cfg``'s field carries a per-episode wind: the anisotropic
    model with a wind speed range above 0 (``tpu_plume/fields/
    analytic.py:90``); every other field's wind is zero, which the port
    keeps as None."""
    return cfg.plume_model == "anisotropic" and cfg.wind_speed_range[1] > 0


def extra_sources(seed: torch.Tensor, cfg: EnvConfig) -> torch.Tensor:
    """Sources 1..S-1 of the fields with seeds ``seed`` int32[N]: f32[N,
    S-1, 2] uniform in [padding, grid - padding)^2, hashed from the seed
    with salts 3 and 4 (``extra_sources``, ``tpu_plume/fields/
    analytic.py:105-126``)."""
    lo = cfg.source_padding
    hi = cfg.grid_size - cfg.source_padding
    ids = torch.arange(1, cfg.num_sources, device=seed.device)
    zero = torch.zeros_like(ids)
    seed = seed[:, None]
    ux = prng.bits_to_uniform(prng.hash_cell(seed, ids, zero, SALT_SRC))
    uy = prng.bits_to_uniform(prng.hash_cell(seed, zero, ids, SALT_SRC + 1))
    return lo + (hi - lo) * torch.stack([ux, uy], -1)


def all_sources(source: torch.Tensor, seed: torch.Tensor,
                cfg: EnvConfig) -> torch.Tensor:
    """f32[N, S, 2]: each field's primary source f32[N, 2] and the S - 1
    sources hashed from its seed (``all_sources``, ``tpu_plume/fields/
    analytic.py:129-133``)."""
    return torch.cat([source[:, None], extra_sources(seed, cfg)], 1)


def source_strengths(seed: torch.Tensor, cfg: EnvConfig) -> torch.Tensor:
    """f32[N, S] emission strengths: 1.0 for the primary source, then
    uniform in ``source_strength_range``, hashed from the seed with salt 5
    (``source_strengths``, ``tpu_plume/fields/analytic.py:136-145``)."""
    ones = torch.ones(seed.shape[0], 1, device=seed.device)
    if cfg.num_sources == 1:
        return ones
    ids = torch.arange(1, cfg.num_sources, device=seed.device)
    u = prng.bits_to_uniform(prng.hash_cell(seed[:, None], ids, ids,
                                            SALT_SRC + 2))
    lo, hi = cfg.source_strength_range
    return torch.cat([ones, lo + (hi - lo) * u], -1)


def isotropic_kernel(source: torch.Tensor, fx, fy, cfg: EnvConfig,
                     z=None) -> torch.Tensor:
    """peak * exp(-d^2 / (2 sigma^2)) of sources f32[..., 2] at cells (fx,
    fy), d^2 gaining (z - source_z)^2 at a height ``z`` (``_iso_kernel``,
    ``tpu_plume/fields/analytic.py:159-166``).  Broadcasts."""
    dx = fx - source[..., 0]
    dy = fy - source[..., 1]
    d2 = dx * dx + dy * dy
    if z is not None:
        dz = z - cfg.source_z
        d2 = d2 + dz * dz
    return cfg.conc_peak * torch.exp(-d2 / (2.0 * cfg.plume_sigma**2))


def anisotropic_kernel(source: torch.Tensor, wind: torch.Tensor, fx, fy,
                       cfg: EnvConfig, z=None) -> torch.Tensor:
    """Gaussian dispersion of sources f32[..., 2] in winds f32[..., 2] at
    cells (fx, fy) (``_aniso_kernel``, ``tpu_plume/fields/
    analytic.py:200-223``): crosswind spread sigma_y = max(sigma_y_min, 0.3
    d^0.71) growing with the downwind distance d, the centerline decaying
    by mass conservation, and a compact kernel of sigma_y_min around and
    upwind of the source.  With a height ``z`` the plume gains the vertical
    profile exp(-(z - source_z)^2 / (2 sigma_z^2)), sigma_z growing like
    sigma_y.  Broadcasts over the sources and winds, fx, fy and z."""
    r0 = fx - source[..., 0]
    r1 = fy - source[..., 1]
    w0, w1 = wind[..., 0], wind[..., 1]
    speed = torch.sqrt(w0 * w0 + w1 * w1) + 1e-8
    downwind = r0 * (w0 / speed) + r1 * (w1 / speed)
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
    blob = (cfg.conc_peak * torch.exp(-r2 / (2.0 * cfg.sigma_y_min ** 2))
            * blob_vert)
    return torch.where(downwind >= 0.0, torch.maximum(plume_val, blob), blob)


def plume_base(source: torch.Tensor, seed: torch.Tensor, wind, fx, fy,
               cfg: EnvConfig, z=None) -> torch.Tensor:
    """The base concentration f32[N] of N analytic fields (primary source
    f32[N, 2], seed int32[N], wind f32[N, 2] or None for a zero wind) at
    cells (fx, fy) f32[N] and heights ``z``: ``cfg.plume_model``'s kernel
    of the primary source, or, for S sources, min(peak, sum of each
    source's strength times its kernel) (``_isotropic_base`` and
    ``_anisotropic_base``, ``tpu_plume/fields/analytic.py:169-197``)."""
    if cfg.plume_model == "anisotropic":
        if wind is None:
            wind = torch.zeros_like(source)

        def kernel(src):
            return anisotropic_kernel(src, wind, fx, fy, cfg, z)
    else:
        def kernel(src):
            return isotropic_kernel(src, fx, fy, cfg, z)
    if cfg.num_sources == 1:
        return kernel(source)
    srcs = all_sources(source, seed, cfg)
    qs = source_strengths(seed, cfg)
    total = 0.0
    for s in range(cfg.num_sources):
        total = total + qs[:, s] * kernel(srcs[:, s])
    return torch.clamp(total, max=cfg.conc_peak)


def sample_plume_plain(pos: torch.Tensor, source: torch.Tensor,
                       seed: torch.Tensor, cfg: EnvConfig, wind=None):
    """The kernel's function in plain PyTorch: pos f32[N, pos_dim], source
    f32[N, 2], seed int32[N] (uint32 bit pattern), wind f32[N, 2] or None
    -> conc, tke f32[N] at the grid cell of pos[:, :2] (and, in 3-D flight,
    the height pos[:, 2])."""
    ix, iy = cell_of(pos[:, :2], cfg.grid_size)
    z = pos[:, 2] if cfg.env_3d else None
    base = plume_base(source, seed, wind, ix.to(torch.float32),
                      iy.to(torch.float32), cfg, z)
    turb = turbulence(seed, ix, iy, cfg)

    conc = torch.clamp(base + turb, 0.0, cfg.conc_peak)
    tke = torch.abs(turb) * 2.0 if cfg.tke_abs_times_two else turb
    return conc, tke


def _expect(name: str, x: torch.Tensor, dtype, shape, index: int) -> None:
    """Raise unless ``x`` is a contiguous ``dtype`` tensor of ``shape`` on
    device ``index`` (-1: the CPU)."""
    if x is None:
        raise ValueError(f"{name} is missing")
    if x.get_device() != index:
        raise ValueError(f"{name} is on {x.device}, expected device {index}")
    if x.dtype is not dtype:
        raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
    if x.shape != shape:
        raise ValueError(f"{name} must have shape {shape}, got "
                         f"{tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _aligned(name: str, x: torch.Tensor) -> None:
    if x.data_ptr() % 8:
        raise ValueError(f"{name} must be 8-byte aligned (read as float2)")


def check_field(cfg: EnvConfig) -> None:
    """Raise unless the plume kernels sample ``cfg``'s field: the analytic
    isotropic or anisotropic model of 1 to ``MAX_SOURCES`` sources."""
    if cfg.plume_model not in ("isotropic", "anisotropic"):
        raise ValueError(f"the plume kernels sample the analytic plume, got "
                         f"plume_model={cfg.plume_model!r}")
    if not 1 <= cfg.num_sources <= MAX_SOURCES:
        raise ValueError(f"the plume kernels take 1 to {MAX_SOURCES} "
                         f"sources, got num_sources={cfg.num_sources}")


def _check(pos, source, seed, wind, cfg):
    """Raise unless the sample kernel takes these tensors."""
    check_field(cfg)
    n, index = pos.shape[0], pos.get_device()
    _expect("pos", pos, _F32, (n, cfg.pos_dim), index)
    _expect("source", source, _F32, (n, 2), index)
    _expect("seed", seed, _I32, (n,), index)
    if reads_wind(cfg):
        _expect("wind", wind, _F32, (n, 2), index)
        _aligned("wind", wind)
    elif wind is not None:
        raise ValueError(f"a field of plume_model={cfg.plume_model!r} and "
                         f"wind_speed_range={cfg.wind_speed_range} has no "
                         f"wind")
    if cfg.pos_dim == 2:
        _aligned("pos", pos)
    _aligned("source", source)


_ext = None          # the kernels' extension module, set at first launch
_raw_stream = None   # the current stream's handle by device index


def _library():
    """The extension module of ``csrc/plume.cu`` (``build.load_module``):
    METH_FASTCALL entry points, each of which launches or raises."""
    global _ext, _raw_stream
    if _ext is None:
        from tpu_plume_torch.ops import build

        ext = build.load_module("plume")
        if ext.ENV_STEP_PARAMS_SIZE != ctypes.sizeof(_EnvStepParams):
            raise RuntimeError("_EnvStepParams does not match csrc/plume.cu")
        if (ext.PLUME_FIELD_SIZE != ctypes.sizeof(_PlumeField)
                or ext.MAX_SOURCES != MAX_SOURCES):
            raise RuntimeError("_PlumeField does not match csrc/plume.cu")
        _raw_stream = torch._C._cuda_getCurrentRawStream
        _ext = ext
    return _ext


_P, _INT, _FLOAT = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

_FIELD_INTS = ("grid", "signed_normal", "tke_abs_times_two", "anisotropic",
               "num_sources", "pos_dim")
_FIELD_FLOATS = ("peak", "two_sigma2", "ti", "src_lo", "src_span", "q_lo",
                 "q_span", "sy_coef", "sy_exp", "sy_min", "inv_two_sy_min2",
                 "sz_coef", "sz_exp", "sz_min", "inv_two_sz_min2", "source_z")


class _PlumeField(ctypes.Structure):
    """``PlumeField`` of ``csrc/plume.cu``, field by field."""

    _fields_ = ([(f, _INT) for f in _FIELD_INTS]
                + [(f, _FLOAT) for f in _FIELD_FLOATS])


def _recip(x: float) -> float:
    """1 / x as PyTorch divides a tensor on the card by the Python scalar
    ``x``: a multiply by the f32 reciprocal of f32(x)."""
    return float(np.float32(1.0) / np.float32(x))


def plume_field(cfg: EnvConfig) -> _PlumeField:
    """The kernels' ``PlumeField`` of ``cfg``: each scalar the value the
    plain version's operation uses on the card (a tensor divided by a
    Python scalar is multiplied by the f32 reciprocal)."""
    lo = cfg.source_padding
    q_lo, q_hi = cfg.source_strength_range
    return _PlumeField(
        grid=cfg.grid_size, signed_normal=int(cfg.turbulence_signed_normal),
        tke_abs_times_two=int(cfg.tke_abs_times_two),
        anisotropic=int(cfg.plume_model == "anisotropic"),
        num_sources=cfg.num_sources, pos_dim=cfg.pos_dim,
        peak=cfg.conc_peak, two_sigma2=2.0 * cfg.plume_sigma**2,
        ti=cfg.turbulence_intensity, src_lo=lo,
        src_span=cfg.grid_size - cfg.source_padding - lo, q_lo=q_lo,
        q_span=q_hi - q_lo, sy_coef=cfg.sigma_y_coef, sy_exp=cfg.sigma_y_exp,
        sy_min=cfg.sigma_y_min,
        inv_two_sy_min2=_recip(2.0 * cfg.sigma_y_min ** 2),
        sz_coef=cfg.sigma_z_coef, sz_exp=cfg.sigma_z_exp,
        sz_min=cfg.sigma_z_min,
        inv_two_sz_min2=_recip(2.0 * cfg.sigma_z_min ** 2),
        source_z=cfg.source_z)


def sample_plume_cuda(pos: torch.Tensor, source: torch.Tensor,
                      seed: torch.Tensor, cfg: EnvConfig, wind=None):
    """Launches the sample kernel on the current stream of the tensors'
    device (the entry point checks the 8-byte alignment of the float2
    reads)."""
    global launches
    index = pos.get_device()
    if index < 0:
        raise ValueError(f"sample_plume_cuda needs CUDA tensors, got "
                         f"{pos.device}")
    n = pos.shape[0]
    if not (pos.dtype is _F32 and source.dtype is _F32 and seed.dtype is _I32
            and pos.shape == (n, cfg.pos_dim) and source.shape == (n, 2)
            and seed.shape == (n,)
            and source.get_device() == index == seed.get_device()
            and pos.is_contiguous() and source.is_contiguous()
            and seed.is_contiguous()
            and (wind is None) != reads_wind(cfg)
            and (wind is None or (wind.dtype is _F32 and wind.shape == (n, 2)
                                  and wind.get_device() == index
                                  and wind.is_contiguous()))):
        _check(pos, source, seed, wind, cfg)          # says what failed
    check_field(cfg)
    field = plume_field(cfg)
    conc, tke = pos.new_empty((2, n)).unbind()
    if _ext is None:
        _library()
    _ext.plume_sample(
        ctypes.addressof(field), pos.data_ptr(), source.data_ptr(),
        seed.data_ptr(), None if wind is None else wind.data_ptr(),
        conc.data_ptr(), tke.data_ptr(), n, _raw_stream(index))
    launches += 1
    return conc, tke


def sample_plume(pos: torch.Tensor, source: torch.Tensor, seed: torch.Tensor,
                 cfg: EnvConfig, wind=None):
    """(conc, tke) f32[N] at the cells of ``pos``: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors."""
    if pos.device.type == "cpu":
        return sample_plume_plain(pos, source, seed, cfg, wind)
    return sample_plume_cuda(pos, source, seed, cfg, wind)


# --- the env step ----------------------------------------------------------

_STATE_PTRS = ("turb", "gumbel", "u_src", "u_wind", "bits", "pos", "t",
               "visited", "source", "seed", "wind", "conc", "tke",
               "prev_conc", "prev_action", "radius", "explore_bonus")
_TRAJ_PTRS = ("obs", "action", "log_prob", "value", "reward", "done",
              "traj_pos", "traj_conc", "success", "steps")
_RECORD_PTRS = ("final_conc", "source_x", "source_y", "rec_radius",
                "distance", "override")
_INTS = ("n", "length", "num_actions", "obs_dim", "divisions", "max_steps",
         "variant", "elastic", "obs_memory")
_FLOATS = (
    "move_step", "turb_scale", "inv_tke_norm", "clip_hi", "wall_lo",
    "wall_hi", "g", "inv_g", "inv_peak", "inv_cell", "inv_visit_norm",
    "visit_pow", "inv_max_steps", "neg_move_coef", "inv_move_step",
    "v10_move", "v10_margin", "v10_boundary", "decay_start", "gradient_gate",
    "neg_boundary_penalty", "conc_coef", "inplume_bonus", "inplume_floor",
    "turn_half", "neg_tke_factor", "r0", "term_coef", "term_cap",
    "depth_coef", "depth_power", "gate_radius", "src_lo", "src_span",
    "z_move", "z_hi", "inv_h", "advect", "w_lo", "w_span", "two_pi")


class _EnvStepParams(ctypes.Structure):
    """``EnvStepParams`` of ``csrc/plume.cu``, field by field."""

    _fields_ = ([(f, _P) for f in _STATE_PTRS] + [("acc", _P * 6)]
                + [(f, _P) for f in _TRAJ_PTRS] + [("rec", _P * 6)]
                + [(f, _P) for f in _RECORD_PTRS]
                + [(f, _INT) for f in _INTS] + [("field", _PlumeField)]
                + [(f, _FLOAT) for f in _FLOATS])


# The kernel's reward forms, by ``EnvConfig.reward_variant``.
_VARIANTS = {"v1_1": 0, "v1_0": 1, "delta": 2}
_MAX_ACTIONS = 8
# The episode totals in EpisodeAccum's (and the kernel's) order.
ACCUM_FIELDS = ("total_reward", "conc_reward", "explore_reward",
                "move_penalty", "tke_penalty", "boundary_penalty")


def env_step_scalars(cfg: EnvConfig) -> dict:
    """The env-step kernel's scalars of ``cfg``, each the value the plain
    version's operation uses on the card: Python folds products of scalars
    in double before the one f32 multiply (ctypes then rounds them to f32
    as PyTorch does), and a tensor divided by a scalar is multiplied by the
    f32 reciprocal."""
    g = float(cfg.grid_size)
    tke_norm = cfg.turbulence_intensity * 3.0
    lo = cfg.source_padding
    hi = cfg.grid_size - cfg.source_padding
    w_lo, w_hi = cfg.wind_speed_range
    return dict(
        move_step=cfg.move_step,
        turb_scale=cfg.move_step * cfg.turb_displacement_coef,
        inv_tke_norm=_recip(tke_norm), clip_hi=g - cfg.clip_edge_eps,
        wall_lo=-0.1 * g, wall_hi=1.1 * g, g=g, inv_g=_recip(g),
        inv_peak=_recip(cfg.conc_peak), inv_cell=_recip(cfg.cell_size),
        inv_visit_norm=_recip(cfg.explore_visit_norm),
        visit_pow=cfg.explore_visit_pow, inv_max_steps=_recip(cfg.max_steps),
        neg_move_coef=-cfg.move_penalty_coef,
        inv_move_step=_recip(cfg.move_step),
        v10_move=-cfg.v10_flat_move_penalty,
        v10_margin=cfg.v10_boundary_margin_frac * g,
        v10_boundary=-cfg.v10_boundary_penalty,
        decay_start=cfg.boundary_decay_start,
        gradient_gate=cfg.boundary_gradient_gate,
        neg_boundary_penalty=-cfg.boundary_penalty,
        conc_coef=cfg.conc_reward_coef, inplume_bonus=cfg.inplume_bonus,
        inplume_floor=cfg.inplume_conc_floor,
        turn_half=cfg.readme_turn_penalty * 0.5,
        neg_tke_factor=-cfg.tke_penalty_factor, r0=cfg.initial_radius,
        term_coef=cfg.terminal_bonus_coef, term_cap=cfg.terminal_bonus_cap,
        depth_coef=cfg.terminal_depth_coef,
        depth_power=cfg.terminal_depth_power,
        gate_radius=cfg.terminal_gate_radius, src_lo=lo, src_span=hi - lo,
        z_move=cfg.z_move_step, z_hi=cfg.domain_height,
        inv_h=_recip(cfg.domain_height), advect=cfg.wind_advect_coef,
        w_lo=w_lo, w_span=w_hi - w_lo, two_pi=2.0 * math.pi)


def check_env_step(cfg: EnvConfig) -> None:
    """Raise unless the env-step kernel computes ``cfg``'s env step: a field
    the plume kernels sample (``check_field``) in 2-D flight or, without
    v1_0's elastic walls, 3-D flight; a reward form it knows; at most
    ``_MAX_ACTIONS`` actions."""
    check_field(cfg)
    if cfg.elastic_walls and cfg.env_3d:
        raise ValueError("elastic_walls (v1_0) is a 2-D-only reward variant")
    if cfg.reward_variant not in _VARIANTS:
        raise ValueError(f"reward_variant must be one of {tuple(_VARIANTS)}, "
                         f"got {cfg.reward_variant!r}")
    if cfg.num_actions > _MAX_ACTIONS:
        raise ValueError(f"the env-step kernel takes at most {_MAX_ACTIONS} "
                         f"actions, got {cfg.num_actions}")


def env_step_bytes(cfg: EnvConfig, n: int, dones: int, greedy: bool,
                   guided: bool = False) -> int:
    """Bytes one env step of ``n`` envs must move, ``dones`` of them
    finishing: each input the kernel reads and each output it writes, once.
    Per env: the logits (and the Gumbel row) and the value; the
    displacement normals; pos, t, the visit cell, source, seed, wind (where
    the field has one), conc, tke, radius, explore bonus and the six totals
    read (and prev_action for the delta reward); the trajectory row
    (action i64, log-prob, value, reward, done, pos, conc) and the record
    row (success, steps, six totals, final conc, source, radius, distance)
    written; pos, t, conc, tke, prev_conc, prev_action, the six totals and
    the next obs written.  A finished env also reads its reset draws
    (source and wind uniforms, seed), writes source, seed and wind, and
    clears its D x D visit grid in place of the visit cell.  Positions and
    displacement normals have ``pos_dim`` floats.  A ``guided`` step also
    reads the executed action (i64) and writes the override flag."""
    a, d, p = cfg.num_actions, cfg.grid_divisions, 4 * cfg.pos_dim
    wind = 8 if reads_wind(cfg) else 0
    reads = (4 * a * (1 if greedy else 2) + 4 + p + p + 4 + 4 + 8 + 4 + wind
             + 4 + 4 + 4 + 4 + 6 * 4
             + (8 if cfg.reward_variant == "delta" else 0))
    traj = 8 + 4 + 4 + 4 + 1 + p + 4
    record = 1 + 4 + 6 * 4 + 4 + 8 + 4 + 4
    state = p + 4 + 4 + 4 + 4 + 8 + 6 * 4 + 4 * cfg.obs_dim
    per_env = reads + traj + record + state + (9 if guided else 0)
    return (n * per_env + (n - dones) * 4
            + dones * (8 + 4 + 8 + 4 + 2 * wind + 4 * d * d))


def check_env_step_inputs(state, accum, draws, traj, obs_rows, cfg,
                          index: int, exec_action=None) -> None:
    """Raise unless the env-step kernel takes these tensors on device
    ``index`` (-1: the CPU, where only the tests call this): ``cfg``'s env
    (``check_env_step``); every tensor contiguous, of its dtype and shape,
    on the device; the float2 reads 8-byte aligned; the field's wind and
    the draws' wind uniforms present exactly where the field has a wind;
    draws of at least as many steps as ``traj``; the record's ``done`` the
    trajectory's and its ``final_x`` / ``final_y`` views of ``traj.pos``;
    ``traj.override`` bool[T, N] where present, and an executed action
    ``exec_action`` i64[N] only with it."""
    check_env_step(cfg)
    n, length = state.pos.shape[0], traj.action.shape[0]
    a, dv, od, dim = (cfg.num_actions, cfg.grid_divisions, cfg.obs_dim,
                      cfg.pos_dim)
    steps = draws.turb_noise.shape[0]
    if steps < length:
        raise ValueError(f"draws of {steps} steps for a chunk of {length}")
    field, ep = state.field, traj.episode
    if field.idx is not None:
        raise ValueError("the env-step kernel samples no bank")
    tensors = {
        "turb_noise": (draws.turb_noise, _F32, (steps, n, dim)),
        "u_src": (draws.u_src, _F32, (steps, n, 2)),
        "bits": (draws.bits, _I32, (steps, n)),
        "pos": (state.pos, _F32, (n, dim)), "t": (state.t, _I32, (n,)),
        "visited": (state.visited, _I32, (n, dv, dv)),
        "source": (field.source, _F32, (n, 2)),
        "seed": (field.seed, _I32, (n,)), "conc": (state.conc, _F32, (n,)),
        "tke": (state.tke, _F32, (n,)),
        "prev_conc": (state.prev_conc, _F32, (n,)),
        "prev_action": (state.prev_action, _I64, (n,)),
        "radius": (state.radius, _F32, (n,)),
        "explore_bonus": (state.explore_bonus, _F32, (n,)),
        "obs_rows": (obs_rows, _F32, (length + 1, n, od)),
        "action": (traj.action, _I64, (length, n)),
        "done": (traj.done, _BOOL, (length, n)),
        "traj_pos": (traj.pos, _F32, (length, n, dim)),
        "success": (ep.success, _BOOL, (length, n)),
        "steps": (ep.steps, _I32, (length, n)),
    }
    aligned = ["u_src", "source"]
    if reads_wind(cfg):
        tensors["wind"] = (field.wind, _F32, (n, 2))
        tensors["u_wind"] = (draws.u_wind, _F32, (steps, n, 2))
        aligned += ["wind", "u_wind"]
    elif field.wind is not None:
        raise ValueError(f"a field of plume_model={cfg.plume_model!r} and "
                         f"wind_speed_range={cfg.wind_speed_range} has no "
                         f"wind")
    if dim == 2:
        aligned += ["turb_noise", "pos", "traj_pos"]
    if draws.gumbel is not None:
        tensors["gumbel"] = (draws.gumbel, _F32, (steps, n, a))
    if traj.override is not None:
        tensors["override"] = (traj.override, _BOOL, (length, n))
    if exec_action is not None:
        if traj.override is None:
            raise ValueError("an executed action needs traj.override")
        tensors["exec_action"] = (exec_action, _I64, (n,))
    for name in ("log_prob", "value", "reward", "conc"):
        tensors["traj " + name] = (getattr(traj, name), _F32, (length, n))
    for name in ACCUM_FIELDS + ("final_conc", "source_x", "source_y",
                                "radius", "distance"):
        tensors["record " + name] = (getattr(ep, name), _F32, (length, n))
    for name in ACCUM_FIELDS:
        tensors["accum " + name] = (getattr(accum, name), _F32, (n,))
    for name, (x, dtype, shape) in tensors.items():
        _expect(name, x, dtype, shape, index)
    for name in aligned:
        _aligned(name, tensors[name][0])
    if ep.done.data_ptr() != traj.done.data_ptr() or (
            ep.done.shape != traj.done.shape):
        raise ValueError("traj.episode.done must be traj.done")
    for k, name in enumerate(("final_x", "final_y")):
        view = getattr(ep, name)
        if (view.data_ptr() != traj.pos.data_ptr() + 4 * k
                or view.shape != (length, n)
                or view.stride() != (dim * n, dim)):
            raise ValueError(f"traj.episode.{name} must be traj.pos[..., "
                             f"{k}]")


class EnvStepper:
    """The env-step kernel's launches over one chunk of ``T`` steps.

    Made once per chunk (``rollout_chunk``): it takes the env state
    ``state`` (an ``EnvState`` of [N, ...] tensors) and the episode totals
    ``accum`` (an ``EpisodeAccum`` of f32[N]), which the kernel updates in
    place and so must belong to the caller's chunk alone; the chunk's
    ``draws`` (a ``ChunkDraws`` of at least T steps); the trajectory
    buffers ``traj`` and ``obs_rows`` of ``rollout.empty_trajectory``, which
    it keeps and the kernel fills.  It validates every tensor once (dtype,
    shape, contiguity, device, the float2 reads' alignment, the record's
    views of ``traj``) and caches the launch's pointers and ``cfg``'s
    scalars in an ``_EnvStepParams``.  ``stepper(t, logits, value)`` then
    checks the policy's two outputs in one expression and makes one call of
    the kernel's entry point, which raises if the launch is refused: step
    ``t`` samples the actions, steps every env, records row ``t`` and writes
    the next obs into ``obs_rows[t + 1]``.  With ``traj.override`` (a
    guided chunk), ``stepper(t, logits, value, exec_action)`` steps the
    envs with the executed actions i64[N] instead of the sampled ones,
    which the record keeps, and writes ``traj.override`` row ``t``."""

    def __init__(self, state, accum, draws, traj, obs_rows: torch.Tensor,
                 cfg: EnvConfig):
        index = state.pos.get_device()
        if index < 0:
            raise ValueError(f"EnvStepper needs CUDA tensors, got "
                             f"{state.pos.device}")
        check_env_step_inputs(state, accum, draws, traj, obs_rows, cfg, index)
        n, length = state.pos.shape[0], traj.action.shape[0]
        a, field, ep = cfg.num_actions, state.field, traj.episode
        ptr = dict(
            turb=draws.turb_noise, gumbel=draws.gumbel, u_src=draws.u_src,
            u_wind=draws.u_wind if field.wind is not None else None,
            bits=draws.bits, pos=state.pos, t=state.t, visited=state.visited,
            source=field.source, seed=field.seed, wind=field.wind,
            conc=state.conc,
            tke=state.tke, prev_conc=state.prev_conc,
            prev_action=state.prev_action, radius=state.radius,
            explore_bonus=state.explore_bonus, obs=obs_rows,
            action=traj.action, log_prob=traj.log_prob, value=traj.value,
            reward=traj.reward, done=traj.done, traj_pos=traj.pos,
            traj_conc=traj.conc, success=ep.success, steps=ep.steps,
            final_conc=ep.final_conc, source_x=ep.source_x,
            source_y=ep.source_y, rec_radius=ep.radius, distance=ep.distance,
            override=traj.override)
        params = _EnvStepParams(
            **{k: None if x is None else x.data_ptr() for k, x in ptr.items()},
            acc=(_P * 6)(*(getattr(accum, f).data_ptr()
                           for f in ACCUM_FIELDS)),
            rec=(_P * 6)(*(getattr(ep, f).data_ptr() for f in ACCUM_FIELDS)),
            n=n, length=length, num_actions=a, obs_dim=cfg.obs_dim,
            divisions=cfg.grid_divisions,
            max_steps=cfg.max_steps, variant=_VARIANTS[cfg.reward_variant],
            elastic=int(cfg.elastic_walls), obs_memory=int(cfg.obs_memory),
            field=plume_field(cfg), **env_step_scalars(cfg))
        self.params = params
        self.address = ctypes.addressof(params)
        # keeps every pointer's storage alive while the stepper is
        self.tensors = (state, accum, draws, traj, obs_rows)
        self.index, self.n, self.num_actions = index, n, a
        self.guided = traj.override is not None
        self.launch = _library().env_step

    def takes(self, logits: torch.Tensor, value: torch.Tensor,
              exec_action: torch.Tensor | None = None) -> bool:
        """Whether the kernel takes the policy's outputs: f32 logits [N, A]
        and value [N], and an executed action i64[N] (only in a guided
        chunk), contiguous, on the stepper's device."""
        n = self.n
        return (logits.dtype is _F32 and value.dtype is _F32
                and logits.shape == (n, self.num_actions)
                and value.shape == (n,) and logits.is_contiguous()
                and value.is_contiguous()
                and logits.get_device() == self.index == value.get_device()
                and (exec_action is None or (
                    self.guided and exec_action.dtype is _I64
                    and exec_action.shape == (n,)
                    and exec_action.is_contiguous()
                    and exec_action.get_device() == self.index)))

    def __call__(self, t: int, logits: torch.Tensor, value: torch.Tensor,
                 exec_action: torch.Tensor | None = None):
        global env_step_launches
        if not self.takes(logits, value, exec_action):    # _expect says why
            _expect("logits", logits, _F32, (self.n, self.num_actions),
                    self.index)
            _expect("value", value, _F32, (self.n,), self.index)
            if not self.guided:
                raise ValueError("an executed action needs a stepper over a "
                                 "trajectory with override rows")
            _expect("exec_action", exec_action, _I64, (self.n,), self.index)
        self.launch(self.address, t, logits.data_ptr(), value.data_ptr(),
                    None if exec_action is None else exec_action.data_ptr(),
                    _raw_stream(self.index))
        env_step_launches += 1

