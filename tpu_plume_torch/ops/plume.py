"""Analytic plume sample, and the analytic env step built around it: the
port of ``tpu_plume/ops/pallas_plume.py``.

Two wrappers reach the kernels of ``tpu_plume_torch/csrc/plume.cu``:

- ``sample_plume(pos, source, seed, cfg)`` returns ``(conc, tke)`` at each
  query's grid cell.  On a CUDA tensor it launches ``plume_sample_kernel``
  or raises; on a CPU tensor it runs ``sample_plume_plain``, the same
  function in plain PyTorch, which is also the yardstick the kernel is held
  against on the card.
- ``EnvStepper`` launches ``env_step_kernel``: one analytic env step of every
  env per launch (action sample, move, plume sample, reward, auto-reset,
  trajectory rows), the rollout's step on the card with the analytic plume.
  Its plain version is ``tpu_plume_torch.rollout.rollout.env_step_plain``,
  which the rollout runs on the CPU.

Both entry points are METH_FASTCALL functions of an extension module
(``build.load_module``).  ``launches`` counts launches of the sample kernel
and ``env_step_launches`` those of the env-step kernel (and nothing else),
so a run can show that its env steps went through the kernels.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from tpu_plume_torch.core import prng
from tpu_plume_torch.core.config import EnvConfig

# Salts of the per-cell hash draws (tpu_plume/fields/analytic.py:30-31).
SALT_NORMAL = 0   # uses 0 and 1 (Box-Muller needs two uniforms)
SALT_UNIFORM = 2

# Bytes one query moves: pos f32[2], source f32[2], seed i32 read; conc and
# tke f32 written.
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


def sample_plume_plain(pos: torch.Tensor, source: torch.Tensor,
                       seed: torch.Tensor, cfg: EnvConfig):
    """The kernel's function in plain PyTorch: pos f32[N, 2], source
    f32[N, 2], seed int32[N] (uint32 bit pattern) -> conc, tke f32[N]."""
    ix, iy = cell_of(pos, cfg.grid_size)
    dx = ix.to(torch.float32) - source[..., 0]
    dy = iy.to(torch.float32) - source[..., 1]
    base = cfg.conc_peak * torch.exp(
        -(dx * dx + dy * dy) / (2.0 * cfg.plume_sigma**2))
    turb = turbulence(seed, ix, iy, cfg)

    conc = torch.clamp(base + turb, 0.0, cfg.conc_peak)
    tke = torch.abs(turb) * 2.0 if cfg.tke_abs_times_two else turb
    return conc, tke


def _expect(name: str, x: torch.Tensor, dtype, shape, index: int) -> None:
    """Raise unless ``x`` is a contiguous ``dtype`` tensor of ``shape`` on
    device ``index`` (-1: the CPU)."""
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


def _check(pos, source, seed):
    """Raise unless the sample kernel takes these tensors."""
    n, index = pos.shape[0], pos.get_device()
    _expect("pos", pos, _F32, (n, 2), index)
    _expect("source", source, _F32, (n, 2), index)
    _expect("seed", seed, _I32, (n,), index)
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
        _raw_stream = torch._C._cuda_getCurrentRawStream
        _ext = ext
    return _ext


def sample_plume_cuda(pos: torch.Tensor, source: torch.Tensor,
                      seed: torch.Tensor, cfg: EnvConfig):
    """Launches the sample kernel on the current stream of the tensors'
    device (the entry point checks the 8-byte alignment of pos and
    source)."""
    global launches
    index = pos.get_device()
    if index < 0:
        raise ValueError(f"sample_plume_cuda needs CUDA tensors, got "
                         f"{pos.device}")
    n = pos.shape[0]
    if not (pos.dtype is _F32 and source.dtype is _F32 and seed.dtype is _I32
            and pos.shape == source.shape == (n, 2) and seed.shape == (n,)
            and source.get_device() == index == seed.get_device()
            and pos.is_contiguous() and source.is_contiguous()
            and seed.is_contiguous()):
        _check(pos, source, seed)          # says what failed
    conc, tke = pos.new_empty((2, n)).unbind()
    if _ext is None:
        _library()
    _ext.plume_sample(
        pos.data_ptr(), source.data_ptr(), seed.data_ptr(), conc.data_ptr(),
        tke.data_ptr(), n, cfg.grid_size, cfg.conc_peak,
        2.0 * cfg.plume_sigma**2, cfg.turbulence_intensity,
        int(cfg.turbulence_signed_normal), int(cfg.tke_abs_times_two),
        _raw_stream(index))
    launches += 1
    return conc, tke


def sample_plume(pos: torch.Tensor, source: torch.Tensor, seed: torch.Tensor,
                 cfg: EnvConfig):
    """(conc, tke) f32[N] at the cells of ``pos``: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors."""
    if pos.device.type == "cpu":
        return sample_plume_plain(pos, source, seed, cfg)
    return sample_plume_cuda(pos, source, seed, cfg)


# --- the env step ----------------------------------------------------------

_P, _INT, _FLOAT = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


class _PlumeField(ctypes.Structure):
    """``PlumeField`` of ``csrc/plume.cu``, field by field."""

    _fields_ = [("grid", _INT), ("peak", _FLOAT), ("two_sigma2", _FLOAT),
                ("ti", _FLOAT), ("signed_normal", _INT),
                ("tke_abs_times_two", _INT)]


_STATE_PTRS = ("turb", "gumbel", "u_src", "bits", "pos", "t", "visited",
               "source", "seed", "conc", "tke", "prev_conc", "prev_action",
               "radius", "explore_bonus")
_TRAJ_PTRS = ("obs", "action", "log_prob", "value", "reward", "done",
              "traj_pos", "traj_conc", "success", "steps")
_RECORD_PTRS = ("final_conc", "source_x", "source_y", "rec_radius",
                "distance")
_INTS = ("n", "length", "num_actions", "obs_dim", "divisions", "max_steps",
         "variant", "elastic", "obs_memory")
_FLOATS = (
    "move_step", "turb_scale", "inv_tke_norm", "clip_hi", "wall_lo",
    "wall_hi", "g", "inv_g", "inv_peak", "inv_cell", "inv_visit_norm",
    "visit_pow", "inv_max_steps", "neg_move_coef", "inv_move_step",
    "v10_move", "v10_margin", "v10_boundary", "decay_start", "gradient_gate",
    "neg_boundary_penalty", "conc_coef", "inplume_bonus", "inplume_floor",
    "turn_half", "neg_tke_factor", "r0", "term_coef", "term_cap",
    "depth_coef", "depth_power", "gate_radius", "src_lo", "src_span")


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


def _recip(x: float) -> float:
    """1 / x as PyTorch divides a tensor on the card by the Python scalar
    ``x``: a multiply by the f32 reciprocal of f32(x)."""
    return float(np.float32(1.0) / np.float32(x))


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
        gate_radius=cfg.terminal_gate_radius, src_lo=lo, src_span=hi - lo)


def check_env_step(cfg: EnvConfig) -> None:
    """Raise unless the env-step kernel computes ``cfg``'s env step: the
    analytic isotropic plume in 2-D flight, a reward form it knows, at most
    ``_MAX_ACTIONS`` actions."""
    if cfg.plume_model != "isotropic" or cfg.env_3d:
        raise ValueError(f"the env-step kernel runs the isotropic plume in "
                         f"2-D flight, got plume_model={cfg.plume_model!r}, "
                         f"env_3d={cfg.env_3d}")
    if cfg.reward_variant not in _VARIANTS:
        raise ValueError(f"reward_variant must be one of {tuple(_VARIANTS)}, "
                         f"got {cfg.reward_variant!r}")
    if cfg.num_actions > _MAX_ACTIONS:
        raise ValueError(f"the env-step kernel takes at most {_MAX_ACTIONS} "
                         f"actions, got {cfg.num_actions}")


def env_step_bytes(cfg: EnvConfig, n: int, dones: int, greedy: bool) -> int:
    """Bytes one env step of ``n`` envs must move, ``dones`` of them
    finishing: each input the kernel reads and each output it writes, once.
    Per env: the logits (and the Gumbel row) and the value; the
    displacement normals; pos, t, the visit cell, source, seed, conc, tke,
    radius, explore bonus and the six totals read (and prev_action for the
    delta reward); the trajectory row (action i64, log-prob, value, reward,
    done, pos, conc) and the record row (success, steps, six totals, final
    conc, source, radius, distance) written; pos, t, conc, tke, prev_conc,
    prev_action, the six totals and the next obs written.  A finished env
    also reads its reset draws (source uniforms, seed), writes source and
    seed, and clears its D x D visit grid in place of the visit cell."""
    a, d = cfg.num_actions, cfg.grid_divisions
    reads = (4 * a * (1 if greedy else 2) + 4 + 8 + 8 + 4 + 4 + 8 + 4 + 4
             + 4 + 4 + 4 + 6 * 4 + (8 if cfg.reward_variant == "delta" else 0))
    traj = 8 + 4 + 4 + 4 + 1 + 8 + 4
    record = 1 + 4 + 6 * 4 + 4 + 8 + 4 + 4
    state = 8 + 4 + 4 + 4 + 4 + 8 + 6 * 4 + 4 * cfg.obs_dim
    per_env = reads + traj + record + state
    return (n * per_env + (n - dones) * 4
            + dones * (8 + 4 + 8 + 4 + 4 * d * d))


def check_env_step_inputs(state, accum, draws, traj, obs_rows, cfg,
                          index: int) -> None:
    """Raise unless the env-step kernel takes these tensors on device
    ``index`` (-1: the CPU, where only the tests call this): ``cfg``'s env
    (``check_env_step``); every tensor contiguous, of its dtype and shape,
    on the device; the float2 reads 8-byte aligned; draws of at least as
    many steps as ``traj``; the record's ``done`` the trajectory's and its
    ``final_x`` / ``final_y`` views of ``traj.pos``."""
    check_env_step(cfg)
    n, length = state.pos.shape[0], traj.action.shape[0]
    a, dv, od = cfg.num_actions, cfg.grid_divisions, cfg.obs_dim
    steps = draws.turb_noise.shape[0]
    if steps < length:
        raise ValueError(f"draws of {steps} steps for a chunk of {length}")
    field, ep = state.field, traj.episode
    if field.idx is not None:
        raise ValueError("the env-step kernel samples no bank")
    tensors = {
        "turb_noise": (draws.turb_noise, _F32, (steps, n, 2)),
        "u_src": (draws.u_src, _F32, (steps, n, 2)),
        "bits": (draws.bits, _I32, (steps, n)),
        "pos": (state.pos, _F32, (n, 2)), "t": (state.t, _I32, (n,)),
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
        "traj_pos": (traj.pos, _F32, (length, n, 2)),
        "success": (ep.success, _BOOL, (length, n)),
        "steps": (ep.steps, _I32, (length, n)),
    }
    if draws.gumbel is not None:
        tensors["gumbel"] = (draws.gumbel, _F32, (steps, n, a))
    for name in ("log_prob", "value", "reward", "conc"):
        tensors["traj " + name] = (getattr(traj, name), _F32, (length, n))
    for name in ACCUM_FIELDS + ("final_conc", "source_x", "source_y",
                                "radius", "distance"):
        tensors["record " + name] = (getattr(ep, name), _F32, (length, n))
    for name in ACCUM_FIELDS:
        tensors["accum " + name] = (getattr(accum, name), _F32, (n,))
    for name, (x, dtype, shape) in tensors.items():
        _expect(name, x, dtype, shape, index)
    for name in ("turb_noise", "u_src", "pos", "source", "traj_pos"):
        _aligned(name, tensors[name][0])
    if ep.done.data_ptr() != traj.done.data_ptr() or (
            ep.done.shape != traj.done.shape):
        raise ValueError("traj.episode.done must be traj.done")
    for k, name in enumerate(("final_x", "final_y")):
        view = getattr(ep, name)
        if (view.data_ptr() != traj.pos.data_ptr() + 4 * k
                or view.shape != (length, n) or view.stride() != (2 * n, 2)):
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
    the next obs into ``obs_rows[t + 1]``."""

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
            bits=draws.bits, pos=state.pos, t=state.t, visited=state.visited,
            source=field.source, seed=field.seed, conc=state.conc,
            tke=state.tke, prev_conc=state.prev_conc,
            prev_action=state.prev_action, radius=state.radius,
            explore_bonus=state.explore_bonus, obs=obs_rows,
            action=traj.action, log_prob=traj.log_prob, value=traj.value,
            reward=traj.reward, done=traj.done, traj_pos=traj.pos,
            traj_conc=traj.conc, success=ep.success, steps=ep.steps,
            final_conc=ep.final_conc, source_x=ep.source_x,
            source_y=ep.source_y, rec_radius=ep.radius, distance=ep.distance)
        params = _EnvStepParams(
            **{k: None if x is None else x.data_ptr() for k, x in ptr.items()},
            acc=(_P * 6)(*(getattr(accum, f).data_ptr()
                           for f in ACCUM_FIELDS)),
            rec=(_P * 6)(*(getattr(ep, f).data_ptr() for f in ACCUM_FIELDS)),
            n=n, length=length, num_actions=a, obs_dim=cfg.obs_dim,
            divisions=cfg.grid_divisions,
            max_steps=cfg.max_steps, variant=_VARIANTS[cfg.reward_variant],
            elastic=int(cfg.elastic_walls), obs_memory=int(cfg.obs_memory),
            field=_PlumeField(cfg.grid_size, cfg.conc_peak,
                              2.0 * cfg.plume_sigma**2,
                              cfg.turbulence_intensity,
                              int(cfg.turbulence_signed_normal),
                              int(cfg.tke_abs_times_two)),
            **env_step_scalars(cfg))
        self.params = params
        self.address = ctypes.addressof(params)
        # keeps every pointer's storage alive while the stepper is
        self.tensors = (state, accum, draws, traj, obs_rows)
        self.index, self.n, self.num_actions = index, n, a
        self.launch = _library().env_step

    def takes(self, logits: torch.Tensor, value: torch.Tensor) -> bool:
        """Whether the kernel takes the policy's outputs: f32 logits [N, A]
        and value [N], contiguous, on the stepper's device."""
        n = self.n
        return (logits.dtype is _F32 and value.dtype is _F32
                and logits.shape == (n, self.num_actions)
                and value.shape == (n,) and logits.is_contiguous()
                and value.is_contiguous()
                and logits.get_device() == self.index == value.get_device())

    def __call__(self, t: int, logits: torch.Tensor, value: torch.Tensor):
        global env_step_launches
        if not self.takes(logits, value):    # _expect says why
            _expect("logits", logits, _F32, (self.n, self.num_actions),
                    self.index)
            _expect("value", value, _F32, (self.n,), self.index)
        self.launch(self.address, t, logits.data_ptr(), value.data_ptr(),
                    _raw_stream(self.index))
        env_step_launches += 1

