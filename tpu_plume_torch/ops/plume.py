"""Analytic plume sample: the port of ``tpu_plume/ops/pallas_plume.py``.

``sample_plume(pos, source, seed, cfg)`` returns ``(conc, tke)`` at each
query's grid cell.  On a CUDA tensor it launches the hand-written kernel of
``tpu_plume_torch/csrc/plume.cu`` or raises; on a CPU tensor it runs
``sample_plume_plain``, the same function in plain PyTorch, which is also
the yardstick the kernel is held against on the card.

``launches`` counts kernel launches (and nothing else), so a run can show
that its env steps went through the kernel.
"""

from __future__ import annotations

import ctypes

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


def _check(pos, source, seed):
    n = pos.shape[0]
    for name, t, dtype, shape in (
        ("pos", pos, torch.float32, (n, 2)),
        ("source", source, torch.float32, (n, 2)),
        ("seed", seed, torch.int32, (n,)),
    ):
        if t.device != pos.device:
            raise ValueError(f"{name} is on {t.device}, pos on {pos.device}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in (("pos", pos), ("source", source)):
        if t.data_ptr() % 8:
            raise ValueError(f"{name} must be 8-byte aligned (read as float2)")


_entry = None   # the loaded C entry point, set at first launch


def _library():
    global _entry
    if _entry is None:
        from tpu_plume_torch.ops import build

        fn = build.load("plume").plume_sample
        fn.argtypes = [ctypes.c_void_p] * 5 + [
            ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float,
            ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        _entry = fn
    return _entry


def sample_plume_cuda(pos: torch.Tensor, source: torch.Tensor,
                      seed: torch.Tensor, cfg: EnvConfig):
    """Launches the CUDA kernel on the current stream of the current
    device, which must hold the tensors."""
    global launches
    if pos.device.type != "cuda":
        raise ValueError(f"sample_plume_cuda needs CUDA tensors, got {pos.device}")
    if pos.device.index != torch.cuda.current_device():
        raise ValueError(f"tensors on {pos.device}, current device is "
                         f"cuda:{torch.cuda.current_device()}")
    _check(pos, source, seed)
    n = pos.shape[0]
    conc = torch.empty(n, dtype=torch.float32, device=pos.device)
    tke = torch.empty(n, dtype=torch.float32, device=pos.device)
    err = _library()(
        pos.data_ptr(), source.data_ptr(), seed.data_ptr(), conc.data_ptr(),
        tke.data_ptr(), n, cfg.grid_size, cfg.conc_peak,
        2.0 * cfg.plume_sigma**2, cfg.turbulence_intensity,
        int(cfg.turbulence_signed_normal), int(cfg.tke_abs_times_two),
        torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"plume_sample launch failed: cudaError {err}")
    launches += 1
    return conc, tke


def sample_plume(pos: torch.Tensor, source: torch.Tensor, seed: torch.Tensor,
                 cfg: EnvConfig):
    """(conc, tke) f32[N] at the cells of ``pos``: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors."""
    if pos.device.type == "cpu":
        return sample_plume_plain(pos, source, seed, cfg)
    return sample_plume_cuda(pos, source, seed, cfg)
