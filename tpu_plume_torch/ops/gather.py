"""Field-query gathers: the port of ``tpu_plume/ops/gather.py`` and of the
two Pallas kernels behind it (``ops/pallas_gather.py``,
``ops/pallas_trilinear.py``).

The kernels' wrappers take a stack of fields or volumes and one row per
query, so that a bank's per-episode row and frame reach the kernel as an
offset:

    bilinear(stack f32[R, H, W], rows i32[N], pts f32[N, 2] = (x, y))      -> f32[N]
    trilinear_zyx(stack f32[R, Z, H, W], rows i32[N], pts f32[N, 3] = (z, x, y)) -> f32[N]

Each samples row ``rows[i]`` at ``pts[i]`` in index units, clamped to the
grid, with the weights and the order of operations of ``bilinear_xla`` and
``trilinear_zyx_xla``.  Rows must lie in [0, R): the plain version raises
``IndexError`` for one outside, the kernel does not check (a check on the
card would cost a sync) and reads outside the stack.  The bank's callers
keep rows in range by construction.  On a CUDA tensor a wrapper launches
its kernel of ``tpu_plume_torch/csrc/gather.cu`` or raises; on a CPU
tensor it runs the plain PyTorch version (``bilinear_plain``,
``trilinear_zyx_plain``), which is also the yardstick the kernel is held
against on the card.  Each wrapper counts its launches in its
``launches`` attribute.

The single-field functions of the JAX module (``bank_cell_lookup``,
``bilinear_xla``, ``bilinear_onehot``, ``trilinear_zyx_xla``,
``trilinear_xla``) are here too, in plain PyTorch: the stack of one is the
TPU kernels' own call.
"""

from __future__ import annotations

import ctypes

import torch

def bank_cell_lookup(bank_conc: torch.Tensor, idx: torch.Tensor,
                     ix: torch.Tensor, iy: torch.Tensor) -> torch.Tensor:
    """Integer-cell lookup across a bank f32[K, H, W]."""
    return bank_conc[idx, ix, iy]


def _axis(coord: torch.Tensor, size: int):
    """(lower corner i32, weight f32) of ``coord`` along an axis of ``size``
    cells: clamped to [0, size-1], the corner to [0, max(size-2, 0)]."""
    c = torch.clamp(coord, 0.0, size - 1.0)
    c0 = torch.clamp(torch.floor(c).to(torch.int32), 0, max(size - 2, 0))
    return c0, c - c0


def cell_offsets(rows: torch.Tensor, z: torch.Tensor | None, x0: torch.Tensor,
                 y0: torch.Tensor, zd: int, h: int, w: int) -> torch.Tensor:
    """int64 element offsets of cells (row, z, x0, y0) in a contiguous stack
    [R, zd, h, w] (``z`` None and ``zd`` 1 for a stack of fields); the
    kernels compute the same in 64 bits."""
    vol = rows.to(torch.int64) * zd
    if z is not None:
        vol = vol + z
    return (vol * h + x0) * w + y0


def _plane(flat, base, w, fx, fy):
    v00 = flat[base]
    v01 = flat[base + 1]
    v10 = flat[base + w]
    v11 = flat[base + w + 1]
    return (v00 * (1 - fx) * (1 - fy) + v01 * (1 - fx) * fy
            + v10 * fx * (1 - fy) + v11 * fx * fy)


def bilinear_plain(stack: torch.Tensor, rows: torch.Tensor,
                   pts: torch.Tensor) -> torch.Tensor:
    """The bilinear kernel's function in plain PyTorch."""
    _, h, w = stack.shape
    x0, fx = _axis(pts[:, 0], h)
    y0, fy = _axis(pts[:, 1], w)
    base = cell_offsets(rows, None, x0, y0, 1, h, w)
    return _plane(stack.reshape(-1), base, w, fx, fy)


def trilinear_zyx_plain(stack: torch.Tensor, rows: torch.Tensor,
                        pts: torch.Tensor) -> torch.Tensor:
    """The trilinear kernel's function in plain PyTorch."""
    _, zd, h, w = stack.shape
    z0, fz = _axis(pts[:, 0], zd)
    x0, fx = _axis(pts[:, 1], h)
    y0, fy = _axis(pts[:, 2], w)
    z1 = torch.clamp(z0 + 1, max=zd - 1)
    flat = stack.reshape(-1)
    p0 = _plane(flat, cell_offsets(rows, z0, x0, y0, zd, h, w), w, fx, fy)
    p1 = _plane(flat, cell_offsets(rows, z1, x0, y0, zd, h, w), w, fx, fy)
    return p0 * (1 - fz) + p1 * fz


def moved_bytes(stack: torch.Tensor, rows: torch.Tensor,
                pts: torch.Tensor) -> int:
    """Bytes a gather over ``stack`` must move at least: each query's point
    and row read and its sample written once, and each cell of the stack
    that some query's corners touch read once, however many queries touch
    it."""
    n, d = pts.shape
    dims = stack.shape[1:]
    zd = dims[0] if d == 3 else 1
    h, w = dims[-2:]
    x0, _ = _axis(pts[:, -2], h)
    y0, _ = _axis(pts[:, -1], w)
    levels = [None]
    if d == 3:
        z0, _ = _axis(pts[:, 0], zd)
        levels = [z0, torch.clamp(z0 + 1, max=zd - 1)]
    corners = torch.cat([cell_offsets(rows, z, x0, y0, zd, h, w) + dx * w + dy
                         for z in levels for dx in (0, 1) for dy in (0, 1)])
    return n * (4 * d + 4 + 4) + 4 * torch.unique(corners).numel()


def _zero_rows(pts: torch.Tensor) -> torch.Tensor:
    return torch.zeros(pts.shape[0], dtype=torch.int32, device=pts.device)


def bilinear_xla(field: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Bilinear sample of ``field`` [H, W] at float points ``pts`` [N, 2],
    clamped to the grid: the stack of one through ``bilinear``."""
    return bilinear(field[None].contiguous(), _zero_rows(pts), pts.contiguous())


def _axis_weights(coord: torch.Tensor, size: int) -> torch.Tensor:
    """[N, size] with (1-f) at the lower corner and f at the one above."""
    c0, f = _axis(coord, size)
    cols = torch.arange(size, dtype=torch.int32, device=coord.device)[None]
    zero = torch.zeros((), dtype=f.dtype, device=f.device)
    return torch.where(cols == c0[:, None], (1.0 - f)[:, None],
                       torch.where(cols == c0[:, None] + 1, f[:, None], zero))


def bilinear_onehot(field: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """The TPU kernel's formulation, rowsum((Wx @ F) * Wy), in plain
    PyTorch: the same function as ``bilinear_xla`` by two products."""
    h, w = field.shape
    wx = _axis_weights(pts[:, 0], h)
    wy = _axis_weights(pts[:, 1], w)
    return torch.sum((wx @ field) * wy, dim=-1)


def trilinear_zyx_xla(volume: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Trilinear sample of ``volume`` [Z, H, W] at float points ``pts``
    [N, 3] = (z, x, y) in index units, clamped: the stack of one through
    ``trilinear_zyx``."""
    return trilinear_zyx(volume[None].contiguous(), _zero_rows(pts),
                         pts.contiguous())


def trilinear_xla(volume: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Trilinear sample of ``volume`` [T, H, W] at float points ``pts``
    [N, 3] = (t, x, y), clamped: the same function as ``trilinear_zyx_xla``
    with the frame axis in place of z."""
    return trilinear_zyx_xla(volume, pts)


def _check(stack, rows, pts, ndim: int):
    n = pts.shape[0]
    for name, t, dtype, shape in (
        ("rows", rows, torch.int32, (n,)),
        ("pts", pts, torch.float32, (n, ndim - 1)),
    ):
        if t.device != stack.device:
            raise ValueError(f"{name} is on {t.device}, stack on {stack.device}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if stack.dtype != torch.float32:
        raise TypeError(f"stack must be torch.float32, got {stack.dtype}")
    if stack.dim() != ndim:
        raise ValueError(f"stack must have {ndim} dims, got {stack.dim()}")
    if not stack.is_contiguous():
        raise ValueError("stack must be contiguous")
    if stack.shape[0] < 1 or stack.shape[-2] < 2 or stack.shape[-1] < 2:
        raise ValueError(f"stack must hold a row of at least 2 x 2 cells, got "
                         f"{tuple(stack.shape)}")
    if ndim == 3 and pts.data_ptr() % 8:
        raise ValueError("pts must be 8-byte aligned (read as float2)")


_entries: dict = {}   # the loaded C entry points, by name


def _entry(name: str, num_ints: int):
    """The C entry point ``name``: four pointers, ``num_ints`` ints and the
    stream."""
    fn = _entries.get(name)
    if fn is None:
        from tpu_plume_torch.ops import build

        fn = getattr(build.load("gather"), name)
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * num_ints
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _entries[name] = fn
    return fn


def _launch(name, wrapper, ndim, stack, rows, pts):
    """Launch ``name`` over ``stack`` of ``ndim`` dims, [R, (Z,) H, W],
    counting it on ``wrapper``; its ints are N and the dims after R."""
    if stack.device.type != "cuda":
        raise ValueError(f"{name} needs CUDA tensors, got {stack.device}")
    if stack.device.index != torch.cuda.current_device():
        raise ValueError(f"tensors on {stack.device}, current device is "
                         f"cuda:{torch.cuda.current_device()}")
    _check(stack, rows, pts, ndim)
    n = pts.shape[0]
    dims = tuple(stack.shape[1:])
    out = torch.empty(n, dtype=torch.float32, device=stack.device)
    err = _entry(name, 1 + len(dims))(
        stack.data_ptr(), rows.data_ptr(), pts.data_ptr(), out.data_ptr(), n,
        *dims, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
    wrapper.launches += 1
    return out


def bilinear_cuda(stack: torch.Tensor, rows: torch.Tensor,
                  pts: torch.Tensor) -> torch.Tensor:
    """Launches the bilinear kernel on the current stream of the current
    device, which must hold the tensors."""
    return _launch("bilinear_gather", bilinear, 3, stack, rows, pts)


def trilinear_zyx_cuda(stack: torch.Tensor, rows: torch.Tensor,
                       pts: torch.Tensor) -> torch.Tensor:
    """Launches the trilinear kernel on the current stream of the current
    device, which must hold the tensors."""
    return _launch("trilinear_zyx_gather", trilinear_zyx, 4, stack, rows,
                   pts)


def bilinear(stack: torch.Tensor, rows: torch.Tensor,
             pts: torch.Tensor) -> torch.Tensor:
    """Bilinear samples f32[N] of rows of ``stack`` [R, H, W]: the CUDA
    kernel for CUDA tensors, the plain version for CPU tensors."""
    if stack.device.type == "cpu":
        return bilinear_plain(stack, rows, pts)
    return bilinear_cuda(stack, rows, pts)


def trilinear_zyx(stack: torch.Tensor, rows: torch.Tensor,
                  pts: torch.Tensor) -> torch.Tensor:
    """Trilinear samples f32[N] of rows of ``stack`` [R, Z, H, W]: the CUDA
    kernel for CUDA tensors, the plain version for CPU tensors."""
    if stack.device.type == "cpu":
        return trilinear_zyx_plain(stack, rows, pts)
    return trilinear_zyx_cuda(stack, rows, pts)


bilinear.launches = 0
trilinear_zyx.launches = 0
