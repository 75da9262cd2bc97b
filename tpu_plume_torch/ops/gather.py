"""Field-query gathers and the env's sub-cell bank sample: the port of
``tpu_plume/ops/gather.py``, of the two Pallas kernels behind it
(``ops/pallas_gather.py``, ``ops/pallas_trilinear.py``), and of the
gridded sub-cell branch of ``sample_conc_tke``
(``tpu_plume/fields/analytic.py:245-266``) that is built on them.

Two calls reach the kernels of ``tpu_plume_torch/csrc/gather.cu``:

- The gathers alone, over a stack of fields or volumes with one row per
  query (the TPU kernels' own call is the stack of one):

    bilinear(stack f32[R, H, W], rows i32[N], pts f32[N, 2] = (x, y))      -> f32[N]
    trilinear_zyx(stack f32[R, Z, H, W], rows i32[N], pts f32[N, 3] = (z, x, y)) -> f32[N]

  Each samples row ``rows[i]`` at ``pts[i]`` in index units, clamped to the
  grid, with the weights and the order of operations of ``bilinear_xla``
  and ``trilinear_zyx_xla``.
- The env step's sub-cell sample of a ``FieldBank``, one launch a sample:

    sample_bank_conc_tke(bank, idx i32[N], pos f32[N, pos_dim], t i32[N] or None,
                         seed i32[N], cfg) -> (conc, tke) f32[N]

  the bank row at the env step's frame (and height, in 3-D flight) between
  cells, plus the cell-hashed turbulence, clipped.  Its plain version,
  ``sample_bank_conc_tke_plain``, is ``bank_points`` through the plain
  gathers and ``plume.turbulence``.  On the card the bank is validated once
  (``check_bank``) into a ``BankSampler``, which caches what a launch needs;
  ``FieldBank.sampler`` keeps it.

Rows must lie in range: the plain versions raise ``IndexError`` for one
outside, the kernels do not check (a check on the card would cost a sync)
and read outside the stack.  The callers keep rows in range by
construction.  On a CUDA tensor a wrapper launches its kernel or raises; on
a CPU tensor it runs the plain PyTorch version, which is also the yardstick
the kernel is held against on the card.  ``bilinear.launches`` and
``trilinear_zyx.launches`` count each kernel's launches in both forms: a
static bank's sample is a bilinear launch, a time-varying or 3-D bank's a
trilinear one.
"""

from __future__ import annotations

import ctypes

import torch

from tpu_plume_torch.ops import plume
from tpu_plume_torch.ops.plume import _BankParams, _expect

_F32, _I32 = torch.float32, torch.int32


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


def _corner_cells(stack: torch.Tensor, rows: torch.Tensor,
                  pts: torch.Tensor) -> torch.Tensor:
    """int64 offsets of every corner the gather of ``pts`` reads."""
    d = pts.shape[1]
    dims = stack.shape[1:]
    zd = dims[0] if d == 3 else 1
    h, w = dims[-2:]
    x0, _ = _axis(pts[:, -2], h)
    y0, _ = _axis(pts[:, -1], w)
    levels = [None]
    if d == 3:
        z0, _ = _axis(pts[:, 0], zd)
        levels = [z0, torch.clamp(z0 + 1, max=zd - 1)]
    return torch.cat([cell_offsets(rows, z, x0, y0, zd, h, w) + dx * w + dy
                      for z in levels for dx in (0, 1) for dy in (0, 1)])


def moved_bytes(stack: torch.Tensor, rows: torch.Tensor,
                pts: torch.Tensor) -> int:
    """Bytes a gather over ``stack`` must move at least: each query's point
    and row read and its sample written once, and each cell of the stack
    that some query's corners touch read once, however many queries touch
    it."""
    n, d = pts.shape
    corners = _corner_cells(stack, rows, pts)
    return n * (4 * d + 4 + 4) + 4 * torch.unique(corners).numel()


def _zero_rows(pts: torch.Tensor) -> torch.Tensor:
    return torch.zeros(pts.shape[0], dtype=torch.int32, device=pts.device)


def bilinear_xla(field: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Bilinear sample of ``field`` [H, W] at float points ``pts`` [N, 2],
    clamped to the grid: the stack of one through ``bilinear``."""
    return bilinear(field[None].contiguous(), _zero_rows(pts), pts.contiguous())


def trilinear_zyx_xla(volume: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Trilinear sample of ``volume`` [Z, H, W] at float points ``pts``
    [N, 3] = (z, x, y) in index units, clamped: the stack of one through
    ``trilinear_zyx``."""
    return trilinear_zyx(volume[None].contiguous(), _zero_rows(pts),
                         pts.contiguous())


# --- a bank's frame and level coordinates, and its sub-cell sample ----------
#
# A ``bank`` here is a ``FieldBank`` of ``tpu_plume_torch.fields.gridded``:
# ``conc`` f32 [K, H, W], [K, T, H, W] or [K, T, Z, H, W], and the scalars
# ``steps_per_frame`` and ``z_extent``.  These are the plain versions of the
# sample kernels' prologue.


def frame_coord(bank, t, like: torch.Tensor) -> torch.Tensor:
    """Env step ``t`` (None: 0) in frame-index units.  A true division on
    every device, as in the JAX package and the kernel: a CUDA tensor
    divided by a Python scalar is multiplied by the scalar's f32 reciprocal,
    which differs in the last bit where ``steps_per_frame`` is not a power
    of two."""
    tf = (torch.zeros_like(like, dtype=torch.float32) if t is None
          else t.to(torch.float32))
    return tf / torch.full_like(tf, bank.steps_per_frame)


def frame_weights(bank, t, like: torch.Tensor):
    """(t0 i32, ft f32): lower frame and its weight at env step ``t``.  A
    one-frame bank gets t0 = -1 and ft = 1, which reads frame 0 (negative
    indices wrap), as in the JAX package."""
    num_frames = bank.conc.shape[1]
    tf = frame_coord(bank, t, like)
    t0 = torch.clamp(torch.floor(tf).to(torch.int32), 0, num_frames - 2)
    ft = torch.clamp(tf - t0, 0.0, 1.0)
    return t0, ft


def level_coord(bank, z, like: torch.Tensor) -> torch.Tensor:
    """Height ``z`` (grid units in [0, z_extent]) in level-index units; the
    scale is rounded to f32 once, as PyTorch and the kernel round it."""
    num_levels = bank.conc.shape[2]
    zeros = torch.zeros_like(like, dtype=torch.float32)
    if num_levels == 1 or z is None:
        return zeros
    return z.to(torch.float32) * ((num_levels - 1) / max(bank.z_extent, 1e-9))


def level_weights(bank, z, like: torch.Tensor):
    """(z0 i32, fz f32): lower level and its weight at height ``z``."""
    num_levels = bank.conc.shape[2]
    zf = level_coord(bank, z, like)
    if num_levels == 1:
        return zf.to(torch.int32), zf
    z0 = torch.clamp(torch.floor(zf).to(torch.int32), 0, num_levels - 2)
    fz = torch.clamp(zf - z0, 0.0, 1.0)
    return z0, fz


def bank_points(bank, idx: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                t=None, z=None, gathers=None) -> torch.Tensor:
    """Sub-cell samples f32[N] of bank rows ``idx`` i32[N] at float points:
    bilinear in (x, y), linear in z (5-D banks) and in t (4-D and 5-D
    banks), clamped to the grid, through the stack gathers ``gathers`` =
    (bilinear, trilinear_zyx) (default: this module's wrappers).  A static
    bank [K, H, W] is one bilinear call at rows ``idx``; a time-varying bank
    [K, T, H, W] one trilinear call with the frame axis as z; a 3-D bank
    [K, T, Z, H, W] two trilinear calls over its [K*T, Z, H, W] view, at
    frames t0 and t0+1, lerped by the frame weight."""
    bil, tri = gathers or (bilinear, trilinear_zyx)
    conc = bank.conc
    x = x.to(torch.float32)
    y = y.to(torch.float32)
    if conc.dim() == 3:
        return bil(conc, idx, torch.stack([x, y], -1))
    if conc.dim() == 4:
        tf = frame_coord(bank, t, x)
        return tri(conc, idx, torch.stack([tf, x, y], -1))
    k, nt, nz, h, w = conc.shape
    pts = torch.stack([level_coord(bank, z, x), x, y], -1)
    volumes = conc.view(k * nt, nz, h, w)
    if nt == 1:      # one frame: no time interpolation (and no row idx - 1)
        return tri(volumes, idx, pts)
    t0, ft = frame_weights(bank, t, x)
    row0 = idx * nt + t0
    a = tri(volumes, row0, pts)
    b = tri(volumes, row0 + 1, pts)
    return (1.0 - ft) * a + ft * b


def sample_bank_conc_tke_plain(bank, idx: torch.Tensor, pos: torch.Tensor,
                               t, seed: torch.Tensor, cfg):
    """The sample kernels' function in plain PyTorch: ``bank_points``
    through the plain gathers at pos[:, :2] (and height pos[:, 2] in 3-D
    flight), plus the turbulence hashed at the grid cell, clipped to
    [0, peak]; tke is the turbulence, or 2|turbulence| (V1.0)."""
    z = pos[:, 2] if cfg.env_3d else None
    base = bank_points(bank, idx, pos[:, 0], pos[:, 1], t, z,
                       gathers=(bilinear_plain, trilinear_zyx_plain))
    ix, iy = plume.cell_of(pos[:, :2], cfg.grid_size)
    turb = plume.turbulence(seed, ix, iy, cfg)
    conc = torch.clamp(base + turb, 0.0, cfg.conc_peak)
    tke = torch.abs(turb) * 2.0 if cfg.tke_abs_times_two else turb
    return conc, tke


def sample_moved_bytes(bank, idx: torch.Tensor, pos: torch.Tensor, t,
                       cfg) -> int:
    """Bytes a bank sample must move at least: each query's idx, pos, t and
    seed read and its conc and tke written once, and each bank cell that
    some query's corners touch read once."""
    corners = []

    def collect(stack, rows, pts):
        # offsets into the bank's storage: every stack is a view of it
        corners.append(_corner_cells(stack, rows, pts))
        return torch.zeros(rows.shape[0], device=rows.device)

    z = pos[:, 2] if cfg.env_3d else None
    bank_points(bank, idx, pos[:, 0], pos[:, 1], t, z,
                gathers=(collect, collect))
    n, d = pos.shape
    return (n * (4 * d + 4 * 5)
            + 4 * torch.unique(torch.cat(corners)).numel())


# --- the kernels' wrappers --------------------------------------------------


def _check(stack, rows, pts, ndim: int):
    """Raise unless the gather kernel over a stack of ``ndim`` dims takes
    these tensors."""
    n = pts.shape[0]
    index = stack.get_device()
    _expect("rows", rows, _I32, (n,), index)
    _expect("pts", pts, _F32, (n, ndim - 1), index)
    if stack.dtype is not _F32:
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


# The sample kernels' modes (``Mode`` of ``csrc/bank_sample.cuh``).
_STATIC, _FRAMES, _ONE_FRAME, _TWO_FRAMES = 2, 3, 4, 5

_ext = None          # the kernels' extension module, set at first launch
_raw_stream = None   # the current stream's handle by device index
_gathers = {}        # the gathers' entry points, by the stack's dims


def _library():
    """The extension module of ``csrc/gather.cu`` (``build.load_module``):
    METH_FASTCALL entry points, each of which launches or raises."""
    global _ext, _raw_stream
    if _ext is None:
        from tpu_plume_torch.ops import build

        ext = build.load_module("gather")
        if ext.BANK_PARAMS_SIZE != ctypes.sizeof(_BankParams):
            raise RuntimeError("_BankParams does not match csrc/gather.cu")
        _gathers[3] = ext.bilinear_gather
        _gathers[4] = ext.trilinear_zyx_gather
        _raw_stream = torch._C._cuda_getCurrentRawStream
        _ext = ext
    return _ext


def _takes(stack, rows, pts, ndim: int, index: int, n: int) -> bool:
    """``_check``'s conditions in one expression, for the launch path (the
    kernel's entry point checks the 8-byte alignment of 2-D points)."""
    shape = stack.shape
    return (stack.dtype is _F32 and rows.dtype is _I32 and pts.dtype is _F32
            and len(shape) == ndim and rows.shape == (n,)
            and pts.shape == (n, ndim - 1)
            and rows.get_device() == index == pts.get_device()
            and stack.is_contiguous() and rows.is_contiguous()
            and pts.is_contiguous() and shape[0] >= 1 and shape[-2] >= 2
            and shape[-1] >= 2)


def _launch(counter, ndim, stack, rows, pts):
    """Launch the gather over ``stack`` of ``ndim`` dims, [R, (Z,) H, W],
    counting it on ``counter``.  It runs on the current stream of the
    tensors' device: a launch while another device is current fails and
    raises."""
    index = stack.get_device()
    if index < 0:
        raise ValueError(f"the gather kernels need CUDA tensors, got "
                         f"{stack.device}")
    n = pts.shape[0]
    if not _takes(stack, rows, pts, ndim, index, n):
        _check(stack, rows, pts, ndim)     # says what failed
    out = pts.new_empty(n)
    if not _gathers:
        _library()
    _gathers[ndim](stack.data_ptr(), rows.data_ptr(), pts.data_ptr(),
                   out.data_ptr(), n, stack.shape, _raw_stream(index))
    counter.launches += 1
    return out


def bilinear_cuda(stack: torch.Tensor, rows: torch.Tensor,
                  pts: torch.Tensor) -> torch.Tensor:
    """Launches the bilinear kernel, the gather alone."""
    return _launch(bilinear, 3, stack, rows, pts)


def trilinear_zyx_cuda(stack: torch.Tensor, rows: torch.Tensor,
                       pts: torch.Tensor) -> torch.Tensor:
    """Launches the trilinear kernel, the gather alone."""
    return _launch(trilinear_zyx, 4, stack, rows, pts)


def bilinear(stack: torch.Tensor, rows: torch.Tensor,
             pts: torch.Tensor) -> torch.Tensor:
    """Bilinear samples f32[N] of rows of ``stack`` [R, H, W]: the CUDA
    kernel for CUDA tensors, the plain version for CPU tensors."""
    if stack.is_cpu:
        return bilinear_plain(stack, rows, pts)
    return bilinear_cuda(stack, rows, pts)


def trilinear_zyx(stack: torch.Tensor, rows: torch.Tensor,
                  pts: torch.Tensor) -> torch.Tensor:
    """Trilinear samples f32[N] of rows of ``stack`` [R, Z, H, W]: the CUDA
    kernel for CUDA tensors, the plain version for CPU tensors."""
    if stack.is_cpu:
        return trilinear_zyx_plain(stack, rows, pts)
    return trilinear_zyx_cuda(stack, rows, pts)


bilinear.launches = 0
trilinear_zyx.launches = 0


def check_bank(conc: torch.Tensor) -> None:
    """Raise unless the sample kernels take the bank ``conc``: f32,
    contiguous, [K, H, W], [K, T, H, W] or [K, T, Z, H, W] with H, W >= 2,
    each dim after K below 2^31 (the kernel's ints), its bytes within 64-bit
    offsets, 8-byte aligned."""
    if conc.dtype is not _F32:
        raise TypeError(f"bank must be torch.float32, got {conc.dtype}")
    if conc.dim() not in (3, 4, 5):
        raise ValueError(f"bank must have 3, 4 or 5 dims, got {conc.dim()}")
    if not conc.is_contiguous():
        raise ValueError("bank must be contiguous")
    shape = tuple(conc.shape)
    if min(shape) < 1 or shape[-2] < 2 or shape[-1] < 2:
        raise ValueError(f"bank rows must hold at least 2 x 2 cells, got "
                         f"{shape}")
    if max(shape[1:]) >= 2**31 or 4 * conc.numel() >= 2**62:
        raise ValueError(f"bank {shape} is beyond the kernel's offsets")
    if conc.data_ptr() % 8:
        raise ValueError("bank must be 8-byte aligned")


def _check_queries(idx, pos, t, seed, pos_dim: int, index: int) -> None:
    """Raise unless the sample kernel takes these per-query tensors on
    device ``index``."""
    n = idx.shape[0]
    _expect("idx", idx, _I32, (n,), index)
    _expect("pos", pos, _F32, (n, pos_dim), index)
    _expect("seed", seed, _I32, (n,), index)
    if t is not None:
        _expect("t", t, _I32, (n,), index)


def _field_scalars(cfg) -> tuple:
    return (cfg.pos_dim, cfg.grid_size, cfg.conc_peak,
            cfg.turbulence_intensity, cfg.turbulence_signed_normal,
            cfg.tke_abs_times_two)


class BankSampler:
    """The sample kernel's launch for one bank on the card and the field
    scalars of one env config.  Made once, where the bank becomes the
    train step's (``FieldBank.sampler``): it validates the bank and caches
    the launch's pointer, dims and scalars in a ``_BankParams``.  A call
    then checks the per-query tensors in one expression (``takes``),
    allocates conc and tke, reads the current stream and makes one call of
    the kernel's entry point, which raises if the launch is refused."""

    def __init__(self, bank, cfg):
        conc = bank.conc
        check_bank(conc)
        if not conc.is_cuda:
            raise ValueError(f"BankSampler needs a bank on the card, got "
                             f"{conc.device}")
        dims = conc.shape[1:]
        nt = dims[0] if conc.dim() > 3 else 1
        nz = dims[1] if conc.dim() == 5 else 1
        mode = {3: _STATIC, 4: _FRAMES,
                5: _ONE_FRAME if nt == 1 else _TWO_FRAMES}[conc.dim()]
        self.params = _BankParams(
            conc.data_ptr(), mode, cfg.pos_dim, nt, nz, dims[-2], dims[-1],
            cfg.grid_size, bank.steps_per_frame,
            (nz - 1) / max(bank.z_extent, 1e-9), cfg.conc_peak,
            cfg.turbulence_intensity, int(cfg.turbulence_signed_normal),
            int(cfg.tke_abs_times_two))
        self.address = ctypes.addressof(self.params)
        self.conc = conc                 # keeps the pointer's storage alive
        self.cfg, self.scalars = cfg, _field_scalars(cfg)
        self.pos_dim = cfg.pos_dim
        self.index = conc.get_device()
        self.counter = bilinear if conc.dim() == 3 else trilinear_zyx
        self.launch = _library().bank_sample

    def serves(self, cfg) -> bool:
        """Whether this sampler's cached scalars are ``cfg``'s."""
        return cfg is self.cfg or _field_scalars(cfg) == self.scalars

    def takes(self, idx, pos, t, seed) -> bool:
        """``_check_queries``' conditions in one expression."""
        n, index = idx.shape[0], self.index
        return (idx.dtype is _I32 and seed.dtype is _I32 and pos.dtype is _F32
                and idx.shape == seed.shape == (n,)
                and pos.shape == (n, self.pos_dim)
                and idx.get_device() == seed.get_device() == index
                and pos.get_device() == index and idx.is_contiguous()
                and seed.is_contiguous() and pos.is_contiguous()
                and (t is None or (t.dtype is _I32 and t.shape == (n,)
                                   and t.get_device() == index
                                   and t.is_contiguous())))

    def __call__(self, idx, pos, t, seed):
        if not self.takes(idx, pos, t, seed):    # _check_queries says why
            _check_queries(idx, pos, t, seed, self.pos_dim, self.index)
        n = idx.shape[0]
        conc, tke = pos.new_empty((2, n)).unbind()
        self.launch(self.address, idx.data_ptr(), pos.data_ptr(),
                    None if t is None else t.data_ptr(), seed.data_ptr(),
                    conc.data_ptr(), tke.data_ptr(), n,
                    _raw_stream(self.index))
        self.counter.launches += 1
        return conc, tke


def sample_bank_conc_tke(bank, idx: torch.Tensor, pos: torch.Tensor, t,
                         seed: torch.Tensor, cfg):
    """(conc, tke) f32[N] of ``bank`` between cells: one launch of the
    sample kernel for a bank on the card, the plain version for a bank on
    the CPU."""
    if bank.conc.is_cpu:
        return sample_bank_conc_tke_plain(bank, idx, pos, t, seed, cfg)
    return bank.sampler(cfg)(idx, pos, t, seed)
