"""Parity of the port's gather module (``tpu_plume_torch.ops.gather``) with
the JAX package's (``tpu_plume.ops.gather`` and the Pallas kernels
``bilinear_pallas`` / ``trilinear_pallas`` in interpret mode), on the CPU.

The wrappers' plain versions compute the functions of ``bilinear_xla`` and
``trilinear_zyx_xla`` in the same order of operations, so against those
they get rtol 1e-6 on fields in [0, 1) (a few ulp of the gathers' address
arithmetic and libm-free floats).  The one-hot matmul formulations (JAX's
``bilinear_onehot`` and the Pallas kernels) sum in another order and get
the tolerance ``tests/test_fields_ops.py`` gives the Pallas kernels (rtol
1e-4, atol 1e-5).  Points include exact grid points, the last cell,
coordinates outside the grid on both sides and the top z level.

The JAX module's single-field functions that no path of the port calls
(``bank_cell_lookup``, ``_axis_weights``, ``bilinear_onehot``,
``trilinear_xla``) are written here, in plain PyTorch, and held to JAX's.
"""

import os
import sysconfig

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_plume.ops import gather as jgather
from tpu_plume.ops.pallas_gather import bilinear_pallas
from tpu_plume.ops.pallas_trilinear import trilinear_pallas
from tpu_plume_torch.ops import build, gather

torch.set_num_threads(1)

EXACT = dict(rtol=1e-6, atol=1e-7)
ONEHOT = dict(rtol=1e-4, atol=1e-5)


def _edge_points(dims, n, rng):
    """[n + edges, len(dims)] points: uniform over the grid and 1 beyond it,
    then exact grid points, the last index, and points outside on both
    sides of every axis."""
    dims = np.asarray(dims, np.float32)
    pts = rng.uniform(-1.0, 1.0, (n, len(dims))) + rng.uniform(
        0.0, 1.0, (n, len(dims))) * dims
    edges = [np.zeros(len(dims)), dims - 1, dims - 1.5, -0.5 * np.ones(len(dims)),
             dims + 3.0, np.floor(dims / 2), dims - 2, [-7.0] + list(dims[1:] - 1)]
    return np.concatenate([pts, np.asarray(edges)]).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def bank_cell_lookup(bank_conc, idx, ix, iy):
    """Integer-cell lookup across a bank f32[K, H, W]."""
    return bank_conc[idx, ix, iy]


def _axis_weights(coord, size):
    """[N, size] with (1-f) at the lower corner and f at the one above."""
    c0, f = gather._axis(coord, size)
    cols = torch.arange(size, dtype=torch.int32, device=coord.device)[None]
    zero = torch.zeros((), dtype=f.dtype, device=f.device)
    return torch.where(cols == c0[:, None], (1.0 - f)[:, None],
                       torch.where(cols == c0[:, None] + 1, f[:, None], zero))


def bilinear_onehot(field, pts):
    """The TPU kernel's formulation, rowsum((Wx @ F) * Wy), in plain
    PyTorch: the same function as ``bilinear_xla`` by two products."""
    h, w = field.shape
    wx = _axis_weights(pts[:, 0], h)
    wy = _axis_weights(pts[:, 1], w)
    return torch.sum((wx @ field) * wy, dim=-1)


def trilinear_xla(volume, pts):
    """Trilinear sample of ``volume`` [T, H, W] at float points ``pts``
    [N, 3] = (t, x, y), clamped: the same function as ``trilinear_zyx_xla``
    with the frame axis in place of z."""
    return gather.trilinear_zyx_xla(volume, pts)


@pytest.mark.parametrize("h,w", [(37, 53), (2, 2), (64, 96)])
def test_bilinear_matches_jax_xla_onehot_and_pallas(h, w):
    rng = np.random.default_rng(h * w)
    field = rng.random((h, w), dtype=np.float32)
    pts = _edge_points((h, w), 300, rng)
    got = gather.bilinear_xla(_t(field), _t(pts)).numpy()
    np.testing.assert_allclose(got, np.asarray(jgather.bilinear_xla(
        jnp.asarray(field), jnp.asarray(pts))), **EXACT)
    np.testing.assert_allclose(got, np.asarray(jgather.bilinear_onehot(
        jnp.asarray(field), jnp.asarray(pts))), **ONEHOT)
    np.testing.assert_allclose(got, np.asarray(bilinear_pallas(
        jnp.asarray(field), jnp.asarray(pts), interpret=True)), **ONEHOT)
    # the port's one-hot formulation is the same function
    np.testing.assert_allclose(bilinear_onehot(_t(field), _t(pts)).numpy(),
                               got, **ONEHOT)
    # exact grid points read the cell
    np.testing.assert_array_equal(got[-8], field[0, 0])
    np.testing.assert_array_equal(got[-7], field[h - 1, w - 1])


@pytest.mark.parametrize("zd", [1, 2, 5, 8])
def test_trilinear_zyx_matches_jax_xla_and_pallas(zd):
    rng = np.random.default_rng(zd)
    vol = rng.random((zd, 40, 56), dtype=np.float32)
    pts = _edge_points((zd, 40, 56), 300, rng)
    got = gather.trilinear_zyx_xla(_t(vol), _t(pts)).numpy()
    np.testing.assert_allclose(got, np.asarray(jgather.trilinear_zyx_xla(
        jnp.asarray(vol), jnp.asarray(pts))), **EXACT)
    np.testing.assert_allclose(got, np.asarray(trilinear_pallas(
        jnp.asarray(vol), jnp.asarray(pts), interpret=True)), **ONEHOT)
    # the top level and the last cell read the corner exactly
    np.testing.assert_array_equal(got[-7], vol[zd - 1, 39, 55])
    np.testing.assert_array_equal(got[-8], vol[0, 0, 0])


def test_trilinear_xla_matches_jax():
    rng = np.random.default_rng(3)
    vol = rng.random((5, 16, 20), dtype=np.float32)
    pts = _edge_points((5, 16, 20), 200, rng)
    np.testing.assert_allclose(
        trilinear_xla(_t(vol), _t(pts)).numpy(),
        np.asarray(jgather.trilinear_xla(jnp.asarray(vol), jnp.asarray(pts))),
        **EXACT)


@pytest.mark.parametrize("size", [2, 9, 53])
def test_axis_weights_match_jax(size):
    rng = np.random.default_rng(size)
    coord = rng.uniform(-2.0, size + 2.0, 128).astype(np.float32)
    coord[:3] = [0.0, size - 1.0, size - 2.0]
    np.testing.assert_array_equal(
        _axis_weights(_t(coord), size).numpy(),
        np.asarray(jgather._axis_weights(jnp.asarray(coord), size)))


def test_bank_cell_lookup_matches_jax():
    rng = np.random.default_rng(5)
    bank = rng.random((6, 30, 40), dtype=np.float32)
    idx = rng.integers(0, 6, 100).astype(np.int32)
    ix = rng.integers(0, 30, 100).astype(np.int32)
    iy = rng.integers(0, 40, 100).astype(np.int32)
    np.testing.assert_array_equal(
        bank_cell_lookup(_t(bank), _t(idx), _t(ix), _t(iy)).numpy(),
        np.asarray(jgather.bank_cell_lookup(*map(jnp.asarray,
                                                 (bank, idx, ix, iy)))))


def test_stacked_bilinear_matches_per_row_jax_calls():
    rng = np.random.default_rng(6)
    stack = rng.random((7, 33, 45), dtype=np.float32)
    pts = _edge_points((33, 45), 400, rng)
    rows = rng.integers(0, 7, len(pts)).astype(np.int32)
    got = gather.bilinear(_t(stack), _t(rows), _t(pts)).numpy()
    for r in range(7):
        sel = rows == r
        want = np.asarray(jgather.bilinear_xla(jnp.asarray(stack[r]),
                                               jnp.asarray(pts[sel])))
        np.testing.assert_allclose(got[sel], want, **EXACT)


def test_stacked_trilinear_matches_per_row_jax_calls():
    rng = np.random.default_rng(7)
    stack = rng.random((6, 4, 21, 34), dtype=np.float32)
    pts = _edge_points((4, 21, 34), 400, rng)
    rows = rng.integers(0, 6, len(pts)).astype(np.int32)
    got = gather.trilinear_zyx(_t(stack), _t(rows), _t(pts)).numpy()
    for r in range(6):
        sel = rows == r
        want = np.asarray(jgather.trilinear_zyx_xla(jnp.asarray(stack[r]),
                                                    jnp.asarray(pts[sel])))
        np.testing.assert_allclose(got[sel], want, **EXACT)


def test_cell_offsets_take_64_bits():
    # A bank of 64 rows x 16 frames x 16 levels at 500 x 500 holds 4.1e9
    # cells; its last corner lies past 2^31.
    k, t, z, h, w = 64, 16, 16, 500, 500
    rows = torch.tensor([k * t - 1, 0, 3], dtype=torch.int32)
    zi = torch.tensor([z - 1, 0, 7], dtype=torch.int32)
    x0 = torch.tensor([h - 2, 0, 11], dtype=torch.int32)
    y0 = torch.tensor([w - 2, 1, 13], dtype=torch.int32)
    got = gather.cell_offsets(rows, zi, x0, y0, z, h, w)
    want = [((int(r) * z + int(q)) * h + int(a)) * w + int(b)
            for r, q, a, b in zip(rows, zi, x0, y0)]
    assert got.dtype == torch.int64
    assert got.tolist() == want
    assert want[0] + w + 1 == k * t * z * h * w - 1 > 2**31
    # two-dim stacks (fields) use the same arithmetic with z None
    got2 = gather.cell_offsets(rows, None, x0, y0, 1, 70000, 40000)
    assert got2[0].item() == ((k * t - 1) * 70000 + h - 2) * 40000 + w - 2


@pytest.mark.parametrize("shape", [(1, 6, 7), (2, 3, 6, 7), (1, 1, 6, 7)])
def test_moved_bytes_count_each_touched_cell_once(shape):
    d = len(shape) - 1
    per_query = 4 * d + 4 + 4
    cells = int(np.prod(shape))
    stack = torch.zeros(shape)
    # one query inside the grid touches 4 corners per level it reads
    # (two levels, or one where Z = 1)
    one = torch.full((1, d), 1.5)
    levels = 1 if d == 2 or shape[1] == 1 else 2
    assert gather.moved_bytes(stack, torch.zeros(1, dtype=torch.int32),
                              one) == per_query + 4 * 4 * levels
    # many queries over every row read each cell at most once
    rng = np.random.default_rng(cells)
    pts = _t(_edge_points(shape[1:], 4000, rng))
    rows = _t(rng.integers(0, shape[0], len(pts)).astype(np.int32))
    assert gather.moved_bytes(stack, rows, pts) == per_query * len(pts) + 4 * cells
    # the same query repeated reads its corners once
    twice = torch.cat([one, one])
    assert gather.moved_bytes(stack, torch.zeros(2, dtype=torch.int32),
                              twice) == 2 * per_query + 4 * 4 * levels


def test_wrappers_on_cpu_run_the_plain_version_and_launch_nothing():
    rng = np.random.default_rng(8)
    stack = _t(rng.random((3, 5, 12, 14), dtype=np.float32))
    pts = _t(_edge_points((5, 12, 14), 50, rng))
    rows = _t(rng.integers(0, 3, len(pts)).astype(np.int32))
    before = (gather.bilinear.launches, gather.trilinear_zyx.launches)
    assert torch.equal(gather.trilinear_zyx(stack, rows, pts),
                       gather.trilinear_zyx_plain(stack, rows, pts))
    assert torch.equal(gather.bilinear(stack[:, 0], rows, pts[:, 1:].contiguous()),
                       gather.bilinear_plain(stack[:, 0], rows, pts[:, 1:]))
    assert (gather.bilinear.launches, gather.trilinear_zyx.launches) == before


def test_kernel_wrappers_refuse_cpu_tensors_and_bad_inputs():
    stack3 = torch.zeros(2, 8, 8)
    stack4 = torch.zeros(2, 3, 8, 8)
    rows = torch.zeros(5, dtype=torch.int32)
    # no fallback: the kernels' wrappers never compute on the CPU
    with pytest.raises(ValueError, match="CUDA"):
        gather.bilinear_cuda(stack3, rows, torch.zeros(5, 2))
    with pytest.raises(ValueError, match="CUDA"):
        gather.trilinear_zyx_cuda(stack4, rows, torch.zeros(5, 3))
    with pytest.raises(TypeError):
        gather._check(stack3, rows.long(), torch.zeros(5, 2), 3)
    with pytest.raises(TypeError):
        gather._check(stack3.double(), rows, torch.zeros(5, 2), 3)
    with pytest.raises(ValueError, match="shape"):
        gather._check(stack4, rows, torch.zeros(5, 2), 4)
    with pytest.raises(ValueError, match="dims"):
        gather._check(stack4, rows, torch.zeros(5, 2), 3)
    with pytest.raises(ValueError, match="contiguous"):
        gather._check(stack3, rows, torch.zeros(2, 5).t(), 3)
    with pytest.raises(ValueError, match="contiguous"):
        gather._check(torch.zeros(8, 8, 2).permute(2, 0, 1), rows,
                      torch.zeros(5, 2), 3)
    with pytest.raises(ValueError, match="2 x 2"):
        gather._check(torch.zeros(2, 1, 8), rows, torch.zeros(5, 2), 3)
    with pytest.raises(ValueError, match="aligned"):
        gather._check(stack3, rows, torch.zeros(11)[1:].view(5, 2), 3)
    gather._check(stack4, rows, torch.zeros(5, 3), 4)   # a good call passes


def test_build_names_the_gather_source():
    assert build.source_path("gather").endswith("csrc/gather.cu")
    assert build.library_path("gather").startswith(build.BUILD_DIR)
    src = open(build.source_path("gather")).read()
    for name in ("bilinear_gather", "trilinear_zyx_gather", "bank_sample",
                 "int64_t", '#include "bank_sample.cuh"', "PyInit_gather",
                 "METH_FASTCALL"):
        assert name in src
    # the bank sample it includes carries the cell-hashed turbulence
    with open(os.path.join(build.CSRC, "bank_sample.cuh")) as fh:
        assert '#include "cell_hash.cuh"' in fh.read()
    # gather.cu is a Python extension module: its build sees Python's headers
    include = sysconfig.get_paths()["include"]
    flags = build.nvcc_flags()
    assert flags[:len(build.NVCC_FLAGS)] == build.NVCC_FLAGS
    assert flags[flags.index("-I") + 1] == include
    assert os.path.exists(os.path.join(include, "Python.h"))
