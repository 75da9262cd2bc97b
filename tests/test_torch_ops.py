"""Parity of the port's hash and plume-sample kernel module with the JAX
package, on the CPU.

The same numpy inputs go through ``tpu_plume.core.prng`` /
``tpu_plume.ops.pallas_plume`` (interpret mode) / ``fields.analytic`` and
through ``tpu_plume_torch.core.prng`` / ``tpu_plume_torch.ops.plume``.  Hash
bits and uniforms are integer-exact and compared with equality.  Floats go
through exp/log/sin/cos of two libraries, so they get the tolerance
``tests/test_fields_ops.py`` gives the Pallas kernel (rtol 1e-5, atol 1e-4
on values up to 100).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_plume.core import prng as jprng
from tpu_plume.core.config import get_preset
from tpu_plume.fields.analytic import FieldState as JFieldState
from tpu_plume.fields.analytic import sample_conc_tke as j_sample_conc_tke
from tpu_plume.ops.pallas_plume import sample_plume_pallas
from tpu_plume_torch.core import get_preset as t_get_preset
from tpu_plume_torch.core import prng as tprng
from tpu_plume_torch.fields.analytic import FieldState, sample_conc_tke
from tpu_plume_torch.ops import build, plume

torch.set_num_threads(1)


def _hash_inputs(n=4000, seed=0):
    rng = np.random.default_rng(seed)
    seeds = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    seeds[:4] = [0, 1, 2**31, 2**32 - 1]
    ix = rng.integers(0, 500, n).astype(np.int32)
    iy = rng.integers(0, 500, n).astype(np.int32)
    return seeds, ix, iy


@pytest.mark.parametrize("salt", range(6))
def test_hash_cell_bits_equal(salt):
    seeds, ix, iy = _hash_inputs(seed=salt)
    want = np.asarray(jprng.hash_cell(jnp.asarray(seeds), jnp.asarray(ix),
                                      jnp.asarray(iy), salt))
    # the env stores seeds as int32 bit patterns; both forms must agree
    for s in (torch.from_numpy(seeds.view(np.int32)),
              torch.from_numpy(seeds.astype(np.int64))):
        got = tprng.hash_cell(s, torch.from_numpy(ix), torch.from_numpy(iy),
                              salt).numpy()
        np.testing.assert_array_equal(got.astype(np.uint32), want)
        assert got.min() >= 0 and got.max() < 2**32


def test_cell_uniform_equal_and_normal_close():
    seeds, ix, iy = _hash_inputs(seed=7)
    js, jx, jy = jnp.asarray(seeds), jnp.asarray(ix), jnp.asarray(iy)
    ts = torch.from_numpy(seeds.view(np.int32))
    tx, ty = torch.from_numpy(ix), torch.from_numpy(iy)
    np.testing.assert_array_equal(
        tprng.cell_uniform(ts, tx, ty, 2).numpy(),
        np.asarray(jprng.cell_uniform(js, jx, jy, 2)))
    # Box-Muller goes through log/sqrt/cos of two libraries: a few ulp.
    np.testing.assert_allclose(
        tprng.cell_normal(ts, tx, ty, 0).numpy(),
        np.asarray(jprng.cell_normal(js, jx, jy, 0)), rtol=1e-5, atol=1e-5)


def _plume_inputs(n, seed):
    rng = np.random.default_rng(seed)
    # positions over and beyond the grid, so the cell clip is exercised
    pos = (rng.random((n, 2)) * 520.0 - 10.0).astype(np.float32)
    source = (50.0 + 400.0 * rng.random((n, 2))).astype(np.float32)
    seeds = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    return pos, source, seeds


@pytest.mark.parametrize("preset", ["ppo_v2_0", "ppo_v1_0", "ppo_v2_1"])
def test_plume_plain_matches_pallas_and_analytic(preset):
    jcfg = get_preset(preset).env
    tcfg = t_get_preset(preset).env
    pos, source, seeds = _plume_inputs(600, seed=len(preset))
    conc, tke = plume.sample_plume_plain(
        torch.from_numpy(pos), torch.from_numpy(source),
        torch.from_numpy(seeds.view(np.int32)), tcfg)

    conc_k, tke_k = sample_plume_pallas(
        jnp.asarray(pos), jnp.asarray(source), jnp.asarray(seeds), jcfg,
        interpret=True)
    ix = jnp.clip(jnp.floor(jnp.asarray(pos[:, 0])).astype(jnp.int32), 0, 499)
    iy = jnp.clip(jnp.floor(jnp.asarray(pos[:, 1])).astype(jnp.int32), 0, 499)
    field = JFieldState(source=jnp.asarray(source), seed=jnp.asarray(seeds),
                        wind=jnp.zeros((600, 2)), idx=jnp.zeros(600, jnp.int32))
    conc_a, tke_a = _analytic(field, ix, iy, jcfg)
    for want_c, want_t in ((conc_k, tke_k), (conc_a, tke_a)):
        np.testing.assert_allclose(conc.numpy(), np.asarray(want_c),
                                   rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(tke.numpy(), np.asarray(want_t),
                                   rtol=1e-5, atol=1e-4)


def _analytic(field, ix, iy, cfg):
    return jax.vmap(lambda f, a, b: j_sample_conc_tke(f, a, b, cfg))(
        field, ix, iy)


def test_field_sample_on_cpu_uses_plain_version():
    cfg = t_get_preset("ppo_v2_0").env
    pos, source, seeds = _plume_inputs(64, seed=3)
    field = FieldState(torch.from_numpy(source),
                       torch.from_numpy(seeds.view(np.int32)))
    before = plume.launches
    conc, tke = sample_conc_tke(field, torch.from_numpy(pos), cfg)
    want_c, want_t = plume.sample_plume_plain(
        torch.from_numpy(pos), field.source, field.seed, cfg)
    assert plume.launches == before  # the CPU path launches nothing
    assert torch.equal(conc, want_c) and torch.equal(tke, want_t)


def test_kernel_wrapper_refuses_cpu_tensors_and_bad_inputs():
    cfg = t_get_preset("ppo_v2_0").env
    pos = torch.zeros(8, 2)
    src = torch.zeros(8, 2)
    seed = torch.zeros(8, dtype=torch.int32)
    # no fallback: the kernel's wrapper never computes on the CPU
    with pytest.raises(ValueError, match="CUDA"):
        plume.sample_plume_cuda(pos, src, seed, cfg)
    with pytest.raises(TypeError):
        plume._check(pos, src, seed.to(torch.int64))
    with pytest.raises(ValueError, match="shape"):
        plume._check(pos, src[:4], seed)
    with pytest.raises(ValueError, match="contiguous"):
        plume._check(torch.zeros(2, 8).t(), src, seed)


def test_build_names_source_and_flags():
    path = build.library_path("plume")
    assert path.startswith(build.BUILD_DIR)
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
    assert "--use_fast_math" not in build.NVCC_FLAGS
    assert build.source_path("plume").endswith("csrc/plume.cu")
