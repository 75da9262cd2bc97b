"""The env's sub-cell bank sample (``tpu_plume_torch.ops.gather``
``sample_bank_conc_tke``, one launch of the sample kernel on the card)
against the JAX package's ``sample_conc_tke`` with ``subcell_sampling``,
on the CPU, where the wrapper runs its plain version.

- ``sample_bank_conc_tke_plain`` against JAX over a static bank, a
  time-varying 4-D bank, a 5-D bank in 3-D flight, a one-frame 5-D bank and
  2-D flight over a 5-D bank, with points on cell edges, past the grid and
  at the top level, steps past the last frame and frames of 7 env steps
  (not a power of two): conc and tke at slice 1's tolerance (rtol 1e-5,
  atol 1e-4), cells equal.
- The frame coordinate is a true division and the level scale one f32
  product, bit for bit, as the kernel computes them.
- One sample is one call of the wrapper: an env reset, step and auto-reset
  call it once each, a rollout twice a step, and none of them reaches the
  stack gathers.
- Validation: a bank the kernel cannot take raises where the train step is
  built; per-query tensors it cannot take raise before a launch.
- The kernels' build key covers the header the sources include.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_plume.core.config import EnvConfig as JEnvConfig
from tpu_plume.fields import gridded as jg
from tpu_plume.fields.analytic import FieldState as JFieldState
from tpu_plume.fields.analytic import sample_conc_tke as j_sample
from tpu_plume_torch.convert import field_bank_from_numpy
from tpu_plume_torch.core.config import EnvConfig, RolloutConfig, get_preset
from tpu_plume_torch.env import methane as tenv
from tpu_plume_torch.fields import gridded as tg
from tpu_plume_torch.models import ActorCritic
from tpu_plume_torch.ops import build, gather, plume
from tpu_plume_torch.rollout.rollout import draw_chunk, init_rollout, rollout_chunk
from tpu_plume_torch.train import ppo_trainer as ttrain

torch.set_num_threads(1)

G = 40
N = 96
K = 3
SPF = 7.0        # env steps per frame: not a power of two
Z_EXTENT = 30.0
TOL = dict(rtol=1e-5, atol=1e-4)

# layout name: (bank shape, 3-D flight)
LAYOUTS = {
    "static": ((K, G, G), False),
    "frames": ((K, 4, G, G), False),
    "volumes_3d_flight": ((K, 4, 5, G, G), True),
    "one_frame_volumes": ((K, 1, 5, G, G), True),
    "volumes_2d_flight": ((K, 4, 5, G, G), False),
}
# Turbulence flags: V1.1+ (|N|, tke = turb) and V1.0 (signed N, 2|turb|).
FLAGS = {"v1_1": dict(), "v1_0": dict(turbulence_signed_normal=True,
                                      tke_abs_times_two=True)}


def _cfgs(env_3d, **kw):
    env = dict(plume_model="gridded", subcell_sampling=True, grid_size=G,
               source_padding=8.0, domain_height=Z_EXTENT, env_3d=env_3d,
               max_steps=9, **kw)
    return JEnvConfig(**env), EnvConfig(**env)


def _banks(shape, seed=0):
    """(JAX bank, port bank) of values in [0, 100) with one source per row."""
    rng = np.random.default_rng(seed)
    conc = (100.0 * rng.random(shape)).astype(np.float32)
    source = rng.uniform(8.0, G - 8.0, (shape[0], 2)).astype(np.float32)
    jbank = jg.FieldBank(conc=jnp.asarray(conc), source=jnp.asarray(source),
                         steps_per_frame=SPF, z_extent=Z_EXTENT)
    return jbank, field_bank_from_numpy(conc, source, None, SPF, Z_EXTENT)


def _queries(seed, pos_dim):
    """idx, pos, t, seed bits (uint32) as numpy arrays: positions over the
    grid and 3 beyond it, exact cell edges, the last cell, the top and
    bottom level and beyond them, steps from 0 to well past the last
    frame."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, K, N).astype(np.int32)
    pos = rng.uniform(-3.0, G + 3.0, (N, 3)).astype(np.float32)
    pos[:, 2] = rng.uniform(-2.0, Z_EXTENT + 2.0, N)
    pos[:8, :2] = np.floor(pos[:8, :2])                  # cell edges
    pos[8:12, :2] = G - 1.0                              # the last cell
    pos[12:16, 2] = Z_EXTENT                             # the top level
    pos[16:20, 2] = 0.0
    t = rng.integers(0, 60, N).astype(np.int32)          # 4 frames = 28 steps
    t[:4] = 0
    t[20:24] = 21                                        # the last frame
    bits = rng.integers(0, 2**32, N, dtype=np.uint64).astype(np.uint32)
    return idx, np.ascontiguousarray(pos[:, :pos_dim]), t, bits


def _jax_sample(jcfg, jbank, idx, pos, t, bits):
    def one(i, p, s, b):
        field = JFieldState(source=jnp.zeros(2), seed=b, wind=jnp.zeros(2),
                            idx=i)
        c = jnp.clip(jnp.floor(p[:2]).astype(jnp.int32), 0, G - 1)
        return j_sample(field, c[0], c[1], jcfg, jbank, t=s,
                        z=p[2] if jcfg.env_3d else None, xy=p[:2])

    conc, tke = jax.vmap(one)(*map(jnp.asarray, (idx, pos, t, bits)))
    return np.asarray(conc), np.asarray(tke)


def _port_args(idx, pos, t, bits):
    return (torch.from_numpy(idx), torch.from_numpy(pos), torch.from_numpy(t),
            torch.from_numpy(bits.view(np.int32)))


@pytest.mark.parametrize("flags", sorted(FLAGS))
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_sample_matches_jax(layout, flags):
    shape, env_3d = LAYOUTS[layout]
    jcfg, tcfg = _cfgs(env_3d, **FLAGS[flags])
    jbank, tbank = _banks(shape, seed=len(layout))
    idx, pos, t, bits = _queries(len(layout) + len(flags), tcfg.pos_dim)
    want_c, want_k = _jax_sample(jcfg, jbank, idx, pos, t, bits)
    args = _port_args(idx, pos, t, bits)
    conc, tke = gather.sample_bank_conc_tke_plain(tbank, *args, tcfg)
    np.testing.assert_allclose(conc.numpy(), want_c, **TOL)
    np.testing.assert_allclose(tke.numpy(), want_k, **TOL)
    # the turbulence cells are JAX's
    ix, iy = plume.cell_of(args[1][:, :2], G)
    cells = np.clip(np.floor(pos[:, :2]), 0, G - 1).astype(np.int32)
    np.testing.assert_array_equal(torch.stack([ix, iy], -1).numpy(), cells)
    # on the CPU the wrapper is the plain version, and so is the env's sample
    got = gather.sample_bank_conc_tke(tbank, *args, tcfg)
    assert all(torch.equal(a, b) for a, b in zip(got, (conc, tke)))


def test_sample_is_the_bank_read_plus_turbulence():
    """The sample is ``bank_points`` (the stack gathers' composition) plus
    the turbulence, clipped: with no turbulence it is the clipped bank
    read, bit for bit."""
    _, tcfg = _cfgs(True, turbulence_intensity=0.0)
    _, tbank = _banks(LAYOUTS["volumes_3d_flight"][0])
    idx, pos, t, bits = _port_args(*_queries(3, 3))
    conc, tke = gather.sample_bank_conc_tke_plain(tbank, idx, pos, t, bits,
                                                  tcfg)
    base = tg.sample_bank_points(tbank, idx, pos[:, 0], pos[:, 1], t,
                                 pos[:, 2])
    assert torch.equal(conc, torch.clamp(base, 0.0, tcfg.conc_peak))
    assert not tke.any()


@pytest.mark.parametrize("spf", [7.0, 0.3, 100.0, 128.0])
def test_frame_coordinate_is_a_true_division(spf):
    """t / steps_per_frame in f32, bit for bit (the kernel's division);
    a multiply by the f32 reciprocal, what PyTorch does for a tensor on the
    card divided by a Python scalar, differs where spf is not a power of
    two."""
    _, tbank = _banks((1, 2, 4, 4))
    tbank = dataclasses.replace(tbank, steps_per_frame=spf)
    t = np.arange(0, 4000, dtype=np.int32)
    got = gather.frame_coord(tbank, torch.from_numpy(t), None).numpy()
    np.testing.assert_array_equal(got, t.astype(np.float32) / np.float32(spf))
    by_reciprocal = t.astype(np.float32) * (np.float32(1.0) / np.float32(spf))
    assert np.array_equal(got, by_reciprocal) == (spf == 128.0)


def test_level_coordinate_is_one_f32_product():
    _, tbank = _banks((1, 2, 5, 4, 4))
    z = np.random.default_rng(0).uniform(0.0, Z_EXTENT, 500).astype(np.float32)
    got = gather.level_coord(tbank, torch.from_numpy(z),
                             torch.from_numpy(z)).numpy()
    np.testing.assert_array_equal(got, z * np.float32(4 / Z_EXTENT))


def test_sample_without_a_step_reads_step_zero():
    _, tcfg = _cfgs(True)
    _, tbank = _banks(LAYOUTS["volumes_3d_flight"][0])
    idx, pos, _, bits = _port_args(*_queries(4, 3))
    zero = torch.zeros(N, dtype=torch.int32)
    a = gather.sample_bank_conc_tke_plain(tbank, idx, pos, None, bits, tcfg)
    b = gather.sample_bank_conc_tke_plain(tbank, idx, pos, zero, bits, tcfg)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.fixture
def counted(monkeypatch):
    """Counts calls of the sample wrapper and of the stack gathers."""
    calls = {"sample": 0, "bilinear": 0, "trilinear_zyx": 0}

    def counting(name, fn):
        def wrapper(*args, **kw):
            calls[name] += 1
            return fn(*args, **kw)
        return wrapper

    monkeypatch.setattr(gather, "sample_bank_conc_tke",
                        counting("sample", gather.sample_bank_conc_tke))
    for name in ("bilinear", "trilinear_zyx"):
        monkeypatch.setattr(gather, name, counting(name, getattr(gather, name)))
    return calls


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_one_sample_is_one_call(layout, counted):
    shape, env_3d = LAYOUTS[layout]
    _, tcfg = _cfgs(env_3d)
    _, tbank = _banks(shape)
    n = 16
    g = torch.Generator().manual_seed(0)
    bits = torch.randint(-(2**31), 2**31, (n,), dtype=torch.int32, generator=g)
    state, obs = tenv.reset_from_draws(torch.rand(n, 2, generator=g), None,
                                       bits, tcfg, bank=tbank)
    assert counted == {"sample": 1, "bilinear": 0, "trilinear_zyx": 0}
    action = torch.randint(0, tcfg.num_actions, (n,), generator=g)
    state, trans = tenv.step_noise(state, action,
                                   torch.randn(n, tcfg.pos_dim, generator=g),
                                   tcfg, tbank)
    assert counted["sample"] == 2
    tenv.auto_reset_from_draws(state, trans.obs, trans.done,
                               torch.rand(n, 2, generator=g), None, bits,
                               tcfg, tbank)
    assert counted == {"sample": 3, "bilinear": 0, "trilinear_zyx": 0}


def test_a_rollout_samples_twice_a_step(counted):
    _, tcfg = _cfgs(True)
    _, tbank = _banks(LAYOUTS["volumes_3d_flight"][0])
    g = torch.Generator().manual_seed(1)
    carry = init_rollout(tcfg, 8, g, bank=tbank)
    model = ActorCritic(tcfg.obs_dim, tcfg.num_actions, (16, 8))
    draws = draw_chunk(torch.Generator().manual_seed(2), tcfg, 3, 8)
    rollout_chunk(model, carry, tcfg, 3, draws=draws, bank=tbank)
    assert counted == {"sample": 1 + 2 * 3, "bilinear": 0, "trilinear_zyx": 0}


def test_banks_the_kernel_cannot_take_raise_at_validation():
    good = torch.zeros(2, 3, 6, 7)
    gather.check_bank(good)
    with pytest.raises(TypeError, match="float32"):
        gather.check_bank(good.double())
    with pytest.raises(ValueError, match="contiguous"):
        gather.check_bank(torch.zeros(2, 3, 7, 6).transpose(2, 3))
    with pytest.raises(ValueError, match="dims"):
        gather.check_bank(torch.zeros(6, 7))
    with pytest.raises(ValueError, match="dims"):
        gather.check_bank(torch.zeros(1, 1, 1, 1, 6, 7))
    with pytest.raises(ValueError, match="2 x 2"):
        gather.check_bank(torch.zeros(2, 1, 7))
    with pytest.raises(ValueError, match="2 x 2"):
        gather.check_bank(torch.zeros(0, 6, 7))
    with pytest.raises(ValueError, match="aligned"):
        gather.check_bank(torch.zeros(2 * 6 * 7 + 1)[1:].view(2, 6, 7))
    # the sample kernel's launch is made for a bank on the card only
    _, tcfg = _cfgs(False)
    _, tbank = _banks((K, G, G))
    with pytest.raises(ValueError, match="card"):
        gather.BankSampler(tbank, tcfg)


@pytest.mark.parametrize("bad", ["f64", "strided"])
def test_build_train_step_validates_the_bank(bad):
    cfg = get_preset("wrf_les_3d")
    cfg = cfg.replace(env=dataclasses.replace(cfg.env, grid_size=G),
                      rollout=RolloutConfig(num_envs=4, unroll_length=2))
    _, bank = _banks((K, 2, 3, G, G))
    ttrain.build_train_step(cfg, bank)       # a bank the kernel takes
    conc = (bank.conc.double() if bad == "f64"
            else bank.conc.transpose(3, 4))
    with pytest.raises(TypeError if bad == "f64" else ValueError):
        ttrain.build_train_step(cfg, dataclasses.replace(bank, conc=conc))


def test_query_tensors_the_kernel_cannot_take_raise():
    idx, pos, t, bits = _port_args(*_queries(5, 3))
    gather._check_queries(idx, pos, t, bits, 3, -1)
    gather._check_queries(idx, pos, None, bits, 3, -1)
    with pytest.raises(TypeError, match="idx"):
        gather._check_queries(idx.long(), pos, t, bits, 3, -1)
    with pytest.raises(TypeError, match="t must"):
        gather._check_queries(idx, pos, t.long(), bits, 3, -1)
    with pytest.raises(TypeError, match="seed"):
        gather._check_queries(idx, pos, t, bits.float(), 3, -1)
    with pytest.raises(ValueError, match="shape"):
        gather._check_queries(idx, pos, t, bits, 2, -1)
    with pytest.raises(ValueError, match="shape"):
        gather._check_queries(idx, pos, t[:-1], bits, 3, -1)
    with pytest.raises(ValueError, match="contiguous"):
        gather._check_queries(idx, pos.t().contiguous().t(), t, bits, 3, -1)
    with pytest.raises(ValueError, match="device"):
        gather._check_queries(idx, pos, t, bits, 3, 0)


def test_field_bank_is_frozen_and_copies_drop_the_cached_launch():
    _, bank = _banks((K, G, G))
    with pytest.raises(dataclasses.FrozenInstanceError):
        bank.conc = bank.conc * 2
    object.__setattr__(bank, "_sampler", "cached")
    assert dataclasses.replace(bank, steps_per_frame=3.0)._sampler is None
    assert bank.to("cpu")._sampler is None
    assert bank._sampler == "cached"


def test_build_key_covers_the_included_header(tmp_path, monkeypatch):
    # both sources include the bank sample, which includes the hash
    for name in ("plume", "gather"):
        with open(build.source_path(name)) as fh:
            assert '#include "bank_sample.cuh"' in fh.read()
    with open(os.path.join(build.CSRC, "bank_sample.cuh")) as fh:
        assert '#include "cell_hash.cuh"' in fh.read()
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n')
    header = tmp_path / "h.cuh"
    header.write_text("// one\n")
    monkeypatch.setattr(build, "CSRC", str(tmp_path))
    first = build.library_path("k")
    header.write_text("// two\n")
    assert build.library_path("k") != first
    header.write_text("// one\n")
    assert build.library_path("k") == first
