"""Parity of the port's gridded banks (``tpu_plume_torch.fields.gridded``)
and the gridded field sample with the JAX package's, on the CPU.

Banks are the JAX package's own (``synthesize_3d_bank`` at a 64-cell grid,
as ``tests/test_fields_ops.py:243-255`` builds them), carried over with
``field_bank_from_numpy``.
- ``sample_bank`` reads cells: the static layout is a lookup and compares
  with equality; interpolated layouts run JAX's operations in its order and
  get rtol 1e-6.  Frame and level indices compare with equality.
- ``sample_bank_points`` goes through the gather kernels' plain versions,
  a formulation of its own, and is held to every JAX gather mode (corner,
  fused, packed after ``pack_time_levels``) at rtol 1e-5, atol 1e-6 x peak:
  the tolerance the JAX package holds its modes to against each other.
- Synthesizer bodies are fed the JAX package's draws; their fields pass
  through exp, pow, sin and cos of two libraries and get rtol 1e-5, atol
  1e-4 on values up to 100 (the plume sample's tolerance).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_plume.core.config import EnvConfig as JEnvConfig
from tpu_plume.fields import gridded as jg
from tpu_plume.fields.analytic import new_field_from_draws as j_new_field
from tpu_plume.fields.analytic import sample_conc_tke as j_sample
from tpu_plume_torch.convert import field_bank_from_numpy
from tpu_plume_torch.core.config import EnvConfig
from tpu_plume_torch.fields import gridded as tg
from tpu_plume_torch.fields.analytic import (
    FieldState,
    new_field_from_draws,
    sample_conc_tke,
)
from tpu_plume_torch.ops import gather

torch.set_num_threads(1)

G = 64
ENV = dict(plume_model="gridded", env_3d=True, grid_size=G,
           source_padding=10.0, domain_height=80.0)
N = 64
SYNTH = dict(rtol=1e-5, atol=1e-4)


def _np(x):
    return np.array(x)


def to_port(jbank):
    return field_bank_from_numpy(
        _np(jbank.conc), _np(jbank.source),
        None if jbank.wind is None else _np(jbank.wind),
        jbank.steps_per_frame, jbank.z_extent)


@pytest.fixture(scope="module")
def banks():
    """{layout: (JAX bank, port bank)} over one 5-D bank [3, 4, 5, 64, 64]
    and its 4-D and 3-D slices."""
    cfg = JEnvConfig(**ENV)
    b5 = jg.synthesize_3d_bank(jax.random.PRNGKey(0), cfg, num_fields=3,
                               num_frames=4, num_levels=5, grid=G,
                               steps_per_frame=10.0, z_extent=80.0)
    b4 = jg.FieldBank(conc=b5.conc[:, :, 0], source=b5.source, wind=b5.wind,
                      steps_per_frame=b5.steps_per_frame)
    b3 = jg.FieldBank(conc=b5.conc[:, 0, 0], source=b5.source,
                      wind=b5.wind[:, 0])
    return {"5d": (b5, to_port(b5)), "4d": (b4, to_port(b4)),
            "3d": (b3, to_port(b3))}


def _queries(seed, bank, edges=False):
    """idx, x, y, t, z as numpy arrays: float positions over the grid and
    past its edges, steps past the last frame, heights over [0, z_extent]."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, bank.conc.shape[0], N).astype(np.int32)
    x = rng.uniform(-2.0, G + 2.0, N).astype(np.float32)
    y = rng.uniform(-2.0, G + 2.0, N).astype(np.float32)
    t = rng.integers(0, 45, N).astype(np.int32)
    z = rng.uniform(0.0, 80.0, N).astype(np.float32)
    if edges:
        # the last frame, the top level, the last cell, integer points
        t[:8], z[:8] = 44, 80.0
        x[8:12], y[8:12] = G - 1.0, G - 1.0
        x[12:16], y[12:16] = 5.0, 7.0
        z[16:20] = 0.0
    return idx, x, y, t, z


def _kw(layout, t, z, wrap):
    return {"5d": dict(t=wrap(t), z=wrap(z)), "4d": dict(t=wrap(t)),
            "3d": {}}[layout]


@pytest.mark.parametrize("layout", ["3d", "4d", "5d"])
def test_sample_bank_matches_jax(banks, layout):
    jb, tb = banks[layout]
    idx, x, y, t, z = _queries(1, jb)
    ix = np.clip(np.floor(x), 0, G - 1).astype(np.int32)
    iy = np.clip(np.floor(y), 0, G - 1).astype(np.int32)
    want = _np(jg.sample_bank(jb, jnp.asarray(idx), jnp.asarray(ix),
                              jnp.asarray(iy), **_kw(layout, t, z, jnp.asarray)))
    got = tg.sample_bank(tb, torch.from_numpy(idx), torch.from_numpy(ix),
                         torch.from_numpy(iy),
                         **_kw(layout, t, z, torch.from_numpy)).numpy()
    if layout == "3d":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_frame_and_level_weights_match_jax(banks):
    jb, tb = banks["5d"]
    _, x, _, t, z = _queries(2, jb, edges=True)
    jt0, jft = jg._frame_weights(jb, jnp.asarray(t), jnp.asarray(x))
    tt0, tft = gather.frame_weights(tb, torch.from_numpy(t),
                                    torch.from_numpy(x))
    np.testing.assert_array_equal(tt0.numpy(), _np(jt0))
    np.testing.assert_array_equal(tft.numpy(), _np(jft))
    jz0, jfz = jg._level_weights(jb, jnp.asarray(z), jnp.asarray(x))
    tz0, tfz = gather.level_weights(tb, torch.from_numpy(z),
                                    torch.from_numpy(x))
    np.testing.assert_array_equal(tz0.numpy(), _np(jz0))
    np.testing.assert_allclose(tfz.numpy(), _np(jfz), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("layout", ["3d", "4d", "5d"])
@pytest.mark.parametrize("edges", [False, True], ids=["random", "edges"])
def test_sample_bank_points_match_every_jax_gather_mode(banks, layout, edges):
    jb, tb = banks[layout]
    idx, x, y, t, z = _queries(3, jb, edges)
    jkw = _kw(layout, t, z, jnp.asarray)
    got = tg.sample_bank_points(
        tb, torch.from_numpy(idx), torch.from_numpy(x), torch.from_numpy(y),
        **_kw(layout, t, z, torch.from_numpy)).numpy()
    atol = 1e-6 * float(_np(jb.conc).max())
    jargs = (jnp.asarray(idx), jnp.asarray(x), jnp.asarray(y))
    for mode, bank in (("corner", jb), ("fused", jb),
                       ("packed", jg.pack_time_levels(jb))):
        want = _np(jg.sample_bank_points(bank, *jargs, gather_mode=mode, **jkw))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=atol,
                                   err_msg=mode)


@pytest.mark.parametrize("layout", ["4d", "5d"])
def test_one_frame_banks_match_jax(banks, layout):
    """A bank of one frame reads that frame at every step, at cells and
    between them, as the JAX package's wrapped frame index does."""
    jb, _ = banks[layout]
    jb = dataclasses.replace(jb, conc=jb.conc[:, :1])
    tb = to_port(jb)
    idx, x, y, t, z = _queries(7, jb, edges=True)
    ix = np.clip(np.floor(x), 0, G - 1).astype(np.int32)
    iy = np.clip(np.floor(y), 0, G - 1).astype(np.int32)
    jkw, tkw = _kw(layout, t, z, jnp.asarray), _kw(layout, t, z,
                                                   torch.from_numpy)
    jargs = [jnp.asarray(a) for a in (idx, x, y)]
    want = _np(jg.sample_bank_points(jb, *jargs, gather_mode="corner", **jkw))
    got = tg.sample_bank_points(tb, *(torch.from_numpy(a) for a in (idx, x, y)),
                                **tkw).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-6 * float(want.max()))
    want = _np(jg.sample_bank(jb, jnp.asarray(idx), jnp.asarray(ix),
                              jnp.asarray(iy), **jkw))
    got = tg.sample_bank(tb, torch.from_numpy(idx), torch.from_numpy(ix),
                         torch.from_numpy(iy), **tkw).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("layout", ["3d", "4d", "5d"])
def test_sample_bank_points_modes_are_one_function(banks, layout):
    _, tb = banks[layout]
    idx, x, y, t, z = (torch.from_numpy(a) for a in _queries(4, tb))
    kw = _kw(layout, t, z, lambda a: a)
    first = tg.sample_bank_points(tb, idx, x, y, **kw)
    for mode in tg.GATHER_MODES:
        assert torch.equal(tg.sample_bank_points(tb, idx, x, y,
                                                 gather_mode=mode, **kw), first)
    with pytest.raises(ValueError, match="gather_mode"):
        tg.sample_bank_points(tb, idx, x, y, gather_mode="onehot", **kw)


def test_5d_points_are_two_trilinear_calls_at_consecutive_frames(banks):
    """The 3-D bank path reads frames t0 and t0+1 of the [K*T, Z, H, W] view
    through the trilinear function, lerped by the frame weight."""
    _, tb = banks["5d"]
    idx, x, y, t, z = (torch.from_numpy(a) for a in _queries(5, tb, True))
    k, nt, nz = tb.conc.shape[:3]
    t0, ft = gather.frame_weights(tb, t, x)
    pts = torch.stack([z * ((nz - 1) / tb.z_extent), x, y], -1)
    vols = tb.conc.reshape(k * nt, nz, G, G)
    a = gather.trilinear_zyx_plain(vols, idx * nt + t0, pts)
    b = gather.trilinear_zyx_plain(vols, idx * nt + t0 + 1, pts)
    assert torch.equal(tg.sample_bank_points(tb, idx, x, y, t, z),
                       (1.0 - ft) * a + ft * b)


@pytest.mark.parametrize("layout", ["3d", "4d", "none"])
def test_bank_wind_matches_jax(banks, layout):
    jb, tb = banks["5d" if layout == "4d" else "3d"]
    if layout == "none":
        jb = dataclasses.replace(jb, wind=None)
        tb = dataclasses.replace(tb, wind=None)
    idx, _, _, t, _ = _queries(6, jb)
    got = tg.bank_wind(tb, torch.from_numpy(idx), torch.from_numpy(t))
    want = jax.vmap(lambda i, s: jg.bank_wind(jb, i, s))(jnp.asarray(idx),
                                                         jnp.asarray(t))
    assert got.shape == (N, 2)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-6, atol=1e-7)


def _tcfg():
    return EnvConfig(**ENV)


def test_static_bank_body_matches_jax():
    jcfg = JEnvConfig(**ENV)
    key = jax.random.PRNGKey(7)
    want = jg.synthesize_bank(key, jcfg, num_fields=3)
    k_src, k_wind = jax.random.split(key)
    sources = jax.random.uniform(k_src, (3, 2), jnp.float32, 10.0, G - 10.0)
    theta = jax.random.uniform(k_wind, (3,), jnp.float32, 0, 2 * jnp.pi)
    got = tg.build_static_bank(torch.from_numpy(_np(sources)),
                               torch.from_numpy(_np(theta)), _tcfg())
    assert got.conc.shape == (3, G, G) and got.wind is None
    np.testing.assert_array_equal(got.source.numpy(), _np(want.source))
    np.testing.assert_allclose(got.conc.numpy(), _np(want.conc), **SYNTH)


def _veering_draws(key, k):
    k_src, k_wind, k_veer = jax.random.split(key, 3)
    return [torch.from_numpy(_np(a)) for a in (
        jax.random.uniform(k_src, (k, 2), jnp.float32, 10.0, G - 10.0),
        jax.random.uniform(k_wind, (k,), jnp.float32, 0, 2 * jnp.pi),
        jax.random.uniform(k_veer, (k,), jnp.float32, -1.0, 1.0))]


def test_time_varying_bank_body_matches_jax():
    jcfg = JEnvConfig(**ENV)
    key = jax.random.PRNGKey(8)
    want = jg.synthesize_time_varying_bank(key, jcfg, num_fields=2,
                                           num_frames=3, steps_per_frame=9.0)
    got = tg.build_time_varying_bank(*_veering_draws(key, 2), _tcfg(),
                                     num_frames=3, steps_per_frame=9.0)
    assert got.conc.shape == (2, 3, G, G) and got.steps_per_frame == 9.0
    np.testing.assert_allclose(got.wind.numpy(), _np(want.wind), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(got.conc.numpy(), _np(want.conc), **SYNTH)


def test_3d_bank_body_matches_jax():
    jcfg = JEnvConfig(**ENV)
    key = jax.random.PRNGKey(9)
    want = jg.synthesize_3d_bank(key, jcfg, num_fields=2, num_frames=3,
                                 num_levels=4, steps_per_frame=10.0)
    got = tg.build_3d_bank(*_veering_draws(key, 2), _tcfg(), num_frames=3,
                           num_levels=4, steps_per_frame=10.0)
    assert got.conc.shape == (2, 3, 4, G, G)
    assert got.z_extent == want.z_extent == 80.0
    np.testing.assert_allclose(got.wind.numpy(), _np(want.wind), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(got.conc.numpy(), _np(want.conc), **SYNTH)


def test_les_bank_body_matches_jax():
    jcfg = JEnvConfig(**ENV)
    key = jax.random.PRNGKey(10)
    k, p = 2, 5
    want = jg.synthesize_les_bank(key, jcfg, num_fields=k, num_frames=3,
                                  num_puffs=p)
    ks = jax.random.split(key, 8)
    two_pi = 2 * jnp.pi
    draws = tg.LesDraws(*(torch.from_numpy(_np(a)) for a in (
        jax.random.uniform(ks[0], (k, 2), jnp.float32, 10.0, G - 10.0),
        jax.random.uniform(ks[1], (k,), jnp.float32, 0, two_pi),
        jax.random.uniform(ks[2], (k,), jnp.float32, -0.6, 0.6),
        jax.random.uniform(ks[3], (k,), jnp.float32, 0, two_pi),
        jax.random.uniform(ks[4], (k, p), jnp.float32, 0, two_pi),
        jax.random.uniform(ks[5], (k, p), jnp.float32, 0.5, 2.0),
        jax.random.uniform(ks[6], (k,), jnp.float32, -0.5, 0.5))))
    got = tg.build_les_bank(draws, _tcfg(), num_frames=3)
    assert got.conc.shape == (k, 3, G, G)
    np.testing.assert_allclose(got.conc.numpy(), _np(want.conc), **SYNTH)
    np.testing.assert_allclose(got.wind.numpy(), _np(want.wind), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("kind", ["static", "time", "3d", "les"])
def test_synthesizers_draw_from_the_generator(kind):
    cfg = dataclasses.replace(_tcfg(), grid_size=24, source_padding=4.0)
    make = {
        "static": lambda g: tg.synthesize_bank(g, cfg, num_fields=3),
        "time": lambda g: tg.synthesize_time_varying_bank(
            g, cfg, num_fields=3, num_frames=2),
        "3d": lambda g: tg.synthesize_3d_bank(g, cfg, num_fields=3,
                                              num_frames=2, num_levels=3),
        "les": lambda g: tg.synthesize_les_bank(g, cfg, num_fields=3,
                                                num_frames=2, num_puffs=4),
    }[kind]
    a = make(torch.Generator().manual_seed(5))
    b = make(torch.Generator().manual_seed(5))
    c = make(torch.Generator().manual_seed(6))
    assert torch.equal(a.conc, b.conc) and not torch.equal(a.conc, c.conc)
    assert a.conc.shape[0] == 3 and a.conc.shape[-2:] == (24, 24)
    assert a.conc.is_contiguous() and torch.isfinite(a.conc).all()
    assert 0.0 <= float(a.conc.min()) and float(a.conc.max()) <= 100.0 + 1e-4
    assert ((a.source >= 4.0) & (a.source <= 20.0)).all()


def test_field_bank_from_numpy_and_to():
    rng = np.random.default_rng(11)
    conc = rng.random((2, 3, 4, 5), dtype=np.float32)
    bank = field_bank_from_numpy(conc, np.ones((2, 2)), None, 7, 0)
    assert bank.conc.dtype == torch.float32 and bank.source.dtype == torch.float32
    assert bank.wind is None and bank.steps_per_frame == 7.0
    np.testing.assert_array_equal(bank.conc.numpy(), conc)
    moved = bank.to("cpu")
    assert moved.conc.device.type == "cpu" and moved.steps_per_frame == 7.0


@pytest.mark.parametrize("subcell", [False, True], ids=["cell", "subcell"])
@pytest.mark.parametrize("layout", ["3d", "4d", "5d"])
def test_gridded_field_sample_matches_jax(banks, layout, subcell):
    """new_field_from_draws + sample_conc_tke on the bank: bank rows and
    sources equal, conc and tke (bank + hashed turbulence) at the env's
    float tolerance."""
    jb, tb = banks[layout]
    env = dict(ENV, env_3d=layout == "5d", subcell_sampling=subcell)
    jcfg, tcfg = JEnvConfig(**env), EnvConfig(**env)
    rng = np.random.default_rng(12)
    u = rng.random((N, 2), dtype=np.float32)
    bits = rng.integers(0, 2**32, N, dtype=np.uint64).astype(np.uint32)
    pos = rng.uniform(0.0, G - 1e-3, (N, 3)).astype(np.float32)
    pos[:, 2] = rng.uniform(0.0, 80.0, N)
    pos = pos[:, :tcfg.pos_dim].copy()
    t = rng.integers(0, 45, N).astype(np.int32)

    def one(uu, b, p, s):
        f = j_new_field(uu, jnp.zeros(2), b, jcfg, jb)
        c = jnp.clip(jnp.floor(p).astype(jnp.int32), 0, G - 1)
        return f, j_sample(f, c[0], c[1], jcfg, jb, t=s,
                           z=p[2] if jcfg.env_3d else None, xy=p[:2])

    jf, (jc, jk) = jax.vmap(one)(jnp.asarray(u), jnp.asarray(bits),
                                 jnp.asarray(pos), jnp.asarray(t))
    tf = new_field_from_draws(torch.from_numpy(u),
                              torch.from_numpy(bits.view(np.int32)), tcfg, tb)
    np.testing.assert_array_equal(tf.idx.numpy(), _np(jf.idx))
    np.testing.assert_array_equal(tf.source.numpy(), _np(jf.source))
    conc, tke = sample_conc_tke(tf, torch.from_numpy(pos), tcfg, tb,
                                torch.from_numpy(t))
    np.testing.assert_allclose(conc.numpy(), _np(jc), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(tke.numpy(), _np(jk), rtol=1e-5, atol=1e-4)


def test_gridded_without_a_bank_raises_as_jax_does():
    cfg = EnvConfig(**ENV)
    u = torch.rand(4, 2, generator=torch.Generator().manual_seed(0))
    bits = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="requires a FieldBank"):
        new_field_from_draws(u, bits, cfg)
    field = FieldState(source=u, seed=bits, idx=torch.zeros(4, dtype=torch.int32))
    with pytest.raises(ValueError, match="requires a FieldBank"):
        sample_conc_tke(field, torch.zeros(4, 3), cfg)
    with pytest.raises(ValueError, match="requires a FieldBank"):
        j_new_field(jnp.zeros(2), jnp.zeros(2), jnp.uint32(0), JEnvConfig(**ENV))
