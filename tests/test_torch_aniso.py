"""The analytic plumes of the ``wrf_les`` slice against the JAX package's,
on the CPU: the anisotropic dispersion in a per-episode wind, S sources
hashed from the seed, and the height's term of 3-D flight.

- The fields: ``new_field_from_draws`` given JAX's draws (source, seed and
  wind), the extra sources and their strengths, the isotropic and
  anisotropic bases of one source and of three, at cells and heights, and
  ``sample_conc_tke`` of every analytic mode.  Hash-derived values (the
  extra sources and strengths) compare within one f32 rounding of the
  span's multiply-add, the wind within 2.4e-7 (XLA's and PyTorch's cos and
  sin round apart by an ulp).  The isotropic floats get the env tolerance
  (rtol 1e-5, atol 1e-4).  The anisotropic base's crosswind term r^2 -
  downwind^2 cancels near the plume's axis, where XLA's CPU evaluation
  (which contracts multiply-adds) and PyTorch's round apart: its floats
  get rtol 1e-4, atol 1e-3 (of a peak of 100).
- One ``build_train_step`` iteration of ``wrf_les``, and one of 3-D flight
  over the anisotropic plume of three sources with wind advection, against
  JAX's ``build_train_step`` given its own draws, at the whole-iteration
  tolerances of ``tests/test_torch_train.py`` (the anisotropic floats as
  above).
- The entry points: ``cli train --cpu --preset wrf_les``, ``train_ppo`` on
  each config the port used to refuse (the anisotropic model, S > 1
  sources, 3-D flight over the analytic plume), the draws' order, the flax
  converter at the slice's widths, and the kernel's copy of the carry.
"""

import csv
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_plume.core.config import get_preset as j_get_preset
from tpu_plume.fields import analytic as ja
from tpu_plume.models import ActorCritic as JActorCritic
from tpu_plume.obsv.metrics import EPISODE_COLUMNS
from tpu_plume.rl.curriculum import curriculum_init as j_cur_init
from tpu_plume.rollout.rollout import init_rollout as j_init_rollout
from tpu_plume.train import ppo_trainer as jtrain
from tpu_plume_torch.cli.main import main as cli_main
from tpu_plume_torch.convert import actor_critic_from_flax
from tpu_plume_torch.core.config import get_preset as t_get_preset
from tpu_plume_torch.env.methane import EnvState
from tpu_plume_torch.fields import analytic as ta
from tpu_plume_torch.models import ActorCritic
from tpu_plume_torch.ops import plume
from tpu_plume_torch.rl.curriculum import curriculum_init
from tpu_plume_torch.rollout import rollout
from tpu_plume_torch.rollout.rollout import ChunkDraws, EpisodeAccum, RolloutCarry
from tpu_plume_torch.train import ppo_trainer as ttrain

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-4
ANISO_RTOL, ANISO_ATOL = 1e-4, 1e-3
N = 512

# The analytic configs of the slice, by name: (preset, env fields).
MODES = {
    "wrf_les": ("wrf_les", {}),
    "aniso_s3": ("wrf_les", {"num_sources": 3}),
    "iso_s3": ("ppo_v2_0", {"num_sources": 3}),
    "aniso_3d": ("wrf_les_3d", {"plume_model": "anisotropic",
                                "wind_speed_range": (1.0, 4.0)}),
    "aniso_3d_s3": ("wrf_les_3d", {"plume_model": "anisotropic",
                                   "wind_speed_range": (1.0, 4.0),
                                   "num_sources": 3}),
    "iso_3d": ("wrf_les_3d", {"plume_model": "isotropic"}),
    "iso_3d_s3": ("wrf_les_3d", {"plume_model": "isotropic",
                                 "num_sources": 3}),
    "aniso_calm": ("wrf_les", {"wind_speed_range": (0.0, 0.0)}),
}


def _cfgs(mode):
    preset, kw = MODES[mode]
    return (dataclasses.replace(j_get_preset(preset).env, **kw),
            dataclasses.replace(t_get_preset(preset).env, **kw))


def _tol(cfg):
    if cfg.plume_model == "anisotropic":
        return dict(rtol=ANISO_RTOL, atol=ANISO_ATOL)
    return dict(rtol=RTOL, atol=ATOL)


def _t(x, dtype=None):
    return torch.from_numpy(np.array(x, dtype=dtype))


def _draws(seed, n=N):
    """Fresh-field draws and query cells and heights, from ``seed``."""
    rng = np.random.default_rng(seed)
    return dict(
        u_src=rng.random((n, 2), dtype=np.float32),
        u_wind=rng.random((n, 2), dtype=np.float32),
        bits=rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32),
        cells=rng.integers(-3, 503, (n, 2)).astype(np.int32),
        z=rng.uniform(-5.0, 105.0, n).astype(np.float32))


def _fields(jcfg, tcfg, x):
    """Both packages' fields from the same draws."""
    jf = jax.vmap(lambda u, w, b: ja.new_field_from_draws(u, w, b, jcfg))(
        jnp.asarray(x["u_src"]), jnp.asarray(x["u_wind"]),
        jnp.asarray(x["bits"]))
    tf = ta.new_field_from_draws(
        torch.from_numpy(x["u_src"]),
        torch.from_numpy(x["u_wind"]) if plume.reads_wind(tcfg) else None,
        torch.from_numpy(x["bits"].view(np.int32)), tcfg)
    return jf, tf


@pytest.mark.parametrize("mode", sorted(MODES))
def test_new_field_from_draws_matches_jax(mode):
    jcfg, tcfg = _cfgs(mode)
    jf, tf = _fields(jcfg, tcfg, _draws(1))
    np.testing.assert_array_equal(tf.source.numpy(), np.asarray(jf.source))
    np.testing.assert_array_equal(tf.seed.numpy().view(np.uint32),
                                  np.asarray(jf.seed))
    if plume.reads_wind(tcfg):
        np.testing.assert_allclose(tf.wind.numpy(), np.asarray(jf.wind),
                                   rtol=0, atol=2.4e-7)
        speed = np.linalg.norm(tf.wind.numpy(), axis=-1)
        lo, hi = tcfg.wind_speed_range
        assert (speed >= lo - 1e-5).all() and (speed <= hi + 1e-5).all()
    else:
        # JAX's zero wind is the port's None
        assert tf.wind is None and not np.asarray(jf.wind).any()


def test_new_field_needs_the_wind_draws_of_a_windy_field():
    _, tcfg = _cfgs("wrf_les")
    u = torch.rand(4, 2, generator=torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="u_wind"):
        ta.new_field_from_draws(u, None, torch.zeros(4, dtype=torch.int32),
                                tcfg)


@pytest.mark.parametrize("mode", ["aniso_s3", "iso_s3", "aniso_3d_s3"])
def test_extra_sources_and_strengths_match_jax(mode):
    jcfg, tcfg = _cfgs(mode)
    jf, tf = _fields(jcfg, tcfg, _draws(2))
    want = jax.vmap(lambda f: ja.all_sources(f, jcfg))(jf)
    got = plume.all_sources(tf.source, tf.seed, tcfg)
    assert got.shape == (N, 3, 2)
    np.testing.assert_array_equal(got[:, 0].numpy(), np.asarray(want[:, 0]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=0)
    np.testing.assert_allclose(plume.extra_sources(tf.seed, tcfg).numpy(),
                               np.asarray(want[:, 1:]), rtol=1e-6, atol=0)
    lo, hi = tcfg.source_padding, tcfg.grid_size - tcfg.source_padding
    assert (got >= lo).all() and (got < hi).all()
    q = plume.source_strengths(tf.seed, tcfg)
    wq = jax.vmap(lambda f: ja.source_strengths(f, jcfg))(jf)
    np.testing.assert_allclose(q.numpy(), np.asarray(wq), rtol=1e-6, atol=0)
    assert (q[:, 0] == 1.0).all()
    q_lo, q_hi = tcfg.source_strength_range
    assert (q[:, 1:] >= q_lo).all() and (q[:, 1:] < q_hi).all()


def test_one_source_has_no_extras_and_strength_one():
    _, tcfg = _cfgs("wrf_les")
    seed = torch.arange(5, dtype=torch.int32)
    assert plume.extra_sources(seed, tcfg).shape == (5, 0, 2)
    assert torch.equal(plume.source_strengths(seed, tcfg), torch.ones(5, 1))


@pytest.mark.parametrize("height", [False, True], ids=["2d", "z"])
def test_anisotropic_kernel_matches_jax(height):
    """One source in one wind at cells (and heights), both packages given
    the same wind."""
    jcfg, tcfg = _cfgs("aniso_3d")
    x = _draws(3, n=4000)
    jf, tf = _fields(jcfg, tcfg, x)
    fx, fy = x["cells"][:, 0].astype(np.float32), x["cells"][:, 1].astype(
        np.float32)
    z = x["z"] if height else None
    want = jax.vmap(lambda s, w, a, b, h: ja._aniso_kernel(
        s, w, a, b, jcfg, h if height else None))(
        jf.source, jf.wind, fx, fy, jnp.asarray(x["z"]))
    got = plume.anisotropic_kernel(tf.source, _t(jf.wind), _t(fx), _t(fy),
                                   tcfg, None if z is None else _t(z))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=ANISO_RTOL,
                               atol=ANISO_ATOL)
    assert (np.asarray(want) > 1.0).sum() > 20   # the plume is sampled


@pytest.mark.parametrize("height", [False, True], ids=["2d", "z"])
def test_anisotropic_kernel_of_one_source_over_a_grid_is_the_batch(height):
    """The bank synthesizers' call (one source and wind broadcast over a
    grid of cells) gives, cell by cell, the env's batched call (a source
    and wind per query), to the bit."""
    _, tcfg = _cfgs("aniso_3d")
    fx, fy = torch.meshgrid(torch.arange(40.0), torch.arange(40.0),
                            indexing="ij")
    z = torch.full((40, 40), 7.5) if height else None
    src, wind = torch.tensor([20.0, 17.0]), torch.tensor([1.5, -0.5])
    grid = plume.anisotropic_kernel(src, wind, fx, fy, tcfg, z)
    n = fx.numel()
    batch = plume.anisotropic_kernel(
        src.expand(n, 2), wind.expand(n, 2), fx.reshape(-1), fy.reshape(-1),
        tcfg, None if z is None else z.reshape(-1))
    assert torch.equal(grid.reshape(-1), batch)
    assert (grid > 1.0).sum() > 100


@pytest.mark.parametrize("mode", sorted(MODES))
def test_analytic_base_matches_jax(mode):
    """The base of each mode (one or three sources, with and without the
    height's term) at cells and heights."""
    jcfg, tcfg = _cfgs(mode)
    x = _draws(4)
    jf, tf = _fields(jcfg, tcfg, x)
    if plume.reads_wind(tcfg):
        tf.wind = _t(jf.wind)        # the same wind in both packages
    fx, fy = x["cells"][:, 0].astype(np.float32), x["cells"][:, 1].astype(
        np.float32)
    base = (ja._anisotropic_base if jcfg.plume_model == "anisotropic"
            else ja._isotropic_base)
    z3 = jcfg.env_3d
    want = jax.vmap(lambda f, a, b, h: base(f, a, b, jcfg,
                                            h if z3 else None))(
        jf, fx, fy, jnp.asarray(x["z"]))
    got = plume.plume_base(tf.source, tf.seed, tf.wind, _t(fx), _t(fy), tcfg,
                           _t(x["z"]) if z3 else None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **_tol(tcfg))
    if tcfg.num_sources > 1:
        assert (got <= tcfg.conc_peak).all()


@pytest.mark.parametrize("mode", sorted(MODES))
def test_sample_conc_tke_matches_jax(mode):
    """``sample_conc_tke`` at float positions (cell, and height in 3-D
    flight): the plain version of the plume kernel on the CPU."""
    jcfg, tcfg = _cfgs(mode)
    x = _draws(5)
    jf, tf = _fields(jcfg, tcfg, x)
    if plume.reads_wind(tcfg):
        tf.wind = _t(jf.wind)
    rng = np.random.default_rng(6)
    pos = rng.uniform(-2.0, 502.0, (N, tcfg.pos_dim)).astype(np.float32)
    if tcfg.env_3d:
        pos[:, 2] = rng.uniform(0.0, tcfg.domain_height, N)
    cells = np.clip(np.floor(pos[:, :2]).astype(np.int32), 0, 499)
    jc, jk = jax.vmap(lambda f, i, j, h: ja.sample_conc_tke(
        f, i, j, jcfg, z=h if jcfg.env_3d else None))(
        jf, cells[:, 0], cells[:, 1], jnp.asarray(pos[:, -1]))
    before = plume.launches
    tc, tk = ta.sample_conc_tke(tf, _t(pos), tcfg)
    assert plume.launches == before       # the CPU path launches nothing
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), **_tol(tcfg))
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), rtol=RTOL,
                               atol=ATOL)


# --- one train iteration ------------------------------------------------------

NE, T, MB = 16, 8, 32
HIDDEN = (64, 32)
ITERATIONS = {
    "wrf_les": ("wrf_les", {}),
    "aniso_3d_s3_advect": ("wrf_les_3d", {
        "plume_model": "anisotropic", "wind_speed_range": (1.0, 4.0),
        "num_sources": 3}),
}


def _small(cfg, env_kw):
    """The config cut to test size: 16 envs x 8 steps, a (64, 32) trunk,
    minibatch 32, episodes of 6 steps and a goal radius of 200, so that
    the iteration sees both episode ends, and a 4-episode curriculum
    window."""
    return cfg.replace(
        env=dataclasses.replace(cfg.env, max_steps=6, initial_radius=200.0,
                                **env_kw),
        ppo=dataclasses.replace(cfg.ppo, hidden_sizes=HIDDEN,
                                minibatch_size=MB),
        curriculum=dataclasses.replace(cfg.curriculum, initial_radius=200.0,
                                       window_size=4),
        rollout=dataclasses.replace(cfg.rollout, num_envs=NE,
                                    unroll_length=T),
    )


def _port_env_state(js) -> EnvState:
    return EnvState(
        pos=_t(js.pos), t=_t(js.t), visited=_t(js.visited),
        field=ta.FieldState(
            source=_t(js.field.source),
            seed=_t(np.asarray(js.field.seed).view(np.int32)),
            wind=_t(js.field.wind) if np.asarray(js.field.wind).any()
            else None),
        radius=_t(js.radius), explore_bonus=_t(js.explore_bonus),
        conc=_t(js.conc), tke=_t(js.tke), prev_conc=_t(js.prev_conc),
        prev_action=_t(js.prev_action, np.int64),
    )


@pytest.fixture(scope="module", params=sorted(ITERATIONS))
def one_iteration(request):
    """One train iteration of each package from the same start:
    ``(jax_out, port_out, cfg, minibatch steps)``, each out ``(loop,
    stats, traj)``."""
    preset, env_kw = ITERATIONS[request.param]
    jcfg = _small(j_get_preset(preset), env_kw)
    tcfg = _small(t_get_preset(preset), env_kw)
    k_model, k_roll, k_loop = jax.random.split(jax.random.PRNGKey(2), 3)
    ts = jtrain.make_train_state(jcfg, k_model)
    roll = j_init_rollout(k_roll, jcfg.env, NE,
                          radius=jcfg.curriculum.initial_radius,
                          explore_bonus=jcfg.env.explore_bonus_init)
    jloop = jtrain.LoopCarry(
        train_state=ts, rollout=roll,
        curriculum=j_cur_init(jcfg.curriculum, jcfg.env.explore_bonus_init),
        key=k_loop)

    # The JAX iteration's draws, from its own keys
    # (tpu_plume/rollout/rollout.py:194-206, rl/ppo.py).
    _, k_update = jax.random.split(jloop.key)
    _, k_turb, k_gumbel, k_src, k_wind, k_bits = jax.random.split(roll.key, 6)
    e = jcfg.env
    draws = ChunkDraws(
        turb_noise=_t(jax.random.normal(k_turb, (T, NE, e.pos_dim))),
        gumbel=_t(jax.random.gumbel(k_gumbel, (T, NE, e.num_actions))),
        u_src=_t(jax.random.uniform(k_src, (T, NE, 2))),
        bits=_t(np.asarray(jax.random.bits(k_bits, (T, NE), jnp.uint32))
                .view(np.int32)),
        u_wind=_t(jax.random.uniform(k_wind, (T, NE, 2))),
    )
    shuffles = [int(jax.random.randint(ek, (), 0, NE * T))
                for ek in jax.random.split(k_update, jcfg.ppo.epochs)]

    params0 = jax.tree.map(np.asarray, ts.params)
    model = ttrain.make_policy_model(tcfg)
    model.load_state_dict(actor_critic_from_flax(params0))
    tloop = ttrain.LoopCarry(
        model=model,
        optimizer=ttrain.ClippedAdam(model.parameters(),
                                     tcfg.ppo.learning_rate,
                                     tcfg.ppo.max_grad_norm),
        rollout=RolloutCarry(env_state=_port_env_state(roll.env_state),
                             obs=_t(roll.obs),
                             accum=EpisodeAccum.zeros(NE, "cpu"),
                             generator=torch.Generator()),
        curriculum=curriculum_init(tcfg.curriculum,
                                   tcfg.env.explore_bonus_init),
        generator=torch.Generator(),
    )
    jout = jtrain.build_train_step(jcfg)(jloop)
    tout = ttrain.build_train_step(tcfg)(tloop, draws=draws,
                                         shuffles=shuffles)
    return jout, tout, tcfg, jcfg.ppo.epochs * (NE * T // MB)


def test_rollout_of_one_iteration_matches_jax(one_iteration):
    (_, _, jtraj), (tloop, _, ttraj), cfg, _ = one_iteration
    tol = _tol(cfg.env)
    for name in ("action", "done"):
        np.testing.assert_array_equal(getattr(ttraj, name).numpy(),
                                      np.asarray(getattr(jtraj, name)))
    for name in ("success", "steps"):
        np.testing.assert_array_equal(getattr(ttraj.episode, name).numpy(),
                                      np.asarray(getattr(jtraj.episode, name)))
    for name in ("reward", "value", "log_prob", "obs", "pos", "conc"):
        np.testing.assert_allclose(getattr(ttraj, name).numpy(),
                                   np.asarray(getattr(jtraj, name)), **tol,
                                   err_msg=name)
    for name in ("total_reward", "final_conc", "distance", "source_x",
                 "source_y"):
        np.testing.assert_allclose(getattr(ttraj.episode, name).numpy(),
                                   np.asarray(getattr(jtraj.episode, name)),
                                   **tol, err_msg=name)
    done = np.asarray(jtraj.done)
    success = np.asarray(jtraj.episode.success)
    assert success.any() and (done & ~success).any()
    assert tloop.rollout.env_state.field.wind.shape == (NE, 2)


def test_update_of_one_iteration_matches_jax(one_iteration):
    (jloop, jstats, _), (tloop, tstats, _), _, steps = one_iteration
    for k in ("loss/total", "loss/policy", "loss/value", "loss/entropy",
              "loss/approx_kl", "loss/clip_frac", "rollout/mean_reward"):
        np.testing.assert_allclose(float(tstats[k]), float(jstats[k]),
                                   rtol=1e-4, atol=1e-5, err_msg=k)
    for k in ("rollout/episodes", "rollout/successes", "curriculum/updates"):
        assert tstats[k] == int(jstats[k]), k
    want = actor_critic_from_flax(jax.tree.map(np.asarray,
                                               jloop.train_state.params))
    for k, v in tloop.model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=0,
                                   atol=1e-6 * steps, err_msg=k)


# --- entry points --------------------------------------------------------------


def test_cli_trains_wrf_les_on_the_cpu(tmp_path, capsys):
    out = tmp_path / "run"
    cli_main(["train", "--cpu", "--preset", "wrf_les", "--envs", "16",
              "--unroll", "8", "--minibatch", "32", "--iterations", "2",
              "--out", str(out)])
    printed = capsys.readouterr().out.strip().splitlines()[-1]
    assert '"env_steps": 256' in printed
    with open(out / "training_results.csv", newline="") as fh:
        assert next(csv.reader(fh)) == EPISODE_COLUMNS
    sd = torch.load(out / "model" / "ppo_successful_models.pth")
    assert sd["feature.0.weight"].shape == (256, 6)
    assert sd["actor.weight"].shape == (5, 128)


def test_cli_takes_the_anisotropic_plume_model(tmp_path, capsys):
    cli_main(["train", "--cpu", "--plume-model", "anisotropic", "--envs", "8",
              "--unroll", "4", "--minibatch", "32", "--iterations", "1",
              "--out", str(tmp_path / "run")])
    assert '"env_steps": 32' in capsys.readouterr().out


# Config paths the port refused before this slice.
SLICE_CONFIGS = {
    "anisotropic": ("ppo_v2_0", {"plume_model": "anisotropic"}),
    "num_sources": ("ppo_v2_0", {"num_sources": 2}),
    "env_3d": ("ppo_v2_0", {"env_3d": True}),
}


@pytest.mark.parametrize("name", sorted(SLICE_CONFIGS))
def test_train_ppo_runs_the_slice_configs(name, tmp_path):
    preset, kw = SLICE_CONFIGS[name]
    cfg = _small(t_get_preset(preset), kw)
    res = ttrain.train_ppo(cfg, str(tmp_path), device="cpu", max_iterations=2,
                           verbose=False, sync_every=1)
    assert res.env_steps == 2 * NE * T and res.episodes > 0


def test_elastic_walls_in_3d_over_the_analytic_plume_raise():
    cfg = _small(t_get_preset("ppo_v1_0"), {"env_3d": True})
    with pytest.raises(ValueError, match="2-D-only"):
        plume.check_env_step(cfg.env)
    loop = ttrain.init_loop(cfg, "cpu")
    with pytest.raises(ValueError, match="2-D-only"):
        ttrain.build_train_step(cfg)(loop)


def test_wind_draws_come_last_and_only_where_the_field_has_a_wind():
    """Every other config draws the stream it drew before fields had
    winds; wrf_les draws the same and then the wind uniforms."""
    iso, aniso = t_get_preset("ppo_v2_0").env, t_get_preset("wrf_les").env
    a = rollout.draw_chunk(torch.Generator().manual_seed(7), iso, 4, 8)
    b = rollout.draw_chunk(torch.Generator().manual_seed(7), aniso, 4, 8)
    assert a.u_wind is None and b.u_wind.shape == (4, 8, 2)
    for name in ("turb_noise", "gumbel", "u_src", "bits"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    ci = rollout.init_rollout(iso, 8, torch.Generator().manual_seed(3))
    ca = rollout.init_rollout(aniso, 8, torch.Generator().manual_seed(3))
    assert ci.env_state.field.wind is None
    assert ca.env_state.field.wind.shape == (8, 2)
    assert torch.equal(ci.env_state.field.seed, ca.env_state.field.seed)
    assert torch.equal(ci.env_state.field.source, ca.env_state.field.source)


def test_own_copy_copies_the_wind():
    cfg = t_get_preset("wrf_les").env
    carry = rollout.init_rollout(cfg, 4, torch.Generator().manual_seed(0))
    copy = rollout.own_copy(carry.env_state)
    copy.field.wind += 1.0
    assert not torch.equal(copy.field.wind, carry.env_state.field.wind)


@pytest.mark.parametrize("obs_dim,actions", [(6, 5), (7, 7)],
                         ids=["wrf_les", "3d"])
def test_flax_params_of_the_slice_widths_convert(obs_dim, actions):
    """The converter carries the slice's widths across unchanged: wrf_les
    is obs 6 / 5 actions and 3-D flight obs 7 / 7 actions."""
    net = JActorCritic(num_actions=actions, hidden_sizes=(256, 128))
    obs = np.random.default_rng(0).standard_normal((5, obs_dim)).astype(
        np.float32)
    params = net.init(jax.random.PRNGKey(0), jnp.asarray(obs))
    jl, jv = net.apply(params, jnp.asarray(obs))
    model = ActorCritic(obs_dim, actions, (256, 128))
    model.load_state_dict(actor_critic_from_flax(
        jax.tree.map(np.asarray, params)))
    with torch.no_grad():
        tl, tv = model(torch.from_numpy(obs))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5,
                               atol=1e-6)
