"""The gridded env, 3-D flight and the wrf_les_3d slice of the port against
the JAX package's, on the CPU.

- ``step_noise`` and ``auto_reset_from_draws`` over JAX's own banks, with
  the same actions, turbulence normals and reset draws, in 3-D flight
  through a [K, T, Z, H, W] bank with wind advection (wrf_les_3d) and in
  2-D flight over static and time-varying banks, read at cells or between
  them.  Done flags, ``reached``, step counts, visit grids and bank rows
  compare with equality; floats at slice 1's env tolerance (rtol 1e-5,
  atol 1e-4).
- One ``build_train_step`` iteration of wrf_les_3d, and one over a static
  bank read between cells, against JAX's ``build_train_step`` at the tiny
  shapes of ``tests/test_env3d.py:115-124`` (episodes cut to 6 steps so the
  iteration sees both episode ends), at slice 1's whole-iteration
  tolerances (``tests/test_torch_train.py``).
- The ``train`` CLI with ``--synth-bank 3d --preset wrf_les_3d --cpu`` and
  its bank-flag rules.
"""

import csv
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_plume.core.config import EnvConfig as JEnvConfig
from tpu_plume.core.config import get_preset as j_get_preset
from tpu_plume.env import methane as jenv
from tpu_plume.fields import gridded as jg
from tpu_plume.fields.analytic import new_field_from_draws as j_new_field
from tpu_plume.fields.analytic import sample_conc_tke as j_sample
from tpu_plume.obsv.metrics import EPISODE_COLUMNS
from tpu_plume.rl.curriculum import curriculum_init as j_cur_init
from tpu_plume.rollout.rollout import init_rollout as j_init_rollout
from tpu_plume.train import ppo_trainer as jtrain
from tpu_plume_torch.cli.main import main as cli_main
from tpu_plume_torch.convert import actor_critic_from_flax, field_bank_from_numpy
from tpu_plume_torch.core.config import EnvConfig
from tpu_plume_torch.core.config import get_preset as t_get_preset
from tpu_plume_torch.env import methane as tenv
from tpu_plume_torch.env.methane import EnvState
from tpu_plume_torch.fields.analytic import FieldState
from tpu_plume_torch.fields.gridded import synthesize_3d_bank
from tpu_plume_torch.rl.curriculum import curriculum_init
from tpu_plume_torch.rollout.rollout import ChunkDraws, EpisodeAccum, RolloutCarry
from tpu_plume_torch.train import ppo_trainer as ttrain

torch.set_num_threads(1)

G = 64
N = 24
STEPS = 12
RTOL, ATOL = 1e-5, 1e-4


def _t(x, dtype=None):
    return torch.from_numpy(np.array(x, dtype=dtype))


def _to_port(jbank):
    return field_bank_from_numpy(
        np.array(jbank.conc), np.array(jbank.source),
        None if jbank.wind is None else np.array(jbank.wind),
        jbank.steps_per_frame, jbank.z_extent)


def _bank(kind, cfg):
    """A JAX bank on the 64-cell grid: static [3, G, G], time-varying
    [3, 4, G, G] or 3-D [3, 4, 5, G, G]."""
    key = jax.random.PRNGKey(len(kind))
    if kind == "static":
        return jg.synthesize_bank(key, cfg, num_fields=3)
    if kind == "time":
        return jg.synthesize_time_varying_bank(key, cfg, num_fields=3,
                                               num_frames=4,
                                               steps_per_frame=3.0)
    return jg.synthesize_3d_bank(key, cfg, num_fields=3, num_frames=4,
                                 num_levels=5, steps_per_frame=3.0)


CASES = {
    # wrf_les_3d: 3-D flight, 5-D bank read between cells, wind advection
    "wrf_les_3d": ("3d", dict(env_3d=True, subcell_sampling=True,
                              wind_advect_coef=0.5)),
    "static_subcell": ("static", dict(subcell_sampling=True)),
    "static_cell": ("static", dict(subcell_sampling=False)),
    "time_advect": ("time", dict(subcell_sampling=True, wind_advect_coef=1.0,
                                 reward_variant="delta")),
}


def _cfgs(**kw):
    env = dict(plume_model="gridded", grid_size=G, source_padding=10.0,
               domain_height=40.0, max_steps=9)
    env.update(kw)
    return JEnvConfig(**env), EnvConfig(**env)


def _j_fresh(u_src, bits, cfg, bank, radius, bonus):
    """The JAX package's fresh state from draws (the construction of
    ``auto_reset_from_draws``), vmapped over envs."""
    def one(u, b, r, e):
        field = j_new_field(u, jnp.zeros(2), b, cfg, bank)
        z = jnp.zeros((), jnp.int32)
        pos = jnp.zeros(cfg.pos_dim, jnp.float32)
        c0, k0 = j_sample(field, z, z, cfg, bank, t=z,
                          z=pos[2] if cfg.env_3d else None, xy=pos[:2])
        d = cfg.grid_divisions
        st = jenv.EnvState(
            pos=pos, t=z, visited=jnp.zeros((d, d), jnp.int32), field=field,
            radius=r, explore_bonus=e, conc=c0, tke=k0, prev_conc=c0,
            prev_action=z)
        return st, jenv.observe(st, cfg, bank)
    return jax.vmap(one)(u_src, bits, radius, bonus)


def _compare(js, jobs, ts, tobs):
    np.testing.assert_array_equal(ts.t.numpy(), np.asarray(js.t))
    np.testing.assert_array_equal(ts.visited.numpy(), np.asarray(js.visited))
    np.testing.assert_array_equal(ts.field.idx.numpy(), np.asarray(js.field.idx))
    np.testing.assert_array_equal(ts.prev_action.numpy(),
                                  np.asarray(js.prev_action))
    for a, b in ((ts.pos, js.pos), (ts.field.source, js.field.source),
                 (ts.conc, js.conc), (ts.tke, js.tke),
                 (ts.prev_conc, js.prev_conc), (tobs, jobs)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.parametrize("case", sorted(CASES))
def test_gridded_env_steps_match_jax(case):
    kind, kw = CASES[case]
    jcfg, tcfg = _cfgs(**kw)
    jbank = _bank(kind, jcfg)
    tbank = _to_port(jbank)
    a = tcfg.num_actions
    rng = np.random.default_rng(len(case))
    radius = rng.uniform(10.0, 60.0, N).astype(np.float32)
    bonus = np.full(N, 0.6, np.float32)
    u0 = rng.random((N, 2), dtype=np.float32)
    b0 = rng.integers(0, 2**32, N, dtype=np.uint64).astype(np.uint32)
    js, jobs = _j_fresh(jnp.asarray(u0), jnp.asarray(b0), jcfg, jbank,
                        jnp.asarray(radius), jnp.asarray(bonus))
    ts, tobs = tenv.reset_from_draws(
        torch.from_numpy(u0), None, torch.from_numpy(b0.view(np.int32)),
        tcfg, bank=tbank)
    ts = ts.replace(radius=torch.from_numpy(radius))
    tobs = tenv.observe(ts, tcfg)
    assert tobs.shape == (N, jcfg.obs_dim)
    _compare(js, jobs, ts, tobs)

    jstep = jax.jit(jax.vmap(
        lambda s, act, n: jenv.step_noise(s, act, n, jcfg, jbank)))
    jreset = jax.jit(jax.vmap(
        lambda s, o, d, u, b: jenv.auto_reset_from_draws(
            s, o, d, u, jnp.zeros(2), b, jcfg, jbank)))
    dones = reached = 0
    for _ in range(STEPS):
        action = rng.integers(0, a, N)
        noise = rng.standard_normal((N, tcfg.pos_dim), dtype=np.float32)
        u = rng.random((N, 2), dtype=np.float32)
        bits = rng.integers(0, 2**32, N, dtype=np.uint64).astype(np.uint32)

        js, jtr = jstep(js, jnp.asarray(action, jnp.int32), jnp.asarray(noise))
        ts, ttr = tenv.step_noise(ts, torch.from_numpy(action),
                                  torch.from_numpy(noise), tcfg, tbank)
        np.testing.assert_array_equal(ttr.done.numpy(), np.asarray(jtr.done))
        np.testing.assert_array_equal(ttr.info.reached.numpy(),
                                      np.asarray(jtr.info.reached))
        for name in ("concentration_reward", "explore_reward", "move_penalty",
                     "tke_penalty", "boundary_penalty", "distance",
                     "conc_raw"):
            np.testing.assert_allclose(
                getattr(ttr.info, name).numpy(),
                np.asarray(getattr(jtr.info, name)), rtol=RTOL, atol=ATOL,
                err_msg=name)
        np.testing.assert_allclose(ttr.reward.numpy(), np.asarray(jtr.reward),
                                   rtol=RTOL, atol=ATOL)
        _compare(js, jtr.obs, ts, ttr.obs)
        dones += int(ttr.done.sum())
        reached += int(ttr.info.reached.sum())

        js, jobs = jreset(js, jtr.obs, jtr.done, jnp.asarray(u),
                          jnp.asarray(bits))
        ts, tobs = tenv.auto_reset_from_draws(
            ts, ttr.obs, ttr.done, torch.from_numpy(u), None,
            torch.from_numpy(bits.view(np.int32)), tcfg, tbank)
        _compare(js, jobs, ts, tobs)
    # the run saw sources reached and episodes timed out
    assert reached > 0 and dones > reached


def _one_env3d(**kw):
    jcfg, tcfg = _cfgs(env_3d=True, subcell_sampling=True, **kw)
    bank = _to_port(_bank("3d", jcfg))
    u = torch.rand(2, 2, generator=torch.Generator().manual_seed(0))
    state, obs = tenv.reset_from_draws(u, None,
                                       torch.arange(2, dtype=torch.int32),
                                       tcfg, bank=bank)
    return tcfg, bank, state, obs


def test_env3d_shapes_obs_layout_and_action_table():
    cfg, _, state, obs = _one_env3d()
    assert cfg.pos_dim == 3 and cfg.obs_dim == 7 and cfg.num_actions == 7
    assert state.pos.shape == (2, 3) and obs.shape == (2, 7)
    state = state.replace(pos=torch.tensor([[1.0, 2.0, 10.0], [3.0, 4.0, 40.0]]))
    obs = tenv.observe(state, cfg)
    torch.testing.assert_close(obs[:, 2], torch.tensor([0.25, 1.0]))
    table = tenv.action_table(cfg, "cpu")
    assert table.shape == (7, 3)
    assert torch.equal(table[5:], torch.tensor([[0.0, 0.0, cfg.z_move_step],
                                                [0.0, 0.0, -cfg.z_move_step]]))


def test_env3d_vertical_moves_clip_and_count_as_full_moves():
    cfg, bank, state, _ = _one_env3d(domain_height=2.0)
    zero = torch.zeros(2, 3)
    up = torch.full((2,), 5)
    s1, tr = tenv.step_noise(state, up, zero, cfg, bank)
    torch.testing.assert_close(s1.pos[:, :2], state.pos[:, :2])
    torch.testing.assert_close(s1.pos[:, 2], torch.full((2,), cfg.z_move_step))
    assert (tr.info.move_penalty == 0.0).all()    # a vertical step is a move
    s2, _ = tenv.step_noise(s1, up, zero, cfg, bank)
    assert (s2.pos[:, 2] == 2.0).all()            # ceiling clip
    s3, tr = tenv.step_noise(state, torch.full((2,), 6), zero, cfg, bank)
    assert (s3.pos[:, 2] == 0.0).all()            # floor clip
    _, tr = tenv.step_noise(state, torch.zeros(2, dtype=torch.int64), zero,
                            cfg, bank)
    assert (tr.info.move_penalty == -cfg.move_penalty_coef).all()


def test_env3d_success_gate_is_horizontal():
    cfg, bank, state, _ = _one_env3d()
    src = state.field.source
    state = state.replace(pos=torch.cat([src, torch.full((2, 1), 35.0)], -1),
                          radius=torch.full((2,), 5.0))
    _, tr = tenv.step_noise(state, torch.zeros(2, dtype=torch.int64),
                            torch.zeros(2, 3), cfg, bank)
    assert tr.info.reached.all() and (tr.info.distance < 1.0).all()


def test_wind_advection_moves_the_agent_horizontally():
    cfg, bank, state, _ = _one_env3d(wind_advect_coef=1.0,
                                     turbulence_intensity=1e-6)
    start = torch.tensor([[30.0, 30.0, 5.0], [20.0, 40.0, 9.0]])
    state = state.replace(pos=start)
    new, _ = tenv.step_noise(state, torch.zeros(2, dtype=torch.int64),
                             torch.zeros(2, 3), cfg, bank)
    from tpu_plume_torch.fields.gridded import bank_wind

    want = bank_wind(bank, state.field.idx, torch.ones(2, dtype=torch.int32))
    torch.testing.assert_close(new.pos[:, :2] - start[:, :2], want,
                               rtol=0, atol=1e-4)
    assert torch.equal(new.pos[:, 2], start[:, 2])


def test_elastic_walls_in_3d_raise_as_jax_does():
    cfg, bank, state, _ = _one_env3d()
    cfg = dataclasses.replace(cfg, elastic_walls=True)
    with pytest.raises(ValueError, match="2-D-only"):
        tenv.step_noise(state, torch.zeros(2, dtype=torch.int64),
                        torch.zeros(2, 3), cfg, bank)


# --- whole iterations ---------------------------------------------------------


NE, T, MB = 8, 8, 32


def _tiny(cfg, env_kw):
    """``tests/test_env3d.py:115-124``'s shapes: a 64-cell grid, 8 envs x 8
    steps, minibatch 32 and 2 epochs; episodes of 6 steps and a goal radius
    of 30, so that episodes both reach the source and time out."""
    return cfg.replace(
        env=dataclasses.replace(cfg.env, grid_size=G, source_padding=10.0,
                                max_steps=6, **env_kw),
        curriculum=dataclasses.replace(cfg.curriculum, initial_radius=30.0),
        rollout=dataclasses.replace(cfg.rollout, num_envs=NE, unroll_length=T),
        ppo=dataclasses.replace(cfg.ppo, minibatch_size=MB, epochs=2),
    )


def _port_env_state(js) -> EnvState:
    return EnvState(
        pos=_t(js.pos), t=_t(js.t), visited=_t(js.visited),
        field=FieldState(source=_t(js.field.source),
                         seed=_t(np.asarray(js.field.seed).view(np.int32)),
                         idx=_t(js.field.idx)),
        radius=_t(js.radius), explore_bonus=_t(js.explore_bonus),
        conc=_t(js.conc), tke=_t(js.tke), prev_conc=_t(js.prev_conc),
        prev_action=_t(js.prev_action, np.int64),
    )


ITERATIONS = {
    "wrf_les_3d": ("wrf_les_3d", {}, "3d"),
    "static_subcell": ("ppo_v2_0", dict(plume_model="gridded",
                                        subcell_sampling=True), "static"),
}


@pytest.fixture(scope="module", params=sorted(ITERATIONS))
def one_iteration(request):
    """One train iteration of each package from the same start, on the same
    bank: ``(jax_out, port_out)``, each ``(loop, stats, traj)``."""
    preset, env_kw, kind = ITERATIONS[request.param]
    jcfg = _tiny(j_get_preset(preset), env_kw)
    tcfg = _tiny(t_get_preset(preset), env_kw)
    if kind == "3d":
        jbank = jg.synthesize_3d_bank(
            jax.random.PRNGKey(0), jcfg.env, num_fields=2, num_frames=3,
            num_levels=4, grid=G, steps_per_frame=8.0)
    else:
        jbank = jg.synthesize_bank(jax.random.PRNGKey(0), jcfg.env,
                                   num_fields=3)
    tbank = _to_port(jbank)
    k_model, k_roll, k_loop = jax.random.split(jax.random.PRNGKey(1), 3)
    ts = jtrain.make_train_state(jcfg, k_model)
    roll = j_init_rollout(k_roll, jcfg.env, NE,
                          radius=jcfg.curriculum.initial_radius,
                          explore_bonus=jcfg.env.explore_bonus_init,
                          bank=jbank)
    jloop = jtrain.LoopCarry(
        train_state=ts, rollout=roll,
        curriculum=j_cur_init(jcfg.curriculum, jcfg.env.explore_bonus_init),
        key=k_loop)

    # The JAX iteration's draws, from its own keys.
    _, k_update = jax.random.split(jloop.key)
    _, k_turb, k_gumbel, k_src, _, k_bits = jax.random.split(roll.key, 6)
    e = jcfg.env
    draws = ChunkDraws(
        turb_noise=_t(jax.random.normal(k_turb, (T, NE, e.pos_dim))),
        gumbel=_t(jax.random.gumbel(k_gumbel, (T, NE, e.num_actions))),
        u_src=_t(jax.random.uniform(k_src, (T, NE, 2))),
        bits=_t(np.asarray(jax.random.bits(k_bits, (T, NE), jnp.uint32))
                .view(np.int32)),
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
    jout = jtrain.build_train_step(jcfg, bank=jbank)(jloop)
    tout = ttrain.build_train_step(tcfg, tbank)(tloop, draws=draws,
                                                shuffles=shuffles)
    return jout, tout, jcfg.ppo.epochs * (NE * T // MB)


def test_rollout_of_one_bank_iteration_matches_jax(one_iteration):
    (_, _, jtraj), (_, _, ttraj), _ = one_iteration
    for name in ("action", "done"):
        np.testing.assert_array_equal(getattr(ttraj, name).numpy(),
                                      np.asarray(getattr(jtraj, name)))
    for name in ("success", "steps"):
        np.testing.assert_array_equal(getattr(ttraj.episode, name).numpy(),
                                      np.asarray(getattr(jtraj.episode, name)))
    for name in ("reward", "value", "log_prob", "obs", "pos", "conc"):
        np.testing.assert_allclose(getattr(ttraj, name).numpy(),
                                   np.asarray(getattr(jtraj, name)),
                                   rtol=1e-5, atol=1e-4, err_msg=name)
    for name in ("total_reward", "final_conc", "distance"):
        np.testing.assert_allclose(getattr(ttraj.episode, name).numpy(),
                                   np.asarray(getattr(jtraj.episode, name)),
                                   rtol=1e-5, atol=1e-4, err_msg=name)
    done = np.asarray(jtraj.done)
    success = np.asarray(jtraj.episode.success)
    assert success.any() and (done & ~success).any()


def test_update_of_one_bank_iteration_matches_jax(one_iteration):
    (jloop, jstats, _), (tloop, tstats, _), steps = one_iteration
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


BANK_FLAGS = ["--bank-fields", "2", "--bank-frames", "2", "--bank-levels", "2"]


def test_cli_trains_wrf_les_3d_on_a_synthesized_bank(tmp_path, capsys):
    out = tmp_path / "run"
    cli_main(["train", "--cpu", "--preset", "wrf_les_3d", "--synth-bank", "3d",
              "--envs", "16", "--unroll", "8", "--minibatch", "32",
              "--iterations", "2", *BANK_FLAGS, "--out", str(out)])
    printed = capsys.readouterr().out.strip().splitlines()[-1]
    assert '"env_steps": 256' in printed
    with open(out / "training_results.csv", newline="") as fh:
        assert next(csv.reader(fh)) == EPISODE_COLUMNS
    sd = torch.load(out / "model" / "ppo_successful_models.pth")
    assert sd["feature.0.weight"].shape == (256, 7)   # 3-D obs
    assert sd["actor.weight"].shape == (7, 128)       # +z / -z actions


@pytest.mark.parametrize("flags,match", [
    (["--synth-bank", "static"], "would ignore it"),
    (["--preset", "wrf_les_3d"], "needs --synth-bank"),
    (["--plume-model", "gridded"], "needs --synth-bank"),
    (["--preset", "wrf_les_3d", "--bank", "bank.nc"], None),
])
def test_cli_bank_flag_rules(flags, match, capsys):
    with pytest.raises(SystemExit) as exc:
        cli_main(["train", "--cpu", "--iterations", "1", *flags])
    if match:
        assert match in str(exc.value)


def test_train_ppo_on_a_static_bank_read_between_cells(tmp_path):
    cfg = t_get_preset("ppo_v2_0")
    cfg = _tiny(cfg, dict(plume_model="gridded", subcell_sampling=True))
    gen = torch.Generator().manual_seed(0)
    from tpu_plume_torch.fields.gridded import synthesize_bank

    bank = synthesize_bank(gen, cfg.env, num_fields=4)
    res = ttrain.train_ppo(cfg, str(tmp_path), device="cpu", max_iterations=2,
                           verbose=False, sync_every=1, bank=bank)
    assert res.env_steps == 2 * NE * T and res.episodes > 0
    with pytest.raises(ValueError, match="requires a FieldBank"):
        ttrain.build_train_step(cfg)


def test_synthesized_3d_bank_has_the_bench_layout():
    cfg = dataclasses.replace(t_get_preset("wrf_les_3d").env, grid_size=20,
                              source_padding=4.0)
    bank = synthesize_3d_bank(torch.Generator().manual_seed(1), cfg)
    assert bank.conc.shape == (4, 8, 8, 20, 20)
    assert bank.wind.shape == (4, 8, 2) and bank.steps_per_frame == 128.0
    assert bank.z_extent == cfg.domain_height
