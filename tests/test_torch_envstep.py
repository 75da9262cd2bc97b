"""The rollout's env step: ``env_step_plain`` (the env-step kernel's plain
version) against the JAX package's rollout step on the CPU, and the
``EnvStepper`` wrapper's refusals.

For the four env cases of ``tests/test_torch_env.py`` (the v1_1, v1_0 and
delta rewards and ``obs_memory``) and the analytic plumes of ``wrf_les``
(the anisotropic model in a per-episode wind, with and without wind
advection), three isotropic sources, and 3-D flight over the isotropic and
anisotropic plumes (the latter also with three sources and the delta
reward), a chunk of steps runs from the same fresh episodes with the same
logits, values and draws, made from a seed with numpy, through
``env_step_plain`` and through JAX's Gumbel-max sample, ``step_noise``,
``auto_reset_from_draws`` and the accumulators and episode records of
``tpu_plume/rollout/rollout.py:209-290``.  The radii of 40-300 and short
episodes make envs finish and reset within the chunk.
Integers and bools are compared with equality, floats at the env
tolerance of PERF.md (rtol 1e-5, atol 1e-4).  A CPU rollout never reaches
the kernel's wrapper and leaves the carry it was given as it was; over a
bank it reaches no ``BankStepper`` either, whose input checks take a
wrf_les_3d state over a 3-D bank and refuse what the bank step kernel does
not take.  The benchmark's ``bank_step_roofline`` counts the bytes of
``chip_smoke.py``'s bound of the bank step kernel.
"""

import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_plume.core.config import get_preset as j_get_preset
from tpu_plume.env import methane as jenv
from tpu_plume.fields.analytic import new_field_from_draws as j_new_field
from tpu_plume.fields.analytic import sample_conc_tke as j_sample
from tpu_plume_torch.core import get_preset as t_get_preset
from tpu_plume_torch.env import methane as tenv
from tpu_plume_torch.fields import gridded
from tpu_plume_torch.models import ActorCritic
from tpu_plume_torch.ops import gather, plume
from tpu_plume_torch.rollout import rollout
from tpu_plume_torch.rollout.rollout import ChunkDraws, EpisodeAccum

torch.set_num_threads(1)

N, STEPS = 24, 12
RTOL, ATOL = 1e-5, 1e-4
# The anisotropic base's crosswind term r^2 - downwind^2 cancels near the
# plume's axis, where XLA's CPU evaluation (which contracts multiply-adds)
# and PyTorch's round apart by up to about 1e-4 of the value
# (tests/test_torch_aniso.py); its floats get this tolerance.
ANISO_RTOL, ANISO_ATOL = 1e-4, 1e-3


def tolerance(cfg):
    """(rtol, atol) of the env floats of ``cfg``."""
    if cfg.plume_model == "anisotropic":
        return dict(rtol=ANISO_RTOL, atol=ANISO_ATOL)
    return dict(rtol=RTOL, atol=ATOL)
CASES = {
    "v1_1": ("ppo_v2_0", {}),
    "v1_0": ("ppo_v1_0", {"max_steps": 7}),
    "delta": ("ppo_v2_0", {"reward_variant": "delta", "inplume_bonus": 0.5,
                           "terminal_depth_coef": 30.0,
                           "terminal_depth_power": 2.0,
                           "terminal_gate_radius": 200.0}),
    "obs_memory": ("ppo_v1_1", {"obs_memory": True, "max_steps": 9}),
    "wrf_les": ("wrf_les", {}),
    "aniso_advect": ("wrf_les", {"wind_advect_coef": 0.5, "max_steps": 8}),
    "iso_s3": ("ppo_v2_0", {"num_sources": 3}),
    "aniso_3d": ("wrf_les_3d", {"plume_model": "anisotropic",
                                "wind_speed_range": (1.0, 4.0)}),
    "iso_3d": ("wrf_les_3d", {"plume_model": "isotropic", "max_steps": 10}),
    "aniso_3d_s3_delta": ("wrf_les_3d", {
        "plume_model": "anisotropic", "wind_speed_range": (1.0, 4.0),
        "num_sources": 3, "reward_variant": "delta", "obs_memory": True}),
}
# The cases of this slice's analytic plumes.
ANALYTIC_CASES = ("wrf_les", "aniso_advect", "iso_s3", "aniso_3d", "iso_3d",
                  "aniso_3d_s3_delta")
# EpisodeRecord's fields beside the six totals, as both packages fill them.
RECORD_FLOATS = ("final_conc", "final_x", "final_y", "source_x", "source_y",
                 "radius", "distance")


def _cfgs(case):
    preset, kw = CASES[case]
    return (dataclasses.replace(j_get_preset(preset).env, **kw),
            dataclasses.replace(t_get_preset(preset).env, **kw))


def _inputs(cfg, seed, greedy=False):
    """Fresh-episode draws, curriculum radii and a chunk's logits, values
    and draws, from ``seed`` with numpy."""
    rng = np.random.default_rng(seed)
    a = cfg.num_actions
    u = rng.random((STEPS + 1, N, 2), dtype=np.float32)
    gumbel = -np.log(-np.log(np.clip(rng.random((STEPS, N, a),
                                                dtype=np.float32),
                                     1e-30, None)))
    return dict(
        radius=rng.uniform(40.0, 300.0, N).astype(np.float32),
        u0=u[0], bits0=rng.integers(0, 2**32, N, dtype=np.uint64)
        .astype(np.uint32),
        logits=(2.0 * rng.standard_normal((STEPS, N, a))).astype(np.float32),
        value=rng.standard_normal((STEPS, N)).astype(np.float32),
        gumbel=None if greedy else gumbel.astype(np.float32),
        turb=rng.standard_normal((STEPS, N, cfg.pos_dim), dtype=np.float32),
        u_src=u[1:],
        bits=rng.integers(0, 2**32, (STEPS, N), dtype=np.uint64)
        .astype(np.uint32),
        u_wind=rng.random((STEPS + 1, N, 2), dtype=np.float32))


def _j_start(cfg, x):
    """JAX's fresh state from the draws (``auto_reset_from_draws``'s
    construction), vmapped over envs, and its obs."""
    def one(u, w, b, r):
        field = j_new_field(u, w, b, cfg)
        z = jnp.zeros((), jnp.int32)
        pos = jnp.zeros(cfg.pos_dim, jnp.float32)
        c0, k0 = j_sample(field, z, z, cfg,
                          z=pos[2] if cfg.env_3d else None)
        d = cfg.grid_divisions
        st = jenv.EnvState(
            pos=pos, t=z,
            visited=jnp.zeros((d, d), jnp.int32), field=field, radius=r,
            explore_bonus=jnp.float32(cfg.explore_bonus_init), conc=c0,
            tke=k0, prev_conc=c0, prev_action=z)
        return st, jenv.observe(st, cfg)
    return jax.vmap(one)(jnp.asarray(x["u0"]), jnp.asarray(x["u_wind"][0]),
                         jnp.asarray(x["bits0"]), jnp.asarray(x["radius"]))


def _j_rollout_step(cfg, greedy):
    """One step of ``tpu_plume/rollout/rollout.py``'s scan body after the
    policy's forward, without the recurrent, oracle and guide branches."""
    step = jax.vmap(lambda s, a, n: jenv.step_noise(s, a, n, cfg))
    reset = jax.vmap(lambda s, o, d, u, w, b: jenv.auto_reset_from_draws(
        s, o, d, u, w, b, cfg))

    @jax.jit
    def body(state, acc, logits, gumbel, noise, u, w, bits):
        action = jnp.argmax(logits if greedy else logits + gumbel, axis=-1)
        log_prob = jnp.sum(jax.nn.log_softmax(logits)
                           * jax.nn.one_hot(action, logits.shape[-1]), -1)
        state, trans = step(state, action, noise)
        info = trans.info
        acc = {"total_reward": acc["total_reward"] + trans.reward,
               "conc_reward": acc["conc_reward"] + info.concentration_reward,
               "explore_reward": acc["explore_reward"] + info.explore_reward,
               "move_penalty": acc["move_penalty"] + info.move_penalty,
               "tke_penalty": acc["tke_penalty"] + info.tke_penalty,
               "boundary_penalty": (acc["boundary_penalty"]
                                    + info.boundary_penalty)}
        record = dict(acc, success=info.reached, steps=state.t,
                      final_conc=jnp.where(info.reached, info.conc_raw, 0.0),
                      final_x=state.pos[:, 0], final_y=state.pos[:, 1],
                      source_x=state.field.source[:, 0],
                      source_y=state.field.source[:, 1], radius=state.radius,
                      distance=info.distance)
        row = dict(action=action, log_prob=log_prob, reward=trans.reward,
                   done=trans.done, pos=state.pos, conc=info.conc_raw)
        keep = 1.0 - trans.done.astype(jnp.float32)
        acc = {k: v * keep for k, v in acc.items()}
        state, obs = reset(state, trans.obs, trans.done, u, w, bits)
        return state, obs, acc, row, record

    return body


def _compare_state(js, ts, tol):
    if ts.field.wind is None:
        assert not np.asarray(js.field.wind).any()
    else:
        np.testing.assert_allclose(ts.field.wind.numpy(),
                                   np.asarray(js.field.wind), rtol=RTOL,
                                   atol=ATOL)
    for a, b in ((ts.t, js.t), (ts.visited, js.visited),
                 (ts.prev_action, js.prev_action)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(ts.field.seed.numpy().view(np.uint32),
                                  np.asarray(js.field.seed))
    for a, b in ((ts.pos, js.pos), (ts.field.source, js.field.source),
                 (ts.conc, js.conc), (ts.tke, js.tke),
                 (ts.prev_conc, js.prev_conc)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **tol)


def _run(case, greedy=False):
    jcfg, tcfg = _cfgs(case)
    x = _inputs(tcfg, seed=len(case) + 10 * greedy, greedy=greedy)
    js, _ = _j_start(jcfg, x)
    jacc = {f: jnp.zeros(N, jnp.float32) for f in plume.ACCUM_FIELDS}
    wind, tol = plume.reads_wind(tcfg), tolerance(tcfg)
    ts, _ = tenv.reset_from_draws(
        torch.from_numpy(x["u0"]),
        torch.from_numpy(x["u_wind"][0]) if wind else None,
        torch.from_numpy(x["bits0"].view(np.int32)), tcfg)
    ts = ts.replace(radius=torch.from_numpy(x["radius"]))
    tacc = EpisodeAccum.zeros(N, "cpu")
    draws = ChunkDraws(
        turb_noise=torch.from_numpy(x["turb"]),
        gumbel=None if greedy else torch.from_numpy(x["gumbel"]),
        u_src=torch.from_numpy(x["u_src"]),
        bits=torch.from_numpy(x["bits"].view(np.int32)),
        u_wind=torch.from_numpy(x["u_wind"][1:]) if wind else None)
    traj, obs_rows = rollout.empty_trajectory(STEPS, N, tcfg, "cpu")
    body = _j_rollout_step(jcfg, greedy)
    gumbel = x["gumbel"] if not greedy else np.zeros((STEPS, N, 1),
                                                     np.float32)
    dones = 0
    for t in range(STEPS):
        js, jobs, jacc, jrow, jrec = body(
            js, jacc, jnp.asarray(x["logits"][t]), jnp.asarray(gumbel[t]),
            jnp.asarray(x["turb"][t]), jnp.asarray(x["u_src"][t]),
            jnp.asarray(x["u_wind"][t + 1]), jnp.asarray(x["bits"][t]))
        ts, tobs, tacc = rollout.env_step_plain(
            torch.from_numpy(x["logits"][t]), torch.from_numpy(x["value"][t]),
            draws, t, ts, tacc, traj, obs_rows, tcfg)
        assert tobs.data_ptr() == obs_rows[t + 1].data_ptr()
        for name in ("action", "done"):
            np.testing.assert_array_equal(getattr(traj, name)[t].numpy(),
                                          np.asarray(jrow[name]), name)
        for name in ("success", "steps"):
            np.testing.assert_array_equal(
                getattr(traj.episode, name)[t].numpy(),
                np.asarray(jrec[name]), name)
        np.testing.assert_array_equal(traj.value[t].numpy(), x["value"][t])
        for name in ("log_prob", "reward", "pos", "conc"):
            np.testing.assert_allclose(getattr(traj, name)[t].numpy(),
                                       np.asarray(jrow[name]), **tol,
                                       err_msg=name)
        for name in plume.ACCUM_FIELDS + RECORD_FLOATS:
            np.testing.assert_allclose(getattr(traj.episode, name)[t].numpy(),
                                       np.asarray(jrec[name]), **tol,
                                       err_msg=name)
            if name in jacc:
                np.testing.assert_allclose(getattr(tacc, name).numpy(),
                                           np.asarray(jacc[name]), **tol,
                                           err_msg=name)
        np.testing.assert_allclose(tobs.numpy(), np.asarray(jobs), **tol)
        _compare_state(js, ts, tol)
        dones += int(traj.done[t].sum())
    # the episode record's done is the step's, and the final position is
    # the step's position
    assert traj.episode.done is traj.done
    assert torch.equal(traj.episode.final_x, traj.pos[..., 0])
    assert dones > 0
    return traj


@pytest.mark.parametrize("case", sorted(CASES))
def test_env_step_plain_matches_jax(case):
    traj = _run(case)
    assert traj.episode.success.any()


def test_env_step_plain_matches_jax_greedy():
    _run("v1_1", greedy=True)


@pytest.mark.parametrize("case", ANALYTIC_CASES)
def test_env_step_plain_matches_jax_greedy_on_the_analytic_plumes(case):
    _run(case, greedy=True)


def test_cpu_rollout_never_reaches_the_kernel_and_keeps_the_carry(
        monkeypatch):
    cfg = t_get_preset("ppo_v2_0").env

    def refuse(*args, **kwargs):
        raise AssertionError("the CPU rollout built an EnvStepper")

    monkeypatch.setattr(plume, "EnvStepper", refuse)
    g = torch.Generator().manual_seed(3)
    carry = rollout.init_rollout(cfg, 16, g, radius=200.0)
    kept_state, kept_obs = rollout.own_copy(carry.env_state), carry.obs.clone()
    model = ActorCritic(cfg.obs_dim, cfg.num_actions, (16, 8))
    before = (plume.launches, plume.env_step_launches)
    new, traj, _ = rollout.rollout_chunk(model, carry, cfg, 6)
    assert (plume.launches, plume.env_step_launches) == before
    for f in dataclasses.fields(kept_state):
        if f.name != "field":
            assert torch.equal(getattr(carry.env_state, f.name),
                               getattr(kept_state, f.name)), f.name
    assert torch.equal(carry.env_state.field.source, kept_state.field.source)
    assert torch.equal(carry.obs, kept_obs)
    assert not torch.equal(new.env_state.pos, carry.env_state.pos)
    assert torch.equal(traj.obs[0], carry.obs)


def test_own_copy_shares_no_storage():
    cfg = t_get_preset("ppo_v2_0").env
    carry = rollout.init_rollout(cfg, 4, torch.Generator().manual_seed(0))
    copy = rollout.own_copy(carry.env_state)
    copy.pos += 1.0
    copy.visited += 1
    assert not torch.equal(copy.pos, carry.env_state.pos)
    assert carry.env_state.visited.sum() == 0
    assert copy.field.idx is None


def _step_inputs(cfg, n=8, length=2):
    g = torch.Generator().manual_seed(0)
    carry = rollout.init_rollout(cfg, n, g)
    draws = rollout.draw_chunk(g, cfg, length, n)
    traj, obs = rollout.empty_trajectory(length, n, cfg, "cpu")
    return carry.env_state, carry.accum, draws, traj, obs


def test_env_stepper_refuses_cpu_tensors():
    cfg = t_get_preset("ppo_v2_0").env
    with pytest.raises(ValueError, match="CUDA"):
        plume.EnvStepper(*_step_inputs(cfg), cfg)


def test_env_step_inputs_checks_take_good_inputs():
    for case in CASES:
        cfg = _cfgs(case)[1]
        plume.check_env_step_inputs(*_step_inputs(cfg), cfg, -1)


@pytest.mark.parametrize("fault", [
    "t_dtype", "visited_shape", "pos_contiguous", "pos_aligned", "short_draws",
    "gumbel_dtype", "obs_rows_shape", "record_view", "accum_dtype",
    "bank_field", "gridded", "reward_variant"])
def test_env_step_inputs_checks_refuse(fault):
    cfg = t_get_preset("ppo_v2_0").env
    state, accum, draws, traj, obs = _step_inputs(cfg)
    error = ValueError
    if fault == "t_dtype":
        state, error = state.replace(t=state.t.long()), TypeError
    elif fault == "visited_shape":
        state = state.replace(visited=state.visited[:, :5].contiguous())
    elif fault == "pos_contiguous":
        state = state.replace(pos=torch.zeros(2, 8).t())
    elif fault == "pos_aligned":
        state = state.replace(pos=torch.zeros(17)[1:].view(8, 2))
    elif fault == "short_draws":
        draws = dataclasses.replace(draws, turb_noise=draws.turb_noise[:1])
    elif fault == "gumbel_dtype":
        draws, error = dataclasses.replace(
            draws, gumbel=draws.gumbel.double()), TypeError
    elif fault == "obs_rows_shape":
        obs = obs[:-1]
    elif fault == "record_view":
        traj = dataclasses.replace(traj, episode=dataclasses.replace(
            traj.episode, final_x=traj.pos[..., 0].clone()))
    elif fault == "accum_dtype":
        accum, error = dataclasses.replace(
            accum, tke_penalty=accum.tke_penalty.double()), TypeError
    elif fault == "bank_field":
        state = state.replace(field=dataclasses.replace(
            state.field, idx=torch.zeros(8, dtype=torch.int32)))
    elif fault == "gridded":
        cfg = dataclasses.replace(cfg, plume_model="gridded")
    elif fault == "reward_variant":
        cfg = dataclasses.replace(cfg, reward_variant="v2")
    with pytest.raises(error):
        plume.check_env_step_inputs(state, accum, draws, traj, obs, cfg, -1)


@pytest.mark.parametrize("fault", [
    "wind_missing", "wind_dtype", "wind_on_a_calm_field", "u_wind_missing",
    "u_wind_shape", "turb_2d", "pos_2d", "traj_pos_2d", "too_many_sources",
    "elastic_3d"])
def test_env_step_inputs_checks_refuse_on_the_analytic_modes(fault):
    cfg = _cfgs("aniso_3d_s3_delta")[1]
    state, accum, draws, traj, obs = _step_inputs(cfg)
    field = state.field
    error = ValueError
    if fault == "wind_missing":
        state = state.replace(field=dataclasses.replace(field, wind=None))
    elif fault == "wind_dtype":
        state, error = state.replace(field=dataclasses.replace(
            field, wind=field.wind.double())), TypeError
    elif fault == "wind_on_a_calm_field":
        cfg = dataclasses.replace(cfg, wind_speed_range=(0.0, 0.0))
    elif fault == "u_wind_missing":
        draws = dataclasses.replace(draws, u_wind=None)
    elif fault == "u_wind_shape":
        draws = dataclasses.replace(draws, u_wind=draws.u_wind[:, :4])
    elif fault == "turb_2d":
        draws = dataclasses.replace(
            draws, turb_noise=draws.turb_noise[..., :2].contiguous())
    elif fault == "pos_2d":
        state = state.replace(pos=state.pos[:, :2].contiguous())
    elif fault == "traj_pos_2d":
        traj = dataclasses.replace(traj, pos=traj.pos[..., :2].contiguous())
    elif fault == "too_many_sources":
        cfg = dataclasses.replace(cfg, num_sources=plume.MAX_SOURCES + 1)
    elif fault == "elastic_3d":
        cfg = dataclasses.replace(cfg, elastic_walls=True)
    with pytest.raises(error):
        plume.check_env_step_inputs(state, accum, draws, traj, obs, cfg, -1)


def _bank_step_inputs(n=8, length=2):
    """wrf_les_3d's env on a 16-cell grid over a 3-D [2, 3, 4, 16, 16] bank
    with a per-frame wind: the step's inputs, the config and the bank."""
    cfg = dataclasses.replace(t_get_preset("wrf_les_3d").env, grid_size=16,
                              source_padding=3.0, domain_height=12.0)
    g = torch.Generator().manual_seed(0)
    bank = gridded.synthesize_3d_bank(g, cfg, num_fields=2, num_frames=3,
                                      num_levels=4, steps_per_frame=4.0)
    carry = rollout.init_rollout(cfg, n, g, bank=bank)
    draws = rollout.draw_chunk(g, cfg, length, n)
    traj, obs = rollout.empty_trajectory(length, n, cfg, "cpu")
    return (carry.env_state, carry.accum, draws, traj, obs), cfg, bank


def test_bank_step_inputs_checks_take_a_wrf_les_3d_state():
    inputs, cfg, bank = _bank_step_inputs()
    assert bank.conc.dim() == 5 and bank.wind.dim() == 3
    plume.check_bank_step_inputs(*inputs, cfg, bank, -1)
    # the guided chunk's executed action, with its override rows
    state, accum, draws, _, _ = inputs
    traj, obs = rollout.empty_trajectory(2, 8, cfg, "cpu", guided=True)
    plume.check_bank_step_inputs(state, accum, draws, traj, obs, cfg, bank,
                                 -1, torch.zeros(8, dtype=torch.int64))


def test_bank_stepper_refuses_cpu_tensors():
    inputs, cfg, bank = _bank_step_inputs()
    with pytest.raises(ValueError, match="CUDA"):
        plume.BankStepper(*inputs, cfg, bank)


@pytest.mark.parametrize("fault", [
    "idx_none", "idx_dtype", "cell_reads", "bank_rank", "exec_no_override",
    "analytic", "no_bank", "field_wind", "bank_source_shape",
    "bank_wind_shape", "elastic_3d"])
def test_bank_step_inputs_checks_refuse(fault):
    (state, accum, draws, traj, obs), cfg, bank = _bank_step_inputs()
    error, exec_action = ValueError, None
    if fault == "idx_none":
        state = state.replace(field=dataclasses.replace(state.field,
                                                        idx=None))
    elif fault == "idx_dtype":
        state, error = state.replace(field=dataclasses.replace(
            state.field, idx=state.field.idx.long())), TypeError
    elif fault == "cell_reads":
        cfg = dataclasses.replace(cfg, subcell_sampling=False)
    elif fault == "bank_rank":
        bank = dataclasses.replace(bank, conc=bank.conc[None])
    elif fault == "exec_no_override":
        exec_action = torch.zeros(8, dtype=torch.int64)
    elif fault == "analytic":
        cfg = dataclasses.replace(cfg, plume_model="anisotropic")
    elif fault == "no_bank":
        bank = None
    elif fault == "field_wind":
        state = state.replace(field=dataclasses.replace(
            state.field, wind=torch.zeros(8, 2)))
    elif fault == "bank_source_shape":
        bank = dataclasses.replace(bank, source=bank.source[:1])
    elif fault == "bank_wind_shape":
        bank = dataclasses.replace(bank, wind=bank.wind[..., :1])
    elif fault == "elastic_3d":
        cfg = dataclasses.replace(cfg, elastic_walls=True)
    with pytest.raises(error):
        plume.check_bank_step_inputs(state, accum, draws, traj, obs, cfg,
                                     bank, -1, exec_action)


def test_cpu_rollout_over_a_bank_never_reaches_the_bank_stepper(monkeypatch):
    """A CPU rollout over a bank steps in ``env_step_plain``: it builds no
    stepper, launches nothing, and leaves the carry it was given as it
    was."""
    _, cfg, bank = _bank_step_inputs()

    def refuse(*args, **kwargs):
        raise AssertionError("the CPU rollout built a stepper")

    monkeypatch.setattr(plume, "BankStepper", refuse)
    monkeypatch.setattr(plume, "EnvStepper", refuse)
    g = torch.Generator().manual_seed(3)
    carry = rollout.init_rollout(cfg, 16, g, radius=4.0, bank=bank)
    kept_state, kept_obs = rollout.own_copy(carry.env_state), carry.obs.clone()
    model = ActorCritic(cfg.obs_dim, cfg.num_actions, (16, 8))
    before = (plume.launches, plume.env_step_launches,
              plume.bank_step_launches)
    new, traj, _ = rollout.rollout_chunk(model, carry, cfg, 6, bank=bank)
    assert (plume.launches, plume.env_step_launches,
            plume.bank_step_launches) == before
    for f in dataclasses.fields(kept_state):
        if f.name != "field":
            assert torch.equal(getattr(carry.env_state, f.name),
                               getattr(kept_state, f.name)), f.name
    for name in ("source", "seed", "idx"):
        assert torch.equal(getattr(carry.env_state.field, name),
                           getattr(kept_state.field, name)), name
    assert torch.equal(carry.obs, kept_obs)
    assert not torch.equal(new.env_state.pos, carry.env_state.pos)
    assert torch.equal(traj.obs[0], carry.obs)


def test_bank_step_roofline_counts_the_kernel_tables_bound():
    """The benchmark's ``bank_step_roofline`` counts, over a CPU chunk over
    a 3-D bank with resets, the bytes of ``chip_smoke.bank_step_bytes``
    step by step, and reads nothing without the kernel's device time (as on
    a program without the kernel) or without a bank."""
    import chip_smoke
    from plumebench import counts, registry

    metric = {m.name: m for m in registry.metrics()}["bank_step_roofline"]
    _, cfg, bank = _bank_step_inputs()
    cfg = dataclasses.replace(cfg, max_steps=3)
    n, length = 16, 6
    carry = rollout.init_rollout(cfg, n, torch.Generator().manual_seed(5),
                                 radius=4.0, bank=bank)
    model = ActorCritic(cfg.obs_dim, cfg.num_actions, (16, 8))
    _, traj, _ = rollout.rollout_chunk(model, carry, cfg, length, bank=bank)
    assert traj.done.any()
    want = sum(chip_smoke.bank_step_bytes(plume, gather, cfg, bank, traj, t)
               for t in range(length))
    ctx = SimpleNamespace(
        kernel_time=lambda names: (length, 2e-3),
        bank={"conc": bank.conc, "source": bank.source,
              "steps_per_frame": bank.steps_per_frame,
              "z_extent": bank.z_extent},
        spec=SimpleNamespace(num_envs=n, env={
            "env_3d": cfg.env_3d, "grid_divisions": cfg.grid_divisions}),
        cfg=SimpleNamespace(env=cfg), trajs=[traj])
    assert metric.kernels == ("bank_step_kernel",)
    assert metric.read(ctx, metric) == pytest.approx(
        100.0 * counts.least_seconds(want) / 2e-3, rel=1e-12)
    for missing in ({"kernel_time": lambda names: (0, 0.0)},
                    {"kernel_time": None}, {"bank": None}):
        assert metric.read(SimpleNamespace(**{**vars(ctx), **missing}),
                           metric) is None


def test_env_step_bytes_count_positions_and_wind():
    """3-D flight reads and writes three floats a position and a
    displacement; a field with a wind reads it every step and, where an
    episode ends, its reset uniforms, writing the fresh wind."""
    cfg = t_get_preset("ppo_v2_0").env
    flat = plume.env_step_bytes(cfg, 4096, 3, False)
    aniso = dataclasses.replace(cfg, plume_model="anisotropic",
                                wind_speed_range=(1.0, 4.0))
    assert plume.env_step_bytes(aniso, 4096, 3, False) - flat == (
        4096 * 8 + 3 * 16)
    calm = dataclasses.replace(aniso, wind_speed_range=(0.0, 0.0))
    assert plume.env_step_bytes(calm, 4096, 3, False) == flat
    # 3-D: four position-wide rows (pos read and written, displacement
    # read, trajectory row written) and the obs' z
    flight = dataclasses.replace(cfg, env_3d=True)
    assert flight.num_actions == 7 and flight.obs_dim == 7
    assert plume.env_step_bytes(flight, 4096, 0, True) - plume.env_step_bytes(
        cfg, 4096, 0, True) == 4096 * (4 * 4 + 4 + 2 * 4)


def test_env_step_bytes_count_the_finished_envs():
    cfg = t_get_preset("ppo_v2_0").env
    # per env: 120 bytes read, 82 of trajectory and record rows, 56 of state
    # and 24 of obs written, 4 of the visit cell
    assert plume.env_step_bytes(cfg, 4096, 0, False) == 4096 * 286
    assert plume.env_step_bytes(cfg, 4096, 0, True) == 4096 * 266
    # a finished env reads its reset draws, writes source and seed and
    # clears its 10 x 10 visit grid in place of the visit cell
    assert (plume.env_step_bytes(cfg, 4096, 3, False)
            - plume.env_step_bytes(cfg, 4096, 0, False)) == 3 * (24 + 400 - 4)


def test_greedy_rollout_ignores_the_draws_gumbel_noise():
    cfg = t_get_preset("ppo_v2_0").env
    g = torch.Generator().manual_seed(5)
    carry = rollout.init_rollout(cfg, 16, g, radius=200.0)
    model = ActorCritic(cfg.obs_dim, cfg.num_actions, (16, 8))
    draws = rollout.draw_chunk(torch.Generator().manual_seed(6), cfg, 4, 16)
    _, noisy, _ = rollout.rollout_chunk(model, carry, cfg, 4, greedy=True,
                                        draws=draws)
    _, plain, _ = rollout.rollout_chunk(
        model, carry, cfg, 4, draws=dataclasses.replace(draws, gumbel=None))
    assert torch.equal(noisy.action, plain.action)
    logits, _ = model(carry.obs)
    assert torch.equal(noisy.action[0], torch.argmax(logits, -1))
