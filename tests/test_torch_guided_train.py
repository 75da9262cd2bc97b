"""The guide in the training path of the port, and the guided CLI, against
the JAX package on the CPU.

- ``env_step_plain(exec_action=)``, the env-step kernel's plain version
  with an executed action, against JAX's rollout step fed the same
  executed action (about a third of the envs overridden each step), in the
  v1_1, v1_0, delta, obs_memory and wrf_les cases of
  ``tests/test_torch_envstep.py``; ``check_env_step_inputs`` on
  ``exec_action``.
- ``rollout_chunk(guide=)`` with the fit guide against JAX's given its
  draws (actions, overrides, done, the guide state reset at episode ends),
  and the identity-guide / always-shift contract of
  ``tests/test_rollout.py:86``.
- One guided ``build_train_step`` iteration against JAX's from the same
  params and draws (``tests/test_torch_train.py``'s harness), also with
  ``fused_update`` set, where the weighted batch takes autodiff.
- ``eval --cpu --guide fit`` (with ``--guide-max-se`` and
  ``--guide-search-after``) against JAX's CLI given its draws, ``train
  --cpu --train-guide fit``, and the flags of slice 9b, as JAX parses
  them, reaching the work.

Tolerances: integers, bools and actions equal; env floats rtol 1e-5 / atol
1e-4 (the anisotropic plume's rtol 1e-4 / atol 1e-3); loss metrics rtol
1e-4 / atol 1e-5; params after k Adam steps atol 1e-6 x k.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_envstep import _cfgs, _compare_state, _inputs, _j_start, tolerance
from test_torch_eval import jax_draws, models
from test_torch_evalcli import _run
from test_torch_train import MB, _jax_shuffles, _port_env_state, _small, _t
from tpu_plume.cli.main import build_parser as j_build_parser
from tpu_plume.cli.main import main as j_cli_main
from tpu_plume.core.config import RolloutConfig as JRolloutCfg
from tpu_plume.core.config import get_preset as j_get_preset
from tpu_plume.data.torch_export import export_actor_critic_pth
from tpu_plume.env import methane as jenv
from tpu_plume.evaluation.guidance import make_guide as j_make_guide
from tpu_plume.rl.curriculum import curriculum_init as j_cur_init
from tpu_plume.rollout import rollout as jroll
from tpu_plume.train import ppo_trainer as jtrain
from tpu_plume_torch.cli.main import build_parser
from tpu_plume_torch.cli.main import main as cli_main
from tpu_plume_torch.convert import actor_critic_from_flax
from tpu_plume_torch.core.config import RolloutConfig
from tpu_plume_torch.core.config import get_preset as t_get_preset
from tpu_plume_torch.env import methane as tenv
from tpu_plume_torch.evaluation import harnesses as th
from tpu_plume_torch.evaluation.guidance import make_guide as t_make_guide
from tpu_plume_torch.models import ActorCritic
from tpu_plume_torch.ops import plume
from tpu_plume_torch.rl.curriculum import curriculum_init
from tpu_plume_torch.rollout import rollout
from tpu_plume_torch.rollout.rollout import ChunkDraws, EpisodeAccum, RolloutCarry
from tpu_plume_torch.stop.controllers import broadcast
from tpu_plume_torch.train import ppo_trainer as ttrain

torch.set_num_threads(1)

STEPS, NE = 12, 24


def _exec_actions(x, seed):
    """The sampled actions argmax(logits + Gumbel) [T, N] of ``_inputs``
    and an executed action for each: about a third replaced by another
    action."""
    sampled = np.argmax(x["logits"] + x["gumbel"], -1)
    rng = np.random.default_rng(seed)
    a = x["logits"].shape[-1]
    other = (sampled + rng.integers(1, a, sampled.shape)) % a
    return sampled, np.where(rng.random(sampled.shape) < 1 / 3, other,
                             sampled).astype(np.int64)


@pytest.mark.parametrize("case", ["v1_1", "v1_0", "delta", "obs_memory",
                                  "wrf_les"])
def test_env_step_plain_with_an_executed_action_matches_jax(case):
    jcfg, tcfg = _cfgs(case)
    x = _inputs(tcfg, seed=len(case) + 40)
    sampled, executed = _exec_actions(x, seed=len(case))
    assert (sampled != executed).mean() > 0.2
    js, _ = _j_start(jcfg, x)
    wind, tol = plume.reads_wind(tcfg), tolerance(tcfg)
    ts, _ = tenv.reset_from_draws(
        torch.from_numpy(x["u0"]),
        torch.from_numpy(x["u_wind"][0]) if wind else None,
        torch.from_numpy(x["bits0"].view(np.int32)), tcfg)
    ts = ts.replace(radius=torch.from_numpy(x["radius"]))
    tacc = EpisodeAccum.zeros(NE, "cpu")
    draws = ChunkDraws(
        turb_noise=torch.from_numpy(x["turb"]),
        gumbel=torch.from_numpy(x["gumbel"]),
        u_src=torch.from_numpy(x["u_src"]),
        bits=torch.from_numpy(x["bits"].view(np.int32)),
        u_wind=torch.from_numpy(x["u_wind"][1:]) if wind else None)
    traj, obs_rows = rollout.empty_trajectory(STEPS, NE, tcfg, "cpu",
                                              guided=True)
    step = jax.jit(jax.vmap(lambda s, a, n: jenv.step_noise(s, a, n, jcfg)))
    reset = jax.jit(jax.vmap(lambda s, o, d, u, w, b:
                             jenv.auto_reset_from_draws(s, o, d, u, w, b,
                                                        jcfg)))
    for t in range(STEPS):
        js, trans = step(js, jnp.asarray(executed[t]),
                         jnp.asarray(x["turb"][t]))
        js, jobs = reset(js, trans.obs, trans.done,
                         jnp.asarray(x["u_src"][t]),
                         jnp.asarray(x["u_wind"][t + 1]),
                         jnp.asarray(x["bits"][t]))
        ts, tobs, tacc = rollout.env_step_plain(
            torch.from_numpy(x["logits"][t]), torch.from_numpy(x["value"][t]),
            draws, t, ts, tacc, traj, obs_rows, tcfg,
            exec_action=torch.from_numpy(executed[t]))
        # the record keeps the sampled action and its log-prob
        np.testing.assert_array_equal(traj.action[t].numpy(), sampled[t])
        log_p = jax.nn.log_softmax(jnp.asarray(x["logits"][t]))
        np.testing.assert_allclose(
            traj.log_prob[t].numpy(),
            np.take_along_axis(np.asarray(log_p), sampled[t][:, None],
                               -1)[:, 0], rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(traj.override[t].numpy(),
                                      sampled[t] != executed[t])
        np.testing.assert_array_equal(traj.done[t].numpy(),
                                      np.asarray(trans.done))
        np.testing.assert_allclose(traj.reward[t].numpy(),
                                   np.asarray(trans.reward), **tol)
        np.testing.assert_allclose(tobs.numpy(), np.asarray(jobs), **tol)
        _compare_state(js, ts, tol)


def _step_inputs(cfg, n=8, length=2, guided=True):
    g = torch.Generator().manual_seed(0)
    carry = rollout.init_rollout(cfg, n, g)
    draws = rollout.draw_chunk(g, cfg, length, n)
    traj, obs = rollout.empty_trajectory(length, n, cfg, "cpu", guided=guided)
    return carry.env_state, carry.accum, draws, traj, obs


def test_env_step_inputs_check_the_executed_action():
    cfg = t_get_preset("ppo_v2_0").env
    inputs = _step_inputs(cfg)
    good = torch.zeros(8, dtype=torch.int64)
    plume.check_env_step_inputs(*inputs, cfg, -1, exec_action=good)
    plume.check_env_step_inputs(*inputs, cfg, -1)
    with pytest.raises(TypeError, match="exec_action"):
        plume.check_env_step_inputs(*inputs, cfg, -1,
                                    exec_action=good.to(torch.int32))
    with pytest.raises(ValueError, match="exec_action"):
        plume.check_env_step_inputs(*inputs, cfg, -1, exec_action=good[:4])
    with pytest.raises(ValueError, match="traj.override"):
        plume.check_env_step_inputs(*_step_inputs(cfg, guided=False), cfg,
                                    -1, exec_action=good)
    state, accum, draws, traj, obs = inputs
    traj = dataclasses.replace(traj, override=traj.override[:1])
    with pytest.raises(ValueError, match="override"):
        plume.check_env_step_inputs(state, accum, draws, traj, obs, cfg, -1)


# A small domain with the reference's 25-px move where the guide engages in
# a short chunk: episodes of 40 steps at the protocol's radius 50.
GUIDED_ENV = dict(grid_size=250, source_padding=25.0, move_frac=0.1,
                  max_steps=40)


def _guided_cfgs(**ppo):
    jcfg = _small(j_get_preset("ppo_v2_0"), JRolloutCfg)
    tcfg = _small(t_get_preset("ppo_v2_0"), RolloutConfig)
    out = []
    for cfg in (jcfg, tcfg):
        cfg = cfg.replace(
            env=dataclasses.replace(cfg.env, initial_radius=50.0,
                                    **GUIDED_ENV),
            curriculum=dataclasses.replace(cfg.curriculum,
                                           initial_radius=50.0),
            ppo=dataclasses.replace(cfg.ppo, **ppo),
            rollout=dataclasses.replace(cfg.rollout, unroll_length=32))
        out.append(cfg)
    return out


def _chunk_draws(key, n, t):
    """The port's ``ChunkDraws`` of JAX's ``rollout_chunk`` from its carry
    key (``tpu_plume/rollout/rollout.py:245-259``)."""
    _, k_turb, k_gumbel, k_src, _, k_bits = jax.random.split(key, 6)
    return ChunkDraws(
        turb_noise=_t(jax.random.normal(k_turb, (t, n, 2), jnp.float32)),
        gumbel=_t(jax.random.gumbel(k_gumbel, (t, n, 5), jnp.float32)),
        u_src=_t(jax.random.uniform(k_src, (t, n, 2), jnp.float32)),
        bits=_t(np.asarray(jax.random.bits(k_bits, (t, n), jnp.uint32))
                .view(np.int32)))


def _port_carry(roll, n, guide):
    return RolloutCarry(env_state=_port_env_state(roll.env_state),
                        obs=_t(roll.obs), accum=EpisodeAccum.zeros(n, "cpu"),
                        generator=torch.Generator(),
                        guide_state=broadcast(guide[0], n, "cpu"))


def run_guided_iteration(**ppo):
    """One guided train iteration of each package from the same start:
    ``(jax_out, port_out, start_params)``."""
    jcfg, tcfg = _guided_cfgs(**ppo)
    n, t = jcfg.rollout.num_envs, jcfg.rollout.unroll_length
    jguide = j_make_guide(jcfg.env, terminate_radius=50.0,
                          success_radius=jcfg.eval.success_distance)
    tguide = t_make_guide(tcfg.env, terminate_radius=50.0,
                          success_radius=tcfg.eval.success_distance)
    k_model, k_roll, k_loop = jax.random.split(jax.random.PRNGKey(5), 3)
    ts = jtrain.make_train_state(jcfg, k_model)
    roll = jroll.init_rollout(k_roll, jcfg.env, n,
                              radius=jcfg.curriculum.initial_radius,
                              explore_bonus=jcfg.env.explore_bonus_init,
                              guide=jguide)
    jloop = jtrain.LoopCarry(
        train_state=ts, rollout=roll,
        curriculum=j_cur_init(jcfg.curriculum, jcfg.env.explore_bonus_init),
        key=k_loop)
    _, k_update = jax.random.split(jloop.key)
    draws = _chunk_draws(roll.key, n, t)
    shuffles = _jax_shuffles(k_update, n * t, jcfg.ppo.epochs)
    params0 = jax.tree.map(np.asarray, ts.params)
    model = ttrain.make_policy_model(tcfg)
    model.load_state_dict(actor_critic_from_flax(params0))
    tloop = ttrain.LoopCarry(
        model=model,
        optimizer=ttrain.ClippedAdam(model.parameters(), 3e-5, 0.5),
        rollout=_port_carry(roll, n, tguide),
        curriculum=curriculum_init(tcfg.curriculum,
                                   tcfg.env.explore_bonus_init),
        generator=torch.Generator())
    jout = jtrain.build_train_step(jcfg, guide=jguide)(jloop)
    tout = ttrain.build_train_step(tcfg, guide=tguide)(
        tloop, draws=draws, shuffles=shuffles)
    return jout, tout


@pytest.fixture(scope="module")
def guided_iteration():
    return run_guided_iteration()


def test_guided_rollout_matches_jax(guided_iteration):
    """Actions (the policy's), overrides, dones and positions of the
    guided chunk, and the guide state after it (reset where an episode
    ended), as JAX's."""
    (jloop, _, jtraj), (tloop, _, ttraj) = guided_iteration
    for name in ("action", "done", "override"):
        np.testing.assert_array_equal(getattr(ttraj, name).numpy(),
                                      np.asarray(getattr(jtraj, name)), name)
    for name in ("reward", "value", "log_prob", "obs", "pos", "conc"):
        np.testing.assert_allclose(getattr(ttraj, name).numpy(),
                                   np.asarray(getattr(jtraj, name)),
                                   rtol=1e-5, atol=1e-4, err_msg=name)
    override, done = ttraj.override.numpy(), ttraj.done.numpy()
    assert override.any() and not override.all() and done.any()
    jgs, tgs = jloop.rollout.guide_state, tloop.rollout.guide_state
    for f in dataclasses.fields(tgs):
        got, want = getattr(tgs, f.name).numpy(), np.asarray(getattr(
            jgs, f.name))
        if want.dtype.kind == "f":
            if f.name != "est":
                np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-3,
                                           err_msg=f.name)
        else:
            np.testing.assert_array_equal(got, want, err_msg=f.name)
    # the guide restarted at each env's last episode end: it has taken at
    # most one sample a step since
    ended = done.any(0)
    last = done.shape[0] - 1 - np.argmax(done[::-1], 0)
    assert ended.any()
    since = done.shape[0] - 1 - last
    assert (tgs.count.numpy()[ended] <= since[ended]).all()


def test_guided_train_step_matches_jax(guided_iteration):
    """The update masks the overridden steps out of the policy surrogate
    (``PPOBatch.weights = 1 - override``): loss metrics and params after
    the iteration's Adam steps as JAX's."""
    (jloop, jstats, _), (tloop, tstats, _) = guided_iteration
    _compare_update(jloop, jstats, tloop, tstats)


def _compare_update(jloop, jstats, tloop, tstats):
    for k in ("loss/total", "loss/policy", "loss/value", "loss/entropy",
              "loss/approx_kl", "loss/clip_frac", "rollout/mean_reward"):
        np.testing.assert_allclose(float(tstats[k]), float(jstats[k]),
                                   rtol=1e-4, atol=1e-5, err_msg=k)
    for k in ("rollout/episodes", "rollout/successes"):
        assert tstats[k] == int(jstats[k]), k
    want = actor_critic_from_flax(jax.tree.map(np.asarray,
                                               jloop.train_state.params))
    n, t = tloop.rollout.obs.shape[0], 32
    steps = 5 * (n * t // MB)
    for k, v in tloop.model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=0,
                                   atol=1e-6 * steps, err_msg=k)


def test_guided_fused_update_takes_autodiff(monkeypatch):
    """With ``fused_update`` the weighted batch takes autodiff, as JAX's
    ``rl/ppo.py:294-295`` does: no fused launch, the same iteration."""
    from tpu_plume_torch.ops import ppo as fused_ops

    def refuse(*a, **k):
        raise AssertionError("a weighted batch reached the fused kernel")

    monkeypatch.setattr(fused_ops, "fused_ppo_grads", refuse)
    (jloop, jstats, _), (tloop, tstats, _) = run_guided_iteration(
        fused_update=True)
    _compare_update(jloop, jstats, tloop, tstats)


def test_guide_in_rollout_override_semantics():
    """tests/test_rollout.py:86's contract: an identity guide is a no-op
    with ``override`` all False; an always-shifting guide marks every step,
    stores the policy's action and drives other dynamics."""
    cfg = t_get_preset("ppo_v2_0").env
    n, t = 8, 20
    model = ActorCritic(cfg.obs_dim, cfg.num_actions, (16, 8))
    model.reset_parameters(torch.Generator().manual_seed(0))

    def identity_fn(gs, pos, conc, action):
        return gs + 1.0, action, torch.zeros_like(action, dtype=torch.bool)

    def shift_fn(gs, pos, conc, action):
        return gs + 1.0, (action + 1) % cfg.num_actions, torch.ones_like(
            action, dtype=torch.bool)

    def chunk(guide):
        g = torch.Generator().manual_seed(1)
        carry = rollout.init_rollout(cfg, n, g, guide=guide)
        draws = rollout.draw_chunk(torch.Generator().manual_seed(2), cfg, t,
                                   n)
        return rollout.rollout_chunk(model, carry, cfg, t, draws=draws,
                                     guide=guide)

    _, traj0, _ = chunk(None)
    assert traj0.override is None
    ident = (torch.zeros(()), identity_fn)
    carry_id, traj_id, _ = chunk(ident)
    assert not traj_id.override.any()
    assert torch.equal(traj_id.action, traj0.action)
    assert torch.equal(traj_id.pos, traj0.pos)
    assert carry_id.guide_state.shape == (n,)
    shift = (torch.zeros(()), shift_fn)
    _, traj_sh, _ = chunk(shift)
    assert traj_sh.override.all()
    assert torch.equal(traj_sh.action[0], traj0.action[0])
    assert not torch.equal(traj_sh.pos, traj0.pos)


def test_guided_rollout_needs_the_guide_state():
    cfg = t_get_preset("ppo_v2_0").env
    carry = rollout.init_rollout(cfg, 4, torch.Generator().manual_seed(0))
    model = ActorCritic(cfg.obs_dim, cfg.num_actions, (16, 8))
    with pytest.raises(ValueError, match="guide_state"):
        rollout.rollout_chunk(model, carry, cfg, 2,
                              guide=t_make_guide(cfg))


EPISODES = 12


@pytest.mark.parametrize("preset,flags", [
    ("ppo_v2_0", []), ("ppo_v2_0", ["--guide-max-se", "6"]),
    ("ppo_v2_0", ["--goal-radius", "5"]),
    ("wrf_les", ["--guide-search-after", "40"])])
def test_cli_eval_guide_fit_matches_jax(preset, flags, tmp_path,
                                        monkeypatch):
    """``eval --cpu --guide fit``: the npz (the reference schema plus the
    ten guide fields) episode by episode and the summary JSON's keys as
    JAX's CLI writes them given its draws; wrf_les runs the fit guide with
    the serpentine search.  Over the protocol's 1000 steps the env's own
    float tolerance (positions at 1e-5) can move an agent across a cell
    boundary and part an episode, also without a guide (seed 2's episode 2
    ends 3.44 px apart unguided); at most one of the twelve may part."""
    env = j_get_preset(preset).env
    _, params, _ = models(env)
    path = str(tmp_path / "policy.pth")
    export_actor_critic_pth(jax.tree.map(np.asarray, params), path)
    argv = ["eval", "--cpu", "--preset", preset, "--pth", path,
            "--episodes", str(EPISODES), "--seed", "2", "--guide", "fit",
            *flags]
    want = _run(j_cli_main, argv + ["--out", str(tmp_path / "jax")])
    tcfg = t_get_preset(preset)
    draws = jax_draws(jax.random.PRNGKey(2), tcfg.env, EPISODES,
                      tcfg.env.max_steps)
    monkeypatch.setattr(th, "draw_eval", lambda *a, **k: draws)
    got = _run(cli_main, argv + ["--out", str(tmp_path / "port")])
    assert got.keys() == want.keys()
    jz = np.load(tmp_path / "jax" / "validation_metrics.npz")
    tz = np.load(tmp_path / "port" / "validation_metrics.npz")
    assert tz.files == jz.files
    assert "guide_est" in tz.files and len(tz.files) == 14
    parted = ((tz["steps"] != jz["steps"])
              | (np.abs(tz["deviations"] - jz["deviations"])
                 > 1e-4 + 1e-5 * np.abs(jz["deviations"])))
    for k in tz.files:
        assert tz[k].dtype == jz[k].dtype and tz[k].shape == jz[k].shape, k
        if k in ("steps", "success", "stopped_early") or k.startswith(
                "guide_hover"):
            parted |= tz[k] != jz[k]
    assert parted.sum() <= 1
    keep = ~parted
    for k in tz.files:
        if k in ("deviations", "guide_dmin"):
            np.testing.assert_allclose(tz[k][keep], jz[k][keep], rtol=1e-5,
                                       atol=1e-4, err_msg=k)
        elif k == "guide_est":
            ok = tz["guide_fit_ok"] & keep
            np.testing.assert_allclose(tz[k][ok], jz[k][ok], atol=0.25)
        else:
            np.testing.assert_array_equal(tz[k][keep], jz[k][keep], err_msg=k)
    # the port's summary is its own npz's
    metrics = th.EvalMetrics(**{k: tz[k] for k in (
        "deviations", "steps", "success", "stopped_early")})
    summary = th.summarize(metrics)
    for k, v in summary.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-6, err_msg=k)


def test_cli_eval_guide_fit_refuses_unguidable_physics(tmp_path):
    """ppo_v2_1's plume under the radius-50 protocol raises JAX's
    ``ValueError``."""
    _, params, _ = models(j_get_preset("ppo_v2_1").env)
    path = str(tmp_path / "policy.pth")
    export_actor_critic_pth(jax.tree.map(np.asarray, params), path)
    argv = ["eval", "--cpu", "--preset", "ppo_v2_1", "--pth", path,
            "--guide", "fit"]
    with pytest.raises(ValueError) as want:
        j_cli_main(argv)
    with pytest.raises(ValueError) as got:
        cli_main(argv)
    assert str(got.value) == str(want.value)


def test_cli_train_with_the_training_guide(tmp_path, capsys):
    out = tmp_path / "run"
    cli_main(["train", "--cpu", "--envs", "16", "--unroll", "8",
              "--minibatch", "32", "--iterations", "2", "--hidden", "32,16",
              "--min-radius", "50", "--terminal-gate", "40",
              "--train-guide", "fit", "--out", str(out)])
    assert (out / "checkpoint.pt").exists()
    assert '"env_steps": 256' in capsys.readouterr().out
    args = j_build_parser().parse_args(["train", "--train-guide", "fit"])
    assert args.train_guide == "fit"


@pytest.mark.parametrize("flags", [
    ["--guide", "learned"], ["--guide", "bank"], ["--guide-ckpt", "dir"],
    ["--guide-margin", "1.5"], ["--no-guide-rim-guard"],
    ["--guide-stable-tol=3"], ["--guide-sticky-target"]])
def test_slice_9b_flags_are_refused_before_any_work(flags):
    """Refused until slice 9b was ported: each flag now parses to the
    value JAX's parser gives it, and with a missing ``--pth`` the eval
    fails to load that policy, before the guide is built."""
    want = vars(j_build_parser().parse_args(["eval", *flags]))
    got = vars(build_parser().parse_args(["eval", *flags]))
    for key, value in got.items():
        if key != "fn":
            assert value == want[key], key
    with pytest.raises(FileNotFoundError, match="nonexistent"):
        cli_main(["eval", "--cpu", "--pth", "/nonexistent.pth", *flags])
