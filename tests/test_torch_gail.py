"""GAIL and the imitation CLI of the port against the JAX package on the
CPU.

- one ``build_gail_train_step`` iteration, the loop open and closed, from
  the same policy and discriminator params, env states and curriculum,
  given JAX's draws (the rollout's, the update's shuffles, the
  discriminator's expert and policy rows): actions, the loss metrics,
  ``gail/disc_loss`` and ``gail/disc_acc``, the params of both nets;
- ``train_ppo_gail``'s host loop: ``curve.csv`` (JAX's header and
  formats) byte-equal to JAX's when both packages' train steps are the
  same scripted step, with the anneal from episode 0 and triggered by the
  radius, each read with the ``sync_every`` window's lag;
- its refusals, and its outputs: ``checkpoint.pt`` evaluated by the
  port's ``eval --ckpt``, ``model/ppo_gail.pth`` and
  ``model/discriminator.pth`` read by JAX's importers;
- ``train-bc``, ``train-dagger``, ``train-gail`` and ``train --distill``
  through ``cli_main --cpu``, the configs of both parsers equal, and the
  BC checkpoint evaluated and warm-started through ``--ckpt``.

Tolerances: actions and counts equal; an iteration's loss metrics and the
discriminator's loss and accuracy rtol 1e-4 / atol 1e-5; params after k
Adam steps atol 1e-6 x k.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_evalcli import _run
from test_torch_train import MB, N, T, _jax_shuffles, _port_env_state, _small, _t
from tpu_plume.cli.main import _apply_overrides as j_apply_overrides
from tpu_plume.cli.main import build_parser as j_build_parser
from tpu_plume.core.config import RolloutConfig as JRolloutCfg
from tpu_plume.core.config import get_preset as j_get_preset
from tpu_plume.data.torch_export import import_actor_critic_pth, import_discriminator_pth
from tpu_plume.models import ActorCritic as JActorCritic
from tpu_plume.models import Discriminator as JDiscriminator
from tpu_plume.rl.curriculum import curriculum_init as j_cur_init
from tpu_plume.rollout.rollout import init_rollout as j_init_rollout
from tpu_plume.train import gail_trainer as jgail
from tpu_plume.train import ppo_trainer as jtrain
from tpu_plume_torch.cli.main import apply_overrides, build_parser
from tpu_plume_torch.cli.main import main as cli_main
from tpu_plume_torch.convert import actor_critic_from_flax, discriminator_from_flax
from tpu_plume_torch.core.config import RolloutConfig
from tpu_plume_torch.core.config import get_preset as t_get_preset
from tpu_plume_torch.data.expert import save_expert_data
from tpu_plume_torch.models import Discriminator
from tpu_plume_torch.rl.curriculum import curriculum_init
from tpu_plume_torch.rollout.rollout import ChunkDraws, EpisodeAccum, RolloutCarry
from tpu_plume_torch.train import gail_trainer as tgail
from tpu_plume_torch.train import ppo_trainer as ttrain

torch.set_num_threads(1)

M, DISC_BATCH = 64, 32
COEF = 0.5


def _expert(seed=0, n=M):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, 6)).astype(np.float32),
            rng.integers(0, 5, n))


def run_gail_iteration(closed_loop):
    """One GAIL iteration of each package from the same start, with JAX's
    draws given to the port."""
    jcfg = _small(j_get_preset("ppo_v2_0"), JRolloutCfg)
    tcfg = _small(t_get_preset("ppo_v2_0"), RolloutConfig)
    es, ea = _expert()
    k_model, k_disc, k_roll, k_loop = jax.random.split(
        jax.random.PRNGKey(0), 4)
    ts = jtrain.make_train_state(jcfg, k_model)
    disc_state = jgail.make_disc_state(jcfg, k_disc)
    roll = j_init_rollout(k_roll, jcfg.env, N,
                          radius=jcfg.curriculum.initial_radius,
                          explore_bonus=jcfg.env.explore_bonus_init)
    jloop = jtrain.LoopCarry(
        train_state=ts, rollout=roll,
        curriculum=j_cur_init(jcfg.curriculum, jcfg.env.explore_bonus_init),
        key=k_loop)
    _, k_update, k_exp, k_pol = jax.random.split(k_loop, 4)
    _, k_turb, k_gumbel, k_src, _, k_bits = jax.random.split(roll.key, 6)
    draws = ChunkDraws(
        turb_noise=_t(jax.random.normal(k_turb, (T, N, 2), jnp.float32)),
        gumbel=_t(jax.random.gumbel(k_gumbel, (T, N, 5), jnp.float32)),
        u_src=_t(jax.random.uniform(k_src, (T, N, 2), jnp.float32)),
        bits=_t(np.asarray(jax.random.bits(k_bits, (T, N), jnp.uint32))
                .view(np.int32)))
    disc_idx = (_t(jax.random.randint(k_exp, (DISC_BATCH,), 0, M)).long(),
                _t(jax.random.randint(k_pol, (DISC_BATCH,), 0, N * T)).long())
    jstep = jgail.build_gail_train_step(
        jcfg, jnp.asarray(es), jnp.asarray(ea, jnp.int32),
        closed_loop=closed_loop, disc_batch=DISC_BATCH)
    jcarry, jstats = jstep(jgail.GAILCarry(ppo=jloop, disc_state=disc_state),
                           jnp.float32(COEF))

    model = ttrain.make_policy_model(tcfg)
    model.load_state_dict(actor_critic_from_flax(
        jax.tree.map(np.asarray, ts.params)))
    disc, disc_opt = tgail.make_disc_state(tcfg, "cpu", 0)
    disc.load_state_dict(discriminator_from_flax(
        jax.tree.map(np.asarray, disc_state.params)))
    tloop = ttrain.LoopCarry(
        model=model,
        optimizer=ttrain.ClippedAdam(model.parameters(), 3e-5, 0.5),
        rollout=RolloutCarry(env_state=_port_env_state(roll.env_state),
                             obs=_t(roll.obs),
                             accum=EpisodeAccum.zeros(N, "cpu"),
                             generator=torch.Generator()),
        curriculum=curriculum_init(tcfg.curriculum,
                                   tcfg.env.explore_bonus_init),
        generator=torch.Generator())
    tstep = tgail.build_gail_train_step(
        tcfg, torch.from_numpy(es), torch.from_numpy(ea),
        closed_loop=closed_loop, disc_batch=DISC_BATCH)
    tcarry, tstats, _ = tstep(
        tgail.GAILCarry(ppo=tloop, disc=disc, disc_optimizer=disc_opt),
        COEF, draws=draws,
        shuffles=_jax_shuffles(k_update, N * T, jcfg.ppo.epochs),
        disc_idx=disc_idx)
    return (jcarry, jstats), (tcarry, tstats)


@pytest.fixture(scope="module")
def gail_iterations():
    return {closed: run_gail_iteration(closed) for closed in (False, True)}


@pytest.mark.parametrize("closed_loop", [False, True])
def test_gail_iteration_matches_jax(closed_loop, gail_iterations):
    (jcarry, jstats), (tcarry, tstats) = gail_iterations[closed_loop]
    for k in ("loss/total", "loss/policy", "loss/value", "loss/entropy",
              "loss/approx_kl", "loss/clip_frac", "rollout/mean_reward",
              "gail/disc_loss", "gail/disc_acc"):
        np.testing.assert_allclose(float(tstats[k]), float(jstats[k]),
                                   rtol=1e-4, atol=1e-5, err_msg=k)
    for k in ("rollout/episodes", "rollout/successes"):
        assert tstats[k] == int(jstats[k]), k
    np.testing.assert_allclose(tstats["curriculum/radius"],
                               float(jstats["curriculum/radius"]), rtol=1e-6)
    want = actor_critic_from_flax(jax.tree.map(
        np.asarray, jcarry.ppo.train_state.params))
    steps = 5 * (N * T // MB)
    for k, v in tcarry.ppo.model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=0,
                                   atol=1e-6 * steps, err_msg=k)
    want = discriminator_from_flax(jax.tree.map(
        np.asarray, jcarry.disc_state.params))
    for k, v in tcarry.disc.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=0,
                                   atol=1e-6, err_msg=k)


def test_closed_loop_moves_the_update(gail_iterations):
    """The imitation reward reaches the update: the closed loop's value
    loss differs from the open loop's from the same start and draws."""
    (_, open_stats), (_, closed_stats) = (gail_iterations[False][1],
                                          gail_iterations[True][1])
    assert float(open_stats["loss/value"]) != float(
        closed_stats["loss/value"])


# per-iteration (episodes, successes, radius) of the scripted train step
SCRIPT = [(5, 1, 50.0), (7, 2, 48.0), (3, 0, 45.0), (9, 4, 39.0),
          (6, 3, 36.0), (8, 2, 35.0), (4, 4, 33.0), (10, 5, 30.0),
          (2, 1, 29.0), (7, 3, 25.0), (5, 2, 24.0)]
ANNEALS = {
    "constant": {},
    "from episode 0": dict(gail_anneal_episodes=40),
    "radius trigger": dict(gail_anneal_episodes=30, gail_anneal_radius=40.0),
}


def _scripted(counter, to_stat, to_int=int):
    def step(carry, coef, *a, **k):
        eps, succ, radius = SCRIPT[counter[0]]
        counter[0] += 1
        stats = {"rollout/episodes": to_int(eps),
                 "rollout/successes": to_int(succ),
                 "curriculum/radius": to_stat(radius) if to_int is not int
                 else radius,
                 "rollout/mean_reward": to_stat(0.25 * eps),
                 "gail/disc_loss": to_stat(float(coef)),
                 "gail/disc_acc": to_stat(0.5)}
        return carry, stats
    return step


@pytest.mark.parametrize("anneal", sorted(ANNEALS))
def test_train_ppo_gail_curve_matches_jax(anneal, tmp_path, monkeypatch):
    """The coefficient each iteration gets (written as ``gail_coef`` and,
    through the scripted step, as ``disc_loss``) reads the episodes of
    the windows drained before it: ``sync_every`` 3 lags it by up to three
    iterations in both packages."""
    counters = {"jax": [0], "port": [0]}

    def j_build(*a, **k):
        step = _scripted(counters["jax"], jnp.float32, jnp.int32)
        return lambda carry, coef: step(carry, coef)

    def t_build(*a, **k):
        step = _scripted(counters["port"], torch.tensor)

        def t_step(carry, coef):
            carry, stats = step(carry, coef)
            return carry, stats, None
        return t_step

    monkeypatch.setattr(jgail, "build_gail_train_step", j_build)
    monkeypatch.setattr(tgail, "build_gail_train_step", t_build)
    path = str(tmp_path / "expert_data.npz")
    save_expert_data(path, *_expert())
    jcfg = _small(j_get_preset("ppo_v2_0"), JRolloutCfg)
    tcfg = _small(t_get_preset("ppo_v2_0"), RolloutConfig)
    kw = dict(closed_loop=True, gail_reward_coef=0.2, sync_every=3,
              max_iterations=len(SCRIPT), verbose=False, **ANNEALS[anneal])
    jres = jgail.train_ppo_gail(jcfg, str(tmp_path / "jax"), path, **kw)
    tres = tgail.train_ppo_gail(tcfg, str(tmp_path / "port"), path,
                                device="cpu", **kw)
    want = (tmp_path / "jax" / "curve.csv").read_text()
    got = (tmp_path / "port" / "curve.csv").read_text()
    assert got == want
    assert got.splitlines()[0] == ("iteration,episodes,successes,"
                                   "success_rate,mean_reward,disc_loss,"
                                   "disc_acc,radius,gail_coef")
    coefs = [float(line.split(",")[-1]) for line in got.splitlines()[1:]]
    if anneal == "constant":
        assert set(coefs) == {0.2}
    else:
        assert coefs[0] == 0.2 and 0.0 <= coefs[-1] < 0.2
    assert (tres.episodes, tres.successes) == (jres.episodes, jres.successes)


def test_train_ppo_gail_refusals(tmp_path):
    path = str(tmp_path / "expert_data.npz")
    save_expert_data(path, *_expert())
    jcfg = _small(j_get_preset("ppo_v2_0"), JRolloutCfg)
    tcfg = _small(t_get_preset("ppo_v2_0"), RolloutConfig)
    cases = (
        (lambda c: c.replace(ppo=dataclasses.replace(c.ppo, arch="lstm")),
         {}),
        (lambda c: c, dict(gail_anneal_radius=40.0)),
    )
    for edit, kw in cases:
        with pytest.raises(ValueError) as jerr:
            jgail.train_ppo_gail(edit(jcfg), str(tmp_path / "j"), path, **kw)
        with pytest.raises(ValueError) as terr:
            tgail.train_ppo_gail(edit(tcfg), str(tmp_path / "t"), path,
                                 device="cpu", **kw)
        assert str(terr.value) == str(jerr.value)
    gridded = tcfg.replace(env=dataclasses.replace(tcfg.env,
                                                   plume_model="gridded"))
    with pytest.raises(ValueError, match="takes no field bank"):
        tgail.train_ppo_gail(gridded, str(tmp_path / "g"), path,
                             device="cpu")


def test_gail_outputs_load_in_eval_and_in_jax(tmp_path):
    path = str(tmp_path / "expert_data.npz")
    save_expert_data(path, *_expert())
    out = tmp_path / "gail"
    res = tgail.train_ppo_gail(
        _small(t_get_preset("ppo_v2_0"), RolloutConfig), str(out), path,
        closed_loop=True, max_iterations=2, device="cpu", verbose=False)
    ckpt = torch.load(out / "checkpoint.pt", weights_only=True)
    assert set(ckpt) == {"model", "disc_model", "curriculum", "config"}
    # the port's eval reads it through --ckpt (the run's trunk widths)
    summary = _run(cli_main, ["eval", "--cpu", "--ckpt", str(out),
                              "--hidden", "64,32", "--episodes", "4"])
    assert 0.0 <= summary["success_rate"] <= 1.0
    # JAX's importers read both .pth files: the same logits
    obs = np.random.default_rng(1).normal(size=(8, 6)).astype(np.float32)
    act = np.eye(5, dtype=np.float32)[np.arange(8) % 5]
    jparams = import_actor_critic_pth(str(out / "model" / "ppo_gail.pth"))
    jlogits, _ = JActorCritic(num_actions=5, hidden_sizes=(64, 32)).apply(
        jparams, obs)
    policy = ttrain.make_policy_model(
        _small(t_get_preset("ppo_v2_0"), RolloutConfig))
    policy.load_state_dict(res.state_dict)
    np.testing.assert_allclose(policy(torch.from_numpy(obs))[0].detach().numpy(),
                               np.asarray(jlogits), rtol=1e-5, atol=1e-6)
    dparams = import_discriminator_pth(str(out / "model" /
                                           "discriminator.pth"))
    disc = Discriminator(6, 5)
    disc.load_state_dict(res.disc_state_dict)
    np.testing.assert_allclose(
        disc(torch.from_numpy(obs), torch.from_numpy(act)).detach().numpy(),
        np.asarray(JDiscriminator().apply(dparams, obs, act)), rtol=1e-5,
        atol=1e-6)


SMALL = ["--envs", "16", "--unroll", "8", "--minibatch", "32",
         "--hidden", "64,32"]
COMMANDS = {
    "train-bc": ["train-bc", "--bc-epochs", "2", "--bc-batch", "64"],
    "train-dagger": ["train-dagger", "--rounds", "2", "--bc-epochs", "1",
                     "--bc-batch", "256", "--oracle", "look1"],
    "train-gail": ["train-gail", "--closed-loop", "--gail-anneal", "100",
                   "--gail-anneal-radius", "40", "--iterations", "2",
                   *SMALL],
    "train --distill": ["train", "--distill", "phase", "--distill-coef",
                        "0.3", "--distill-gate", "0.2", "--iterations", "1",
                        *SMALL],
}
KEYS = {"train-bc": {"samples", "train_loss", "val_loss", "val_accuracy",
                     "out"},
        "train-dagger": {"rounds", "samples", "val_accuracy",
                         "rollout_success", "out"},
        "train-gail": {"episodes", "successes", "out_dir"},
        "train --distill": {"episodes", "successes", "success_rate",
                            "env_steps", "steps_per_sec", "out_dir"}}


@pytest.mark.parametrize("name", sorted(COMMANDS))
def test_imitation_commands_run_with_jax_configs(name, tmp_path):
    """Each command's config from both parsers, then the port's run; the
    BC checkpoint also warm-starts ``train --ckpt`` and runs ``eval
    --ckpt``."""
    argv = list(COMMANDS[name])
    if name in ("train-bc", "train-gail"):
        path = str(tmp_path / "expert_data.npz")
        save_expert_data(path, *_expert(n=200))
        argv += ["--expert", path]
    if name == "train-dagger":
        # 8 episodes a round (DAgger's --envs)
        argv += ["--envs", "8", "--hidden", "64,32"]
    out = str(tmp_path / "run")
    argv += ["--out", out]
    jargs = j_build_parser().parse_args(argv)
    targs = build_parser().parse_args(argv)
    jcfg = j_apply_overrides(j_get_preset("ppo_v2_0"), jargs)
    tcfg = apply_overrides(t_get_preset("ppo_v2_0"), targs)
    for part in ("env", "curriculum", "rollout", "ppo"):
        want = dataclasses.asdict(getattr(jcfg, part))
        for key, value in dataclasses.asdict(getattr(tcfg, part)).items():
            assert value == want[key], (part, key)
    for key, value in vars(targs).items():
        if key != "fn":
            assert value == getattr(jargs, key), key
    summary = _run(cli_main, [*argv, "--cpu"])
    assert set(summary) == KEYS[name]
    if name == "train-bc":
        evaluated = _run(cli_main, ["eval", "--cpu", "--ckpt", out,
                                    "--episodes", "4"])
        assert "success_rate" in evaluated
        tuned = _run(cli_main, ["train", "--cpu", "--ckpt", out,
                                "--iterations", "1", "--envs", "16",
                                "--unroll", "8", "--minibatch", "32",
                                "--out", str(tmp_path / "ft")])
        assert tuned["env_steps"] == 128
    if name == "train-gail":
        assert (tmp_path / "run" / "curve.csv").read_text().count("\n") == 3
    if name == "train-dagger":
        assert len(summary["rollout_success"]) == 2
    assert (tmp_path / "run" / "checkpoint.pt").is_file()
