"""Policies across the two packages, and the ``eval`` and ``expert``
commands of the port's CLI, on the CPU.

- A JAX policy exported with ``export_actor_critic_pth`` evaluates through
  the port's ``eval --cpu --pth`` as through JAX's ``eval --pth``, given
  JAX's draws; the port's ``model/ppo_successful_models.pth`` imported with
  JAX's ``import_actor_critic_pth`` evaluates in JAX as in the port.
- ``--pth`` and ``--ckpt`` of one run give the same summary; ``expert``
  writes the ``expert_data.npz`` contract.
- ``train_ppo(init_params=)`` starts from those params bit for bit, and
  one iteration from them matches JAX's ``build_train_step`` from the same
  params (``tests/test_torch_train.py``'s harness and tolerances).
- Both ``eval`` parsers build the same config from the flags they share;
  the flags slices 9b, 10 and 11 ported parse as in JAX and reach the
  work, the train flags of distilled PPO too.

Tolerances are ``tests/test_torch_eval.py``'s: steps, stop flags and
success equal, deviations rtol 1e-5 / atol 1e-4.
"""

import contextlib
import csv
import dataclasses
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_eval import MOVE, compare_metrics, jax_draws, models
from test_torch_train import HIDDEN, MB, N, T, _jax_shuffles, _port_env_state, _small, _t
from tpu_plume.cli.main import _apply_overrides as j_apply_overrides
from tpu_plume.cli.main import build_parser as j_build_parser
from tpu_plume.cli.main import main as j_cli_main
from tpu_plume.core.config import RolloutConfig as JRolloutCfg
from tpu_plume.core.config import get_preset as j_get_preset
from tpu_plume.data.torch_export import export_actor_critic_pth, import_actor_critic_pth
from tpu_plume.evaluation import harnesses as jh
from tpu_plume.models import ActorCritic as JActorCritic
from tpu_plume.rl.curriculum import curriculum_init as j_cur_init
from tpu_plume.rollout.rollout import init_rollout as j_init_rollout
from tpu_plume.train import ppo_trainer as jtrain
from tpu_plume_torch.cli.main import apply_overrides, build_parser
from tpu_plume_torch.cli.main import main as cli_main
from tpu_plume_torch.convert import actor_critic_from_flax
from tpu_plume_torch.core.config import RolloutConfig
from tpu_plume_torch.core.config import get_preset as t_get_preset
from tpu_plume_torch.evaluation import harnesses as th
from tpu_plume_torch.rollout.rollout import ChunkDraws, EpisodeAccum, RolloutCarry
from tpu_plume_torch.train import ppo_trainer as ttrain

torch.set_num_threads(1)

EPISODES = 16


def _run(main, argv):
    """``main(argv)``'s last printed line, parsed as JSON."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(argv)
    return json.loads(out.getvalue().strip().splitlines()[-1])


def _close_summaries(got, want):
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-4,
                                   err_msg=k)


def test_jax_pth_evaluates_like_jax_through_the_cli(tmp_path, monkeypatch):
    jmodel, params, _ = models(j_get_preset("ppo_v2_0").env)
    path = str(tmp_path / "jax_policy.pth")
    export_actor_critic_pth(jax.tree.map(np.asarray, params), path)
    flags = ["eval", "--cpu", "--pth", path, "--episodes", str(EPISODES),
             "--seed", "3", "--stop", "heuristic"]
    want = _run(j_cli_main, flags + ["--out", str(tmp_path / "jax")])
    tcfg = t_get_preset("ppo_v2_0")
    draws = jax_draws(jax.random.PRNGKey(3), tcfg.env, EPISODES,
                      tcfg.env.max_steps)
    monkeypatch.setattr(th, "draw_eval", lambda *a, **k: draws)
    got = _run(cli_main, flags + ["--out", str(tmp_path / "port")])
    _close_summaries(got, want)
    jz = np.load(tmp_path / "jax" / "validation_metrics.npz")
    tz = np.load(tmp_path / "port" / "validation_metrics.npz")
    assert jz.files == tz.files
    for k in ("steps", "success", "stopped_early"):
        np.testing.assert_array_equal(tz[k], jz[k], err_msg=k)
    np.testing.assert_allclose(tz["deviations"], jz["deviations"], rtol=1e-5,
                               atol=1e-4)
    with open(tmp_path / "jax" / "evaluation_results.csv") as fh:
        jrows = list(csv.reader(fh))
    with open(tmp_path / "port" / "evaluation_results.csv") as fh:
        trows = list(csv.reader(fh))
    assert [r[:2] + r[3:4] for r in trows] == [r[:2] + r[3:4] for r in jrows]


@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    """A two-iteration CPU run of the port's ``train`` at a tiny size."""
    out = tmp_path_factory.mktemp("run")
    cli_main(["train", "--cpu", "--envs", str(N), "--unroll", str(T),
              "--minibatch", str(MB), "--iterations", "2", "--seed", "1",
              "--out", str(out)])
    return out


def test_port_pth_evaluates_like_jax(port_run):
    path = str(port_run / "model" / "ppo_successful_models.pth")
    jcfg, tcfg = (p("ppo_v2_0") for p in (j_get_preset, t_get_preset))
    jcfg = jcfg.replace(env=dataclasses.replace(jcfg.env, **MOVE))
    tcfg = tcfg.replace(env=dataclasses.replace(tcfg.env, **MOVE))
    params = jax.tree.map(jnp.asarray, import_actor_critic_pth(path))
    key = jax.random.PRNGKey(4)
    jm = jh.evaluate_policy(params, JActorCritic(num_actions=5).apply,
                            jcfg.env, jcfg.eval, key, num_episodes=32,
                            max_steps=60)
    args = build_parser().parse_args(["eval", "--cpu", "--pth", path])
    from tpu_plume_torch.cli.main import load_policy

    model = load_policy(args, tcfg, "cpu")
    tm = th.evaluate_policy(model, tcfg.env, tcfg.eval, num_episodes=32,
                            max_steps=60, device="cpu",
                            draws=jax_draws(key, tcfg.env, 32, 60))
    compare_metrics(jm, tm)


def test_pth_and_ckpt_give_the_same_summary(port_run, tmp_path):
    flags = ["eval", "--cpu", "--episodes", "8", "--stop", "heuristic",
             "--goal-radius", "30"]
    by_pth = _run(cli_main, flags + ["--pth", str(
        port_run / "model" / "ppo_successful_models.pth")])
    by_ckpt = _run(cli_main, flags + ["--ckpt", str(port_run / "checkpoint.pt")])
    by_dir = _run(cli_main, flags + ["--ckpt", str(port_run)])
    assert by_pth == by_ckpt == by_dir
    assert "bullseye_rate" in by_pth
    orbax = tmp_path / "checkpoint"
    orbax.mkdir()
    with pytest.raises(SystemExit, match="Orbax"):
        cli_main(flags + ["--ckpt", str(orbax)])


def test_expert_cli_writes_the_expert_contract(port_run, tmp_path):
    path = str(tmp_path / "expert_data.npz")
    res = _run(cli_main, ["expert", "--cpu", "--ckpt", str(port_run),
                          "--episodes", "4", "--out", path])
    data = np.load(path)
    assert sorted(data.files) == ["actions", "states"]
    assert data["states"].dtype == np.float32
    assert data["actions"].dtype == np.int64
    assert data["states"].shape == (res["samples"], 6)
    assert data["actions"].shape == (res["samples"],)
    assert 0 < res["samples"] <= 4 * 1000 and res["path"] == path


def test_train_ppo_starts_from_init_params_bit_for_bit(tmp_path):
    cfg = _small(t_get_preset("ppo_v2_0"), RolloutConfig)
    jparams = JActorCritic(num_actions=5, hidden_sizes=HIDDEN).init(
        jax.random.PRNGKey(7), jnp.zeros((1, 6)))
    sd = actor_critic_from_flax(jax.tree.map(np.asarray, jparams))
    res = ttrain.train_ppo(cfg, str(tmp_path), device="cpu", max_iterations=0,
                           verbose=False, init_params=sd)
    ckpt = torch.load(tmp_path / "checkpoint.pt", weights_only=True)
    for k, v in sd.items():
        assert torch.equal(res.state_dict[k], v), k
        assert torch.equal(ckpt["model"][k], v), k
    cli_main(["train", "--cpu", "--envs", str(N), "--unroll", str(T),
              "--minibatch", str(MB), "--iterations", "0", "--hidden",
              ",".join(map(str, HIDDEN)), "--ckpt", str(tmp_path),
              "--out", str(tmp_path / "again")])
    again = torch.load(tmp_path / "again" / "checkpoint.pt", weights_only=True)
    for k, v in sd.items():
        assert torch.equal(again["model"][k], v), k


def test_one_iteration_from_init_params_matches_jax():
    jcfg = _small(j_get_preset("ppo_v2_0"), JRolloutCfg)
    tcfg = _small(t_get_preset("ppo_v2_0"), RolloutConfig)
    k_model, k_roll, k_loop = jax.random.split(jax.random.PRNGKey(0), 3)
    init = JActorCritic(num_actions=5, hidden_sizes=HIDDEN).init(
        jax.random.PRNGKey(7), jnp.zeros((1, 6)))
    ts = jtrain.make_train_state(jcfg, k_model).replace(params=init)
    roll = j_init_rollout(k_roll, jcfg.env, N,
                          radius=jcfg.curriculum.initial_radius,
                          explore_bonus=jcfg.env.explore_bonus_init)
    jloop = jtrain.LoopCarry(
        train_state=ts, rollout=roll,
        curriculum=j_cur_init(jcfg.curriculum, jcfg.env.explore_bonus_init),
        key=k_loop)
    _, k_update = jax.random.split(jloop.key)
    _, k_turb, k_gumbel, k_src, _, k_bits = jax.random.split(roll.key, 6)
    draws = ChunkDraws(
        turb_noise=_t(jax.random.normal(k_turb, (T, N, 2), jnp.float32)),
        gumbel=_t(jax.random.gumbel(k_gumbel, (T, N, 5), jnp.float32)),
        u_src=_t(jax.random.uniform(k_src, (T, N, 2), jnp.float32)),
        bits=_t(np.asarray(jax.random.bits(k_bits, (T, N), jnp.uint32))
                .view(np.int32)),
    )
    sd = actor_critic_from_flax(jax.tree.map(np.asarray, init))
    tloop = ttrain.init_loop(tcfg, "cpu", init_params=sd)
    for k, v in tloop.model.state_dict().items():
        assert torch.equal(v, sd[k]), k
    tloop = dataclasses.replace(tloop, rollout=RolloutCarry(
        env_state=_port_env_state(roll.env_state), obs=_t(roll.obs),
        accum=EpisodeAccum.zeros(N, "cpu"), generator=torch.Generator()))
    jloop, jstats, jtraj = jtrain.build_train_step(jcfg)(jloop)
    tloop, tstats, ttraj = ttrain.build_train_step(tcfg)(
        tloop, draws=draws,
        shuffles=_jax_shuffles(k_update, N * T, jcfg.ppo.epochs))
    np.testing.assert_array_equal(ttraj.action.numpy(), np.asarray(jtraj.action))
    np.testing.assert_array_equal(ttraj.done.numpy(), np.asarray(jtraj.done))
    for name in ("reward", "value", "log_prob"):
        np.testing.assert_allclose(getattr(ttraj, name).numpy(),
                                   np.asarray(getattr(jtraj, name)),
                                   rtol=1e-5, atol=1e-4, err_msg=name)
    np.testing.assert_allclose(float(tstats["loss/total"]),
                               float(jstats["loss/total"]), rtol=1e-4,
                               atol=1e-5)
    want = actor_critic_from_flax(jax.tree.map(np.asarray,
                                               jloop.train_state.params))
    steps = 5 * (N * T // MB)
    for k, v in tloop.model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=0,
                                   atol=1e-6 * steps, err_msg=k)


SHARED = {
    "none": [],
    "plume": ["--plume-model", "anisotropic"],
    "reward": ["--reward", "delta", "--obs-memory", "--inplume-bonus", "0.1"],
    "recipe": ["--min-radius", "50", "--terminal-gate", "40"],
    "depth": ["--depth-coef", "0.5", "--depth-power", "2.0"],
    "hidden": ["--hidden", "512,256", "--bf16", "--f32-heads"],
    "run": ["--episodes", "64", "--seed", "3", "--envs", "32"],
}


@pytest.mark.parametrize("cmd", ["eval", "expert"])
@pytest.mark.parametrize("flags", sorted(SHARED))
def test_eval_parsers_build_jax_config(cmd, flags):
    argv = [cmd, "--preset", "ppo_v2_0", *SHARED[flags]]
    jcfg = j_apply_overrides(j_get_preset("ppo_v2_0"),
                             j_build_parser().parse_args(argv))
    tcfg = apply_overrides(t_get_preset("ppo_v2_0"),
                           build_parser().parse_args(argv))
    for part in ("env", "curriculum", "ppo", "eval", "stop"):
        want = dataclasses.asdict(getattr(jcfg, part))
        for key, value in dataclasses.asdict(getattr(tcfg, part)).items():
            assert key in want, (part, key)
            assert value == want[key], (part, key, value, want[key])
    assert (tcfg.total_episodes, tcfg.seed) == (jcfg.total_episodes, jcfg.seed)
    if cmd == "expert":
        assert build_parser().parse_args(argv).out == "expert_data.npz"


# The flags of slices 9b (the bank and learned guides), 10 (the oracles)
# and 11 (the localizer) that once were refused here, and what a command
# given a policy file that does not exist does with each now: fail to load
# that policy, or, where an oracle replaces the policy, run without it.
REFUSED = {   # flags: what the command does
    "guide_learned": (["--guide", "learned"], "policy"),
    "guide_bank": (["--guide", "bank"], "policy"),
    "guide_margin": (["--guide-margin", "1.5"], "policy"),
    "guide_rim_guard": (["--no-guide-rim-guard"], "policy"),
    "guide_ckpt": (["--guide-ckpt", "dir"], "policy"),
    "oracle": (["--oracle", "phase"], "runs"),
    "localize": (["--localize", "dir"], "policy"),
    "localize_window": (["--localize-window", "32"], "policy"),
    "expert_oracle": (["--oracle", "naive"], "runs"),
}


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_flags_of_later_slices_are_refused_before_any_work(name, tmp_path):
    """Each flag that slices 9b, 10 and 11 refused until they were ported
    parses to the value JAX's parser gives it and reaches the work: with a
    missing ``--pth`` the command fails to load that policy, or flies the
    oracle, which loads none (as in JAX)."""
    flags, outcome = REFUSED[name]
    cmd = "expert" if name.startswith("expert") else "eval"
    want = vars(j_build_parser().parse_args([cmd, *flags]))
    got = vars(build_parser().parse_args([cmd, *flags]))
    for key, value in got.items():
        if key != "fn":
            assert value == want[key], key
    argv = [cmd, "--cpu", "--pth", "/nonexistent.pth", "--episodes", "4",
            "--out", str(tmp_path / ("x.npz" if cmd == "expert" else "x")),
            *flags]
    if outcome == "policy":
        with pytest.raises(FileNotFoundError, match="nonexistent"):
            cli_main(argv)
    else:
        out = _run(cli_main, argv)
        assert ("samples" if cmd == "expert" else "success_rate") in out


# The train flags of slice 10 (distilled PPO) that once were refused here,
# and the config field each sets.
TRAIN_PORTED = {   # name: (flags, ppo field, value)
    "distill": (["--distill", "phase"], "distill_oracle", "phase"),
    "distill_coef": (["--distill-coef", "0.1"], "distill_coef", 0.1),
    "distill_gate": (["--distill-gate=0.2"], "distill_conc_gate", 0.2),
}


@pytest.mark.parametrize("name", sorted(TRAIN_PORTED))
def test_train_flags_of_slice_10_reach_the_work(name, tmp_path):
    """Each train flag that slice 10 refused until it was ported parses as
    JAX's parser parses it, sets the config field JAX's overrides set,
    and the train command runs with it."""
    flags, field, value = TRAIN_PORTED[name]
    argv = ["train", "--iterations", "1", "--envs", str(N), "--unroll",
            str(T), "--minibatch", str(MB), "--hidden", "64,32", *flags]
    jcfg = j_apply_overrides(j_get_preset("ppo_v2_0"),
                             j_build_parser().parse_args(argv))
    tcfg = apply_overrides(t_get_preset("ppo_v2_0"),
                           build_parser().parse_args(argv))
    assert getattr(tcfg.ppo, field) == getattr(jcfg.ppo, field) == value
    assert dataclasses.asdict(tcfg.ppo) == dataclasses.asdict(jcfg.ppo)
    out = _run(cli_main, [*argv, "--cpu", "--out", str(tmp_path / "run")])
    assert out["env_steps"] == N * T


# The train flags of slice 12, refused until it ported them, and what each
# leaves in the run directory.
TRAIN_SLICE_12 = {   # name: (flags, a file of the run)
    "resume": (["--resume", "BASE"], "checkpoint.pt"),
    # one drain window (sync_every 8): the snapshot of its end
    "snapshot_every": (["--snapshot-every", "1"],
                       "checkpoint_iter000002/checkpoint.pt"),
    "tensorboard": (["--tensorboard"], "tb"),
    "profile_steps": (["--profile-steps", "1", "--iterations", "3"],
                      "profile/trace.json"),
    "debug_nans": (["--debug-nans"], "checkpoint.pt"),
}


@pytest.mark.parametrize("name", sorted(TRAIN_SLICE_12))
def test_train_flags_of_slice_12_reach_the_work(name, tmp_path):
    """Each train flag of slice 12 parses as JAX's parser parses it and the
    train command runs with it (``--resume`` from a run of one iteration,
    to two)."""
    flags, made = TRAIN_SLICE_12[name]
    base = str(tmp_path / "base")
    flags = [base if f == "BASE" else f for f in flags]
    argv = ["train", "--iterations", "2", "--envs", str(N), "--unroll",
            str(T), "--minibatch", str(MB), "--hidden", "64,32", *flags]
    want = vars(j_build_parser().parse_args(argv))
    for key, value in vars(build_parser().parse_args(argv)).items():
        if key not in ("fn", "out"):    # the port's run directory is its own
            assert value == want[key], key
    if name == "resume":
        _run(cli_main, [*argv[:-2], "--iterations", "1", "--cpu", "--out",
                        base])
    out = tmp_path / "run"
    printed = _run(cli_main, [*argv, "--cpu", "--out", str(out)])
    assert printed["env_steps"] == (3 if name == "profile_steps"
                                    else 2) * N * T
    assert (out / made).exists()


@pytest.mark.parametrize("cmd", ["train", "eval", "expert"])
def test_flags_no_slice_ports_are_errors(cmd, capsys):
    with pytest.raises(SystemExit) as exc:
        cli_main([cmd, "--cpu", "--pth", "/nonexistent.pth", "--typo", "3"])
    assert exc.value.code == 2
    assert "unrecognized arguments: --typo 3" in capsys.readouterr().err


def test_eval_runs_on_the_card_unless_asked_for_the_cpu(port_run, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli_main(["eval", "--pth", str(port_run / "model" /
                                       "ppo_successful_models.pth")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli_main(["expert", "--ckpt", str(port_run)])

