"""The whole slice, on the CPU: one ``build_train_step`` iteration of the
port against the JAX package's, ``train_ppo`` and the ``train`` CLI.

The JAX iteration's randomness is reproduced with public ``jax.random``
calls (the key splits of ``train/ppo_trainer.py:160``,
``rollout/rollout.py:194-206`` and ``rl/ppo.py:350,317``) and handed to the
port, which starts from the JAX iteration's params, env states and
curriculum.  Actions, dones and successes are compared with equality.
Rewards, values and log-probs get rtol 1e-5 / atol 1e-4 (the env's float
tolerance, ``tests/test_torch_env.py``).  The update's loss metrics are
averages over 20 minibatch steps whose params drift apart by float
rounding, so they get rtol 1e-4 / atol 1e-5; post-update params get atol
1e-6 per Adam step (``tests/test_torch_rl.py``).
"""

import ast
import csv
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_plume.core.config import RolloutConfig as JRolloutCfg
from tpu_plume.core.config import get_preset as j_get_preset
from tpu_plume.data.torch_export import import_actor_critic_pth
from tpu_plume.models import ActorCritic as JActorCritic
from tpu_plume.obsv.metrics import EPISODE_COLUMNS
from tpu_plume.rl.curriculum import curriculum_init as j_cur_init
from tpu_plume.rollout.rollout import init_rollout as j_init_rollout
from tpu_plume.train import ppo_trainer as jtrain
from tpu_plume_torch.cli.main import main as cli_main
from tpu_plume_torch.convert import actor_critic_from_flax
from tpu_plume_torch.core import resolve_device
from tpu_plume_torch.core.config import RolloutConfig
from tpu_plume_torch.core.config import get_preset as t_get_preset
from tpu_plume_torch.env.methane import EnvState
from tpu_plume_torch.fields.analytic import FieldState
from tpu_plume_torch.models import ActorCritic
from tpu_plume_torch.rl.curriculum import curriculum_init
from tpu_plume_torch.rollout.rollout import ChunkDraws, EpisodeAccum, RolloutCarry
from tpu_plume_torch.train import ppo_trainer as ttrain

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HIDDEN = (64, 32)
N, T, MB = 16, 8, 32


def _small(cfg, rollout_cls):
    """ppo_v2_0 cut to test size: 16 envs x 8 steps, a (64, 32) trunk,
    minibatch 32 (4 per epoch, 5 epochs), short episodes, a wide goal
    radius so episodes succeed, and a 4-episode curriculum window."""
    return cfg.replace(
        env=dataclasses.replace(cfg.env, max_steps=6, initial_radius=200.0),
        ppo=dataclasses.replace(cfg.ppo, hidden_sizes=HIDDEN,
                                minibatch_size=MB),
        curriculum=dataclasses.replace(cfg.curriculum, initial_radius=200.0,
                                       window_size=4),
        rollout=rollout_cls(num_envs=N, unroll_length=T),
    )


def _t(x, dtype=None):
    return torch.from_numpy(np.array(x, dtype=dtype))


def _port_env_state(js) -> EnvState:
    return EnvState(
        pos=_t(js.pos), t=_t(js.t), visited=_t(js.visited),
        field=FieldState(source=_t(js.field.source),
                         seed=_t(np.asarray(js.field.seed).view(np.int32))),
        radius=_t(js.radius), explore_bonus=_t(js.explore_bonus),
        conc=_t(js.conc), tke=_t(js.tke), prev_conc=_t(js.prev_conc),
        prev_action=_t(js.prev_action, np.int64),
    )


def _jax_shuffles(key, batch_size, epochs):
    return [int(jax.random.randint(ek, (), 0, batch_size))
            for ek in jax.random.split(key, epochs)]


def run_one_iteration(**ppo):
    """One train iteration of each package from the same start, with the
    PPO config fields ``ppo`` set on both: ``(jax_out, port_out,
    start_params)``, each out ``(loop, stats, traj)``, the start params as
    a port state_dict."""
    jcfg = _small(j_get_preset("ppo_v2_0"), JRolloutCfg)
    tcfg = _small(t_get_preset("ppo_v2_0"), RolloutConfig)
    jcfg = jcfg.replace(ppo=dataclasses.replace(jcfg.ppo, **ppo))
    tcfg = tcfg.replace(ppo=dataclasses.replace(tcfg.ppo, **ppo))
    k_model, k_roll, k_loop = jax.random.split(jax.random.PRNGKey(0), 3)
    ts = jtrain.make_train_state(jcfg, k_model)
    roll = j_init_rollout(k_roll, jcfg.env, N,
                          radius=jcfg.curriculum.initial_radius,
                          explore_bonus=jcfg.env.explore_bonus_init)
    jloop = jtrain.LoopCarry(
        train_state=ts, rollout=roll,
        curriculum=j_cur_init(jcfg.curriculum, jcfg.env.explore_bonus_init),
        key=k_loop)

    # The JAX iteration's draws, from its own keys.
    _, k_update = jax.random.split(jloop.key)
    _, k_turb, k_gumbel, k_src, _, k_bits = jax.random.split(roll.key, 6)
    draws = ChunkDraws(
        turb_noise=_t(jax.random.normal(k_turb, (T, N, 2), jnp.float32)),
        gumbel=_t(jax.random.gumbel(k_gumbel, (T, N, 5), jnp.float32)),
        u_src=_t(jax.random.uniform(k_src, (T, N, 2), jnp.float32)),
        bits=_t(np.asarray(jax.random.bits(k_bits, (T, N), jnp.uint32))
                .view(np.int32)),
    )
    shuffles = _jax_shuffles(k_update, N * T, jcfg.ppo.epochs)

    params0 = jax.tree.map(np.asarray, ts.params)
    model = ttrain.make_policy_model(tcfg)
    model.load_state_dict(actor_critic_from_flax(params0))
    tloop = ttrain.LoopCarry(
        model=model,
        optimizer=ttrain.ClippedAdam(model.parameters(), 3e-5, 0.5),
        rollout=RolloutCarry(env_state=_port_env_state(roll.env_state),
                             obs=_t(roll.obs), accum=EpisodeAccum.zeros(N, "cpu"),
                             generator=torch.Generator()),
        curriculum=curriculum_init(tcfg.curriculum, tcfg.env.explore_bonus_init),
        generator=torch.Generator(),
    )
    jout = jtrain.build_train_step(jcfg)(jloop)
    tout = ttrain.build_train_step(tcfg)(tloop, draws=draws, shuffles=shuffles)
    return jout, tout, actor_critic_from_flax(params0)


@pytest.fixture(scope="module")
def one_iteration():
    """One train iteration of each package from the same start."""
    return run_one_iteration()[:2]


def test_rollout_of_one_iteration_matches_jax(one_iteration):
    (_, _, jtraj), (_, _, ttraj) = one_iteration
    np.testing.assert_array_equal(ttraj.action.numpy(), np.asarray(jtraj.action))
    np.testing.assert_array_equal(ttraj.done.numpy(), np.asarray(jtraj.done))
    np.testing.assert_array_equal(ttraj.episode.success.numpy(),
                                  np.asarray(jtraj.episode.success))
    np.testing.assert_array_equal(ttraj.episode.steps.numpy(),
                                  np.asarray(jtraj.episode.steps))
    for name in ("reward", "value", "log_prob", "obs", "pos", "conc"):
        np.testing.assert_allclose(getattr(ttraj, name).numpy(),
                                   np.asarray(getattr(jtraj, name)),
                                   rtol=1e-5, atol=1e-4, err_msg=name)
    for name in ("total_reward", "final_conc", "distance"):
        np.testing.assert_allclose(getattr(ttraj.episode, name).numpy(),
                                   np.asarray(getattr(jtraj.episode, name)),
                                   rtol=1e-5, atol=1e-4, err_msg=name)
    # the iteration saw both episode ends
    done = np.asarray(jtraj.done)
    success = np.asarray(jtraj.episode.success)
    assert success.any() and (done & ~success).any()


def test_update_and_curriculum_of_one_iteration_match_jax(one_iteration):
    (jloop, jstats, _), (tloop, tstats, _) = one_iteration
    for k in ("loss/total", "loss/policy", "loss/value", "loss/entropy",
              "loss/approx_kl", "loss/clip_frac", "rollout/mean_reward"):
        np.testing.assert_allclose(float(tstats[k]), float(jstats[k]),
                                   rtol=1e-4, atol=1e-5, err_msg=k)
    for k in ("rollout/episodes", "rollout/successes", "curriculum/updates"):
        assert tstats[k] == int(jstats[k]), k
    assert tstats["curriculum/updates"] > 0
    np.testing.assert_allclose(tstats["curriculum/radius"],
                               float(jstats["curriculum/radius"]), rtol=1e-6)
    np.testing.assert_allclose(tstats["curriculum/explore_bonus"],
                               float(jstats["curriculum/explore_bonus"]),
                               rtol=1e-6)
    want = actor_critic_from_flax(jax.tree.map(np.asarray,
                                               jloop.train_state.params))
    steps = 5 * (N * T // MB)
    for k, v in tloop.model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=0,
                                   atol=1e-6 * steps, err_msg=k)


def _train_cfg():
    return _small(t_get_preset("ppo_v2_0"), RolloutConfig)


def test_train_ppo_writes_csv_checkpoint_and_pth(tmp_path):
    res = ttrain.train_ppo(_train_cfg(), str(tmp_path), device="cpu",
                           max_iterations=2, verbose=False, sync_every=1)
    assert res.env_steps == 2 * N * T and res.episodes > 0
    with open(tmp_path / "training_results.csv", newline="") as fh:
        rows = list(csv.reader(fh))
    assert rows[0] == EPISODE_COLUMNS
    assert len(rows) - 1 == res.episodes
    assert sum(int(r[2]) for r in rows[1:]) == res.successes
    ckpt = torch.load(tmp_path / "checkpoint.pt", weights_only=False)
    assert ckpt["counters"]["iteration"] == 2
    # the exported policy loads into the JAX package's flax model
    params = import_actor_critic_pth(
        str(tmp_path / "model" / "ppo_successful_models.pth"))
    obs = np.random.default_rng(0).standard_normal((4, 6), dtype=np.float32)
    logits, value = JActorCritic(num_actions=5, hidden_sizes=HIDDEN).apply(
        params, jnp.asarray(obs))
    m = ActorCritic(6, 5, HIDDEN)
    m.load_state_dict(res.state_dict)
    with torch.no_grad():
        tl, tv = m(torch.from_numpy(obs))
    np.testing.assert_allclose(np.asarray(logits), tl.numpy(), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(np.asarray(value), tv.numpy(), rtol=1e-5,
                               atol=1e-6)


def test_cli_train_on_cpu(tmp_path, capsys):
    out = tmp_path / "run"
    cli_main(["train", "--cpu", "--envs", str(N), "--unroll", str(T),
              "--minibatch", str(MB), "--iterations", "2", "--seed", "3",
              "--reward", "delta", "--obs-memory", "--out", str(out)])
    printed = capsys.readouterr().out.strip().splitlines()[-1]
    assert '"env_steps": 256' in printed
    with open(out / "training_results.csv", newline="") as fh:
        assert next(csv.reader(fh)) == EPISODE_COLUMNS
    sd = torch.load(out / "model" / "ppo_successful_models.pth")
    assert sd["feature.0.weight"].shape == (256, 12)  # obs_memory: 6 + 1 + 5


def test_cli_runs_flags_of_slice_12(tmp_path):
    """``--snapshot-every`` and ``--tensorboard``, refused until slice 12,
    run, and ``--resume`` continues from the snapshot to the same params
    as the run it was taken from."""
    small = ["train", "--cpu", "--envs", str(N), "--unroll", str(T),
             "--minibatch", str(MB), "--hidden", "64,32"]
    cli_main([*small, "--iterations", "2", "--sync-every", "1",
              "--snapshot-every", "1", "--tensorboard", "--out",
              str(tmp_path / "run")])
    assert (tmp_path / "run" / "tb").is_dir()
    cli_main([*small, "--iterations", "2", "--resume",
              str(tmp_path / "run" / "checkpoint_iter000001"), "--out",
              str(tmp_path / "resumed")])
    a, b = (torch.load(tmp_path / d / "checkpoint.pt", weights_only=True)
            for d in ("run", "resumed"))
    for k, v in a["model"].items():
        assert torch.equal(v, b["model"][k]), k


def test_entry_points_raise_without_a_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain.train_ppo(_train_cfg(), str(tmp_path), max_iterations=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli_main(["train", "--iterations", "1", "--out", str(tmp_path)])
    assert resolve_device("cpu").type == "cpu"


def test_train_ppo_runs_distilled_ppo(tmp_path):
    """``distill_oracle`` (once refused until slice 10) runs the teacher in
    the rollout and the imitation term in the update: ``loss/distill``
    reaches ``train_log.csv``."""
    cfg = _train_cfg()
    cfg = cfg.replace(ppo=dataclasses.replace(cfg.ppo, distill_oracle="naive"))
    res = ttrain.train_ppo(cfg, str(tmp_path), device="cpu",
                           max_iterations=ttrain.LOG_EVERY, verbose=False)
    assert res.env_steps == ttrain.LOG_EVERY * N * T
    with open(tmp_path / "train_log.csv", newline="") as fh:
        rows = list(csv.DictReader(fh))
    assert rows and float(rows[-1]["loss/distill"]) > 0


def test_gridded_without_a_bank_raises_value_error(tmp_path):
    cfg = _train_cfg()
    cfg = cfg.replace(env=dataclasses.replace(cfg.env, plume_model="gridded"))
    with pytest.raises(ValueError, match="requires a FieldBank"):
        ttrain.train_ppo(cfg, str(tmp_path), device="cpu", max_iterations=1)


_BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "tpu_plume")


def test_port_imports_without_jax_or_the_jax_package():
    code = (
        "import sys\n"
        f"for name in {_BLOCKED!r}:\n"
        "    sys.modules[name] = None\n"
        "import importlib, pkgutil, tpu_plume_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    tpu_plume_torch.__path__, 'tpu_plume_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "import tpu_plume_torch.cli\n"
        "print(len(names))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 20


def _imported_roots(path):
    tree = ast.parse(open(path).read())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            roots.add(node.module.split(".")[0])
    return roots


def test_chip_smoke_and_port_sources_import_no_jax():
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(os.path.join(REPO, "tpu_plume_torch")):
        paths += [os.path.join(root, f) for f in files if f.endswith(".py")]
    for path in paths:
        bad = _imported_roots(path) & set(_BLOCKED)
        assert not bad, (path, bad)
    assert "tpu_plume_torch" in _imported_roots(paths[0])


def test_episode_assembler_and_radius_tracker_match_jax():
    rng = np.random.default_rng(4)
    t_len, n, max_steps = 12, 5, 7
    steps = np.zeros((t_len, n), np.int32)
    done = np.zeros((t_len, n), bool)
    count = np.zeros(n, np.int32)
    for t in range(t_len):
        count += 1
        steps[t] = count
        done[t] = (count >= max_steps) | (rng.random(n) < 0.2)
        count[done[t]] = 0
    traj = {
        "pos": rng.random((t_len, n, 2), dtype=np.float32) * 500,
        "conc": rng.random((t_len, n), dtype=np.float32) * 100,
        "done": done, "steps": steps,
        "episode": {"success": done & (rng.random((t_len, n)) < 0.5),
                    "radius": np.full((t_len, n), 50.0, np.float32)},
    }
    want = list(jtrain.EpisodeAssembler(n, max_steps).drain(traj))
    got = list(ttrain.EpisodeAssembler(n, max_steps).drain(traj))
    assert len(got) == len(want) == int(done.sum())
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            np.testing.assert_array_equal(np.asarray(g[k]), np.asarray(w[k]),
                                          err_msg=k)
    jt, tt = jtrain.RadiusTracker(), ttrain.RadiusTracker()
    for r, s in [(50.0, True), (45.0, False), (45.0, True), (40.5, True),
                 (50.0, True), (45.0, True), (36.0, True)]:
        assert tt.update(r, s) == jt.update(r, s)
    assert tt.radius_history == jt.radius_history


def test_greedy_rollout_matches_jax():
    from tpu_plume.rollout.rollout import rollout_chunk as j_rollout
    from tpu_plume_torch.rollout.rollout import rollout_chunk

    jcfg = _small(j_get_preset("ppo_v1_1"), JRolloutCfg)
    tcfg = _small(t_get_preset("ppo_v1_1"), RolloutConfig)
    jmodel = JActorCritic(num_actions=5, hidden_sizes=HIDDEN)
    params = jmodel.init(jax.random.PRNGKey(2), jnp.zeros((1, 6)))
    roll = j_init_rollout(jax.random.PRNGKey(3), jcfg.env, N,
                          radius=200.0, explore_bonus=0.6)
    _, k_turb, _, k_src, _, k_bits = jax.random.split(roll.key, 6)
    draws = ChunkDraws(
        turb_noise=_t(jax.random.normal(k_turb, (T, N, 2), jnp.float32)),
        gumbel=None,
        u_src=_t(jax.random.uniform(k_src, (T, N, 2), jnp.float32)),
        bits=_t(np.asarray(jax.random.bits(k_bits, (T, N), jnp.uint32))
                .view(np.int32)),
    )
    _, jtraj, jboot = j_rollout(params, jmodel.apply, roll, jcfg.env, T,
                                greedy=True)
    model = ActorCritic(6, 5, HIDDEN)
    model.load_state_dict(actor_critic_from_flax(jax.tree.map(np.asarray,
                                                              params)))
    carry = RolloutCarry(env_state=_port_env_state(roll.env_state),
                         obs=_t(roll.obs), accum=EpisodeAccum.zeros(N, "cpu"),
                         generator=torch.Generator())
    _, ttraj, tboot = rollout_chunk(model, carry, tcfg.env, T, greedy=True,
                                    draws=draws)
    np.testing.assert_array_equal(ttraj.action.numpy(),
                                  np.asarray(jtraj.action))
    np.testing.assert_array_equal(ttraj.done.numpy(), np.asarray(jtraj.done))
    np.testing.assert_allclose(ttraj.reward.numpy(), np.asarray(jtraj.reward),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(tboot.numpy(), np.asarray(jboot), rtol=1e-5,
                               atol=1e-4)
    assert ttraj.done.any()
