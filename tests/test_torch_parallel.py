"""Data parallel on the CPU (``tpu_plume_torch.parallel``): 2 gloo ranks of
N / 2 envs each against one process of N envs, in the cases of
``tests/torch_parallel_ranks.py`` (the PPO MLP step with the roll and the
permutation shuffles, the recurrent step, a 3-D bank step, the GAIL step
and a DAgger collection), and the port's mesh step against JAX's sharded
step from the same start and draws.

The ranks are spawned once for all cases (``torch.multiprocessing``, a
``FileStore`` in a temporary directory) and save their results; each test
compares them.  Tolerances: actions, dones and successes of the first
iteration equal; rewards, values and log-probs rtol 1e-5 / atol 1e-5; the
loss metrics rtol 1e-4; params after k Adam steps atol 1e-6 x k (PERF.md's
Adam tolerance); the curriculum equal.  Against JAX the env's tolerance
(rtol 1e-5 / atol 1e-4) and the same loss and Adam tolerances, as
``tests/test_torch_train.py`` holds one unsharded iteration.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import torch_parallel_ranks as ranks
from tpu_plume.core.config import RolloutConfig as JRolloutCfg
from tpu_plume.core.config import get_preset as j_get_preset
from tpu_plume.parallel import make_mesh as j_make_mesh
from tpu_plume.parallel import shard_loop_carry as j_shard_loop_carry
from tpu_plume.rl.curriculum import curriculum_init as j_cur_init
from tpu_plume.rollout.rollout import init_rollout as j_init_rollout
from tpu_plume.train import ppo_trainer as jtrain
from tpu_plume_torch.convert import actor_critic_from_flax
from tpu_plume_torch.core.config import get_preset
from tpu_plume_torch.parallel import Mesh, make_mesh, shard_loop_carry
from tpu_plume_torch.train import ppo_trainer as ttrain

torch.set_num_threads(1)

N, T, MB = ranks.N, ranks.T, ranks.MB
W = ranks.WORLD
TRAJ_EXACT = ("action", "done", "success")
TRAJ_FLOAT = ("reward", "value", "log_prob")
LOSSES = ("loss/total", "loss/policy", "loss/value", "loss/entropy",
          "loss/approx_kl", "loss/clip_frac", "rollout/mean_reward")


def jax_start(data_dir):
    """JAX's sharded step (2 devices) from its own start, whose params,
    env states, draws and shuffles go to ``jax_start.npz`` for the port."""
    jcfg = ranks.small(j_get_preset("ppo_v2_0"), JRolloutCfg)
    k_model, k_roll, k_loop = jax.random.split(jax.random.PRNGKey(0), 3)
    ts = jtrain.make_train_state(jcfg, k_model)
    roll = j_init_rollout(k_roll, jcfg.env, N,
                          radius=jcfg.curriculum.initial_radius,
                          explore_bonus=jcfg.env.explore_bonus_init)
    jloop = jtrain.LoopCarry(
        train_state=ts, rollout=roll,
        curriculum=j_cur_init(jcfg.curriculum, jcfg.env.explore_bonus_init),
        key=k_loop)
    # the iteration's draws, from its own keys (tests/test_torch_train.py)
    _, k_update = jax.random.split(jloop.key)
    _, k_turb, k_gumbel, k_src, _, k_bits = jax.random.split(roll.key, 6)
    es = roll.env_state
    arrays = {f"param/{k}": v.numpy() for k, v in actor_critic_from_flax(
        jax.tree.map(np.asarray, ts.params)).items()}
    arrays.update({
        "env/pos": es.pos, "env/t": es.t, "env/visited": es.visited,
        "env/radius": es.radius, "env/explore_bonus": es.explore_bonus,
        "env/conc": es.conc, "env/tke": es.tke, "env/prev_conc": es.prev_conc,
        "env/prev_action": np.asarray(es.prev_action, np.int64),
        "env/source": es.field.source,
        "env/seed": np.asarray(es.field.seed).view(np.int32),
        "obs": roll.obs,
        "draw/turb_noise": jax.random.normal(k_turb, (T, N, 2), jnp.float32),
        "draw/gumbel": jax.random.gumbel(k_gumbel, (T, N, 5), jnp.float32),
        "draw/u_src": jax.random.uniform(k_src, (T, N, 2), jnp.float32),
        "draw/bits": np.asarray(jax.random.bits(k_bits, (T, N), jnp.uint32)
                                ).view(np.int32),
        "shuffles": [int(jax.random.randint(ek, (), 0, N * T))
                     for ek in jax.random.split(k_update, jcfg.ppo.epochs)],
    })
    np.savez(os.path.join(data_dir, "jax_start.npz"),
             **{k: np.asarray(v) for k, v in arrays.items()})
    return jtrain.build_train_step(jcfg)(
        j_shard_loop_carry(jloop, j_make_mesh(2)))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``(one process's results, the ranks' results joined on the env
    axis, JAX's sharded step)`` of every case."""
    data_dir = str(tmp_path_factory.mktemp("ranks"))
    jout = jax_start(data_dir)
    mp.start_processes(ranks.worker, args=(W, os.path.join(data_dir, "store"),
                                           data_dir),
                       nprocs=W, join=True, start_method="spawn")
    single = {name: ranks.run_case(name, None, data_dir)
              for name in ranks.CASES}
    joined = {}
    for name in ranks.CASES:
        parts = [dict(np.load(os.path.join(data_dir, f"{name}_{r}.npz")))
                 for r in range(W)]
        joined[name] = {k: (np.concatenate([p[k] for p in parts],
                                           axis=0 if name == "dagger"
                                           and k in ("succ", "finished")
                                           else 1)
                            if k in TRAJ_EXACT + TRAJ_FLOAT
                            or name == "dagger" else parts)
                        for k in parts[0]}
    return single, joined, jout


def assert_replicas(parts, key):
    """Every rank holds the same value of a replicated ``key``."""
    for p in parts[1:]:
        np.testing.assert_array_equal(p[key], parts[0][key], err_msg=key)


def adam_steps(name):
    cfg = ranks.case_cfg(name)
    if cfg.ppo.arch == "lstm":
        per_epoch = N // max(1, MB // T)
    else:
        per_epoch = N * T // MB
    return ranks.ITERS * cfg.ppo.epochs * per_epoch


@pytest.mark.parametrize("name", ["mlp", "mlp_permutation", "lstm", "bank3d",
                                  "gail"])
def test_two_ranks_step_as_one_process(runs, name):
    single, joined, _ = runs
    want, got = single[name], joined[name]
    for k in TRAJ_EXACT:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k in TRAJ_FLOAT:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-5,
                                   err_msg=k)
    for key in want:
        if key in TRAJ_EXACT + TRAJ_FLOAT:
            continue
        per_rank = got[key]
        assert len(per_rank) == W
        assert_replicas(per_rank, key)
        value = per_rank[0][key]
        if key.startswith("param/") or key.startswith("disc/"):
            np.testing.assert_allclose(value, want[key], rtol=0,
                                       atol=1e-6 * adam_steps(name),
                                       err_msg=key)
        elif key.startswith("cur/") or key in (
                "stat/rollout/episodes", "stat/rollout/successes",
                "stat/curriculum/radius", "stat/curriculum/explore_bonus",
                "stat/curriculum/updates"):
            np.testing.assert_array_equal(value, want[key], err_msg=key)
        else:
            np.testing.assert_allclose(value, want[key], rtol=1e-4,
                                       atol=1e-5, err_msg=key)


def test_two_ranks_collect_dagger_as_one_process(runs):
    single, joined, _ = runs
    want, got = single["dagger"], joined["dagger"]
    for k in ("labels", "valid", "succ", "finished"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_allclose(got["states"], want["states"], rtol=1e-5,
                               atol=1e-5)
    assert want["valid"].any() and want["finished"].any()


def test_mesh_step_agrees_with_jax_sharded_step(runs):
    """The port's mesh step (2 gloo ranks) against JAX's sharded step (2
    devices) from the same start, draws and shuffles."""
    _, joined, (jloop, jstats, jtraj) = runs
    got = joined["jax"]
    for k in TRAJ_EXACT:
        want = np.asarray(jtraj.episode.success if k == "success"
                          else getattr(jtraj, k))
        np.testing.assert_array_equal(got[k], want, err_msg=k)
    for k in TRAJ_FLOAT:
        np.testing.assert_allclose(got[k], np.asarray(getattr(jtraj, k)),
                                   rtol=1e-5, atol=1e-4, err_msg=k)
    rank0 = got["stat/loss/total"][0]
    for k in LOSSES:
        np.testing.assert_allclose(rank0[f"stat/{k}"], float(jstats[k]),
                                   rtol=1e-4, atol=1e-5, err_msg=k)
    for k in ("rollout/episodes", "rollout/successes", "curriculum/updates"):
        assert int(rank0[f"stat/{k}"]) == int(jstats[k]), k
    want = actor_critic_from_flax(jax.tree.map(np.asarray,
                                               jloop.train_state.params))
    steps = 5 * (N * T // MB)
    for k, v in want.items():
        np.testing.assert_allclose(rank0[f"param/{k}"], v.numpy(), rtol=0,
                                   atol=1e-6 * steps, err_msg=k)


def test_make_mesh_too_many_devices():
    with pytest.raises(ValueError, match="available"):
        make_mesh(99)
    mesh = make_mesh()
    assert (mesh.rank, mesh.world_size, mesh.device.type) == (0, 1, "cpu")


def test_num_envs_must_divide_mesh():
    cfg = ranks.small(get_preset("ppo_v2_0"))
    cfg = cfg.replace(rollout=dataclasses.replace(cfg.rollout, num_envs=15))
    loop = ttrain.init_loop(cfg, "cpu")
    mesh = Mesh(rank=0, world_size=2, device=torch.device("cpu"),
                grouped=False)
    with pytest.raises(ValueError, match="divisible"):
        shard_loop_carry(loop, mesh)
