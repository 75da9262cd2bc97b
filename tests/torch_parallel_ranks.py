"""The cases of ``tests/test_torch_parallel.py``, run both by one process
over N envs (``mesh=None``) and by each of the gloo ranks over its N / W
(``worker``, spawned by the test), without JAX: each returns its results
as numpy arrays, the rank's with its own envs only.

A case runs ``ITERS`` train iterations from ``init_loop`` at the same seed
and returns the first iteration's trajectory (actions, dones, successes,
rewards, values, log-probs), the last iteration's stats, the curriculum and
the params after the last; the DAgger case one round's collection; the
``jax`` case one iteration from the start, draws and shuffles that the
test took from JAX's sharded step (``jax_start.npz``).
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch
import torch.distributed as dist

from tpu_plume_torch.core.config import RolloutConfig, get_preset
from tpu_plume_torch.env.methane import EnvState
from tpu_plume_torch.fields.analytic import FieldState
from tpu_plume_torch.fields.gridded import synthesize_3d_bank
from tpu_plume_torch.parallel import make_mesh, shard_gail_carry, shard_loop_carry
from tpu_plume_torch.rl.curriculum import curriculum_init
from tpu_plume_torch.rollout.rollout import ChunkDraws, EpisodeAccum, RolloutCarry
from tpu_plume_torch.train import gail_trainer as tgail
from tpu_plume_torch.train import ppo_trainer as ttrain
from tpu_plume_torch.train.dagger import _collect

N, T, MB, HIDDEN = 16, 8, 32, (64, 32)
ITERS = 2
WORLD = 2
CASES = ("mlp", "mlp_permutation", "lstm", "bank3d", "gail", "dagger", "jax")
DISC_BATCH = 64
DAGGER_STEPS = 40


def small(cfg, rollout_cls=RolloutConfig, **ppo):
    """ppo_v2_0 cut to test size, as ``tests/test_torch_train.py`` cuts it:
    16 envs x 8 steps, a (64, 32) trunk, minibatch 32, short episodes, a
    wide goal radius and a 4-episode curriculum window."""
    return cfg.replace(
        env=dataclasses.replace(cfg.env, max_steps=6, initial_radius=200.0),
        ppo=dataclasses.replace(cfg.ppo, hidden_sizes=HIDDEN,
                                minibatch_size=MB, **ppo),
        curriculum=dataclasses.replace(cfg.curriculum, initial_radius=200.0,
                                       window_size=4),
        rollout=rollout_cls(num_envs=N, unroll_length=T))


def case_cfg(name):
    cfg = get_preset("ppo_v2_0")
    if name == "mlp_permutation":
        return small(cfg, shuffle_mode="permutation")
    if name == "lstm":
        return small(cfg, arch="lstm", lstm_hidden=16, lstm_embed=16)
    if name == "bank3d":
        w3 = get_preset("wrf_les_3d")
        cfg = small(w3)
        return cfg.replace(
            env=dataclasses.replace(cfg.env, grid_size=64,
                                    source_padding=10.0),
            curriculum=dataclasses.replace(cfg.curriculum,
                                           initial_radius=30.0))
    return small(cfg)


def expert(cfg):
    rng = np.random.default_rng(0)
    return (torch.from_numpy(rng.random((512, cfg.env.obs_dim),
                                        np.float32)),
            torch.from_numpy(rng.integers(0, cfg.env.num_actions, 512)))


def _np(x):
    return x.detach().cpu().numpy()


def _trajectory(traj) -> dict:
    return {"action": _np(traj.action), "done": _np(traj.done),
            "success": _np(traj.episode.success),
            "reward": _np(traj.reward), "value": _np(traj.value),
            "log_prob": _np(traj.log_prob)}


def _after(stats, loop) -> dict:
    out = {f"stat/{k}": np.asarray(float(v)) for k, v in stats.items()}
    out.update({f"param/{k}": _np(v)
                for k, v in loop.model.state_dict().items()})
    cur = loop.curriculum
    out.update({"cur/radius": np.asarray(cur.radius),
                "cur/explore_bonus": np.asarray(cur.explore_bonus),
                "cur/counts": np.asarray([cur.success_count,
                                          cur.episode_count,
                                          cur.num_updates])})
    return out


def run_case(name: str, mesh=None, data_dir: str | None = None) -> dict:
    """The case's results (see the module docstring) in one process
    (``mesh`` None) or on a rank of ``mesh``."""
    if name == "dagger":
        return run_dagger(mesh)
    if name == "jax":
        return run_jax_start(mesh, data_dir)
    cfg = case_cfg(name)
    bank = None
    if name == "bank3d":
        bank = synthesize_3d_bank(torch.Generator().manual_seed(7), cfg.env,
                                  num_fields=2, num_frames=3, num_levels=4,
                                  steps_per_frame=8.0)
    loop = ttrain.init_loop(cfg, "cpu", bank)
    out = {}
    if name == "gail":
        disc, opt = tgail.make_disc_state(cfg, "cpu", cfg.seed + 1)
        carry = tgail.GAILCarry(ppo=loop, disc=disc, disc_optimizer=opt)
        if mesh is not None:
            carry = shard_gail_carry(carry, mesh)
        step = tgail.build_gail_train_step(cfg, *expert(cfg),
                                           closed_loop=True,
                                           disc_batch=DISC_BATCH)
        for k in range(ITERS):
            carry, stats, traj = step(carry, 0.1)
            if k == 0:
                out.update(_trajectory(traj))
        out.update({f"disc/{k}": _np(v)
                    for k, v in carry.disc.state_dict().items()})
        out.update(_after(stats, carry.ppo))
        return out
    if mesh is not None:
        loop = shard_loop_carry(loop, mesh)
    step = ttrain.build_train_step(cfg, bank)
    for k in range(ITERS):
        loop, stats, traj = step(loop)
        if k == 0:
            out.update(_trajectory(traj))
    out.update(_after(stats, loop))
    return out


def run_dagger(mesh) -> dict:
    """One student-driven DAgger round's collection of N episodes: the
    rank collects its slice of the global reset draws."""
    from tpu_plume_torch.evaluation.oracle import make_oracle

    cfg = small(get_preset("ppo_v2_0"))
    env = dataclasses.replace(cfg.env, max_steps=DAGGER_STEPS)
    model = ttrain.make_policy_model(cfg).reset_parameters(
        torch.Generator().manual_seed(0))
    states, labels, valid, succ, finished = _collect(
        model, make_oracle("phase", env), env, N, 0.0,
        generator=torch.Generator().manual_seed(1), device="cpu", mesh=mesh)
    return {"states": _np(states), "labels": _np(labels),
            "valid": _np(valid), "succ": _np(succ),
            "finished": _np(finished)}


def start_arrays(loop, draws, shuffles) -> dict:
    """A port loop's start, its draws and shuffles as numpy arrays (what
    the test saves from JAX's start for ``run_jax_start``)."""
    es = loop.rollout.env_state
    out = {f"param/{k}": _np(v) for k, v in loop.model.state_dict().items()}
    out.update({f"env/{f.name}": _np(getattr(es, f.name))
                for f in dataclasses.fields(es) if f.name != "field"})
    out.update({"env/source": _np(es.field.source),
                "env/seed": _np(es.field.seed), "obs": _np(loop.rollout.obs),
                "shuffles": np.asarray(shuffles)})
    out.update({f"draw/{f.name}": _np(getattr(draws, f.name))
                for f in dataclasses.fields(draws)
                if getattr(draws, f.name) is not None})
    return out


def run_jax_start(mesh, data_dir) -> dict:
    """One iteration from JAX's start, draws and shuffles."""
    a = dict(np.load(os.path.join(data_dir, "jax_start.npz")))

    def t(key):
        return torch.from_numpy(a[key])

    cfg = small(get_preset("ppo_v2_0"))
    model = ttrain.make_policy_model(cfg)
    model.load_state_dict({k[6:]: t(k) for k in a if k.startswith("param/")})
    es = EnvState(field=FieldState(source=t("env/source"), seed=t("env/seed")),
                  **{k[4:]: t(k) for k in a if k.startswith("env/")
                     and k not in ("env/source", "env/seed")})
    gen = torch.Generator()
    loop = ttrain.LoopCarry(
        model=model,
        optimizer=ttrain.ClippedAdam(model.parameters(),
                                     cfg.ppo.learning_rate,
                                     cfg.ppo.max_grad_norm),
        rollout=RolloutCarry(env_state=es, obs=t("obs"),
                             accum=EpisodeAccum.zeros(N, "cpu"),
                             generator=gen),
        curriculum=curriculum_init(cfg.curriculum,
                                   cfg.env.explore_bonus_init),
        generator=gen)
    if mesh is not None:
        loop = shard_loop_carry(loop, mesh)
    draws = ChunkDraws(**{k[5:]: t(k) for k in a if k.startswith("draw/")})
    loop, stats, traj = ttrain.build_train_step(cfg)(
        loop, draws=draws, shuffles=[int(s) for s in a["shuffles"]])
    return {**_trajectory(traj), **_after(stats, loop)}


def worker(rank: int, world: int, store_path: str, out_dir: str) -> None:
    """A gloo rank: every case on its envs, each case's results to
    ``out_dir/<case>_<rank>.npz``."""
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(store_path, world), rank=rank,
        world_size=world)
    try:
        mesh = make_mesh(world)
        for name in CASES:
            np.savez(os.path.join(out_dir, f"{name}_{rank}.npz"),
                     **run_case(name, mesh, out_dir))
    finally:
        dist.destroy_process_group()
