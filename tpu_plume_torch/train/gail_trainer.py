"""GAIL: PPO with a discriminator, the loop open or closed (port of
``tpu_plume/train/gail_trainer.py``).

One iteration runs the PPO train step's rollout (``rollout_chunk``: on
the card one env-step launch per env step), GAE and ``ppo_update`` (the
fused PPO kernels under ``fused_update``), then one discriminator step on
``disc_batch`` expert pairs against ``disc_batch`` pairs of the rollout
(plain Adam, lr 1e-3, optax's ``adam``).  With ``closed_loop`` the
rewards gain ``gail_coef * softplus(D(s, a))``, the imitation reward
-log(1 - D), before GAE, under the discriminator of the iteration's start;
open, the discriminator trains beside PPO and the rewards are the env's
(the reference's GAIL).  ``gail_coef`` is an input of each call, so the
host may anneal it.

The rollout's draws, the update's shuffles and the discriminator's
expert and policy indices come from the loop's generators, or from the
caller, which is how the tests feed both packages the same numbers.

A carry laid out by ``parallel.shard_gail_carry`` runs data parallel: the
PPO part as ``ppo_trainer.build_train_step`` runs it, the expert data
replicated, the discriminator's indices drawn globally (the policy's over
the global batch) and each of its samples counted by one rank (an expert
sample by rank ``k % W``, a policy sample by the rank that holds its env),
its loss each rank's sum over the global ``disc_batch`` and its gradients
summed over the ranks before Adam.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any

import numpy as np
import torch
from torch.nn import functional as F

from tpu_plume_torch.core import debug
from tpu_plume_torch.core.config import TrainConfig
from tpu_plume_torch.core.device import resolve_device
from tpu_plume_torch.core.support import check_ppo
from tpu_plume_torch.models.discriminator import Discriminator, bce_with_logits
from tpu_plume_torch.obsv import trace
from tpu_plume_torch.obsv.metrics import TrainLogger
from tpu_plume_torch.rl.curriculum import curriculum_update
from tpu_plume_torch.rl.gae import compute_gae
from tpu_plume_torch.rl.ppo import (
    PPOBatch,
    Share,
    normalize_advantages,
    ppo_update,
)
from tpu_plume_torch.rollout.rollout import (
    ChunkDraws,
    draw_chunk,
    rollout_chunk,
)
from tpu_plume_torch.train import ppo_trainer as ttrain
from tpu_plume_torch.train.hostsync import drain_window

CURVE_HEADER = ("iteration,episodes,successes,success_rate,mean_reward,"
                "disc_loss,disc_acc,radius,gail_coef\n")


@dataclasses.dataclass
class GAILCarry:
    ppo: ttrain.LoopCarry
    disc: Discriminator
    disc_optimizer: torch.optim.Optimizer


@dataclasses.dataclass
class GAILResult:
    state_dict: dict
    disc_state_dict: dict
    episodes: int
    successes: int
    out_dir: str


def make_disc_state(cfg: TrainConfig, device, seed: int, lr: float = 1e-3):
    """(discriminator, Adam at ``lr``); the init is drawn on the CPU from
    ``seed``."""
    disc = Discriminator(cfg.env.obs_dim, cfg.env.num_actions)
    disc.reset_parameters(torch.Generator().manual_seed(seed)).to(device)
    return disc, torch.optim.Adam(disc.parameters(), lr=lr,
                                  betas=(0.9, 0.999), eps=1e-8)


def build_gail_train_step(cfg: TrainConfig, expert_states: torch.Tensor,
                          expert_actions: torch.Tensor, *,
                          closed_loop: bool = False, disc_batch: int = 1024):
    """One GAIL iteration ``train_step(carry, gail_coef, draws=None,
    shuffles=None, disc_idx=None) -> (carry, stats, traj)`` (see the module
    docstring); ``expert_states`` f32[M, obs_dim] and ``expert_actions``
    i64[M] on the loop's device.  ``draws`` (``ChunkDraws``), ``shuffles``
    (one per epoch) and ``disc_idx`` (``(expert rows, policy rows)``, each
    i64[disc_batch]) replace the iteration's randomness; the indices are
    otherwise drawn from the loop's generator after the shuffles.  Each
    call records its ``iteration`` span and the ``rollout``, ``gae``,
    ``update``, ``disc`` and ``read`` spans under it (``obsv.trace``), as
    ``ppo_trainer.build_train_step``'s do."""
    check_ppo(cfg.ppo)
    env_cfg, ppo_cfg, cur_cfg = cfg.env, cfg.ppo, cfg.curriculum
    T = cfg.rollout.unroll_length
    num_actions = env_cfg.num_actions
    expert_n = expert_states.shape[0]

    def one_hot(a):
        return F.one_hot(a, num_actions).to(torch.float32)

    def train_step(carry: GAILCarry, gail_coef: float,
                   draws: ChunkDraws | None = None, shuffles=None,
                   disc_idx=None):
        loop, disc = carry.ppo, carry.disc
        device = loop.rollout.obs.device
        rec = trace.begin(device, drawn=draws is not None)
        mesh = loop.mesh
        spread = mesh is not None and mesh.world_size > 1
        n = loop.rollout.obs.shape[0]
        if mesh is not None:
            if draws is None:
                draws = draw_chunk(loop.generator, env_cfg, T,
                                   n * mesh.world_size)
            draws = draws.envs(mesh.envs(n * mesh.world_size))
        with rec.phase("rollout", ranged=False):
            rcarry, traj, bootstrap = rollout_chunk(
                loop.model, ttrain.push_curriculum(loop), env_cfg, T,
                draws=draws)
            if debug.enabled():
                debug.check_finite("rollout", obs=traj.obs,
                                   reward=traj.reward, value=traj.value,
                                   log_prob=traj.log_prob,
                                   bootstrap=bootstrap)

        def flat(x):
            return x.reshape((-1,) + x.shape[2:])

        obs_flat, act_flat = flat(traj.obs), flat(traj.action)
        act_oh = one_hot(act_flat)
        with rec.phase("gae"):
            rewards = traj.reward
            if closed_loop:
                with torch.no_grad():
                    imit = F.softplus(disc(obs_flat, act_oh))
                rewards = rewards + gail_coef * imit.reshape(rewards.shape)
            advantages, returns = compute_gae(
                rewards, traj.value, traj.done, bootstrap, ppo_cfg.gamma,
                ppo_cfg.gae_lambda)
            if debug.enabled():
                debug.check_finite("gae", advantages=advantages,
                                   returns=returns)
        with rec.phase("update", ranged=False):
            batch = PPOBatch(
                obs=obs_flat, actions=act_flat,
                old_log_probs=flat(traj.log_prob),
                advantages=normalize_advantages(flat(advantages), ppo_cfg,
                                                mesh),
                returns=flat(returns), old_values=flat(traj.value))
            loss_metrics = ppo_update(loop.model, loop.optimizer, batch,
                                      ppo_cfg, generator=loop.generator,
                                      shuffles=shuffles, mesh=mesh,
                                      num_envs=n)
            if debug.enabled():
                debug.check_finite("update", **loss_metrics,
                                   **dict(loop.model.named_parameters()))

        with rec.phase("disc"):
            # The discriminator's step: expert minibatch against policy
            # minibatch, expert labelled 1.
            if disc_idx is None:
                e_idx = torch.randint(0, expert_n, (disc_batch,),
                                      device=device, generator=loop.generator)
                p_idx = torch.randint(0, obs_flat.shape[0] * (
                    mesh.world_size if spread else 1), (disc_batch,),
                    device=device, generator=loop.generator)
            else:
                e_idx, p_idx = disc_idx
            mean = torch.mean
            if spread:
                # this rank's samples: expert k % W, the policy's by their env
                w, rank = mesh.world_size, mesh.rank
                e_idx = e_idx[torch.arange(disc_batch, device=device) % w
                              == rank]
                envs = p_idx % (n * w)
                p_idx = (p_idx // (n * w) * n + envs % n)[envs // n == rank]
                mean = Share(disc_batch, mesh).mean
            e_logit = disc(expert_states[e_idx],
                           one_hot(expert_actions[e_idx]))
            p_logit = disc(obs_flat[p_idx], act_oh[p_idx])
            d_loss = (bce_with_logits(e_logit, torch.ones_like(e_logit), mean)
                      + bce_with_logits(p_logit, torch.zeros_like(p_logit),
                                        mean))
            d_acc = 0.5 * (mean((e_logit > 0).to(torch.float32))
                           + mean((p_logit < 0).to(torch.float32)))
            carry.disc_optimizer.zero_grad(set_to_none=True)
            d_loss.backward()
            if mesh is not None:
                mesh.sum_grads(disc.parameters())
                d_loss, d_acc = mesh.sum(torch.stack([d_loss.detach(),
                                                      d_acc]))
            carry.disc_optimizer.step()
            if debug.enabled():
                debug.check_finite("discriminator", disc_loss=d_loss,
                                   **dict(disc.named_parameters()))

        new_episodes = traj.done.sum()
        new_successes = (traj.done & traj.episode.success).sum()
        mean_reward = traj.reward.mean()
        if mesh is not None:
            new_episodes, new_successes = mesh.sum(
                torch.stack([new_episodes, new_successes]))
            mean_reward = mesh.mean(traj.reward)
        with rec.read():
            new_episodes, new_successes = (int(new_episodes),
                                           int(new_successes))
        curriculum = curriculum_update(loop.curriculum, new_successes,
                                       new_episodes, cur_cfg)
        stats: dict[str, Any] = dict(loss_metrics)
        stats.update({
            "rollout/mean_reward": mean_reward,
            "rollout/episodes": new_episodes,
            "rollout/successes": new_successes,
            "curriculum/radius": float(curriculum.radius),
            "gail/disc_loss": d_loss.detach(),
            "gail/disc_acc": d_acc,
        })
        new_loop = dataclasses.replace(loop, rollout=rcarry,
                                       curriculum=curriculum)
        rec.end()
        return dataclasses.replace(carry, ppo=new_loop), stats, traj

    return train_step


def train_ppo_gail(
    cfg: TrainConfig,
    out_dir: str,
    expert_path: str,
    *,
    closed_loop: bool = False,
    gail_reward_coef: float = 0.1,
    gail_anneal_episodes: int | None = None,
    gail_anneal_radius: float | None = None,
    max_iterations: int | None = None,
    verbose: bool = True,
    sync_every: int = 8,
    device=None,
) -> GAILResult:
    """Train until ``cfg.total_episodes`` episodes (or ``max_iterations``
    iterations), writing ``curve.csv`` a row an iteration.
    ``gail_anneal_episodes=K`` decays the closed-loop weight linearly from
    ``gail_reward_coef`` to 0 over K episodes, from episode 0 or, with
    ``gail_anneal_radius=R``, from the first drained iteration whose
    curriculum radius is at most R.  As in JAX, the weight of an iteration
    reads the episodes of the windows drained before it (``sync_every``
    iterations a window, so up to that many iterations of lag).
    ``device`` defaults to ``cuda``; ``"cpu"`` runs on the CPU.  Writes
    ``checkpoint.pt`` (``model``, ``disc_model``, ``curriculum``,
    ``config``: ``eval --ckpt`` loads it), ``model/ppo_gail.pth`` and
    ``model/discriminator.pth`` in the reference layouts, and every
    ``ppo_trainer.LOG_EVERY`` iterations a row of ``train_log.csv``: the
    curve's numbers and the iteration's spans (``obsv.trace.scalars``, as
    ``train_ppo`` logs them, with the discriminator's ``time/disc_*``).
    The feedforward policy over an analytic plume only: like JAX's, the
    trainer passes no bank."""
    from tpu_plume_torch.data.expert import load_expert_data

    if cfg.ppo.arch != "mlp":
        raise ValueError(
            "GAIL training supports the mlp policy only (the reference's "
            "GAIL is V1.1/MLP, train_ppo_gail.py:34); train the lstm arch "
            "with plain PPO"
        )
    if cfg.env.plume_model == "gridded":
        raise ValueError(
            'GAIL training takes no field bank (as in JAX, train_ppo_gail '
            'passes none): plume_model="gridded" is not supported; train '
            'it with plain PPO')
    if gail_anneal_radius is not None and not gail_anneal_episodes:
        raise ValueError(
            "--gail-anneal-radius only arms the decay trigger; without "
            "--gail-anneal (gail_anneal_episodes) no decay ever happens — "
            "pass both or neither"
        )
    device = resolve_device(device)
    os.makedirs(out_dir, exist_ok=True)
    e_states, e_actions = load_expert_data(expert_path)
    loop = ttrain.init_loop(cfg, device)
    disc, disc_opt = make_disc_state(cfg, device, cfg.seed + 1)
    carry = GAILCarry(ppo=loop, disc=disc, disc_optimizer=disc_opt)
    train_step = build_gail_train_step(
        cfg, torch.from_numpy(e_states).to(device),
        torch.from_numpy(e_actions).to(device), closed_loop=closed_loop)

    curve_path = os.path.join(out_dir, "curve.csv")
    with open(curve_path, "w") as f:
        f.write(CURVE_HEADER)
    anneal_start = 0 if gail_anneal_radius is None else None
    episodes = successes = iteration = 0
    pending: list = []
    train_logger = TrainLogger(out_dir)

    def consume():
        nonlocal episodes, successes, anneal_start
        # the window's stats in one transfer
        host = drain_window([{k: st[k] for k in (
            "rollout/mean_reward", "gail/disc_loss", "gail/disc_acc")}
            for _, st, _, _ in pending])
        with open(curve_path, "a") as f:
            for (it, stats, coef, spans), h in zip(pending, host):
                reward, d_loss, d_acc = (float(h[k]) for k in (
                    "rollout/mean_reward", "gail/disc_loss",
                    "gail/disc_acc"))
                it_eps = stats["rollout/episodes"]
                it_succ = stats["rollout/successes"]
                radius = stats["curriculum/radius"]
                episodes += it_eps
                successes += it_succ
                if anneal_start is None and radius <= gail_anneal_radius:
                    anneal_start = episodes
                f.write(f"{it},{episodes},{successes},"
                        f"{it_succ / max(it_eps, 1):.4f},{reward:.4f},"
                        f"{d_loss:.4f},{d_acc:.4f},{radius:.2f},"
                        f"{coef:.5f}\n")
                if it % ttrain.LOG_EVERY == 0:
                    scalars = {"rollout/mean_reward": reward,
                               "gail/disc_loss": d_loss,
                               "gail/disc_acc": d_acc,
                               "curriculum/radius": radius,
                               "gail/coef": coef,
                               "progress/episodes": episodes,
                               "progress/successes": successes}
                    if spans is not None:
                        scalars.update(trace.scalars(spans, pending[-1][3]))
                    train_logger.log(it, scalars)
                if verbose and it % 10 == 0:
                    print(f"iter {it:4d} | eps {episodes:6d} | "
                          f"succ {successes / max(episodes, 1):5.1%} | "
                          f"disc_loss {d_loss:.3f} | disc_acc {d_acc:.2f}",
                          flush=True)
        pending.clear()

    while episodes < cfg.total_episodes:
        if max_iterations is not None and iteration >= max_iterations:
            break
        coef = gail_reward_coef
        if gail_anneal_episodes and anneal_start is not None:
            coef *= max(0.0, 1.0 - (episodes - anneal_start)
                        / gail_anneal_episodes)
        begun = trace.count()
        carry, stats, _ = train_step(carry, float(np.float32(coef)))
        spans = trace.latest() if trace.count() > begun else None
        iteration += 1
        pending.append((iteration, stats, coef, spans))
        if len(pending) >= max(sync_every, 1):
            consume()
    if pending:
        consume()
    train_logger.close()

    state_dict = ttrain.cpu_state_dict(carry.ppo.model)
    disc_state_dict = ttrain.cpu_state_dict(carry.disc)
    ttrain.save_checkpoint(
        out_dir, cfg, state_dict, disc_model=disc_state_dict,
        curriculum=ttrain.curriculum_dict(carry.ppo.curriculum))
    model_dir = os.path.join(out_dir, "model")
    os.makedirs(model_dir, exist_ok=True)
    torch.save(state_dict, os.path.join(model_dir, "ppo_gail.pth"))
    torch.save(disc_state_dict, os.path.join(model_dir, "discriminator.pth"))
    return GAILResult(state_dict=state_dict, disc_state_dict=disc_state_dict,
                      episodes=episodes, successes=successes, out_dir=out_dir)
