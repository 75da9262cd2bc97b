"""Rollout of the policy and the env over N envs for T steps (port of
``tpu_plume/rollout/rollout.py``, feedforward policy, analytic plume or a
gridded ``FieldBank`` passed as ``bank``).

Per step: one policy forward over all envs, a Gumbel-max action sample,
``step_noise`` and the auto-reset of finished envs.  The chunk's randomness
(turbulence normals, Gumbel noise, reset uniforms and seeds) is drawn up
front in one ``ChunkDraws``; a caller may pass its own draws instead, which
is how the tests feed both packages the same numbers.  Per-episode totals
are carried per env and emitted as masked ``EpisodeRecord`` rows at done
steps for the host drain.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from tpu_plume_torch.core.config import EnvConfig
from tpu_plume_torch.env.methane import (
    EnvState,
    auto_reset_from_draws,
    reset_from_draws,
    step_noise,
)


@dataclass
class EpisodeAccum:
    """Running per-env episode totals, each f32[N]."""

    total_reward: torch.Tensor
    conc_reward: torch.Tensor
    explore_reward: torch.Tensor
    move_penalty: torch.Tensor
    tke_penalty: torch.Tensor
    boundary_penalty: torch.Tensor

    @classmethod
    def zeros(cls, n: int, device) -> "EpisodeAccum":
        return cls(*(torch.zeros(n, dtype=torch.float32, device=device)
                     for _ in range(6)))


@dataclass
class EpisodeRecord:
    """Completed-episode rows, valid where ``done``; [T, N] after stacking.
    The columns of the reference's per-episode CSV plus the final and
    source positions."""

    done: torch.Tensor
    success: torch.Tensor
    total_reward: torch.Tensor
    steps: torch.Tensor
    conc_reward: torch.Tensor
    explore_reward: torch.Tensor
    move_penalty: torch.Tensor
    tke_penalty: torch.Tensor
    boundary_penalty: torch.Tensor
    final_conc: torch.Tensor     # conc at the final cell (0 unless success)
    final_x: torch.Tensor
    final_y: torch.Tensor
    source_x: torch.Tensor
    source_y: torch.Tensor
    radius: torch.Tensor
    distance: torch.Tensor       # final distance to source


@dataclass
class RolloutStep:
    """Per-step outputs, stacked to [T, N, ...]."""

    obs: torch.Tensor            # f32[N, obs_dim] obs the policy acted on
    action: torch.Tensor         # i64[N]
    log_prob: torch.Tensor       # f32[N]
    value: torch.Tensor          # f32[N]
    reward: torch.Tensor         # f32[N]
    done: torch.Tensor           # bool[N]
    pos: torch.Tensor            # f32[N, pos_dim] post-step position
    conc: torch.Tensor           # f32[N] raw conc at the new cell
    episode: EpisodeRecord


@dataclass
class ChunkDraws:
    """The randomness of one chunk of T steps over N envs."""

    turb_noise: torch.Tensor     # f32[T, N, pos_dim] displacement normals
    gumbel: torch.Tensor | None  # f32[T, N, A] Gumbel noise; None = greedy
    u_src: torch.Tensor          # f32[T, N, 2] reset source uniforms
    bits: torch.Tensor           # i32[T, N] reset field seeds


@dataclass
class RolloutCarry:
    env_state: EnvState          # batched [N, ...]
    obs: torch.Tensor            # f32[N, obs_dim]
    accum: EpisodeAccum
    generator: torch.Generator   # on the rollout's device


def random_bits(shape, generator: torch.Generator) -> torch.Tensor:
    """Uniform 32-bit patterns as int32 (how the env stores field seeds)."""
    return torch.randint(-(2**31), 2**31, shape, dtype=torch.int32,
                         device=generator.device, generator=generator)


def gumbel_noise(shape, generator: torch.Generator) -> torch.Tensor:
    tiny = torch.finfo(torch.float32).tiny
    u = torch.rand(shape, device=generator.device, generator=generator)
    return -torch.log(-torch.log(torch.clamp(u, min=tiny)))


def draw_chunk(generator: torch.Generator, cfg: EnvConfig, length: int,
               num_envs: int, greedy: bool = False) -> ChunkDraws:
    dev = generator.device
    t, n = length, num_envs
    return ChunkDraws(
        turb_noise=torch.randn(t, n, cfg.pos_dim, device=dev,
                               generator=generator),
        gumbel=None if greedy else gumbel_noise((t, n, cfg.num_actions),
                                                generator),
        u_src=torch.rand(t, n, 2, device=dev, generator=generator),
        bits=random_bits((t, n), generator),
    )


def init_rollout(cfg: EnvConfig, num_envs: int, generator: torch.Generator,
                 radius: float | None = None,
                 explore_bonus: float | None = None,
                 bank=None) -> RolloutCarry:
    """Fresh episodes in every env, on the generator's device."""
    dev = generator.device
    u_src = torch.rand(num_envs, 2, device=dev, generator=generator)
    env_state, obs = reset_from_draws(
        u_src, random_bits((num_envs,), generator), cfg, radius, explore_bonus,
        bank)
    return RolloutCarry(env_state=env_state, obs=obs,
                        accum=EpisodeAccum.zeros(num_envs, dev),
                        generator=generator)


def _stack(items):
    first = items[0]
    if dataclasses.is_dataclass(first):
        return type(first)(**{f.name: _stack([getattr(x, f.name) for x in items])
                              for f in dataclasses.fields(first)})
    return torch.stack(items)


@torch.no_grad()
def rollout_chunk(model: torch.nn.Module, carry: RolloutCarry, cfg: EnvConfig,
                  length: int, greedy: bool = False,
                  draws: ChunkDraws | None = None, bank=None):
    """Run ``length`` policy+env steps for all envs.

    Returns ``(carry', traj: RolloutStep[T, N, ...], bootstrap_value f32[N])``
    where ``bootstrap_value`` is V(obs_T) for GAE.  ``greedy`` takes argmax
    actions.  ``draws`` replaces the chunk's randomness, which is otherwise
    drawn from ``carry.generator``."""
    num_envs = carry.obs.shape[0]
    if draws is None:
        draws = draw_chunk(carry.generator, cfg, length, num_envs, greedy)
    env_state, obs, acc = carry.env_state, carry.obs, carry.accum
    steps = []
    for t in range(length):
        logits, value = model(obs)
        if greedy:
            action = torch.argmax(logits, dim=-1)
        else:
            action = torch.argmax(logits + draws.gumbel[t], dim=-1)
        log_prob = torch.log_softmax(logits, dim=-1).gather(
            -1, action[:, None]).squeeze(-1)

        env_state, trans = step_noise(env_state, action, draws.turb_noise[t],
                                      cfg, bank)
        info = trans.info
        acc = EpisodeAccum(
            total_reward=acc.total_reward + trans.reward,
            conc_reward=acc.conc_reward + info.concentration_reward,
            explore_reward=acc.explore_reward + info.explore_reward,
            move_penalty=acc.move_penalty + info.move_penalty,
            tke_penalty=acc.tke_penalty + info.tke_penalty,
            boundary_penalty=acc.boundary_penalty + info.boundary_penalty,
        )
        # Reference: final conc recorded only on success.
        success = info.reached
        record = EpisodeRecord(
            done=trans.done,
            success=success,
            total_reward=acc.total_reward,
            steps=env_state.t,
            conc_reward=acc.conc_reward,
            explore_reward=acc.explore_reward,
            move_penalty=acc.move_penalty,
            tke_penalty=acc.tke_penalty,
            boundary_penalty=acc.boundary_penalty,
            final_conc=torch.where(success, info.conc_raw,
                                   torch.zeros_like(info.conc_raw)),
            final_x=env_state.pos[:, 0],
            final_y=env_state.pos[:, 1],
            source_x=env_state.field.source[:, 0],
            source_y=env_state.field.source[:, 1],
            radius=env_state.radius,
            distance=info.distance,
        )
        steps.append(RolloutStep(
            obs=obs, action=action, log_prob=log_prob, value=value,
            reward=trans.reward, done=trans.done, pos=env_state.pos,
            conc=info.conc_raw, episode=record,
        ))

        # Clear the totals of envs that finished, then auto-reset them.
        keep = 1.0 - trans.done.to(torch.float32)
        acc = EpisodeAccum(*(getattr(acc, f.name) * keep
                             for f in dataclasses.fields(acc)))
        env_state, obs = auto_reset_from_draws(
            env_state, trans.obs, trans.done, draws.u_src[t], draws.bits[t],
            cfg, bank)

    _, bootstrap_value = model(obs)
    carry = RolloutCarry(env_state=env_state, obs=obs, accum=acc,
                         generator=carry.generator)
    return carry, _stack(steps), bootstrap_value
