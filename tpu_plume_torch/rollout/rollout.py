"""Rollout of the policy and the env over N envs for T steps (port of
``tpu_plume/rollout/rollout.py``, the feedforward or the recurrent policy,
analytic plume or a gridded ``FieldBank`` passed as ``bank``).

Per step: one policy forward over all envs (with the recurrent policy,
``step`` from the carry's ``hidden``, which is zeroed after the env step
where the episode ended), then the env step
(``env_step_plain``): a Gumbel-max action sample, ``step_noise``, the
episode totals and records, and the auto-reset of finished envs.  On the
card over the analytic plume the env step is one launch of the env-step
kernel (``tpu_plume_torch.ops.plume.EnvStepper``), and over a bank read
between cells one launch of the bank step kernel (``plume.BankStepper``),
whose plain version ``env_step_plain`` is.  The chunk's randomness (turbulence normals, Gumbel
noise, reset uniforms and seeds, and the reset wind uniforms of a field
with a wind) is drawn up front in one ``ChunkDraws``; a
caller may pass its own draws instead, which is how the tests feed both
packages the same numbers.  Each step writes its row of [T, N] buffers
(``empty_trajectory``).  Per-episode totals are carried per env and
emitted as masked ``EpisodeRecord`` rows at done steps for the host drain.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from tpu_plume_torch.core.config import EnvConfig
from tpu_plume_torch.core.support import check_env
from tpu_plume_torch.core.tree import tree_map
from tpu_plume_torch.env.methane import (
    EnvState,
    auto_reset_from_draws,
    reset_from_draws,
    select,
    step_noise,
)
from tpu_plume_torch.obsv import trace
from tpu_plume_torch.ops import plume
from tpu_plume_torch.stop.controllers import broadcast


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
    # bool[N]: the executed action was the guide's, not the policy's
    # sampled one (the PPO update masks these steps out of the policy
    # surrogate); None unless the rollout runs a guide.
    override: torch.Tensor | None = None
    # i64[N]: the teacher's action on the pre-step state (distilled PPO);
    # None unless the rollout runs an oracle.
    oracle_action: torch.Tensor | None = None


@dataclass
class ChunkDraws:
    """The randomness of one chunk of T steps over N envs."""

    turb_noise: torch.Tensor     # f32[T, N, pos_dim] displacement normals
    gumbel: torch.Tensor | None  # f32[T, N, A] Gumbel noise; None = greedy
    u_src: torch.Tensor          # f32[T, N, 2] reset source uniforms
    bits: torch.Tensor           # i32[T, N] reset field seeds
    # f32[T, N, 2] reset wind uniforms (speed, direction) of a field with a
    # wind (``plume.reads_wind``); None for the others
    u_wind: torch.Tensor | None = None

    def envs(self, index) -> "ChunkDraws":
        """The draws of the envs ``index`` (a slice or an index tensor),
        contiguous; an absent draw stays None."""
        return tree_map(lambda x: x[:, index].contiguous(), self)


@dataclass
class RolloutCarry:
    env_state: EnvState          # batched [N, ...]
    obs: torch.Tensor            # f32[N, obs_dim]
    accum: EpisodeAccum
    generator: torch.Generator   # on the rollout's device
    # The recurrent policy's (c, h), each f32[N, H], zeroed at episode
    # boundaries; None for the feedforward policy.
    hidden: tuple | None = None
    # The terminal guide's state of every env (``guidance.make_guide``),
    # back to its initial state where an episode ended; None unguided.
    guide_state: object | None = None


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
    """The chunk's draws from ``generator``, in the order turbulence,
    Gumbel noise, source uniforms, seeds and, last and only for a field
    with a wind, the wind uniforms, so that every other field's stream is
    what it was before fields had winds."""
    dev = generator.device
    t, n = length, num_envs
    draws = ChunkDraws(
        turb_noise=torch.randn(t, n, cfg.pos_dim, device=dev,
                               generator=generator),
        gumbel=None if greedy else gumbel_noise((t, n, cfg.num_actions),
                                                generator),
        u_src=torch.rand(t, n, 2, device=dev, generator=generator),
        bits=random_bits((t, n), generator),
    )
    if plume.reads_wind(cfg):
        draws.u_wind = torch.rand(t, n, 2, device=dev, generator=generator)
    return draws


def init_rollout(cfg: EnvConfig, num_envs: int, generator: torch.Generator,
                 radius: float | None = None,
                 explore_bonus: float | None = None,
                 bank=None, hidden: tuple | None = None,
                 guide=None) -> RolloutCarry:
    """Fresh episodes in every env, on the generator's device; ``hidden``
    is the recurrent policy's initial carry (None for the feedforward
    policy); with a ``guide`` (``(init_state, step_fn)``) every env starts
    from its initial state."""
    dev = generator.device
    u_src = torch.rand(num_envs, 2, device=dev, generator=generator)
    bits = random_bits((num_envs,), generator)
    u_wind = (torch.rand(num_envs, 2, device=dev, generator=generator)
              if plume.reads_wind(cfg) else None)
    env_state, obs = reset_from_draws(u_src, u_wind, bits, cfg, radius,
                                      explore_bonus, bank)
    guide_state = (None if guide is None
                   else broadcast(guide[0], num_envs, dev))
    return RolloutCarry(env_state=env_state, obs=obs,
                        accum=EpisodeAccum.zeros(num_envs, dev),
                        generator=generator, hidden=hidden,
                        guide_state=guide_state)


def empty_trajectory(length: int, num_envs: int, cfg: EnvConfig, device,
                     guided: bool = False, labelled: bool = False):
    """The buffers of a chunk of ``length`` steps over ``num_envs`` envs:
    ``(traj, obs_rows)``, ``traj`` a ``RolloutStep`` of [T, N, ...] tensors
    and ``obs_rows`` f32[T + 1, N, obs_dim], whose row ``t`` is the obs the
    policy acts on at step ``t`` and whose last row is the chunk's final
    obs.  ``traj.obs`` is ``obs_rows[:T]``; the record's ``done`` is
    ``traj.done`` and its ``final_x`` / ``final_y`` are views of
    ``traj.pos``, since they hold the same values.  ``guided`` adds the
    ``override`` rows, ``labelled`` the ``oracle_action`` rows."""
    t, n = length, num_envs

    def f32(*shape):
        return torch.empty((t, n) + shape, dtype=torch.float32, device=device)

    obs_rows = torch.empty(t + 1, n, cfg.obs_dim, dtype=torch.float32,
                           device=device)
    done = torch.empty(t, n, dtype=torch.bool, device=device)
    pos = f32(cfg.pos_dim)
    episode = EpisodeRecord(
        done=done,
        success=torch.empty(t, n, dtype=torch.bool, device=device),
        total_reward=f32(),
        steps=torch.empty(t, n, dtype=torch.int32, device=device),
        conc_reward=f32(), explore_reward=f32(), move_penalty=f32(),
        tke_penalty=f32(), boundary_penalty=f32(), final_conc=f32(),
        final_x=pos[..., 0], final_y=pos[..., 1], source_x=f32(),
        source_y=f32(), radius=f32(), distance=f32())
    traj = RolloutStep(
        obs=obs_rows[:t],
        action=torch.empty(t, n, dtype=torch.int64, device=device),
        log_prob=f32(), value=f32(), reward=f32(), done=done, pos=pos,
        conc=f32(), episode=episode,
        override=(torch.empty(t, n, dtype=torch.bool, device=device)
                  if guided else None),
        oracle_action=(torch.empty(t, n, dtype=torch.int64, device=device)
                       if labelled else None))
    return traj, obs_rows


def _totals(obj) -> list:
    """The six episode totals of an ``EpisodeAccum`` or ``EpisodeRecord``,
    in ``EpisodeAccum``'s order."""
    return [getattr(obj, f.name) for f in dataclasses.fields(EpisodeAccum)]


def _write_rows(rows) -> None:
    """Copy each ``x`` of ``rows``, a list of ``(row of a buffer, x)``, into
    its row: one multi-tensor copy per dtype of the contiguous ``x`` (on
    the card, one launch each), one copy each for the strided ones."""
    groups: dict = {}
    for row, x in rows:
        dst, src = groups.setdefault((x.dtype, x.is_contiguous()), ([], []))
        dst.append(row)
        src.append(x)
    for dst, src in groups.values():
        torch._foreach_copy_(dst, src)


def env_step_plain(logits: torch.Tensor, value: torch.Tensor,
                   draws: ChunkDraws, t: int, state: EnvState,
                   accum: EpisodeAccum, traj: RolloutStep,
                   obs_rows: torch.Tensor, cfg: EnvConfig, bank=None,
                   exec_action: torch.Tensor | None = None):
    """Step ``t`` of a chunk after the policy's forward, for every env: the
    env-step kernel's function (``tpu_plume_torch.ops.plume.EnvStepper``),
    and over a bank the bank step kernel's (``plume.BankStepper``), in plain
    PyTorch; the rollout's step on the CPU and over a bank read at the cell.

    Samples the actions from ``logits`` f32[N, A] (Gumbel-max with the row
    ``draws.gumbel[t]``, argmax where ``draws.gumbel`` is None), steps the
    envs with the turbulence normals ``draws.turb_noise[t]``, adds the
    episode totals, records row ``t`` of ``traj`` (``value`` f32[N] too),
    clears the totals of the envs that finished and swaps fresh episodes
    from ``draws.u_src[t]``, ``draws.u_wind[t]`` and ``draws.bits[t]`` into
    them.  Writes the
    next obs into ``obs_rows[t + 1]`` and returns ``(state', obs',
    accum')``; ``state`` and ``accum`` are not modified.

    ``exec_action`` i64[N] (a guide's output) is the action the envs
    execute in place of the sampled one, which ``traj.action`` and
    ``traj.log_prob`` still record; ``traj.override`` row ``t`` then marks
    where the two differ (all False without it)."""
    if draws.gumbel is None:
        action = torch.argmax(logits, dim=-1)
    else:
        action = torch.argmax(logits + draws.gumbel[t], dim=-1)
    log_prob = torch.log_softmax(logits, dim=-1).gather(
        -1, action[:, None]).squeeze(-1)
    executed = action if exec_action is None else exec_action

    state, trans = step_noise(state, executed, draws.turb_noise[t], cfg,
                              bank)
    info = trans.info
    terms = (trans.reward, info.concentration_reward, info.explore_reward,
             info.move_penalty, info.tke_penalty, info.boundary_penalty)
    acc = EpisodeAccum(*torch._foreach_add(_totals(accum), terms))
    # Reference: final conc recorded only on success.
    success = info.reached
    ep = traj.episode
    rows = [
        (traj.action, action), (traj.log_prob, log_prob),
        (traj.value, value), (traj.reward, trans.reward),
        (traj.done, trans.done), (traj.pos, state.pos),
        (traj.conc, info.conc_raw), (ep.success, success),
        (ep.steps, state.t),
        (ep.final_conc, torch.where(success, info.conc_raw,
                                    torch.zeros_like(info.conc_raw))),
        (ep.source_x, state.field.source[:, 0]),
        (ep.source_y, state.field.source[:, 1]), (ep.radius, state.radius),
        (ep.distance, info.distance),
    ] + list(zip(_totals(ep), _totals(acc)))
    if traj.override is not None:
        rows.append((traj.override, executed != action))
    rows = [(buf[t], x) for buf, x in rows]

    # Clear the totals of envs that finished, then auto-reset them.
    keep = 1.0 - trans.done.to(torch.float32)
    acc = EpisodeAccum(*torch._foreach_mul(_totals(acc), [keep] * 6))
    u_wind = None if draws.u_wind is None else draws.u_wind[t]
    state, obs = auto_reset_from_draws(state, trans.obs, trans.done,
                                       draws.u_src[t], u_wind, draws.bits[t],
                                       cfg, bank)
    _write_rows(rows + [(obs_rows[t + 1], obs)])
    return state, obs_rows[t + 1], acc


@torch.no_grad()
def rollout_chunk(model: torch.nn.Module, carry: RolloutCarry, cfg: EnvConfig,
                  length: int, greedy: bool = False,
                  draws: ChunkDraws | None = None, bank=None, guide=None,
                  oracle=None):
    """Run ``length`` policy+env steps for all envs.

    Returns ``(carry', traj: RolloutStep[T, N, ...], bootstrap_value f32[N])``
    where ``bootstrap_value`` is V(obs_T) for GAE.  ``greedy`` takes argmax
    actions.  ``draws`` replaces the chunk's randomness, which is otherwise
    drawn from ``carry.generator``.

    Each step is one policy forward, then, on the card, one launch of the
    env-step kernel (``ops.plume.EnvStepper``) with the analytic plume or of
    the bank step kernel (``ops.plume.BankStepper``) over a bank read
    between cells (``subcell_sampling``), which updates a copy of the
    carry's state made once per chunk; on the CPU, and over a bank read at
    the cell, ``env_step_plain``.  The carry passed in is not modified.

    With ``carry.hidden`` set, ``model`` is the recurrent policy: each step
    is ``model.step(hidden, obs)``, and after the env step ``hidden`` is
    zeroed where that step's ``done`` is set (read from ``traj.done``,
    which the env step has just written).  The bootstrap value comes from
    ``model.step`` on the final carry, which it does not advance.

    ``guide`` (``(init_state, step_fn)``, the eval's terminal-guidance
    hook) runs in the rollout with its state in ``carry.guide_state``:
    each step samples the policy's action in PyTorch (argmax of logits +
    Gumbel row), gives it to the guide with the pre-step positions and
    concentrations, and the env executes the guide's action
    (``exec_action`` of the env step; on the card still one launch).  ``traj.action`` and ``traj.log_prob`` stay the policy's,
    ``traj.override`` marks the steps the guide changed, and the guide's
    state returns to its initial state where the step ended an episode.

    ``oracle`` (``evaluation.oracle.make_oracle``, ``fn(env_state) ->
    i64[N]``) labels every pre-step state into ``traj.oracle_action``, the
    teacher of distilled PPO; it runs before the env step, so on the card
    it reads the state before the step kernel updates it in place (stream
    order, no host read).

    Under ``torch.profiler`` each step's policy forward and env step are
    the ranges ``rollout.policy`` and ``rollout.env_step``
    (``obsv.trace.leaf``)."""
    num_envs = carry.obs.shape[0]
    if draws is None:
        draws = draw_chunk(carry.generator, cfg, length, num_envs, greedy)
    elif greedy:
        draws = dataclasses.replace(draws, gumbel=None)
    traj, obs_rows = empty_trajectory(length, num_envs, cfg,
                                      carry.obs.device,
                                      guided=guide is not None,
                                      labelled=oracle is not None)
    obs_rows[0] = carry.obs
    inputs = obs_rows.unbind(0)
    hidden = carry.hidden
    guide_state = carry.guide_state
    if guide is not None:
        if guide_state is None:
            raise ValueError("a guided rollout needs carry.guide_state "
                             "(init_rollout(guide=))")
        guide_fn = guide[1]
        guide_init = broadcast(guide[0], num_envs, carry.obs.device)

    def policy(t):
        nonlocal hidden
        if hidden is None:
            return model(inputs[t])
        hidden, logits, value = model.step(hidden, inputs[t])
        return logits, value

    def reset_hidden(t):
        nonlocal hidden
        if hidden is not None:
            done = traj.done[t][:, None]
            hidden = tuple(torch.where(done, 0.0, x) for x in hidden)

    def guided(t, state, logits):
        # the guide's action given the policy's sampled one
        nonlocal guide_state
        if guide is None:
            return None
        if draws.gumbel is None:
            action = torch.argmax(logits, dim=-1)
        else:
            action = torch.argmax(logits + draws.gumbel[t], dim=-1)
        guide_state, executed, _ = guide_fn(guide_state, state.pos,
                                            state.conc, action)
        return executed

    def label(t, state):
        if oracle is not None:
            traj.oracle_action[t] = oracle(state)

    def reset_guide(t):
        nonlocal guide_state
        if guide is not None:
            guide_state = select(traj.done[t], guide_init, guide_state)

    if carry.obs.is_cuda and (cfg.plume_model != "gridded"
                              or cfg.subcell_sampling):
        check_env(cfg)
        env_state, acc = own_copy(carry.env_state), own_copy(carry.accum)
        if cfg.plume_model == "gridded":
            stepper = plume.BankStepper(env_state, acc, draws, traj,
                                        obs_rows, cfg, bank)
        else:
            stepper = plume.EnvStepper(env_state, acc, draws, traj,
                                       obs_rows, cfg)
        for t in range(length):
            with trace.leaf("rollout.policy"):
                logits, value = policy(t)
            with trace.leaf("rollout.env_step"):
                label(t, env_state)
                stepper(t, logits, value, guided(t, env_state, logits))
                reset_hidden(t)
                reset_guide(t)
    else:
        env_state, acc = carry.env_state, carry.accum
        for t in range(length):
            with trace.leaf("rollout.policy"):
                logits, value = policy(t)
            with trace.leaf("rollout.env_step"):
                label(t, env_state)
                executed = guided(t, env_state, logits)
                env_state, _, acc = env_step_plain(
                    logits, value, draws, t, env_state, acc, traj, obs_rows,
                    cfg, bank, exec_action=executed)
                reset_hidden(t)
                reset_guide(t)

    obs = inputs[length]
    if hidden is None:
        _, bootstrap_value = model(obs)
    else:
        _, _, bootstrap_value = model.step(hidden, obs)
    carry = RolloutCarry(env_state=env_state, obs=obs, accum=acc,
                         generator=carry.generator, hidden=hidden,
                         guide_state=guide_state)
    return carry, traj, bootstrap_value


def own_copy(obj):
    """A contiguous copy of every tensor of a (nested) dataclass, for the
    env-step kernel to update in place; None stays None."""
    return tree_map(lambda x: x.clone(memory_format=torch.contiguous_format),
                    obj)
