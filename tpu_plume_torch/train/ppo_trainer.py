"""End-to-end PPO training (port of ``tpu_plume/train/ppo_trainer.py``,
the feedforward or the recurrent policy, ``cfg.ppo.arch`` "mlp" or "lstm",
on the analytic plume or a gridded ``FieldBank``).

One train step runs

    rollout (policy + env over N envs for T steps)
      -> GAE (reverse loop over T)
      -> PPO update (epochs x minibatches, clip + Adam)
      -> curriculum transition (host scalars)

on the step's device, or under a data-parallel mesh on each rank's share of
the envs (``tpu_plume_torch.parallel``; the carry holds the mesh).  The
host loop ``train_ppo`` keeps each iteration's stats and episode records
on the device and drains a window of ``sync_every`` iterations to the host
in one transfer (``train/hostsync.py``): the reference's CSV, per-iteration
scalars (and TensorBoard's), and a ``torch.save`` bundle from which a run
resumes bit for bit (``--snapshot-every``, ``--resume``), plus, for the
2-layer feedforward policy, the reference-layout ``.pth`` at the end.  With
a capture on (``capture_netcdf``, ``capture_conc_csv``) the drain also
reassembles each finished episode's trajectory (``EpisodeCapture``) into
``training_data.nc`` and ``data.csv``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from tpu_plume_torch.core import debug
from tpu_plume_torch.core.config import TrainConfig
from tpu_plume_torch.core.device import resolve_device
from tpu_plume_torch.core.support import check_env, check_ppo
from tpu_plume_torch.core.tree import flatten, tree_map
from tpu_plume_torch.data.conc_csv import save_conc_rows
from tpu_plume_torch.data.netcdf import EpisodeArrays, NetCDFWriter
from tpu_plume_torch.models.actor_critic import ActorCritic
from tpu_plume_torch.models.recurrent import RecurrentActorCritic
from tpu_plume_torch.obsv import trace
from tpu_plume_torch.obsv.metrics import EpisodeCSVLogger, TrainLogger
from tpu_plume_torch.ops import gather
from tpu_plume_torch.rl.curriculum import (
    CurriculumState,
    curriculum_init,
    curriculum_update,
)
from tpu_plume_torch.rl.gae import compute_gae
from tpu_plume_torch.rl.ppo import (
    PPOBatch,
    RecurrentPPOBatch,
    Share,
    normalize_advantages,
    ppo_loss,
    ppo_loss_recurrent,
    ppo_update,
    ppo_update_recurrent,
)
from tpu_plume_torch.rollout.rollout import (
    ChunkDraws,
    RolloutCarry,
    draw_chunk,
    init_rollout,
    rollout_chunk,
)
from tpu_plume_torch.train.hostsync import drain_window, drain_window_rows

# Iterations between lines of train_log.csv and progress prints.
LOG_EVERY = 10
# Episode-record fields the CSV logger consumes.
REC_KEYS = (
    "done", "success", "total_reward", "steps", "conc_reward",
    "explore_reward", "move_penalty", "tke_penalty", "boundary_penalty",
    "final_conc", "radius",
)


class ClippedAdam:
    """``optax.chain(clip_by_global_norm(max_norm), adam(lr))``.

    The clip is optax's: gradients are replaced by ``g / norm * max_norm``
    when the global norm reaches ``max_norm``.  (``clip_grad_norm_`` divides
    by ``norm + 1e-6`` instead.)  Adam is ``torch.optim.Adam`` with b1 0.9,
    b2 0.999, eps 1e-8, the optax defaults."""

    def __init__(self, params, lr: float, max_grad_norm: float):
        self.params = list(params)
        self.max_grad_norm = float(max_grad_norm)
        self.adam = torch.optim.Adam(self.params, lr=lr, betas=(0.9, 0.999),
                                     eps=1e-8)

    def zero_grad(self, set_to_none: bool = True):
        self.adam.zero_grad(set_to_none=set_to_none)

    @torch.no_grad()
    def step(self):
        grads = [p.grad for p in self.params if p.grad is not None]
        norm = torch.sqrt(sum((g * g).sum() for g in grads))
        keep = norm < self.max_grad_norm
        for g in grads:
            g.copy_(torch.where(keep, g, g / norm * self.max_grad_norm))
        self.adam.step()

    def state_dict(self):
        return self.adam.state_dict()

    def load_state_dict(self, state_dict: dict) -> None:
        self.adam.load_state_dict(state_dict)


def policy_dtypes(cfg: TrainConfig, dtype: torch.dtype | None = None):
    """(compute dtype, head dtype) of the policy: ``dtype`` defaults to
    bf16 under ``bf16_compute``, else f32; ``f32_heads`` keeps the
    feedforward policy's heads in f32 when the compute dtype is bf16 and is
    a no-op otherwise (head dtype None follows the compute dtype; the
    recurrent policy's heads always do, as in JAX)."""
    if dtype is None:
        dtype = torch.bfloat16 if cfg.ppo.bf16_compute else torch.float32
    head_dtype = (torch.float32 if cfg.ppo.f32_heads and cfg.ppo.arch == "mlp"
                  and dtype == torch.bfloat16 else None)
    return dtype, head_dtype


def make_policy_model(cfg: TrainConfig, dtype: torch.dtype | None = None):
    """The policy network of ``cfg.ppo.arch``: ``ActorCritic`` or
    ``RecurrentActorCritic``; ``dtype`` overrides the compute dtype (params
    are f32 regardless), as ``policy_dtypes`` sets it."""
    check_ppo(cfg.ppo)
    dtype, head_dtype = policy_dtypes(cfg, dtype)
    if cfg.ppo.arch == "lstm":
        return RecurrentActorCritic(
            cfg.env.obs_dim, cfg.env.num_actions, cfg.ppo.lstm_embed,
            cfg.ppo.lstm_hidden, dtype, cfg.ppo.lstm_layer_norm)
    return ActorCritic(cfg.env.obs_dim, cfg.env.num_actions,
                       cfg.ppo.hidden_sizes, dtype, head_dtype)


def make_train_state(cfg: TrainConfig, device, seed: int):
    """(model, optimizer); the init is drawn on the CPU from ``seed``, so it
    is the same on every device."""
    model = make_policy_model(cfg).reset_parameters(
        torch.Generator().manual_seed(seed)).to(device)
    opt = ClippedAdam(model.parameters(), cfg.ppo.learning_rate,
                      cfg.ppo.max_grad_norm)
    return model, opt


@dataclass
class LoopCarry:
    """Training loop state."""

    model: ActorCritic | RecurrentActorCritic
    optimizer: ClippedAdam
    rollout: RolloutCarry
    curriculum: CurriculumState
    # The draws of the rollout and the update's shuffles, on the model's
    # device: the same object as ``rollout.generator``.
    generator: torch.Generator
    # The data-parallel layout (``parallel.shard_loop_carry``); None for
    # one process.
    mesh: Any = None


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def push_curriculum(loop: LoopCarry) -> RolloutCarry:
    """The loop's rollout carry with the curriculum's current radius and
    exploration bonus in every env."""
    n, device = loop.rollout.obs.shape[0], loop.rollout.obs.device
    env_state = loop.rollout.env_state.replace(
        radius=torch.full((n,), loop.curriculum.radius, dtype=torch.float32,
                          device=device),
        explore_bonus=torch.full((n,), loop.curriculum.explore_bonus,
                                 dtype=torch.float32, device=device),
    )
    return dataclasses.replace(loop.rollout, env_state=env_state)


def build_train_step(cfg: TrainConfig, bank=None, time_phases: bool = False,
                     guide=None, with_grads: bool = False):
    """One training iteration ``train_step(loop, draws=None, shuffles=None)
    -> (loop, stats, traj)``.

    ``bank`` is the ``FieldBank`` of ``plume_model="gridded"``, on the
    loop's device; the step holds it.

    With the recurrent policy (``arch="lstm"``) the update is
    ``ppo_update_recurrent`` over the [T, N] chunk: its replay starts from
    the chunk-start carry and zeroes it after each done step.

    ``draws`` (``ChunkDraws``) and ``shuffles`` (one roll offset or index
    permutation per epoch; for the recurrent policy one env permutation per
    epoch) replace the iteration's randomness.

    Each call records its ``iteration`` span and the ``rollout``, ``gae``,
    ``update`` and ``read`` spans under it (``obsv.trace``), which never
    synchronise.  With ``time_phases`` the phase spans synchronise at
    their boundaries and ``stats`` gets their host ms, the phases' wall ms,
    as ``time/rollout_ms``, ``time/gae_ms`` and ``time/update_ms``.

    ``guide`` (``(init_state, step_fn)``, ``evaluation.guidance.make_guide``)
    runs in the rollout (``rollout_chunk(guide=)``; the loop's carry needs
    ``init_loop(guide=)``): the envs execute its actions, and the update
    masks the overridden steps out of the policy surrogate and entropy
    (``PPOBatch.weights = 1 - override``; a weighted batch takes autodiff
    under ``fused_update``, as in JAX).

    ``cfg.ppo.distill_oracle`` (distilled PPO) names a scripted teacher
    (``evaluation.oracle.make_oracle``) that labels every pre-step state of
    the rollout (``rollout_chunk(oracle=)``); the update adds the imitation
    cross-entropy (``rl.ppo._maybe_distill``), and a labelled batch takes
    autodiff under ``fused_update``, as in JAX.

    ``with_grads`` adds ``stats["grads"]``, the gradient of the whole
    batch's loss at the params after the update, by name (TensorBoard's
    ``grads/`` histograms, JAX's full-batch gradient): one more forward and
    backward pass.

    A loop laid out by ``parallel.shard_loop_carry`` carries its ``mesh``:
    every rank draws the chunk at the global [T, N] shapes and steps its
    slice of the envs (``draws`` too are the global ones), the update
    runs over the global batch (``rl.ppo``), and the episode counts and
    the mean reward are summed over the ranks.

    Under ``core.debug.debug_nans`` each phase's outputs are checked, and
    the first non-finite one raises naming its phase."""
    check_env(cfg.env)
    check_ppo(cfg.ppo)
    if cfg.env.plume_model == "gridded" and bank is None:
        raise ValueError('plume_model="gridded" requires a FieldBank')
    if cfg.env.plume_model == "gridded" and cfg.env.subcell_sampling:
        # The sample kernel's bank is validated here, once; on the card the
        # bank keeps the launch that the env's samples reuse.
        gather.check_bank(bank.conc)
        if bank.conc.is_cuda:
            bank.sampler(cfg.env)
    env_cfg, ppo_cfg, cur_cfg = cfg.env, cfg.ppo, cfg.curriculum
    T = cfg.rollout.unroll_length
    # bf16_update split: the update's loss runs a bf16 twin of the model
    # over the same f32 params; the rollout stays f32.  Ignored under
    # bf16_compute, where the whole model is already bf16.
    update_dtypes = None
    if ppo_cfg.bf16_update and not ppo_cfg.bf16_compute:
        update_dtypes = policy_dtypes(cfg, torch.bfloat16)
    oracle = None
    if ppo_cfg.distill_oracle:
        from tpu_plume_torch.evaluation.oracle import make_oracle

        oracle = make_oracle(ppo_cfg.distill_oracle, env_cfg)

    def train_step(loop: LoopCarry, draws: ChunkDraws | None = None,
                   shuffles=None):
        rec = trace.begin(loop.rollout.obs.device, synced=time_phases,
                          drawn=draws is not None)
        mesh = loop.mesh
        n = loop.rollout.obs.shape[0]
        carry = push_curriculum(loop)
        h_init = carry.hidden
        if mesh is not None:
            if draws is None:
                draws = draw_chunk(loop.generator, env_cfg, T,
                                   n * mesh.world_size)
            draws = draws.envs(mesh.envs(n * mesh.world_size))

        with rec.phase("rollout", ranged=False):
            carry, traj, bootstrap = rollout_chunk(
                loop.model, carry, env_cfg, T, draws=draws, bank=bank,
                guide=guide, oracle=oracle)
            if debug.enabled():
                debug.check_finite("rollout", obs=traj.obs,
                                   reward=traj.reward, value=traj.value,
                                   log_prob=traj.log_prob,
                                   bootstrap=bootstrap)
        with rec.phase("gae"):
            advantages, returns = compute_gae(
                traj.reward, traj.value, traj.done, bootstrap,
                ppo_cfg.gamma, ppo_cfg.gae_lambda)
            if debug.enabled():
                debug.check_finite("gae", advantages=advantages,
                                   returns=returns)

        with rec.phase("update", ranged=False):
            update_model = (loop.model if update_dtypes is None
                            else loop.model.twin(*update_dtypes))
            if h_init is not None:
                # Sequence-major: the replay needs the time axis.
                adv_n = normalize_advantages(advantages, ppo_cfg, mesh)
                ret = (adv_n + traj.value if ppo_cfg.bug_compat_returns
                       else returns)
                batch = RecurrentPPOBatch(
                    obs=traj.obs, actions=traj.action,
                    old_log_probs=traj.log_prob, advantages=adv_n, returns=ret,
                    old_values=traj.value,
                    resets=torch.cat([torch.zeros_like(traj.done[:1]),
                                      traj.done[:-1]]),
                    h_init=h_init, oracle_actions=traj.oracle_action)
                loss_metrics = ppo_update_recurrent(
                    update_model, loop.optimizer, batch, ppo_cfg,
                    generator=loop.generator, shuffles=shuffles, mesh=mesh)
            else:
                def flat(x):
                    return x.reshape((-1,) + x.shape[2:])

                adv_n = normalize_advantages(flat(advantages), ppo_cfg, mesh)
                if ppo_cfg.bug_compat_returns:
                    # Reference quirk: returns from normalized advantages.
                    ret = adv_n + flat(traj.value)
                else:
                    ret = flat(returns)
                batch = PPOBatch(
                    obs=flat(traj.obs),
                    actions=flat(traj.action),
                    old_log_probs=flat(traj.log_prob),
                    advantages=adv_n,
                    returns=ret,
                    old_values=flat(traj.value),
                    weights=(None if guide is None else
                             1.0 - flat(traj.override).to(torch.float32)),
                    oracle_actions=(None if oracle is None
                                    else flat(traj.oracle_action)),
                )
                loss_metrics = ppo_update(update_model, loop.optimizer, batch,
                                          ppo_cfg, generator=loop.generator,
                                          shuffles=shuffles, mesh=mesh,
                                          num_envs=n)
            if debug.enabled():
                debug.check_finite("update", **loss_metrics,
                                   **dict(loop.model.named_parameters()))

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
            "curriculum/explore_bonus": float(curriculum.explore_bonus),
            "curriculum/updates": curriculum.num_updates,
        })
        if with_grads:
            stats["grads"] = full_batch_grads(loop.model, batch, ppo_cfg,
                                              mesh)
        if time_phases:
            for name in trace.PHASES:
                stats[f"time/{name}_ms"] = rec.record.get(name).host_ms
        new_loop = dataclasses.replace(loop, rollout=carry,
                                       curriculum=curriculum)
        rec.end()
        return new_loop, stats, traj

    return train_step


def full_batch_grads(model, batch, cfg, mesh=None) -> dict:
    """The gradient, by parameter name, of the loss of the whole ``batch``
    (a ``PPOBatch`` or ``RecurrentPPOBatch``) at ``model``'s params; under
    a ``mesh`` of W > 1 ranks the global batch's."""
    share = None
    if mesh is not None and mesh.world_size > 1:
        share = Share(batch.actions.numel() * mesh.world_size, mesh)
    loss_fn = (ppo_loss_recurrent if isinstance(batch, RecurrentPPOBatch)
               else ppo_loss)
    loss, _ = loss_fn(model, batch, cfg, share)
    names, params = zip(*model.named_parameters())
    grads = torch.autograd.grad(loss, params)
    if mesh is not None:
        grads = [mesh.sum(g) for g in grads]
    return dict(zip(names, grads))


def init_loop(cfg: TrainConfig, device, bank=None,
              init_params: dict | None = None, guide=None) -> LoopCarry:
    """Fresh model, optimizer, envs and curriculum from ``cfg.seed``;
    ``bank`` (gridded model) on ``device``; the recurrent policy's carry
    starts at zeros, and a ``guide``'s state at its initial state.
    ``init_params``, a state_dict of the policy (for the feedforward policy
    the reference ``.pth`` layout), replaces the initial params (the
    optimizer starts fresh).  Recorded as the ``init_loop`` span
    (``obsv.trace``)."""
    with trace.init_loop():
        device = torch.device(device)
        model, optimizer = make_train_state(cfg, device, cfg.seed)
        if init_params is not None:
            model.load_state_dict(init_params)
        generator = torch.Generator(device=device).manual_seed(cfg.seed)
        hidden = (model.initial_state(cfg.rollout.num_envs, device)
                  if cfg.ppo.arch == "lstm" else None)
        rollout = init_rollout(cfg.env, cfg.rollout.num_envs, generator,
                               radius=cfg.curriculum.initial_radius,
                               explore_bonus=cfg.env.explore_bonus_init,
                               bank=bank, hidden=hidden, guide=guide)
    return LoopCarry(model=model, optimizer=optimizer, rollout=rollout,
                     curriculum=curriculum_init(cfg.curriculum,
                                                cfg.env.explore_bonus_init),
                     generator=generator)


class RadiusTracker:
    """Host-side gate: capture only successful episodes at the two smallest
    curriculum radii seen so far (reference train_ppo2.0.py:90-108)."""

    def __init__(self):
        self.radius_history: list[float] = []

    def update(self, radius: float, is_success: bool) -> bool:
        if is_success:
            if radius not in self.radius_history:
                self.radius_history.append(radius)
                self.radius_history.sort()
                if len(self.radius_history) > 2:
                    del self.radius_history[-1]
        return is_success and radius in self.radius_history


class EpisodeAssembler:
    """Reassembles per-episode (x, y, conc) trajectories from fixed-shape
    rollout chunks (host numpy)."""

    def __init__(self, num_envs: int, max_steps: int):
        self.x = np.full((num_envs, max_steps), np.nan, np.float32)
        self.y = np.full((num_envs, max_steps), np.nan, np.float32)
        self.c = np.full((num_envs, max_steps), np.nan, np.float32)
        self.n = num_envs

    def drain(self, traj_np: dict):
        """Yields dicts of completed episodes in scan order."""
        pos = np.asarray(traj_np["pos"], np.float32)      # [T, N, 2]
        conc = np.asarray(traj_np["conc"], np.float32)    # [T, N]
        done = np.asarray(traj_np["done"])                # [T, N]
        steps = np.asarray(traj_np["steps"], np.int32)    # 1-based
        rec = traj_np["episode"]
        envs = np.arange(self.n)
        for t in range(pos.shape[0]):
            idx = np.minimum(steps[t] - 1, self.x.shape[1] - 1)
            self.x[envs, idx] = pos[t, :, 0]
            self.y[envs, idx] = pos[t, :, 1]
            self.c[envs, idx] = conc[t]
            for env in np.nonzero(done[t])[0]:
                s = int(steps[t, env])
                s_clip = min(s, self.x.shape[1])
                yield {
                    "env": int(env),
                    "steps": s,
                    "x": self.x[env, :s_clip].copy(),
                    "y": self.y[env, :s_clip].copy(),
                    "conc": self.c[env, :s_clip].copy(),
                    **{k: np.asarray(v[t, env]) for k, v in rec.items()},
                }


class EpisodeCapture:
    """The trajectory capture of ``train_ppo`` (JAX's ``_drain``,
    ``tpu_plume/train/ppo_trainer.py:549-596``): each drained window's
    finished episodes, reassembled by ``EpisodeAssembler``, go

    - with ``conc_csv``, every success to ``data.csv`` (its concentration
      sequence and final concentration, the V1.2 format);
    - the successes at the two smallest radii seen (``RadiusTracker``), at
      most ``total_episodes`` of them, to ``arrays`` (``EpisodeArrays``),
      and with ``netcdf`` to ``training_data.nc`` (V2.1's sigma and peak
      for ``ppo_v2_1``).

    With ``append`` (a resumed run) an existing ``data.csv`` is kept and
    appended to; ``training_data.nc`` and the tracker restart, as in JAX."""

    def __init__(self, cfg: TrainConfig, out_dir: str, netcdf: bool,
                 conc_csv: bool, append: bool = False):
        self.limit = cfg.total_episodes
        self.sigma, self.peak = cfg.env.plume_sigma, cfg.env.conc_peak
        v21 = cfg.name == "ppo_v2_1"
        self.arrays = EpisodeArrays(cfg.env.max_steps, v21)
        self.writer = None
        if netcdf:
            self.writer = NetCDFWriter(
                os.path.join(out_dir, "training_data.nc"),
                grid_size=cfg.env.grid_size, max_episodes=cfg.total_episodes,
                max_steps=cfg.env.max_steps, with_gaussian_params=v21)
        self.conc_csv = None
        if conc_csv:
            self.conc_csv = os.path.join(out_dir, "data.csv")
            if not (append and os.path.exists(self.conc_csv)):
                open(self.conc_csv, "w").close()
        self.tracker = RadiusTracker()
        self.assembler = EpisodeAssembler(cfg.rollout.num_envs,
                                          cfg.env.max_steps)

    def drain(self, rec: dict) -> None:
        """Capture the finished episodes of one iteration's [T, N] host
        arrays (``_records``)."""
        traj_np = {"pos": rec["pos"], "conc": rec["conc"],
                   "done": rec["done"], "steps": rec["steps"],
                   "episode": {k: rec[k] for k in (
                       "success", "final_conc", "final_x", "final_y",
                       "radius")}}
        rows = []
        for ep in self.assembler.drain(traj_np):
            if self.conc_csv and bool(ep["success"]):
                rows.append((ep["conc"], float(ep["final_conc"])))
            if len(self.arrays) >= self.limit:
                continue
            if self.tracker.update(float(ep["radius"]), bool(ep["success"])):
                kw = dict(episode_idx=len(self.arrays), steps=ep["steps"],
                          x=ep["x"], y=ep["y"], conc=ep["conc"],
                          source_x=float(ep["final_x"]),
                          source_y=float(ep["final_y"]),
                          source_conc=float(ep["final_conc"]),
                          sigma=self.sigma, peak=self.peak)
                if self.writer is not None:
                    self.writer.write_episode_data(**kw)
                self.arrays.write_episode_data(**kw)
        if rows:
            save_conc_rows(self.conc_csv, *zip(*rows), append=True)

    def close(self) -> None:
        if self.writer is not None:
            self.writer.close()


def cpu_state_dict(model: torch.nn.Module) -> dict:
    return {k: v.detach().cpu() for k, v in model.state_dict().items()}


def curriculum_dict(curriculum: CurriculumState) -> dict:
    return {k: v.item() if isinstance(v, np.generic) else v
            for k, v in dataclasses.asdict(curriculum).items()}


def save_checkpoint(out_dir: str, cfg: TrainConfig, state_dict: dict,
                    **extra) -> None:
    """``out_dir/checkpoint.pt``: the policy's state_dict under ``model``,
    ``extra``'s entries, and the config under ``config``, whose ``ppo``
    the CLI's ``--ckpt`` checks against the policy it builds."""
    os.makedirs(out_dir, exist_ok=True)
    torch.save({"model": state_dict, **extra,
                "config": dataclasses.asdict(cfg)},
               os.path.join(out_dir, "checkpoint.pt"))


def cpu_tensors(tree) -> list:
    """The tensors of ``tree`` (``core.tree``) on the CPU, in its order:
    what ``torch.load(weights_only=True)`` reads back, and
    ``restore_tensors`` puts into a tree of the same layout."""
    return [x.detach().cpu() for x in flatten(tree)[0]]


def restore_tensors(template, saved: list, where: str):
    """``template`` (a freshly built carry) with the tensors ``saved``
    (its ``cpu_tensors``) in place of its own, on the template's devices.
    Another count of tensors, or a tensor of another shape or dtype,
    raises ``ValueError`` naming where."""
    leaves, rebuild = flatten(template)
    if len(saved) != len(leaves):
        raise ValueError(f"{where}: saved {len(saved)} tensors, this run's "
                         f"carry holds {len(leaves)}")
    for i, (t, x) in enumerate(zip(leaves, saved)):
        if x.shape != t.shape or x.dtype != t.dtype:
            raise ValueError(f"{where}: tensor {i} saved {x.dtype}"
                             f"{list(x.shape)}, this run's {t.dtype}"
                             f"{list(t.shape)}")
    return rebuild(iter([x.to(t.device) for t, x in zip(leaves, saved)]))


def bundle_of(loop: LoopCarry, counters: dict, bank=None) -> dict:
    """Everything a bit-exact continuation needs, besides the params
    (``save_checkpoint``'s ``model``) and the config: the optimizer's
    state, the whole rollout carry, the curriculum, the counters, the
    generator's state and the bank's shape (the bank itself is rebuilt
    from its flags and seed, as in JAX)."""
    return {"optimizer": tree_map(lambda x: x.detach().cpu(),
                                  loop.optimizer.state_dict()),
            "rollout": cpu_tensors(loop.rollout),
            "curriculum": curriculum_dict(loop.curriculum),
            "counters": dict(counters),
            "generator": loop.generator.get_state(),
            "bank_shape": None if bank is None else list(bank.conc.shape)}


# The config fields a resumed run must share with the run it resumes.
RESUME_FIELDS = (("rollout", "num_envs"), ("ppo", "arch"),
                 ("ppo", "hidden_sizes"), ("ppo", "lstm_hidden"),
                 ("env", "plume_model"))


def resume_loop(loop: LoopCarry, path: str, cfg: TrainConfig, bank=None
                ) -> tuple[LoopCarry, dict]:
    """``(loop, counters)`` of the bundle at ``path`` (a ``checkpoint.pt``
    or the directory holding one: a run's end, or a snapshot
    ``checkpoint_iterNNNNNN``) restored into the freshly built ``loop``.
    A bundle of another ``num_envs``, arch, plume model or bank shape
    raises ``ValueError`` before any step.  The generator is restored
    once: the rollout carry and the update share it."""
    file = (os.path.join(path, "checkpoint.pt") if os.path.isdir(path)
            else path)
    bundle = torch.load(file, map_location="cpu", weights_only=True)
    saved = bundle["config"]
    now = dataclasses.asdict(cfg)
    for section, key in RESUME_FIELDS:
        a, b = saved[section][key], now[section][key]
        if (list(a) if isinstance(a, (list, tuple)) else a) != (
                list(b) if isinstance(b, (list, tuple)) else b):
            raise ValueError(f"resume {path}: it was saved with "
                             f"{section}.{key}={a!r}, this run has {b!r}")
    shape = None if bank is None else list(bank.conc.shape)
    if bundle["bank_shape"] != shape:
        raise ValueError(f"resume {path}: it was saved over a bank of shape "
                         f"{bundle['bank_shape']}, this run's is {shape}")
    rollout = restore_tensors(loop.rollout, bundle["rollout"],
                              f"resume {path}: rollout")
    loop.model.load_state_dict(bundle["model"])
    loop.optimizer.load_state_dict(bundle["optimizer"])
    loop.generator.set_state(bundle["generator"])
    cur = bundle["curriculum"]
    curriculum = CurriculumState(
        radius=np.float32(cur["radius"]),
        explore_bonus=np.float32(cur["explore_bonus"]),
        success_count=int(cur["success_count"]),
        episode_count=int(cur["episode_count"]),
        num_updates=int(cur["num_updates"]))
    return (dataclasses.replace(loop, rollout=rollout, curriculum=curriculum),
            bundle["counters"])


@dataclasses.dataclass
class TrainResult:
    state_dict: dict
    curriculum: CurriculumState
    episodes: int
    successes: int
    env_steps: int
    steps_per_sec: float
    out_dir: str
    # the captured episodes (``EpisodeCapture.arrays``) when a capture ran
    trajectories: EpisodeArrays | None = None


def _records(traj, trajectories: bool) -> dict:
    """The [T, N] device arrays the host drain reads: the episode records
    of ``REC_KEYS`` and, for a capture (``trajectories``), the positions,
    concentrations and final positions (which the capture writes as the
    source's)."""
    ep = traj.episode
    rec = {k: getattr(ep, k) for k in REC_KEYS}
    if trajectories:
        rec.update(pos=traj.pos, conc=traj.conc, final_x=ep.final_x,
                   final_y=ep.final_y)
    return rec


class _Profile:
    """``--profile-steps``: ``torch.profiler`` (CPU, and CUDA activity on
    the card) over ``steps`` iterations, started one iteration before them
    so that the tracer is warm when they begin (a cold start loses their
    first launches), a Chrome trace in ``out_dir/profile/trace.json`` when
    they end."""

    def __init__(self, device: torch.device, out_dir: str, steps: int):
        from torch.profiler import ProfilerActivity, profile, schedule

        activities = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if device.type == "cuda" else [])
        self.device, self.out_dir = device, out_dir
        self.prof = profile(activities=activities,
                            schedule=schedule(wait=0, warmup=1, active=steps,
                                              repeat=1),
                            on_trace_ready=self._save)
        self.prof.start()

    def _save(self, prof) -> None:
        os.makedirs(os.path.join(self.out_dir, "profile"), exist_ok=True)
        prof.export_chrome_trace(
            os.path.join(self.out_dir, "profile", "trace.json"))

    def step(self) -> None:
        """After each iteration: the device's work ends inside its step."""
        _sync(self.device)
        self.prof.step()

    def stop(self) -> None:
        _sync(self.device)
        self.prof.stop()


def train_ppo(
    cfg: TrainConfig,
    out_dir: str,
    *,
    device=None,
    write_csv: bool = True,
    max_iterations: int | None = None,
    verbose: bool = True,
    sync_every: int | None = None,
    guide=None,
    bank=None,
    init_params: dict | None = None,
    capture_netcdf: bool = False,
    capture_conc_csv: bool = False,
    use_tensorboard: bool = False,
    profile_steps: int = 0,
    snapshot_every: int | None = None,
    resume_from: str | None = None,
) -> TrainResult:
    """Train until ``cfg.total_episodes`` episodes complete (or
    ``max_iterations`` iterations).  ``device`` defaults to ``cuda`` and
    raises without a card; pass ``"cpu"`` to run on the CPU.
    ``sync_every`` is the number of iterations whose stats and episode
    records are drained to the host in one transfer (default 8); their
    episodes count toward ``cfg.total_episodes`` when the window is
    drained, so training runs to the end of the window that reaches it, as
    JAX's does.  The CSV path compacts the window's done rows on the
    device (``hostsync.drain_window_rows``) at JAX's caps, ``2 * N *
    sync_every`` rows, then ``16 * N * sync_every``, then the full records.
    ``guide`` (``evaluation.guidance.make_guide``) runs in the training
    rollout (``build_train_step(guide=)``): policy-in-the-loop fine-tuning,
    the feedforward policy only, as in JAX.  ``bank`` is the ``FieldBank`` of
    ``plume_model="gridded"``; it is moved to ``device``.  ``init_params``
    (a state_dict of the policy, as ``--pth`` and ``--ckpt`` load it)
    warm-starts the policy; the optimizer starts fresh.  The run writes
    ``checkpoint.pt`` and, for the 2-layer feedforward policy only,
    ``model/ppo_successful_models.pth``, the reference's layout.
    ``capture_netcdf`` writes ``training_data.nc`` (needs h5py) and
    ``capture_conc_csv`` ``data.csv`` (``EpisodeCapture``); with either, the
    captured episodes are also returned in ``TrainResult.trajectories``.
    The capture adds no launch to the step: each drained window's records
    and trajectories come to the host in one transfer.

    ``checkpoint.pt`` is the full bundle (``bundle_of``); ``snapshot_every``
    writes one to ``out_dir/checkpoint_iterNNNNNN/`` at the first window
    boundary at least that many iterations after the last.
    ``resume_from`` (such a directory, or a run's) restores it into the
    fresh loop (``resume_loop``), and the run goes on bit for bit as the
    uninterrupted one: ``training_results.csv``, ``train_log.csv`` and
    ``data.csv`` append, ``training_data.nc`` restarts, and
    ``total_episodes`` and ``max_iterations`` stay absolute targets.  It
    excludes ``init_params``.  ``use_tensorboard`` logs the scalars and
    the params' and full-batch gradients' histograms to ``out_dir/tb``
    every ``LOG_EVERY`` iterations; ``profile_steps`` traces iterations 3
    to 2 + ``profile_steps``, as JAX's does (``_Profile``).  Each logged
    row of ``train_log.csv`` (and TensorBoard) also gets the iteration's
    spans (``obsv.trace.scalars``): ``time/rollout_host_ms``,
    ``time/gae_host_ms``, ``time/update_host_ms``, ``time/read_ms``,
    ``time/drain_ms`` (its window's), and on the card the phases'
    ``time/<phase>_device_ms``."""
    device = resolve_device(device)
    check_env(cfg.env)
    check_ppo(cfg.ppo)
    if guide is not None and cfg.ppo.arch == "lstm":
        raise ValueError(
            "guided fine-tuning (--guide) supports the feedforward arch only")
    if resume_from is not None and init_params is not None:
        raise ValueError("resume_from and init_params are exclusive: a "
                         "resume restores the params it was saved with")
    if bank is not None:
        bank = bank.to(device)
    os.makedirs(out_dir, exist_ok=True)
    loop = init_loop(cfg, device, bank, init_params, guide=guide)
    counters = {"episodes": 0, "successes": 0, "env_steps": 0,
                "iteration": 0}
    resuming = resume_from is not None
    if resuming:
        loop, counters = resume_loop(loop, resume_from, cfg, bank)
    train_step = build_train_step(cfg, bank, guide=guide,
                                  with_grads=use_tensorboard)
    per_iter_steps = cfg.rollout.num_envs * cfg.rollout.unroll_length
    sync_every = max(8 if sync_every is None else sync_every, 1)
    record_caps = (2 * cfg.rollout.num_envs * sync_every,
                   16 * cfg.rollout.num_envs * sync_every)
    episodes, successes = counters["episodes"], counters["successes"]
    env_steps, iteration = counters["env_steps"], counters["iteration"]
    last_snapshot = iteration
    t_steady = None
    it_at_steady = 0
    pending: list = []

    with contextlib.ExitStack() as files:
        capture = None
        if capture_netcdf or capture_conc_csv:
            capture = files.enter_context(contextlib.closing(EpisodeCapture(
                cfg, out_dir, capture_netcdf, capture_conc_csv,
                append=resuming)))
        csv_logger = None
        if write_csv:
            csv_logger = files.enter_context(contextlib.closing(
                EpisodeCSVLogger(os.path.join(out_dir,
                                              "training_results.csv"),
                                 append=resuming)))
        train_logger = files.enter_context(contextlib.closing(
            TrainLogger(out_dir, use_tensorboard, append=resuming)))
        need_records = csv_logger is not None or capture is not None

        def log(it, stats, scalars):
            dt = time.perf_counter() - t_steady
            sps = (it - it_at_steady) * per_iter_steps / max(dt, 1e-9)
            scalars.update({
                "throughput/env_steps_per_sec": sps,
                "progress/episodes": episodes,
                "progress/successes": successes,
            })
            train_logger.log(it, scalars)
            if use_tensorboard:
                train_logger.log_histograms(
                    it, dict(loop.model.named_parameters()))
                train_logger.log_histograms(it, stats["grads"], "grads")
            if verbose:
                print(
                    f"iter {it:5d} | eps {episodes:6d} | "
                    f"succ {successes / max(episodes, 1):5.1%} | "
                    f"radius {scalars['curriculum/radius']:5.1f} | "
                    f"reward/step "
                    f"{scalars['rollout/mean_reward']:7.3f} | "
                    f"{sps / 1e6:6.2f}M steps/s",
                    flush=True,
                )

        def consume():
            # One transfer a window (hostsync).  Episodes count when their
            # window is drained, as in JAX's train_ppo: the loop test sees
            # drained windows only, and an iteration is logged every
            # LOG_EVERY or once the drained count reaches the target.
            nonlocal episodes, successes, last_snapshot
            window = pending[:]
            pending.clear()
            compact = csv_logger is not None and capture is None
            if compact:
                pairs = [(stats, rec) for _, stats, rec, _ in window]
                for cap in record_caps:
                    host_stats, rows, row_count = drain_window_rows(
                        pairs, REC_KEYS, cap)
                    if row_count <= cap:
                        break
                host = [(stats, None) for stats in host_stats]
            else:
                host = drain_window([(stats, rec)
                                     for _, stats, rec, _ in window])
            for (it, _, _, spans), (stats, rec) in zip(window, host):
                scalars = {k: float(v) for k, v in stats.items()
                           if k != "grads"}
                # NaN tripwire: the whole-iteration loss is the canary.
                if not np.isfinite(scalars["loss/total"]):
                    raise RuntimeError(
                        f"non-finite loss at iteration {it}: {scalars} — "
                        f"re-run with --debug-nans to locate the producing "
                        f"phase")
                if rec is not None and csv_logger is not None:
                    csv_logger.log_records({k: rec[k] for k in REC_KEYS})
                if capture is not None:
                    capture.drain(rec)
                episodes += stats["rollout/episodes"]
                successes += stats["rollout/successes"]
                if it % LOG_EVERY == 0 or episodes >= cfg.total_episodes:
                    if spans is not None:
                        scalars.update(trace.scalars(spans, window[-1][3]))
                    log(it, stats, scalars)
            if compact:
                if row_count <= cap:
                    csv_logger.log_records(
                        {"done": np.arange(cap) < row_count, **rows})
                else:
                    # Both caps overflowed: the full records, every row.
                    for rec in drain_window([rec for _, _, rec, _ in window]):
                        csv_logger.log_records({k: rec[k] for k in REC_KEYS})
            if snapshot_every and window:
                it_last = window[-1][0]
                if it_last - last_snapshot >= snapshot_every:
                    save_checkpoint(
                        os.path.join(out_dir, f"checkpoint_iter{it_last:06d}"),
                        cfg, cpu_state_dict(loop.model), **bundle_of(
                            loop, counters_now(), bank))
                    last_snapshot = it_last

        def counters_now():
            return {"episodes": episodes, "successes": successes,
                    "env_steps": env_steps, "iteration": iteration}

        profiler = None
        while episodes < cfg.total_episodes:
            if max_iterations is not None and iteration >= max_iterations:
                break
            if profile_steps and iteration == 1:
                # warms up over iteration 2, traces 3 to 2 + profile_steps
                profiler = _Profile(device, out_dir, profile_steps)
            begun = trace.count()
            loop, stats, traj = train_step(loop)
            spans = trace.latest() if trace.count() > begun else None
            iteration += 1
            env_steps += per_iter_steps
            if t_steady is None:
                # Steady-state throughput excludes the first iteration,
                # which builds the kernels and warms the allocator.
                t_steady = time.perf_counter()
                it_at_steady = iteration
            pending.append((iteration, stats,
                            _records(traj, capture is not None)
                            if need_records else None, spans))
            if len(pending) >= sync_every:
                consume()
            if profiler is not None:
                profiler.step()
                if iteration == 2 + profile_steps:
                    profiler.stop()
                    profiler = None
        if pending:
            consume()
        if profiler is not None:
            profiler.stop()
        _sync(device)
        total_dt = time.perf_counter() - (t_steady or time.perf_counter())

    state_dict = cpu_state_dict(loop.model)
    save_checkpoint(out_dir, cfg, state_dict,
                    **bundle_of(loop, counters_now(), bank))
    if cfg.ppo.arch == "mlp" and len(cfg.ppo.hidden_sizes) == 2:
        # The .pth layout is the reference's 2-layer PPOActorCritic.
        model_dir = os.path.join(out_dir, "model")
        os.makedirs(model_dir, exist_ok=True)
        torch.save(state_dict,
                   os.path.join(model_dir, "ppo_successful_models.pth"))

    return TrainResult(
        state_dict=state_dict,
        curriculum=loop.curriculum,
        episodes=episodes,
        successes=successes,
        env_steps=env_steps,
        steps_per_sec=(iteration - it_at_steady) * per_iter_steps
        / max(total_dt, 1e-9),
        out_dir=out_dir,
        trajectories=None if capture is None else capture.arrays,
    )
