"""End-to-end PPO training (port of ``tpu_plume/train/ppo_trainer.py``,
the feedforward or the recurrent policy, ``cfg.ppo.arch`` "mlp" or "lstm",
on the analytic plume or a gridded ``FieldBank``).

One train step runs

    rollout (policy + env over N envs for T steps)
      -> GAE (reverse loop over T)
      -> PPO update (epochs x minibatches, clip + Adam)
      -> curriculum transition (host scalars)

on the step's device.  The host loop ``train_ppo`` drains completed-episode
records to the reference's CSV every ``sync_every`` iterations, logs
per-iteration scalars, and writes a ``torch.save`` checkpoint and, for the
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

from tpu_plume_torch.core.config import TrainConfig
from tpu_plume_torch.core.device import resolve_device
from tpu_plume_torch.core.support import check_env, check_ppo
from tpu_plume_torch.data.conc_csv import save_conc_rows
from tpu_plume_torch.data.netcdf import EpisodeArrays, NetCDFWriter
from tpu_plume_torch.models.actor_critic import ActorCritic
from tpu_plume_torch.models.recurrent import RecurrentActorCritic
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
    normalize_advantages,
    ppo_update,
    ppo_update_recurrent,
)
from tpu_plume_torch.rollout.rollout import (
    ChunkDraws,
    RolloutCarry,
    init_rollout,
    rollout_chunk,
)

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
    generator: torch.Generator   # update shuffles, on the model's device


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
                     guide=None):
    """One training iteration ``train_step(loop, draws=None, shuffles=None)
    -> (loop, stats, traj)``.

    ``bank`` is the ``FieldBank`` of ``plume_model="gridded"``, on the
    loop's device; the step holds it.

    With the recurrent policy (``arch="lstm"``) the update is
    ``ppo_update_recurrent`` over the [T, N] chunk: its replay starts from
    the chunk-start carry and zeroes it after each done step.

    ``draws`` (``ChunkDraws``) and ``shuffles`` (one roll offset or index
    permutation per epoch; for the recurrent policy one env permutation per
    epoch) replace the iteration's randomness.  With
    ``time_phases`` the device is synchronised at the phase boundaries and
    ``stats`` gets the wall ms of ``time/rollout_ms``, ``time/gae_ms`` and
    ``time/update_ms``.

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
    autodiff under ``fused_update``, as in JAX."""
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
        device = loop.rollout.obs.device
        marks = []

        def mark():
            if time_phases:
                _sync(device)
                marks.append(time.perf_counter())

        carry = push_curriculum(loop)
        h_init = carry.hidden

        mark()
        carry, traj, bootstrap = rollout_chunk(loop.model, carry, env_cfg, T,
                                               draws=draws, bank=bank,
                                               guide=guide, oracle=oracle)
        mark()
        advantages, returns = compute_gae(
            traj.reward, traj.value, traj.done, bootstrap,
            ppo_cfg.gamma, ppo_cfg.gae_lambda)
        mark()

        update_model = (loop.model if update_dtypes is None
                        else loop.model.twin(*update_dtypes))
        if h_init is not None:
            # Sequence-major: the replay needs the time axis.
            adv_n = normalize_advantages(advantages, ppo_cfg)
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
                generator=loop.generator, shuffles=shuffles)
        else:
            def flat(x):
                return x.reshape((-1,) + x.shape[2:])

            adv_n = normalize_advantages(flat(advantages), ppo_cfg)
            if ppo_cfg.bug_compat_returns:
                # Reference quirk: returns built from normalized advantages.
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
                                      shuffles=shuffles)
        mark()

        new_episodes = int(traj.done.sum())
        new_successes = int((traj.done & traj.episode.success).sum())
        curriculum = curriculum_update(loop.curriculum, new_successes,
                                       new_episodes, cur_cfg)

        stats: dict[str, Any] = dict(loss_metrics)
        stats.update({
            "rollout/mean_reward": traj.reward.mean(),
            "rollout/episodes": new_episodes,
            "rollout/successes": new_successes,
            "curriculum/radius": float(curriculum.radius),
            "curriculum/explore_bonus": float(curriculum.explore_bonus),
            "curriculum/updates": curriculum.num_updates,
        })
        if time_phases:
            for name, a, b in zip(("rollout", "gae", "update"), marks,
                                  marks[1:]):
                stats[f"time/{name}_ms"] = (b - a) * 1e3
        new_loop = dataclasses.replace(loop, rollout=carry,
                                       curriculum=curriculum)
        return new_loop, stats, traj

    return train_step


def init_loop(cfg: TrainConfig, device, bank=None,
              init_params: dict | None = None, guide=None) -> LoopCarry:
    """Fresh model, optimizer, envs and curriculum from ``cfg.seed``;
    ``bank`` (gridded model) on ``device``; the recurrent policy's carry
    starts at zeros, and a ``guide``'s state at its initial state.
    ``init_params``, a state_dict of the policy (for the feedforward policy
    the reference ``.pth`` layout), replaces the initial params (the
    optimizer starts fresh)."""
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
      for ``ppo_v2_1``)."""

    def __init__(self, cfg: TrainConfig, out_dir: str, netcdf: bool,
                 conc_csv: bool):
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
            open(self.conc_csv, "w").close()
        self.tracker = RadiusTracker()
        self.assembler = EpisodeAssembler(cfg.rollout.num_envs,
                                          cfg.env.max_steps)

    def drain(self, rec: dict) -> None:
        """Capture the finished episodes of one iteration's [T, N] host
        arrays (``_capture_records``)."""
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


def _done_rows(traj) -> dict:
    """The episode-record rows of ``traj`` where ``done``, on the host."""
    ep = traj.episode
    done = ep.done
    return {"done": np.ones(int(done.sum()), bool),
            **{k: getattr(ep, k)[done].cpu().numpy()
               for k in REC_KEYS if k != "done"}}


def _capture_records(traj) -> dict:
    """The [T, N] device arrays a captured iteration drains: the episode
    records of ``REC_KEYS``, the positions and concentrations, and the
    final positions (which the capture writes as the source's)."""
    ep = traj.episode
    return {**{k: getattr(ep, k) for k in REC_KEYS},
            "pos": traj.pos, "conc": traj.conc,
            "final_x": ep.final_x, "final_y": ep.final_y}


def _window_to_host(window: list) -> list:
    """A window's device arrays (a list of dicts of tensors) on the host in
    one transfer: packed as f32 (bools and the int32 step counts, at most
    2^24, are exact there), then split and cast back."""
    host = torch.cat([v.reshape(-1).float() for tree in window
                      for v in tree.values()]).cpu().numpy()
    out, at = [], 0
    for tree in window:
        host_tree = {}
        for k, v in tree.items():
            n = v.numel()
            host_tree[k] = host[at:at + n].reshape(v.shape).astype(
                str(v.dtype).removeprefix("torch."))
            at += n
        out.append(host_tree)
    return out


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
) -> TrainResult:
    """Train until ``cfg.total_episodes`` episodes complete (or
    ``max_iterations`` iterations).  ``device`` defaults to ``cuda`` and
    raises without a card; pass ``"cpu"`` to run on the CPU.
    ``sync_every`` is the number of iterations whose episode records are
    drained to the CSV in one batch (default 8); their episodes count
    toward ``cfg.total_episodes`` when the batch is drained, so training
    runs to the end of the window that reaches it, as JAX's does.
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
    and trajectories come to the host in one transfer."""
    device = resolve_device(device)
    check_env(cfg.env)
    check_ppo(cfg.ppo)
    if guide is not None and cfg.ppo.arch == "lstm":
        raise ValueError(
            "guided fine-tuning (--guide) supports the feedforward arch only")
    if bank is not None:
        bank = bank.to(device)
    os.makedirs(out_dir, exist_ok=True)
    loop = init_loop(cfg, device, bank, init_params, guide=guide)
    train_step = build_train_step(cfg, bank, guide=guide)
    per_iter_steps = cfg.rollout.num_envs * cfg.rollout.unroll_length
    sync_every = max(8 if sync_every is None else sync_every, 1)
    episodes = successes = env_steps = iteration = 0
    t_steady = None
    it_at_steady = 0
    pending: list = []

    with contextlib.ExitStack() as files:
        capture = None
        if capture_netcdf or capture_conc_csv:
            capture = files.enter_context(contextlib.closing(EpisodeCapture(
                cfg, out_dir, capture_netcdf, capture_conc_csv)))
        csv_logger = None
        if write_csv:
            csv_logger = files.enter_context(contextlib.closing(
                EpisodeCSVLogger(os.path.join(out_dir,
                                              "training_results.csv"))))
        train_logger = files.enter_context(contextlib.closing(
            TrainLogger(out_dir)))

        def consume():
            # Episodes count when their window is drained, as in JAX's
            # train_ppo: the loop test sees drained windows only, and an
            # iteration is logged on LOG_EVERY or once the drained count
            # reaches the target.
            nonlocal episodes, successes
            if capture is not None:
                host = _window_to_host([rec for _, _, rec in pending])
                pending[:] = [(it, stats, rec) for (it, stats, _), rec in
                              zip(pending, host)]
            for it, stats, rows in pending:
                scalars = {k: float(v) for k, v in stats.items()}
                # NaN tripwire: the whole-iteration loss is the canary.
                if not np.isfinite(scalars["loss/total"]):
                    raise RuntimeError(f"non-finite loss at iteration {it}: "
                                       f"{scalars}")
                if csv_logger is not None:
                    csv_logger.log_records({k: rows[k] for k in REC_KEYS})
                if capture is not None:
                    capture.drain(rows)
                episodes += stats["rollout/episodes"]
                successes += stats["rollout/successes"]
                if it % LOG_EVERY == 0 or episodes >= cfg.total_episodes:
                    dt = time.perf_counter() - t_steady
                    sps = (it - it_at_steady) * per_iter_steps / max(dt, 1e-9)
                    scalars.update({
                        "throughput/env_steps_per_sec": sps,
                        "progress/episodes": episodes,
                        "progress/successes": successes,
                    })
                    train_logger.log(it, scalars)
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
            pending.clear()

        while episodes < cfg.total_episodes:
            if max_iterations is not None and iteration >= max_iterations:
                break
            loop, stats, traj = train_step(loop)
            iteration += 1
            env_steps += per_iter_steps
            if t_steady is None:
                # Steady-state throughput excludes the first iteration,
                # which builds the kernels and warms the allocator.
                t_steady = time.perf_counter()
                it_at_steady = iteration
            if capture is not None:
                rows = _capture_records(traj)
            else:
                rows = _done_rows(traj) if csv_logger is not None else None
            pending.append((iteration, stats, rows))
            if len(pending) >= sync_every:
                consume()
        consume()
        _sync(device)
        total_dt = time.perf_counter() - (t_steady or time.perf_counter())

    state_dict = cpu_state_dict(loop.model)
    save_checkpoint(
        out_dir, cfg, state_dict,
        optimizer=loop.optimizer.state_dict(),
        curriculum=curriculum_dict(loop.curriculum),
        counters={"episodes": episodes, "successes": successes,
                  "env_steps": env_steps, "iteration": iteration})
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
