"""Evaluation harnesses: greedy policy + stop gate over N parallel episodes
(port of ``tpu_plume/evaluation/harnesses.py``).

Reproduces the reference evaluators' statistical protocol:

  - ``ModelEvaluator.run_evaluation`` (PPOV1.1/evaluate_model.py:43-90):
    1000 greedy episodes, heuristic stop, deviation/success CSV;
  - ``evaluate_with_lstm.main`` V2.0 (PPOV2.0/evaluate_with_lstm.py:39-135):
    LSTM threshold stop, metrics npz {deviations, steps, success,
    stopped_early};
  - ``evaluate_with_lstm.main`` V2.1 (PPOV2.1/evaluate_with_lstm.py:29-118):
    PeakAndStop gate (stop_prob > 0.8), success@50px, peak predictions.

All episodes run at once as batched envs on the eval's device: each is
reset once, then every step is one policy forward over all of them, the env
step (``env.methane.step_noise``, whose field sample is one launch of the
plume-sample kernel over the analytic plume or of the bank sample over a
sub-cell bank) and the stop gate; finished episodes are frozen, with no
auto-reset, for the whole ``min(env.max_steps, eval.max_eval_steps)``
steps, as JAX's ``lax.scan`` runs them.  With ``rnn=``, the recurrent
policy, the policy forward is its ``step`` from a carry that starts at zeros
(frozen with the episode in the eval, advanced every step in the expert
data, as in JAX).  The randomness (reset uniforms and
seeds, turbulence normals, Gumbel noise) is drawn up front in one
``EvalDraws``; a caller may pass its own, which is how the tests feed both
packages the same numbers.  With ``guide=`` (``evaluation.guidance``) a
terminal guide replaces the policy's action where it steers, its state
frozen with the episode like the env's; a bank-match guide
(``evaluation.bank_guide``) also reads the shared bank and each episode's
step count.  With ``oracle=`` (``evaluation.oracle``) a scripted policy
replaces the policy's forward.  A seed gives other episodes here than in
the JAX package (Philox against threefry).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Callable, Optional

import numpy as np
import torch

from tpu_plume_torch.core import debug
from tpu_plume_torch.core.config import EnvConfig, EvalConfig, StopConfig
from tpu_plume_torch.core.device import resolve_device
from tpu_plume_torch.core.support import check_env
from tpu_plume_torch.core.tree import tree_map
from tpu_plume_torch.env.methane import reset_from_draws, select, step_noise
from tpu_plume_torch.ops import plume
from tpu_plume_torch.rollout.rollout import gumbel_noise, random_bits
from tpu_plume_torch.stop import controllers as ctrl


@dataclasses.dataclass
class EvalMetrics:
    """The reference validation_metrics.npz schema
    (PPOV2.0/evaluate_with_lstm.py:63-68, 132), with the guide diagnostics
    of a guided eval."""

    deviations: np.ndarray
    steps: np.ndarray
    success: np.ndarray
    stopped_early: np.ndarray
    peak_pred: np.ndarray | None = None
    final_conc: np.ndarray | None = None
    trajectories: np.ndarray | None = None  # [K, T, 3] (x, y, conc), NaN-padded
    sources: np.ndarray | None = None       # [N, 2] true source positions
    # guided-eval diagnostics at episode end (None when unguided): hover
    # mode, fit validity, accepted samples, the fit's estimate [N, 2], the
    # refutations, the closest committed approach to the estimate and the
    # commitment latch, the bank guide's matched row, the episode's bank
    # row and the in-plume contact count (a guide without a register
    # reports zeros)
    guide_hover: np.ndarray | None = None
    guide_fit_ok: np.ndarray | None = None
    guide_samples: np.ndarray | None = None
    guide_est: np.ndarray | None = None
    guide_refutes: np.ndarray | None = None
    guide_dmin: np.ndarray | None = None
    guide_committed: np.ndarray | None = None
    guide_match: np.ndarray | None = None
    field_idx: np.ndarray | None = None
    guide_contacts: np.ndarray | None = None

    def save_csv(self, path: str):
        """The V1.1 evaluator's evaluation_results.csv schema
        (PPOV1.1/evaluate_model.py:77-87)."""
        import csv

        with open(path, "w", newline="") as fh:
            w = csv.writer(fh)
            w.writerow(["episode", "steps", "deviation", "success",
                        "final_conc"])
            for i in range(len(self.deviations)):
                w.writerow([
                    i + 1,
                    int(self.steps[i]),
                    float(self.deviations[i]),
                    bool(self.success[i]),
                    float(self.final_conc[i])
                    if self.final_conc is not None else "",
                ])

    def save_npz(self, path: str):
        data = dict(
            deviations=self.deviations,
            steps=self.steps,
            success=self.success,
            stopped_early=self.stopped_early,
        )
        if self.peak_pred is not None:
            data["peak_pred"] = self.peak_pred
        # guide diagnostics, present only for guided runs so that plain
        # rows keep the reference schema
        for k in GUIDE_FIELDS:
            v = getattr(self, k)
            if v is not None:
                data[k] = v
        np.savez(path, **data)


GUIDE_FIELDS = ("guide_hover", "guide_fit_ok", "guide_samples", "guide_est",
                "guide_refutes", "guide_dmin", "guide_committed",
                "guide_match", "field_idx", "guide_contacts")


# A stop gate bundles (one episode's init state, step_fn(state, conc, pos)
# -> (state', stop)).  JAX's step_fn steps one episode and is vmapped; this
# one steps the batch: state [N, ...], conc f32[N], pos f32[N, pos_dim] ->
# (state', stop bool[N]).  See tpu_plume_torch.stop.controllers.
StopGate = tuple[Any, Callable]


def make_threshold_gate(predict_fn: Callable, stop_cfg: StopConfig) -> StopGate:
    return (
        ctrl.threshold_init(stop_cfg),
        lambda s, conc, pos: ctrl.threshold_step(s, conc, predict_fn,
                                                 stop_cfg),
    )


def make_peak_stop_gate(predict_fn: Callable, stop_cfg: StopConfig) -> StopGate:
    return (
        ctrl.peak_stop_init(stop_cfg),
        lambda s, conc, pos: ctrl.peak_stop_step(s, conc, predict_fn,
                                                 stop_cfg),
    )


def make_heuristic_gate(eval_cfg: EvalConfig, conc_peak: float) -> StopGate:
    return (
        ctrl.heuristic_stop_init(eval_cfg),
        lambda s, conc, pos: ctrl.heuristic_stop_step(s, pos, conc, conc_peak,
                                                      eval_cfg),
    )


@dataclass
class EvalDraws:
    """The randomness of an eval of N episodes over T steps."""

    u_src: torch.Tensor             # f32[N, 2] reset source uniforms
    u_wind: torch.Tensor | None     # f32[N, 2] reset wind uniforms, or None
    bits: torch.Tensor              # i32[N] reset field seeds
    turb_noise: torch.Tensor        # f32[T, N, pos_dim] displacement normals
    gumbel: torch.Tensor | None     # f32[T, N, A] Gumbel noise; None = greedy

    def envs(self, index) -> "EvalDraws":
        """The draws of the episodes ``index`` (a slice or an index
        tensor), contiguous; an absent draw stays None.  The split goes by
        field: the resets are per episode [N, ...], the per-step draws
        [T, N, ...]."""
        def take(x, axis):
            return (None if x is None else
                    x[(slice(None),) * axis + (index,)].contiguous())

        return EvalDraws(u_src=take(self.u_src, 0),
                         u_wind=take(self.u_wind, 0), bits=take(self.bits, 0),
                         turb_noise=take(self.turb_noise, 1),
                         gumbel=take(self.gumbel, 1))

    def to(self, device) -> "EvalDraws":
        return tree_map(lambda x: x.to(device), self)


def draw_eval(generator: torch.Generator, cfg: EnvConfig, length: int,
              num_episodes: int, greedy: bool = True) -> EvalDraws:
    """An eval's draws from ``generator``, on its device: the reset's
    source uniforms, seeds and (for a field with a wind,
    ``plume.reads_wind``) wind uniforms, then the turbulence normals and,
    unless ``greedy``, the Gumbel noise."""
    dev = generator.device
    n = num_episodes
    u_src = torch.rand(n, 2, device=dev, generator=generator)
    bits = random_bits((n,), generator)
    u_wind = (torch.rand(n, 2, device=dev, generator=generator)
              if plume.reads_wind(cfg) else None)
    turb = torch.randn(length, n, cfg.pos_dim, device=dev,
                       generator=generator)
    gumbel = (None if greedy else
              gumbel_noise((length, n, cfg.num_actions), generator))
    return EvalDraws(u_src=u_src, u_wind=u_wind, bits=bits, turb_noise=turb,
                     gumbel=gumbel)


def _check_draws(draws: EvalDraws, cfg: EnvConfig, length: int, n: int,
                 greedy: bool) -> None:
    want = {"u_src": (n, 2), "bits": (n,),
            "turb_noise": (length, n, cfg.pos_dim)}
    if plume.reads_wind(cfg):
        want["u_wind"] = (n, 2)
    if not greedy:
        want["gumbel"] = (length, n, cfg.num_actions)
    for name, shape in want.items():
        x = getattr(draws, name)
        if x is None or tuple(x.shape) != shape:
            raise ValueError(f"EvalDraws.{name} must have shape {shape}, got "
                             f"{None if x is None else tuple(x.shape)}")


def _start(model, env_cfg, device, generator, draws, n, length, greedy,
           goal_radius, bank):
    """The eval's device (``device`` resolved as ``train_ppo`` resolves
    it), the model (None under an oracle), bank and draws moved there, and
    freshly reset episodes.  A ``generator`` must lie on that device.  A
    bank there already stays the same object, keeping its cached
    launch."""
    dev = resolve_device(device)
    if model is not None:
        model = model.to(dev)
    if bank is not None and bank.conc.device.type != dev.type:
        bank = bank.to(dev)
    if draws is None:
        if generator is None:
            raise ValueError("pass a generator or the draws")
        if torch.device(generator.device).type != dev.type:
            raise ValueError(f"the generator is on {generator.device} but "
                             f"the eval runs on {dev}")
        draws = draw_eval(generator, env_cfg, length, n, greedy)
    _check_draws(draws, env_cfg, length, n, greedy)
    draws = draws.to(dev)
    env_state, obs = reset_from_draws(draws.u_src, draws.u_wind, draws.bits,
                                      env_cfg, radius=goal_radius, bank=bank)
    return dev, model, bank, draws, env_state, obs


@torch.no_grad()
def evaluate_policy(
    model: torch.nn.Module | None,
    env_cfg: EnvConfig,
    eval_cfg: EvalConfig,
    generator: torch.Generator | None = None,
    num_episodes: Optional[int] = None,
    stop_gate: Optional[StopGate] = None,
    max_steps: Optional[int] = None,
    greedy: bool = True,
    track_trajectories: int = 0,
    goal_radius: float | None = None,
    bank=None,
    draws: EvalDraws | None = None,
    device=None,
    rnn=None,
    guide=None,
    oracle=None,
) -> EvalMetrics:
    """Run ``num_episodes`` parallel episodes of ``model`` (an
    ``ActorCritic``) for ``max_steps`` steps (default
    ``min(env_cfg.max_steps, eval_cfg.max_eval_steps)``); returns
    per-episode metrics in the reference npz layout.

    ``device`` defaults to ``cuda`` and raises without a card; pass
    ``"cpu"`` to run on the CPU.  The model (in place), the bank and the
    draws are moved there; ``generator``, on that device, draws the
    randomness unless ``draws`` gives it.  ``greedy`` takes
    argmax actions, else argmax(logits + Gumbel noise), JAX's categorical.

    ``track_trajectories=K`` additionally records the (x, y, conc) history
    of the first K episodes in ``metrics.trajectories`` [K, T, 3], NaN past
    episode end.

    ``goal_radius`` overrides the env's episode-termination radius (the
    reference protocol uses the INITIAL_RADIUS=50 of a fresh env).

    ``rnn`` (a ``RecurrentActorCritic``) is the policy in place of
    ``model``, as in JAX, where ``model`` is then not read (the CLI passes
    the same module as both): each step is ``rnn.step`` from a carry that
    starts at zeros and is frozen, like the env state, once the episode has
    ended.

    ``guide`` is a ``(init_state, step_fn)`` terminal-guidance controller
    (``evaluation.guidance.make_guide``): every step, after the policy's
    action, ``step_fn(state, pos, conc, action)`` reads the pre-step
    positions and concentrations, and the env executes the action it
    returns; its state is frozen with the episode.  A ``step_fn`` with
    ``needs_source`` set also receives the true sources, one with
    ``needs_bank`` (``evaluation.bank_guide``) the bank, shared by the
    episodes, and each episode's step count before the move.  The guide's
    registers at the end fill ``EvalMetrics.guide_*``.

    ``oracle`` (``evaluation.oracle.make_oracle``), ``fn(env_state) ->
    i64[N]``, replaces the policy: ``model`` and ``rnn`` are then not read
    and may be None, and a guide may still override its action."""
    check_env(env_cfg)
    n = num_episodes or eval_cfg.episodes
    length = max_steps or min(env_cfg.max_steps, eval_cfg.max_eval_steps)
    if oracle is not None:
        model = rnn = None
    dev, model, bank, draws, env_state, obs = _start(
        model if rnn is None else rnn, env_cfg, device, generator, draws, n,
        length, greedy, goal_radius, bank)
    hidden = None if rnn is None else model.initial_state(n, dev)
    if stop_gate is not None:
        stop_init, stop_fn = stop_gate
        stop_state = ctrl.broadcast(stop_init, n, dev)
    else:
        stop_state = None
    finished = torch.zeros(n, dtype=torch.bool, device=dev)
    steps = torch.zeros(n, dtype=torch.int32, device=dev)
    stopped_early = torch.zeros(n, dtype=torch.bool, device=dev)
    k = track_trajectories
    tracked = (torch.empty(length, k, 3, dtype=torch.float32, device=dev)
               if k else None)
    if guide is not None:
        g_init, g_fn = guide
        guide_state = ctrl.broadcast(g_init, n, dev)

    for t in range(length):
        if oracle is not None:
            action = oracle(env_state)
        else:
            if hidden is None:
                logits, _ = model(obs)
            else:
                new_hidden, logits, _ = model.step(hidden, obs)
            if greedy:
                action = torch.argmax(logits, dim=-1)
            else:
                action = torch.argmax(logits + draws.gumbel[t], dim=-1)
        if guide is not None:
            g_args = (guide_state, env_state.pos, env_state.conc, action)
            if getattr(g_fn, "needs_source", False):
                g_args += (env_state.field.source,)
            elif getattr(g_fn, "needs_bank", False):
                g_args += (bank, env_state.t)
            new_guide, action, _ = g_fn(*g_args)
        new_env, trans = step_noise(env_state, action, draws.turb_noise[t],
                                    env_cfg, bank)
        if debug.enabled():
            debug.check_finite("eval step", logits=None if oracle else logits,
                               obs=trans.obs)
        active = ~finished
        done = trans.done
        if stop_state is not None:
            new_stop, stop_fired = stop_fn(stop_state, trans.info.conc_raw,
                                           new_env.pos)
            stop_state = select(active, new_stop, stop_state)
            stopped_early = stopped_early | (active & stop_fired)
            done = done | stop_fired
        env_state = select(active, new_env, env_state)
        obs = torch.where(active[:, None], trans.obs, obs)
        if hidden is not None:
            hidden = tuple(torch.where(active[:, None], new, old)
                           for new, old in zip(new_hidden, hidden))
        if guide is not None:
            guide_state = select(active, new_guide, guide_state)
        steps = steps + active.to(torch.int32)
        finished = finished | done
        if k:
            tracked[t] = torch.where(
                active[:k, None],
                torch.cat([env_state.pos[:k, :2], env_state.conc[:k, None]],
                          dim=1),
                float("nan"))

    # planimetric deviation (3-D flight keeps the horizontal success gate)
    d = env_state.pos[:, :2] - env_state.field.source
    deviation = torch.sqrt((d * d).sum(-1)).cpu().numpy()
    peak_pred = (stop_state.peak_pred.cpu().numpy()
                 if isinstance(stop_state, ctrl.PeakStopState) else None)
    gdiag = {} if guide is None else _guide_diagnostics(guide_state,
                                                        env_state)
    return EvalMetrics(
        deviations=deviation,
        steps=steps.cpu().numpy(),
        success=deviation <= eval_cfg.success_distance,
        stopped_early=stopped_early.cpu().numpy(),
        peak_pred=peak_pred,
        final_conc=env_state.conc.cpu().numpy(),
        trajectories=(None if tracked is None
                      else np.swapaxes(tracked.cpu().numpy(), 0, 1)),
        sources=env_state.field.source.cpu().numpy(),
        **gdiag,
    )


def _guide_diagnostics(gs, env_state) -> dict:
    """``EvalMetrics``' guide fields from the final guide state, on the
    host; a register the guide lacks reads as zeros, as in JAX."""
    mode = gs.mode
    zeros_i = torch.zeros_like(mode)
    idx = env_state.field.idx
    diag = {
        "guide_hover": mode == 1,
        "guide_fit_ok": gs.est_ok,
        "guide_samples": gs.count,
        "guide_est": gs.est,
        "guide_refutes": getattr(gs, "refutes", zeros_i),
        "guide_dmin": getattr(gs, "d_min", torch.zeros_like(
            gs.est_ok, dtype=torch.float32)),
        "guide_committed": getattr(gs, "committed",
                                   torch.zeros_like(gs.est_ok)),
        "guide_match": getattr(gs, "match", zeros_i),
        "field_idx": zeros_i if idx is None else idx,
        "guide_contacts": getattr(gs, "n_contact", zeros_i),
    }
    return {k: v.cpu().numpy() for k, v in diag.items()}


def summarize(m: EvalMetrics) -> dict:
    """The reference's printed summary block
    (PPOV2.0/evaluate_with_lstm.py:112-129)."""
    succ_dev = m.deviations[m.success]
    return {
        "mean_deviation": float(m.deviations.mean()),
        "std_deviation": float(m.deviations.std()),
        "success_rate": float(m.success.mean()),
        "success_mean_deviation": float(succ_dev.mean()) if succ_dev.size else 0.0,
        "success_std_deviation": float(succ_dev.std()) if succ_dev.size else 0.0,
        "early_stop_rate": float(m.stopped_early.mean()),
        "mean_steps": float(m.steps.mean()),
    }


@dataclass
class Collection:
    """One pass of N episodes over T steps, frozen once each ends (the
    expert data's and DAgger's rollout), on the collection's device."""

    states: torch.Tensor          # f32[T, N, obs_dim] the obs of each step
    actions: torch.Tensor         # i64[T, N] the executed actions
    labels: torch.Tensor | None   # i64[T, N] the labeller's actions
    valid: torch.Tensor           # bool[T, N] the episode was active
    success: torch.Tensor         # bool[N] ended reached within 40 px
    finished: torch.Tensor        # bool[N] ended


@torch.no_grad()
def collect(
    model: torch.nn.Module | None,
    env_cfg: EnvConfig,
    generator: torch.Generator | None = None,
    num_episodes: int = 100,
    bank=None,
    draws: EvalDraws | None = None,
    device=None,
    rnn=None,
    oracle=None,
    labeller=None,
) -> Collection:
    """The eval loop with no gate, at the env's own radius, for
    ``env_cfg.max_steps`` steps: each step the greedy policy (or ``oracle``
    in its place) acts on every episode, finished episodes frozen.
    ``labeller`` (``fn(env_state) -> i64[N]``, an oracle) labels each
    pre-step state.  ``rnn`` is the recurrent policy, its carry advanced
    at every step, also after the episode has ended, as in JAX.
    ``device``, ``generator`` and ``draws`` are as in ``evaluate_policy``."""
    check_env(env_cfg)
    if oracle is not None:
        model = rnn = None
    n, length = num_episodes, env_cfg.max_steps
    dev, model, bank, draws, env_state, obs = _start(
        model if rnn is None else rnn, env_cfg, device, generator, draws, n,
        length, True, None, bank)
    hidden = None if rnn is None else model.initial_state(n, dev)
    finished = torch.zeros(n, dtype=torch.bool, device=dev)
    success = torch.zeros(n, dtype=torch.bool, device=dev)
    states = torch.empty(length, n, env_cfg.obs_dim, dtype=torch.float32,
                         device=dev)
    actions = torch.empty(length, n, dtype=torch.int64, device=dev)
    labels = (None if labeller is None else
              torch.empty(length, n, dtype=torch.int64, device=dev))
    valid = torch.empty(length, n, dtype=torch.bool, device=dev)
    for t in range(length):
        if oracle is not None:
            action = oracle(env_state)
        else:
            if hidden is None:
                logits, _ = model(obs)
            else:
                hidden, logits, _ = model.step(hidden, obs)
            action = torch.argmax(logits, dim=-1)
        if labeller is not None:
            labels[t] = action if labeller is oracle else labeller(env_state)
        new_env, trans = step_noise(env_state, action, draws.turb_noise[t],
                                    env_cfg, bank)
        if debug.enabled():
            debug.check_finite("eval step", logits=None if oracle else logits,
                               obs=trans.obs)
        active = ~finished
        states[t] = obs
        actions[t] = action
        valid[t] = active
        env_state = select(active, new_env, env_state)
        obs = torch.where(active[:, None], trans.obs, obs)
        success = success | (active & trans.done & trans.info.reached
                             & (trans.info.distance <= 40.0))
        finished = finished | trans.done
    return Collection(states=states, actions=actions, labels=labels,
                      valid=valid, success=success, finished=finished)


@torch.no_grad()
def generate_expert_data(
    model: torch.nn.Module | None,
    env_cfg: EnvConfig,
    generator: torch.Generator | None = None,
    num_episodes: int = 100,
    path: str | None = None,
    bank=None,
    draws: EvalDraws | None = None,
    device=None,
    rnn=None,
    oracle=None,
):
    """Greedy-rollout (state, action) collection -- the reference
    expert-data pipeline (PPOV1.1/generate_expert_data.py:14-61):
    ``collect``'s pass, keeping each active episode's (obs, action) in
    step-major order.  Returns numpy ``(states f32[M, obs_dim], actions
    i64[M])`` and writes them to ``path`` in the ``expert_data.npz``
    contract when given.  ``device``, ``generator`` and ``draws`` are as in
    ``evaluate_policy``; ``rnn`` and ``oracle`` (privileged-teacher
    demonstrations, ``evaluation.oracle.make_oracle``) as in ``collect``."""
    c = collect(model, env_cfg, generator, num_episodes, bank, draws, device,
                rnn, oracle)
    mask = c.valid.reshape(-1)
    states = c.states.reshape(-1, env_cfg.obs_dim)[mask].cpu().numpy()
    actions = c.actions.reshape(-1)[mask].cpu().numpy()
    if path is not None:
        from tpu_plume_torch.data.expert import save_expert_data

        save_expert_data(path, states, actions)
    return states, actions
