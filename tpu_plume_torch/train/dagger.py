"""DAgger (Ross et al. 2011) against a scripted oracle (port of
``tpu_plume/train/dagger.py``).

Each round rolls out N fresh episodes for ``env_cfg.max_steps`` steps
(``evaluation.harnesses.collect``, the expert data's pass: each finished
episode frozen), labels every visited pre-step state with the oracle's
action, adds the active steps to the aggregate and refits the student on
it, warm-started, with a fresh optimizer (``train.bc``'s fitters).  Round
0 is driven by the oracle (beta = 1, behavior cloning), later rounds by
the greedy student (beta = 0).  ``arch="lstm"`` runs sequence DAgger: the
recurrent student's carry runs through the collection and the refit is
full-episode BPTT over an episode-major aggregate.

The aggregate is JAX's to the bit, given the same collections: the host
``np.random.default_rng(cfg.seed)`` calls in its order, the
``max_round_samples`` subsample, and the fit set padded to a power-of-two
capacity by ``np.resize`` (flat: at least 2^12 rows, 4096 validation
rows; sequence: at least 2^7 episodes, at most ``seq_episode_cap``, 256
validation episodes).  The collections' draws and the fits' permutations
come from one ``torch.Generator`` on the device, seeded by ``cfg.seed``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpu_plume_torch.core.config import TrainConfig
from tpu_plume_torch.core.device import resolve_device
from tpu_plume_torch.evaluation import harnesses


@dataclasses.dataclass
class DaggerResult:
    state_dict: dict
    rounds: int
    samples: int
    val_accuracy: float
    # the success@40 of each round's own collection
    eval_success: list = dataclasses.field(default_factory=list)


def _collect(model, oracle, env_cfg, n: int, beta: float, *, rnn=False,
             generator=None, draws=None, device=None, mesh=None):
    """One round's collection of ``n`` episodes: the oracle drives where
    ``beta`` is 1, the greedy student (with ``rnn`` its carry fed every
    obs) where it is 0, and the oracle labels every pre-step state.
    Returns ``(states [T, N, D], labels i64[T, N], valid bool[T, N],
    succ bool[N], finished bool[N])`` on the device.  ``draws`` (an
    ``EvalDraws``, greedy) replaces the reset and turbulence draws of
    ``generator``.  Under a data-parallel ``mesh`` the rank collects its
    ``n / W`` episodes of the global draws (``EvalDraws.envs``), with
    no collective; its N is then ``n / W``."""
    if beta not in (0.0, 1.0):
        raise ValueError(f"beta must be 1.0 or 0.0, got {beta}")
    if mesh is not None:
        if n % mesh.world_size:
            raise ValueError(f"{n} episodes must be divisible by the mesh "
                             f"size {mesh.world_size}")
        if draws is None:
            draws = harnesses.draw_eval(generator, env_cfg, env_cfg.max_steps,
                                        n)
        draws = draws.envs(mesh.envs(n))
        n //= mesh.world_size
    c = harnesses.collect(
        None if rnn else model, env_cfg, generator, n, draws=draws,
        device=device, rnn=model if rnn else None,
        oracle=oracle if beta == 1.0 else None, labeller=oracle)
    return c.states, c.labels, c.valid, c.success, c.finished


def train_dagger(
    cfg: TrainConfig,
    out_dir: str | None,
    *,
    oracle_kind: str = "phase",
    rounds: int = 8,
    episodes_per_round: int = 512,
    epochs_per_round: int = 20,
    batch_size: int = 4096,
    lr: float = 1e-3,
    max_round_samples: int = 65536,
    val_frac: float = 0.05,
    seq_episode_cap: int = 1024,
    verbose: bool = True,
    device=None,
) -> DaggerResult:
    """``rounds`` rounds of collection and refit (see the module
    docstring); each round's collection doubles as a closed-loop
    success@40 probe.  ``device`` defaults to ``cuda``; ``"cpu"`` runs on
    the CPU.  Writes ``out_dir/checkpoint.pt`` (``model``, ``config``)
    every round, so that a cut run keeps its latest fit."""
    from tpu_plume_torch.evaluation.oracle import make_oracle
    from tpu_plume_torch.train.bc import make_bc_fitter, make_seq_bc_fitter
    from tpu_plume_torch.train.ppo_trainer import (
        cpu_state_dict,
        make_policy_model,
        save_checkpoint,
    )

    device = resolve_device(device)
    rnn = cfg.ppo.arch == "lstm"
    env_cfg = cfg.env
    model = make_policy_model(cfg).reset_parameters(
        torch.Generator().manual_seed(cfg.seed)).to(device)
    oracle = make_oracle(oracle_kind, env_cfg)
    generator = torch.Generator(device=device).manual_seed(cfg.seed)
    n = episodes_per_round
    if rnn:
        fit = make_seq_bc_fitter(
            model, epochs=epochs_per_round,
            batch_episodes=max(8, batch_size // env_cfg.max_steps), lr=lr)
    else:
        fit = make_bc_fitter(model, epochs=epochs_per_round,
                             batch_size=batch_size, lr=lr)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    xs, ys, ms = [], [], []
    eval_success = []
    rng = np.random.default_rng(cfg.seed)
    for r in range(rounds):
        beta = 1.0 if r == 0 else 0.0
        states, labels, valid, succ, finished = (
            x.cpu().numpy() for x in _collect(
                model, oracle, env_cfg, n, beta, rnn=rnn,
                generator=generator, device=device))
        if rnn:
            # Episode-major aggregate: [T, N, D] columns concatenated on N.
            xs.append(states)
            ys.append(labels)
            ms.append(valid)
            x_all = np.concatenate(xs, axis=1)
            y_all = np.concatenate(ys, axis=1)
            m_all = np.concatenate(ms, axis=1)
            n_eps = x_all.shape[1]
            order = rng.permutation(n_eps)
            n_val = max(1, min(256, n_eps // 20))
            va, tr = order[:n_val], order[n_val:]
            cap = 1 << max(7, int(np.ceil(np.log2(tr.size))))
            cap = min(cap, seq_episode_cap)
            rep = (rng.choice(tr, cap, replace=False)
                   if tr.size > cap else np.resize(tr, (cap,)))
            vrep = np.resize(va, (256,))
            losses, val_loss, val_acc = fit(
                t(x_all[:, rep]), t(y_all[:, rep]), t(m_all[:, rep]),
                t(x_all[:, vrep]), t(y_all[:, vrep]), t(m_all[:, vrep]),
                generator)
            added, total = int(valid.sum()), int(m_all.sum())
        else:
            mask = valid.reshape(-1)
            x = states.reshape(-1, env_cfg.obs_dim)[mask]
            y = labels.reshape(-1)[mask]
            if x.shape[0] > max_round_samples:
                sel = rng.choice(x.shape[0], max_round_samples, replace=False)
                x, y = x[sel], y[sel]
            xs.append(x)
            ys.append(y)
            x_all = np.concatenate(xs)
            y_all = np.concatenate(ys)
            order = rng.permutation(x_all.shape[0])
            n_val = max(1, min(4096, int(x_all.shape[0] * val_frac)))
            va, tr = order[:n_val], order[n_val:]
            # A power-of-two capacity by cyclic repetition, as JAX pads
            # its fit set (duplicates are uniform).
            cap = 1 << max(12, int(np.ceil(np.log2(tr.size))))
            x_fit = np.resize(x_all[tr], (cap, x_all.shape[1]))
            y_fit = np.resize(y_all[tr], (cap,))
            x_val = np.resize(x_all[va], (4096, x_all.shape[1]))
            y_val = np.resize(y_all[va], (4096,))
            losses, val_loss, val_acc = fit(t(x_fit), t(y_fit), t(x_val),
                                            t(y_val), generator)
            added, total = x.shape[0], x_all.shape[0]
        host = torch.cat([losses[-1:], val_loss[None], val_acc[None]]).cpu()
        last_loss, val_acc = float(host[0]), float(host[2])
        s_rate = float(succ.mean())
        eval_success.append(s_rate)
        if verbose:
            who = "oracle-driven" if beta == 1.0 else "student-driven"
            print(f"dagger round {r} ({who}): +{added} -> {total} pairs, fit "
                  f"{last_loss:.3f}, val acc {val_acc:.1%}, rollout s@40 "
                  f"{s_rate:.1%} (find {float(finished.mean()):.1%})",
                  flush=True)
        if out_dir:
            save_checkpoint(out_dir, cfg, cpu_state_dict(model))
    return DaggerResult(
        state_dict=cpu_state_dict(model), rounds=rounds,
        samples=(int(sum(m.sum() for m in ms)) if rnn
                 else int(sum(a.shape[0] for a in xs))),
        val_accuracy=val_acc, eval_success=eval_success)
