"""Behavior cloning: the policy fitted to expert (state, action) pairs by
cross-entropy, a warm start for PPO (``train --ckpt``) (port of
``tpu_plume/train/bc.py``).

A fit is epochs x minibatches of AdamW steps (optax's ``adamw``: weight
decay 1e-4 on every parameter, no clip; ``lstm_trainer.ClippedAdamW``),
each epoch over a fresh permutation of the training rows cut to whole
minibatches; the validation loss and accuracy are taken once, at the end.
The permutations come from a ``torch.Generator`` on the data's device, or
from the caller (``perms``), which is how the tests feed both packages the
same ones.  Every tensor stays on the device; a caller reads the results
once.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch
from torch.nn import functional as F

from tpu_plume_torch.core.config import TrainConfig
from tpu_plume_torch.core.device import resolve_device
from tpu_plume_torch.train.lstm_trainer import ClippedAdamW

# optax.adamw's default weight decay
WEIGHT_DECAY = 1e-4


@dataclasses.dataclass
class BCResult:
    state_dict: dict
    train_loss: float
    val_accuracy: float
    val_loss: float
    samples: int


def _epoch_perms(n: int, epochs: int, generator, perms, device):
    if perms is None:
        return [torch.randperm(n, device=device, generator=generator)
                for _ in range(epochs)]
    if len(perms) != epochs:
        raise ValueError(f"{len(perms)} permutations for {epochs} epochs")
    return [torch.as_tensor(p, device=device) for p in perms]


def make_bc_fitter(model: torch.nn.Module, *, epochs: int = 30,
                   batch_size: int = 4096, lr: float = 1e-3):
    """``fit(x_tr, y_tr, x_va, y_va, generator=None, perms=None) ->
    (losses f32[epochs], val_loss, val_acc)``, training ``model`` (a
    feedforward policy) in place with a fresh optimizer each call.  Each
    epoch takes ``nb = max(1, n // bs)`` minibatches of ``bs = min(
    batch_size, n)`` rows from its permutation (``perms[e]``, i64[n], else
    drawn from ``generator``), the remainder dropped; ``losses`` holds
    each epoch's mean minibatch loss."""

    def fit(x_tr, y_tr, x_va, y_va, generator=None,
            perms: Sequence | None = None):
        n = x_tr.shape[0]
        bs = min(batch_size, n)
        nb = max(1, n // bs)
        opt = ClippedAdamW(model.parameters(), WEIGHT_DECAY, None)
        losses = []
        for perm in _epoch_perms(n, epochs, generator, perms, x_tr.device):
            idx = perm[:nb * bs].reshape(nb, bs)
            total = 0.0
            for i in range(nb):
                logits, _ = model(x_tr[idx[i]])
                loss = F.cross_entropy(logits, y_tr[idx[i]])
                opt.zero_grad()
                loss.backward()
                opt.step(lr)
                total = total + loss.detach()
            losses.append(total / nb)
        with torch.no_grad():
            logits, _ = model(x_va)
            val_loss = F.cross_entropy(logits, y_va)
            val_acc = (torch.argmax(logits, -1) == y_va).float().mean()
        return torch.stack(losses), val_loss, val_acc

    return fit


def _seq_xent(model, obs, labels, mask):
    """The masked cross-entropy and accuracy of the recurrent policy
    replayed over whole episodes [T, b] from a zero carry."""
    h0 = model.initial_state(obs.shape[1], obs.device)
    resets = torch.zeros(obs.shape[:2], dtype=torch.bool, device=obs.device)
    _, logits, _ = model.sequence(h0, obs, resets)
    ce = -torch.log_softmax(logits, -1).gather(
        -1, labels[..., None]).squeeze(-1)
    denom = mask.sum().float().clamp(min=1.0)
    acc = ((torch.argmax(logits, -1) == labels) & mask).sum() / denom
    return (ce * mask.to(ce.dtype)).sum() / denom, acc


def make_seq_bc_fitter(model: torch.nn.Module, *, epochs: int = 30,
                       batch_episodes: int = 64, lr: float = 1e-3):
    """The sequence (BPTT) fitter of the recurrent policy: ``fit(obs,
    labels, mask, v_obs, v_labels, v_mask, generator=None, perms=None) ->
    (losses, val_loss, val_acc)`` over time-major data, obs [T, N, D],
    labels and mask [T, N] (mask True on active steps).  A minibatch is a
    column slice of ``batch_episodes`` whole episodes of the epoch's
    episode permutation, replayed from a zero carry; the loss and the
    accuracy average over the active steps."""

    def fit(obs, labels, mask, v_obs, v_labels, v_mask, generator=None,
            perms: Sequence | None = None):
        n = obs.shape[1]
        be = min(batch_episodes, n)
        nb = max(1, n // be)
        opt = ClippedAdamW(model.parameters(), WEIGHT_DECAY, None)
        losses = []
        for perm in _epoch_perms(n, epochs, generator, perms, obs.device):
            idx = perm[:nb * be].reshape(nb, be)
            total = 0.0
            for i in range(nb):
                cols = idx[i]
                loss, _ = _seq_xent(model, obs[:, cols], labels[:, cols],
                                    mask[:, cols])
                opt.zero_grad()
                loss.backward()
                opt.step(lr)
                total = total + loss.detach()
            losses.append(total / nb)
        with torch.no_grad():
            val_loss, val_acc = _seq_xent(model, v_obs, v_labels, v_mask)
        return torch.stack(losses), val_loss, val_acc

    return fit


def fit_bc(model, x_tr, y_tr, x_va, y_va, *, epochs: int = 30,
           batch_size: int = 4096, lr: float = 1e-3, generator=None,
           perms: Sequence | None = None):
    """One-shot ``make_bc_fitter``."""
    fit = make_bc_fitter(model, epochs=epochs, batch_size=batch_size, lr=lr)
    return fit(x_tr, y_tr, x_va, y_va, generator, perms)


def train_bc(cfg: TrainConfig, out_dir: str | None, expert_path: str, *,
             epochs: int = 30, batch_size: int = 4096, lr: float = 1e-3,
             val_frac: float = 0.1, verbose: bool = True,
             device=None) -> BCResult:
    """Fit the policy of ``cfg`` (feedforward only) to the pairs of
    ``expert_path`` (``expert_data.npz``), holding out ``val_frac`` of them
    (at least one) by ``np.random.default_rng(cfg.seed).permutation``, as
    JAX does.  The init and the epochs' permutations come from
    ``cfg.seed``.  ``device`` defaults to ``cuda``; ``"cpu"`` runs on the
    CPU.  Writes ``out_dir/checkpoint.pt`` (``model``, ``config``), which
    ``train --ckpt`` warm-starts from and ``eval --ckpt`` evaluates; the
    critic head stays at its init."""
    if cfg.ppo.arch == "lstm":
        raise ValueError("behavior cloning supports feedforward archs only")
    from tpu_plume_torch.data.expert import load_expert_data
    from tpu_plume_torch.train.ppo_trainer import (
        cpu_state_dict,
        make_policy_model,
        save_checkpoint,
    )

    device = resolve_device(device)
    states, actions = load_expert_data(expert_path)
    if states.shape[1] != cfg.env.obs_dim:
        raise ValueError(
            f"expert obs dim {states.shape[1]} != config obs dim "
            f"{cfg.env.obs_dim} (match --obs-memory etc. to the collection)"
        )
    n = states.shape[0]
    order = np.random.default_rng(cfg.seed).permutation(n)
    n_val = max(1, int(n * val_frac))
    val_idx, train_idx = order[:n_val], order[n_val:]

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    model = make_policy_model(cfg).reset_parameters(
        torch.Generator().manual_seed(cfg.seed)).to(device)
    losses, val_loss, val_acc = fit_bc(
        model, t(states[train_idx]), t(actions[train_idx]),
        t(states[val_idx]), t(actions[val_idx]), epochs=epochs,
        batch_size=batch_size, lr=lr,
        generator=torch.Generator(device=device).manual_seed(cfg.seed))
    host = torch.cat([losses, val_loss[None], val_acc[None]]).cpu().numpy()
    losses, val_loss, val_acc = host[:-2], float(host[-2]), float(host[-1])
    if verbose:
        print(f"bc: {n - n_val} train / {n_val} val pairs, {epochs} epochs — "
              f"loss {losses[0]:.3f} -> {losses[-1]:.3f}, "
              f"val acc {val_acc:.1%}")
    state_dict = cpu_state_dict(model)
    if out_dir:
        save_checkpoint(out_dir, cfg, state_dict)
    return BCResult(state_dict=state_dict, train_loss=float(losses[-1]),
                    val_accuracy=val_acc, val_loss=val_loss, samples=n)
