"""Clipped-surrogate PPO loss and the multi-epoch minibatch update (port of
``tpu_plume/rl/ppo.py``, feedforward policy).

``ppo_update`` runs ``epochs`` passes over the flat T-major batch, each cut
into minibatches after a shuffle: a random circular roll (default), an
affine index bijection, or a full permutation.  The roll offsets or index
permutations may be given by the caller, which is how the tests reproduce
the JAX package's shuffles.  Each minibatch step takes the gradients, then
a global-norm clip and Adam (``tpu_plume_torch.train.ppo_trainer.ClippedAdam``).

The gradients are autodiff of ``ppo_loss``, with the loss forward recomputed
in the backward under ``cfg.remat`` (``torch.utils.checkpoint``), or, under
``cfg.fused_update``, the fused kernel's (``tpu_plume_torch.ops.ppo``): it
takes every minibatch when the batch has no per-sample weights, the model
is the standard feedforward ActorCritic and the minibatch has a row tile
(the JAX gate, ``tpu_plume/rl/ppo.py:294-302``).  A batch on the card then
goes to the CUDA kernel, one on the CPU to the kernel's plain version.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Sequence

import torch
from torch.utils.checkpoint import checkpoint

from tpu_plume_torch.core.config import PPOConfig
from tpu_plume_torch.core.support import check_ppo
from tpu_plume_torch.ops import ppo as fused_ops


@dataclass
class PPOBatch:
    """Flattened rollout data, each with the sample axis first."""

    obs: torch.Tensor            # f32[B, obs_dim]
    actions: torch.Tensor        # i64[B]
    old_log_probs: torch.Tensor  # f32[B]
    advantages: torch.Tensor     # f32[B] (normalized)
    returns: torch.Tensor        # f32[B]
    old_values: torch.Tensor     # f32[B]
    # Optional per-sample weights of the policy surrogate and entropy
    # (None = uniform); the value loss trains on every sample.
    weights: torch.Tensor | None = None

    def map(self, fn) -> "PPOBatch":
        return PPOBatch(**{f.name: (None if getattr(self, f.name) is None
                                    else fn(getattr(self, f.name)))
                           for f in dataclasses.fields(self)})


def normalize_advantages(advantages: torch.Tensor, cfg: PPOConfig):
    """Global advantage normalization with the reference's degenerate-std
    guard; the population std, as ``jnp.std`` computes it."""
    centered = advantages - advantages.mean()
    std = centered.std(correction=0)
    std = torch.where((std < 1e-6) | torch.isnan(std), torch.ones_like(std), std)
    return centered / (std + cfg.adv_norm_eps)


def ppo_loss(model: torch.nn.Module, batch: PPOBatch, cfg: PPOConfig):
    """(total loss, metrics dict of 0-d tensors) for one minibatch."""
    logits, values = model(batch.obs)
    log_probs_all = torch.log_softmax(logits, dim=-1)
    new_log_probs = log_probs_all.gather(-1, batch.actions[:, None]).squeeze(-1)

    # Clipped policy surrogate.
    ratio = torch.exp(new_log_probs - batch.old_log_probs)
    surr1 = ratio * batch.advantages
    surr2 = torch.clamp(ratio, 1.0 - cfg.clip_epsilon,
                        1.0 + cfg.clip_epsilon) * batch.advantages
    surr = torch.minimum(surr1, surr2)
    if batch.weights is not None:
        wsum = torch.clamp(batch.weights.sum(), min=1.0)
        policy_loss = -(surr * batch.weights).sum() / wsum
    else:
        policy_loss = -surr.mean()

    # Clipped value loss against the stored values.
    value_clipped = batch.old_values + torch.clamp(
        values - batch.old_values, -cfg.clip_epsilon, cfg.clip_epsilon)
    value_loss = cfg.value_loss_coef * torch.maximum(
        (values - batch.returns) ** 2,
        (value_clipped - batch.returns) ** 2,
    ).mean()

    # Entropy bonus.
    ent = -(torch.exp(log_probs_all) * log_probs_all).sum(-1)
    if batch.weights is not None:
        entropy = (ent * batch.weights).sum() / torch.clamp(
            batch.weights.sum(), min=1.0)
    else:
        entropy = ent.mean()

    total = policy_loss + value_loss - cfg.entropy_beta * entropy
    with torch.no_grad():
        metrics = {
            "loss/total": total.detach(),
            "loss/policy": policy_loss.detach(),
            "loss/value": value_loss.detach(),
            "loss/entropy": entropy.detach(),
            "loss/approx_kl": (batch.old_log_probs - new_log_probs).mean(),
            "loss/clip_frac": ((ratio - 1.0).abs() > cfg.clip_epsilon)
            .to(torch.float32).mean(),
        }
    return total, metrics


def draw_shuffles(batch_size: int, cfg: PPOConfig,
                  generator: torch.Generator) -> list:
    """One shuffle per epoch: an int roll offset for ``shuffle_mode="roll"``,
    else an index permutation i64[B] (affine when B is a power of two and
    ``shuffle_mode="affine"``, a full random permutation otherwise)."""
    dev = generator.device
    out = []
    affine = (cfg.shuffle_mode == "affine"
              and (batch_size & (batch_size - 1)) == 0)
    for _ in range(cfg.epochs):
        if cfg.shuffle_mode == "roll":
            out.append(int(torch.randint(0, batch_size, (), device=dev,
                                         generator=generator)))
        elif affine:
            # i -> (a*i + b) mod B with B a power of two and a odd: a bijection.
            a = torch.randint(0, batch_size // 2, (), device=dev,
                              generator=generator) * 2 + 1
            b = torch.randint(0, batch_size, (), device=dev,
                              generator=generator)
            idx = torch.arange(batch_size, device=dev)
            out.append((a * idx + b) & (batch_size - 1))
        else:
            out.append(torch.randperm(batch_size, device=dev,
                                      generator=generator))
    return out


def ppo_update(model: torch.nn.Module, optimizer, batch: PPOBatch,
               cfg: PPOConfig, generator: torch.Generator | None = None,
               shuffles: Sequence | None = None) -> dict[str, torch.Tensor]:
    """``cfg.epochs`` epochs of shuffled minibatch steps on ``model`` in
    place; returns the metrics averaged over all minibatches (0-d tensors).

    ``shuffles`` holds one roll offset or index permutation per epoch (see
    ``draw_shuffles``); without it they are drawn from ``generator``.  The
    batch size must be a multiple of ``cfg.minibatch_size``."""
    check_ppo(cfg)
    batch_size = batch.obs.shape[0]
    mb = cfg.minibatch_size
    num_minibatches = batch_size // mb
    if num_minibatches * mb != batch_size:
        raise ValueError(f"batch {batch_size} not divisible by minibatch {mb}")
    if shuffles is None:
        shuffles = draw_shuffles(batch_size, cfg, generator)
    if len(shuffles) != cfg.epochs:
        raise ValueError(f"{len(shuffles)} shuffles for {cfg.epochs} epochs")

    fused = (cfg.fused_update and batch.weights is None
             and fused_ops.supports(model) and fused_ops.pick_tile(mb) > 0)
    params = dict(model.named_parameters()) if fused else None

    sums: dict[str, torch.Tensor] = {}
    for shuffle in shuffles:
        if isinstance(shuffle, int):
            shuffled = batch.map(lambda x: torch.roll(x, shuffle, 0))
        else:
            shuffled = batch.map(lambda x: x[shuffle])
        for i in range(num_minibatches):
            part = shuffled.map(lambda x: x[i * mb:(i + 1) * mb])
            if fused:
                grads, metrics = fused_ops.fused_ppo_grads(model, part, cfg)
                for name, g in grads.items():
                    params[name].grad = g
            else:
                if cfg.remat:
                    loss, metrics = checkpoint(ppo_loss, model, part, cfg,
                                               use_reentrant=False)
                else:
                    loss, metrics = ppo_loss(model, part, cfg)
                optimizer.zero_grad(set_to_none=True)
                loss.backward()
            optimizer.step()
            for k, v in metrics.items():
                sums[k] = sums[k] + v if k in sums else v
    count = cfg.epochs * num_minibatches
    return {k: v / count for k, v in sums.items()}
