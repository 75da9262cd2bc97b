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
(the JAX gate, ``tpu_plume/rl/ppo.py:294-302``); a batch with teacher
labels (distilled PPO, ``oracle_actions``) takes autodiff.  A batch on the card then
goes to the CUDA kernel, one on the CPU to the kernel's plain version.

``ppo_update_recurrent`` is the recurrent policy's update: the same losses
over [T, n] sequence minibatches, cut from the env axis after one env
permutation per epoch, with the policy's carry replayed from the chunk-start
``h_init`` (BPTT).

Under a data-parallel ``mesh`` (``tpu_plume_torch.parallel``) of world size
W > 1 each rank holds its envs' share of the batch: the advantages are
normalized over the global batch, the shuffles are drawn over the global
batch (or the global envs) and each rank takes its rows of each global
minibatch, every mean of the loss becomes the rank's sum over the global
count (``Share``), and the gradients are summed over the ranks before the
clip, so every rank takes the same Adam step; the fused kernels compute a
whole minibatch, so such a batch takes autodiff, as JAX's does under a
mesh.  At world size 1 the update is the plain one with the gradients
passed through the (identity) collective.

Under ``torch.profiler`` each minibatch's gradients (with their sum over
the ranks) and its optimizer step are the ranges ``update.grads`` and
``update.optimizer`` (``obsv.trace.leaf``).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Sequence

import torch
from torch.utils.checkpoint import checkpoint

from tpu_plume_torch.core.config import PPOConfig
from tpu_plume_torch.core.support import check_ppo
from tpu_plume_torch.core.tree import tree_map
from tpu_plume_torch.obsv import trace
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
    # Optional teacher labels of distilled PPO (i64[B]; None = no
    # imitation term).
    oracle_actions: torch.Tensor | None = None

    def map(self, fn) -> "PPOBatch":
        return tree_map(fn, self)


@dataclass
class RecurrentPPOBatch:
    """Sequence-major rollout data of the recurrent policy: the time axis
    stays, so that the update replays the policy's carry over each chunk
    from the chunk-start ``h_init``, zeroed where ``resets`` is set."""

    obs: torch.Tensor            # f32[T, N, obs_dim]
    actions: torch.Tensor        # i64[T, N]
    old_log_probs: torch.Tensor  # f32[T, N]
    advantages: torch.Tensor     # f32[T, N] (normalized)
    returns: torch.Tensor        # f32[T, N]
    old_values: torch.Tensor     # f32[T, N]
    resets: torch.Tensor         # bool[T, N]: zero the carry before step t
    h_init: tuple                # (c, h), each f32[N, H], at chunk start
    # Optional teacher labels of distilled PPO (i64[T, N]; None = no
    # imitation term).
    oracle_actions: torch.Tensor | None = None

    def envs(self, index) -> "RecurrentPPOBatch":
        """The sequences of the envs ``index`` (a slice or an index
        tensor).  The split goes by field, not by shape: ``h_init`` is
        env-major and the others time-major, and a shape test would take
        one for the other where T == N == H; an absent ``oracle_actions``
        stays None."""
        return RecurrentPPOBatch(
            h_init=tuple(x[index] for x in self.h_init),
            **{f.name: (None if getattr(self, f.name) is None
                        else getattr(self, f.name)[:, index])
               for f in dataclasses.fields(self) if f.name != "h_init"})


def _spread(mesh) -> bool:
    """Whether ``mesh`` spreads the batch over more than one rank."""
    return mesh is not None and mesh.world_size > 1


class _Local:
    """The means of a loss over a whole minibatch held by one process."""

    @staticmethod
    def mean(x: torch.Tensor) -> torch.Tensor:
        return x.mean()

    @staticmethod
    def weighted(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return (x * w).sum() / torch.clamp(w.sum(), min=1.0)


class Share:
    """The means of a loss over a global minibatch of ``count`` samples of
    which this rank holds a share: each is the rank's sum over the global
    count (or over the global sum of the weights), so that the ranks'
    values add up to the global mean."""

    def __init__(self, count: int, mesh):
        self.count, self.mesh = count, mesh

    def mean(self, x: torch.Tensor) -> torch.Tensor:
        return x.sum() / self.count

    def weighted(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return (x * w).sum() / torch.clamp(self.mesh.sum(w.sum()), min=1.0)


def normalize_advantages(advantages: torch.Tensor, cfg: PPOConfig,
                         mesh=None):
    """Global advantage normalization with the reference's degenerate-std
    guard; the population std, as ``jnp.std`` computes it.  Under a
    ``mesh`` of W > 1 ranks, each holding an equal share, the mean and the
    variance are the global batch's."""
    if _spread(mesh):
        centered = advantages - mesh.mean(advantages)
        std = torch.sqrt(mesh.mean(centered * centered))
    else:
        centered = advantages - advantages.mean()
        std = centered.std(correction=0)
    std = torch.where((std < 1e-6) | torch.isnan(std), torch.ones_like(std), std)
    return centered / (std + cfg.adv_norm_eps)


def ppo_loss(model: torch.nn.Module, batch: PPOBatch, cfg: PPOConfig,
             share: Share | None = None):
    """(total loss, metrics dict of 0-d tensors) for one minibatch (with
    ``share``, this rank's share of a global minibatch's)."""
    logits, values = model(batch.obs)
    return _clipped_loss(logits, values, batch, cfg, batch.weights, share)


def _maybe_distill(total, metrics, oracle_actions, log_probs_all, obs,
                   cfg: PPOConfig, share=_Local):
    """Distilled PPO's imitation term (JAX's ``_maybe_distill``): the
    cross-entropy of the policy against the teacher's action, added at
    ``cfg.distill_coef``; with ``distill_conc_gate`` > 0 only states whose
    normalized concentration ``obs[..., 2]`` exceeds the gate count.  A
    no-op without labels."""
    if oracle_actions is None:
        return total, metrics
    ce = -log_probs_all.gather(-1, oracle_actions[..., None]).squeeze(-1)
    if cfg.distill_conc_gate > 0.0:
        w = (obs[..., 2] > cfg.distill_conc_gate).to(ce.dtype)
        distill = share.weighted(ce, w)
    else:
        distill = share.mean(ce)
    total = total + cfg.distill_coef * distill
    return total, {**metrics, "loss/total": total.detach(),
                   "loss/distill": distill.detach()}


def _clipped_loss(logits: torch.Tensor, values: torch.Tensor, batch,
                  cfg: PPOConfig, weights: torch.Tensor | None = None,
                  share: Share | None = None):
    """The clipped surrogate, the clipped value loss and the entropy bonus
    of the policy's ``logits`` [..., A] and ``values`` [...] against
    ``batch``'s fields of the same leading shape, averaged over all of it
    (``weights`` masks the surrogate and the entropy); with ``share`` each
    average is this rank's share of the global minibatch's."""
    share = _Local if share is None else share
    log_probs_all = torch.log_softmax(logits, dim=-1)
    new_log_probs = log_probs_all.gather(
        -1, batch.actions[..., None]).squeeze(-1)

    # Clipped policy surrogate.
    ratio = torch.exp(new_log_probs - batch.old_log_probs)
    surr1 = ratio * batch.advantages
    surr2 = torch.clamp(ratio, 1.0 - cfg.clip_epsilon,
                        1.0 + cfg.clip_epsilon) * batch.advantages
    surr = torch.minimum(surr1, surr2)
    if weights is not None:
        policy_loss = -share.weighted(surr, weights)
    else:
        policy_loss = -share.mean(surr)

    # Clipped value loss against the stored values.
    value_clipped = batch.old_values + torch.clamp(
        values - batch.old_values, -cfg.clip_epsilon, cfg.clip_epsilon)
    value_loss = cfg.value_loss_coef * share.mean(torch.maximum(
        (values - batch.returns) ** 2,
        (value_clipped - batch.returns) ** 2,
    ))

    # Entropy bonus.
    ent = -(torch.exp(log_probs_all) * log_probs_all).sum(-1)
    if weights is not None:
        entropy = share.weighted(ent, weights)
    else:
        entropy = share.mean(ent)

    total = policy_loss + value_loss - cfg.entropy_beta * entropy
    with torch.no_grad():
        metrics = {
            "loss/total": total.detach(),
            "loss/policy": policy_loss.detach(),
            "loss/value": value_loss.detach(),
            "loss/entropy": entropy.detach(),
            "loss/approx_kl": share.mean(batch.old_log_probs - new_log_probs),
            "loss/clip_frac": share.mean(
                ((ratio - 1.0).abs() > cfg.clip_epsilon).to(torch.float32)),
        }
    return _maybe_distill(total, metrics, batch.oracle_actions,
                          log_probs_all, batch.obs, cfg, share)


def ppo_loss_recurrent(model: torch.nn.Module, batch: RecurrentPPOBatch,
                       cfg: PPOConfig, share: Share | None = None):
    """``ppo_loss`` over a [T, n] sequence minibatch: the policy's
    ``sequence`` replay from ``batch.h_init`` with ``batch.resets``."""
    _, logits, values = model.sequence(batch.h_init, batch.obs, batch.resets)
    return _clipped_loss(logits, values, batch, cfg, share=share)


def draw_env_permutations(num_envs: int, cfg: PPOConfig,
                          generator: torch.Generator) -> list:
    """One env permutation i64[N] per epoch, the recurrent update's
    shuffles."""
    return [torch.randperm(num_envs, device=generator.device,
                           generator=generator) for _ in range(cfg.epochs)]


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


def _rank_rows(local: torch.Tensor, owner: torch.Tensor, per_mb: int,
               num_minibatches: int, rank: int) -> list:
    """This rank's rows of each global minibatch: ``local`` and ``owner``
    give each position of the epoch's global order its row on its rank and
    that rank; minibatch ``i`` is the positions ``[i * per_mb, (i + 1) *
    per_mb)``.  One host read (the counts) an epoch."""
    mine = torch.nonzero(owner == rank).squeeze(1)
    counts = torch.bincount(mine // per_mb, minlength=num_minibatches)
    return list(local[mine].split(counts.tolist()))


def ppo_update(model: torch.nn.Module, optimizer, batch: PPOBatch,
               cfg: PPOConfig, generator: torch.Generator | None = None,
               shuffles: Sequence | None = None, mesh=None,
               num_envs: int | None = None) -> dict[str, torch.Tensor]:
    """``cfg.epochs`` epochs of shuffled minibatch steps on ``model`` in
    place; returns the metrics averaged over all minibatches (0-d tensors).

    ``shuffles`` holds one roll offset or index permutation per epoch (see
    ``draw_shuffles``); without it they are drawn from ``generator``.  The
    batch size must be a multiple of ``cfg.minibatch_size``.

    Under a ``mesh`` of W > 1 ranks the batch is this rank's T-major
    [T * num_envs] share of the global [T * num_envs * W] batch: the
    shuffles and minibatches are the global batch's, and the returned
    metrics the global ones (module docstring)."""
    check_ppo(cfg)
    spread = _spread(mesh)
    batch_size = batch.obs.shape[0] * (mesh.world_size if spread else 1)
    mb = cfg.minibatch_size
    num_minibatches = batch_size // mb
    if num_minibatches * mb != batch_size:
        raise ValueError(f"batch {batch_size} not divisible by minibatch {mb}")
    if shuffles is None:
        shuffles = draw_shuffles(batch_size, cfg, generator)
    if len(shuffles) != cfg.epochs:
        raise ValueError(f"{len(shuffles)} shuffles for {cfg.epochs} epochs")

    fused = (not spread and cfg.fused_update and batch.weights is None
             and batch.oracle_actions is None
             and fused_ops.supports(model) and fused_ops.pick_tile(mb) > 0)
    params = dict(model.named_parameters()) if fused else None
    share = Share(mb, mesh) if spread else None

    sums: dict[str, torch.Tensor] = {}
    for shuffle in shuffles:
        if spread:
            order = (torch.arange(batch_size, device=batch.obs.device)
                     - shuffle) % batch_size if isinstance(shuffle, int) \
                else shuffle
            envs, n = order % (num_envs * mesh.world_size), num_envs
            rows = _rank_rows(order // (n * mesh.world_size) * n + envs % n,
                              envs // n, mb, num_minibatches, mesh.rank)
            parts = [batch.map(lambda x, r=r: x[r]) for r in rows]
        else:
            if isinstance(shuffle, int):
                shuffled = batch.map(lambda x: torch.roll(x, shuffle, 0))
            else:
                shuffled = batch.map(lambda x: x[shuffle])
            parts = [shuffled.map(lambda x, i=i: x[i * mb:(i + 1) * mb])
                     for i in range(num_minibatches)]
        for part in parts:
            with trace.leaf("update.grads"):
                if fused:
                    grads, metrics = fused_ops.fused_ppo_grads(model, part,
                                                               cfg)
                    for name, g in grads.items():
                        params[name].grad = g
                else:
                    if cfg.remat:
                        loss, metrics = checkpoint(ppo_loss, model, part,
                                                   cfg, share,
                                                   use_reentrant=False)
                    else:
                        loss, metrics = ppo_loss(model, part, cfg, share)
                    optimizer.zero_grad(set_to_none=True)
                    loss.backward()
                if mesh is not None:
                    mesh.sum_grads(model.parameters())
            with trace.leaf("update.optimizer"):
                optimizer.step()
            for k, v in metrics.items():
                sums[k] = sums[k] + v if k in sums else v
    return _averages(sums, cfg.epochs * num_minibatches, mesh)


def _averages(sums: dict, count: int, mesh) -> dict:
    """The metrics' sums over ``count`` minibatch steps as averages, summed
    over the ranks of a ``mesh`` of W > 1 first (one collective)."""
    if _spread(mesh):
        sums = dict(zip(sums, mesh.sum(torch.stack(list(sums.values())))))
    return {k: v / count for k, v in sums.items()}


def ppo_update_recurrent(model: torch.nn.Module, optimizer,
                         batch: RecurrentPPOBatch, cfg: PPOConfig,
                         generator: torch.Generator | None = None,
                         shuffles: Sequence | None = None, mesh=None
                         ) -> dict[str, torch.Tensor]:
    """The recurrent policy's update (``tpu_plume/rl/ppo.py``
    ``ppo_update_recurrent``): ``cfg.epochs`` epochs, each over one env
    permutation (``shuffles``, else ``draw_env_permutations`` from
    ``generator``), cut into minibatches of whole sequences:
    ``cfg.minibatch_size`` counts steps, so a minibatch holds
    ``minibatch_size // T`` envs.  Each minibatch step takes autodiff's
    gradients of ``ppo_loss_recurrent`` (BPTT through ``sequence``), then
    the clip and Adam of ``optimizer``.  ``cfg.fused_update`` and
    ``cfg.remat`` are not read, as JAX's recurrent update does not read
    them: the fused kernels compute the feedforward network.  Returns the
    metrics averaged over all minibatches (0-d tensors).  Under a ``mesh``
    of W > 1 ranks the batch holds this rank's envs of the global N and
    the permutations are of the global envs (module docstring)."""
    check_ppo(cfg)
    spread = _spread(mesh)
    T, n = batch.actions.shape
    N = n * (mesh.world_size if spread else 1)
    envs_per_mb = max(1, cfg.minibatch_size // T)
    num_minibatches = max(1, N // envs_per_mb)
    envs_per_mb = N // num_minibatches
    if num_minibatches * envs_per_mb != N:
        raise ValueError(f"num_envs {N} not divisible into "
                         f"{num_minibatches} minibatches")
    if shuffles is None:
        shuffles = draw_env_permutations(N, cfg, generator)
    if len(shuffles) != cfg.epochs:
        raise ValueError(f"{len(shuffles)} shuffles for {cfg.epochs} epochs")
    share = Share(T * envs_per_mb, mesh) if spread else None

    sums: dict[str, torch.Tensor] = {}
    for perm in shuffles:
        if spread:
            parts = [batch.envs(r) for r in _rank_rows(
                perm % n, perm // n, envs_per_mb, num_minibatches, mesh.rank)]
        else:
            shuffled = batch.envs(perm)
            parts = [shuffled.envs(slice(i * envs_per_mb,
                                         (i + 1) * envs_per_mb))
                     for i in range(num_minibatches)]
        for part in parts:
            with trace.leaf("update.grads"):
                loss, metrics = ppo_loss_recurrent(model, part, cfg, share)
                optimizer.zero_grad(set_to_none=True)
                loss.backward()
                if mesh is not None:
                    mesh.sum_grads(model.parameters())
            with trace.leaf("update.optimizer"):
                optimizer.step()
            for k, v in metrics.items():
                sums[k] = sums[k] + v if k in sums else v
    return _averages(sums, cfg.epochs * num_minibatches, mesh)
