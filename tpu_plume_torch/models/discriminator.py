"""GAIL discriminator (port of ``tpu_plume/models/discriminator.py``).

(state || one-hot action) -> 128 -> ReLU -> 1, returning the logit; the
loss is the numerically stable sigmoid BCE on logits.  The weights live in
``net = Sequential(Linear, ReLU, Linear)``, so ``state_dict()`` is the
reference ``discriminator.pth`` layout (``net.0``, ``net.2``;
``tpu_plume/data/torch_export.py``).  Init draws flax's ``Dense`` default
from a ``torch.Generator``: lecun-normal kernels (a normal truncated at two
deviations, variance 1 / fan_in) and zero biases.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from tpu_plume_torch.models.recurrent import _lecun_normal_


class Discriminator(nn.Module):
    def __init__(self, obs_dim: int, num_actions: int, hidden: int = 128):
        super().__init__()
        self.net = nn.Sequential(nn.Linear(obs_dim + num_actions, hidden),
                                 nn.ReLU(), nn.Linear(hidden, 1))

    def reset_parameters(self, generator: torch.Generator | None = None):
        with torch.no_grad():
            for lin in (self.net[0], self.net[2]):
                _lecun_normal_(lin.weight, generator)
                nn.init.zeros_(lin.bias)
        return self

    def forward(self, state: torch.Tensor,
                action_one_hot: torch.Tensor) -> torch.Tensor:
        """state f32[..., obs_dim], action_one_hot f32[..., A] -> logit
        f32[...]."""
        return self.net(torch.cat([state, action_one_hot], -1)).squeeze(-1)


def bce_with_logits(logits: torch.Tensor, targets: torch.Tensor,
                    mean=torch.mean) -> torch.Tensor:
    """Stable binary cross-entropy on logits (== BCELoss(sigmoid(x), t));
    ``mean`` averages the samples' terms (a data-parallel rank passes its
    share of the global mean, ``rl.ppo.Share.mean``)."""
    return mean(torch.clamp(logits, min=0.0) - logits * targets
                + torch.log1p(torch.exp(-torch.abs(logits))))


def discriminator_loss(model: Discriminator, expert_states, expert_actions_oh,
                       policy_states, policy_actions_oh) -> torch.Tensor:
    """Expert labelled 1, policy labelled 0, the two BCEs summed
    (reference ``compute_discriminator_loss``)."""
    e = model(expert_states, expert_actions_oh)
    p = model(policy_states, policy_actions_oh)
    return (bce_with_logits(e, torch.ones_like(e))
            + bce_with_logits(p, torch.zeros_like(p)))


def gail_reward(model: Discriminator, states: torch.Tensor,
                actions_oh: torch.Tensor) -> torch.Tensor:
    """The imitation reward -log(1 - D(s, a)) = softplus(logit)."""
    return F.softplus(model(states, actions_oh))
