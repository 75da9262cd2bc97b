"""PPO actor-critic network (port of ``tpu_plume/models/actor_critic.py``).

An obs_dim->256->128 MLP trunk with LayerNorm+ReLU, a 5-way actor head
returning logits and a scalar critic head.  Submodules are named as the
reference's ``PPOActorCritic`` state_dict names them (``feature.0/1/3/4``,
``actor``, ``critic``), so ``state_dict()`` is the reference ``.pth`` layout.

LayerNorm uses eps 1e-6, flax's default, where torch's own default is 1e-5.
Init is orthogonal with gains sqrt(2) (trunk), 0.01 (actor) and 1.0
(critic), biases zero.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

LAYER_NORM_EPS = 1e-6


class ActorCritic(nn.Module):
    def __init__(self, obs_dim: int, num_actions: int = 5,
                 hidden_sizes: Sequence[int] = (256, 128)):
        super().__init__()
        layers: list[nn.Module] = []
        width = obs_dim
        for h in hidden_sizes:
            layers += [nn.Linear(width, h), nn.LayerNorm(h, eps=LAYER_NORM_EPS),
                       nn.ReLU()]
            width = h
        self.feature = nn.Sequential(*layers)
        self.actor = nn.Linear(width, num_actions)
        self.critic = nn.Linear(width, 1)

    def reset_parameters(self, generator: torch.Generator | None = None):
        """Orthogonal init from ``generator``; LayerNorms to scale 1, bias 0."""
        gains = [(m, math.sqrt(2.0)) for m in self.feature
                 if isinstance(m, nn.Linear)]
        gains += [(self.actor, 0.01), (self.critic, 1.0)]
        with torch.no_grad():
            for lin, gain in gains:
                nn.init.orthogonal_(lin.weight, gain, generator=generator)
                nn.init.zeros_(lin.bias)
            for m in self.feature:
                if isinstance(m, nn.LayerNorm):
                    nn.init.ones_(m.weight)
                    nn.init.zeros_(m.bias)
        return self

    def forward(self, obs: torch.Tensor):
        """obs f32[N, obs_dim] -> (logits f32[N, A], value f32[N])."""
        x = self.feature(obs)
        return self.actor(x), self.critic(x).squeeze(-1)
