"""PPO actor-critic network (port of ``tpu_plume/models/actor_critic.py``).

An obs_dim->256->128 MLP trunk with LayerNorm+ReLU, a 5-way actor head
returning logits and a scalar critic head.  Submodules are named as the
reference's ``PPOActorCritic`` state_dict names them (``feature.0/1/3/4``,
``actor``, ``critic``), so ``state_dict()`` is the reference ``.pth`` layout.

LayerNorm uses eps 1e-6, flax's default, where torch's own default is 1e-5.
Init is orthogonal with gains sqrt(2) (trunk), 0.01 (actor) and 1.0
(critic), biases zero.

Mixed precision follows flax's ``dtype`` / ``head_dtype``: params stay f32
and the outputs are cast back to f32, while under bfloat16

- a Dense layer casts its input, weight and bias to bf16; its product is
  bf16 and the bias is added in bf16;
- a LayerNorm takes its stats in f32 as E[x^2] - E[x]^2 (clamped at 0),
  normalises in f32 and casts its output to ``dtype``;
- the heads and their input run in ``head_dtype`` when it is set.
"""

from __future__ import annotations

import copy
import math
from typing import Sequence

import torch
from torch import nn
from torch.nn import functional as F

LAYER_NORM_EPS = 1e-6


def _dense(lin: nn.Linear, x: torch.Tensor, dtype: torch.dtype):
    if dtype == torch.float32:
        return lin(x)
    y = F.linear(x.to(dtype), lin.weight.to(dtype))
    return y if lin.bias is None else y + lin.bias.to(dtype)


def _layer_norm(ln: nn.LayerNorm, x: torch.Tensor, dtype: torch.dtype):
    if dtype == torch.float32:
        return ln(x)
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = torch.clamp((xf * xf).mean(-1, keepdim=True) - mu * mu, min=0.0)
    y = (xf - mu) * (torch.rsqrt(var + ln.eps) * ln.weight) + ln.bias
    return y.to(dtype)


class ActorCritic(nn.Module):
    def __init__(self, obs_dim: int, num_actions: int = 5,
                 hidden_sizes: Sequence[int] = (256, 128),
                 dtype: torch.dtype = torch.float32,
                 head_dtype: torch.dtype | None = None):
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
        self.dtype = dtype
        self.head_dtype = head_dtype

    def twin(self, dtype: torch.dtype,
             head_dtype: torch.dtype | None = None) -> "ActorCritic":
        """The same network over the same parameter tensors, computing in
        ``dtype`` / ``head_dtype``: a shallow copy that shares the
        submodules, so a gradient or an optimizer step through the twin
        lands on this network's parameters."""
        twin = copy.copy(self)
        twin.dtype = dtype
        twin.head_dtype = head_dtype
        return twin

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
        x = obs
        for m in self.feature:
            if isinstance(m, nn.Linear):
                x = _dense(m, x, self.dtype)
            elif isinstance(m, nn.LayerNorm):
                x = _layer_norm(m, x, self.dtype)
            else:
                x = m(x)
        hd = self.dtype if self.head_dtype is None else self.head_dtype
        x = x.to(hd)
        logits = _dense(self.actor, x, hd)
        value = _dense(self.critic, x, hd)
        return logits.float(), value.squeeze(-1).float()
