"""Generalized Advantage Estimation (port of ``tpu_plume/rl/gae.py``).

Time-major [T, N] arrays and a reverse loop over T shared by all N envs.
``dones[t]`` marks that transition t ended its episode, so the next value
(``values[t+1]`` or the bootstrap) is masked by ``1 - dones[t]``.
"""

from __future__ import annotations

import torch


def compute_gae(rewards: torch.Tensor, values: torch.Tensor,
                dones: torch.Tensor, bootstrap_value: torch.Tensor,
                gamma: float, lam: float):
    """Returns (advantages, returns), both f32[T, N]."""
    nonterminal = 1.0 - dones.to(torch.float32)
    advantages = torch.empty_like(rewards)
    next_adv = torch.zeros_like(bootstrap_value)
    next_value = bootstrap_value
    for t in range(rewards.shape[0] - 1, -1, -1):
        delta = rewards[t] + gamma * next_value * nonterminal[t] - values[t]
        next_adv = delta + gamma * lam * nonterminal[t] * next_adv
        advantages[t] = next_adv
        next_value = values[t]
    return advantages, advantages + values
