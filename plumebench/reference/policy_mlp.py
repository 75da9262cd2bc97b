"""The actor-critic MLP: obs -> (Linear, LayerNorm (eps 1e-6), ReLU) per
hidden width -> actor logits and a scalar critic value, over a dict of
parameters in the reference ``.pth`` layout.  The configuration's
``policy`` is ``{"obs_dim", "hidden": [widths], "num_actions"}``.

The update rolls the flat T-major batch by one offset per epoch and cuts
it into row minibatches.  No carry."""

from __future__ import annotations

import math

import torch
from torch.nn import functional as F

from plumebench import counts
from plumebench.reference.layers import LAYER_NORM_EPS, linear


def layout(spec) -> list:
    """(name, shape, kind, gain) of every parameter, in the program's
    ``named_parameters`` order: "w" weights drawn normal with std gain /
    sqrt(fan_in), "b" biases and LayerNorm shifts at 0, "g" LayerNorm
    scales at 1."""
    policy = spec.policy
    out = []
    width = policy["obs_dim"]
    for i, h in enumerate(policy["hidden"]):
        lin, ln = f"feature.{3 * i}", f"feature.{3 * i + 1}"
        out += [(f"{lin}.weight", (h, width), "w", math.sqrt(2.0)),
                (f"{lin}.bias", (h,), "b", 0.0),
                (f"{ln}.weight", (h,), "g", 0.0),
                (f"{ln}.bias", (h,), "b", 0.0)]
        width = h
    a = policy["num_actions"]
    out += [("actor.weight", (a, width), "w", 0.01), ("actor.bias", (a,), "b", 0.0),
            ("critic.weight", (1, width), "w", 1.0), ("critic.bias", (1,), "b", 0.0)]
    return out


def shuffles(spec, gen: torch.Generator) -> list:
    """One roll offset of the flat batch per epoch."""
    batch = spec.num_envs * spec.unroll_length
    return torch.randint(0, batch, (spec.epochs,), device=gen.device,
                         generator=gen).tolist()


def initial_carry(spec, device):
    return None


def forward(params: dict, obs: torch.Tensor, hidden: list,
            round_inputs: bool = False):
    """(logits f32[..., A], value f32[...]); ``round_inputs`` rounds each
    product's inputs to TF32."""
    def dense(x, name):
        return linear(x, params[f"{name}.weight"], params[f"{name}.bias"],
                      round_inputs)

    x = obs
    for i, h in enumerate(hidden):
        x = dense(x, f"feature.{3 * i}")
        ln = f"feature.{3 * i + 1}"
        x = F.layer_norm(x, (h,), params[f"{ln}.weight"], params[f"{ln}.bias"],
                         LAYER_NORM_EPS)
        x = torch.relu(x)
    return dense(x, "actor"), dense(x, "critic").squeeze(-1)


def step(params: dict, carry, obs: torch.Tensor, spec, round_inputs: bool):
    """One rollout step: (carry, logits f32[N, A], value f32[N])."""
    logits, value = forward(params, obs, spec.policy["hidden"], round_inputs)
    return carry, logits, value


def update_batch(seq: dict, h_init, spec) -> dict:
    """The update's batch: every [T, N, ...] field of ``seq`` flattened
    T-major to [T N, ...]."""
    return {k: v.reshape((-1,) + v.shape[2:]) for k, v in seq.items()
            if k != "dones"}


def minibatches(batch: dict, shift: int, spec, half: bool) -> list:
    """The epoch's minibatches: the batch rolled by ``shift``, cut into
    rows of ``spec.minibatch_size``; ``half`` keeps each one's first half."""
    mb = spec.minibatch_size
    rolled = {k: torch.roll(v, shift, 0) for k, v in batch.items()}
    parts = []
    for i in range(0, rolled["obs"].shape[0], mb):
        part = {k: v[i:i + mb] for k, v in rolled.items()}
        if half:
            part = {k: v[:mb // 2] for k, v in part.items()}
        parts.append(part)
    return parts


def minibatch_forward(params: dict, part: dict, spec, round_inputs: bool):
    """(logits, values) of a minibatch's rows."""
    return forward(params, part["obs"], spec.policy["hidden"], round_inputs)


def macs_per_row(spec) -> int:
    p = spec.policy
    return counts.mlp_macs(p["obs_dim"], p["hidden"], p["num_actions"])
