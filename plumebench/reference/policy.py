"""The actor-critic MLP: obs -> (Linear, LayerNorm (eps 1e-6), ReLU) per
hidden width -> actor logits and a scalar critic value, over a dict of
parameters in the reference ``.pth`` layout."""

from __future__ import annotations

import torch
from torch.nn import functional as F

LAYER_NORM_EPS = 1e-6


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to TF32 (10 mantissa bits, to nearest): the inputs a
    TF32 product reads, for the control on a device without TF32; the
    gradient passes through unchanged."""
    i = x.detach().contiguous().view(torch.int32)
    rounded = ((i + 0x1000) & ~0x1FFF).view(torch.float32)
    return x + (rounded - x.detach())


def forward(params: dict, obs: torch.Tensor, hidden: list,
            round_inputs: bool = False):
    """(logits f32[N, A], value f32[N]); ``round_inputs`` rounds each
    product's inputs to TF32."""
    def linear(x, name):
        w, b = params[f"{name}.weight"], params[f"{name}.bias"]
        if round_inputs:
            x, w = tf32_round(x), tf32_round(w)
        return F.linear(x, w, b)

    x = obs
    for i, h in enumerate(hidden):
        x = linear(x, f"feature.{3 * i}")
        ln = f"feature.{3 * i + 1}"
        x = F.layer_norm(x, (h,), params[f"{ln}.weight"], params[f"{ln}.bias"],
                         LAYER_NORM_EPS)
        x = torch.relu(x)
    return linear(x, "actor"), linear(x, "critic").squeeze(-1)
