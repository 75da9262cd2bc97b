"""What the reference's policies share: the LayerNorm eps, and a product
that the TF32 control can round."""

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


def linear(x: torch.Tensor, w: torch.Tensor, b, round_inputs: bool):
    """``x @ w.T + b`` (``b`` may be None); ``round_inputs`` rounds both
    inputs of the product to TF32."""
    if round_inputs:
        x, w = tf32_round(x), tf32_round(w)
    return F.linear(x, w, b)
