"""Recurrent (LSTM) actor-critic, the PPO+LSTM policy (port of
``tpu_plume/models/recurrent.py``).

    obs -> Dense(embed) -> LayerNorm -> ReLU -> LSTM cell -> (actor, critic)

The carry is flax's ``(c, h)``, each f32[N, H] (``torch.nn.LSTMCell`` keeps
``(h, c)``).  Two cells:

- ``LSTMCell``, flax's ``OptimizedLSTMCell``: gate pre-activations
  ``(h @ W_h + b) + x @ W_i`` in the order (i, f, g, o), one bias on the
  hidden side, none on the input side, no +1 on the forget gate;
- ``LayerNormLSTMCell``: ``x @ W_i + h @ W_h`` with no biases, a LayerNorm
  over the 4H pre-activations, +1 on the forget gate and a LayerNorm over
  the new cell state before its tanh.

Every LayerNorm has eps 1e-6, flax's.  The cells are written as explicit
products and gates through ``_dense`` / ``_layer_norm``, so that under a
bf16 ``dtype`` they promote as JAX does: bf16 products and gates, while the
carry stays f32 because a bf16 gate times the f32 ``c`` is f32.  The
LayerNorm cell's ``h`` is a product of two bf16 gates there, bf16 in JAX;
it is kept in the f32 carry, which holds every bf16 value exactly (JAX's
own rollout scan refuses that carry, whose dtype changes after one step).
The heads run in ``dtype`` and return f32 (``f32_heads`` does not apply to
this model, as in JAX).

``sequence`` replays a chunk for the BPTT update: the encoder, the
input-side gate product and the heads do not depend on the carry, so they
run once over all T x N rows, and only the hidden-side product and the
gates run per step.

Init draws flax's distributions from a ``torch.Generator``: the encoder
orthogonal sqrt(2), the cell's input kernels lecun-normal, its recurrent
kernels orthogonal (one matrix per gate in the plain cell, as flax makes
one per gate), the actor orthogonal 0.01, the critic orthogonal 1.0,
biases zero, LayerNorms scale 1, bias 0.
"""

from __future__ import annotations

import copy
import math

import torch
from torch import nn

from tpu_plume_torch.models.actor_critic import (
    LAYER_NORM_EPS,
    _dense,
    _layer_norm,
)

GATES = 4   # (i, f, g, o)

Carry = tuple[torch.Tensor, torch.Tensor]


def _lecun_normal_(weight: torch.Tensor, generator) -> None:
    """flax's ``lecun_normal``: a normal truncated at two deviations, scaled
    to variance 1 / fan_in (``weight`` is [out, in])."""
    std = math.sqrt(1.0 / weight.shape[1]) / 0.87962566103423978
    nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std,
                          generator=generator)


class LSTMCell(nn.Module):
    """flax's ``OptimizedLSTMCell``; ``ih`` [4H, in] and ``hh`` [4H, H] hold
    the per-gate kernels stacked in the order (i, f, g, o), ``hh.bias`` the
    hidden-side biases."""

    def __init__(self, in_features: int, hidden: int):
        super().__init__()
        self.ih = nn.Linear(in_features, GATES * hidden, bias=False)
        self.hh = nn.Linear(hidden, GATES * hidden)

    def reset_parameters(self, generator=None) -> None:
        hidden = self.hh.weight.shape[1]
        _lecun_normal_(self.ih.weight, generator)
        for k in range(GATES):
            nn.init.orthogonal_(self.hh.weight[k * hidden:(k + 1) * hidden],
                                generator=generator)
        nn.init.zeros_(self.hh.bias)

    def forward(self, carry: Carry, xi: torch.Tensor,
                dtype: torch.dtype) -> Carry:
        """One step from ``carry`` given ``xi``, the input-side product
        ``_dense(self.ih, x, dtype)``."""
        c, h = carry
        i, f, g, o = (_dense(self.hh, h, dtype) + xi).chunk(GATES, -1)
        new_c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        return new_c, torch.sigmoid(o) * torch.tanh(new_c)


class LayerNormLSTMCell(nn.Module):
    """The LayerNorm-LSTM of ``tpu_plume/models/recurrent.py``; ``ih``
    [4H, in] and ``hh`` [4H, H] have no biases."""

    def __init__(self, in_features: int, hidden: int):
        super().__init__()
        self.ih = nn.Linear(in_features, GATES * hidden, bias=False)
        self.hh = nn.Linear(hidden, GATES * hidden, bias=False)
        self.ln_gates = nn.LayerNorm(GATES * hidden, eps=LAYER_NORM_EPS)
        self.ln_cell = nn.LayerNorm(hidden, eps=LAYER_NORM_EPS)

    def reset_parameters(self, generator=None) -> None:
        _lecun_normal_(self.ih.weight, generator)
        nn.init.orthogonal_(self.hh.weight, generator=generator)
        for ln in (self.ln_gates, self.ln_cell):
            nn.init.ones_(ln.weight)
            nn.init.zeros_(ln.bias)

    def forward(self, carry: Carry, xi: torch.Tensor,
                dtype: torch.dtype) -> Carry:
        c, h = carry
        z = _layer_norm(self.ln_gates, xi + _dense(self.hh, h, dtype), dtype)
        i, f, g, o = z.chunk(GATES, -1)
        new_c = torch.sigmoid(f + 1.0) * c + torch.sigmoid(i) * torch.tanh(g)
        new_h = torch.sigmoid(o) * torch.tanh(
            _layer_norm(self.ln_cell, new_c, dtype))
        return new_c, new_h.float()


class RecurrentActorCritic(nn.Module):
    def __init__(self, obs_dim: int, num_actions: int = 5,
                 embed_size: int = 128, lstm_hidden: int = 128,
                 dtype: torch.dtype = torch.float32,
                 layer_norm_cell: bool = False):
        super().__init__()
        self.encoder = nn.Linear(obs_dim, embed_size)
        self.encoder_norm = nn.LayerNorm(embed_size, eps=LAYER_NORM_EPS)
        cell = LayerNormLSTMCell if layer_norm_cell else LSTMCell
        self.cell = cell(embed_size, lstm_hidden)
        self.actor = nn.Linear(lstm_hidden, num_actions)
        self.critic = nn.Linear(lstm_hidden, 1)
        self.lstm_hidden = lstm_hidden
        self.dtype = dtype

    def twin(self, dtype: torch.dtype,
             head_dtype: torch.dtype | None = None) -> "RecurrentActorCritic":
        """The same network over the same parameter tensors, computing in
        ``dtype`` (``ActorCritic.twin``); the heads follow ``dtype``, so
        ``head_dtype`` must be None."""
        if head_dtype is not None:
            raise ValueError("the recurrent model's heads follow its dtype")
        twin = copy.copy(self)
        twin.dtype = dtype
        return twin

    def reset_parameters(self, generator: torch.Generator | None = None):
        with torch.no_grad():
            for lin, gain in ((self.encoder, math.sqrt(2.0)),
                              (self.actor, 0.01), (self.critic, 1.0)):
                nn.init.orthogonal_(lin.weight, gain, generator=generator)
                nn.init.zeros_(lin.bias)
            nn.init.ones_(self.encoder_norm.weight)
            nn.init.zeros_(self.encoder_norm.bias)
            self.cell.reset_parameters(generator)
        return self

    def initial_state(self, n: int, device=None) -> Carry:
        """The zero ``(c, h)`` carry, also the episode-boundary reset."""
        return tuple(torch.zeros(n, self.lstm_hidden, dtype=torch.float32,
                                 device=device) for _ in range(2))

    def _input_product(self, obs: torch.Tensor) -> torch.Tensor:
        x = _dense(self.encoder, obs, self.dtype)
        x = torch.relu(_layer_norm(self.encoder_norm, x, self.dtype))
        return _dense(self.cell.ih, x, self.dtype)

    def _heads(self, y: torch.Tensor):
        logits = _dense(self.actor, y, self.dtype).float()
        value = _dense(self.critic, y, self.dtype).squeeze(-1).float()
        return logits, value

    def step(self, carry: Carry, obs: torch.Tensor):
        """obs f32[N, obs_dim] and ``carry`` -> (carry', logits f32[N, A],
        value f32[N])."""
        carry = self.cell(carry, self._input_product(obs), self.dtype)
        return (carry,) + self._heads(carry[1])

    forward = step

    def sequence(self, carry: Carry, obs_seq: torch.Tensor,
                 resets: torch.Tensor):
        """BPTT replay of a chunk: obs_seq f32[T, N, obs_dim], resets
        bool[T, N], True where the carry is zeroed before step t.  Returns
        (carry', logits f32[T, N, A], values f32[T, N]), what a chain of
        ``step`` calls with those resets returns."""
        hs = []
        # unbind, not xi[t]: the backward of T selects would fill and add
        # T gradients of the whole [T, N, 4H] product; unbind's stacks once.
        for xt, reset in zip(self._input_product(obs_seq).unbind(0),
                             resets.unbind(0)):
            carry = tuple(torch.where(reset[:, None], 0.0, x) for x in carry)
            carry = self.cell(carry, xt, self.dtype)
            hs.append(carry[1])
        return (carry,) + self._heads(torch.stack(hs))
