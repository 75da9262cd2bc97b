"""The recurrent actor-critic (PPO-LSTM) and its BPTT minibatches, in
float32, written from the published equations:

    x = ReLU(LayerNorm(W_e obs + b_e))                          encoder
    z = W_h h + b_h + W_i x              (plain cell)
    z = LayerNorm(W_i x + W_h h)         (LayerNorm cell, Ba et al. 2016)
    i, f, g, o = z split in four, in that order
    c' = sigmoid(f [+ 1]) c + sigmoid(i) tanh(g)
    h' = sigmoid(o) tanh(c')             (plain cell)
    h' = sigmoid(o) tanh(LayerNorm(c'))  (LayerNorm cell)
    logits = W_a h' + b_a, value = w_v h' + b_v

with the +1 on the forget gate in the LayerNorm cell only, and every
LayerNorm's eps 1e-6.  The configuration's ``ppo.lstm_layer_norm`` chooses
the cell; its ``policy`` is ``{"obs_dim", "embed", "hidden",
"num_actions"}`` (E and H).  Parameters carry the program's
``state_dict`` names: ``encoder``, ``encoder_norm``, ``cell.ih`` [4H, E]
and ``cell.hh`` [4H, H] (the plain cell's bias on ``cell.hh``, the
LayerNorm cell's ``cell.ln_gates`` over 4H and ``cell.ln_cell`` over H),
``actor``, ``critic``.

The carry is (c, h), each f32[N, H], zeros at the start and after every
episode's end (``train.rollout``).  The update (CleanRL's
``ppo_atari_lstm.py``, "The 37 Implementation Details of PPO", Huang et
al. 2022): each epoch permutes the envs and cuts them into minibatches of
``minibatch_size // T`` whole sequences, each replayed over its T steps
from the chunk-start carry, zeroed before step t where step t - 1 ended an
episode, with backpropagation through all T steps.

Where this departs from CleanRL's recurrent PPO:

- the cell is flax's ``OptimizedLSTMCell`` (one bias, on the hidden side;
  no +1 on the forget gate) or the LayerNorm cell above, not
  ``torch.nn.LSTM`` (two biases);
- the encoder is one Linear with a LayerNorm, not a convolutional trunk;
- the carry is zeroed after the env step that ends an episode, where
  CleanRL multiplies it by ``1 - done`` before each step; the values are
  the same;
- the minibatch counts steps (``minibatch_size // T`` envs), where CleanRL
  sets the number of env minibatches;
- the loss, the clip and Adam are the feedforward policy's
  (``train.ppo_loss``, ``train.Adam``): the advantages normalised once
  over the whole batch and not per minibatch, the clipped value loss
  weighted by ``value_loss_coef`` without CleanRL's further 1/2, optax's
  global-norm clip (``g / norm * max``, not ``g / (norm + 1e-6) * max``),
  Adam's eps 1e-8 (CleanRL's 1e-5), and no learning-rate annealing;
- the weights are drawn normal with std gain / sqrt(fan_in) from the seed,
  not orthogonal.
"""

from __future__ import annotations

import math

import torch
from torch.nn import functional as F

from plumebench import counts
from plumebench.reference.layers import LAYER_NORM_EPS, linear

GATES = 4


def _layer_norm_cell(spec) -> bool:
    return bool(spec.ppo()["lstm_layer_norm"])


def layout(spec) -> list:
    """(name, shape, kind, gain) of every parameter, in the program's
    ``named_parameters`` order (``policy_mlp.layout``'s kinds)."""
    p = spec.policy
    d, e, h, a = p["obs_dim"], p["embed"], p["hidden"], p["num_actions"]
    out = [("encoder.weight", (e, d), "w", math.sqrt(2.0)),
           ("encoder.bias", (e,), "b", 0.0),
           ("encoder_norm.weight", (e,), "g", 0.0),
           ("encoder_norm.bias", (e,), "b", 0.0),
           ("cell.ih.weight", (GATES * h, e), "w", 1.0),
           ("cell.hh.weight", (GATES * h, h), "w", 1.0)]
    if _layer_norm_cell(spec):
        out += [("cell.ln_gates.weight", (GATES * h,), "g", 0.0),
                ("cell.ln_gates.bias", (GATES * h,), "b", 0.0),
                ("cell.ln_cell.weight", (h,), "g", 0.0),
                ("cell.ln_cell.bias", (h,), "b", 0.0)]
    else:
        out.append(("cell.hh.bias", (GATES * h,), "b", 0.0))
    return out + [("actor.weight", (a, h), "w", 0.01),
                  ("actor.bias", (a,), "b", 0.0),
                  ("critic.weight", (1, h), "w", 1.0),
                  ("critic.bias", (1,), "b", 0.0)]


def shuffles(spec, gen: torch.Generator) -> list:
    """One permutation i64[N] of the envs per epoch."""
    return [torch.randperm(spec.num_envs, device=gen.device, generator=gen)
            for _ in range(spec.epochs)]


def initial_carry(spec, device):
    """(c, h), zeros f32[N, H] each."""
    return tuple(torch.zeros(spec.num_envs, spec.policy["hidden"],
                             device=device) for _ in range(2))


def _encode(params: dict, obs: torch.Tensor, round_inputs: bool):
    """W_i x of the observations [..., obs_dim]: the input side of the gates,
    which does not depend on the carry."""
    x = linear(obs, params["encoder.weight"], params["encoder.bias"],
               round_inputs)
    x = F.layer_norm(x, x.shape[-1:], params["encoder_norm.weight"],
                     params["encoder_norm.bias"], LAYER_NORM_EPS)
    return linear(torch.relu(x), params["cell.ih.weight"], None, round_inputs)


def _cell(params: dict, carry, xi: torch.Tensor, ln_cell: bool,
          round_inputs: bool):
    """One step of the cell from ``carry`` (c, h) given ``xi = W_i x``."""
    c, h = carry
    if ln_cell:
        z = xi + linear(h, params["cell.hh.weight"], None, round_inputs)
        z = F.layer_norm(z, z.shape[-1:], params["cell.ln_gates.weight"],
                         params["cell.ln_gates.bias"], LAYER_NORM_EPS)
        i, f, g, o = z.chunk(GATES, -1)
        c = torch.sigmoid(f + 1.0) * c + torch.sigmoid(i) * torch.tanh(g)
        cn = F.layer_norm(c, c.shape[-1:], params["cell.ln_cell.weight"],
                          params["cell.ln_cell.bias"], LAYER_NORM_EPS)
        return c, torch.sigmoid(o) * torch.tanh(cn)
    z = linear(h, params["cell.hh.weight"], params["cell.hh.bias"],
               round_inputs) + xi
    i, f, g, o = z.chunk(GATES, -1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return c, torch.sigmoid(o) * torch.tanh(c)


def _heads(params: dict, h: torch.Tensor, round_inputs: bool):
    logits = linear(h, params["actor.weight"], params["actor.bias"],
                    round_inputs)
    value = linear(h, params["critic.weight"], params["critic.bias"],
                   round_inputs)
    return logits, value.squeeze(-1)


def step(params: dict, carry, obs: torch.Tensor, spec, round_inputs: bool):
    """One rollout step: (carry', logits f32[N, A], value f32[N])."""
    carry = _cell(params, carry, _encode(params, obs, round_inputs),
                  _layer_norm_cell(spec), round_inputs)
    return (carry,) + _heads(params, carry[1], round_inputs)


def update_batch(seq: dict, h_init, spec) -> dict:
    """The update's batch: the [T, N, ...] fields of ``seq``, the resets
    (step t - 1 ended an episode; none at t = 0) and the chunk-start carry
    ``h_init``."""
    batch = {k: v for k, v in seq.items() if k != "dones"}
    dones = seq["dones"]
    batch["resets"] = torch.cat([torch.zeros_like(dones[:1]), dones[:-1]])
    batch["h_init"] = h_init
    return batch


def _envs(batch: dict, index) -> dict:
    """The sequences of the envs ``index``: the env axis is the second of
    every field but the carry's, where it is the first."""
    return {k: (tuple(x[index] for x in v) if k == "h_init" else v[:, index])
            for k, v in batch.items()}


def minibatches(batch: dict, perm: torch.Tensor, spec, half: bool) -> list:
    """The epoch's minibatches: the envs in the order ``perm``, cut into
    ``minibatch_size // T`` whole sequences each; ``half`` keeps the first
    half of each one's envs."""
    n, t = spec.num_envs, spec.unroll_length
    per_mb = max(1, spec.minibatch_size // t)
    count = max(1, n // per_mb)
    per_mb = n // count
    if per_mb * count != n:
        raise ValueError(f"{n} envs do not split into {count} minibatches")
    shuffled = _envs(batch, perm)
    parts = []
    for i in range(count):
        part = _envs(shuffled, slice(i * per_mb, (i + 1) * per_mb))
        if half:
            part = _envs(part, slice(0, per_mb // 2))
        parts.append(part)
    return parts


def minibatch_forward(params: dict, part: dict, spec, round_inputs: bool):
    """(logits f32[T, n, A], values f32[T, n]) of a minibatch's sequences,
    replayed from ``h_init`` with the carry zeroed where ``resets`` is set;
    the input side of the gates and the heads run once over all T n rows."""
    ln_cell = _layer_norm_cell(spec)
    carry, hs = part["h_init"], []
    for xi, reset in zip(_encode(params, part["obs"], round_inputs).unbind(0),
                         part["resets"].unbind(0)):
        carry = tuple(torch.where(reset[:, None], 0.0, x) for x in carry)
        carry = _cell(params, carry, xi, ln_cell, round_inputs)
        hs.append(carry[1])
    return _heads(params, torch.stack(hs), round_inputs)


def macs_per_row(spec) -> int:
    p = spec.policy
    return counts.lstm_macs(p["obs_dim"], p["embed"], p["hidden"],
                            p["num_actions"])
