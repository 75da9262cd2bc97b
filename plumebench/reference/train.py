"""The reference's training iterations over the checked steps.

One iteration: the curriculum's radius and exploration bonus pushed into
every env; T policy steps, each followed by the env step with the
Gumbel-max action of the step's noise row, the turbulence normals and the
auto-reset from the step's reset draws, and the policy's carry (if it has
one) zeroed in the envs whose episode ended; the bootstrap value from the
final carry, which it does not advance; GAE; the advantages normalized
over the batch (population std); ``epochs`` shuffles, each cutting the
batch into minibatches, and per minibatch the clipped PPO loss, its
gradients, optax's global-norm clip and an Adam step (torch.optim.Adam's
arithmetic: b1 0.9, b2 0.999, eps 1e-8); then the success-windowed
curriculum on the host in float32 numpy.

The policy is the module the configuration names (``policy_<name>``):
it owns the parameters' layout, the shuffles, the carry, the rollout step,
how an epoch's batch is cut into minibatches and each minibatch's forward;
everything else here is shared.

``run`` returns what the comparison reads: each step's loss averaged over
its minibatch steps, Adam's first moment after its first update (the
first clipped gradient, times 1 - b1) and after the first step, and the
parameters' change after the last, by leaf.

``variant`` puts the reference in the program's place for the control and
the planted faults: "tf32" computes the products in TF32 (on the card
TF32 itself, elsewhere inputs rounded to it); "half" takes each
minibatch's loss over its first half (of rows, or of a sequence
minibatch's envs); "reward" alters the rollout's reward row of the last
env step (+1 in every env), which GAE carries back over the chunk.  Every
other variant computes with TF32 off.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from plumebench.reference import env as renv

VARIANTS = ("f32", "tf32", "half", "reward")
_f32 = np.float32


def curriculum_update(cur: dict, successes: int, episodes: int,
                      cfg: dict) -> dict:
    """The adaptive success-window curriculum (float32 host arithmetic)."""
    succ = cur["success_count"] + successes
    count = cur["episode_count"] + episodes
    rate = _f32(succ) / max(_f32(count), _f32(1.0))
    fires = count // cfg["window_size"]
    radius, bonus = cur["radius"], cur["explore_bonus"]
    for _ in range(fires):
        bonus = max(bonus * _f32(cfg["explore_decay_factor"]) ** (_f32(1.0) + rate),
                    _f32(cfg["explore_bonus_floor"]))
        thr = cfg["success_threshold"]
        if rate > thr:
            shrink = radius * _f32(cfg["radius_decay"]) ** (
                _f32(2.0) + _f32(3.0) * (rate - _f32(thr)))
            new_radius = max(_f32(cfg["min_radius"]), shrink)
        elif rate < cfg["expand_below"]:
            new_radius = min(_f32(cfg["initial_radius"]),
                             radius * _f32(cfg["expand_rate"]))
        else:
            new_radius = radius
        step = new_radius - radius
        clamp = cfg["anti_oscillation_clamp"]
        if abs(step) > clamp:
            new_radius = radius + _f32(clamp) * np.sign(step)
        radius = _f32(new_radius)
    if fires > 0:
        rest = count - fires * cfg["window_size"]
        succ, count = int(np.round(rate * _f32(rest))), rest
    return {"radius": _f32(radius), "explore_bonus": _f32(bonus),
            "success_count": succ, "episode_count": count}


def gae(rewards, values, dones, bootstrap, gamma: float, lam: float):
    nonterminal = 1.0 - dones.to(torch.float32)
    adv = torch.empty_like(rewards)
    next_adv = torch.zeros_like(bootstrap)
    next_value = bootstrap
    for t in range(rewards.shape[0] - 1, -1, -1):
        delta = rewards[t] + gamma * next_value * nonterminal[t] - values[t]
        next_adv = delta + gamma * lam * nonterminal[t] * next_adv
        adv[t] = next_adv
        next_value = values[t]
    return adv, adv + values


def normalize(adv, eps: float):
    centered = adv - adv.mean()
    std = centered.std(correction=0)
    std = torch.where((std < 1e-6) | torch.isnan(std), torch.ones_like(std), std)
    return centered / (std + eps)


def ppo_loss(logits, values, mb: dict, ppo: dict):
    """The clipped loss of a minibatch of any leading shape, each term
    averaged over all of it."""
    log_probs = torch.log_softmax(logits, dim=-1)
    new_lp = log_probs.gather(-1, mb["actions"][..., None]).squeeze(-1)
    ratio = torch.exp(new_lp - mb["old_log_probs"])
    eps = ppo["clip_epsilon"]
    surr = torch.minimum(ratio * mb["advantages"],
                         torch.clamp(ratio, 1.0 - eps, 1.0 + eps)
                         * mb["advantages"])
    policy_loss = -surr.mean()
    clipped = mb["old_values"] + torch.clamp(values - mb["old_values"], -eps, eps)
    value_loss = ppo["value_loss_coef"] * torch.maximum(
        (values - mb["returns"]) ** 2, (clipped - mb["returns"]) ** 2).mean()
    entropy = -(torch.exp(log_probs) * log_probs).sum(-1).mean()
    return policy_loss + value_loss - ppo["entropy_beta"] * entropy


class Adam:
    """optax's clip_by_global_norm then torch.optim.Adam's step, by leaf."""

    def __init__(self, names: list, lr: float, max_norm: float):
        self.names, self.lr, self.max_norm = names, lr, max_norm
        self.m, self.v, self.t = {}, {}, 0

    @torch.no_grad()
    def step(self, params: dict, grads: list) -> None:
        norm = torch.sqrt(sum((g * g).sum() for g in grads))
        keep = norm < self.max_norm
        grads = [torch.where(keep, g, g / norm * self.max_norm) for g in grads]
        self.t += 1
        b1, b2 = 0.9, 0.999
        bc1 = 1 - b1 ** self.t
        bc2_sqrt = (1 - b2 ** self.t) ** 0.5
        for name, g in zip(self.names, grads):
            if name not in self.m:
                self.m[name] = torch.zeros_like(g)
                self.v[name] = torch.zeros_like(g)
            m, v = self.m[name], self.v[name]
            m.lerp_(g, 1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            denom = (v.sqrt() / bc2_sqrt).add_(1e-8)
            params[name].addcdiv_(m, denom, value=-(self.lr / bc1))


def _precision(variant: str, device: torch.device):
    """On the card, TF32 on for the "tf32" variant and off for the others;
    elsewhere f32 products (the "tf32" variant rounds their inputs)."""
    if device.type != "cuda":
        return contextlib.nullcontext()

    @contextlib.contextmanager
    def precision(tf32: bool):
        keep = (torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.backends.cudnn.allow_tf32 = tf32
        try:
            yield
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = keep
    return precision(variant == "tf32")


def rollout(field, policy, params, s, obs, carry, draws, spec, bank,
            round_inputs):
    """T steps of every env: the batch's [T, N] rows, the final state, obs
    and carry, the bootstrap value and the step's episode and success
    counts."""
    env = spec.env
    t_len = spec.unroll_length
    rows = {k: [] for k in ("obs", "actions", "old_log_probs", "old_values",
                            "rewards", "dones")}
    episodes = successes = 0
    for t in range(t_len):
        carry, logits, value = policy.step(params, carry, obs, spec,
                                           round_inputs)
        action = torch.argmax(logits + draws["gumbel"][t], dim=-1)
        log_prob = torch.log_softmax(logits, dim=-1).gather(
            -1, action[:, None]).squeeze(-1)
        s, next_obs, reward, done, reached = renv.step(
            field, s, action, draws["turb_noise"][t], env, bank)
        for k, x in (("obs", obs), ("actions", action),
                     ("old_log_probs", log_prob), ("old_values", value),
                     ("rewards", reward), ("dones", done)):
            rows[k].append(x)
        episodes = episodes + done.sum()
        successes = successes + (done & reached).sum()
        u_wind = None if draws["u_wind"] is None else draws["u_wind"][t]
        s, obs = renv.auto_reset(field, s, next_obs, done, draws["u_src"][t],
                                 u_wind, draws["bits"][t], env, bank)
        if carry is not None:
            carry = tuple(torch.where(done[:, None], 0.0, x) for x in carry)
    _, _, bootstrap = policy.step(params, carry, obs, spec, round_inputs)
    batch = {k: torch.stack(v) for k, v in rows.items()}
    return batch, s, obs, carry, bootstrap, int(episodes), int(successes)


def run(spec, field, policy, inputs, steps: int, variant: str = "f32"
        ) -> dict:
    """``steps`` iterations from ``inputs`` (an ``Inputs`` whose checked
    steps are drawn here, in order) with the reference ``field`` and
    ``policy`` modules: {"losses": [float], "first_grad", "first_moment",
    "change": {leaf: tensor}}."""
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}, got {variant!r}")
    env, ppo, cur_cfg = spec.env, spec.ppo(), spec.config["curriculum"]
    renv.check(env)
    bank = inputs.bank
    device = inputs.u_src.device
    round_inputs = variant == "tf32" and device.type != "cuda"
    names = list(inputs.params)
    start = {k: v.clone() for k, v in inputs.params.items()}
    params = {k: v.clone() for k, v in inputs.params.items()}
    n = spec.num_envs
    radius0 = _f32(cur_cfg["initial_radius"])
    bonus0 = _f32(env["explore_bonus_init"])
    full = lambda x: torch.full((n,), float(x), dtype=torch.float32,
                                device=device)
    s = renv.fresh(field, inputs.u_src, inputs.u_wind, inputs.bits,
                   full(radius0), full(bonus0), env, bank)
    obs = renv.observe(s, env)
    carry = policy.initial_carry(spec, device)
    cur = {"radius": radius0, "explore_bonus": bonus0, "success_count": 0,
           "episode_count": 0}
    opt = Adam(names, ppo["learning_rate"], ppo["max_grad_norm"])
    losses, first_grad, first_moment = [], None, None
    with _precision(variant, device):
        for k in range(steps):
            draws, shuffles = inputs.step(k)
            s = dict(s, radius=full(cur["radius"]),
                     bonus=full(cur["explore_bonus"]))
            h_init = carry
            with torch.no_grad():
                seq, s, obs, carry, bootstrap, episodes, successes = rollout(
                    field, policy, params, s, obs, carry, draws, spec, bank,
                    round_inputs)
                if variant == "reward":
                    seq["rewards"][-1] += 1.0
                adv, returns = gae(seq.pop("rewards"), seq["old_values"],
                                   seq["dones"], bootstrap, ppo["gamma"],
                                   ppo["gae_lambda"])
            seq["advantages"] = normalize(
                adv.reshape(-1), ppo["adv_norm_eps"]).reshape(adv.shape)
            seq["returns"] = returns
            batch = policy.update_batch(seq, h_init, spec)
            total, count = 0.0, 0
            for shuffle in shuffles:
                for part in policy.minibatches(batch, shuffle, spec,
                                               variant == "half"):
                    leaves = [params[name].requires_grad_(True)
                              for name in names]
                    logits, values = policy.minibatch_forward(
                        params, part, spec, round_inputs)
                    loss = ppo_loss(logits, values, part, ppo)
                    grads = torch.autograd.grad(loss, leaves)
                    for leaf in leaves:
                        leaf.requires_grad_(False)
                    opt.step(params, list(grads))
                    if first_grad is None:
                        first_grad = {n: opt.m[n].clone() for n in names}
                    total = total + loss.detach()
                    count += 1
            losses.append(float(total / count))
            if k == 0:
                first_moment = {name: opt.m[name].clone() for name in names}
            cur = curriculum_update(cur, successes, episodes, cur_cfg)
    change = {name: params[name] - start[name] for name in names}
    return {"losses": losses, "first_grad": first_grad,
            "first_moment": first_moment, "change": change}
