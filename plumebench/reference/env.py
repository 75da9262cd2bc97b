"""The methane env over N envs: reset, step and auto-reset, in 2-D or 3-D
flight over a field module (``field_isotropic``, ``field_bank``), with the
v1_1 shaped reward: concentration, exploration of a D x D visit grid, move
and TKE penalties, the boundary penalty and the terminal bonus within the
curriculum radius.  The state is a dict of tensors with the env axis first;
no function modifies its inputs.

Observation: [x/G, y/G, (z/H in 3-D), conc/peak, tke/(3 TI), t/max_steps,
explore_level].  Actions: stay, +y, -y, +x, -x, and +z, -z in 3-D flight.
"""

from __future__ import annotations

import torch

# Config values this reference does not model, with the value it assumes.
_ASSUMED = {"reward_variant": "v1_1", "elastic_walls": False,
            "obs_memory": False, "num_sources": 1, "terminal_depth_coef": 0.0,
            "terminal_gate_radius": 0.0, "turbulence_signed_normal": False,
            "tke_abs_times_two": False}


def check(env: dict) -> None:
    """Raise unless this reference models ``env``."""
    for key, want in _ASSUMED.items():
        if env[key] != want:
            raise ValueError(f"the reference env models {key}={want!r}, the "
                             f"configuration has {env[key]!r}")


def pos_dim(env: dict) -> int:
    return 3 if env["env_3d"] else 2


def move_step(env: dict) -> float:
    return env["grid_size"] * env["move_frac"]


def action_table(env: dict, device) -> torch.Tensor:
    m = move_step(env)
    rows = [[0.0, 0.0], [0.0, m], [0.0, -m], [m, 0.0], [-m, 0.0]]
    if env["env_3d"]:
        zm = env["grid_size"] * env["z_move_frac"]
        rows = [r + [0.0] for r in rows] + [[0.0, 0.0, zm], [0.0, 0.0, -zm]]
    return torch.tensor(rows, dtype=torch.float32, device=device)


def _cell(pos, env: dict):
    d = env["grid_divisions"]
    c = torch.clamp(torch.floor(pos / (env["grid_size"] // d)).to(torch.int64),
                    0, d - 1)
    return torch.arange(pos.shape[0], device=pos.device), c[:, 0], c[:, 1]


def observe(s: dict, env: dict) -> torch.Tensor:
    rows, cx, cy = _cell(s["pos"], env)
    visits = s["visited"][rows, cx, cy].to(torch.float32)
    level = torch.clamp(visits / env["explore_visit_norm"], max=1.0)
    parts = [s["pos"][:, 0] / env["grid_size"], s["pos"][:, 1] / env["grid_size"]]
    if env["env_3d"]:
        parts.append(s["pos"][:, 2] / env["domain_height"])
    return torch.stack(parts + [
        s["conc"] / env["conc_peak"],
        s["tke"] / (env["turbulence_intensity"] * 3.0),
        s["t"].to(torch.float32) / env["max_steps"],
        level,
    ], dim=-1)


def fresh(field, u_src, u_wind, bits, radius, bonus, env: dict, bank) -> dict:
    """New episodes from the draws: a new field, the agent at the origin,
    a cleared visit grid; ``radius`` and ``bonus`` f32[N] carried."""
    n, dev = bits.shape[0], bits.device
    f = field.new_field(u_src, u_wind, bits, env, bank)
    pos = torch.zeros(n, pos_dim(env), dtype=torch.float32, device=dev)
    t = torch.zeros(n, dtype=torch.int32, device=dev)
    conc, tke = field.sample(f, pos, t, env, bank)
    d = env["grid_divisions"]
    return {"pos": pos, "t": t,
            "visited": torch.zeros(n, d, d, dtype=torch.int32, device=dev),
            "field": f, "radius": radius, "bonus": bonus, "conc": conc,
            "tke": tke}


def select(mask, a, b):
    """Per env ``where(mask, a, b)`` over (nested dicts of) tensors."""
    if isinstance(a, dict):
        return {k: select(mask, a[k], b[k]) for k in a}
    return torch.where(mask.reshape(mask.shape + (1,) * (a.dim() - 1)), a, b)


def step(field, s: dict, action, turb_noise, env: dict, bank):
    """(state', obs', reward, done, reached) of one step of every env with
    actions i64[N] and turbulence normals f32[N, pos_dim]."""
    g = float(env["grid_size"])
    ms = move_step(env)
    tke_norm = env["turbulence_intensity"] * 3.0
    peak = env["conc_peak"]
    t_new = s["t"] + 1
    prev_conc, prev_tke = s["conc"], s["tke"]
    prev_conc_n = prev_conc / peak

    delta = action_table(env, s["pos"].device)[action]
    delta_norm = torch.sqrt((delta * delta).sum(-1))
    if env["env_3d"]:
        moved = (delta_norm > 0.0).to(torch.float32)
        move_penalty = -env["move_penalty_coef"] * (1.0 - moved)
    else:
        move_penalty = -env["move_penalty_coef"] * (1.0 - delta_norm / ms)

    turb_eff = (ms * env["turb_displacement_coef"] * turb_noise
                * prev_tke[:, None] / tke_norm)
    raw = s["pos"] + delta + turb_eff
    if env["wind_advect_coef"]:
        wind = field.wind(s["field"], t_new, env, bank)
        if wind is not None:
            advect = env["wind_advect_coef"] * wind
            if env["env_3d"]:
                advect = torch.cat([advect, torch.zeros_like(advect[:, :1])], -1)
            raw = raw + advect
    if env["env_3d"]:
        new_pos = torch.cat([
            torch.clamp(raw[:, :2], 0.0, g - env["clip_edge_eps"]),
            torch.clamp(raw[:, 2:], 0.0, env["domain_height"])], -1)
    else:
        new_pos = torch.clamp(raw, 0.0, g - env["clip_edge_eps"])

    cur_conc, cur_tke = field.sample(s["field"], new_pos, t_new, env, bank)
    cur_conc_n = cur_conc / peak
    border = torch.minimum(
        torch.minimum(new_pos[:, 0], g - new_pos[:, 0]),
        torch.minimum(new_pos[:, 1], g - new_pos[:, 1]))
    zero = torch.zeros_like(border)
    conc_gradient = (cur_conc_n - prev_conc_n) / (delta_norm + 1e-6)
    boundary_dist = border / g
    start = env["boundary_decay_start"]
    boundary_penalty = torch.where(
        (boundary_dist < start) & (conc_gradient < env["boundary_gradient_gate"]),
        -env["boundary_penalty"] * (start - boundary_dist) ** 2, zero)

    rows, cx, cy = _cell(new_pos, env)
    visited = s["visited"].clone()
    visited[rows, cx, cy] += 1
    visits = visited[rows, cx, cy].to(torch.float32)
    level = torch.clamp(visits / env["explore_visit_norm"], max=1.0)
    explore_reward = (s["bonus"] * (1.0 - level)
                      / (visits ** env["explore_visit_pow"] + 1.0))

    new = dict(s, pos=new_pos, t=t_new, visited=visited, conc=cur_conc,
               tke=cur_tke)
    obs = observe(new, env)
    conc_reward = env["conc_reward_coef"] * cur_conc_n
    tke_penalty = -env["tke_penalty_factor"] * (cur_tke / tke_norm)
    reward = (conc_reward + explore_reward + move_penalty + tke_penalty
              + boundary_penalty)
    d = new_pos[:, :2] - s["field"]["source"]
    distance = torch.sqrt((d * d).sum(-1))
    reached = distance <= s["radius"]
    bonus = torch.clamp(
        env["terminal_bonus_coef"] * (env["initial_radius"] / s["radius"]),
        max=env["terminal_bonus_cap"])
    reward = reward + torch.where(reached, bonus, zero)
    done = (t_new >= env["max_steps"]) | reached
    return new, obs, reward, done, reached


def auto_reset(field, s: dict, obs, done, u_src, u_wind, bits, env: dict,
               bank):
    """Fresh episodes swapped into the envs where ``done``."""
    f = fresh(field, u_src, u_wind, bits, s["radius"], s["bonus"], env, bank)
    return select(done, f, s), select(done, observe(f, env), obs)
