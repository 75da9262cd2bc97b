"""The benchmark's one generator: every input of a run, made on the device
from ``--seed`` and the cell's configuration and traffic files.

``Inputs(spec, seed, device)`` draws, from one ``torch.Generator`` on the
device and always in this order:

1. the policy's parameters, in the layout of the reference policy of the
   program's architecture (``reference/policy_<ppo.arch>.py`` ``layout``,
   the program's ``state_dict`` names), all weights in one normal draw;
2. for a configuration with a ``bank``, the synthesized bank (a frozen copy
   of the port's ``build_3d_bank``: anisotropic plumes with a veering wind
   and a vertical profile), built one frame at a time;
3. the initial episodes' source uniforms and field seeds;
4. for each checked step, the chunk's draws (turbulence normals, Gumbel
   noise, reset uniforms and seeds) and the update's shuffles, one per
   epoch, as the policy draws them (``shuffles``: the MLP's roll offsets,
   the recurrent policy's env permutations).

A second ``Inputs`` of the same seed on the same device replays the same
calls and so holds the same tensors: that is how the reference is handed
the program's inputs once the window has closed, without keeping them on
the device during it.  Nothing here imports the program.
"""

from __future__ import annotations

import math

import torch

from plumebench import registry


def make_params(layout: list, gen: torch.Generator) -> dict:
    """The parameters of ``layout``, (name, shape, kind, gain)
    each (f32, on the generator's device): "w" weights drawn normal, all in
    one draw, with std gain / sqrt(fan_in), "b" biases and LayerNorm shifts
    at 0, "g" LayerNorm scales at 1."""
    dev = gen.device
    weights = [(name, shape, gain) for name, shape, kind, gain in layout
               if kind == "w"]
    flat = torch.randn(sum(math.prod(s) for _, s, _ in weights), device=dev,
                       generator=gen)
    params, at = {}, 0
    for name, shape, gain in weights:
        size = math.prod(shape)
        params[name] = (flat[at:at + size].reshape(shape)
                        * (gain / math.sqrt(shape[1])))
        at += size
    for name, shape, kind, _ in layout:
        if kind == "b":
            params[name] = torch.zeros(shape, device=dev)
        elif kind == "g":
            params[name] = torch.ones(shape, device=dev)
    return {name: params[name].contiguous() for name, *_ in layout}


def aniso_kernel(src, wind, fx, fy, env: dict, z):
    """Gaussian dispersion of one source in one wind at cells (fx, fy) and
    heights ``z`` (the port's ``plume.anisotropic_kernel`` with a height)."""
    r0 = fx - src[0]
    r1 = fy - src[1]
    w0, w1 = wind[0], wind[1]
    speed = torch.sqrt(w0 * w0 + w1 * w1) + 1e-8
    downwind = r0 * (w0 / speed) + r1 * (w1 / speed)
    r2 = r0 ** 2 + r1 ** 2
    cross2 = torch.clamp(r2 - downwind ** 2, min=0.0)
    d = torch.clamp(downwind, min=0.0)
    peak, sy_min, sz_min = env["conc_peak"], env["sigma_y_min"], env["sigma_z_min"]
    sigma = torch.clamp(env["sigma_y_coef"] * d ** env["sigma_y_exp"], min=sy_min)
    centerline = peak * (sy_min / sigma)
    dz = z - env["source_z"]
    sigma_z = torch.clamp(env["sigma_z_coef"] * d ** env["sigma_z_exp"], min=sz_min)
    centerline = centerline * (sz_min / sigma_z)
    vert = torch.exp(-(dz * dz) / (2.0 * sigma_z ** 2))
    blob_vert = torch.exp(-(dz * dz) / (2.0 * sz_min ** 2))
    plume_val = centerline * torch.exp(-cross2 / (2.0 * sigma ** 2)) * vert
    blob = peak * torch.exp(-r2 / (2.0 * sy_min ** 2)) * blob_vert
    return torch.where(downwind >= 0.0, torch.maximum(plume_val, blob), blob)


def make_bank(spec: dict, env: dict, gen: torch.Generator) -> dict:
    """A 3-D bank {"conc" f32[K, F, Z, G, G], "source" f32[K, 2], "wind"
    f32[K, F, 2], "steps_per_frame", "z_extent"} from ``spec`` ``{"fields",
    "frames", "levels", "steps_per_frame", "wind_speed"}``: source uniform
    in [padding, G - padding)^2, a wind of ``wind_speed`` veering from a
    uniform direction by up to one radian across the frames, levels evenly
    over [0, domain_height]."""
    dev = gen.device
    k, nf, nz = spec["fields"], spec["frames"], spec["levels"]
    g = env["grid_size"]
    lo, hi = env["source_padding"], g - env["source_padding"]
    sources = lo + (hi - lo) * torch.rand(k, 2, device=dev, generator=gen)
    theta0 = 2 * math.pi * torch.rand(k, device=dev, generator=gen)
    veer = -1.0 + 2.0 * torch.rand(k, device=dev, generator=gen)
    tfs = torch.linspace(0.0, 1.0, nf, device=dev)
    thetas = theta0[:, None] + veer[:, None] * tfs[None, :]
    wind = spec["wind_speed"] * torch.stack([torch.cos(thetas),
                                             torch.sin(thetas)], -1)
    ze = env["domain_height"]
    levels = torch.linspace(0.0, ze, nz, device=dev)[:, None, None]
    r = torch.arange(g, device=dev).to(torch.float32)
    fx, fy = r[:, None], r[None, :]
    conc = torch.empty(k, nf, nz, g, g, dtype=torch.float32, device=dev)
    for i in range(k):
        for f in range(nf):
            conc[i, f] = aniso_kernel(sources[i], wind[i, f], fx, fy, env,
                                      levels)
    return {"conc": conc, "source": sources, "wind": wind,
            "steps_per_frame": float(spec["steps_per_frame"]),
            "z_extent": float(ze)}


def reads_wind(env: dict) -> bool:
    """Whether the field carries a per-episode wind (and so reset wind
    uniforms are drawn): the anisotropic model with a wind range above 0."""
    return (env["plume_model"] == "anisotropic"
            and env["wind_speed_range"][1] > 0)


def pos_dim(env: dict) -> int:
    return 3 if env["env_3d"] else 2


def num_actions(env: dict) -> int:
    return 7 if env["env_3d"] else 5


def random_bits(shape, gen: torch.Generator) -> torch.Tensor:
    """Uniform 32-bit patterns as int32 (field seeds)."""
    return torch.randint(-(2**31), 2**31, shape, dtype=torch.int32,
                         device=gen.device, generator=gen)


def chunk_draws(env: dict, t: int, n: int, gen: torch.Generator) -> dict:
    """One chunk's randomness: turb_noise f32[T, N, pos_dim], gumbel f32[T,
    N, A], u_src f32[T, N, 2], bits i32[T, N], u_wind f32[T, N, 2] or
    None."""
    dev = gen.device
    tiny = torch.finfo(torch.float32).tiny
    turb = torch.randn(t, n, pos_dim(env), device=dev, generator=gen)
    u = torch.rand(t, n, num_actions(env), device=dev, generator=gen)
    gumbel = -torch.log(-torch.log(torch.clamp(u, min=tiny)))
    u_src = torch.rand(t, n, 2, device=dev, generator=gen)
    bits = random_bits((t, n), gen)
    u_wind = (torch.rand(t, n, 2, device=dev, generator=gen)
              if reads_wind(env) else None)
    return {"turb_noise": turb, "gumbel": gumbel, "u_src": u_src,
            "bits": bits, "u_wind": u_wind}


class Inputs:
    """Every input of one run (module docstring).  ``spec`` is the run's
    ``registry.Spec``; the checked steps' draws come one step at a time
    from ``step(k)``, in order."""

    def __init__(self, spec, seed: int, device):
        self.spec = spec
        self.policy = registry.reference_policy(spec)
        self.gen = torch.Generator(device=device).manual_seed(int(seed))
        env = spec.env
        self.params = make_params(self.policy.layout(spec), self.gen)
        self.bank = (make_bank(spec.bank, env, self.gen)
                     if spec.bank is not None else None)
        n = spec.num_envs
        self.u_src = torch.rand(n, 2, device=self.gen.device,
                                generator=self.gen)
        self.bits = random_bits((n,), self.gen)
        self.u_wind = (torch.rand(n, 2, device=self.gen.device,
                                  generator=self.gen)
                       if reads_wind(env) else None)
        self._next = 0

    def step(self, k: int):
        """(draws dict, the update's shuffles: one per epoch) of checked
        step ``k``; steps are drawn in order 0, 1, 2, ..."""
        if k != self._next:
            raise ValueError(f"checked step {k} drawn out of order "
                             f"(next is {self._next})")
        self._next += 1
        s = self.spec
        draws = chunk_draws(s.env, s.unroll_length, s.num_envs, self.gen)
        return draws, self.policy.shuffles(s, self.gen)
