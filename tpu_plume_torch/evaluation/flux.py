"""Flux inversion over N episodes (port of ``tpu_plume/evaluation/flux.py``).

Given the concentration samples a survey collected along each episode's
track and the dispersion kernel, the per-source strengths are the
least-squares solution of

    c_i  ~=  sum_s  q_s K_s(p_i)

with K_s the unit-strength kernel of source s (the isotropic Gaussian, or
the anisotropic dispersion in the episode's wind).  Saturated samples
(clipped at ``conc_peak``) are left out: the clip breaks linearity.  The
source positions are the true ones, or estimated from the samples alone
(``estimate_sources``: greedy peaks, soft EM, a local log-Gaussian fit, a
residual reseat and a joint Levenberg-Marquardt fit of the mixture).

JAX writes one episode and vmaps it; here every function takes a leading
episode axis: points f32[N, T, 2], concs f32[N, T], sources f32[N, S, 2],
winds f32[N, 2] (or None, the zero wind), heights f32[N, T] in 3-D flight.
Nothing reads the host before the study's final matching; the linear
solves are ``torch.linalg.solve_ex``, which, as ``jnp.linalg.solve``,
returns non-finite values for a singular system instead of raising, so the
``isfinite`` and ``ok`` gates see what JAX's see.

The study (``flux_inversion_study``) flies the surveys through
``env.methane.step_noise`` (one plume-sample launch a step on the card),
never auto-resetting nor freezing an episode, then scores each episode
(``score_survey``) and matches estimates to true sources on the host
(``summarize_flux``).  Its randomness is an ``EvalDraws`` (Gumbel noise
always drawn, as JAX draws it under an oracle too), from a generator on
its device or given.  ``record=``, a dict, collects the estimator's
decisions and their margins (see ``estimate_sources``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import numpy as np
import torch

from tpu_plume_torch.core.config import EnvConfig
from tpu_plume_torch.env.methane import step_noise
from tpu_plume_torch.evaluation import harnesses
from tpu_plume_torch.evaluation.guidance import norm2
from tpu_plume_torch.evaluation.oracle import staircase
from tpu_plume_torch.fields.analytic import FieldState
from tpu_plume_torch.ops import plume

# E|N(0, 1)| + E[0.3 sin cos] + E[0.2 U]: the turbulence's mean over TI
# (fields/analytic.py's model), subtracted before the fits.
_NOISE_MEAN_PER_TI = 0.7978845608 + 0.1


def _noise_mean(cfg: EnvConfig) -> float:
    return cfg.turbulence_intensity * _NOISE_MEAN_PER_TI


def _solve(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a^-1 b for batched a [..., K, K] and b [..., K], with no error
    check (non-finite values where a is singular) and no host read."""
    return torch.linalg.solve_ex(a, b[..., None])[0][..., 0]


def _eye(k: int, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(k, dtype=like.dtype, device=like.device)


def _trace(a: torch.Tensor) -> torch.Tensor:
    return torch.diagonal(a, dim1=-2, dim2=-1).sum(-1)


def design_matrix(points: torch.Tensor, sources: torch.Tensor, wind,
                  cfg: EnvConfig, z: torch.Tensor | None = None
                  ) -> torch.Tensor:
    """A[n, i, s] = the unit-strength kernel of source s of episode n at
    its sample i: f32[N, T, S].  ``wind`` f32[N, 2] or None (a zero wind)
    is read by the anisotropic model only."""
    fx = points[..., 0, None]
    fy = points[..., 1, None]
    src = sources[:, None]
    zz = None if z is None else z[..., None]
    if cfg.plume_model == "anisotropic":
        if wind is None:
            wind = torch.zeros_like(sources[:, 0])
        return plume.anisotropic_kernel(src, wind[:, None, None], fx, fy, cfg,
                                        zz)
    return plume.isotropic_kernel(src, fx, fy, cfg, zz)


def invert_fluxes(points, concs, sources, wind, cfg: EnvConfig, z=None,
                  valid=None, saturation_frac: float = 0.95,
                  ridge: float = 1e-6, debias_noise: bool = True,
                  column_mask=None) -> torch.Tensor:
    """Least-squares strengths q f32[N, S] from the ridge-regularised normal
    equations; invalid (``valid`` bool[N, T] false) and saturated samples
    get zero row weight, and the columns of unsupported sources
    (``column_mask`` bool[N, S] false) are zeroed.  ``debias_noise``
    subtracts the turbulence's mean first."""
    a = design_matrix(points, sources, wind, cfg, z)
    if column_mask is not None:
        a = a * column_mask.to(torch.float32)[:, None, :]
    if debias_noise:
        concs = concs - _noise_mean(cfg)
    w = (concs < saturation_frac * cfg.conc_peak).to(torch.float32)
    if valid is not None:
        w = w * valid.to(torch.float32)
    aw = a * w[..., None]
    awt = aw.transpose(-1, -2)
    ata = awt @ a
    s = a.shape[-1]
    lam = ridge * (_trace(ata) / s + 1e-9)
    return _solve(ata + lam[:, None, None] * _eye(s, a),
                  (awt @ concs[..., None])[..., 0])


def source_observability(points, sources, wind, cfg: EnvConfig, z=None,
                         frac: float = 0.05) -> torch.Tensor:
    """bool[N, S]: some sample of the episode saw at least ``frac`` of
    source s's unit-strength peak."""
    a = design_matrix(points, sources, wind, cfg, z)
    return a.amax(1) >= frac * cfg.conc_peak


def _greedy_peaks(points, concs, num_sources: int, radius: float,
                  record: dict | None):
    """S rounds of: the highest sample not within ``radius`` of an
    earlier pick (the first on ties, as ``jnp.argmax``)."""
    rows = torch.arange(points.shape[0], device=points.device)
    masked = concs
    peaks, picks, gaps = [], [], []
    for _ in range(num_sources):
        i = torch.argmax(masked, -1)
        p = points[rows, i]
        picks.append(i)
        if record is not None and masked.shape[-1] > 1:
            top2 = torch.topk(masked, 2, -1).values
            gaps.append(top2[:, 0] - top2[:, 1])
        far = norm2(points - p[:, None]) > radius
        masked = torch.where(far, masked, -1.0)
        peaks.append(p)
    if record is not None:
        record["pick"] = torch.stack(picks, 1)
        if gaps:
            record["pick_gap"] = torch.stack(gaps, 1)
    return torch.stack(peaks, 1)


def estimate_sources(points, concs, num_sources: int, cfg: EnvConfig,
                     suppress_radius: float | None = None, em_iters: int = 8,
                     return_strengths: bool = False, reseat_iters: int = 1,
                     record: dict | None = None):
    """Source positions f32[N, S, 2] from the samples alone (JAX's five
    stages): greedy peak picking with a ``suppress_radius`` (3 sigma), the
    conc^3-weighted soft EM and log-Gaussian refinement
    (``refine_positions``); on the isotropic plume with S > 1 the residual
    reseat of a duplicate candidate onto an unexplained residual peak;
    and on the isotropic plume the joint LM fit (``joint_refine``), kept
    for a source whose 8 angular sectors within 3 sigma all hold an
    unsaturated sample.  With ``return_strengths`` also the strengths
    f32[N, S] of the local fits (or of the joint fit where kept).

    ``record``, a dict, receives each decision and its margin: ``pick``
    and ``pick_gap`` (the winning sample's lead), ``ok`` / ``beta3`` /
    ``mu_rel_norm`` of each log-Gaussian fit and the EM's candidates it
    fitted (``em_peaks``; lists, one per call),
    ``reseat`` and ``reseat_margin`` (the residual peak over its bound),
    ``take`` and ``sse_gain`` per LM step, ``good`` and ``hits``."""
    if suppress_radius is None:
        suppress_radius = 3.0 * cfg.plume_sigma
    peaks = _greedy_peaks(points, concs, num_sources, suppress_radius, record)
    mus, qs = refine_positions(points, concs, peaks, cfg, em_iters=em_iters,
                               return_strengths=True, record=record)
    if reseat_iters and cfg.plume_model == "isotropic" and num_sources > 1:
        for _ in range(reseat_iters):
            seeds = _reseat_seeds(points, concs, mus, qs, cfg, record)
            mus, qs = refine_positions(points, concs, seeds, cfg, em_iters=0,
                                       return_strengths=True, record=record)
    if cfg.plume_model == "isotropic":
        mus_j, qs_j = joint_refine(points, concs, mus, qs, cfg,
                                   record=record)
        good = _coverage_good(points, concs, mus_j, cfg, record)
        mus = torch.where(good[..., None], mus_j, mus)
        qs = torch.where(good, qs_j, qs)
    if return_strengths:
        return mus, qs
    return mus


def _reseat_seeds(points, concs, mus, qs, cfg: EnvConfig, record):
    """One residual reseat round (JAX's stage 4): where a candidate is a
    weaker duplicate of another (within 1.6 sigma) and the residual of the
    fitted field keeps a peak above 0.1 peak away (1.5 sigma) from every
    candidate, the weakest duplicate moves to that peak."""
    s = mus.shape[1]
    dup_r = 1.6 * cfg.plume_sigma
    a = design_matrix(points, mus, None, cfg)
    resid = (torch.clamp(concs - _noise_mean(cfg), min=0.0)
             - (a @ qs[..., None])[..., 0])
    dmat = norm2(mus[:, :, None, :] - mus[:, None, :, :])
    idx = torch.arange(s, device=mus.device)
    stronger = (qs[:, None, :] > qs[:, :, None]) | (
        (qs[:, None, :] == qs[:, :, None]) & (idx[None, :] < idx[:, None]))
    dup = ((dmat < dup_r) & stronger & (idx[None, :] != idx[:, None])).any(-1)
    dc = norm2(points[:, :, None, :] - mus[:, None, :, :]).amin(-1)
    rmask = dc > 1.5 * cfg.plume_sigma
    rp = torch.argmax(torch.where(rmask, resid, -math.inf), -1)
    rows = torch.arange(mus.shape[0], device=mus.device)
    peak_resid = resid[rows, rp]
    do = dup.any(-1) & (peak_resid > 0.1 * cfg.conc_peak) & rmask.any(-1)
    worst = torch.argmin(torch.where(dup, qs, math.inf), -1)
    repl = (idx[None, :] == worst[:, None]) & do[:, None]
    if record is not None:
        record["reseat"] = do
        record["reseat_margin"] = peak_resid - 0.1 * cfg.conc_peak
    return torch.where(repl[..., None], points[rows, rp][:, None], mus)


def _coverage_good(points, concs, mus, cfg: EnvConfig, record):
    """bool[N, S]: all 8 angular sectors within 3 sigma of each refined
    position hold an unsaturated sample (JAX's coverage gate; its
    ``.at[].max`` over the sectors is a one-hot ``any`` here)."""
    rel = points[:, :, None, :] - mus[:, None, :, :]           # [N, T, S, 2]
    dist = norm2(rel)
    ang = torch.atan2(rel[..., 1], rel[..., 0])
    sector = torch.clamp(torch.floor((ang + math.pi) / (math.pi / 4.0)),
                         0, 7).to(torch.int64)
    near = (dist < 3.0 * cfg.plume_sigma) & (
        concs[..., None] < 0.95 * cfg.conc_peak)
    hit = (torch.nn.functional.one_hot(sector, 8).to(torch.bool)
           & near[..., None]).any(1)                          # [N, S, 8]
    hits = hit.sum(-1)
    if record is not None:
        record["good"] = hits >= 8
        record["hits"] = hits
    return hits >= 8


def joint_refine(points, concs, mus, qs, cfg: EnvConfig, iters: int = 8,
                 lm: float = 1e-2, record: dict | None = None):
    """Joint Levenberg-Marquardt over (mu_s / sigma, log q_s) of the
    isotropic mixture, ``iters`` steps; a step is kept only where it lowers
    the weighted SSE.  Returns (mu f32[N, S, 2], q f32[N, S])."""
    n, s = mus.shape[:2]
    sig = max(cfg.plume_sigma, 1e-3)
    cd = torch.clamp(concs - _noise_mean(cfg), min=0.0)
    w = (concs < 0.95 * cfg.conc_peak).to(torch.float32)

    def model(theta):
        mu = theta[:, :2 * s].reshape(n, s, 2) * sig
        q = torch.exp(theta[:, 2 * s:])
        d2 = ((points[:, :, None, :] - mu[:, None, :, :]) ** 2).sum(-1)
        k = cfg.conc_peak * torch.exp(-d2 / (2.0 * sig ** 2))  # [N, T, S]
        return (k @ q[..., None])[..., 0], k, mu, q

    def sse(m):
        return (w * (cd - m) ** 2).sum(-1)

    theta = torch.cat([(mus / sig).reshape(n, 2 * s),
                       torch.log(torch.clamp(qs, 1e-3, 1e3))], -1)
    takes, gains = [], []
    for _ in range(iters):
        m, k, mu, q = model(theta)
        r = cd - m
        kq = k * q[:, None, :]
        rel = (points[:, :, None, :] - mu[:, None, :, :]) / sig
        j_mu = kq[..., None] * rel
        jac = torch.cat([j_mu.reshape(n, -1, 2 * s), kq], -1)  # [N, T, 3S]
        jwt = (jac * w[..., None]).transpose(-1, -2)
        jtj = jwt @ jac
        g = (jwt @ r[..., None])[..., 0]
        damp = lm * (_trace(jtj) / (3 * s) + 1e-9)
        delta = _solve(jtj + damp[:, None, None] * _eye(3 * s, jtj), g)
        cand = theta + torch.clamp(delta, -1.0, 1.0)
        gain = sse(m) - sse(model(cand)[0])
        take = gain > 0
        theta = torch.where(take[:, None], cand, theta)
        takes.append(take)
        gains.append(gain)
    if record is not None:
        record["take"] = torch.stack(takes, 1)
        record["sse_gain"] = torch.stack(gains, 1)
    mu = theta[:, :2 * s].reshape(n, s, 2) * sig
    return mu, torch.exp(theta[:, 2 * s:])


def refine_positions(points, concs, peaks, cfg: EnvConfig,
                     em_iters: int = 8, return_strengths: bool = False,
                     record: dict | None = None):
    """EM and log-Gaussian refinement of given candidates f32[N, S, 2],
    row s refining row s: ``em_iters`` soft-EM steps (conc^3-weighted
    centroids of softmax responsibilities over a sigma-wide kernel), then
    per candidate a weighted LLS of log c on [1, x, y, x^2 + y^2] in
    coordinates centred at the candidate and scaled by sigma, whose vertex
    is kept where it is a maximum within 2 sigma (``ok``), with the
    strength from the same fit."""
    w = torch.clamp(concs, min=0.0) ** 3
    scale = max(cfg.plume_sigma, 1e-3)

    def responsibilities(peaks):
        d2 = ((points[:, :, None, :] - peaks[:, None, :, :]) ** 2).sum(-1)
        return torch.softmax(-d2 / (2.0 * scale ** 2), -1)    # [N, T, S]

    for _ in range(em_iters):
        rw = responsibilities(peaks) * w[..., None]
        denom = rw.sum(1) + 1e-9
        peaks = ((rw[..., None] * points[:, :, None, :]).sum(1)
                 / denom[..., None])

    logc = torch.log(torch.clamp(concs - _noise_mean(cfg), min=1e-3))
    resp = responsibilities(peaks).transpose(1, 2)            # [N, S, T]
    unsat = (concs < 0.95 * cfg.conc_peak).to(torch.float32)
    rel = (points[:, None, :, :] - peaks[:, :, None, :]) / scale
    r2 = (rel ** 2).sum(-1)                                   # [N, S, T]
    feats = torch.stack([torch.ones_like(r2), rel[..., 0], rel[..., 1], r2],
                        -1)                                   # [N, S, T, 4]
    wt = (resp * unsat[:, None] * torch.exp(-0.5 * r2)
          * torch.clamp(concs, min=0.0)[:, None] ** 2)
    xtw = feats.transpose(-1, -2) * wt[..., None, :]          # [N, S, 4, T]
    beta = _solve(xtw @ feats + 1e-6 * _eye(4, feats),
                  (xtw @ logc[:, None, :, None])[..., 0])     # [N, S, 4]
    mu_rel = beta[..., 1:3] / (-2.0 * beta[..., 3] + 1e-12)[..., None]
    mu_rel_norm = norm2(mu_rel)
    ok = (beta[..., 3] < 0) & (mu_rel_norm <= 2.0)
    mu = torch.where(ok[..., None], peaks + mu_rel * scale, peaks)
    mu_rel = torch.where(ok[..., None], mu_rel, 0.0)
    log_qp = torch.clamp(beta[..., 0] - beta[..., 3] * (mu_rel ** 2).sum(-1),
                         -20.0, 12.0)
    q = torch.exp(log_qp) / cfg.conc_peak
    q = torch.where(ok & torch.isfinite(q), q, 0.0)
    if record is not None:
        for key, value in (("em_peaks", peaks), ("ok", ok),
                           ("beta3", beta[..., 3]),
                           ("mu_rel_norm", mu_rel_norm)):
            record.setdefault(key, []).append(value)
    if return_strengths:
        return mu, q
    return mu


@dataclasses.dataclass
class Survey:
    """What the surveys of N episodes collected, episode-first."""

    points: torch.Tensor          # f32[N, T, 2] positions after each step
    z: torch.Tensor | None        # f32[N, T] heights (3-D flight), else None
    concs: torch.Tensor           # f32[N, T] concentrations there
    field: FieldState             # each episode's plume
    seeds: torch.Tensor | None    # f32[N, S, 2] pass-1 estimates (two-pass)


def _fly(env_state, obs, cfg, draws, choose, rows):
    """One env step for each draws row of ``rows``, each action from
    ``choose(env_state, obs, t)``; returns the last state and observation
    and the positions, heights and concentrations after each step."""
    pts, zs, concs = [], [], []
    for t in rows:
        action = choose(env_state, obs, t)
        env_state, trans = step_noise(env_state, action, draws.turb_noise[t],
                                      cfg)
        obs = trans.obs
        pts.append(env_state.pos[:, :2])
        if cfg.env_3d:
            zs.append(env_state.pos[:, 2])
        concs.append(trans.info.conc_raw)
    return env_state, obs, pts, zs, concs


@torch.no_grad()
def fly_survey(cfg: EnvConfig, env_state, obs, draws, num_steps: int,
               policy=None, oracle: Optional[Callable] = None,
               refine_steps: int = 0) -> Survey:
    """Fly the surveys of freshly reset episodes (``env_state``, ``obs``)
    for ``num_steps`` steps with ``draws`` (an ``EvalDraws``): each step's
    action from ``oracle(env_state)``, else argmax(``policy(obs)``'s logits
    + Gumbel noise), else argmax(Gumbel noise), a uniform random walk.
    With ``refine_steps`` > 0, pass 1 takes the first ``num_steps -
    refine_steps`` steps; then each episode's sources are estimated and
    pass 2 chases, along the staircase, waypoints at each estimate and on
    an 8-point ring of ``move_step`` radius around it, a waypoint counting
    as reached within 0.6 ``move_step`` or passed after 12 stuck steps."""
    steps_p1 = num_steps - refine_steps
    if steps_p1 <= 0:
        raise ValueError(f"refine_steps={refine_steps} leaves no pass-1 "
                         f"step of num_steps={num_steps}")
    n = obs.shape[0]

    def choose(state, obs, t):
        if oracle is not None:
            return oracle(state)
        if policy is not None:
            logits, _ = policy(obs)
            return torch.argmax(logits + draws.gumbel[t], -1)
        return torch.argmax(draws.gumbel[t], -1)

    env_state, obs, pts, zs, concs = _fly(env_state, obs, cfg, draws, choose,
                                          range(steps_p1))
    seeds = None
    if refine_steps > 0:
        dev = obs.device
        seeds = estimate_sources(torch.stack(pts, 1), torch.stack(concs, 1),
                                 cfg.num_sources, cfg)
        r = torch.tensor(float(cfg.move_step), device=dev)
        ang = torch.arange(8, dtype=torch.float32, device=dev) * (
            2 * math.pi / 8)
        ring = r * torch.stack([torch.cos(ang), torch.sin(ang)], -1)
        offs = torch.cat([torch.zeros(1, 2, device=dev), ring])   # [9, 2]
        wps = (seeds[:, :, None, :] + offs).reshape(n, -1, 2)    # [N, W, 2]
        n_wp = wps.shape[1]
        rows = torch.arange(n, device=dev)
        carry = [torch.zeros(n, dtype=torch.int64, device=dev),
                 torch.zeros(n, dtype=torch.int64, device=dev)]

        def chase(state, obs, t):
            wp_idx, stuck = carry
            to = wps[rows, wp_idx] - state.pos[:, :2]
            adv = (norm2(to) <= 0.6 * r) | (stuck >= 12)
            carry[0] = torch.clamp(wp_idx + adv.to(torch.int64),
                                   max=n_wp - 1)
            carry[1] = torch.where(adv, 0, stuck + 1)
            return staircase(to)

        env_state, _, pts2, zs2, concs2 = _fly(
            env_state, obs, cfg, draws, chase, range(steps_p1, num_steps))
        pts, zs, concs = pts + pts2, zs + zs2, concs + concs2
    return Survey(points=torch.stack(pts, 1),
                  z=torch.stack(zs, 1) if cfg.env_3d else None,
                  concs=torch.stack(concs, 1), field=env_state.field,
                  seeds=seeds)


@torch.no_grad()
def score_survey(survey: Survey, cfg: EnvConfig, estimated_positions: bool,
                 record: dict | None = None):
    """Each episode's estimated strengths, true strengths, estimated and
    true sources and the observed flags (JAX's ``one``): q_est f32[N, S],
    q_true f32[N, S], srcs f32[N, S, 2], srcs_true f32[N, S, 2], observed
    bool[N, S].  Estimated positions come from ``estimate_sources``, or,
    after a two-pass survey, from refining its pass-1 seeds on all the
    samples; on the isotropic plume the strengths are the local fits',
    elsewhere ``invert_fluxes`` at the positions used."""
    field, p, c, zq = survey.field, survey.points, survey.concs, survey.z
    srcs_true = plume.all_sources(field.source, field.seed, cfg)
    q_true = plume.source_strengths(field.seed, cfg)
    if estimated_positions:
        if survey.seeds is not None:
            srcs, q_local = refine_positions(p, c, survey.seeds, cfg,
                                             em_iters=0,
                                             return_strengths=True,
                                             record=record)
        else:
            srcs, q_local = estimate_sources(p, c, cfg.num_sources, cfg,
                                             return_strengths=True,
                                             record=record)
        if cfg.plume_model == "isotropic":
            q_est = q_local
        else:
            q_est = invert_fluxes(p, c, srcs, field.wind, cfg, z=zq)
    else:
        srcs = srcs_true
        q_est = invert_fluxes(p, c, srcs, field.wind, cfg, z=zq)
    observed = source_observability(p, srcs_true, field.wind, cfg, z=zq)
    return q_est, q_true, srcs, srcs_true, observed


def summarize_flux(q_est, q_true, srcs_est, srcs_true, observed,
                   estimated_positions: bool) -> dict:
    """JAX's summary on the host: each estimate greedily matched to its
    nearest true source (closest pair first), the relative strength error
    and position error of each true source, their statistics over the
    observed sources, and with ``estimated_positions`` the position errors
    and the shares localized within 20 px."""
    q_est, q_true, srcs_est, srcs_true, observed = (
        x.cpu().numpy() for x in (q_est, q_true, srcs_est, srcs_true,
                                  observed))
    n, s = q_true.shape
    rel = np.empty_like(q_true)
    pos_err = np.empty_like(q_true)
    for ep in range(n):
        d = np.linalg.norm(
            srcs_est[ep][:, None, :] - srcs_true[ep][None, :, :], axis=-1)
        assigned = np.full(s, -1)
        dd = d.copy()
        for _ in range(s):
            i, j = np.unravel_index(np.argmin(dd), dd.shape)
            assigned[i] = j
            dd[i, :] = np.inf
            dd[:, j] = np.inf
        for i in range(s):
            j = assigned[i]
            rel[ep, j] = abs(q_est[ep, i] - q_true[ep, j]) / q_true[ep, j]
            pos_err[ep, j] = d[i, j]

    rel_obs = rel[observed]
    pos_obs = pos_err[observed]
    nan = float("nan")
    out = {
        "episodes": n,
        "sources": int(s),
        "estimated_positions": bool(estimated_positions),
        "observed_frac": float(observed.mean()),
        "mean_rel_error": float(rel_obs.mean()) if rel_obs.size else nan,
        "median_rel_error": (float(np.median(rel_obs)) if rel_obs.size
                             else nan),
        "p90_rel_error": (float(np.quantile(rel_obs, 0.9)) if rel_obs.size
                          else nan),
        "within_20pct": (float((rel_obs < 0.2).mean()) if rel_obs.size
                         else 0.0),
    }
    if estimated_positions:
        loc = observed & (pos_err <= 20.0)
        rel_loc = rel[loc]
        out.update({
            "mean_pos_error": float(pos_obs.mean()) if pos_obs.size else nan,
            "median_pos_error": (float(np.median(pos_obs)) if pos_obs.size
                                 else nan),
            "pos_within_20px": (float((pos_obs <= 20.0).mean())
                                if pos_obs.size else 0.0),
            "localized_frac": float(loc.mean()),
            "mean_rel_error_localized": (float(rel_loc.mean())
                                         if rel_loc.size else nan),
            "median_rel_error_localized": (float(np.median(rel_loc))
                                           if rel_loc.size else nan),
            "within_20pct_localized": (float((rel_loc < 0.2).mean())
                                       if rel_loc.size else 0.0),
        })
    return out


def check_flux_env(cfg: EnvConfig) -> None:
    """The study reads the analytic plume's kernels: a gridded bank has
    none (JAX's study cannot reset one either)."""
    if cfg.plume_model == "gridded":
        raise ValueError(
            'the flux study inverts the analytic plume\'s kernels; '
            'plume_model="gridded" has none (and the study reads no bank): '
            'use "isotropic" or "anisotropic"')


def flux_inversion_study(cfg: EnvConfig, generator=None,
                         num_episodes: int = 64, num_steps: int = 400,
                         policy=None, estimated_positions: bool = False,
                         oracle: Optional[Callable] = None,
                         refine_steps: int = 0, draws=None,
                         device=None) -> dict:
    """Fly ``num_episodes`` surveys of ``num_steps`` steps (``fly_survey``:
    ``oracle``, else the MLP ``policy`` sampled with Gumbel noise, else a
    random walk; two passes with ``refine_steps``), score each episode
    (``score_survey``, at the true positions or, with
    ``estimated_positions``, estimated ones) and return JAX's summary dict
    (``summarize_flux``).

    ``device`` defaults to ``cuda`` and raises without a card; pass
    ``"cpu"`` for the CPU.  The policy (in place) and the draws are moved
    there; ``generator``, on that device, draws the randomness unless
    ``draws`` (an ``EvalDraws`` of ``num_steps`` steps with Gumbel noise)
    gives it."""
    check_flux_env(cfg)
    if oracle is not None:
        policy = None
    _, policy, _, draws, env_state, obs = harnesses._start(
        policy, cfg, device, generator, draws, num_episodes, num_steps,
        False, None, None)
    survey = fly_survey(cfg, env_state, obs, draws, num_steps, policy=policy,
                        oracle=oracle, refine_steps=refine_steps)
    return summarize_flux(*score_survey(survey, cfg, estimated_positions),
                          estimated_positions)
