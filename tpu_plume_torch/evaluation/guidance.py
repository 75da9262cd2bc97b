"""Model-based terminal guidance: online source trilateration and crossing
phase control over N episodes (port of ``tpu_plume/evaluation/guidance.py``).

Under the reference eval protocol the episode ends at the first crossing of
the radius-50 goal ball, and a 25-px move crossing on a random chord lands
anywhere in (25, 50]: the guide locates the source from the agent's own
samples and times the final step so the crossing lands deep.

  - It inverts the isotropic plume model ``conc = peak*exp(-d^2/2sigma^2)``
    at every visited cell into a distance ring ``r_i`` and solves the
    weighted linear least-squares trilateration for the source from the
    flight's sample history (a rank-2 normal system, closed form).
  - Once the estimate is well conditioned it steers with a 5-way lookahead
    (``phase_action``): a crossing step only when it lands deeper than
    ``deep_target``, otherwise a maneuver outside the goal ball that sets up
    a radial final step.  Before that, a hover state machine bounces around
    the readable annulus to gather 2-D sample spread.

The JAX package writes one episode's scalar state machine and vmaps it; here
every register of ``GuideState`` carries the episode axis first ([N] and the
ring buffers [N, K, ...]).  ``guide_init`` returns one episode's state (no
episode axis), as JAX's does; ``stop.controllers.broadcast`` gives each of N
episodes its copy.  ``guide_step`` steps the batch with branch-free
``torch.where`` updates (one-hot slot writes into the rings), so it never
reads the device from the host.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from dataclasses import dataclass

import torch

from tpu_plume_torch.core.config import EnvConfig
from tpu_plume_torch.env.methane import action_table


@dataclass(frozen=True)
class GuideConfig:
    """The guide's thresholds (JAX's ``GuideConfig``, whose comments give
    the measurements behind each default; ``derive_guide_config`` scales
    them to a preset's physics)."""

    buffer_size: int = 128
    # accepted debiased conc/peak band of a sample
    conc_floor: float = 0.03
    conc_ceil: float = 0.98
    # inlier samples after the robust cut
    min_samples: int = 5
    # posterior worst-direction standard error (px) the fit must reach
    max_se: float = 6.0
    # weighted RMS radial residual (px) bound
    max_residual: float = 12.0
    # goal-ball radius the episode terminates at
    terminate_radius: float = 50.0
    # ideal landing depth, and the acceptance bound of a crossing
    deep_target: float = 30.0
    deep_take: float = 34.0
    # hover entry: one >= enter_strong read, or a readable step followed by
    # an >= enter_weak read (debiased conc_n units)
    enter_weak: float = 0.045
    enter_strong: float = 0.06
    # preferred pre-crossing distance (setup - move must be <= deep_target)
    setup_distance: float = 54.0
    # hover band: the pointwise distance is trusted above point_floor;
    # inward probes only from probe_in_min out
    point_floor: float = 0.03
    probe_in_min: float = 80.0
    # consecutive sub-floor steps before hover concedes the plume was lost
    lost_patience: int = 10
    # absolute floor of the robust residual cut (px)
    resid_floor: float = 12.0
    # fit-vs-pointwise cross-check above cross_check_conc, to a tolerance
    cross_check_conc: float = 0.06
    cross_check_tol: float = 10.0
    # |delta d_hat| across one move that counts as a radial measurement
    radial_move_min: float = 6.0
    # latch the dive on the first validated fit
    commit_on_ok: bool = True
    # stuck-hover fallback dive (<= 0 disables) and its gates
    fallback_patience: int = 480
    fallback_min_inliers: int = 20
    max_se_fallback: float | None = None
    # radial calibration of the dive against the pointwise distance
    bias_alpha: float = 0.5
    bias_conc_min: float = 0.06
    bias_clip: float = 12.0
    # widen the take band after this many committed steps (0 disables)
    take_relax_age: int = 0
    take_relax_to: float = 38.0
    # consecutive far reads before an inward hover probe
    probe_consistency: int = 1
    # hover out-steps follow the remembered per-axis inward signs
    sign_aware_out: bool = False
    # phantom-estimate refutation (0 disables)
    phantom_patience: int = 3
    phantom_margin: float = 5.0
    # committed steps before a crossing may be taken (0/1 disable)
    dive_warmup: int = 0
    # hover safety veto (0 disables; measured negative in JAX)
    hover_veto_margin: float = 0.0
    veto_min_inliers: int = 10
    veto_se: float = 12.0
    # estimate-aware hover geometry (off by default in JAX)
    est_signs: bool = False
    est_sign_min: float = 25.0
    tangential_band: float = 0.0
    # blend of each validated fix into the committed estimate (1 = replace)
    est_ema: float = 0.2


# std of (|N(0,1)| + 0.3 sin*cos + 0.2 U) per unit TI
_NOISE_STD_FRAC = 0.623


def derive_guide_config(
    cfg: EnvConfig,
    terminate_radius: float = 50.0,
    success_radius: float = 40.0,
) -> GuideConfig:
    """Every guide threshold from the field physics (sigma, TI, peak, the
    move step) and the protocol (terminator, success distance), as JAX's
    ``derive_guide_config`` derives them.

    Raises ``ValueError`` when the readable annulus ends inside the goal
    ball (e.g. ppo_v2_1's sigma-15 plume under the radius-50 protocol):
    there is then no signal to trilaterate from without ending the
    episode."""
    noise_n = _NOISE_STD_FRAC * cfg.turbulence_intensity / cfg.conc_peak
    sigma = float(cfg.plume_sigma)
    move = cfg.grid_size * cfg.move_frac

    conc_floor = 1.6 * noise_n
    r_max = sigma * math.sqrt(2.0 * math.log(1.0 / max(conc_floor, 1e-9)))
    if r_max < terminate_radius + 2.0:
        raise ValueError(
            f"hover-outside guidance infeasible: the plume is readable only "
            f"to r~{r_max:.0f} px (sigma={sigma}, conc floor "
            f"{conc_floor:.3f}) but the episode terminates at d<="
            f"{terminate_radius} — every usable sample is inside the goal "
            f"ball.  Use a smaller --goal-radius (precision protocol) or "
            f"the learned localizer (--guide learned)."
        )

    def r_of(c):
        return sigma * math.sqrt(2.0 * math.log(1.0 / max(c, 1e-9)))

    def r_err(c):
        return sigma**2 * noise_n / (r_of(c) * c)

    deep = min(success_radius - 10.0, 0.8 * terminate_radius)
    return GuideConfig(
        deep_take=min(success_radius - 6.0, 0.9 * terminate_radius),
        conc_floor=conc_floor,
        enter_weak=2.4 * noise_n,
        enter_strong=3.3 * noise_n,
        point_floor=conc_floor,
        terminate_radius=terminate_radius,
        deep_target=deep,
        setup_distance=deep + move - 1.0,
        max_se=min(6.0, max(1.5, 0.8 * deep)),
        probe_in_min=terminate_radius + move + 5.0,
        resid_floor=2.9 * r_err(2.0 * conc_floor),
        max_residual=2.9 * r_err(2.0 * conc_floor),
        cross_check_conc=3.3 * noise_n,
        cross_check_tol=2.5 * r_err(3.3 * noise_n),
        radial_move_min=0.24 * move,
        bias_conc_min=3.3 * noise_n,
        bias_clip=1.2 * 2.5 * r_err(3.3 * noise_n),
    )


@dataclass
class GuideState:
    """One register per field, the episode axis first in a batch."""

    pos_buf: torch.Tensor    # f32[K, 2] sample positions
    r2_buf: torch.Tensor     # f32[K] inverted squared source distances
    w_buf: torch.Tensor      # f32[K] sample weights (0 = empty slot)
    count: torch.Tensor      # i32 accepted samples (monotonic)
    est: torch.Tensor        # f32[2] source estimate
    est_ok: torch.Tensor     # bool
    # hover state machine
    mode: torch.Tensor       # i32: 0 = defer to the policy, 1 = hover
    d_prev: torch.Tensor     # f32 last trusted pointwise distance
    d_prev_ok: torch.Tensor  # bool
    last_action: torch.Tensor  # i32 action the guide returned last step
    sign_x: torch.Tensor     # f32 +-1: x direction judged inward
    know_x: torch.Tensor     # bool
    mag_x: torch.Tensor      # f32 |last radial delta| on x moves
    sign_y: torch.Tensor
    know_y: torch.Tensor
    mag_y: torch.Tensor
    axis_next: torch.Tensor  # i32 0 = x, 1 = y (probe alternator)
    low_count: torch.Tensor  # i32 consecutive sub-floor steps
    streak: torch.Tensor     # i32 consecutive readable steps
    best_conc: torch.Tensor  # f32 highest conc_n contact so far
    best_pos: torch.Tensor   # f32[2] its position
    committed: torch.Tensor  # bool: dive commitment latched
    est_good: torch.Tensor   # f32[2] last estimate that passed the gates
    hover_age: torch.Tensor  # i32 consecutive steps in hover
    rad_bias: torch.Tensor   # f32 EMA of (est-implied - pointwise) distance
    bias_ok: torch.Tensor    # bool: rad_bias has been measured
    commit_age: torch.Tensor  # i32 steps since the commitment latched
    far_count: torch.Tensor  # i32 consecutive reads beyond probe_in_min
    phantom_count: torch.Tensor  # i32 consecutive alive-inside-the-ball steps


def guide_init(gcfg: GuideConfig) -> GuideState:
    """One episode's initial state, on the CPU."""
    k = gcfg.buffer_size
    f32, i32 = torch.float32, torch.int32

    def z():
        return torch.zeros((), dtype=f32)

    def zi():
        return torch.zeros((), dtype=i32)

    def zb():
        return torch.zeros((), dtype=torch.bool)

    return GuideState(
        pos_buf=torch.zeros(k, 2, dtype=f32), r2_buf=torch.zeros(k, dtype=f32),
        w_buf=torch.zeros(k, dtype=f32), count=zi(),
        est=torch.zeros(2, dtype=f32), est_ok=zb(), mode=zi(), d_prev=z(),
        d_prev_ok=zb(), last_action=zi(), sign_x=torch.ones((), dtype=f32),
        know_x=zb(), mag_x=torch.full((), 99.0, dtype=f32),
        sign_y=torch.ones((), dtype=f32), know_y=zb(),
        mag_y=torch.full((), 99.0, dtype=f32), axis_next=zi(),
        low_count=zi(), streak=zi(), best_conc=z(),
        best_pos=torch.zeros(2, dtype=f32), committed=zb(),
        est_good=torch.zeros(2, dtype=f32), hover_age=zi(), rad_bias=z(),
        bias_ok=zb(), commit_age=zi(), far_count=zi(), phantom_count=zi(),
    )


def norm2(x: torch.Tensor) -> torch.Tensor:
    """The Euclidean norm over the last axis, sqrt(sum(x * x)), as
    ``jnp.linalg.norm`` computes it."""
    return torch.sqrt((x * x).sum(-1))


def _wlls(pos, r2, w):
    """One weighted LLS trilateration pass per episode: pos f32[N, K, 2],
    r2 and w f32[N, K].  Each sample satisfies |p|^2 - 2 x_i . p + |x_i|^2
    = r_i^2; subtracting the weighted-mean equation leaves the rank-2
    system (x_i - xbar) . p = (ubar - u_i)/2 with u_i = r_i^2 - |x_i|^2.
    Returns (est [N, 2], resid_rms, se, wsum), each [N] but est."""
    wsum = w.sum(-1) + 1e-9
    xbar = (w[..., None] * pos).sum(-2) / wsum[:, None]
    u = r2 - (pos ** 2).sum(-1)
    ubar = (w * u).sum(-1) / wsum
    dx = pos - xbar[:, None]                       # [N, K, 2]
    c = 0.5 * (ubar[:, None] - u)                  # [N, K]
    m = (w[..., None, None] * dx[..., :, None] * dx[..., None, :]).sum(-3)
    v = (w[..., None] * c[..., None] * dx).sum(-2)  # [N, 2]
    m00, m01, m10, m11 = m[:, 0, 0], m[:, 0, 1], m[:, 1, 0], m[:, 1, 1]
    det = m00 * m11 - m01 * m10
    inv = torch.stack([torch.stack([m11, -m01], -1),
                       torch.stack([-m10, m00], -1)], -2) / (det + 1e-9)[
                           :, None, None]
    est = (inv * v[:, None, :]).sum(-1)
    tr = m00 + m11
    lam_min = 0.5 * (tr - torch.sqrt(torch.clamp(tr ** 2 - 4.0 * det,
                                                 min=0.0)))
    d_est = norm2(pos - est[:, None])
    resid = torch.sqrt(
        (w * (d_est - torch.sqrt(torch.clamp(r2, min=0.0))) ** 2).sum(-1)
        / wsum)
    # posterior worst-direction standard error of est (px): per-unit-weight
    # residual variance of the linear system over its smallest eigenvalue
    e_lin = (dx * est[:, None]).sum(-1) - c
    n_eff = (w > 0).sum(-1).to(torch.float32)
    sigma0 = (w * e_lin ** 2).sum(-1) / torch.clamp(n_eff, min=1.0)
    se = torch.sqrt(sigma0 / torch.clamp(lam_min, min=1e-6))
    return est, resid, se, wsum


def _solve_estimate(gs: GuideState, gcfg: GuideConfig):
    """Robust trilateration: WLLS and two reweighting passes that drop the
    samples whose radial residual exceeds 2.5 x the weighted median
    (floored at ``resid_floor``).  Returns (est, ok, se, n_eff)."""
    w = gs.w_buf
    est, resid, se, wsum = _wlls(gs.pos_buf, gs.r2_buf, w)
    ring = torch.sqrt(torch.clamp(gs.r2_buf, min=0.0))
    k = w.shape[-1]
    for _ in range(2):
        err = torch.abs(norm2(gs.pos_buf - est[:, None]) - ring)
        # the weighted median of the errors: the first sorted sample whose
        # cumulative weight reaches half the total (ties in sample order)
        order = torch.argsort(err, dim=-1, stable=True)
        cum = torch.cumsum(torch.gather(w, -1, order), -1)
        at = torch.searchsorted(cum, 0.5 * w.sum(-1, keepdim=True))
        at = torch.clamp(at, max=k - 1)
        med = torch.gather(err, -1, torch.gather(order, -1, at))[:, 0]
        keep = err <= torch.clamp(2.5 * med, min=gcfg.resid_floor)[:, None]
        w = gs.w_buf * keep
        est, resid, se, wsum = _wlls(gs.pos_buf, gs.r2_buf, w)
    n_eff = (w > 0).sum(-1)
    ok = ((n_eff >= gcfg.min_samples) & (se <= gcfg.max_se)
          & (resid <= gcfg.max_residual))
    return est, ok, se, n_eff


def phase_action(pos2, est, cfg: EnvConfig, terminate_radius: float,
                 deep_target: float, setup_distance: float,
                 deep_take=None, radial_bias=0.0) -> torch.Tensor:
    """Crossing-phase control from source estimates, per episode: pos2 and
    est f32[N, 2] -> i64[N] action.  A two-step lookahead that takes a
    goal-ball crossing only when it lands within ``deep_take`` (default
    ``deep_target``) of the estimate, otherwise maneuvers without crossing
    toward a position whose next step can land near ``deep_target``.
    ``deep_take`` and ``radial_bias`` (the measured est-implied minus
    pointwise distance, subtracted from every est-implied distance) may be
    floats or f32[N].  Ties go to the first action, as ``jnp.argmin``'s."""
    take = deep_target if deep_take is None else deep_take

    def per_env(x, axes):
        # a float, or an f32[N] broadcast over the action axes
        if isinstance(x, torch.Tensor) and x.dim() == 1:
            return x.reshape(x.shape + (1,) * axes)
        return x

    deltas = action_table(cfg, pos2.device)[:, :2]    # [A, 2]
    land = pos2[:, None, :] + deltas[None]             # [N, A, 2]
    d1 = norm2(land - est[:, None, :]) - per_env(radial_bias, 1)  # [N, A]
    crossing = d1 <= terminate_radius

    def depth_score(d):
        # deeper than the target is cheap, shallower nears the failure rim
        return torch.where(d > deep_target, d - deep_target,
                           0.3 * (deep_target - d))

    d2 = norm2(land[:, :, None, :] + deltas[None, None]
               - est[:, None, None, :]) - per_env(radial_bias, 2)
    deep2 = d2 <= per_env(take, 2)                     # [N, A, A]
    best2 = torch.where(deep2, depth_score(d2),
                        torch.full_like(d2, 1e9)).amin(-1)
    score = torch.where(
        crossing & (d1 <= per_env(take, 1)),
        depth_score(d1),                               # a deep landing
        torch.where(
            ~crossing & deep2.any(-1),
            1e3 + best2,                               # setup for one
            torch.where(
                ~crossing,
                2e3 + torch.abs(d1 - setup_distance),  # approach the ring
                3e3 + d1,                              # shallow crossing
            ),
        ),
    )
    return torch.argmin(score, dim=-1)


@functools.lru_cache(maxsize=8)
def _reverse(device: torch.device) -> torch.Tensor:
    """Each 2-D action's reverse (stay, -y, +y, -x, +x), on ``device``."""
    return torch.tensor([0, 2, 1, 4, 3], dtype=torch.int32, device=device)


def _full(like: torch.Tensor, value, dtype) -> torch.Tensor:
    return torch.full(like.shape, value, dtype=dtype, device=like.device)


def guide_step(gs: GuideState, pos: torch.Tensor, conc: torch.Tensor,
               policy_action: torch.Tensor, cfg: EnvConfig,
               gcfg: GuideConfig, true_source: torch.Tensor | None = None):
    """Ingest every episode's current sample (pos f32[N, pos_dim], conc
    f32[N]), refresh its estimate and return ``(state', action, overriding
    bool[N])``; ``action`` has ``policy_action``'s dtype and is the
    policy's where the guide does not override.

    ``true_source`` f32[N, 2] is a diagnostic injection: the state machine
    runs unchanged, but once the guide steers the lookahead is driven by
    the true source instead of the fit (and the radial calibration is
    zeroed)."""
    f32, i32 = torch.float32, torch.int32
    pos2 = pos[:, :2]
    # debias the additive turbulence (mean TI*(E|N| + 0.2 E[U])) before
    # inverting the plume model
    noise_mean = cfg.turbulence_intensity * (0.7978845608 + 0.1)
    conc_n = (conc - noise_mean) / cfg.conc_peak
    sigma2 = cfg.plume_sigma ** 2
    accept = (conc_n >= gcfg.conc_floor) & (conc_n <= gcfg.conc_ceil)
    r2 = -2.0 * sigma2 * torch.log(torch.clamp(conc_n, min=1e-6))
    idx = gs.count % gcfg.buffer_size
    slot = (torch.arange(gcfg.buffer_size, device=pos.device)[None]
            == idx[:, None])
    write = slot & accept[:, None]
    gs = dataclasses.replace(
        gs,
        pos_buf=torch.where(write[..., None], pos2[:, None, :], gs.pos_buf),
        r2_buf=torch.where(write, r2[:, None], gs.r2_buf),
        # weight ~ conc^3 favours the high-SNR annulus samples
        w_buf=torch.where(write, (conc_n ** 3)[:, None], gs.w_buf),
        count=gs.count + accept.to(i32),
    )
    est, ok, fit_se, fit_n = _solve_estimate(gs, gcfg)
    # in the high-SNR zone the pointwise inversion is accurate to a few px:
    # a fit that disagrees with it is wrong
    d_est_here = norm2(pos2 - est)
    d_point = torch.sqrt(torch.clamp(r2, min=0.0))
    ok = ok & torch.where(
        conc_n >= gcfg.cross_check_conc,
        torch.abs(d_est_here - d_point) <= gcfg.cross_check_tol,
        torch.ones_like(ok))
    gs = dataclasses.replace(gs, est=est, est_ok=ok)

    # ---- pointwise distance and per-axis gradient-sign registers ----
    have_d = conc_n >= gcfg.point_floor
    d_hat = d_point
    delta_d = d_hat - gs.d_prev
    meas = have_d & gs.d_prev_ok & (torch.abs(delta_d) > gcfg.radial_move_min)
    la = gs.last_action
    was_y = (la == 1) | (la == 2)
    was_x = (la == 3) | (la == 4)
    one, zero = _full(delta_d, 1.0, f32), _full(delta_d, 0.0, f32)
    move_sign = torch.where((la == 1) | (la == 3), one,
                            torch.where((la == 2) | (la == 4), -one, zero))
    inward = -torch.sign(delta_d) * move_sign
    mx, my = meas & was_x, meas & was_y
    sign_x = torch.where(mx, inward, gs.sign_x)
    know_x = gs.know_x | mx
    mag_x = torch.where(mx, torch.abs(delta_d), gs.mag_x)
    sign_y = torch.where(my, inward, gs.sign_y)
    know_y = gs.know_y | my
    mag_y = torch.where(my, torch.abs(delta_d), gs.mag_y)

    # best contact so far: the rally point when contact is lost
    better = conc_n > gs.best_conc
    best_conc = torch.where(better, conc_n, gs.best_conc)
    best_pos = torch.where(better[:, None], pos2, gs.best_pos)

    # ---- hover mode transitions: a validated entry ----
    readable = conc_n >= gcfg.conc_floor
    streak = torch.where(readable, gs.streak + 1, torch.zeros_like(gs.streak))
    low_count = torch.where(~readable, gs.low_count + 1,
                            torch.zeros_like(gs.low_count))
    enter = (((gs.streak >= 1) & (conc_n >= gcfg.enter_weak))
             | (conc_n >= gcfg.enter_strong))
    lost = low_count >= gcfg.lost_patience
    mode = torch.where(enter, torch.ones_like(gs.mode),
                       torch.where(lost, torch.zeros_like(gs.mode), gs.mode))
    # on losing the plume, forget stale gradient knowledge
    know_x = know_x & ~lost
    know_y = know_y & ~lost

    # ---- hover action ----
    g2 = 0.5 * cfg.grid_size
    csx = torch.where(pos[:, 0] < g2, one, -one)  # centre bias, sign unknown
    csy = torch.where(pos[:, 1] < g2, one, -one)
    sx = torch.where(know_x, sign_x, csx)
    sy = torch.where(know_y, sign_y, csy)
    est_conf = (fit_n >= gcfg.veto_min_inliers) & (fit_se <= gcfg.veto_se)
    gap = est - pos2
    if gcfg.est_signs:
        sx = torch.where(
            est_conf & (torch.abs(gap[:, 0]) >= gcfg.est_sign_min),
            torch.sign(gap[:, 0]), sx)
        sy = torch.where(
            est_conf & (torch.abs(gap[:, 1]) >= gcfg.est_sign_min),
            torch.sign(gap[:, 1]), sy)
    a1, a2, a3, a4 = (_full(la, v, i32) for v in (1, 2, 3, 4))
    in_x = torch.where(sx > 0, a3, a4)   # x move judged inward
    in_y = torch.where(sy > 0, a1, a2)

    alt_x = gs.axis_next == 0
    if gcfg.tangential_band > 0:
        ambig = d_point < gcfg.probe_in_min + gcfg.tangential_band
        alt_x = torch.where(est_conf & ambig,
                            torch.abs(gap[:, 0]) <= torch.abs(gap[:, 1]),
                            alt_x)
    probe_in = torch.where(alt_x, in_x, in_y)
    # bounce: an inward probe only from d_hat >= probe_in_min, else walk
    # back out, continuing the last move if it increased d_hat
    rev = _reverse(pos.device)[torch.clamp(la, 0, 4).long()]
    went_out = delta_d > 0.0
    out_step = torch.where(
        gs.d_prev_ok & (la != 0),
        torch.where(went_out, la, rev),
        torch.where(rev == 0, probe_in, rev),
    )
    if gcfg.sign_aware_out:
        out_x = torch.where(sx > 0, a4, a3)  # opposite of the inward x move
        out_y = torch.where(sy > 0, a2, a1)
        out_step = torch.where(
            was_x & know_x, out_x,
            torch.where(was_y & know_y, out_y,
                        torch.where(know_x, out_x,
                                    torch.where(know_y, out_y, out_step))))
    far_count = torch.where(have_d & (d_hat >= gcfg.probe_in_min),
                            gs.far_count + 1, torch.zeros_like(gs.far_count))
    do_probe = (d_hat >= gcfg.probe_in_min) & (
        far_count >= gcfg.probe_consistency)
    bounce_action = torch.where(do_probe, probe_in, out_step)

    # ---- dive commitment and the stuck-hover fallback ----
    hover_age = torch.where(mode == 1, gs.hover_age + 1,
                            torch.zeros_like(gs.hover_age))
    soft = torch.zeros_like(ok)
    if gcfg.fallback_patience > 0:
        se_bar = (gcfg.max_se if gcfg.max_se_fallback is None
                  else gcfg.max_se_fallback)
        soft = ((hover_age >= gcfg.fallback_patience) & (fit_se <= se_bar)
                & (fit_n >= gcfg.fallback_min_inliers))
    commit_now = soft | (ok if gcfg.commit_on_ok else torch.zeros_like(ok))
    committed = gs.committed | commit_now
    est_refresh = est
    if gcfg.est_ema < 1.0:
        # blend validated refreshes during a dive
        est_refresh = torch.where(
            gs.committed[:, None],
            (1.0 - gcfg.est_ema) * gs.est_good + gcfg.est_ema * est, est)
    est_good = torch.where((ok | soft)[:, None], est_refresh, gs.est_good)
    est_used = torch.where(ok[:, None], est_refresh, est_good)
    if true_source is not None:  # diagnostic: a perfect fix
        est_used = true_source[:, :2]
    steer = ok | committed

    # ---- radial calibration of the committed estimate ----
    rad_bias, bias_ok = gs.rad_bias, gs.bias_ok
    bias = torch.zeros_like(gs.rad_bias)
    if gcfg.bias_alpha > 0 and true_source is None:
        d_used_here = norm2(pos2 - est_used)
        good_read = (conc_n >= gcfg.bias_conc_min) & steer
        bias_raw = torch.clamp(d_used_here - d_hat, -gcfg.bias_clip,
                               gcfg.bias_clip)
        a = gcfg.bias_alpha
        rad_bias = torch.where(
            good_read,
            torch.where(gs.bias_ok, (1.0 - a) * gs.rad_bias + a * bias_raw,
                        bias_raw),
            gs.rad_bias)
        bias_ok = gs.bias_ok | good_read
        bias = torch.where(bias_ok, rad_bias, torch.zeros_like(rad_bias))

    # ---- phantom-estimate refutation: alive inside the estimated ball ----
    refuted = torch.zeros_like(ok)
    phantom_count = torch.zeros_like(gs.phantom_count)
    if gcfg.phantom_patience > 0:
        d_here_eff = norm2(pos2 - est_used) - bias
        phantom = committed & (
            d_here_eff <= gcfg.terminate_radius - gcfg.phantom_margin)
        phantom_count = torch.where(phantom, gs.phantom_count + 1,
                                    torch.zeros_like(gs.phantom_count))
        refuted = phantom_count >= gcfg.phantom_patience
        committed = committed & ~refuted
        bias_ok = bias_ok & ~refuted

    # ---- the estimate-based lookahead ----
    commit_age = torch.where(committed, gs.commit_age + 1,
                             torch.zeros_like(gs.commit_age))
    take_eff = float(gcfg.deep_take)
    if gcfg.dive_warmup > 0:
        take_eff = torch.where(commit_age >= gcfg.dive_warmup,
                               _full(bias, take_eff, f32),
                               _full(bias, -1.0, f32))
    if gcfg.take_relax_age > 0:
        take_eff = torch.where(commit_age >= gcfg.take_relax_age,
                               _full(bias, gcfg.take_relax_to, f32),
                               _full(bias, 1.0, f32) * take_eff)
    deltas = action_table(cfg, pos.device)[:, :2]
    g_action = phase_action(pos2, est_used, cfg, gcfg.terminate_radius,
                            gcfg.deep_target, gcfg.setup_distance,
                            deep_take=take_eff, radial_bias=bias)

    hover_action = bounce_action.long()
    # no trusted read: rally back toward the best contact seen
    d_rally = norm2(pos2[:, None, :] + deltas[None] - best_pos[:, None, :])
    stay = torch.arange(cfg.num_actions, device=pos.device) == 0
    rally = torch.argmin(torch.where(stay, torch.full_like(d_rally, 1e9),
                                     d_rally), dim=-1)
    hover_action = torch.where(have_d, hover_action, rally)

    # ---- hover safety veto ----
    if gcfg.hover_veto_margin > 0:
        d_land_est = norm2(pos2[:, None, :] + deltas[None] - est[:, None, :])
        veto_on = (fit_n >= gcfg.veto_min_inliers) & (fit_se <= gcfg.veto_se)
        risky = d_land_est <= gcfg.terminate_radius + gcfg.hover_veto_margin
        retreat = torch.argmax(d_land_est, dim=-1)
        out_l = out_step.long()[:, None]
        alt = torch.where(torch.gather(risky, 1, out_l)[:, 0], retreat,
                          out_step.long())
        hover_action = torch.where(
            veto_on & torch.gather(risky, 1, hover_action[:, None])[:, 0],
            alt, hover_action)

    steer = steer & ~refuted
    hovering = (mode == 1) & ~steer
    action = torch.where(
        steer, g_action,
        torch.where(hovering, hover_action, policy_action.long()),
    ).to(policy_action.dtype)
    overriding = steer | hovering

    gs = dataclasses.replace(
        gs,
        mode=mode,
        d_prev=torch.where(have_d, d_hat, gs.d_prev),
        d_prev_ok=have_d,
        last_action=action.to(i32),
        sign_x=sign_x, know_x=know_x, mag_x=mag_x,
        sign_y=sign_y, know_y=know_y, mag_y=mag_y,
        # alternate probe axes per executed in-probe
        axis_next=torch.where(hovering & do_probe & have_d,
                              1 - gs.axis_next, gs.axis_next),
        low_count=low_count, streak=streak, best_conc=best_conc,
        best_pos=best_pos, committed=committed, est_good=est_good,
        hover_age=hover_age, rad_bias=rad_bias, bias_ok=bias_ok,
        commit_age=commit_age, far_count=far_count,
        phantom_count=phantom_count,
        # a refuted fit's samples are wiped so the trilateration restarts
        w_buf=torch.where(refuted[:, None], torch.zeros_like(gs.w_buf),
                          gs.w_buf),
    )
    return gs, action, overriding


def make_guide(
    cfg: EnvConfig,
    gcfg: GuideConfig | None = None,
    terminate_radius: float | None = None,
    success_radius: float = 40.0,
    max_se: float | None = None,
    search_after: int | None = None,
):
    """``(init_state, step_fn)`` for ``evaluate_policy``'s and the
    rollout's ``guide=`` hook: one episode's initial state and a step over
    the batch, ``step_fn(state, pos, conc, policy_action) -> (state',
    action, overriding)``.

    With ``gcfg=None`` the thresholds are derived from the env physics
    (``derive_guide_config``); ``max_se`` overrides the validation gate.
    The anisotropic plume goes to ``aniso_fit.make_aniso_guide`` (a
    Gauss-Newton fit of its 3-parameter kernel), where ``search_after``
    enables the resuming serpentine contact search (ignored on the
    isotropic path).  3-D flight and every other plume model raise
    ``ValueError``, as in JAX."""
    if cfg.env_3d:
        raise ValueError("terminal guidance is 2-D (planimetric) only")
    if cfg.plume_model == "anisotropic":
        from tpu_plume_torch.evaluation.aniso_fit import (
            derive_aniso_config,
            make_aniso_guide,
        )

        agcfg = derive_aniso_config(
            cfg,
            terminate_radius=(50.0 if terminate_radius is None
                              else terminate_radius),
            success_radius=success_radius,
        )
        if max_se is not None:
            agcfg = dataclasses.replace(agcfg, max_se=max_se)
        if search_after is not None:
            agcfg = dataclasses.replace(agcfg,
                                        search_after=max(search_after, 0))
        return make_aniso_guide(cfg, agcfg)
    if cfg.plume_model != "isotropic":
        raise ValueError(
            "model-based guidance needs an analytic plume model; "
            f"plume_model={cfg.plume_model!r} is not supported — use the "
            "learned localizer route (--guide learned)"
        )
    if gcfg is None:
        gcfg = derive_guide_config(
            cfg,
            terminate_radius=(50.0 if terminate_radius is None
                              else terminate_radius),
            success_radius=success_radius,
        )
        if max_se is not None:
            gcfg = dataclasses.replace(gcfg, max_se=max_se)
    return (
        guide_init(gcfg),
        lambda gs, pos, conc, act: guide_step(gs, pos, conc, act, cfg, gcfg),
    )
