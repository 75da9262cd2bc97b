"""Model-based terminal guidance for anisotropic plumes (port of
``tpu_plume/evaluation/aniso_fit.py``): a Gauss-Newton fit of (source_x,
source_y, wind_angle) against the agent's own concentration samples,
driving the shared crossing-phase controller (``guidance.phase_action``).

On the wrf_les physics (sigma_y = 0.3 d^0.71 downwind of a per-episode
wind) the concentration at a point depends on the direction to the source,
so no pointwise conc -> radius inversion exists.  The plume kernel is known
in closed form with three unknowns (wind speed cancels: the kernel reads
only the unit wind), so the guide minimizes

    sum_i w_i (kernel(p_i; s, theta) - c_i)^2

over the flight's accepted samples, from a fixed fan of ``n_theta`` wind
angles (each started one plume length upwind of the strongest sample) for
``gn_iters`` damped Gauss-Newton steps, and keeps the best in-domain final
loss.  A posterior worst-direction standard error of the source block gates
steering; the dive commitment latch, phantom refutation (with a ban ball
sized by what the environment proved source-free), commit timeout and the
optional transect, ridge-ride and serpentine-search tiers follow JAX's.

JAX writes one episode and vmaps it, with ``jax.jacfwd`` of the residual;
here every register carries the episode axis first, the starts run as a
second batch axis ([N, n_theta]), the iterations are a Python loop of
batched steps, and the Jacobian is the kernel's closed-form derivative
(``_model_and_jac``), held to JAX's ``jacfwd`` by the tests.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from dataclasses import dataclass

import torch

from tpu_plume_torch.core.config import EnvConfig
from tpu_plume_torch.env.methane import action_table
from tpu_plume_torch.evaluation.guidance import (
    _NOISE_STD_FRAC,
    _full,
    norm2,
    phase_action,
)
from tpu_plume_torch.ops.plume import anisotropic_kernel


@dataclass(frozen=True)
class AnisoGuideConfig:
    """The fit guide's settings (JAX's ``AnisoGuideConfig``, whose comments
    give the measurements behind each default)."""

    buffer_size: int = 128
    # accepted debiased conc/peak band of a sample
    conc_floor: float = 0.03
    conc_ceil: float = 0.98
    min_samples: int = 8
    # posterior worst-direction standard error (px) the fit must reach
    max_se: float = 4.0
    # censored ("null") reads: positions read sub-floor null_streak steps in
    # a row add one-sided hinge residuals (0 disables)
    null_buffer: int = 0
    null_pred_mult: float = 3.0
    null_streak: int = 2
    null_weight: float = 1.0
    # the Gauss-Newton ladder: damping anneals geometrically to
    # damping_final over gn_iters steps from each of n_theta starts
    n_theta: int = 8
    gn_iters: int = 16
    damping: float = 1e-2
    damping_final: float = 1e-4
    upwind_init: float = 60.0
    # dive geometry
    terminate_radius: float = 50.0
    deep_target: float = 30.0
    deep_take: float = 34.0
    setup_distance: float = 54.0
    # commitment latch and phantom refutation
    commit_on_ok: bool = True
    phantom_patience: int = 3
    phantom_margin: float = 5.0
    phantom_se_mult: float = 2.0
    # source-domain constraint on the selection and the gate (< 0 disables)
    domain_slack: float = 8.0
    # peak-proximity tie-break among near-tied modes (0 disables)
    peak_tiebreak: float = 0.0
    # cap of the ban ball around a refuted centre
    phantom_ban_radius: float = 15.0
    # presence refutations before conceding to the policy (<= 0 disables)
    phantom_max_refutes: int = 3
    stale_concedes: bool = False
    # prediction-mismatch refutation (<= 0 disables)
    mismatch_patience: int = 0
    mismatch_pred_mult: float = 4.0
    mismatch_ratio: float = 4.0
    # committed steps without termination before the fit is stale
    commit_timeout: int = 100
    # crosswind transect sensing (off by default in JAX)
    transect: bool = False
    enter_weak: float = 0.045
    flip_patience: int = 3
    lost_patience: int = 12
    safety_conc: float = 0.5
    edge_margin: float = 15.0
    drift_steps: int = 2
    sense_patience: int = 60
    # identifiability-triggered ridge ride (off by default in JAX)
    ride: bool = False
    ride_budget: int = 30
    ride_ambig_min: float = 40.0
    ambig_ratio: float = 5.0
    ride_standoff: float = 60.0
    # blend of validated fixes into the committed estimate (1 = replace)
    est_ema: float = 1.0
    # resuming serpentine contact search after this many contact-free
    # steps (0 disables)
    search_after: int = 0


@dataclass
class AnisoGuideState:
    """One register per field, the episode axis first in a batch."""

    pos_buf: torch.Tensor    # f32[K, 2] accepted sample positions
    c_buf: torch.Tensor      # f32[K] debiased conc_n
    w_buf: torch.Tensor      # f32[K] weights (0 = empty slot)
    count: torch.Tensor      # i32 accepted samples (monotonic)
    est: torch.Tensor        # f32[2] current fit
    theta: torch.Tensor      # f32 fitted wind angle
    est_ok: torch.Tensor     # bool: the gate is open this step
    committed: torch.Tensor  # bool: dive commitment latched
    est_good: torch.Tensor   # f32[2] freshest validated fix
    theta_good: torch.Tensor  # f32 its wind angle
    commit_age: torch.Tensor  # i32
    phantom_count: torch.Tensor  # i32
    mm_count: torch.Tensor   # i32 net prediction-mismatch votes
    mode: torch.Tensor       # i32 1 while overriding
    tr_mode: torch.Tensor    # i32 1 while transect sensing is engaged
    tr_sign: torch.Tensor    # f32 +-1 current crosswind direction
    low_streak: torch.Tensor  # i32 consecutive sub-floor reads
    tr_age: torch.Tensor     # i32 sensing steps taken
    tr_spent: torch.Tensor   # bool: sensing budget exhausted
    drift: torch.Tensor      # i32 pending downwind drift steps
    bad_est: torch.Tensor    # f32[2] last refuted centre
    bad_r: torch.Tensor      # f32 its ban radius
    have_bad: torch.Tensor   # bool: bad_est is live
    refutes: torch.Tensor    # i32 refutations (presence + stale)
    p_refutes: torch.Tensor  # i32 presence refutations only
    d_min: torch.Tensor      # f32 closest committed approach to the est
    null_pos: torch.Tensor   # f32[Kn, 2] proven dead-zone positions
    null_w: torch.Tensor     # f32[Kn] null-slot weights (0 = empty)
    null_count: torch.Tensor  # i32 nulls recorded (monotonic)
    ride_count: torch.Tensor  # i32 ridge-ride steps taken
    step_count: torch.Tensor  # i32 steps ingested (search timer)
    last_contact: torch.Tensor  # i32 step of the last readable read
    sweep_down: torch.Tensor  # bool: serpentine vertical direction


@functools.lru_cache(maxsize=8)
def _cofactors(device: torch.device) -> torch.Tensor:
    """The adjugate's cofactors of a row-major 3x3 matrix a[0..8], on
    ``device``: cofactor i is a[P] * a[Q] - a[R] * a[S] of row i's
    (P, Q, R, S), flattened."""
    return torch.tensor([[4, 8, 5, 7], [2, 7, 1, 8], [1, 5, 2, 4],
                         [5, 6, 3, 8], [0, 8, 2, 6], [2, 3, 0, 5],
                         [3, 7, 4, 6], [1, 6, 0, 7], [0, 4, 1, 3]],
                        device=device).reshape(-1)


def _inv3(a: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse (adjugate / det) of 3x3 matrices a[..., 3, 3],
    each cofactor and the determinant in JAX's ``_inv3`` order."""
    flat = a.reshape(a.shape[:-2] + (9,))
    f = flat[..., _cofactors(a.device)].reshape(a.shape[:-2] + (9, 4))
    adj = f[..., 0] * f[..., 1] - f[..., 2] * f[..., 3]
    det = (flat[..., 0] * adj[..., 0] + flat[..., 1] * adj[..., 3]
           + flat[..., 2] * adj[..., 6])
    return (adj / (det + 1e-12)[..., None]).reshape(a.shape)


def make_model_n(cfg: EnvConfig):
    """The normalized forward model c/peak: ``model_n(pos [..., K, 2], s
    [..., 2], theta [...]) -> [..., K]``, the port's ``anisotropic_kernel``
    with the unit wind (cos theta, sin theta) (the kernel is
    speed-invariant)."""

    def model_n(pos, s, theta):
        u = torch.stack([torch.cos(theta), torch.sin(theta)], -1)
        k = anisotropic_kernel(s[..., None, :], u[..., None, :],
                               pos[..., 0], pos[..., 1], cfg)
        return k / cfg.conc_peak

    return model_n


def _tie(x: torch.Tensor, y) -> torch.Tensor:
    """The share of the tangent that ``max(x, y)`` passes to ``x``: 1 where
    x > y, 0.5 at a tie, 0 below (JAX's balanced rule)."""
    return torch.where(x > y, 1.0, torch.where(x == y, 0.5, 0.0))


def _model_and_jac(pos, s, theta, cfg: EnvConfig, jac: bool = True):
    """``make_model_n``'s values f32[N, S, K] at positions pos f32[N, K, 2]
    for sources s f32[N, S, 2] and wind angles theta f32[N, S] (the same
    operations in the same order), and with ``jac`` their derivatives in
    s_x, s_y and theta, three f32[N, S, K].

    The kernel k depends on the parameters through the downwind distance dw
    and the squared distance r2 alone, so its derivative is P_w dw' + P_r
    r2', with P_w and P_r the chain rule's factors through the crosswind
    spread, the centreline and the upwind blob (``max`` splitting ties as
    JAX's differentiation does).  The unit wind's norm is 1 for every
    theta, so its derivative, zero up to rounding, is left out."""
    peak, smin = cfg.conc_peak, cfg.sigma_y_min
    coef, ex = cfg.sigma_y_coef, cfg.sigma_y_exp
    fx, fy = pos[:, None, :, 0], pos[:, None, :, 1]      # [N, 1, K]
    cs = torch.cos(theta)[..., None]                     # [N, S, 1]
    sn = torch.sin(theta)[..., None]
    # the kernel's primal, as ops/plume.py anisotropic_kernel computes it
    r0 = fx - s[..., 0, None]
    r1 = fy - s[..., 1, None]
    speed = torch.sqrt(cs * cs + sn * sn) + 1e-8
    u0, u1 = cs / speed, sn / speed
    dw = r0 * u0 + r1 * u1
    r2 = r0 ** 2 + r1 ** 2
    q = r2 - dw ** 2
    cross2 = torch.clamp(q, min=0.0)
    d = torch.clamp(dw, min=0.0)
    t = coef * d ** ex
    sig = torch.clamp(t, min=smin)
    cl = peak * (smin / sig)
    e_arg = torch.exp(-cross2 / (2.0 * sig ** 2))
    plume_v = cl * e_arg * 1.0
    blob = peak * torch.exp(-r2 / (2.0 * smin ** 2)) * 1.0
    upwind = dw < 0.0
    k = torch.where(upwind, blob, torch.maximum(plume_v, blob))
    if not jac:
        return k / peak, None

    # sig' = h dw' (through d = max(dw, 0) and max(smin, coef d^ex))
    h = (_tie(t, smin) * _tie(dw, 0.0) * coef * ex
         * torch.where(d > 0.0, d, 1.0) ** (ex - 1.0) * (d > 0.0))
    inv2s2 = 0.5 / sig ** 2
    ce = cl * e_arg
    tq = _tie(q, 0.0)
    # plume' = ce (-cross2' / (2 sig^2) + cross2 sig' / sig^3) + cl' e_arg,
    # with cross2' = tq (r2' - 2 dw dw') and cl' = -peak smin sig' / sig^2
    a_w = (ce * (tq * 2.0 * dw * inv2s2 + cross2 * h / sig ** 3)
           - peak * smin * h / sig ** 2 * e_arg)
    a_r = -ce * tq * inv2s2
    b_r = -blob / (2.0 * smin ** 2)
    wp = torch.where(upwind, 0.0, _tie(plume_v, blob))
    p_w = (wp * a_w) / peak
    p_r = (wp * a_r + (1.0 - wp) * b_r) / peak
    # dw' = (-u0, -u1, r0 u0' + r1 u1'), r2' = (-2 r0, -2 r1, 0)
    jx = -(p_w * u0 + 2.0 * p_r * r0)
    jy = -(p_w * u1 + 2.0 * p_r * r1)
    jt = p_w * (r1 * (cs / speed) - r0 * (sn / speed))
    return k / peak, (jx, jy, jt)


def _normal(j, r):
    """J^T J [..., 3, 3] and J^T r [..., 3] of the Jacobian columns ``j``
    (three [..., K]) and residuals ``r`` [..., K], each entry one product
    summed over K."""
    jm = torch.stack(j, -2)                                # [..., 3, K]
    a = (jm[..., :, None, :] * jm[..., None, :, :]).sum(-1)
    return a, (jm * r[..., None, :]).sum(-1)


def fit_aniso(pos, c, w, cfg: EnvConfig, gcfg: AnisoGuideConfig,
              null_pos=None, null_w=None, return_ambiguity=False):
    """Multi-start damped Gauss-Newton fit of every episode's sample buffer
    (pos f32[N, K, 2], c and w f32[N, K]).

    ``null_pos`` f32[N, Kn, 2] / ``null_w`` f32[N, Kn] optionally add the
    censored-data hinge residuals: a candidate predicting a readable
    signal at a proven dead-zone position pays for it in loss.

    Returns (est f32[N, 2], theta f32[N], se f32[N], n_eff i64[N]): the
    best-loss start (the first of equal losses, preferring sources in the
    spawn domain) and its posterior worst-direction standard error of the
    source block.  ``return_ambiguity`` appends the multi-start mode spread
    (px) among the near-best starts."""
    n, kd = c.shape
    dev = c.device
    sw = torch.sqrt(w)[:, None]                             # [N, 1, K]
    nulls = null_pos is not None and null_pos.shape[1] > 0
    if nulls:
        null_thresh = gcfg.null_pred_mult * gcfg.conc_floor
        sw_null = (math.sqrt(gcfg.null_weight) * null_w)[:, None]
        pos_all = torch.cat([pos, null_pos], 1)
    else:
        pos_all = pos
    c = c[:, None]

    def residual(params, jac=True):
        model, dm = _model_and_jac(pos_all, params[..., :2], params[..., 2],
                                   cfg, jac)
        if not nulls:
            return (model - c) * sw, dm and tuple(x * sw for x in dm)
        excess = model[..., kd:] - null_thresh
        r = torch.cat([(model[..., :kd] - c) * sw,
                       sw_null * torch.clamp(excess, min=0.0)], -1)
        if not jac:
            return r, None
        gate = sw_null * _tie(excess, 0.0)
        return r, tuple(torch.cat([x[..., :kd] * sw, x[..., kd:] * gate], -1)
                        for x in dm)

    eye = torch.eye(3, dtype=torch.float32, device=dev)
    n_it = gcfg.gn_iters
    lam_sched = (gcfg.damping * (gcfg.damping_final / gcfg.damping) ** (
        torch.arange(n_it, dtype=torch.float32) / max(n_it - 1, 1))).tolist()

    i_max = torch.argmax(torch.where(w > 0, c[:, 0], -1.0), dim=-1)
    p_star = torch.gather(pos, 1, i_max[:, None, None].expand(n, 1, 2))
    thetas = (2.0 * math.pi / gcfg.n_theta) * torch.arange(
        gcfg.n_theta, dtype=torch.float32, device=dev)
    dirs = torch.stack([torch.cos(thetas), torch.sin(thetas)], -1)
    s0 = p_star - gcfg.upwind_init * dirs[None]            # [N, S, 2]
    params = torch.cat([s0, thetas[None, :, None].expand(n, -1, 1)], -1)
    for lam in lam_sched:
        a, g = _normal(*residual(params)[::-1])
        params = params - (_inv3(a + lam * eye) @ g[..., None])[..., 0]
    r_all, _ = residual(params, jac=False)
    all_loss = (r_all ** 2).sum(-1)                        # [N, S]
    if gcfg.domain_slack >= 0:
        lo = cfg.source_padding - gcfg.domain_slack
        hi = cfg.grid_size - cfg.source_padding + gcfg.domain_slack
        in_dom = ((params[..., :2] >= lo) & (params[..., :2] <= hi)).all(-1)
        sel_loss = torch.where(in_dom.any(-1, keepdim=True),
                               torch.where(in_dom, all_loss, math.inf),
                               all_loss)
    else:
        sel_loss = all_loss
    if gcfg.peak_tiebreak > 0:
        tied = sel_loss <= gcfg.peak_tiebreak * sel_loss.amin(-1,
                                                              keepdim=True)
        d_peak = norm2(params[..., :2] - p_star)
        best = torch.argmin(torch.where(tied, d_peak, math.inf), dim=-1)
    else:
        best = torch.argmin(sel_loss, dim=-1)
    rows = torch.arange(n, device=dev)
    best_params = params[rows, best]
    # the posterior at the selected start (sigma0 from the data rows only)
    r, j = residual(best_params[:, None])
    a, _ = _normal(j, r)
    a, r = a[:, 0], r[:, 0, :kd]
    n_eff = (w > 0).sum(-1)
    noise_n = _NOISE_STD_FRAC * cfg.turbulence_intensity / cfg.conc_peak
    sigma0 = torch.clamp(
        (r ** 2).sum(-1) / torch.clamp(n_eff.to(torch.float32), min=1.0),
        min=noise_n ** 2)
    # worst-direction source variance: sigma0 over the smallest eigenvalue
    # of the Schur complement of the wind-angle block
    a_tt = torch.clamp(a[:, 2, 2], min=1e-12)
    s2 = a[:, :2, :2] - (a[:, :2, 2, None] * a[:, None, 2, :2]) / a_tt[
        :, None, None]
    tr = s2[:, 0, 0] + s2[:, 1, 1]
    det = s2[:, 0, 0] * s2[:, 1, 1] - s2[:, 0, 1] * s2[:, 1, 0]
    lam_min = 0.5 * (tr - torch.sqrt(torch.clamp(tr ** 2 - 4.0 * det,
                                                 min=0.0)))
    se = torch.sqrt(sigma0 / torch.clamp(lam_min, min=1e-9))
    if not return_ambiguity:
        return best_params[:, :2], best_params[:, 2], se, n_eff
    # theta identifiability as the spread of the near-best starts' sources
    loss_floor = n_eff.to(torch.float32) * noise_n ** 2
    near = sel_loss <= gcfg.ambig_ratio * torch.maximum(
        sel_loss[rows, best], loss_floor)[:, None]
    d_modes = norm2(params[..., :2] - best_params[:, None, :2])
    spread = torch.where(near, d_modes, 0.0).amax(-1)
    return best_params[:, :2], best_params[:, 2], se, n_eff, spread


def derive_aniso_config(
    cfg: EnvConfig,
    terminate_radius: float = 50.0,
    success_radius: float = 40.0,
) -> AnisoGuideConfig:
    """Thresholds from the field physics and the protocol, as JAX's
    ``derive_aniso_config`` derives them (the setup ring keeps a +4 px
    margin, capped so that a radial step from it still clears the take
    band)."""
    noise_n = _NOISE_STD_FRAC * cfg.turbulence_intensity / cfg.conc_peak
    move = cfg.grid_size * cfg.move_frac
    deep = min(success_radius - 10.0, 0.8 * terminate_radius)
    take = min(success_radius - 6.0, 0.9 * terminate_radius)
    return AnisoGuideConfig(
        conc_floor=1.6 * noise_n,
        enter_weak=2.4 * noise_n,
        terminate_radius=terminate_radius,
        deep_target=deep,
        deep_take=take,
        setup_distance=move + min(deep + 3.0, take - 1.0),
        upwind_init=terminate_radius + 10.0,
    )


def aniso_init(gcfg: AnisoGuideConfig) -> AnisoGuideState:
    """One episode's initial state, on the CPU."""
    k, kn = gcfg.buffer_size, max(gcfg.null_buffer, 1)
    f32, i32 = torch.float32, torch.int32

    def z():
        return torch.zeros((), dtype=f32)

    def zi():
        return torch.zeros((), dtype=i32)

    def zb():
        return torch.zeros((), dtype=torch.bool)

    return AnisoGuideState(
        pos_buf=torch.zeros(k, 2, dtype=f32), c_buf=torch.zeros(k, dtype=f32),
        w_buf=torch.zeros(k, dtype=f32), count=zi(),
        est=torch.zeros(2, dtype=f32), theta=z(), est_ok=zb(), committed=zb(),
        est_good=torch.zeros(2, dtype=f32), theta_good=z(), commit_age=zi(),
        phantom_count=zi(), mm_count=zi(), mode=zi(), tr_mode=zi(),
        tr_sign=torch.ones((), dtype=f32), low_streak=zi(), tr_age=zi(),
        tr_spent=zb(), drift=zi(), bad_est=torch.zeros(2, dtype=f32),
        bad_r=z(), have_bad=zb(), refutes=zi(), p_refutes=zi(),
        d_min=torch.full((), 1e9, dtype=f32),
        null_pos=torch.zeros(kn, 2, dtype=f32),
        null_w=torch.zeros(kn, dtype=f32), null_count=zi(), ride_count=zi(),
        step_count=zi(), last_contact=zi(), sweep_down=zb(),
    )


def make_aniso_guide(
    cfg: EnvConfig,
    gcfg: AnisoGuideConfig | None = None,
    terminate_radius: float | None = None,
    success_radius: float = 40.0,
):
    """``(init_state, step_fn)`` for the ``guide=`` hooks (see
    ``guidance.make_guide``).  Control tiers: a validated fit -> the
    phase-controlled dive; then, where enabled, the ridge ride, the
    crosswind transect and the serpentine search; otherwise the policy."""
    if cfg.env_3d:
        raise ValueError("aniso-fit guidance is 2-D (planimetric) only")
    if cfg.plume_model != "anisotropic":
        raise ValueError(
            f"make_aniso_guide requires plume_model='anisotropic', got "
            f"{cfg.plume_model!r}"
        )
    if cfg.num_sources != 1:
        raise ValueError("the 3-parameter fit assumes a single source")
    if gcfg is None:
        gcfg = derive_aniso_config(
            cfg,
            terminate_radius=(50.0 if terminate_radius is None
                              else terminate_radius),
            success_radius=success_radius,
        )
    noise_mean = cfg.turbulence_intensity * (0.7978845608 + 0.1)
    model_n = make_model_n(cfg)

    def step(gs: AnisoGuideState, pos, conc, policy_action):
        i32 = torch.int32
        dev = pos.device
        pos2 = pos[:, :2]
        conc_n = (conc - noise_mean) / cfg.conc_peak
        accept = (conc_n >= gcfg.conc_floor) & (conc_n <= gcfg.conc_ceil)
        idx = gs.count % gcfg.buffer_size
        slot = (torch.arange(gcfg.buffer_size, device=dev)[None]
                == idx[:, None])
        write = slot & accept[:, None]
        # sub-floor streak (the null recorder and the transect share it)
        readable = conc_n >= gcfg.conc_floor
        low_streak = torch.where(readable, torch.zeros_like(gs.low_streak),
                                 gs.low_streak + 1)
        gs = dataclasses.replace(
            gs,
            pos_buf=torch.where(write[..., None], pos2[:, None, :],
                                gs.pos_buf),
            c_buf=torch.where(write, conc_n[:, None], gs.c_buf),
            w_buf=torch.where(write, torch.ones_like(gs.w_buf), gs.w_buf),
            count=gs.count + accept.to(i32),
        )
        if gcfg.null_buffer > 0:
            # record a proven dead-zone position
            nwrite = (~readable) & (low_streak >= gcfg.null_streak)
            nslot = ((torch.arange(gcfg.null_buffer, device=dev)[None]
                      == (gs.null_count % gcfg.null_buffer)[:, None])
                     & nwrite[:, None])
            gs = dataclasses.replace(
                gs,
                null_pos=torch.where(nslot[..., None], pos2[:, None, :],
                                     gs.null_pos),
                null_w=torch.where(nslot, torch.ones_like(gs.null_w),
                                   gs.null_w),
                null_count=gs.null_count + nwrite.to(i32),
            )
            est, theta, se, n_eff, ambig = fit_aniso(
                gs.pos_buf, gs.c_buf, gs.w_buf, cfg, gcfg,
                null_pos=gs.null_pos, null_w=gs.null_w,
                return_ambiguity=True)
        else:
            est, theta, se, n_eff, ambig = fit_aniso(
                gs.pos_buf, gs.c_buf, gs.w_buf, cfg, gcfg,
                return_ambiguity=True)
        ok = (n_eff >= gcfg.min_samples) & (se <= gcfg.max_se)
        if gcfg.domain_slack >= 0:
            # a source cannot spawn outside the padded box
            dlo = cfg.source_padding - gcfg.domain_slack
            dhi = cfg.grid_size - cfg.source_padding + gcfg.domain_slack
            ok = ok & ((est >= dlo) & (est <= dhi)).all(-1)
        if gcfg.phantom_ban_radius > 0:
            # no fit inside the environment-falsified ball
            ok = ok & ~(gs.have_bad & (norm2(est - gs.bad_est) <= gs.bad_r))

        commit_now = ok if gcfg.commit_on_ok else torch.zeros_like(ok)
        committed = gs.committed | commit_now
        est_refresh = est
        if gcfg.est_ema < 1.0:
            est_refresh = torch.where(
                gs.committed[:, None],
                (1.0 - gcfg.est_ema) * gs.est_good + gcfg.est_ema * est, est)
        est_good = torch.where(ok[:, None], est_refresh, gs.est_good)
        theta_good = torch.where(ok, theta, gs.theta_good)
        est_used = torch.where(ok[:, None], est_refresh, est_good)
        steer = ok | committed

        # phantom refutation: alive inside the estimated terminate ball;
        # the inside count is cumulative while committed
        far = torch.full_like(gs.d_min, 1e9)
        refuted = torch.zeros_like(ok)
        phantom_count = torch.zeros_like(gs.phantom_count)
        d_min = gs.d_min
        r_ban = torch.full_like(gs.d_min, gcfg.phantom_ban_radius)
        if gcfg.phantom_patience > 0:
            margin_eff = max(
                min(gcfg.phantom_margin, 0.1 * gcfg.terminate_radius),
                gcfg.phantom_se_mult * gcfg.max_se,
            )
            d_here = norm2(pos2 - est_used)
            d_min = torch.minimum(torch.where(gs.committed, gs.d_min, far),
                                  torch.where(committed, d_here, far))
            phantom = committed & (
                d_here <= gcfg.terminate_radius - margin_eff)
            phantom_count = torch.where(
                committed, gs.phantom_count + phantom.to(i32),
                torch.zeros_like(gs.phantom_count))
            refuted = phantom_count >= gcfg.phantom_patience
            committed = committed & ~refuted
            r_ban = torch.clamp(gcfg.terminate_radius - d_min, margin_eff,
                                gcfg.phantom_ban_radius)
        # prediction-mismatch refutation
        mm_count = torch.zeros_like(gs.mm_count)
        if gcfg.mismatch_patience > 0:
            pred_n = model_n(pos2[:, None, :], est_used, theta_good)[:, 0]
            strong_pred = pred_n >= gcfg.mismatch_pred_mult * gcfg.conc_floor
            vote = strong_pred & (conc_n < pred_n / gcfg.mismatch_ratio)
            agree = strong_pred & (conc_n >= pred_n / gcfg.mismatch_ratio)
            mm_count = torch.where(
                committed,
                torch.where(agree, torch.zeros_like(gs.mm_count),
                            gs.mm_count + vote.to(i32)),
                torch.zeros_like(gs.mm_count))
            mm_refuted = committed & (mm_count >= gcfg.mismatch_patience)
            refuted = refuted | mm_refuted
            committed = committed & ~mm_refuted
        stale = torch.zeros_like(ok)
        if gcfg.commit_timeout > 0:
            stale = gs.committed & (gs.commit_age >= gcfg.commit_timeout)
            committed = committed & ~stale
        wiped = refuted | stale
        steer = steer & ~wiped
        # only falsification by presence bans the centre
        bad_est = torch.where(refuted[:, None], est_used, gs.bad_est)
        bad_r = torch.where(refuted, r_ban, gs.bad_r)
        have_bad = gs.have_bad | refuted
        d_min = torch.where(committed, d_min, far)
        refutes = gs.refutes + wiped.to(i32)
        p_refutes = gs.p_refutes + refuted.to(i32)
        if gcfg.phantom_max_refutes > 0:
            concede_basis = refutes if gcfg.stale_concedes else p_refutes
            conceded = concede_basis >= gcfg.phantom_max_refutes
            steer = steer & ~conceded
            committed = committed & ~conceded
        commit_age = torch.where(committed, gs.commit_age + 1,
                                 torch.zeros_like(gs.commit_age))

        g_action = phase_action(pos2, est_used, cfg, gcfg.terminate_radius,
                                gcfg.deep_target, gcfg.setup_distance,
                                deep_take=gcfg.deep_take)

        # ---- crosswind transect sensing ----
        enter = (conc_n >= gcfg.enter_weak) & ~gs.tr_spent
        lost = low_streak >= gcfg.lost_patience
        spent = gs.tr_spent | (gs.tr_age >= gcfg.sense_patience)
        tr_mode = torch.where(
            enter, torch.ones_like(gs.tr_mode),
            torch.where(lost | spent, torch.zeros_like(gs.tr_mode),
                        gs.tr_mode))
        # turn back once per off-ridge excursion, then drift downwind
        flip = (~readable) & (low_streak == gcfg.flip_patience)
        tr_sign = torch.where(flip, -gs.tr_sign, gs.tr_sign)
        drift = torch.where(flip, _full(gs.drift, gcfg.drift_steps, i32),
                            gs.drift)
        u = torch.stack([torch.cos(theta), torch.sin(theta)], -1)   # [N, 2]
        want = torch.where(
            ((conc_n >= gcfg.safety_conc) | (drift > 0))[:, None],
            u,                                        # downwind
            tr_sign[:, None] * torch.stack([-u[:, 1], u[:, 0]], -1),
        )
        deltas = action_table(cfg, dev)[:, :2]
        dn = deltas / (norm2(deltas)[:, None] + 1e-9)
        land = pos2[:, None, :] + deltas[None]
        m = gcfg.edge_margin
        in_box = ((land >= m) & (land <= cfg.grid_size - m)).all(-1)
        penalty = (1e3 * (~in_box).to(torch.float32)
                   + 1e6 * (torch.arange(cfg.num_actions, device=dev)
                            == 0).to(torch.float32))
        tr_score = (dn[None] * want[:, None, :]).sum(-1) - penalty
        tr_action = torch.argmax(tr_score, dim=-1)

        sensing = ((tr_mode == 1) & ~steer & ~spent if gcfg.transect
                   else torch.zeros_like(ok))
        drift = torch.where(sensing & (drift > 0), drift - 1, drift)
        tr_age = gs.tr_age + sensing.to(i32)

        # ---- identifiability-triggered ridge ride ----
        riding = torch.zeros_like(ok)
        ride_action = policy_action.long()
        ride_count = gs.ride_count
        if gcfg.ride:
            to_est = est - pos2
            unident = (ambig > gcfg.ride_ambig_min
                       if gcfg.ride_ambig_min > 0 else ~ok)
            riding = (readable & ~steer & unident
                      & (n_eff >= gcfg.min_samples)
                      & (ride_count < gcfg.ride_budget)
                      & (norm2(to_est) > gcfg.ride_standoff)
                      & (conc_n < gcfg.safety_conc))
            sign_u = torch.where((to_est * u).sum(-1) >= 0.0, 1.0, -1.0)
            ride_score = ((dn[None] * (sign_u[:, None] * u)[:, None, :])
                          .sum(-1) - penalty)
            ride_action = torch.argmax(ride_score, dim=-1)
            ride_count = ride_count + riding.to(i32)

        # ---- resuming serpentine search ----
        step_count = gs.step_count + 1
        last_contact = torch.where(readable, step_count, gs.last_contact)
        searching = torch.zeros_like(ok)
        s_action = policy_action.long()
        sweep_down = gs.sweep_down
        if gcfg.search_after > 0:
            g = float(cfg.grid_size)
            mv = float(cfg.move_step)
            band_h = 1.12 * float(cfg.plume_sigma)
            x, y = pos[:, 0], pos[:, 1]
            at_top = y >= g - 1.2 * mv
            at_bot = y <= 1.2 * mv
            sweep_down = torch.where(
                at_top, torch.ones_like(sweep_down),
                torch.where(at_bot, torch.zeros_like(sweep_down),
                            sweep_down))
            band = torch.floor(y / band_h).to(i32)
            going_right = band % 2 == 0
            turn = torch.where(going_right, x >= g - 1.2 * mv,
                               x <= 1.2 * mv)
            a1, a2, a3, a4 = (_full(s_action, v, torch.int64)
                              for v in (1, 2, 3, 4))
            vert = torch.where(sweep_down, a2, a1)
            s_action = torch.where(turn, vert,
                                   torch.where(going_right, a3, a4))
            searching = (~steer & ~sensing & ~riding
                         & (step_count - last_contact >= gcfg.search_after))

        action = torch.where(
            steer, g_action,
            torch.where(riding, ride_action,
                        torch.where(sensing, tr_action,
                                    torch.where(searching, s_action,
                                                policy_action.long()))),
        ).to(policy_action.dtype)
        overriding = steer | sensing | riding | searching

        gs = dataclasses.replace(
            gs,
            est=est, theta=theta, est_ok=ok, committed=committed,
            est_good=est_good, theta_good=theta_good, commit_age=commit_age,
            phantom_count=phantom_count, mm_count=mm_count,
            mode=overriding.to(i32), tr_mode=tr_mode, tr_sign=tr_sign,
            low_streak=low_streak, tr_age=tr_age, tr_spent=spent,
            drift=drift, bad_est=bad_est, bad_r=bad_r, have_bad=have_bad,
            refutes=refutes, p_refutes=p_refutes, d_min=d_min,
            ride_count=ride_count, step_count=step_count,
            last_contact=last_contact, sweep_down=sweep_down,
            # a refuted or stale fit's samples are wiped
            w_buf=torch.where(wiped[:, None], torch.zeros_like(gs.w_buf),
                              gs.w_buf),
        )
        return gs, action, overriding

    return aniso_init(gcfg), step
