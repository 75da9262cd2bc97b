"""Bank-match terminal guidance for gridded fields over N episodes (port of
``tpu_plume/evaluation/bank_guide.py``, whose docstring gives the
measurements behind each rule).

An episode's field is one of the ``FieldBank``'s K rows, so locating its
source reduces to identifying the row that best explains the flight's own
(position, concentration) samples:

  - every step gathers all K rows' predictions at the agent's cell
    (``gridded.sample_bank``, linear in t and z for 4-D and 5-D banks) and
    adds each row's squared error against the debiased observation to its
    score, on informative steps only (the observation or some row's
    prediction in-plume);
  - the identification gate opens once the argmin row is stable across a
    check with ``min_contact`` in-plume reads, optionally behind a
    runner-up / best score ratio (``margin``) that expires at
    ``margin_until``; it stays open, and the dive steers at the latest
    argmin (or a seated row, ``sticky_target``) through
    ``guidance.phase_action``;
  - while it is shut, a resuming serpentine search (``search_after``), the
    rim guard (deflect landings inside any candidate's ball, steer to the
    top-2 rows' disagreement, fail open after ``rim_expire``), the entry
    rule (``entry_dive``) and the dive bias (``dive_bias``) shape the
    policy's move.

JAX steps one episode under ``vmap``; here ``score`` is f32[N, K], ``est``
f32[N, 2] and the other registers [N], with branch-free ``torch.where``
updates and no host read.  ``init`` is one episode's state (no episode
axis), as JAX's; ``stop.controllers.broadcast`` gives each episode its
copy.  Where JAX reads a length-5 vector at an action that 3-D flight may
make 5 or 6, its gather clamps the index to 4, and so does this one.
``lax.top_k``'s tie order (the lower row first) is a stable ascending sort
of the score here.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from tpu_plume_torch.core.config import EnvConfig
from tpu_plume_torch.env.methane import action_table
from tpu_plume_torch.evaluation.guidance import (
    _NOISE_STD_FRAC,
    norm2,
    phase_action,
)
from tpu_plume_torch.evaluation.oracle import staircase
from tpu_plume_torch.fields.gridded import sample_bank


@dataclass
class BankGuideState:
    score: torch.Tensor         # f32[N, K] accumulated squared error
    n_contact: torch.Tensor     # i32[N] in-plume samples ingested
    count: torch.Tensor         # i32[N] steps ingested
    match: torch.Tensor         # i32[N] current best row
    match_prev: torch.Tensor    # i32[N] best row at the previous check
    est_ok: torch.Tensor        # bool[N] identification gate open
    est: torch.Tensor           # f32[N, 2] dive row's source
    mode: torch.Tensor          # i32[N] 1 while overriding
    sweep_down: torch.Tensor    # bool[N] serpentine vertical direction
    last_contact: torch.Tensor  # i32[N] step of the latest in-plume read
    target: torch.Tensor        # i32[N] seated dive row (sticky_target)


def _at(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[n, idx[n]]`` for x [N, L] and idx [N], the index clamped to
    L - 1 as JAX's gather clamps it."""
    idx = torch.clamp(idx, max=x.shape[1] - 1).to(torch.int64)
    return torch.gather(x, 1, idx[:, None])[:, 0]


def make_bank_guide(
    cfg: EnvConfig,
    num_rows: int,
    *,
    check_every: int = 1,
    min_contact: int = 2,
    margin: float = 1.0,
    margin_until: int = 0,
    search_after: int | None = 50,
    rim_guard: bool = True,
    rim_expire: int = 400,
    guard_top: int = 0,
    entry_dive: bool = False,
    dive_bias: bool = False,
    sticky_target: bool = False,
    reseat_margin: float = 1.3,
    terminate_radius: float = 50.0,
    success_radius: float = 40.0,
):
    """``(init_state, step_fn)`` for ``evaluate_policy``'s guide hook over a
    bank of ``num_rows`` rows.  The step is marked ``needs_bank``: the
    harness calls ``step(gs, pos, conc, policy_action, bank, t)`` with the
    shared bank and each episode's step count before the move, and it
    returns ``(state', action, gate open)``."""
    if cfg.plume_model != "gridded":
        raise ValueError("--guide bank requires plume_model='gridded'")
    deep_target = min(success_radius - 10.0, 0.8 * terminate_radius)
    deep_take = min(success_radius - 5.0, float(terminate_radius))
    setup_distance = cfg.grid_size * cfg.move_frac + min(
        deep_target + 3.0, deep_take - 1.0)
    noise_mean = cfg.turbulence_intensity * (0.7978845608 + 0.1)
    # in-plume = 3 sigma of debiased turbulence noise above zero
    contact_floor = 3.0 * _NOISE_STD_FRAC * cfg.turbulence_intensity
    floor_n = contact_floor / cfg.conc_peak
    g = float(cfg.grid_size)
    m = float(cfg.move_step)
    band_h = 1.12 * float(cfg.plume_sigma)
    # the ball-avoidance margin: 2.5 sigma of the turbulence displacement
    avoid_r = terminate_radius + 2.5 * m * float(cfg.turb_displacement_coef)
    guarded_top = 0 < guard_top < num_rows
    # the static disambiguation's stride-8 subsample of the bank, taken
    # once per bank (the same values JAX reads from its rows every step)
    coarse = {}

    def init() -> BankGuideState:
        zi = torch.zeros((), dtype=torch.int32)
        return BankGuideState(
            score=torch.zeros(num_rows, dtype=torch.float32),
            n_contact=zi, count=zi, match=zi,
            match_prev=torch.full((), -1, dtype=torch.int32),
            est_ok=torch.zeros((), dtype=torch.bool),
            est=torch.zeros(2, dtype=torch.float32),
            mode=zi,
            sweep_down=torch.zeros((), dtype=torch.bool),
            last_contact=zi,
            target=torch.full((), -1, dtype=torch.int32),
        )

    def step(gs: BankGuideState, pos, conc, policy_action, bank, t):
        n, dev = pos.shape[0], pos.device
        i32 = torch.int32
        pos2 = pos[:, :2]
        # stay, +y, -y, +x, -x in the plane
        deltas = action_table(cfg, dev)[:5, :2]
        land = pos2[:, None, :] + deltas[None]                  # [N, 5, 2]
        centers = bank.source[:, :2]                            # [K, 2]
        rows = torch.arange(num_rows, device=dev)

        ij = torch.clamp(torch.floor(pos2).to(i32), 0, cfg.grid_size - 1)
        nk = (n, num_rows)
        preds = sample_bank(
            bank, rows[None, :], ij[:, 0:1], ij[:, 1:2],
            t=t[:, None].expand(nk),
            z=pos[:, 2:3].expand(nk) if cfg.env_3d else None,
        ) / cfg.conc_peak                                       # [N, K]
        obs = torch.clamp(conc - noise_mean, min=0.0) / cfg.conc_peak
        informative = (obs >= floor_n) | (preds.amax(-1) >= floor_n)
        score = gs.score + informative[:, None] * (obs[:, None] - preds) ** 2
        contact_now = conc - noise_mean >= contact_floor
        n_contact = gs.n_contact + contact_now.to(i32)
        count = gs.count + 1
        last_contact = torch.where(contact_now, count, gs.last_contact)

        match = torch.argmin(score, dim=-1).to(i32)
        do_check = (count % check_every == 0) & (n_contact >= min_contact)
        stable = match == gs.match_prev
        if num_rows >= 2:
            # lax.top_k(-score, k): the k smallest scores, the lower row
            # first among ties
            ranked, order = torch.sort(score, dim=-1, stable=True)
            best2, top2 = ranked[:, :2], order[:, :2]
        else:  # one row: no runner-up exists
            best2 = score.expand(n, 2)
            top2 = torch.zeros(n, 2, dtype=torch.int64, device=dev)
        if margin > 1.0:
            margin_ok = best2[:, 1] > margin * best2[:, 0]
            if margin_until > 0:
                margin_ok = margin_ok | (count >= margin_until)
            stable = stable & margin_ok
        est_ok = gs.est_ok | (do_check & stable)
        match_prev = torch.where(do_check, match, gs.match_prev)
        if sticky_target:
            seated = torch.where(gs.target >= 0, gs.target, match)
            better = _at(score, seated) > reseat_margin * _at(score, match)
            target = torch.where(est_ok & ~better, seated, match)
            dive_row = target
        else:
            target = gs.target
            dive_row = match
        src = bank.source[dive_row.to(torch.int64)]

        g_action = phase_action(pos2, src, cfg, terminate_radius,
                                deep_target, setup_distance,
                                deep_take=deep_take)
        if guarded_top:
            guard_centers = centers[order[:, :guard_top]]       # [N, M, 2]
            guard_active = n_contact >= 1
        else:
            guard_centers = centers[None].expand(n, num_rows, 2)
            guard_active = torch.ones(n, dtype=torch.bool, device=dev)

        def safe_move(a):
            # no landing within avoid_r of a guarded row's source: a
            # blocked move becomes the safe move most clockwise-tangential
            # around the nearest ball (the farthest landing where none is
            # safe)
            d_all = norm2(land[:, :, None, :]
                          - guard_centers[:, None, :, :])       # [N, 5, M]
            d_min = d_all.amin(-1)                              # [N, 5]
            near = torch.argmin(d_all[:, 0], dim=-1)
            u = pos2 - guard_centers[torch.arange(n, device=dev), near]
            tangent = torch.stack([u[:, 1], -u[:, 0]], -1)       # clockwise
            t_score = ((deltas[None, 1:] * tangent[:, None]).sum(-1)
                       / (norm2(tangent) + 1e-6)[:, None] / m)   # [N, 4]
            safe = d_min[:, 1:] > avoid_r
            pref = torch.where(safe, t_score + 1e-4 * d_min[:, 1:],
                               -1e3 + 1e-3 * d_min[:, 1:])
            sub = torch.argmax(pref, dim=-1) + 1
            a_ok = (_at(d_min, a) > avoid_r) | (a == 0) | ~guard_active
            return torch.where(a_ok, a, sub)

        def nearest_live():
            # the nearest ball the drone is not inside (standing inside a
            # ball that did not terminate proves its row wrong)
            d0 = norm2(pos2[:, None, :] - centers[None])        # [N, K]
            live = d0 > terminate_radius
            near = torch.argmin(torch.where(live, d0, 1e9), dim=-1)
            c = centers[near]                                   # [N, 2]
            return _at(live, near), c, norm2(land - c[:, None])  # dn [N, 5]

        def entry_rule(a):
            # forbid only the shallow chord into the nearest live ball,
            # substituting one step of the dive controller at that ball
            live_near, c, dn = nearest_live()
            kill = live_near[:, None] & (dn > deep_take) & (dn <= avoid_r)
            sub = phase_action(pos2, c, cfg, terminate_radius, deep_target,
                               setup_distance, deep_take=deep_take)
            return torch.where(_at(kill, a), sub, a)

        move_filter = entry_rule if entry_dive else safe_move

        fallback = policy_action.to(torch.int64)
        sweep_down = gs.sweep_down
        if search_after is not None:
            x, y = pos2[:, 0], pos2[:, 1]
            at_top = y >= g - 1.2 * m
            at_bot = y <= 1.2 * m
            sweep_down = torch.where(at_top, True,
                                     torch.where(at_bot, False, sweep_down))
            band = torch.floor(y / band_h).to(i32)
            going_right = band % 2 == 0
            turn = torch.where(going_right, x >= g - 1.2 * m, x <= 1.2 * m)
            vert = torch.where(sweep_down, 2, 1)
            s_action = move_filter(torch.where(
                turn, vert, torch.where(going_right, 3, 4)).to(torch.int64))
            # resume when contact dries up for another search_after steps
            searching = ~est_ok & (count - last_contact >= search_after)
            if rim_guard and not entry_dive:
                searching = searching & (count < rim_expire)
            fallback = torch.where(searching, s_action, fallback)
        if rim_guard:
            # active disambiguation: head for where the top-2 rows disagree
            if bank.conc.dim() == 3:
                if coarse.get("bank") is not bank:
                    coarse.update(bank=bank,
                                  conc=bank.conc[:, ::8, ::8].contiguous())
                sub = coarse["conc"][top2]                     # [N, 2, h, w]
                w_ = sub.shape[3]
                flat = torch.argmax(
                    torch.abs(sub[:, 0] - sub[:, 1]).reshape(n, -1), dim=-1)
                tgt = torch.stack([
                    (flat // w_).to(torch.float32) * 8.0 + 4.0,
                    (flat % w_).to(torch.float32) * 8.0 + 4.0], -1)
            else:
                # greedy 1-step: the four landings' predicted disagreement
                mv = deltas[1:]
                lp = torch.clamp(torch.floor(pos2[:, None, :] + mv[None]),
                                 0, cfg.grid_size - 1).to(i32)  # [N, 4, 2]
                n24 = (n, 2, 4)
                pr = sample_bank(
                    bank, top2[:, :, None], lp[:, None, :, 0],
                    lp[:, None, :, 1], t=t[:, None, None].expand(n24),
                    z=(pos[:, 2, None, None].expand(n24) if cfg.env_3d
                       else None))                              # [N, 2, 4]
                best = torch.argmax(torch.abs(pr[:, 0] - pr[:, 1]), dim=-1)
                tgt = pos2 + mv[best]
            disc = staircase(tgt - pos2)
            # fail open after rim_expire steps
            guard_on = count < rim_expire
            # a strictly separated top-2 only (noise leaves every row tied)
            have_evidence = best2[:, 1] > best2[:, 0]
            discriminating = (~est_ok & (n_contact >= min_contact)
                              & guard_on & have_evidence)
            fallback = torch.where(discriminating, disc, fallback)
            if not entry_dive:
                fallback = torch.where(guard_on, safe_move(fallback),
                                       fallback)
        if entry_dive:
            fallback = entry_rule(fallback)
        if dive_bias:
            # a move about to enter the nearest live ball strikes the
            # deepest of the five landings, where one lands <= deep_take
            live_near, _, dnb = nearest_live()
            entering = live_near & (_at(dnb, fallback) <= terminate_radius)
            strike = torch.argmin(dnb, dim=-1)
            do_strike = entering & (dnb.amin(-1) <= deep_take)
            fallback = torch.where(do_strike, strike, fallback)
        action = torch.where(est_ok, g_action, fallback).to(
            policy_action.dtype)
        gs = dataclasses.replace(
            gs, score=score, n_contact=n_contact, count=count,
            match=dive_row if sticky_target else match,
            match_prev=match_prev, est_ok=est_ok, est=src,
            mode=est_ok.to(i32), sweep_down=sweep_down,
            last_contact=last_contact, target=target)
        return gs, action, est_ok

    step.needs_bank = True
    return init(), step
