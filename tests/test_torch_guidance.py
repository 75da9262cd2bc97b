"""The model-fit terminal guide of the port (``evaluation/guidance.py``)
against the JAX package's, on the CPU.

- ``derive_guide_config`` field by field for ppo_v2_0, wrf_les's physics
  and the precision protocol, its refusal of ppo_v2_1 at radius 50, and
  ``make_guide``'s dispatch and refusals.
- ``phase_action`` on random positions and estimates.
- ``guide_step`` teacher-forced (``teacher_forced``): the port's guide
  flies episodes in closed loop with a scripted policy (mostly toward the
  source, sometimes a random move), recording each step's input state,
  (pos, conc, policy action) and outputs; JAX's vmapped step is then run
  from each recorded input state on the same inputs.  Also with the true
  source injected (``true_source=``).
- ``evaluate_policy(guide=)`` on ppo_v2_0 against JAX's given the draws
  JAX consumes (``jax_draws``), with the fit guide and with a
  ``needs_source`` guide.

Tolerances.  Actions, overrides and every integer and bool register equal;
floats rtol 1e-5 / atol 1e-4, but the estimate and the registers computed
from it (``est_good``, ``rad_bias``, the eval's ``guide_est``) rtol 1e-5 /
atol 1e-3 px: the packages sum the buffer's 128 samples in different
orders (about 1e-7 relative), which moves the estimate by up to about
3e-4 px, and ``rad_bias`` is a difference of two such distances of 60-100
px.  The estimate is compared where the fit passed the gates.  Elsewhere
(also in a committed guide, which steers on ``est_good``) the
trilateration's normal matrix may be
near-singular (one to a few collinear samples) and its solution is
rounding noise in both packages, so only the gate decisions are compared
there.  A gate can decide the other way when the fit lies within that
rounding of its boundary.  Such a step (one in 19200 of a 64 x 300 flight: the cross-check at 10.0296
px against a tolerance of 10.02958) is accepted only where one of the
step's gate quantities lies within ``GATE_MARGIN`` (relative) of its
bound, at most one step per flight; every other step must agree.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_plume.core.config import EnvConfig as JEnvConfig
from tpu_plume.core.config import get_preset as j_get_preset
from tpu_plume.evaluation import guidance as jgd
from tpu_plume.evaluation import harnesses as jh
from tpu_plume_torch.core.config import EnvConfig as TEnvConfig
from tpu_plume_torch.core.config import get_preset as t_get_preset
from tpu_plume_torch.env import methane as tenv
from tpu_plume_torch.evaluation import guidance as tgd
from tpu_plume_torch.evaluation import harnesses as th
from tpu_plume_torch.ops import plume
from tpu_plume_torch.stop.controllers import broadcast

from test_torch_eval import INWARD, _configs, jax_draws, models

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-4
EST_ATOL = 1e-3
# the registers computed from the fit's estimate
EST_FIELDS = ("est", "est_good", "rad_bias")
GATE_MARGIN = 1e-4
# A smaller domain with the reference's 25-px move and 31.25-px plume, so
# that most episodes reach the readable annulus within a few hundred steps.
SMALL = dict(grid_size=250, source_padding=25.0, move_frac=0.1)


@pytest.mark.parametrize("preset,terminate,success", [
    ("ppo_v2_0", 50.0, 40.0), ("ppo_v2_0", 5.0, 40.0),
    ("wrf_les", 5.0, 40.0), ("ppo_v2_1", 5.0, 50.0)])
def test_derive_guide_config_matches_jax(preset, terminate, success):
    want = jgd.derive_guide_config(j_get_preset(preset).env, terminate,
                                   success)
    got = tgd.derive_guide_config(t_get_preset(preset).env, terminate,
                                  success)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert dataclasses.asdict(tgd.GuideConfig()) == dataclasses.asdict(
        jgd.GuideConfig())


def test_derive_guide_config_refuses_ppo_v2_1_as_jax_does():
    with pytest.raises(ValueError) as want:
        jgd.derive_guide_config(j_get_preset("ppo_v2_1").env, 50.0, 50.0)
    with pytest.raises(ValueError) as got:
        tgd.derive_guide_config(t_get_preset("ppo_v2_1").env, 50.0, 50.0)
    assert str(got.value) == str(want.value)
    assert "hover-outside guidance infeasible" in str(got.value)


@pytest.mark.parametrize("kw", [{"env_3d": True},
                                {"plume_model": "gridded"}])
def test_make_guide_refuses_as_jax_does(kw):
    with pytest.raises(ValueError) as want:
        jgd.make_guide(JEnvConfig(**kw))
    with pytest.raises(ValueError) as got:
        tgd.make_guide(TEnvConfig(**kw))
    assert str(got.value) == str(want.value)


def test_make_guide_dispatches_and_overrides_as_jax_does():
    """The isotropic plume gets the trilateration with ``max_se`` applied;
    the anisotropic one the fit, with ``max_se`` and ``search_after``
    (negative clipped to 0, disabled)."""
    cfg = t_get_preset("ppo_v2_0").env
    init, _ = tgd.make_guide(cfg, max_se=3.5)
    assert isinstance(init, tgd.GuideState)
    assert init.pos_buf.shape == (128, 2)
    from tpu_plume_torch.evaluation import aniso_fit as taf

    wcfg = t_get_preset("wrf_les").env
    init, _ = tgd.make_guide(wcfg, terminate_radius=5.0, max_se=3.5,
                             search_after=-4)
    assert isinstance(init, taf.AnisoGuideState)
    assert init.null_pos.shape == (1, 2)


def test_phase_action_matches_jax():
    """5-way two-step lookahead: the same action for random positions,
    estimates and radial biases, including positions on the rings where
    scores tie (the first minimal action wins in both)."""
    cfg_j, cfg_t = j_get_preset("ppo_v2_0").env, t_get_preset("ppo_v2_0").env
    rng = np.random.default_rng(0)
    n = 512
    est = rng.uniform(60.0, 440.0, (n, 2)).astype(np.float32)
    ang = rng.uniform(0.0, 2 * np.pi, n)
    r = rng.uniform(20.0, 90.0, n)
    r[:64] = 50.0       # on the terminator: exact ties between moves
    ang[:64] = np.round(ang[:64] / (np.pi / 2)) * (np.pi / 2)
    pos = (est + np.stack([r * np.cos(ang), r * np.sin(ang)], -1)).astype(
        np.float32)
    bias = rng.uniform(-6.0, 6.0, n).astype(np.float32)
    for take, b in ((None, 0.0), (34.0, bias)):
        want = jax.vmap(lambda p, e, rb: jgd.phase_action(
            p, e, cfg_j, 50.0, 30.0, 54.0, deep_take=take,
            radial_bias=rb))(jnp.asarray(pos), jnp.asarray(est),
                             jnp.broadcast_to(jnp.asarray(b), (n,)))
        got = tgd.phase_action(torch.from_numpy(pos), torch.from_numpy(est),
                               cfg_t, 50.0, 30.0, 54.0, deep_take=take,
                               radial_bias=torch.as_tensor(b))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def scripted_flight(step_fn, init, cfg, n, length, seed, true_source=False):
    """``n`` episodes of ``length`` steps of the port's env on the CPU with
    the guide in the loop, from ``seed``: the policy moves along the
    larger axis gap toward the source 70% of the time, else at random, and
    the env executes the guide's action.  Episodes do not end (the guide
    also sees flights inside the goal ball).  Returns one tuple per step:
    (input state, pos, conc, policy action, source, outputs)."""
    rng = np.random.default_rng(seed)
    u = torch.from_numpy(rng.random((n, 2), dtype=np.float32))
    bits = torch.from_numpy(rng.integers(-2**31, 2**31, n, dtype=np.int64)
                            .astype(np.int32))
    u_wind = (torch.from_numpy(rng.random((n, 2), dtype=np.float32))
              if plume.reads_wind(cfg) else None)
    state, _ = tenv.reset_from_draws(u, u_wind, bits, cfg)
    gs = broadcast(init, n, "cpu")
    steps = []
    for _ in range(length):
        gap = (state.field.source - state.pos[:, :2]).numpy()
        toward = np.where(np.abs(gap[:, 0]) >= np.abs(gap[:, 1]),
                          np.where(gap[:, 0] > 0, 3, 4),
                          np.where(gap[:, 1] > 0, 1, 2))
        act = np.where(rng.random(n) < 0.7, toward, rng.integers(0, 5, n))
        act = torch.from_numpy(act.astype(np.int64))
        args = (gs, state.pos, state.conc, act)
        if true_source:
            args += (state.field.source,)
        out = step_fn(*args)
        steps.append((gs, state.pos, state.conc, act,
                      state.field.source, out))
        gs = out[0]
        turb = torch.from_numpy(rng.standard_normal((n, 2),
                                                    dtype=np.float32))
        state, _ = tenv.step_noise(state, out[1], turb, cfg)
    return steps


def to_jax(state, cls):
    return cls(**{f.name: jnp.asarray(getattr(state, f.name).numpy())
                  for f in dataclasses.fields(state)})


def iso_gate_margin(gin, gout, pos, conc, cfg, gcfg) -> np.ndarray:
    """Per episode, the smallest relative distance of one of the step's
    gate quantities to its bound, recomputed by the port from the ingested
    buffers: the robust cut of each reweighting pass, se, the residual and
    the cross-check, and the pointwise distance's change against zero and
    against ``radial_move_min``."""
    w = gout.w_buf
    est, resid, se, _ = tgd._wlls(gout.pos_buf, gout.r2_buf, w)
    ring = torch.sqrt(torch.clamp(gout.r2_buf, min=0.0))
    margins = []
    for _ in range(2):
        err = torch.abs(tgd.norm2(gout.pos_buf - est[:, None]) - ring)
        order = torch.argsort(err, dim=-1, stable=True)
        cum = torch.cumsum(torch.gather(w, -1, order), -1)
        at = torch.clamp(torch.searchsorted(cum, 0.5 * w.sum(-1,
                                                             keepdim=True)),
                         max=w.shape[-1] - 1)
        med = torch.gather(err, -1, torch.gather(order, -1, at))[:, 0]
        cut = torch.clamp(2.5 * med, min=gcfg.resid_floor)
        rel = torch.where(w > 0, torch.abs(err - cut[:, None]) / cut[:, None],
                          torch.full_like(err, np.inf))
        margins.append(rel.amin(-1))
        w = gout.w_buf * (err <= cut[:, None])
        est, resid, se, _ = tgd._wlls(gout.pos_buf, gout.r2_buf, w)
    margins.append(torch.abs(se - gcfg.max_se) / gcfg.max_se)
    margins.append(torch.abs(resid - gcfg.max_residual) / gcfg.max_residual)
    noise_mean = cfg.turbulence_intensity * (0.7978845608 + 0.1)
    conc_n = (conc - noise_mean) / cfg.conc_peak
    d_point = torch.sqrt(torch.clamp(
        -2.0 * cfg.plume_sigma ** 2 * torch.log(torch.clamp(conc_n,
                                                            min=1e-6)),
        min=0.0))
    cross = torch.abs(tgd.norm2(pos[:, :2] - est) - d_point)
    margins.append(torch.where(
        conc_n >= gcfg.cross_check_conc,
        torch.abs(cross - gcfg.cross_check_tol) / gcfg.cross_check_tol,
        torch.full_like(cross, np.inf)))
    delta = torch.abs(d_point - gin.d_prev)
    margins.append(delta / torch.clamp(d_point, min=1.0))
    margins.append(torch.abs(delta - gcfg.radial_move_min)
                   / gcfg.radial_move_min)
    return torch.stack(margins).amin(0).numpy()


def teacher_forced(steps, j_step, j_init, float_tol, est_tol, margin_fn,
                   est_fields=EST_FIELDS, fit_fields=("est",), active=None,
                   angle_fields=(), angle_tol=0.0):
    """Replay the recorded inputs through JAX's vmapped step in one
    ``lax.scan`` from the broadcast initial state, each package carrying
    its own state, and compare every step's outputs with the port's (see
    the module docstring): ``fit_fields`` (the current fit) where it
    passed the gates and ``est_fields`` at ``est_tol``, the other floats at
    ``float_tol``; ``angle_fields`` modulo 2 pi within ``angle_tol``.
    ``active`` bool[T, N] freezes an episode's
    state after its last active step, as the eval does.  An episode whose
    gate decides the other way within ``GATE_MARGIN`` of its bound is
    dropped from the comparison from that step on; returns the mask of the
    dropped episodes."""
    n = steps[0][1].shape[0]
    xs = tuple(jnp.asarray(np.stack([s[k].numpy() for s in steps]))
               for k in (1, 2, 3, 4))
    if active is None:
        active = np.ones((len(steps), n), bool)
    xs += (jnp.asarray(active),)

    def body(gs, x):
        *x, live = x
        new, act, over = j_step(gs, *x)
        kept = jax.tree.map(lambda a, b: jnp.where(
            live.reshape((-1,) + (1,) * (a.ndim - 1)), a, b), new, gs)
        return kept, (new, act, over)

    gs0 = jax.tree.map(lambda x: jnp.broadcast_to(x, (n,) + x.shape), j_init)
    _, (states, acts, overs) = jax.jit(
        lambda g, x: jax.lax.scan(body, g, x))(gs0, xs)
    alive = np.ones(n, bool)
    for t, (gin, pos, conc, act, src, (gout, a_t, o_t)) in enumerate(steps):
        differ = ((np.asarray(acts[t]) != a_t.numpy())
                  | (np.asarray(overs[t]) != o_t.numpy()))
        for f in dataclasses.fields(gout):
            x = np.asarray(getattr(states, f.name)[t])
            if x.dtype.kind in "biu":
                differ |= (x != getattr(gout, f.name).numpy()).reshape(
                    n, -1).any(-1)
        differ &= alive
        if differ.any():
            margin = margin_fn(gin, gout, pos, conc)[differ]
            assert (margin < GATE_MARGIN).all(), (t, np.nonzero(differ),
                                                  margin)
            alive &= ~differ
        fit = gout.est_ok.numpy() & alive
        for f in dataclasses.fields(gout):
            x = np.asarray(getattr(states, f.name)[t])
            if x.dtype.kind != "f":
                continue
            rows = fit if f.name in fit_fields else alive
            got = getattr(gout, f.name).numpy()[rows]
            if f.name in angle_fields:
                gap = (got - x[rows] + np.pi) % (2 * np.pi) - np.pi
                assert np.abs(gap).max(initial=0.0) <= angle_tol, (t, f.name)
                continue
            tol = est_tol if f.name in est_fields else float_tol
            np.testing.assert_allclose(got, x[rows], err_msg=(t, f.name),
                                       **tol)
    return ~alive


# The guide's options that are off by default (in both packages), on: the
# estimate's signs and the tangential band in the hover geometry, the
# hover veto, sign-aware out-steps, a consistency requirement before
# in-probes, the dive warm-up and the take band's relaxation, an early
# stuck-hover fallback dive and a softer estimate blend.
ISO_OPTIONS = dict(est_signs=True, tangential_band=20.0,
                   hover_veto_margin=5.0, sign_aware_out=True,
                   probe_consistency=2, dive_warmup=2, take_relax_age=30,
                   fallback_patience=40, max_se_fallback=8.0, est_ema=0.5)


@pytest.mark.parametrize("case", ["protocol", "precision", "truth",
                                  "options"])
def test_guide_steps_teacher_forced_match_jax(case):
    """32 flights x 160 steps of the SMALL domain around a source, at the
    protocol's radius 50, the precision protocol's radius 5, at radius 50
    with the true source injected, and at radius 50 with ISO_OPTIONS."""
    jcfg, tcfg = _configs("ppo_v2_0", SMALL)
    terminate = 5.0 if case == "precision" else 50.0
    jg = jgd.derive_guide_config(jcfg.env, terminate, 40.0)
    tg = tgd.derive_guide_config(tcfg.env, terminate, 40.0)
    if case == "options":
        jg = dataclasses.replace(jg, **ISO_OPTIONS)
        tg = dataclasses.replace(tg, **ISO_OPTIONS)
    truth = case == "truth"

    def t_step(gs, pos, conc, act, src=None):
        return tgd.guide_step(gs, pos, conc, act, tcfg.env, tg,
                              true_source=src)

    j_step = jax.vmap(
        lambda gs, p, c, a, s: jgd.guide_step(
            gs, p, c, a, jcfg.env, jg, true_source=s if truth else None))
    steps = scripted_flight(t_step, tgd.guide_init(tg), tcfg.env, 32, 160,
                            seed=7, true_source=truth)
    dropped = teacher_forced(
        steps, j_step, jgd.guide_init(jg), dict(rtol=RTOL, atol=ATOL),
        dict(rtol=RTOL, atol=EST_ATOL),
        lambda gin, gout, pos, conc: iso_gate_margin(gin, gout, pos, conc,
                                                     tcfg.env, tg))
    assert dropped.sum() <= 1
    last = steps[-1][-1][0]
    # the flights engaged every tier: hover, validated fits, dives
    assert last.committed.any() and (last.mode == 1).any()
    assert last.count.min() > 0


def recording(guide):
    """``guide`` with its step recording each call as ``scripted_flight``
    records it; returns (guide, the list of steps)."""
    init, fn = guide
    steps = []

    def step(gs, pos, conc, act, *src):
        out = fn(gs, pos, conc, act, *src)
        steps.append((gs, pos, conc, act, src[0] if src else pos, out))
        return out
    step.needs_source = getattr(fn, "needs_source", False)
    return (init, step), steps


def guided_eval(preset, n, length, jguide, tguide, j_step, j_init, margin,
                env=SMALL, seed=3, rtol=RTOL, atol=ATOL, est_atol=EST_ATOL,
                **replay):
    """``n`` episodes of ``length`` steps of each package's
    ``evaluate_policy`` with the guides ``jguide(cfg)`` and ``tguide(cfg)``
    given the draws JAX consumes, compared episode by episode
    (``compare_guided``).  The port's guide steps are recorded and replayed
    through JAX's (``teacher_forced`` with ``j_step``, ``j_init`` and
    ``margin`` and the keywords ``replay``, the episodes frozen after their
    last step): an episode may
    part only where a gate decided the other way within ``GATE_MARGIN`` of
    its bound, at most one in 64.  Returns the port's metrics."""
    jcfg, tcfg = _configs(preset, env)
    jm, jp, tm = models(tcfg.env, bias=INWARD)
    key = jax.random.PRNGKey(seed)
    draws = jax_draws(key, tcfg.env, n, length)
    jmet = jh.evaluate_policy(jp, jm.apply, jcfg.env, jcfg.eval, key,
                              num_episodes=n, max_steps=length,
                              guide=jguide(jcfg))
    guide, steps = recording(tguide(tcfg))
    tmet = th.evaluate_policy(tm, tcfg.env, tcfg.eval, draws=draws,
                              num_episodes=n, max_steps=length, device="cpu",
                              guide=guide)
    active = np.arange(length)[:, None] < tmet.steps[None, :]
    dropped = teacher_forced(steps, j_step(jcfg), j_init(jcfg),
                             dict(rtol=rtol, atol=atol),
                             dict(rtol=rtol, atol=est_atol),
                             lambda *a: margin(tcfg, *a), active=active,
                             **replay)
    assert dropped.sum() <= max(1, n // 64)
    keep = ~dropped
    compare_guided(jmet, tmet, keep, rtol, atol, est_atol)
    return tmet


def compare_guided(jmet, tmet, keep, rtol=RTOL, atol=ATOL,
                   est_atol=EST_ATOL):
    """Steps, success and the integer and bool guide fields equal; the
    deviations, the closest approaches and (where the fit validated) the
    estimates at the float tolerance; over the episodes ``keep``."""
    for name in ("steps", "success", "stopped_early", "guide_hover",
                 "guide_fit_ok", "guide_samples", "guide_refutes",
                 "guide_committed", "guide_match", "field_idx",
                 "guide_contacts"):
        got, want = getattr(tmet, name), np.asarray(getattr(jmet, name))
        assert got.dtype == want.dtype and got.shape == want.shape, name
        np.testing.assert_array_equal(got[keep], want[keep], err_msg=name)
    for name in ("deviations", "final_conc", "guide_dmin"):
        np.testing.assert_allclose(getattr(tmet, name)[keep],
                                   np.asarray(getattr(jmet, name))[keep],
                                   rtol=rtol, atol=atol, err_msg=name)
    fit = tmet.guide_fit_ok & keep
    assert tmet.guide_est.dtype == np.float32
    np.testing.assert_allclose(tmet.guide_est[fit],
                               np.asarray(jmet.guide_est)[fit], rtol=rtol,
                               atol=est_atol)


def iso_margin(tcfg, gin, gout, pos, conc):
    return iso_gate_margin(gin, gout, pos, conc, tcfg.env,
                           tgd.derive_guide_config(tcfg.env, 50.0, 40.0))


def iso_j_step(jcfg, truth=False):
    jg = jgd.derive_guide_config(jcfg.env, 50.0, 40.0)
    return jax.vmap(lambda gs, p, c, a, s: jgd.guide_step(
        gs, p, c, a, jcfg.env, jg, true_source=s if truth else None))


def iso_j_init(jcfg):
    return jgd.guide_init(jgd.derive_guide_config(jcfg.env, 50.0, 40.0))


def test_guided_eval_matches_jax():
    """64 episodes x 300 steps of ppo_v2_0's physics on the SMALL domain,
    the protocol's radius 50: every guide tier engages in some episodes."""
    tmet = guided_eval(
        "ppo_v2_0", 64, 300,
        lambda c: jgd.make_guide(c.env, success_radius=40.0),
        lambda c: tgd.make_guide(c.env, success_radius=40.0),
        iso_j_step, iso_j_init, iso_margin)
    assert tmet.guide_committed.any() and tmet.guide_hover.any()
    assert tmet.success.any()


def test_guided_eval_passes_the_true_source_as_jax_does():
    """A ``needs_source`` step receives each episode's true source (the
    truth-injection diagnostic of scripts/guide_truth.py)."""
    def with_truth(make_cfg, step, init_of):
        def build(c):
            gcfg = make_cfg(c.env, 50.0, 40.0)

            def fn(gs, pos, conc, act, src):
                return step(gs, pos, conc, act, c.env, gcfg, true_source=src)
            fn.needs_source = True
            return init_of(gcfg), fn
        return build

    tmet = guided_eval(
        "ppo_v2_0", 32, 200,
        with_truth(jgd.derive_guide_config, jgd.guide_step, jgd.guide_init),
        with_truth(tgd.derive_guide_config, tgd.guide_step, tgd.guide_init),
        lambda c: iso_j_step(c, truth=True), iso_j_init, iso_margin)
    assert tmet.guide_committed.any()


def test_eval_refuses_a_bank_guide_naming_slice_9b():
    """Refused until slice 9b was ported: a ``needs_bank`` step now
    receives the bank, shared by the episodes, and each episode's step
    count before the move (``tests/test_torch_bankguide.py`` holds the
    bank guide itself to JAX's)."""
    _, tcfg = _configs("ppo_v2_0", dict(SMALL, plume_model="gridded"))
    _, _, tm = models(tcfg.env)
    from tpu_plume_torch.evaluation.bank_guide import make_bank_guide
    from tpu_plume_torch.fields.gridded import synthesize_bank

    bank = synthesize_bank(torch.Generator().manual_seed(0), tcfg.env,
                           num_fields=3)
    init, step = make_bank_guide(tcfg.env, 3)
    seen = []

    def fn(gs, pos, conc, act, b, t):
        seen.append((b, t.clone()))
        return step(gs, pos, conc, act, b, t)
    fn.needs_bank = True
    m = th.evaluate_policy(tm, tcfg.env, tcfg.eval,
                           torch.Generator().manual_seed(0), num_episodes=4,
                           max_steps=5, device="cpu", bank=bank,
                           guide=(init, fn))
    assert all(b is bank for b, _ in seen)
    assert [t.tolist() for _, t in seen[:2]] == [[0] * 4, [1] * 4]
    assert (m.guide_samples == m.steps).all()
    assert (m.field_idx >= 0).all() and (m.field_idx < 3).all()
