"""The anisotropic model-fit guide of the port (``evaluation/aniso_fit.py``)
against the JAX package's, on the CPU.

- ``derive_aniso_config`` field by field; ``make_aniso_guide``'s refusals.
- The model and its closed-form Jacobian against ``make_model_n`` and
  ``jax.jacfwd`` of JAX's residual; ``_inv3`` bit-equal.
- ``fit_aniso`` on the fixed buffers of ``tests/test_aniso_fit.py`` (the
  noiseless transects, co-located samples, the null reads, the
  out-of-domain source and the short ridge segment).
- The guide's step teacher-forced: the port's guide flies wrf_les episodes
  with a scripted policy, recording every step's (pos, conc, policy
  action), and JAX's vmapped step replays them in one ``lax.scan``.
- ``evaluate_policy(guide=)`` on wrf_les against JAX's given its draws.
- The ridge ride and the crosswind transect teacher-forced with the fit
  held fixed in both packages (a table picked by the sample count), so
  that their logic is compared step for step apart from the fit.

Tolerances.  Actions, overrides and every integer and bool register are
equal at every step (a gate within rounding of its bound may decide the
other way, as tests/test_torch_guidance.py accounts for it).  The fit's
floats where it converged on an identifying geometry: on the fixed
noiseless cases est within 1e-2 px, theta within 1e-4 rad, se rtol 1e-3;
on the flights' validated fits est (and the registers computed from it)
within 0.25 px and theta within 1e-2 rad modulo 2 pi.  The Gauss-Newton
steps sum 128 products in a different order than XLA's (about 1e-7
relative), and on noisy samples the 16 damped iterations stop short of
the minimum (the last step still moves the estimate by about 0.1 px), so
the two paths end up to 0.18 px and 4e-3 rad apart (measured), and a start's angle may
end a turn apart.  Where the fit has not validated, the
normal matrix is near-singular (a few collinear samples) or several starts
tie near zero loss: the estimate is then rounding noise in both packages
(tens of px apart with one to three samples) and only the gate decisions
are compared.  The Jacobian rtol 1e-3 / atol 1e-6 of the largest entry
(XLA's CPU code contracts multiply-adds; the unit wind's norm derivative,
zero up to rounding, is left out).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_plume.core.config import EnvConfig as JEnvConfig
from tpu_plume.core.config import get_preset as j_get_preset
from tpu_plume.evaluation import aniso_fit as ja
from tpu_plume_torch.core.config import EnvConfig as TEnvConfig
from tpu_plume_torch.core.config import get_preset as t_get_preset
from tpu_plume_torch.evaluation import aniso_fit as ta
from tpu_plume_torch.stop.controllers import broadcast

torch.set_num_threads(1)

EST_ATOL, THETA_ATOL, SE_RTOL = 1e-2, 1e-4, 1e-3
# the flights' validated fits (see the module docstring)
FLIGHT_EST_ATOL, FLIGHT_THETA_ATOL = 0.25, 1e-2
# how the flights' replay compares the fit's registers
FLIGHT_FIELDS = dict(
    est_fields=("est", "est_good", "bad_est", "d_min", "bad_r"),
    fit_fields=("est", "theta"), angle_fields=("theta", "theta_good"),
    angle_tol=FLIGHT_THETA_ATOL)


def _wrf(cls, **kw):
    """The fixed-case physics of tests/test_aniso_fit.py."""
    return cls(plume_model="anisotropic", plume_sigma=15.0,
               wind_speed_range=(1.0, 4.0), **kw)


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


@pytest.mark.parametrize("preset,terminate,success", [
    ("wrf_les", 50.0, 40.0), ("wrf_les", 5.0, 40.0), ("ppo_v2_0", 50.0, 40.0)])
def test_derive_aniso_config_matches_jax(preset, terminate, success):
    want = ja.derive_aniso_config(j_get_preset(preset).env, terminate, success)
    got = ta.derive_aniso_config(t_get_preset(preset).env, terminate, success)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert dataclasses.asdict(ta.AnisoGuideConfig()) == dataclasses.asdict(
        ja.AnisoGuideConfig())


@pytest.mark.parametrize("kw,match", [
    ({"env_3d": True}, "2-D"),
    ({"plume_model": "isotropic"}, "requires plume_model='anisotropic'"),
    ({"num_sources": 3}, "single source")])
def test_make_aniso_guide_refuses_as_jax_does(kw, match):
    for cls, make in ((JEnvConfig, ja.make_aniso_guide),
                      (TEnvConfig, ta.make_aniso_guide)):
        base = dict(plume_model="anisotropic", wind_speed_range=(1.0, 4.0))
        with pytest.raises(ValueError, match=match):
            make(cls(**{**base, **kw}))


def _transect_points(src, theta):
    u = np.array([np.cos(theta), np.sin(theta)])
    v = np.array([-np.sin(theta), np.cos(theta)])
    return np.stack([src + d * u + cw * v for d in (80.0, 140.0, 220.0)
                     for cw in np.linspace(-25.0, 25.0, 9)]).astype(
                         np.float32), u, v


def test_model_and_jacobian_match_jax():
    """The fit's model is ``make_model_n`` bit for bit, and its Jacobian is
    JAX's ``jacfwd`` of the residual, at 64 random positions around 8
    sources and wind angles (a start fan around each)."""
    jcfg, tcfg = _wrf(JEnvConfig), _wrf(TEnvConfig)
    rng = np.random.default_rng(0)
    src = rng.uniform(100.0, 400.0, (3, 8, 2)).astype(np.float32)
    theta = rng.uniform(-np.pi, np.pi, (3, 8)).astype(np.float32)
    pos = (src[:, :1] + rng.normal(0.0, 60.0, (3, 64, 2))).astype(np.float32)
    model, jac = ta._model_and_jac(_t(pos), _t(src), _t(theta), tcfg)
    tmodel = ta.make_model_n(tcfg)
    np.testing.assert_array_equal(
        model.numpy(),
        tmodel(_t(pos)[:, None], _t(src), _t(theta)).numpy())
    jmodel = ja.make_model_n(jcfg)
    got = torch.stack(jac, -1).numpy()
    for b in range(3):
        for s in range(8):
            def f(p, b=b):
                return jmodel(jnp.asarray(pos[b]), p[:2], p[2])
            params = jnp.asarray(np.r_[src[b, s], theta[b, s]])
            np.testing.assert_allclose(model[b, s].numpy(),
                                       np.asarray(f(params)), rtol=1e-4,
                                       atol=1e-6)
            want = np.asarray(jax.jacfwd(f)(params))
            np.testing.assert_allclose(
                got[b, s], want, rtol=1e-3,
                atol=1e-6 * np.abs(want).max(), err_msg=(b, s))


def test_inv3_is_jax_bit_for_bit():
    a = np.random.default_rng(1).normal(size=(64, 3, 3)).astype(np.float32)
    want = np.stack([np.asarray(ja._inv3(jnp.asarray(x))) for x in a])
    np.testing.assert_array_equal(ta._inv3(_t(a)).numpy(), want)


def _fit_both(pos, c, w, jcfg, tcfg, jg, tg, null_pos=None, null_w=None,
              ambiguity=False):
    kw = {} if null_pos is None else dict(null_pos=jnp.asarray(null_pos),
                                          null_w=jnp.asarray(null_w))
    want = ja.fit_aniso(jnp.asarray(pos), jnp.asarray(c), jnp.asarray(w),
                        jcfg, jg, return_ambiguity=ambiguity, **kw)
    tkw = {} if null_pos is None else dict(null_pos=_t(null_pos)[None],
                                           null_w=_t(null_w)[None])
    got = ta.fit_aniso(_t(pos)[None], _t(c)[None], _t(w)[None], tcfg, tg,
                       return_ambiguity=ambiguity, **tkw)
    return ([np.asarray(x) for x in want], [x[0].numpy() for x in got])


def _assert_fit(want, got, validated=True):
    assert int(got[3]) == int(want[3])          # n_eff
    if validated:
        np.testing.assert_allclose(got[0], want[0], atol=EST_ATOL)
        np.testing.assert_allclose(got[1], want[1], atol=THETA_ATOL)
        np.testing.assert_allclose(got[2], want[2], rtol=SE_RTOL)


def test_fit_on_noiseless_transects_matches_jax():
    """tests/test_aniso_fit.py:29-56: three crosswind transects pin the
    source; est, theta, se, n_eff and the ambiguity spread as JAX's."""
    jcfg, tcfg = _wrf(JEnvConfig), _wrf(TEnvConfig)
    src, theta = np.array([220.0, 310.0], np.float32), 0.9
    pos, _, _ = _transect_points(src, theta)
    c = np.asarray(ja.make_model_n(jcfg)(jnp.asarray(pos), jnp.asarray(src),
                                         theta))
    w = (c >= 0.03).astype(np.float32)
    want, got = _fit_both(pos, c, w, jcfg, tcfg, ja.AnisoGuideConfig(),
                          ta.AnisoGuideConfig(), ambiguity=True)
    _assert_fit(want, got)
    assert np.linalg.norm(got[0] - src) < 2.0
    np.testing.assert_allclose(got[4], want[4], atol=EST_ATOL)
    assert float(got[4]) < 10.0


def test_fit_of_co_located_samples_does_not_validate_as_in_jax():
    """tests/test_aniso_fit.py:58-67: one point 32 times; se far past the
    gate in both packages (the estimate itself is unidentified)."""
    pos = np.tile(np.array([[250.0, 250.0]], np.float32), (32, 1))
    c, w = np.full(32, 0.2, np.float32), np.ones(32, np.float32)
    want, got = _fit_both(pos, c, w, _wrf(JEnvConfig), _wrf(TEnvConfig),
                          ja.AnisoGuideConfig(), ta.AnisoGuideConfig())
    _assert_fit(want, got, validated=False)
    assert got[2] > 4.0 and want[2] > 4.0


def test_fit_with_null_reads_matches_jax():
    """tests/test_aniso_fit.py:245-270: consistent nulls leave the fit
    where it was, in both packages."""
    jcfg = _wrf(JEnvConfig, max_steps=500)
    tcfg = _wrf(TEnvConfig, max_steps=500)
    jg = ja.derive_aniso_config(jcfg, terminate_radius=5.0)
    tg = ta.derive_aniso_config(tcfg, terminate_radius=5.0)
    src, theta = np.array([220.0, 310.0], np.float32), 0.9
    pos, _, v = _transect_points(src, theta)
    c = np.asarray(ja.make_model_n(jcfg)(jnp.asarray(pos), jnp.asarray(src),
                                         theta))
    w = np.ones(pos.shape[0], np.float32)
    far = np.tile((src + 120.0 * v)[None].astype(np.float32), (8, 1))
    want, got = _fit_both(pos, c, w, jcfg, tcfg, jg, tg, null_pos=far,
                          null_w=np.ones(8, np.float32))
    _assert_fit(want, got)
    assert got[2] <= tg.max_se


def test_fit_of_an_out_of_domain_source_matches_jax():
    """tests/test_aniso_fit.py:297-328's geometry (a source 30 px outside
    the spawn domain) with the domain gate on and off."""
    jcfg = _wrf(JEnvConfig, max_steps=500)
    tcfg = _wrf(TEnvConfig, max_steps=500)
    src, theta = np.array([20.0, 250.0], np.float32), 0.0
    pos, _, _ = _transect_points(src, theta)
    c = np.asarray(ja.make_model_n(jcfg)(jnp.asarray(pos), jnp.asarray(src),
                                         theta))
    w = (c >= 0.03).astype(np.float32)
    for slack in (-1.0, 8.0):
        jg = dataclasses.replace(ja.derive_aniso_config(jcfg, 5.0),
                                 domain_slack=slack)
        tg = dataclasses.replace(ta.derive_aniso_config(tcfg, 5.0),
                                 domain_slack=slack)
        want, got = _fit_both(pos, c, w, jcfg, tcfg, jg, tg)
        _assert_fit(want, got, validated=want[2] <= jg.max_se)
        assert (got[2] <= tg.max_se) == (want[2] <= jg.max_se)


def test_ambiguity_of_a_short_ridge_segment_matches_jax():
    """tests/test_aniso_fit.py:362-389: a short segment along the ridge
    leaves near-best modes 100+ px apart and does not validate."""
    jcfg, tcfg = _wrf(JEnvConfig), _wrf(TEnvConfig)
    src, theta = np.array([220.0, 310.0], np.float32), 0.9
    u = np.array([np.cos(theta), np.sin(theta)])
    pos = np.stack([src + d * u for d in np.linspace(100.0, 130.0, 8)]
                   ).astype(np.float32)
    c = np.asarray(ja.make_model_n(jcfg)(jnp.asarray(pos), jnp.asarray(src),
                                         theta))
    want, got = _fit_both(pos, c, np.ones(8, np.float32), jcfg, tcfg,
                          ja.AnisoGuideConfig(), ta.AnisoGuideConfig(),
                          ambiguity=True)
    _assert_fit(want, got, validated=False)
    assert got[2] > 4.0 and want[2] > 4.0
    assert got[4] > 100.0 and want[4] > 100.0


def aniso_gate_margin(tcfg, gcfg, gin, gout, pos, conc) -> np.ndarray:
    """Per episode, the smallest relative distance of one of the step's
    gate quantities to its bound, recomputed by the port from the step's
    ingested buffers: se against ``max_se``, the estimate against the
    domain box and the ban ball, and the distance to the used estimate
    against the phantom trigger."""
    noise_mean = tcfg.turbulence_intensity * (0.7978845608 + 0.1)
    conc_n = (conc - noise_mean) / tcfg.conc_peak
    accept = (conc_n >= gcfg.conc_floor) & (conc_n <= gcfg.conc_ceil)
    slot = (torch.arange(gcfg.buffer_size)[None]
            == (gin.count % gcfg.buffer_size)[:, None]) & accept[:, None]
    pos_buf = torch.where(slot[..., None], pos[:, None, :2], gin.pos_buf)
    c_buf = torch.where(slot, conc_n[:, None], gin.c_buf)
    w_buf = torch.where(slot, 1.0, gin.w_buf)
    est, _, se, _ = ta.fit_aniso(pos_buf, c_buf, w_buf, tcfg, gcfg)
    lo = tcfg.source_padding - gcfg.domain_slack
    hi = tcfg.grid_size - tcfg.source_padding + gcfg.domain_slack
    margins = [torch.abs(se - gcfg.max_se) / gcfg.max_se,
               torch.minimum(torch.abs(est - lo),
                             torch.abs(est - hi)).amin(-1) / hi]
    ban = torch.abs(torch.sqrt(((est - gin.bad_est) ** 2).sum(-1))
                    - gin.bad_r) / torch.clamp(gin.bad_r, min=1.0)
    margins.append(torch.where(gin.have_bad, ban, np.inf))
    margin_eff = max(min(gcfg.phantom_margin, 0.1 * gcfg.terminate_radius),
                     gcfg.phantom_se_mult * gcfg.max_se)
    trigger = gcfg.terminate_radius - margin_eff
    d_here = torch.sqrt(((pos[:, :2] - gout.est_good) ** 2).sum(-1))
    margins.append(torch.abs(d_here - trigger) / max(abs(trigger), 1.0))
    return torch.stack(margins).amin(0).numpy()


# the wrf_les physics on the small domain of tests/test_torch_guidance.py
SMALL = dict(grid_size=250, source_padding=25.0, move_frac=0.1)


# The fit guide's options that are off by default (in both packages), on:
# the null reads, the prediction-mismatch refutation, the peak tie-break,
# stale refutations counting toward concession, the serpentine search and
# an estimate blend.  The crosswind transect and the ridge ride steer by
# the current fit's wind angle before it validates, which at one to a few
# samples is rounding noise in both packages: they are held to JAX's with
# the fit held fixed
# (``test_ride_and_transect_tiers_teacher_forced_match_jax``).
ANISO_OPTIONS = dict(null_buffer=16, mismatch_patience=3,
                     peak_tiebreak=1.3, stale_concedes=True, search_after=30,
                     est_ema=0.5)


@pytest.mark.parametrize("terminate,options", [(50.0, False), (5.0, False),
                                               (50.0, True)])
def test_aniso_steps_teacher_forced_match_jax(terminate, options):
    """24 wrf_les flights x 120 steps with the port's guide in the loop
    (``scripted_flight`` of tests/test_torch_guidance.py), at the
    protocol's radius 50, the precision protocol's radius 5 and at radius
    50 with ANISO_OPTIONS, replayed through JAX's vmapped step."""
    from test_torch_guidance import scripted_flight, teacher_forced

    jcfg = dataclasses.replace(j_get_preset("wrf_les").env, **SMALL)
    tcfg = dataclasses.replace(t_get_preset("wrf_les").env, **SMALL)
    jg = ja.derive_aniso_config(jcfg, terminate, 40.0)
    tg = ta.derive_aniso_config(tcfg, terminate, 40.0)
    if options:
        jg = dataclasses.replace(jg, **ANISO_OPTIONS)
        tg = dataclasses.replace(tg, **ANISO_OPTIONS)
    j_init, j_fn = ja.make_aniso_guide(jcfg, jg)
    t_init, t_fn = ta.make_aniso_guide(tcfg, tg)
    steps = scripted_flight(t_fn, t_init, tcfg, 24, 120, seed=11)
    dropped = teacher_forced(
        steps, jax.vmap(lambda gs, p, c, a, s: j_fn(gs, p, c, a)), j_init,
        dict(rtol=1e-5, atol=1e-4), dict(rtol=1e-5, atol=FLIGHT_EST_ATOL),
        lambda gin, gout, pos, conc: aniso_gate_margin(tcfg, tg, gin, gout,
                                                       pos, conc),
        **FLIGHT_FIELDS)
    assert dropped.sum() <= 1
    last = steps[-1][-1][0]
    assert last.est_ok.any() or last.committed.any() or (
        last.refutes > 0).any()


def test_guided_wrf_les_eval_matches_jax():
    """32 wrf_les episodes x 200 steps on the small domain with the fit
    guide (``make_guide`` dispatches the anisotropic plume to it), against
    JAX's ``evaluate_policy`` given its draws (``guided_eval`` of
    tests/test_torch_guidance.py, at the flights' tolerance)."""
    from test_torch_guidance import guided_eval
    from tpu_plume.evaluation.guidance import make_guide as j_make
    from tpu_plume_torch.evaluation.guidance import make_guide as t_make

    def gcfgs(c):
        return ja.derive_aniso_config(c.env, 50.0, 40.0)

    def j_step(jcfg):
        fn = ja.make_aniso_guide(jcfg.env, gcfgs(jcfg))[1]
        return jax.vmap(lambda gs, p, c, a, s: fn(gs, p, c, a))

    def margin(tcfg, gin, gout, pos, conc):
        return aniso_gate_margin(tcfg.env, ta.derive_aniso_config(
            tcfg.env, 50.0, 40.0), gin, gout, pos, conc)

    tmet = guided_eval(
        "wrf_les", 32, 200,
        lambda c: j_make(c.env, success_radius=40.0),
        lambda c: t_make(c.env, success_radius=40.0),
        j_step, lambda c: ja.make_aniso_guide(c.env, gcfgs(c))[0], margin,
        env=SMALL, est_atol=FLIGHT_EST_ATOL, **FLIGHT_FIELDS)
    # the inward policy crosses some ridges: those fits see their samples
    assert (tmet.guide_samples >= ta.AnisoGuideConfig().min_samples).any()


def test_ride_and_transect_tiers():
    """tests/test_aniso_fit.py:391-422's ridge ride on the port, batched
    over three walks: it overrides only when enabled, on an unvalidated fit
    with samples, within its budget; and the crosswind transect: a strong
    read engages it, it moves (never stays), counts its sensing steps and
    releases control once ``sense_patience`` is spent."""
    cfg = _wrf(TEnvConfig)
    base = ta.derive_aniso_config(cfg, terminate_radius=50.0,
                                  success_radius=40.0)
    model_n = ta.make_model_n(cfg)
    src = torch.tensor([[220.0, 310.0]] * 3)
    theta = torch.tensor([0.9, 0.9, 2.1])
    u = torch.stack([torch.cos(theta), torch.sin(theta)], -1)

    def walk(gcfg, depths, policy=0):
        init, step = ta.make_aniso_guide(cfg, gcfg)
        gs = broadcast(init, 3, "cpu")
        overrides, actions = [], []
        for d in depths:
            p = src + d * u
            conc = model_n(p[:, None], src, theta)[:, 0] * cfg.conc_peak
            gs, a, ov = step(gs, p, conc, torch.full((3,), policy))
            overrides.append(ov)
            actions.append(a)
        return gs, torch.stack(overrides), torch.stack(actions)

    depths = np.linspace(230.0, 190.0, 12)
    assert not base.ride and not base.transect
    gs, ov, _ = walk(base, depths)
    assert (gs.ride_count == 0).all() and not ov.any()
    gs, ov, _ = walk(dataclasses.replace(base, ride=True, ride_ambig_min=0.0),
                     depths)
    assert (gs.ride_count == ov.sum(0)).all() and (gs.ride_count > 0).all()
    gs, ov, _ = walk(dataclasses.replace(base, ride=True, ride_ambig_min=0.0,
                                         ride_budget=2), depths)
    assert (gs.ride_count == 2).all() and (ov.sum(0) == 2).all()

    near = np.linspace(150.0, 140.0, 8)     # strong reads on the ridge
    gcfg = dataclasses.replace(base, transect=True, sense_patience=5)
    gs, ov, act = walk(gcfg, near)
    assert ov[0].all() and (act[ov] != 0).all()
    assert (gs.tr_age == gcfg.sense_patience).all() and gs.tr_spent.all()
    assert not ov[-1].any()


# The fit held fixed for the tiers' replay: a table of (est, theta, se,
# spread) rows, picked in both packages by the buffer's sample count
# modulo 4, so that the same buffers give the same fit bit for bit.  One
# row validates (se under the gate, the estimate in the domain); the
# others leave the fit unvalidated, two of them ambiguous (spread over
# ``ride_ambig_min``).  No angle sits on a multiple of 45 degrees, so no
# two actions' scores tie.
FIXED_EST = np.array([[60.0, 70.0], [190.0, 80.0], [120.0, 200.0],
                      [150.0, 130.0]], np.float32)
FIXED_THETA = np.array([0.3, 0.9, 2.1, -1.2], np.float32)
FIXED_SE = np.array([9.0, 9.0, 9.0, 1.0], np.float32)
FIXED_SPREAD = np.array([80.0, 10.0, 120.0, 5.0], np.float32)


def _j_fixed_fit(pos, c, w, cfg, gcfg, null_pos=None, null_w=None,
                 return_ambiguity=False):
    n_eff = (w > 0).sum()
    k = n_eff % 4
    out = (jnp.asarray(FIXED_EST)[k], jnp.asarray(FIXED_THETA)[k],
           jnp.asarray(FIXED_SE)[k], n_eff)
    return out + (jnp.asarray(FIXED_SPREAD)[k],) if return_ambiguity else out


def _t_fixed_fit(pos, c, w, cfg, gcfg, null_pos=None, null_w=None,
                 return_ambiguity=False):
    n_eff = (w > 0).sum(-1)
    k = n_eff % 4
    out = (torch.from_numpy(FIXED_EST)[k], torch.from_numpy(FIXED_THETA)[k],
           torch.from_numpy(FIXED_SE)[k], n_eff)
    return (out + (torch.from_numpy(FIXED_SPREAD)[k],) if return_ambiguity
            else out)


# the tiers on: the ride by the spread and by the se gate, each with the
# transect, and with the null reads and the serpentine search beside them
TIER_OPTIONS = {
    "spread": dict(ride=True, transect=True),
    "se_gated": dict(ride=True, ride_ambig_min=0.0, ride_budget=6,
                     transect=True, sense_patience=10, null_buffer=16,
                     search_after=30),
}


@pytest.mark.parametrize("case", sorted(TIER_OPTIONS))
def test_ride_and_transect_tiers_teacher_forced_match_jax(case, monkeypatch):
    """The ridge ride and the crosswind transect with the fit held fixed
    (``FIXED_*``) in both packages: 24 wrf_les flights x 120 steps with
    the port's guide in the loop, replayed through JAX's vmapped step.
    Every action, override, integer and bool register is equal at every
    step (no gate may flip: the fit is the same bit for bit), the floats
    within rtol 1e-5 / atol 1e-4; and both tiers steer some steps."""
    from test_torch_guidance import scripted_flight, teacher_forced

    monkeypatch.setattr(ja, "fit_aniso", _j_fixed_fit)
    monkeypatch.setattr(ta, "fit_aniso", _t_fixed_fit)
    jcfg = dataclasses.replace(j_get_preset("wrf_les").env, **SMALL)
    tcfg = dataclasses.replace(t_get_preset("wrf_les").env, **SMALL)
    jg = dataclasses.replace(ja.derive_aniso_config(jcfg, 50.0, 40.0),
                             **TIER_OPTIONS[case])
    tg = dataclasses.replace(ta.derive_aniso_config(tcfg, 50.0, 40.0),
                             **TIER_OPTIONS[case])
    j_init, j_fn = ja.make_aniso_guide(jcfg, jg)
    t_init, t_fn = ta.make_aniso_guide(tcfg, tg)
    steps = scripted_flight(t_fn, t_init, tcfg, 24, 120, seed=5)
    tol = dict(rtol=1e-5, atol=1e-4)
    dropped = teacher_forced(
        steps, jax.vmap(lambda gs, p, c, a, s: j_fn(gs, p, c, a)), j_init,
        tol, tol, lambda gin, gout, pos, conc: np.full(pos.shape[0], np.inf),
        fit_fields=("est", "theta"))
    assert not dropped.any()
    last = steps[-1][-1][0]
    assert (last.ride_count > 0).any() and (last.tr_age > 0).any()
    assert last.est_ok.any() or last.committed.any()


def test_fit_on_noisy_guide_buffers_matches_jax():
    """``fit_aniso`` over 1000 of wrf_les's guide buffers as
    ``chip_smoke.py`` builds them for its card check (noisy transects,
    ridge segments and sparse reads, 2-128 reads each), against JAX's
    vmapped fit: n_eff equal, and at most one buffer in 64 whose fits part
    by ``chip_smoke.fits_apart`` (a gate deciding the other way outside
    rounding of its bound, or validated fits more than 0.25 px, 1e-2 rad
    or 1e-2 relative in se apart: on noisy reads the 16 damped steps stop
    short of the minimum and near-tied starts may swap).  Both sides of
    the gates occur."""
    import chip_smoke

    jcfg, tcfg = j_get_preset("wrf_les").env, t_get_preset("wrf_les").env
    jg = ja.derive_aniso_config(jcfg, 50.0, 40.0)
    tg = ta.derive_aniso_config(tcfg, 50.0, 40.0)
    n = 1000
    bufs = chip_smoke.fit_buffers(tcfg, tg, n, seed=3)
    got = [x.numpy() for x in ta.fit_aniso(
        *(torch.from_numpy(x) for x in bufs), tcfg, tg,
        return_ambiguity=True)]
    want = [np.asarray(x) for x in jax.jit(jax.vmap(
        lambda p, c, w: ja.fit_aniso(p, c, w, jcfg, jg,
                                     return_ambiguity=True)))(*bufs)]
    np.testing.assert_array_equal(got[3], want[3])
    apart, ok, _ = chip_smoke.fits_apart(got, want, tcfg, tg)
    assert apart.sum() <= n // 64, np.flatnonzero(apart)
    assert 0 < ok.sum() < n
    assert ((want[3] >= tg.min_samples) & ~ok).any()
