"""The port's flux study against the JAX package's, on the CPU.

- Each estimator (``design_matrix``, ``invert_fluxes``,
  ``source_observability``, ``refine_positions``, ``joint_refine``,
  ``estimate_sources``) against JAX's, vmapped over the same numpy
  episodes: isotropic, anisotropic in a wind, 3-D; the greedy pick, the
  reseat's merged pair, the LM's close pair, a masked column, and singular
  systems whose non-finite values pass the gates as in JAX.
- JAX's own ``tests/test_flux.py`` scenarios on the port, with their
  asserts.
- ``flux_inversion_study`` from the draws JAX's study consumes from its key
  (``flux_draws``: the 3-way split of ``tpu_plume/evaluation/flux.py:429``,
  the reset keys' fields, the normals and the Gumbel noise), 8 episodes x
  200 steps: random, raster, the MLP policy (converted params), the
  two-pass survey, estimated positions on and off, anisotropic and 3-D.
  With the true positions the summaries agree key by key: counts and
  shares equal, errors within rtol 1e-4.  The estimated positions are
  replayed episode by episode: the port's estimates on its survey against
  JAX's estimators on the same samples.  An episode agrees where each
  position lies within 0.05 px (``POS_ATOL``) and each strength within rtol
  1e-3 (``Q_RTOL``, atol 1e-6); an episode that parts is replayed stage by
  stage, each stage of the port given the same inputs as JAX's (the
  greedy picks equal, each log-Gaussian fit and reseat within 0.05 px and
  rtol 1e-2, each LM step within 0.05 px, a step's take decision flipping
  only within ``GAIN_RTOL`` of the data's SSE, the coverage gate equal):
  the fits and the LM of a near-degenerate mixture (two candidates on one
  core) amplify float rounding, over the LM's 8 steps in particular, in
  either package.  At most half the episodes may part.  The summary of the
  port's estimates then equals JAX's summary of the same estimates but the
  parted episodes', which take the port's: counts and shares equal,
  strength errors within rtol 1e-3, position errors within 0.05 px.  The
  two-pass survey's second pass is replayed through JAX's controller from
  the port's pass-1 estimates (``jax_survey(seeds1=)``).

Tolerances: positions and concentrations of the survey rtol 1e-5 / atol
1e-4 (the env's); anisotropic kernels rtol 1e-4 / atol 1e-3 (XLA
contracts multiply-adds), isotropic rtol 1e-5 / atol 1e-4; fits as above.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_eval import models
from tpu_plume.core.config import EnvConfig as JEnvConfig
from tpu_plume.core.config import get_preset as j_get_preset
from tpu_plume.env import methane as jm
from tpu_plume.evaluation import flux as jf
from tpu_plume.evaluation.oracle import make_oracle as j_make_oracle
from tpu_plume.fields import analytic as ja
from tpu_plume_torch.core.config import EnvConfig as TEnvConfig
from tpu_plume_torch.core.config import get_preset as t_get_preset
from tpu_plume_torch.evaluation import flux as tf
from tpu_plume_torch.evaluation import harnesses as th
from tpu_plume_torch.evaluation.oracle import make_oracle as t_make_oracle
from tpu_plume_torch.fields.analytic import FieldState
from tpu_plume_torch.ops import plume

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-4
ANISO_RTOL, ANISO_ATOL = 1e-4, 1e-3
POS_ATOL, Q_RTOL = 0.05, 1e-3
STAGE_ATOL, STAGE_RTOL = POS_ATOL, 1e-2
GAIN_RTOL = 1e-5
N, STEPS = 8, 200


def _t(x, dtype=None):
    return torch.from_numpy(np.array(x, dtype=dtype))


def _np(x):
    return np.asarray(x)


@functools.lru_cache(maxsize=None)
def j_stage(name, cfg, **kw):
    """JAX's estimator ``name`` with its config and options bound, vmapped
    over episodes and jitted (one compile per shape)."""
    fn = getattr(jf, name)
    if name == "estimate_sources":
        return jax.jit(jax.vmap(lambda p, c: fn(p, c, cfg.num_sources, cfg,
                                                **kw)))
    if name == "refine_positions":
        return jax.jit(jax.vmap(lambda p, c, k: fn(p, c, k, cfg, **kw)))
    return jax.jit(jax.vmap(lambda p, c, m, q: fn(p, c, m, q, cfg, **kw)))


def configs(preset="ppo_v2_0", **env):
    """JAX's and the port's env of ``preset`` with 3 sources and ``env``."""
    env = dict(num_sources=3, **env)
    return (dataclasses.replace(j_get_preset(preset).env, **env),
            dataclasses.replace(t_get_preset(preset).env, **env))


def flux_draws(key, tcfg, n, steps) -> th.EvalDraws:
    """The port's ``EvalDraws`` holding the numbers JAX's study draws from
    ``key``: the reset keys' source uniforms, seeds and wind uniforms
    (``fields/analytic.py:51-62``), the normals ``[T, N, pos_dim]`` and the
    Gumbel noise ``[T, N, A]`` (``flux.py:429-441``)."""
    k_reset, k_act, k_noise = jax.random.split(key, 3)

    def per_env(k):
        k_src, k_seed, k_wind = jax.random.split(k, 3)
        u = jax.random.uniform(k_src, (2,), jnp.float32)
        seed = jax.random.randint(k_seed, (), 0, jnp.iinfo(jnp.int32).max)
        k_speed, k_dir = jax.random.split(k_wind)
        wind = jnp.stack([jax.random.uniform(k_speed, (), jnp.float32),
                          jax.random.uniform(k_dir, (), jnp.float32)])
        return u, seed, wind

    u_src, bits, u_wind = jax.vmap(per_env)(jax.random.split(k_reset, n))
    noise = jax.random.normal(k_noise, (steps, n, tcfg.pos_dim), jnp.float32)
    gumbel = jax.random.gumbel(k_act, (steps, n, tcfg.num_actions),
                               jnp.float32)
    return th.EvalDraws(
        u_src=_t(u_src), bits=_t(bits, np.int32),
        u_wind=_t(u_wind) if plume.reads_wind(tcfg) else None,
        turb_noise=_t(noise), gumbel=_t(gumbel))


def jax_survey(cfg, key, n, steps, oracle=None, apply=None, params=None,
               refine_steps=0, seeds1=None):
    """JAX's study's survey (``flux.py:429-525``) from ``key``: its fields
    and per-episode samples as numpy [N, T, ...], and the pass-1 estimates;
    with ``seeds1`` pass 2 chases those in place of its own estimates."""
    k_reset, k_act, k_noise = jax.random.split(key, 3)
    steps_p1 = steps - refine_steps

    def run(reset_keys, k_act, k_noise, seeds1):
        env_state, obs = jax.vmap(lambda k: jm.reset(k, cfg))(reset_keys)
        noises = jax.random.normal(k_noise, (steps, n, cfg.pos_dim),
                                   jnp.float32)
        gumbels = jax.random.gumbel(k_act, (steps, n, cfg.num_actions),
                                    jnp.float32)

        def body(carry, xs):
            env_state, obs = carry
            noise_t, gumbel_t = xs
            if oracle is not None:
                action = jax.vmap(oracle)(env_state)
            elif apply is not None:
                logits, _ = apply(params, obs)
                action = jnp.argmax(logits + gumbel_t, axis=-1)
            else:
                action = jnp.argmax(gumbel_t, axis=-1)
            env_state, trans = jax.vmap(
                lambda s, a, nz: jm.step_noise(s, a, nz, cfg))(
                env_state, action, noise_t)
            zs = env_state.pos[:, 2] if cfg.env_3d else jnp.zeros(n)
            return (env_state, trans.obs), (env_state.pos[:, :2], zs,
                                            trans.info.conc_raw)

        (env_state, obs), (pts, zs, concs) = jax.lax.scan(
            body, (env_state, obs), (noises[:steps_p1], gumbels[:steps_p1]))
        srcs1 = jnp.zeros((n, cfg.num_sources, 2))
        if refine_steps > 0:
            srcs1 = jax.vmap(lambda p, c: jf.estimate_sources(
                p, c, cfg.num_sources, cfg))(jnp.swapaxes(pts, 0, 1),
                                             jnp.swapaxes(concs, 0, 1))
            wp = srcs1 if seeds1 is None else seeds1
            r = jnp.float32(cfg.move_step)
            ang = jnp.arange(8, dtype=jnp.float32) * (2 * jnp.pi / 8)
            ring = r * jnp.stack([jnp.cos(ang), jnp.sin(ang)], -1)
            offs = jnp.concatenate([jnp.zeros((1, 2)), ring])
            wps = (wp[:, :, None, :] + offs[None, None]).reshape(n, -1, 2)
            n_wp = wps.shape[1]

            def body2(carry, xs):
                env_state, obs, wp_idx, stuck = carry
                noise_t, _ = xs
                tgt = jnp.take_along_axis(wps, wp_idx[:, None, None],
                                          axis=1)[:, 0, :]
                to = tgt - env_state.pos[:, :2]
                adv = (jnp.linalg.norm(to, axis=-1) <= 0.6 * r) | (stuck >= 12)
                wp_idx = jnp.minimum(wp_idx + adv.astype(jnp.int32), n_wp - 1)
                stuck = jnp.where(adv, 0, stuck + 1)
                action = jnp.where(
                    jnp.abs(to[:, 0]) >= jnp.abs(to[:, 1]),
                    jnp.where(to[:, 0] > 0, 3, 4),
                    jnp.where(to[:, 1] > 0, 1, 2)).astype(jnp.int32)
                env_state, trans = jax.vmap(
                    lambda s, a, nz: jm.step_noise(s, a, nz, cfg))(
                    env_state, action, noise_t)
                zq = env_state.pos[:, 2] if cfg.env_3d else jnp.zeros(n)
                return (env_state, trans.obs, wp_idx, stuck), (
                    env_state.pos[:, :2], zq, trans.info.conc_raw)

            (env_state, _, _, _), (p2, z2, c2) = jax.lax.scan(
                body2, (env_state, obs, jnp.zeros(n, jnp.int32),
                        jnp.zeros(n, jnp.int32)),
                (noises[steps_p1:], gumbels[steps_p1:]))
            pts = jnp.concatenate([pts, p2])
            zs = jnp.concatenate([zs, z2])
            concs = jnp.concatenate([concs, c2])
        return (env_state.field, jnp.swapaxes(pts, 0, 1),
                jnp.swapaxes(zs, 0, 1), jnp.swapaxes(concs, 0, 1), srcs1)

    field, pts, zs, concs, srcs1 = jax.jit(run)(
        jax.random.split(k_reset, n), k_act, k_noise,
        None if seeds1 is None else jnp.asarray(seeds1))
    return dict(field=field, points=_np(pts), z=_np(zs), concs=_np(concs),
                seeds=_np(srcs1))


def jax_scores(cfg, field, points, z, concs, estimated, seeds=None):
    """JAX's per-episode scoring (``one``, ``flux.py:530-568``) of the given
    samples: q_est, q_true, srcs, srcs_true, observed as numpy."""

    def one(field, p, zz, c, seed_peaks):
        srcs_true = ja.all_sources(field, cfg)
        q_true = ja.source_strengths(field, cfg)
        zq = zz if cfg.env_3d else None
        if estimated:
            if seeds is not None:
                srcs, q_local = jf.refine_positions(
                    p, c, seed_peaks, cfg, em_iters=0, return_strengths=True)
            else:
                srcs, q_local = jf.estimate_sources(
                    p, c, cfg.num_sources, cfg, return_strengths=True)
            q_est = (q_local if cfg.plume_model == "isotropic" else
                     jf.invert_fluxes(p, c, srcs, field.wind, cfg, z=zq))
        else:
            srcs = srcs_true
            q_est = jf.invert_fluxes(p, c, srcs, field.wind, cfg, z=zq)
        observed = jf.source_observability(p, srcs_true, field.wind, cfg,
                                           z=zq)
        return q_est, q_true, srcs, srcs_true, observed

    n = points.shape[0]
    seed = (jnp.zeros((n, cfg.num_sources, 2)) if seeds is None
            else jnp.asarray(seeds))
    out = jax.jit(jax.vmap(one))(field, jnp.asarray(points), jnp.asarray(z),
                                 jnp.asarray(concs), seed)
    return tuple(_np(x) for x in out)


def port_survey(tcfg, draws, n, steps, **kw):
    _, model, _, draws, state, obs = th._start(
        kw.pop("policy", None), tcfg, "cpu", None, draws, n, steps, False,
        None, None)
    return tf.fly_survey(tcfg, state, obs, draws, steps, policy=model, **kw)


def assert_same_survey(survey, js):
    np.testing.assert_allclose(survey.points.numpy(), js["points"],
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(survey.concs.numpy(), js["concs"], rtol=RTOL,
                               atol=ATOL)
    if survey.z is not None:
        np.testing.assert_allclose(survey.z.numpy(), js["z"], rtol=RTOL,
                                   atol=ATOL)


def same_summaries(got, want, rtol=1e-4, pos_atol=0.0):
    """Counts and shares equal; strength errors within ``rtol``, position
    errors within ``rtol`` or ``pos_atol`` px."""
    assert got.keys() == want.keys()
    for key in want:
        if isinstance(want[key], float) and "error" in key:
            np.testing.assert_allclose(
                got[key], want[key], rtol=rtol,
                atol=pos_atol if "pos" in key else 0.0, err_msg=key)
        else:
            assert got[key] == want[key], (key, got[key], want[key])


# ---------------------------------------------------------------- estimators

def episodes(seed, n=4, t=300, s=3, lo=0.0, hi=499.0):
    """n episodes of t uniform sample points, S sources inside the domain,
    strengths in [0.5, 1.5], winds and heights."""
    rng = np.random.default_rng(seed)
    return dict(
        points=rng.uniform(lo, hi, (n, t, 2)).astype(np.float32),
        sources=rng.uniform(60, 440, (n, s, 2)).astype(np.float32),
        q=rng.uniform(0.5, 1.5, (n, s)).astype(np.float32),
        wind=rng.uniform(-2, 2, (n, 2)).astype(np.float32),
        z=rng.uniform(0, 30, (n, t)).astype(np.float32))


def j_design(e, cfg, z):
    return jax.vmap(lambda p, s, w, zz: jf.design_matrix(p, s, w, cfg, zz))(
        e["points"], e["sources"], e["wind"], e["z"]) if z else jax.vmap(
        lambda p, s, w: jf.design_matrix(p, s, w, cfg))(
        e["points"], e["sources"], e["wind"])


MODEL_CASES = {
    "iso": dict(),
    "aniso": dict(plume_model="anisotropic"),
    "iso_3d": dict(env_3d=True),
    "aniso_3d": dict(plume_model="anisotropic", env_3d=True),
}


def model_cfgs(case):
    kw = dict(num_sources=3, **MODEL_CASES[case])
    return JEnvConfig(**kw), TEnvConfig(**kw)


def tol(cfg):
    return ((ANISO_RTOL, ANISO_ATOL) if cfg.plume_model == "anisotropic"
            else (RTOL, ATOL))


@pytest.mark.parametrize("case", sorted(MODEL_CASES))
def test_design_matrix_invert_and_observability_match_jax(case):
    jcfg, tcfg = model_cfgs(case)
    e = episodes(0)
    z = tcfg.env_3d
    tz = _t(e["z"]) if z else None
    want_a = _np(j_design(e, jcfg, z))
    got_a = tf.design_matrix(_t(e["points"]), _t(e["sources"]),
                             _t(e["wind"]), tcfg, tz)
    np.testing.assert_allclose(got_a.numpy(), want_a, *tol(tcfg))
    concs = (want_a * e["q"][:, None, :]).sum(-1) + 2.0
    rng = np.random.default_rng(1)
    valid = rng.uniform(size=concs.shape) > 0.2
    mask = np.array([[True, True, False]] * 4)
    for kw in (dict(), dict(valid=valid), dict(column_mask=mask),
               dict(debias_noise=False, ridge=1e-3)):
        want = jax.vmap(lambda p, c, s, w, zz, v, m: jf.invert_fluxes(
            p, c, s, w, jcfg, z=zz if z else None,
            valid=v if "valid" in kw else None,
            column_mask=m if "column_mask" in kw else None,
            **{k: kw[k] for k in ("debias_noise", "ridge") if k in kw}))(
            e["points"], concs, e["sources"], e["wind"], e["z"], valid, mask)
        got = tf.invert_fluxes(
            _t(e["points"]), _t(concs), _t(e["sources"]), _t(e["wind"]),
            tcfg, z=tz, **{k: _t(v) if isinstance(v, np.ndarray) else v
                           for k, v in kw.items()})
        np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-3,
                                   atol=1e-4, err_msg=str(kw))
    want_o = jax.vmap(lambda p, s, w, zz: jf.source_observability(
        p, s, w, jcfg, z=zz if z else None))(
        e["points"], e["sources"], e["wind"], e["z"])
    got_o = tf.source_observability(_t(e["points"]), _t(e["sources"]),
                                    _t(e["wind"]), tcfg, z=tz)
    np.testing.assert_array_equal(got_o.numpy(), _np(want_o))


def test_anisotropic_columns_see_a_zero_wind_where_the_port_keeps_none():
    jcfg, tcfg = model_cfgs("aniso")
    e = episodes(2)
    want = jax.vmap(lambda p, s: jf.design_matrix(p, s, jnp.zeros(2), jcfg))(
        e["points"], e["sources"])
    got = tf.design_matrix(_t(e["points"]), _t(e["sources"]), None, tcfg)
    np.testing.assert_allclose(got.numpy(), _np(want), ANISO_RTOL, ANISO_ATOL)


def test_singular_systems_give_non_finite_values_where_jax_does():
    """A zero column with no ridge makes the normal equations singular:
    both packages return the same non-finite entries and no error; the LM
    on a zero design (all samples saturated, no damping) rejects its
    non-finite step in both and keeps its seed."""
    jcfg, tcfg = model_cfgs("iso")
    e = episodes(3)
    mask = np.array([[True, False, True]] * 4)
    concs = np.full(e["points"].shape[:2], 30.0, np.float32)
    want = _np(jax.vmap(lambda p, c, s, m: jf.invert_fluxes(
        p, c, s, jnp.zeros(2), jcfg, ridge=0.0, column_mask=m))(
        e["points"], concs, e["sources"], mask))
    got = tf.invert_fluxes(_t(e["points"]), _t(concs), _t(e["sources"]),
                           None, tcfg, ridge=0.0,
                           column_mask=_t(mask)).numpy()
    assert not np.isfinite(want).all()
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    np.testing.assert_allclose(got[np.isfinite(got)],
                               want[np.isfinite(want)], rtol=1e-3)
    sat = np.full_like(concs, 100.0)
    mus, qs = e["sources"], e["q"]
    want_m, want_q = jax.vmap(lambda p, c, m, q: jf.joint_refine(
        p, c, m, q, jcfg, lm=0.0))(e["points"], sat, mus, qs)
    record = {}
    got_m, got_q = tf.joint_refine(_t(e["points"]), _t(sat), _t(mus), _t(qs),
                                   tcfg, lm=0.0, record=record)
    assert not record["take"].any()
    np.testing.assert_allclose(got_m.numpy(), _np(want_m), atol=1e-4)
    np.testing.assert_allclose(got_q.numpy(), _np(want_q), rtol=1e-6)
    np.testing.assert_allclose(got_m.numpy(), mus, atol=1e-4)


def noisy_concs(e, cfg, noise, seed=5):
    a = _np(jax.vmap(lambda p, s: jf.design_matrix(p, s, jnp.zeros(2), cfg))(
        e["points"], e["sources"]))
    rng = np.random.default_rng(seed)
    c = (a * e["q"][:, None, :]).sum(-1) + noise * np.abs(
        rng.normal(size=a.shape[:2]))
    return np.clip(c, 0, cfg.conc_peak).astype(np.float32)


@pytest.mark.parametrize("noise", [0.0, 3.0])
def test_refine_positions_matches_jax(noise):
    jcfg, tcfg = model_cfgs("iso")
    e = episodes(4, n=6, t=800)
    c = noisy_concs(e, jcfg, noise)
    peaks = e["sources"] + np.float32(9.0)
    for em in (8, 0):
        wm, wq = jax.vmap(lambda p, cc, k: jf.refine_positions(
            p, cc, k, jcfg, em_iters=em, return_strengths=True))(
            e["points"], c, peaks)
        record = {}
        gm, gq = tf.refine_positions(_t(e["points"]), _t(c), _t(peaks), tcfg,
                                     em_iters=em, return_strengths=True,
                                     record=record)
        np.testing.assert_allclose(gm.numpy(), _np(wm), atol=STAGE_ATOL)
        np.testing.assert_allclose(gq.numpy(), _np(wq), rtol=Q_RTOL,
                                   atol=1e-6)
        assert record["ok"][0].shape == (6, 3)


def test_refine_positions_gate_rejects_a_candidate_far_from_every_sample():
    """A candidate no sample weighs (zero responsibilities) solves to
    beta = 0: beta3 < 0 fails in both, the candidate stays, q = 0."""
    jcfg, tcfg = model_cfgs("iso")
    e = episodes(6, n=2, t=200, lo=0.0, hi=100.0)
    c = noisy_concs(e, jcfg, 0.0)
    peaks = np.array([[[20.0, 20.0], [480.0, 480.0], [50.0, 60.0]]] * 2,
                     np.float32)
    wm, wq = jax.vmap(lambda p, cc, k: jf.refine_positions(
        p, cc, k, jcfg, em_iters=0, return_strengths=True))(
        e["points"], c, peaks)
    record = {}
    gm, gq = tf.refine_positions(_t(e["points"]), _t(c), _t(peaks), tcfg,
                                 em_iters=0, return_strengths=True,
                                 record=record)
    assert not record["ok"][0][:, 1].any()
    assert float(record["beta3"][0][:, 1].abs().max()) == 0.0
    np.testing.assert_array_equal(gm.numpy()[:, 1], peaks[:, 1])
    np.testing.assert_array_equal(_np(wm)[:, 1], peaks[:, 1])
    np.testing.assert_array_equal(gq.numpy()[:, 1], _np(wq)[:, 1])


@pytest.mark.parametrize("case", ["iso", "aniso"])
def test_estimate_sources_matches_jax(case):
    """The greedy pick, EM, fit, reseat, joint LM and coverage gate on
    clean dense samples (decisive fits) with and without strengths."""
    jcfg, tcfg = model_cfgs(case)
    e = episodes(7, n=4, t=1500)
    c = _np(j_design(e, jcfg, False) * e["q"][:, None, :]).sum(-1)
    c = np.clip(c, 0, 100).astype(np.float32)
    wm, wq = j_stage("estimate_sources", jcfg, return_strengths=True)(
        e["points"], c)
    record = {}
    gm, gq = tf.estimate_sources(_t(e["points"]), _t(c), 3, tcfg,
                                 return_strengths=True, record=record)
    np.testing.assert_allclose(gm.numpy(), _np(wm), atol=POS_ATOL)
    np.testing.assert_allclose(gq.numpy(), _np(wq), rtol=Q_RTOL, atol=1e-6)
    np.testing.assert_array_equal(
        tf.estimate_sources(_t(e["points"]), _t(c), 3, tcfg).numpy(),
        gm.numpy())
    # the greedy pick: the first maximum, as jnp.argmax
    assert record["pick"].shape == (4, 3)
    assert (record["pick_gap"] >= 0).all()
    if case == "iso":
        assert record["take"].shape == (4, 8) and "good" in record
    else:
        assert "take" not in record and "reseat" not in record


def test_greedy_pick_takes_the_first_of_tied_maxima():
    jcfg, tcfg = model_cfgs("iso")
    pts = np.array([[[10.0, 10.0], [400.0, 400.0], [11.0, 10.0],
                     [200.0, 50.0]]], np.float32)
    c = np.array([[50.0, 50.0, 50.0, 20.0]], np.float32)
    record = {}
    tf.estimate_sources(_t(pts), _t(c), 3, tcfg, record=record)
    assert record["pick"][0].tolist() == [0, 1, 3]
    radius = 3.0 * tcfg.plume_sigma
    peaks = tf._greedy_peaks(_t(pts), _t(c), 3, radius, None)
    np.testing.assert_array_equal(peaks.numpy()[0], pts[0, [0, 1, 3]])
    np.testing.assert_array_equal(
        peaks.numpy()[0], _np(jax_greedy_peaks(jnp.asarray(pts[0]),
                                               jnp.asarray(c[0]), 3, radius)))


def merged_pair():
    srcs = np.array([[150.0, 150.0], [150.0, 200.0], [380.0, 380.0]],
                    np.float32)
    q = np.array([1.0, 0.9, 1.1], np.float32)
    rng = np.random.default_rng(3)
    pts = rng.uniform(0, 499, (2000, 2)).astype(np.float32)
    return pts, srcs, q


def test_reseat_of_a_merged_pair_matches_jax():
    jcfg, tcfg = model_cfgs("iso")
    pts, srcs, q = merged_pair()
    c = _np(jf.design_matrix(pts, srcs, jnp.zeros(2), jcfg) @ q)
    for reseat in (0, 1):
        want = j_stage("estimate_sources", jcfg, reseat_iters=reseat)(
            pts[None], c[None])[0]
        record = {}
        got = tf.estimate_sources(_t(pts)[None], _t(c)[None], 3, tcfg,
                                  reseat_iters=reseat, record=record)
        np.testing.assert_allclose(got.numpy()[0], _np(want), atol=POS_ATOL)
        if reseat:
            assert bool(record["reseat"][0])
            assert float(record["reseat_margin"][0]) > 0


def test_joint_refine_of_a_close_pair_matches_jax():
    jcfg, tcfg = model_cfgs("iso")
    srcs = np.array([[220.0, 215.0], [220.0, 265.0]], np.float32)
    q = np.array([1.2, 0.8], np.float32)
    rng = np.random.default_rng(4)
    pts = rng.uniform(100, 380, (3000, 2)).astype(np.float32)
    c = _np(jf.design_matrix(pts, srcs, jnp.zeros(2), jcfg) @ q)
    seeds = srcs + np.array([[4.0, -6.0], [-3.0, 7.0]], np.float32)
    seed_q = np.array([1.0, 1.0], np.float32)
    jcfg2 = dataclasses.replace(jcfg, num_sources=2)
    tcfg2 = dataclasses.replace(tcfg, num_sources=2)
    wm, wq = jf.joint_refine(pts, c, seeds, seed_q, jcfg2)
    record = {}
    gm, gq = tf.joint_refine(_t(pts)[None], _t(c)[None], _t(seeds)[None],
                             _t(seed_q)[None], tcfg2, record=record)
    np.testing.assert_allclose(gm.numpy()[0], _np(wm), atol=POS_ATOL)
    np.testing.assert_allclose(gq.numpy()[0], _np(wq), rtol=Q_RTOL)
    assert record["take"][0, 0]


# ------------------------------------------------ JAX's scenarios on the port

def _field(seed, n=1):
    return FieldState(source=torch.tensor([[120.0, 300.0]] * n),
                      seed=torch.full((n,), seed, dtype=torch.int32),
                      wind=torch.tensor([[1.5, 0.5]] * n))


def test_jax_invert_fluxes_exact_on_clean_samples():
    cfg = TEnvConfig(num_sources=3, turbulence_intensity=0.0)
    f = _field(3)
    srcs = plume.all_sources(f.source, f.seed, cfg)
    q_true = plume.source_strengths(f.seed, cfg)
    rng = np.random.default_rng(0)
    pts = _t(rng.uniform(0, 499, (1, 600, 2)), np.float32)
    a = tf.design_matrix(pts, srcs, f.wind, cfg)
    concs = (a @ q_true[..., None])[..., 0]
    q = tf.invert_fluxes(pts, concs, srcs, f.wind, cfg)
    np.testing.assert_allclose(q.numpy(), q_true.numpy(), rtol=1e-3)


def test_jax_flux_study_meets_20pct_goal():
    cfg = TEnvConfig(num_sources=3, max_steps=10000)
    out = tf.flux_inversion_study(cfg, torch.Generator().manual_seed(0),
                                  num_episodes=32, num_steps=400,
                                  device="cpu")
    assert out["observed_frac"] > 0.3
    assert out["mean_rel_error"] < 0.2, out
    assert out["within_20pct"] > 0.7, out


def test_jax_estimate_sources_recovers_positions():
    cfg = TEnvConfig(num_sources=3, turbulence_intensity=0.0)
    f = _field(3)
    srcs = plume.all_sources(f.source, f.seed, cfg)
    q_true = plume.source_strengths(f.seed, cfg)
    rng = np.random.default_rng(1)
    pts = _t(rng.uniform(0, 499, (1, 1500, 2)), np.float32)
    concs = (tf.design_matrix(pts, srcs, f.wind, cfg)
             @ q_true[..., None])[..., 0]
    est = tf.estimate_sources(pts, concs, 3, cfg).numpy()[0]
    d = np.linalg.norm(est[:, None] - srcs.numpy()[0][None], axis=-1)
    assert d.min(axis=0).max() < 12.0, d


def test_jax_flux_study_estimated_positions_end_to_end():
    cfg = TEnvConfig(num_sources=3, max_steps=10000)
    out = tf.flux_inversion_study(cfg, torch.Generator().manual_seed(0),
                                  num_episodes=32, num_steps=400,
                                  estimated_positions=True, device="cpu")
    assert out["estimated_positions"] is True
    assert out["observed_frac"] > 0.3
    assert np.isfinite(out["mean_pos_error"])
    assert out["median_pos_error"] < 20.0, out
    assert out["median_rel_error"] < 0.3, out
    assert out["median_rel_error_localized"] < 0.15, out
    assert out["within_20pct_localized"] > 0.7, out


def test_jax_flux_study_coverage_survey_beats_random():
    cfg = TEnvConfig(num_sources=3, max_steps=10000)
    kw = dict(num_episodes=24, num_steps=500, estimated_positions=True,
              device="cpu")
    ras = tf.flux_inversion_study(cfg, torch.Generator().manual_seed(0),
                                  oracle=t_make_oracle("raster", cfg), **kw)
    rnd = tf.flux_inversion_study(cfg, torch.Generator().manual_seed(0), **kw)
    assert ras["localized_frac"] >= rnd["localized_frac"] + 0.2, (ras, rnd)
    assert ras["within_20pct"] >= 0.75, ras
    assert ras["observed_frac"] >= 0.95, ras


def test_jax_reseat_recovers_merged_pair():
    cfg = TEnvConfig(num_sources=3, turbulence_intensity=0.0)
    pts, srcs, q = merged_pair()
    tp = _t(pts)[None]
    concs = (tf.design_matrix(tp, _t(srcs)[None], None, cfg)
             @ _t(q)[None, :, None])[..., 0]
    est0 = tf.estimate_sources(tp, concs, 3, cfg, reseat_iters=0).numpy()[0]
    est1 = tf.estimate_sources(tp, concs, 3, cfg, reseat_iters=1).numpy()[0]

    def worst(est):
        return np.linalg.norm(est[:, None] - srcs[None], axis=-1).min(
            axis=0).max()

    assert worst(est1) <= max(worst(est0), 15.0)
    assert worst(est1) < 15.0, (est0, est1)


def test_jax_joint_refine_resolves_close_pair_strengths():
    cfg = TEnvConfig(num_sources=2, turbulence_intensity=0.0)
    srcs = torch.tensor([[[220.0, 215.0], [220.0, 265.0]]])
    q_true = torch.tensor([[1.2, 0.8]])
    rng = np.random.default_rng(4)
    pts = _t(rng.uniform(100, 380, (1, 3000, 2)), np.float32)
    concs = (tf.design_matrix(pts, srcs, None, cfg) @ q_true[..., None])[..., 0]
    mus, qs = tf.estimate_sources(pts, concs, 2, cfg, return_strengths=True)
    mus, qs = mus.numpy()[0], qs.numpy()[0]
    order = np.argsort(mus[:, 1])
    np.testing.assert_allclose(mus[order], srcs.numpy()[0], atol=6.0)
    np.testing.assert_allclose(qs[order], q_true.numpy()[0], rtol=0.15)


def test_jax_extra_sources_and_env_success_at_the_nearest_source():
    """JAX's field scenarios of the same file: extra sources pure in the
    seed and inside the padding, strengths in range, and the env's success
    gate at the nearest of three sources."""
    from tpu_plume_torch.env import methane as tm

    cfg = TEnvConfig(num_sources=4)
    f = _field(7)
    srcs = plume.all_sources(f.source, f.seed, cfg).numpy()[0]
    assert srcs.shape == (4, 2)
    np.testing.assert_allclose(srcs[0], [120.0, 300.0])
    assert (srcs >= cfg.source_padding).all()
    assert (srcs <= cfg.grid_size - cfg.source_padding).all()
    other = plume.all_sources(f.source, torch.tensor([8], dtype=torch.int32),
                              cfg).numpy()[0]
    assert not np.allclose(srcs[1:], other[1:])
    qs = plume.source_strengths(f.seed, cfg).numpy()[0]
    lo, hi = cfg.source_strength_range
    assert qs[0] == 1.0 and ((qs[1:] >= lo) & (qs[1:] <= hi)).all()
    cfg3 = TEnvConfig(num_sources=3, turbulence_intensity=1e-6)
    state, _ = tm.reset_from_draws(torch.tensor([[0.3, 0.6]]), None,
                                   torch.tensor([11], dtype=torch.int32),
                                   cfg3)
    src1 = plume.all_sources(state.field.source, state.field.seed,
                             cfg3)[:, 1]
    state = state.replace(pos=src1.clone(), radius=torch.tensor([30.0]))
    _, tr = tm.step_noise(state, torch.tensor([0]), torch.zeros(1, 2), cfg3)
    assert bool(tr.info.reached[0]) and float(tr.info.distance[0]) < 30.0


# --------------------------------------------------------- the study vs JAX

SURVEYS = {
    "random": dict(),
    "raster": dict(survey="raster"),
    "policy": dict(survey="policy"),
    "two_pass": dict(survey="raster", refine_steps=60),
    "aniso": dict(preset="wrf_les", survey="raster"),
    "3d": dict(env=dict(env_3d=True)),
}


def study_setup(case):
    spec = SURVEYS[case]
    jcfg, tcfg = configs(spec.get("preset", "ppo_v2_0"),
                         **spec.get("env", {}))
    key = jax.random.PRNGKey(1)
    draws = flux_draws(key, tcfg, N, STEPS)
    kw_j, kw_t = {}, {}
    if spec.get("survey") == "raster":
        kw_j["oracle"] = j_make_oracle("raster", jcfg)
        kw_t["oracle"] = t_make_oracle("raster", tcfg)
    elif spec.get("survey") == "policy":
        jmodel, params, tmodel = models(tcfg, key=2)
        kw_j.update(policy=jmodel.apply, params=params)
        kw_t["policy"] = tmodel
    refine = spec.get("refine_steps", 0)
    return jcfg, tcfg, key, draws, kw_j, kw_t, refine


@pytest.mark.parametrize("case", sorted(SURVEYS))
def test_study_with_true_positions_matches_jax(case):
    """The survey, ``invert_fluxes`` at the true sources and the
    observability: JAX's summary key by key (a two-pass survey's second
    pass replayed from the port's pass-1 estimates)."""
    jcfg, tcfg, key, draws, kw_j, kw_t, refine = study_setup(case)
    if refine:
        survey = port_survey(tcfg, draws, N, STEPS, refine_steps=refine,
                             **kw_t)
        js = jax_survey(jcfg, key, N, STEPS, refine_steps=refine,
                        oracle=kw_j["oracle"], seeds1=survey.seeds.numpy())
        assert_same_survey(survey, js)
        want = tf.summarize_flux(*(_t(x) for x in jax_scores(
            jcfg, js["field"], js["points"], js["z"], js["concs"], False)),
            False)
        got = tf.summarize_flux(*tf.score_survey(survey, tcfg, False), False)
        same_summaries(got, want)
        return
    want = jf.flux_inversion_study(jcfg, key, num_episodes=N,
                                   num_steps=STEPS, **kw_j)
    got = tf.flux_inversion_study(tcfg, draws=draws, num_episodes=N,
                                  num_steps=STEPS, device="cpu", **kw_t)
    same_summaries(got, want)


def jax_greedy_peaks(points, concs, s, radius):
    """JAX's greedy pick (``flux.py:145-155``) alone."""
    def pick(masked, _):
        p = points[jnp.argmax(masked)]
        far = jnp.linalg.norm(points - p[None, :], axis=-1) > radius
        return jnp.where(far, masked, -1.0), p

    return jax.lax.scan(pick, concs, None, length=s)[1]


def jax_coverage_good(points, concs, mus, cfg):
    """JAX's coverage gate (``flux.py:224-237``) alone."""
    s = mus.shape[0]
    rel = points[:, None, :] - mus[None, :, :]
    dist = jnp.linalg.norm(rel, axis=-1)
    ang = jnp.arctan2(rel[..., 1], rel[..., 0])
    sector = jnp.clip(jnp.floor((ang + jnp.pi) / (jnp.pi / 4.0)), 0,
                      7).astype(jnp.int32)
    near = (dist < 3.0 * cfg.plume_sigma) & (
        concs[:, None] < 0.95 * cfg.conc_peak)
    hit = jnp.zeros((s, 8), bool).at[jnp.arange(s)[None, :], sector].max(near)
    return hit.sum(axis=1) >= 8


def replay_stages(points, concs, tcfg, jcfg, seeds=None):
    """Each stage of the port's estimate of one episode, from the port's
    own inputs to it, against JAX's stage given the same inputs: the greedy
    picks equal, each fit within STAGE_ATOL px and its strengths within
    STAGE_RTOL, each LM step within STAGE_ATOL px unless its take decision
    flipped within GAIN_RTOL of the data's SSE, the coverage gate equal."""
    p, c = _t(points)[None], _t(concs)[None]
    jp, jc = jnp.asarray(points), jnp.asarray(concs)
    s = tcfg.num_sources

    def fit(peaks, em_iters):
        m, q = tf.refine_positions(p, c, peaks, tcfg, em_iters=em_iters,
                                   return_strengths=True)
        wm, wq = j_stage("refine_positions", jcfg, em_iters=em_iters,
                         return_strengths=True)(
            jp[None], jc[None], peaks.numpy())
        wm, wq = wm[0], wq[0]
        np.testing.assert_allclose(m.numpy()[0], _np(wm), atol=STAGE_ATOL)
        np.testing.assert_allclose(q.numpy()[0], _np(wq), rtol=STAGE_RTOL,
                                   atol=1e-6)
        return m, q

    if seeds is not None:
        fit(_t(seeds)[None], 0)
        return
    radius = 3.0 * tcfg.plume_sigma
    peaks = tf._greedy_peaks(p, c, s, radius, None)
    np.testing.assert_array_equal(peaks.numpy()[0],
                                  _np(jax_greedy_peaks(jp, jc, s, radius)))
    m, q = fit(peaks, 8)
    if tcfg.plume_model != "isotropic":
        return
    m, q = fit(tf._reseat_seeds(p, c, m, q, tcfg, None), 0)
    cd = np.clip(concs - tcfg.turbulence_intensity * (0.7978845608 + 0.1),
                 0, None)
    sse_scale = float(((concs < 0.95 * tcfg.conc_peak) * cd ** 2).sum())
    for step in range(8):
        record = {}
        m1, q1 = tf.joint_refine(p, c, m, q, tcfg, iters=1, record=record)
        wm1 = j_stage("joint_refine", jcfg, iters=1)(
            jp[None], jc[None], m.numpy(), q.numpy())[0][0]
        gap = float(np.abs(m1.numpy()[0] - _np(wm1)).max())
        gain = float(record["sse_gain"][0, 0])
        # beyond the stage tolerance only where the take decision flipped,
        # within rounding of the SSE
        assert gap <= STAGE_ATOL or abs(gain) <= GAIN_RTOL * sse_scale, (
            step, gain, gap, sse_scale)
        m, q = m1, q1
    np.testing.assert_array_equal(
        tf._coverage_good(p, c, m, tcfg, None).numpy()[0],
        _np(jax_coverage_good(jp, jc, jnp.asarray(m.numpy()[0]), jcfg)))


def parted_episodes(points, concs, got, want, tcfg, jcfg, seeds=None):
    """Episodes whose estimated positions (f32[N, S, 2]) or strengths
    ([N, S]) part beyond POS_ATOL / Q_RTOL, each replayed stage by stage;
    at most half of them."""
    pos_gap = np.abs(got[0] - want[0]).max((1, 2))
    q_ok = np.isclose(got[1], want[1], rtol=Q_RTOL, atol=1e-6).all(1)
    parted = np.flatnonzero((pos_gap > POS_ATOL) | ~q_ok)
    assert len(parted) <= len(pos_gap) // 2, (parted, pos_gap)
    for ep in parted:
        replay_stages(points[ep], concs[ep], tcfg, jcfg,
                      None if seeds is None else seeds[ep])
    return parted


@pytest.mark.parametrize("case", ["random", "raster", "policy", "two_pass",
                                  "aniso"])
def test_study_with_estimated_positions_matches_jax(case):
    """The port's estimated positions and strengths on its survey against
    JAX's estimators on the same samples, episode by episode (a two-pass
    survey's pass-1 estimates too), a parted episode replayed stage by
    stage; then the summary, the parted episodes taking the port's
    estimates on both sides."""
    jcfg, tcfg, key, draws, kw_j, kw_t, refine = study_setup(case)
    survey = port_survey(tcfg, draws, N, STEPS, refine_steps=refine, **kw_t)
    points, concs = survey.points.numpy(), survey.concs.numpy()
    seeds = None
    if refine:
        seeds = survey.seeds.numpy()
        p1, c1 = points[:, :STEPS - refine], concs[:, :STEPS - refine]
        want1 = j_stage("estimate_sources", jcfg, return_strengths=True)(
            p1, c1)
        got1 = tf.estimate_sources(_t(p1), _t(c1), 3, tcfg,
                                   return_strengths=True)
        parted_episodes(p1, c1, (got1[0].numpy(), got1[1].numpy()),
                        (_np(want1[0]), _np(want1[1])), tcfg, jcfg)
        np.testing.assert_array_equal(got1[0].numpy(), seeds)
    got = [x.numpy() for x in tf.score_survey(survey, tcfg, True)]
    jfield = jax.vmap(lambda k: jm.reset(k, jcfg)[0].field)(
        jax.random.split(jax.random.split(key, 3)[0], N))
    want = jax_scores(jcfg, jfield, points,
                      survey.z.numpy() if survey.z is not None
                      else np.zeros_like(concs), concs, True, seeds)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-6)
    np.testing.assert_allclose(got[3], want[3], rtol=1e-6)
    np.testing.assert_array_equal(got[4], want[4])
    parted = parted_episodes(points, concs, (got[2], got[0]),
                             (want[2], want[0]), tcfg, jcfg, seeds)
    mixed = [x.copy() for x in want]
    for i in (0, 2):
        mixed[i][parted] = got[i][parted]
    same_summaries(
        tf.summarize_flux(*(_t(x) for x in got), True),
        tf.summarize_flux(*(_t(x) for x in mixed), True),
        rtol=Q_RTOL, pos_atol=POS_ATOL)
