"""The evaluation slice of the port against the JAX package's, on the CPU.

- ``evaluate_policy`` and ``generate_expert_data`` given exactly the
  numbers JAX's consume from their key: the reset keys' split
  (``tpu_plume/evaluation/harnesses.py:187-188``), each env's ``k_src``,
  ``k_seed`` and ``k_wind`` (``fields/analytic.py:51-62``; the uniforms on
  [0, 1) from the same keys, a bank row as ``(idx + 0.5) / K``), and per
  step ``key, k_act, k_step = split(key, 3)`` (``harnesses.py:225``; the
  Gumbel noise of ``categorical`` from ``k_act``, the normals from
  ``split(k_step, n)``) or the expert's 2-way split (``:411``).
- The three stop controllers step by step on seeded sequences.
- ``EvalMetrics``' ``.npz`` and ``.csv`` files and ``summarize``.

Tolerances: steps, ``stopped_early``, success, actions and row counts
equal; deviations, final concentrations, sources, trajectories, expert
states and peak predictions rtol 1e-5 / atol 1e-4, the env's float
tolerance; the anisotropic plume's floats rtol 1e-4 / atol 1e-3, as in
``tests/test_torch_aniso.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_plume.core.config import get_preset as j_get_preset
from tpu_plume.evaluation import harnesses as jh
from tpu_plume.fields import gridded as jg
from tpu_plume.models import ActorCritic as JActorCritic
from tpu_plume.stop import controllers as jc
from tpu_plume_torch.convert import actor_critic_from_flax, field_bank_from_numpy
from tpu_plume_torch.core.config import get_preset as t_get_preset
from tpu_plume_torch.evaluation import harnesses as th
from tpu_plume_torch.models import ActorCritic
from tpu_plume_torch.ops import plume
from tpu_plume_torch.stop import controllers as tc

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-4
ANISO_RTOL, ANISO_ATOL = 1e-4, 1e-3
N = 32


def _t(x, dtype=None):
    return torch.from_numpy(np.array(x, dtype=dtype))


def jax_draws(key, tcfg, n, length, bank_rows=None, expert=False,
              greedy=True) -> th.EvalDraws:
    """The port's ``EvalDraws`` holding the numbers that JAX's
    ``evaluate_policy`` (or, with ``expert``, ``generate_expert_data``)
    draws from ``key`` for ``n`` episodes over ``length`` steps."""
    k_reset, k_scan = jax.random.split(key)

    def per_env(k):
        k_src, k_seed, k_wind = jax.random.split(k, 3)
        if bank_rows:
            idx = jax.random.randint(k_src, (), 0, bank_rows)
            u = jnp.stack([(idx + 0.5) / bank_rows, 0.5]).astype(jnp.float32)
        else:
            u = jax.random.uniform(k_src, (2,), jnp.float32)
        seed = jax.random.randint(k_seed, (), 0, jnp.iinfo(jnp.int32).max)
        k_speed, k_dir = jax.random.split(k_wind)
        wind = jnp.stack([jax.random.uniform(k_speed, (), jnp.float32),
                          jax.random.uniform(k_dir, (), jnp.float32)])
        return u, seed, wind

    u_src, bits, u_wind = jax.vmap(per_env)(jax.random.split(k_reset, n))

    def body(key, _):
        if expert:
            key, k_step = jax.random.split(key)
            gumbel = jnp.zeros((n, tcfg.num_actions), jnp.float32)
        else:
            key, k_act, k_step = jax.random.split(key, 3)
            gumbel = jax.random.gumbel(k_act, (n, tcfg.num_actions),
                                       jnp.float32)
        noise = jax.vmap(lambda k: jax.random.normal(
            k, (tcfg.pos_dim,), jnp.float32))(jax.random.split(k_step, n))
        return key, (noise, gumbel)

    _, (turb, gumbel) = jax.jit(
        lambda k: jax.lax.scan(body, k, None, length=length))(k_scan)
    return th.EvalDraws(
        u_src=_t(u_src), bits=_t(bits, np.int32),
        u_wind=_t(u_wind) if plume.reads_wind(tcfg) else None,
        turb_noise=_t(turb), gumbel=None if greedy else _t(gumbel))


# Actor biases: a policy that stays put, and one that heads into the
# domain, +x or +y as the obs tips the balance.
STAY = (1.0, 0.0, 0.0, 0.0, 0.0)
INWARD = (0.0, 0.5, 0.0, 0.5, 0.0)


def models(env_cfg, key=0, bias=INWARD):
    """A JAX actor-critic's (model, params) and the port's model holding
    the same params, with ``bias`` added to the actor's bias (zero for the
    3-D flight's two extra actions)."""
    jmodel = JActorCritic(num_actions=env_cfg.num_actions)
    params = jmodel.init(jax.random.PRNGKey(key),
                         jnp.zeros((1, env_cfg.obs_dim)))
    params = jax.tree.map(np.array, params)
    params["params"]["Dense_2"]["bias"][:len(bias)] += np.float32(bias)
    tmodel = ActorCritic(env_cfg.obs_dim, env_cfg.num_actions)
    tmodel.load_state_dict(actor_critic_from_flax(params))
    return jmodel, jax.tree.map(jnp.asarray, params), tmodel


def compare_metrics(jm, tm, rtol=RTOL, atol=ATOL):
    for name in ("steps", "stopped_early", "success"):
        got, want = getattr(tm, name), np.asarray(getattr(jm, name))
        assert got.dtype == want.dtype, (name, got.dtype, want.dtype)
        np.testing.assert_array_equal(got, want, err_msg=name)
    for name in ("deviations", "final_conc", "sources", "peak_pred",
                 "trajectories"):
        got, want = getattr(tm, name), getattr(jm, name)
        assert (got is None) == (want is None), name
        if want is not None:
            assert got.shape == want.shape and got.dtype == want.dtype, name
            np.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                                       equal_nan=True, err_msg=name)


def _gate(kind, jcfg, tcfg):
    """Each package's stop gate of ``kind``, with the same stub
    predictors for the LSTM gates."""
    if kind == "heuristic":
        return (jh.make_heuristic_gate(jcfg.eval, jcfg.env.conc_peak),
                th.make_heuristic_gate(tcfg.eval, tcfg.env.conc_peak))
    if kind == "threshold":
        return (jh.make_threshold_gate(lambda w: w.mean() * 2.0 - 40.0,
                                       jcfg.stop),
                th.make_threshold_gate(lambda w: w.mean(-1) * 2.0 - 40.0,
                                       tcfg.stop))
    if kind == "peakstop":
        return (jh.make_peak_stop_gate(lambda w: (w.max(), w.mean() * 1.6),
                                       jcfg.stop),
                th.make_peak_stop_gate(
                    lambda w: (w.amax(-1), w.mean(-1) * 1.6), tcfg.stop))
    if kind == "always":
        return (jh.make_peak_stop_gate(
                    lambda w: (jnp.float32(1.0), jnp.float32(1.0)), jcfg.stop),
                th.make_peak_stop_gate(
                    lambda w: (torch.ones(w.shape[0]), torch.ones(w.shape[0])),
                    tcfg.stop))
    return None, None


# The gates' setting: a 100-cell grid with a wide plume, low turbulence and
# a goal radius of 5, and a policy that stays put at the start, so the
# concentration there decides: the gates fire where the source lies near
# the start and not elsewhere.
NEAR = dict(grid_size=100, source_padding=10.0, turbulence_intensity=0.5,
            plume_sigma=60.0, initial_radius=5.0)
# The other cases' setting: the same grid with a goal radius of 25, which
# an inward policy reaches in some episodes after a few steps.
MOVE = dict(grid_size=100, source_padding=10.0, initial_radius=25.0)
CASES = {   # name: (preset, env fields, gate, eval kwargs, actor bias)
    "greedy": ("ppo_v2_0", MOVE, None, {}, INWARD),
    "heuristic": ("ppo_v2_0", NEAR, "heuristic", {}, STAY),
    "sampled": ("ppo_v2_0", MOVE, None, {"greedy": False}, INWARD),
    "goal_radius": ("ppo_v2_0", MOVE, None,
                    {"goal_radius": 5.0, "track_trajectories": 8}, INWARD),
    "wrf_les": ("wrf_les", MOVE, None, {"track_trajectories": 4}, INWARD),
    "threshold": ("ppo_v2_0", NEAR, "threshold", {}, STAY),
    "peakstop": ("ppo_v2_0", NEAR, "peakstop", {}, STAY),
    "always_stop": ("ppo_v2_0", NEAR, "always", {}, STAY),
    "wrf_les_3d": ("wrf_les_3d", dict(grid_size=64, source_padding=10.0,
                                      domain_height=40.0,
                                      initial_radius=20.0), None, {}, INWARD),
    "static_bank": ("ppo_v2_0", dict(plume_model="gridded",
                                     subcell_sampling=True, grid_size=64,
                                     source_padding=10.0,
                                     initial_radius=20.0), None, {}, INWARD),
}
LENGTH = 60


def _configs(preset, env_kw):
    jcfg, tcfg = j_get_preset(preset), t_get_preset(preset)
    return (jcfg.replace(env=dataclasses.replace(jcfg.env, **env_kw)),
            tcfg.replace(env=dataclasses.replace(tcfg.env, **env_kw)))


def _banks(name, jcfg):
    """Each package's bank of a bank case (None, None otherwise)."""
    if name == "wrf_les_3d":
        jbank = jg.synthesize_3d_bank(jax.random.PRNGKey(0), jcfg.env,
                                      num_fields=3, num_frames=3,
                                      num_levels=4, grid=64,
                                      steps_per_frame=8.0)
    elif name == "static_bank":
        jbank = jg.synthesize_bank(jax.random.PRNGKey(0), jcfg.env,
                                   num_fields=3)
    else:
        return None, None
    return jbank, field_bank_from_numpy(
        np.array(jbank.conc), np.array(jbank.source),
        None if jbank.wind is None else np.array(jbank.wind),
        jbank.steps_per_frame, jbank.z_extent)


@pytest.mark.parametrize("name", sorted(CASES))
def test_evaluate_policy_matches_jax(name):
    preset, env_kw, gate, kw, bias = CASES[name]
    jcfg, tcfg = _configs(preset, env_kw)
    jbank, tbank = _banks(name, jcfg)
    jmodel, params, tmodel = models(jcfg.env, bias=bias)
    jgate, tgate = _gate(gate, jcfg, tcfg)
    key = jax.random.PRNGKey(11)
    jm = jh.evaluate_policy(params, jmodel.apply, jcfg.env, jcfg.eval, key,
                            num_episodes=N, stop_gate=jgate, max_steps=LENGTH,
                            bank=jbank, **kw)
    draws = jax_draws(key, tcfg.env, N, LENGTH,
                      bank_rows=None if tbank is None else 3,
                      greedy=kw.get("greedy", True))
    tm = th.evaluate_policy(tmodel, tcfg.env, tcfg.eval, draws=draws,
                            device="cpu", num_episodes=N, stop_gate=tgate, max_steps=LENGTH,
                            bank=tbank, **kw)
    aniso = tcfg.env.plume_model == "anisotropic"
    compare_metrics(jm, tm, *((ANISO_RTOL, ANISO_ATOL) if aniso
                              else (RTOL, ATOL)))
    if gate in ("heuristic", "threshold", "peakstop"):
        # the gate fires in some episodes and not in all
        assert 0 < tm.stopped_early.sum() < N, tm.stopped_early
    if gate == "always":
        assert tm.stopped_early.all()
        assert (tm.steps == tcfg.stop.peak_stop_window).all()
    if name == "goal_radius":
        assert tm.trajectories.shape == (8, LENGTH, 3)
        assert np.isnan(tm.trajectories).any() == (tm.steps[:8] < LENGTH).any()


@pytest.mark.parametrize("greedy", [True, False], ids=["greedy", "sampled"])
def test_evaluation_varies_across_episodes(greedy):
    """The moving cases end episodes both by reaching the source, at the
    first step or later, and by running out of steps, so their comparisons
    see all three."""
    _, tcfg = _configs("ppo_v2_0", MOVE)
    _, _, tmodel = models(tcfg.env)
    m = th.evaluate_policy(tmodel, tcfg.env, tcfg.eval,
                           torch.Generator().manual_seed(0), num_episodes=N,
                           max_steps=LENGTH, greedy=greedy, device="cpu")
    assert (m.steps == 1).any() and (m.steps == LENGTH).any()
    assert ((m.steps > 1) & (m.steps < LENGTH)).any()
    assert m.success[m.steps < LENGTH].all()


def test_generate_expert_data_matches_jax(tmp_path):
    jcfg, tcfg = _configs("ppo_v2_0", dict(MOVE, max_steps=40))
    jmodel, params, tmodel = models(jcfg.env)
    key = jax.random.PRNGKey(5)
    js, ja = jh.generate_expert_data(params, jmodel.apply, jcfg.env, key,
                                     num_episodes=16)
    path = str(tmp_path / "expert_data.npz")
    ts, ta = th.generate_expert_data(
        tmodel, tcfg.env, num_episodes=16, path=path, device="cpu",
        draws=jax_draws(key, tcfg.env, 16, 40, expert=True))
    assert ts.shape == js.shape and ts.shape[0] < 16 * 40
    np.testing.assert_array_equal(ta, np.asarray(ja))
    np.testing.assert_allclose(ts, js, rtol=RTOL, atol=ATOL)
    from tpu_plume.data import load_expert_data as j_load

    ls, la = j_load(path)
    assert ls.dtype == np.float32 and la.dtype == np.int64
    np.testing.assert_array_equal(ls, ts)
    np.testing.assert_array_equal(la, ta)


def test_three_dimensional_heuristic_gate_raises_as_jax_does():
    _, tcfg = _configs("wrf_les_3d", {})
    state = tc.broadcast(tc.heuristic_stop_init(tcfg.eval), 4, "cpu")
    with pytest.raises(ValueError, match="3-D flight"):
        tc.heuristic_stop_step(state, torch.zeros(4, 3), torch.zeros(4),
                               100.0, tcfg.eval)
    jstate = jax.tree.map(lambda x: jnp.broadcast_to(x, (4,) + x.shape),
                          jc.heuristic_stop_init(j_get_preset("ppo_v2_0").eval))
    with pytest.raises(ValueError):
        jax.vmap(lambda s, p: jc.heuristic_stop_step(
            s, p, jnp.float32(1.0), 100.0, j_get_preset("ppo_v2_0").eval))(
            jstate, jnp.zeros((4, 3)))


def _sequences(seed, n=16, steps=40):
    """Concentrations f32[steps, n] that rise toward the source in some
    episodes, and positions f32[steps, n, 2] that settle in some."""
    rng = np.random.default_rng(seed)
    rise = rng.uniform(0.0, 3.0, n).astype(np.float32)
    conc = (20.0 + rise * np.arange(steps)[:, None]
            + rng.normal(0, 2.0, (steps, n))).astype(np.float32)
    spread = rng.choice([0.3, 4.0], n).astype(np.float32)
    pos = (250.0 + spread[None, :, None]
           * rng.normal(size=(steps, n, 2))).astype(np.float32)
    return conc, pos


@pytest.mark.parametrize("kind", ["threshold", "peakstop", "heuristic"])
def test_controllers_step_like_jax(kind):
    jcfg, tcfg = _configs("ppo_v2_0", {})
    conc, pos = _sequences(len(kind))
    n = conc.shape[1]
    jgate, tgate = _gate(kind, jcfg, tcfg)
    jstate = jax.tree.map(lambda x: jnp.broadcast_to(x, (n,) + x.shape),
                          jgate[0])
    tstate = tc.broadcast(tgate[0], n, "cpu")
    jstep = jax.jit(jax.vmap(jgate[1]))
    fired = 0
    for t in range(conc.shape[0]):
        jstate, jstop = jstep(jstate, jnp.asarray(conc[t]), jnp.asarray(pos[t]))
        tstate, tstop = tgate[1](tstate, _t(conc[t]), _t(pos[t]))
        np.testing.assert_array_equal(tstop.numpy(), np.asarray(jstop),
                                      err_msg=f"step {t}")
        fired += int(tstop.sum())
        for f in dataclasses.fields(tstate):
            got = getattr(tstate, f.name).numpy()
            want = np.asarray(getattr(jstate, f.name))
            assert got.dtype == want.dtype, (f.name, got.dtype, want.dtype)
            if got.dtype == np.float32:
                np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL,
                                           equal_nan=True, err_msg=f.name)
            else:
                np.testing.assert_array_equal(got, want, err_msg=f.name)
    assert 0 < fired < n * conc.shape[0]


def _metrics(cls, with_peak):
    rng = np.random.default_rng(3)
    dev = rng.uniform(0, 300, 12).astype(np.float32)
    return cls(deviations=dev, steps=rng.integers(1, 1000, 12, dtype=np.int32),
               success=dev <= 40.0,
               stopped_early=rng.random(12) < 0.3,
               peak_pred=(rng.random(12).astype(np.float32) if with_peak
                          else None),
               final_conc=rng.uniform(0, 100, 12).astype(np.float32))


@pytest.mark.parametrize("with_peak", [False, True], ids=["plain", "peak"])
def test_metrics_files_and_summary_match_jax(tmp_path, with_peak):
    jm, tm = _metrics(jh.EvalMetrics, with_peak), _metrics(th.EvalMetrics,
                                                            with_peak)
    for pkg, m in (("jax", jm), ("port", tm)):
        m.save_npz(str(tmp_path / f"{pkg}.npz"))
        m.save_csv(str(tmp_path / f"{pkg}.csv"))
    jz, tz = np.load(tmp_path / "jax.npz"), np.load(tmp_path / "port.npz")
    assert jz.files == tz.files
    for k in jz.files:
        assert jz[k].dtype == tz[k].dtype, k
        np.testing.assert_array_equal(jz[k], tz[k], err_msg=k)
    assert ((tmp_path / "jax.csv").read_text()
            == (tmp_path / "port.csv").read_text())
    assert jh.summarize(jm) == th.summarize(tm)
    none_ok = dataclasses.replace(tm, success=np.zeros(12, bool))
    assert th.summarize(none_ok) == jh.summarize(
        dataclasses.replace(jm, success=np.zeros(12, bool)))


@pytest.mark.parametrize("entry", ["evaluate_policy", "generate_expert_data"])
def test_eval_runs_on_the_card_unless_asked_for_the_cpu(entry, monkeypatch):
    _, tcfg = _configs("ppo_v2_0", dict(MOVE, max_steps=5))
    _, _, tmodel = models(tcfg.env)
    fn = getattr(th, entry)
    args = ((tmodel, tcfg.env, tcfg.eval) if entry == "evaluate_policy"
            else (tmodel, tcfg.env))
    gen = torch.Generator().manual_seed(0)
    assert fn(*args, gen, num_episodes=4, device="cpu") is not None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fn(*args, gen, num_episodes=4)
    assert next(tmodel.parameters()).device.type == "cpu"


def test_eval_checks_its_draws_and_refuses_unported_options():
    _, tcfg = _configs("ppo_v2_0", {})
    _, _, tmodel = models(tcfg.env)
    draws = th.draw_eval(torch.Generator().manual_seed(0), tcfg.env, 5, 4)
    with pytest.raises(ValueError, match="turb_noise"):
        th.evaluate_policy(tmodel, tcfg.env, tcfg.eval, draws=draws,
                           num_episodes=4, max_steps=6, device="cpu")
    with pytest.raises(ValueError, match="gumbel"):
        th.evaluate_policy(tmodel, tcfg.env, tcfg.eval, draws=draws,
                           num_episodes=4, max_steps=5, greedy=False,
                           device="cpu")
    # the scripted oracle (slice 10's refusal until it was ported) replaces
    # the policy, which is then neither read nor needed
    m = th.evaluate_policy(None, tcfg.env, tcfg.eval, draws=draws,
                           num_episodes=4, max_steps=5, device="cpu",
                           oracle=lambda st: torch.zeros_like(st.t,
                                                              dtype=torch.int64))
    assert (m.steps == 5).all()
