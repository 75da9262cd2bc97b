"""The scripted oracles of the port (``evaluation/oracle.py``) against the
JAX package's, on the CPU.

- Each of the four kinds against JAX's ``make_oracle`` (vmapped) on 4096
  seeded states (positions, sources, radii and step counts, a quarter of
  them on the goal ball's axis-aligned rim, where moves tie), with the
  episode's own geometry and with the protocol's pinned: actions equal.
- JAX's four oracle tests (``tests/test_stop_eval.py``) replayed on the
  port with their asserts.
- ``evaluate_policy(oracle=)`` and ``generate_expert_data(oracle=)`` on
  ppo_v2_0 against JAX's given the draws JAX consumes (``jax_draws``):
  steps, success and actions equal, deviations and expert states at the
  env tolerance (rtol 1e-5, atol 1e-4).  No policy is built or loaded.
"""

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_plume.core.config import EnvConfig as JEnvConfig
from tpu_plume.evaluation import harnesses as jh
from tpu_plume.evaluation import oracle as jor
from tpu_plume_torch.core.config import EnvConfig as TEnvConfig
from tpu_plume_torch.env import methane as tenv
from tpu_plume_torch.evaluation import harnesses as th
from tpu_plume_torch.evaluation import oracle as tor

from test_torch_eval import _configs, compare_metrics, jax_draws

torch.set_num_threads(1)

N = 4096
SIGMA = dict(plume_sigma=500 / 16)


def seeded_states(n, seed, pos_dim=2):
    """Numpy positions, sources, radii and step counts of ``n`` episodes:
    a quarter on the ball of radius 50 about the source along an axis
    (where landings tie), the rest 20-120 px from it, radii in [5, 60]."""
    rng = np.random.default_rng(seed)
    src = rng.uniform(60.0, 440.0, (n, 2)).astype(np.float32)
    ang = rng.uniform(0.0, 2 * np.pi, n)
    r = rng.uniform(20.0, 120.0, n)
    q = n // 4
    r[:q] = 50.0
    ang[:q] = np.round(ang[:q] / (np.pi / 2)) * (np.pi / 2)
    pos = (src + np.stack([r * np.cos(ang), r * np.sin(ang)], -1))
    pos = np.clip(pos, 0.0, 499.0).astype(np.float32)
    if pos_dim == 3:
        pos = np.concatenate([pos, rng.uniform(0, 50, (n, 1))], -1)
    radius = rng.uniform(5.0, 60.0, n).astype(np.float32)
    radius[:q // 2] = 50.0
    t = rng.integers(0, 40, n).astype(np.int32)
    return pos.astype(np.float32), src, radius, t


class Field(NamedTuple):
    source: object


class State(NamedTuple):
    """The env state's fields an oracle reads (a pytree for JAX's vmap)."""
    pos: object
    field: Field
    radius: object
    t: object


def state(pos, src, radius, t, lib):
    """A stand-in env state of the arrays (JAX's one episode; the port's
    batch)."""
    return State(pos=lib(pos), field=Field(source=lib(src)),
                 radius=lib(radius), t=lib(t))


@pytest.mark.parametrize("pinned", [False, True], ids=["dynamic", "pinned"])
@pytest.mark.parametrize("kind", tor.ORACLE_KINDS)
def test_oracle_actions_match_jax(kind, pinned):
    assert tor.ORACLE_KINDS == jor.ORACLE_KINDS
    cfg_j, cfg_t = JEnvConfig(**SIGMA), TEnvConfig(**SIGMA)
    kw = dict(terminate_radius=50.0) if pinned else {}
    pos, src, radius, t = seeded_states(N, seed=1 + pinned)
    want = jax.jit(jax.vmap(jor.make_oracle(kind, cfg_j, **kw)))(
        state(pos, src, radius, t, jnp.asarray))
    got = tor.make_oracle(kind, cfg_t, **kw)(
        state(pos, src, radius, t, torch.from_numpy))
    assert got.dtype == torch.int64 and got.shape == (N,)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # every move is taken
    assert np.isin([1, 2, 3, 4], got.numpy()).all()


def test_oracle_reads_the_plane_of_3d_flight_as_jax_does():
    cfg_j = JEnvConfig(env_3d=True, **SIGMA)
    cfg_t = TEnvConfig(env_3d=True, **SIGMA)
    pos, src, radius, t = seeded_states(512, seed=3, pos_dim=3)
    for kind in tor.ORACLE_KINDS:
        want = jax.vmap(jor.make_oracle(kind, cfg_j))(
            state(pos, src, radius, t, jnp.asarray))
        got = tor.make_oracle(kind, cfg_t)(
            state(pos, src, radius, t, torch.from_numpy))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_make_oracle_refuses_an_unknown_kind_as_jax_does():
    with pytest.raises(ValueError) as want:
        jor.make_oracle("greedy", JEnvConfig())
    with pytest.raises(ValueError) as got:
        tor.make_oracle("greedy", TEnvConfig())
    assert str(got.value) == str(want.value)


def one(pos, src, radius=50.0, t=30):
    """One episode's state for the port's oracle (JAX's ``_oracle_state``:
    ``t`` past the raster's descent)."""
    return state([pos], [src], [radius], [t],
                 lambda x: torch.tensor(np.asarray(x)))


def test_oracle_phase_avoids_shallow_crossing():
    """From d=60 along +x (move 25) the crossing lands at 35 (deep): look1
    and phase take it; from d=70 every crossing lands shallow (45): look1
    staircases into it, phase takes a setup step outside the ball."""
    cfg = TEnvConfig(**SIGMA)
    look1 = tor.make_oracle("look1", cfg)
    phase = tor.make_oracle("phase", cfg)
    deep_avail = one([200.0, 250.0], [260.0, 250.0])
    assert int(look1(deep_avail)) == 3
    assert int(phase(deep_avail)) == 3
    shallow_only = one([190.0, 250.0], [260.0, 250.0])
    assert int(look1(shallow_only)) == 3
    a = int(phase(shallow_only))
    assert a != 3
    deltas = np.array([[0, 0], [0, 25], [0, -25], [25, 0], [-25, 0]],
                      np.float32)
    d_after = np.linalg.norm(np.array([190.0, 250.0]) + deltas[a]
                             - [260.0, 250.0])
    assert d_after > 50.0


def test_oracle_raster_sweeps_without_source():
    """raster reads only pos and t: +x on even bands, -x on odd ones, +y at
    a row's end, and straight down for the first grid/move steps."""
    cfg = TEnvConfig(**SIGMA)
    raster = tor.make_oracle("raster", cfg)
    band = 1.12 * cfg.plume_sigma
    assert int(raster(one([250.0, 0.5 * band], [999.0, 999.0]))) == 3
    assert int(raster(one([250.0, 1.5 * band], [999.0, 999.0]))) == 4
    assert int(raster(one([495.0, 0.5 * band], [999.0, 999.0]))) == 1
    assert int(raster(one([250.0, 400.0], [999.0, 999.0], t=0))) == 2


def test_oracle_phase_lands_deep_through_real_env():
    """The phase oracle through the port's turbulent env: 24 episodes of
    120 steps reach the ball in at least 16, at least 60% of them within
    40 px (JAX's thresholds)."""
    cfg = TEnvConfig(max_steps=120, **SIGMA)
    oracle = tor.make_oracle("phase", cfg)
    gen = torch.Generator().manual_seed(0)
    n = 24
    u = torch.rand(n, 2, generator=gen)
    bits = torch.randint(0, 2**31 - 1, (n,), generator=gen,
                         dtype=torch.int32)
    st, _ = tenv.reset_from_draws(u, None, bits, cfg)
    finished = torch.zeros(n, dtype=torch.bool)
    reached = torch.zeros(n, dtype=torch.bool)
    deep = torch.zeros(n, dtype=torch.bool)
    for _ in range(cfg.max_steps):
        new, tr = tenv.step_noise(st, oracle(st),
                                  torch.randn(n, 2, generator=gen), cfg)
        live = ~finished
        reached |= live & tr.info.reached
        deep |= live & tr.info.reached & (tr.info.distance <= 40.0)
        st = tenv.select(live, new, st)
        finished |= tr.done
    assert int(reached.sum()) >= 16
    assert deep.sum() / reached.sum() >= 0.6


def test_generate_expert_data_oracle_needs_no_policy():
    cfg = TEnvConfig(max_steps=60, **SIGMA)
    states, actions = th.generate_expert_data(
        None, cfg, torch.Generator().manual_seed(1), num_episodes=8,
        device="cpu", oracle=tor.make_oracle("phase", cfg))
    assert states.shape[1] == cfg.obs_dim
    assert states.shape[0] == actions.shape[0] > 0
    assert 0 <= actions.min() and actions.max() < 5


def test_oracle_follows_episode_radius():
    """Under a shrunken radius (7.4) the phase teacher approaches (+x);
    at 50 it refuses the shallow crossing; pinned geometry overrides the
    episode's radius."""
    cfg = TEnvConfig(**SIGMA)
    phase = tor.make_oracle("phase", cfg)
    assert int(phase(one([190.0, 250.0], [260.0, 250.0], radius=7.4))) == 3
    assert int(phase(one([190.0, 250.0], [260.0, 250.0], radius=50.0))) != 3
    pinned = tor.make_oracle("phase", cfg, terminate_radius=50.0)
    assert int(pinned(one([190.0, 250.0], [260.0, 250.0], radius=7.4))) != 3


@pytest.mark.parametrize("kind", ["phase", "raster"])
def test_oracle_eval_matches_jax(kind):
    """ppo_v2_0, 32 episodes x 60 steps, the oracle in place of any
    policy."""
    jcfg, tcfg = _configs("ppo_v2_0", {})
    key = jax.random.PRNGKey(2)
    jm = jh.evaluate_policy(None, None, jcfg.env, jcfg.eval, key,
                            num_episodes=32, max_steps=60,
                            oracle=jor.make_oracle(kind, jcfg.env))
    tm = th.evaluate_policy(None, tcfg.env, tcfg.eval,
                            draws=jax_draws(key, tcfg.env, 32, 60),
                            num_episodes=32, max_steps=60, device="cpu",
                            oracle=tor.make_oracle(kind, tcfg.env))
    compare_metrics(jm, tm)
    if kind == "phase":
        assert tm.success.mean() > 0.5 and (tm.steps == 60).any()


def test_oracle_expert_data_matches_jax(tmp_path):
    jcfg, tcfg = _configs("ppo_v2_0", dict(max_steps=60))
    key = jax.random.PRNGKey(6)
    js, ja = jh.generate_expert_data(None, None, jcfg.env, key,
                                     num_episodes=32,
                                     oracle=jor.make_oracle("naive",
                                                            jcfg.env))
    ts, ta = th.generate_expert_data(
        None, tcfg.env, num_episodes=32, device="cpu",
        path=str(tmp_path / "expert_data.npz"),
        draws=jax_draws(key, tcfg.env, 32, 60, expert=True),
        oracle=tor.make_oracle("naive", tcfg.env))
    assert ts.shape == js.shape and ts.shape[0] < 32 * 60
    np.testing.assert_array_equal(ta, np.asarray(ja))
    np.testing.assert_allclose(ts, js, rtol=1e-5, atol=1e-4)


def test_guided_oracle_eval_composes_as_jax_does():
    """``--oracle raster --guide fit``: the guide overrides the raster
    surveyor's moves (JAX's zero-learned-components system)."""
    from tpu_plume.evaluation.guidance import make_guide as j_make_guide
    from tpu_plume_torch.evaluation.guidance import make_guide as t_make_guide

    jcfg, tcfg = _configs("ppo_v2_0", dict(grid_size=250,
                                           source_padding=25.0,
                                           move_frac=0.1))
    key = jax.random.PRNGKey(8)
    jm = jh.evaluate_policy(None, None, jcfg.env, jcfg.eval, key,
                            num_episodes=16, max_steps=200,
                            oracle=jor.make_oracle("raster", jcfg.env),
                            guide=j_make_guide(jcfg.env))
    tm = th.evaluate_policy(None, tcfg.env, tcfg.eval,
                            draws=jax_draws(key, tcfg.env, 16, 200),
                            num_episodes=16, max_steps=200, device="cpu",
                            oracle=tor.make_oracle("raster", tcfg.env),
                            guide=t_make_guide(tcfg.env))
    for name in ("steps", "success", "guide_fit_ok", "guide_hover",
                 "guide_committed", "guide_samples"):
        np.testing.assert_array_equal(getattr(tm, name),
                                      np.asarray(getattr(jm, name)),
                                      err_msg=name)
    np.testing.assert_allclose(tm.deviations, np.asarray(jm.deviations),
                               rtol=1e-5, atol=1e-4)
    assert tm.guide_fit_ok.any()
