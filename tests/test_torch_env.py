"""Parity of the port's batched env with the JAX package's vmapped env, on
the CPU.

Both start from the same reset draws and take the same actions,
turbulence normals and reset draws for several steps, across the v1_1,
v1_0 (elastic walls, flat penalties) and delta (in-plume bonus, depth and
gate terms) rewards and with ``obs_memory``.  Done flags, ``reached``,
step counts, visit grids and grid cells are compared with equality.
Floats (positions, obs, rewards, field samples) pass through
exp/log/sin/cos/pow of two libraries and are compared at rtol 1e-5 with an
absolute floor of 1e-4 on quantities of order 1-500.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_plume.core.config import get_preset
from tpu_plume.env import methane as jenv
from tpu_plume.fields.analytic import new_field_from_draws as j_new_field
from tpu_plume.fields.analytic import sample_conc_tke as j_sample
from tpu_plume_torch.core import get_preset as t_get_preset
from tpu_plume_torch.env import methane as tenv
from tpu_plume_torch.ops.plume import cell_of

torch.set_num_threads(1)

N = 24
STEPS = 12
RTOL, ATOL = 1e-5, 1e-4


def _cfgs(preset, **env_kw):
    jcfg = get_preset(preset)
    tcfg = t_get_preset(preset)
    return (dataclasses.replace(jcfg.env, **env_kw),
            dataclasses.replace(tcfg.env, **env_kw))


def _j_fresh(u_src, bits, cfg, radius, bonus):
    """The JAX package's fresh state from draws (the construction of
    ``auto_reset_from_draws``), vmapped over envs."""
    def one(u, b, r, e):
        field = j_new_field(u, jnp.zeros(2), b, cfg)
        z = jnp.zeros((), jnp.int32)
        c0, k0 = j_sample(field, z, z, cfg)
        d = cfg.grid_divisions
        st = jenv.EnvState(
            pos=jnp.zeros(2, jnp.float32), t=z,
            visited=jnp.zeros((d, d), jnp.int32), field=field, radius=r,
            explore_bonus=e, conc=c0, tke=k0, prev_conc=c0, prev_action=z)
        return st, jenv.observe(st, cfg)
    return jax.vmap(one)(u_src, bits, radius, bonus)


def _compare(js, jobs, ts, tobs):
    np.testing.assert_array_equal(ts.t.numpy(), np.asarray(js.t))
    np.testing.assert_array_equal(ts.visited.numpy(), np.asarray(js.visited))
    np.testing.assert_array_equal(ts.prev_action.numpy(),
                                  np.asarray(js.prev_action))
    np.testing.assert_array_equal(ts.field.seed.numpy().view(np.uint32),
                                  np.asarray(js.field.seed))
    for a, b in ((ts.pos, js.pos), (ts.field.source, js.field.source),
                 (ts.conc, js.conc), (ts.tke, js.tke),
                 (ts.prev_conc, js.prev_conc), (tobs, jobs)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL,
                                   atol=ATOL)
    gx, gy = cell_of(ts.pos, 500)
    jcell = np.clip(np.floor(np.asarray(js.pos)).astype(np.int32), 0, 499)
    np.testing.assert_array_equal(gx.numpy(), jcell[:, 0])
    np.testing.assert_array_equal(gy.numpy(), jcell[:, 1])


CASES = {
    "v1_1": ("ppo_v2_0", {}),
    "v1_0": ("ppo_v1_0", {"max_steps": 7}),
    "delta": ("ppo_v2_0", {"reward_variant": "delta", "inplume_bonus": 0.5,
                           "terminal_depth_coef": 30.0,
                           "terminal_depth_power": 2.0,
                           "terminal_gate_radius": 200.0}),
    "obs_memory": ("ppo_v1_1", {"obs_memory": True, "max_steps": 9}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_env_steps_match_jax(case):
    preset, kw = CASES[case]
    jcfg, tcfg = _cfgs(preset, **kw)
    rng = np.random.default_rng(len(case))
    # Radii of 40-300 make some envs reach the source within the test.
    radius = rng.uniform(40.0, 300.0, N).astype(np.float32)
    bonus = np.full(N, 0.6, np.float32)

    u0 = rng.random((N, 2), dtype=np.float32)
    b0 = rng.integers(0, 2**32, N, dtype=np.uint64).astype(np.uint32)
    js, jobs = _j_fresh(jnp.asarray(u0), jnp.asarray(b0), jcfg,
                        jnp.asarray(radius), jnp.asarray(bonus))
    ts, tobs = tenv.reset_from_draws(
        torch.from_numpy(u0), None, torch.from_numpy(b0.view(np.int32)),
        tcfg)
    ts = ts.replace(radius=torch.from_numpy(radius))
    tobs = tenv.observe(ts, tcfg)
    _compare(js, jobs, ts, tobs)

    jstep = jax.jit(jax.vmap(lambda s, a, n: jenv.step_noise(s, a, n, jcfg)))
    jreset = jax.jit(jax.vmap(
        lambda s, o, d, u, b: jenv.auto_reset_from_draws(
            s, o, d, u, jnp.zeros(2), b, jcfg)))
    dones = 0
    reached = 0
    for _ in range(STEPS):
        action = rng.integers(0, 5, N)
        noise = rng.standard_normal((N, 2), dtype=np.float32)
        u = rng.random((N, 2), dtype=np.float32)
        bits = rng.integers(0, 2**32, N, dtype=np.uint64).astype(np.uint32)

        js, jtr = jstep(js, jnp.asarray(action, jnp.int32), jnp.asarray(noise))
        ts, ttr = tenv.step_noise(ts, torch.from_numpy(action),
                                  torch.from_numpy(noise), tcfg)
        np.testing.assert_array_equal(ttr.done.numpy(), np.asarray(jtr.done))
        np.testing.assert_array_equal(ttr.info.reached.numpy(),
                                      np.asarray(jtr.info.reached))
        for name in ("concentration_reward", "explore_reward", "move_penalty",
                     "tke_penalty", "boundary_penalty", "distance",
                     "conc_raw"):
            np.testing.assert_allclose(
                getattr(ttr.info, name).numpy(),
                np.asarray(getattr(jtr.info, name)), rtol=RTOL, atol=ATOL,
                err_msg=name)
        np.testing.assert_allclose(ttr.reward.numpy(), np.asarray(jtr.reward),
                                   rtol=RTOL, atol=ATOL)
        _compare(js, jtr.obs, ts, ttr.obs)
        dones += int(ttr.done.sum())
        reached += int(ttr.info.reached.sum())

        js, jobs = jreset(js, jtr.obs, jtr.done, jnp.asarray(u),
                          jnp.asarray(bits))
        ts, tobs = tenv.auto_reset_from_draws(
            ts, ttr.obs, ttr.done, torch.from_numpy(u), None,
            torch.from_numpy(bits.view(np.int32)), tcfg)
        _compare(js, jobs, ts, tobs)
    # the run reached sources and, where max_steps is short, timed out
    assert reached > 0
    assert dones > reached or "max_steps" not in kw


def test_select_keeps_unfinished_envs():
    _, tcfg = _cfgs("ppo_v2_0")
    u = torch.rand(4, 2, generator=torch.Generator().manual_seed(0))
    bits = torch.arange(4, dtype=torch.int32)
    s, _ = tenv.reset_from_draws(u, None, bits, tcfg)
    s2, _ = tenv.reset_from_draws(1 - u, None, bits + 7, tcfg)
    done = torch.tensor([True, False, True, False])
    out = tenv.select(done, s2, s)
    assert torch.equal(out.field.seed, torch.tensor([7, 1, 9, 3],
                                                    dtype=torch.int32))
    assert torch.equal(out.field.source[1], s.field.source[1])
