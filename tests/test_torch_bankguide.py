"""The bank-match terminal guide of the port (``evaluation/bank_guide.py``)
against the JAX package's, on the CPU.

- The step teacher-forced: the port's guide flies episodes over a bank in
  closed loop with a scripted policy (toward the source, sometimes a
  random move, in 3-D flight also the policy's +z / -z actions 5 and 6),
  recording each step's (pos, conc, policy action, step count) and
  outputs; JAX's step, vmapped over the episodes with the bank shared, is
  then run over the same inputs in one ``lax.scan`` and every register,
  action and gate compared at every step.  Over a static [6, 64, 64], a
  time-varying [3, 4, 64, 64] and a 3-D [2, 3, 4, 64, 64] bank with the
  defaults, and one case per option on the static bank (and on the 3-D
  one for the options that index a landing by the policy's action).  A
  bank of duplicate rows holds ``lax.top_k``'s tie order.
- ``evaluate_policy`` with the bank guide against JAX's given the draws
  JAX consumes (``jax_draws``).

The banks are wide Gaussian plumes built in numpy from a seed (each
package gets the same arrays), so that every flight reads the plume.
Tolerances: actions, gates and every integer and bool register equal;
``score`` and ``est`` rtol 1e-5 / atol 1e-6.  On the static bank the
scores are bit-equal (cell lookups, the same sums); on the 4-D and 5-D
banks XLA may contract the frame and level lerps, so an episode may part
only where its scores differ between the packages and a score decision
(the top-2 gap, the margin ratio) lies within 1e-5 relative of its bound,
at most one episode per flight, each logged.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_plume.core.config import EnvConfig as JEnvConfig
from tpu_plume.evaluation import bank_guide as jbg
from tpu_plume.evaluation import harnesses as jh
from tpu_plume.fields.gridded import FieldBank as JFieldBank
from tpu_plume_torch.convert import field_bank_from_numpy
from tpu_plume_torch.core.config import EnvConfig as TEnvConfig
from tpu_plume_torch.env import methane as tenv
from tpu_plume_torch.evaluation import bank_guide as tbg
from tpu_plume_torch.evaluation import harnesses as th
from tpu_plume_torch.stop.controllers import broadcast

from test_torch_eval import jax_draws, models

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6
TIE_MARGIN = 1e-5
# A 64-cell domain with 4-px moves and a goal ball of 12 px (the guide's
# success radius 18 gives a deep target of 8 px and a take bound of 12).
ENV = dict(plume_model="gridded", grid_size=64, source_padding=8.0,
           move_frac=0.0625, initial_radius=12.0)
ENV_3D = dict(ENV, env_3d=True, domain_height=24.0, z_move_frac=0.0625)
GEOMETRY = dict(terminate_radius=12.0, success_radius=18.0)
SIGMA = 9.0


def gauss_bank(kind, seed=0, duplicate=False):
    """Numpy (conc, source, steps_per_frame, z_extent) of a bank of wide
    Gaussian plumes at random sources: ``static`` [6, 64, 64], ``time``
    [3, 4, 64, 64] (the plume drifts across frames), ``3d`` [2, 3, 4, 64,
    64] (its peak also falls off with height).  ``duplicate``: rows 3-5 of
    the static bank repeat rows 0-2, with other sources."""
    rng = np.random.default_rng(seed)
    g = 64
    k = {"static": 6, "time": 3, "3d": 2}[kind]
    src = rng.uniform(12.0, 52.0, (k, 2)).astype(np.float32)
    ix = np.arange(g, dtype=np.float32)[:, None]
    iy = np.arange(g, dtype=np.float32)[None, :]

    def plume(s, peak=100.0):
        d2 = (ix - s[0]) ** 2 + (iy - s[1]) ** 2
        return (peak * np.exp(-d2 / (2.0 * SIGMA ** 2))).astype(np.float32)

    if kind == "static":
        conc = np.stack([plume(s) for s in src])
        if duplicate:
            conc[3:] = conc[:3]
        return conc, src, 1.0, 0.0
    drift = rng.uniform(-3.0, 3.0, (k, 2)).astype(np.float32)
    frames = np.stack([np.stack([plume(s + f * d) for f in range(
        {"time": 4, "3d": 3}[kind])]) for s, d in zip(src, drift)])
    if kind == "time":
        return frames, src, 8.0, 0.0
    levels = np.array([1.0, 0.8, 0.5, 0.3], np.float32)
    return (frames[:, :, None] * levels[None, None, :, None, None]
            ).astype(np.float32), src, 8.0, 24.0


def banks(kind, **kw):
    conc, src, spf, z = gauss_bank(kind, **kw)
    return (JFieldBank(conc=jnp.asarray(conc), source=jnp.asarray(src),
                       steps_per_frame=spf, z_extent=z),
            field_bank_from_numpy(conc, src, None, spf, z))


def configs(three_d=False):
    kw = ENV_3D if three_d else ENV
    return JEnvConfig(**kw), TEnvConfig(**kw)


def bank_flight(step, init, cfg, bank, n, length, seed):
    """``n`` episodes of ``length`` steps of the port's env over ``bank``
    with the guide in the loop: the policy takes the staircase toward the
    source 60% of the time, else a random action (any of the 7 in 3-D
    flight).  Episodes do not end.  Returns one tuple per step: (input
    state, pos, conc, policy action, step count, outputs)."""
    rng = np.random.default_rng(seed)
    u = torch.from_numpy(rng.random((n, 2), dtype=np.float32))
    bits = torch.from_numpy(rng.integers(0, 2**31, n, dtype=np.int64)
                            .astype(np.int32))
    state, _ = tenv.reset_from_draws(u, None, bits, cfg, bank=bank)
    gs = broadcast(init, n, "cpu")
    steps = []
    for _ in range(length):
        gap = (state.field.source - state.pos[:, :2]).numpy()
        toward = np.where(np.abs(gap[:, 0]) >= np.abs(gap[:, 1]),
                          np.where(gap[:, 0] > 0, 3, 4),
                          np.where(gap[:, 1] > 0, 1, 2))
        act = np.where(rng.random(n) < 0.6, toward,
                       rng.integers(0, cfg.num_actions, n))
        act = torch.from_numpy(act.astype(np.int64))
        out = step(gs, state.pos, state.conc, act, bank, state.t)
        steps.append((gs, state.pos, state.conc, act, state.t, out))
        gs = out[0]
        turb = torch.from_numpy(rng.standard_normal(
            (n, cfg.pos_dim), dtype=np.float32))
        state, _ = tenv.step_noise(state, out[1], turb, cfg, bank)
    return steps


def score_tie(got, want, margin) -> np.ndarray:
    """Per episode, whether its scores differ between the packages and a
    score decision lies within TIE_MARGIN of its bound: the gap between
    any two of its three lowest scores, and the margin ratio."""
    ranked = np.sort(got, -1)
    lo = ranked[:, :3]
    gaps = [np.abs(lo[:, i] - lo[:, j]) / np.maximum(lo[:, j], 1e-30)
            for i, j in ((0, 1), (1, 2), (0, 2))]
    gaps.append(np.abs(ranked[:, 1] - margin * ranked[:, 0])
                / np.maximum(ranked[:, 1], 1e-30))
    near = np.min(gaps, 0) < TIE_MARGIN
    return near & (got != want).any(-1)


def replay(steps, j_step, j_init, jbank, margin=1.0, active=None):
    """Run the recorded inputs through JAX's vmapped step in one
    ``lax.scan`` (each package carrying its own state; ``active`` [T, N]
    freezes an episode after its last step) and compare each step's
    outputs with the port's.  An episode that parts (``score_tie``) is
    dropped from that step on; returns the mask of dropped episodes."""
    n = steps[0][1].shape[0]
    xs = tuple(jnp.asarray(np.stack([s[k].numpy() for s in steps]))
               for k in (1, 2, 3, 4))
    if active is None:
        active = np.ones((len(steps), n), bool)
    xs += (jnp.asarray(active),)
    vstep = jax.vmap(j_step, in_axes=(0, 0, 0, 0, None, 0))

    def body(carry, x):
        gs, bank = carry
        *x, live = x
        pos, conc, act, t = x
        new, a, over = vstep(gs, pos, conc, act.astype(jnp.int32), bank, t)
        kept = jax.tree.map(lambda u, v: jnp.where(
            live.reshape((-1,) + (1,) * (u.ndim - 1)), u, v), new, gs)
        return (kept, bank), (new, a, over)

    gs0 = jax.tree.map(lambda x: jnp.broadcast_to(x, (n,) + x.shape), j_init)
    _, (states, acts, overs) = jax.jit(
        lambda c, x: jax.lax.scan(body, c, x))((gs0, jbank), xs)
    alive = np.ones(n, bool)
    for t, (_, _, _, _, _, (gout, a_t, o_t)) in enumerate(steps):
        live = active[t]
        differ = ((np.asarray(acts[t]) != a_t.numpy())
                  | (np.asarray(overs[t]) != o_t.numpy()))
        for f in dataclasses.fields(gout):
            x = np.asarray(getattr(states, f.name)[t])
            if x.dtype.kind in "biu":
                differ |= (x != getattr(gout, f.name).numpy()).reshape(
                    n, -1).any(-1)
        differ &= alive & live
        if differ.any():
            tie = score_tie(gout.score.numpy(),
                            np.asarray(states.score[t]), margin)
            assert tie[differ].all(), (t, np.flatnonzero(differ))
            print(f"step {t}: episodes {np.flatnonzero(differ)} part at a "
                  f"score tie")
            alive &= ~differ
        rows = alive & live
        for name in ("score", "est"):
            np.testing.assert_allclose(
                getattr(gout, name).numpy()[rows],
                np.asarray(getattr(states, name)[t])[rows], rtol=RTOL,
                atol=ATOL, err_msg=(t, name))
    return ~alive


# One case per option (the defaults first); "3d:" runs on the 3-D bank.
OPTIONS = {
    "defaults": {},
    "margin": dict(margin=1.5),
    "margin_deadline": dict(margin=1.5, margin_until=40),
    "guard_top": dict(guard_top=2),
    "entry_dive": dict(entry_dive=True),
    "dive_bias": dict(dive_bias=True),
    "sticky_target": dict(sticky_target=True, margin=1.2),
    "search_off": dict(search_after=None),
    "rim_guard_off": dict(rim_guard=False),
    "time:defaults": {},
    "3d:defaults": {},
    "3d:options": dict(guard_top=1, sticky_target=True, dive_bias=True,
                       margin=1.5, margin_until=40),
    "3d:entry_dive": dict(entry_dive=True, check_every=2),
    "duplicate_rows": dict(guard_top=2, margin=1.5, margin_until=60),
}
FLIGHT = dict(search_after=20, rim_expire=90)


@pytest.mark.parametrize("case", sorted(OPTIONS))
def test_bank_guide_steps_teacher_forced_match_jax(case):
    """32 flights x 120 steps over each bank, the port's guide in the loop,
    replayed through JAX's step.  The search starts after 20 contact-free
    steps and the rim guard fails open at 90, so a flight meets both."""
    kind = case.split(":")[0] if ":" in case else "static"
    jbank, tbank = banks(kind, duplicate=case == "duplicate_rows")
    jcfg, tcfg = configs(three_d=kind == "3d")
    k = int(jbank.conc.shape[0])
    kw = {**GEOMETRY, **FLIGHT, **OPTIONS[case]}
    j_init, j_step = jbg.make_bank_guide(jcfg, k, **kw)
    t_init, t_step = tbg.make_bank_guide(tcfg, k, **kw)
    assert t_step.needs_bank
    steps = bank_flight(t_step, t_init, tcfg, tbank, 32, 120, seed=5)
    dropped = replay(steps, j_step, j_init, jbank, kw.get("margin", 1.0))
    assert dropped.sum() <= 1
    last = steps[-1][-1][0]
    # most flights read the plume; the gate was shut on some steps and
    # open on others, and while shut the guide moved other than the policy
    assert (last.n_contact > 0).sum() >= 24
    opened = np.stack([s[-1][2].numpy() for s in steps])
    policy = np.stack([s[3].numpy() for s in steps])
    moved = np.stack([s[-1][1].numpy() for s in steps])
    assert opened.any() and (~opened).any()
    assert ((moved != policy) & ~opened).any()
    if kind == "3d":
        assert np.isin([5, 6], policy).all()
    if case == "duplicate_rows":
        # rows that tie exactly, the lower one ranked first
        ties = [(s[-1][0].score[:, :3] == s[-1][0].score[:, 3:]).all(-1)
                for s in steps]
        assert np.stack(ties).any()


def test_bank_guided_eval_matches_jax():
    """``evaluate_policy`` over a [4, 64, 64] bank with the bank guide,
    32 episodes x 120 steps, given JAX's draws: steps, success, the
    matched row, the gate and the contacts equal."""
    conc, src, _, _ = gauss_bank("static", seed=3)
    conc, src = conc[:4], src[:4]
    jbank = JFieldBank(conc=jnp.asarray(conc), source=jnp.asarray(src))
    tbank = field_bank_from_numpy(conc, src)
    jcfg, tcfg = configs()
    from tpu_plume.core.config import EvalConfig as JEvalConfig
    from tpu_plume_torch.core.config import EvalConfig as TEvalConfig

    jev, tev = JEvalConfig(success_distance=18.0), TEvalConfig(
        success_distance=18.0)
    jmodel, params, tmodel = models(jcfg)
    key = jax.random.PRNGKey(4)
    kw = dict(GEOMETRY, search_after=30, margin=1.5, margin_until=60)
    jm = jh.evaluate_policy(params, jmodel.apply, jcfg, jev, key,
                            num_episodes=32, max_steps=120, bank=jbank,
                            guide=jbg.make_bank_guide(jcfg, 4, **kw))
    tm = th.evaluate_policy(
        tmodel, tcfg, tev, draws=jax_draws(key, tcfg, 32, 120, bank_rows=4),
        num_episodes=32, max_steps=120, bank=tbank, device="cpu",
        guide=tbg.make_bank_guide(tcfg, 4, **kw))
    for name in ("steps", "success", "guide_match", "guide_fit_ok",
                 "field_idx", "guide_contacts", "guide_samples",
                 "guide_hover"):
        got, want = getattr(tm, name), np.asarray(getattr(jm, name))
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    np.testing.assert_allclose(tm.deviations, np.asarray(jm.deviations),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(tm.guide_est, np.asarray(jm.guide_est),
                               rtol=RTOL, atol=ATOL)
    assert 0 < tm.guide_fit_ok.sum() < 32 and tm.success.any()

