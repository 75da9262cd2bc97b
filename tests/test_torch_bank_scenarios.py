"""JAX's ten bank-guide scenarios (``tests/test_bank_guide.py``) on the
port's ``evaluation/bank_guide.py``, each with JAX's asserts.

- The two end-to-end evals (``identifies_and_dives`` on a bank of 16
  wide isotropic rows, ``on_anisotropic_ridges`` on JAX's synthesized
  ridge bank) run the port's ``evaluate_policy`` with JAX's raster
  surveyor, from the draws JAX's ``evaluate_policy`` makes from its key
  (``jax_draws``) and over JAX's arrays, so that they are JAX's episodes.
- The other eight step one episode (N = 1) by hand: the non-gridded
  refusal (JAX's message), the margin gate and its deadline, the rim
  guard and its fail-open, background steps, the contact gate,
  ``guard_top`` and the entry-dive rule.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_plume.core.config import EnvConfig as JEnvConfig
from tpu_plume.evaluation import bank_guide as jbg
from tpu_plume.fields.gridded import synthesize_bank
from tpu_plume_torch.convert import field_bank_from_numpy
from tpu_plume_torch.core.config import EnvConfig as TEnvConfig
from tpu_plume_torch.core.config import EvalConfig as TEvalConfig
from tpu_plume_torch.evaluation import bank_guide as tbg
from tpu_plume_torch.evaluation import harnesses as th
from tpu_plume_torch.stop.controllers import broadcast

from test_torch_eval import jax_draws

torch.set_num_threads(1)


class Raster(torch.nn.Module):
    """JAX's boustrophedon surveyor (``_raster_apply``): sweep east, step
    south a line, sweep west."""

    def __init__(self, cfg):
        super().__init__()
        self.g, self.num_actions = cfg.grid_size, cfg.num_actions

    def forward(self, obs):
        g = self.g
        x, y = obs[..., 0] * g, obs[..., 1] * g
        going_right = torch.remainder(torch.floor(y / 30.0), 2) == 0
        turn = torch.where(going_right, x >= g - 30.0, x <= 30.0)
        action = torch.where(turn, 1, torch.where(going_right, 3, 4))
        logits = torch.nn.functional.one_hot(action, self.num_actions) * 50.0
        return logits.float(), torch.zeros(obs.shape[:-1])


def scenario_cfg(**kw):
    return TEnvConfig(plume_model="gridded", plume_sigma=500 / 16, **kw)


def gauss_np(cfg, src, sig=None, peak=None):
    """JAX's scenario plume: a [500, 500] Gaussian at ``src``."""
    g = cfg.grid_size
    ix = np.arange(g, dtype=np.float32)[:, None]
    iy = np.arange(g, dtype=np.float32)[None, :]
    sig = cfg.plume_sigma if sig is None else sig
    peak = cfg.conc_peak if peak is None else peak
    d2 = (ix - src[0]) ** 2 + (iy - src[1]) ** 2
    return (peak * np.exp(-d2 / (2.0 * sig * sig))).astype(np.float32)


def one_episode(init, step):
    """The guide's state for one episode and its step on scalars."""
    def run(gs, pos, conc, act, bank, t):
        return step(gs, torch.tensor([pos], dtype=torch.float32),
                    torch.tensor([conc], dtype=torch.float32),
                    torch.tensor([act]), bank,
                    torch.tensor([t], dtype=torch.int32))
    return broadcast(init, 1, "cpu"), run


def scenario_eval(cfg, bank_np, episodes, guide=None):
    """The raster surveyor's eval over ``bank_np`` (conc, source) from the
    draws JAX's ``evaluate_policy`` makes from PRNGKey(1)."""
    conc, src = bank_np
    ev = TEvalConfig(episodes=episodes, success_distance=40.0)
    length = min(cfg.max_steps, ev.max_eval_steps)
    return th.evaluate_policy(
        Raster(cfg), cfg, ev, draws=jax_draws(
            jax.random.PRNGKey(1), cfg, episodes, length,
            bank_rows=conc.shape[0]),
        bank=field_bank_from_numpy(conc, src), device="cpu", guide=guide)


def test_bank_guide_requires_gridded():
    with pytest.raises(ValueError) as want:
        jbg.make_bank_guide(JEnvConfig(), 4)
    with pytest.raises(ValueError) as got:
        tbg.make_bank_guide(TEnvConfig(), 4)
    assert str(got.value) == str(want.value)


def test_bank_guide_identifies_and_dives():
    """K = 16 wide isotropic rows (JAX's ``_isotropic_bank`` sources): the
    gate opens on at least 24 of 64 episodes, at least 80% of them on the
    true row, and the guided success clears the surveyor's by 0.15."""
    cfg = scenario_cfg(max_steps=800)
    lo, hi = cfg.source_padding, cfg.grid_size - cfg.source_padding
    src = np.asarray(jax.random.uniform(jax.random.PRNGKey(0), (16, 2),
                                        jnp.float32, lo, hi))
    bank = (np.stack([gauss_np(cfg, s) for s in src]), src)
    mg = scenario_eval(cfg, bank, 64, guide=tbg.make_bank_guide(cfg, 16))
    mp = scenario_eval(cfg, bank, 64)
    gated = mg.guide_fit_ok
    assert gated.sum() >= 24, int(gated.sum())
    correct = (mg.guide_match == mg.field_idx)[gated]
    assert correct.mean() >= 0.8, float(correct.mean())
    assert mg.success.mean() > mp.success.mean() + 0.15, (
        float(mg.success.mean()), float(mp.success.mean()))


def test_bank_guide_on_anisotropic_ridges():
    """JAX's synthesized thin-ridge bank (K = 16) at the conservative
    cadence: every gated episode's row right in at least 80%, and at
    least 70% of the gated dives succeed."""
    from tpu_plume.fields.gridded import synthesize_bank

    cfg = scenario_cfg(max_steps=800)
    jcfg = JEnvConfig(plume_model="gridded", max_steps=800,
                      plume_sigma=500 / 16)
    jb = synthesize_bank(jax.random.PRNGKey(0), jcfg, num_fields=16)
    mg = scenario_eval(cfg, (np.asarray(jb.conc), np.asarray(jb.source)), 96,
                       guide=tbg.make_bank_guide(
                           cfg, 16, min_contact=4, check_every=2,
                           search_after=None, rim_guard=False))
    gated = mg.guide_fit_ok
    assert gated.sum() >= 10, int(gated.sum())
    correct = (mg.guide_match == mg.field_idx)[gated]
    assert correct.mean() >= 0.8, float(correct.mean())
    assert mg.success[gated].mean() >= 0.7, float(mg.success[gated].mean())


def walk_row_a(cfg, bank, **kw):
    """12 strong reads walking east through row 0's plume core (at 250,
    250); returns whether the gate opened."""
    plume = gauss_np(cfg, (250.0, 250.0))
    gs, step = one_episode(*tbg.make_bank_guide(cfg, 2, min_contact=2,
                                                check_every=1, **kw))
    for i in range(12):
        pos = (240.0 + i * 2.0, 250.0)
        gs, _, _ = step(gs, pos, float(plume[int(pos[0]), int(pos[1])]), 3,
                        bank, i)
    return bool(gs.est_ok[0])


def two_row_bank(cfg, duplicate):
    a, b = (250.0, 250.0), (100.0, 400.0)
    conc = np.stack([gauss_np(cfg, a), gauss_np(cfg, a if duplicate else b)])
    return field_bank_from_numpy(conc, np.array([a, b], np.float32))


def test_bank_guide_margin_gate_blocks_ambiguity():
    """Duplicate rows never commit under a margin of 2; a separable bank
    does; without the margin the identity gate commits on the tie."""
    cfg = scenario_cfg()
    ambiguous, separable = (two_row_bank(cfg, d) for d in (True, False))
    assert not walk_row_a(cfg, ambiguous, margin=2.0)
    assert walk_row_a(cfg, separable, margin=2.0)
    assert walk_row_a(cfg, ambiguous, margin=1.0)


def test_bank_guide_margin_deadline_fallback():
    """The margin expires at ``margin_until``: blocked with it always on
    or still ahead, committed once the walk passes it."""
    cfg = scenario_cfg()
    ambiguous = two_row_bank(cfg, True)
    assert not walk_row_a(cfg, ambiguous, margin=2.0, margin_until=0)
    assert not walk_row_a(cfg, ambiguous, margin=2.0, margin_until=100)
    assert walk_row_a(cfg, ambiguous, margin=2.0, margin_until=6)


def one_ball_bank():
    return field_bank_from_numpy(np.zeros((1, 500, 500), np.float32),
                                 np.array([[250.0, 250.0]], np.float32))


def landing_distance(cfg, pos, action):
    m = cfg.move_step
    deltas = np.array([[0, 0], [0, m], [0, -m], [m, 0], [-m, 0]], np.float32)
    return float(np.linalg.norm(np.asarray(pos) + deltas[action]
                                - np.array([250.0, 250.0])))


def test_bank_guide_rim_guard_deflects_then_fails_open():
    """A westward step into the unidentified ball's terminate radius is
    deflected to a landing outside it; after ``rim_expire`` steps the
    policy's action passes."""
    cfg = scenario_cfg()
    bank = one_ball_bank()
    gs, step = one_episode(*tbg.make_bank_guide(cfg, 1, rim_guard=True,
                                                rim_expire=64))
    pos = (310.0, 250.0)
    gs, action, on = step(gs, pos, 0.0, 4, bank, 0)
    assert not bool(on[0]) and int(action[0]) != 4
    assert landing_distance(cfg, pos, int(action[0])) > 50.0
    for _ in range(70):
        gs, action, on = step(gs, pos, 0.0, 4, bank, 0)
    assert int(action[0]) == 4


def test_bank_guide_background_steps_do_not_accumulate():
    """Weak reads over an all-background bank leave the score at 0."""
    cfg = scenario_cfg()
    bank = field_bank_from_numpy(
        np.zeros((2, 500, 500), np.float32),
        np.array([[100.0, 100.0], [400.0, 400.0]], np.float32))
    gs, step = one_episode(*tbg.make_bank_guide(cfg, 2))
    for i in range(16):
        gs, _, _ = step(gs, (250.0, 250.0), 0.3, 3, bank, i)
    assert float(gs.score.abs().max()) == 0.0


def test_bank_guide_gate_needs_contact():
    """No contact in the far corner of JAX's synthesized K = 4 bank: the
    gate stays shut and the policy's action passes."""
    cfg = scenario_cfg()
    jb = synthesize_bank(jax.random.PRNGKey(0), JEnvConfig(
        plume_model="gridded", plume_sigma=500 / 16), num_fields=4)
    bank = field_bank_from_numpy(np.asarray(jb.conc), np.asarray(jb.source))
    gs, step = one_episode(*tbg.make_bank_guide(cfg, 4))
    for i in range(32):
        gs, action, _ = step(gs, (5.0, 5.0), 0.0, 3, bank, i)
    assert not bool(gs.est_ok[0])
    assert int(action[0]) == 3


def test_bank_guide_guard_top_restricts_to_scored_candidates():
    """``guard_top=1``: no guard before contact; after a read in row 0's
    core only row 0's ball deflects, and a decoy's ball does not."""
    cfg = scenario_cfg()
    srcs = np.array([[250.0, 250.0], [100.0, 400.0], [400.0, 100.0],
                     [130.0, 250.0]], np.float32)
    conc = np.stack([gauss_np(cfg, s, sig=60.0, peak=1.0) for s in srcs])
    bank = field_bank_from_numpy(conc, srcs)
    gs, step = one_episode(*tbg.make_bank_guide(
        cfg, 4, rim_guard=True, rim_expire=1000, guard_top=1,
        min_contact=99))
    pos = (310.0, 250.0)
    gs, action, _ = step(gs, pos, 0.0, 4, bank, 0)
    assert int(action[0]) == 4
    read = float(conc[0, 310, 250]) * cfg.conc_peak + 0.5
    gs, _, _ = step(gs, pos, read, 0, bank, 0)
    assert int(gs.n_contact[0]) >= 1 and int(gs.match[0]) == 0
    gs, action, _ = step(gs, pos, 0.0, 4, bank, 0)
    assert int(action[0]) != 4
    gs, action, _ = step(gs, (190.0, 250.0), 0.0, 4, bank, 0)
    assert int(action[0]) == 4


def test_bank_guide_entry_dive_rule():
    """``entry_dive``: a deep entry passes, a shallow chord is replaced
    (never failing open) by a landing deep or outside, a hover in the
    (50, 55] shell becomes the deep entry, and a ball the drone is inside
    is dead."""
    cfg = scenario_cfg()
    bank = one_ball_bank()
    init, fn = tbg.make_bank_guide(cfg, 1, rim_guard=True, rim_expire=64,
                                   entry_dive=True)
    gs, step = one_episode(init, fn)
    gs, action, on = step(gs, (310.0, 250.0), 0.0, 4, bank, 0)
    assert not bool(on[0]) and int(action[0]) == 4
    gs, _ = one_episode(init, fn)
    for _ in range(70):
        gs, action, _ = step(gs, (320.0, 250.0), 0.0, 4, bank, 0)
        assert int(action[0]) != 4
        d = landing_distance(cfg, (320.0, 250.0), int(action[0]))
        assert d <= 35.0 or d > 50.0
    gs, _ = one_episode(init, fn)
    gs, action, _ = step(gs, (302.0, 250.0), 0.0, 0, bank, 0)
    assert int(action[0]) == 4
    gs, _ = one_episode(init, fn)
    gs, action, _ = step(gs, (260.0, 250.0), 0.0, 4, bank, 0)
    assert int(action[0]) == 4
