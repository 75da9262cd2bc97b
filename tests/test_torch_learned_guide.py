"""The learned terminal guide and the post-hoc localizer of the port
(``evaluation/learned_guide.py``, ``evaluation/localize.py``) against the
JAX package's, on the CPU.

- JAX's six learned-guide tests (``tests/test_learned_guide.py``)
  replayed on the port with their asserts (a stand-in localizer where
  JAX's has one).
- The step teacher-forced with a localizer of JAX's init converted by
  ``convert.lstm_zoo_from_flax``, in the ``xyc`` and ``xycd`` layouts at
  window 16: the port's guide flies ppo_v2_0 episodes in closed loop, and
  JAX's vmapped step is run over the same inputs
  (``test_torch_guidance.teacher_forced``).  Actions, gates, counts equal;
  the window rtol 1e-5 / atol 1e-4, the estimate atol 1e-3 px.  A gate
  may decide the other way only where the estimate's move lies within
  1e-4 relative of ``stable_tol``, at most one episode per flight, each
  logged.
- ``derive_learned_guide_config`` equal; ``localizer_meta.npz`` from JAX's
  and the port's ``train_source_lstm`` read alike.
- ``localize_from_trajectories`` against JAX's on NaN-padded flights with
  an all-NaN episode, atol 1e-3 px.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_plume.evaluation import learned_guide as jlg
from tpu_plume.evaluation.localize import (
    localize_from_trajectories as j_localize,
)
from tpu_plume.models.lstm_zoo import GaussianParamPredictor as JLocalizer
from tpu_plume_torch.convert import lstm_zoo_from_flax
from tpu_plume_torch.core.config import EnvConfig, EvalConfig
from tpu_plume_torch.evaluation import harnesses as th
from tpu_plume_torch.evaluation import learned_guide as tlg
from tpu_plume_torch.evaluation.guidance import norm2
from tpu_plume_torch.evaluation.localize import localize_from_trajectories
from tpu_plume_torch.models.lstm_zoo import GaussianParamPredictor

from test_torch_eval import _configs
from test_torch_guidance import SMALL, scripted_flight, teacher_forced

torch.set_num_threads(1)

EST_ATOL = 1e-3
GATE_MARGIN = 1e-4


class Fixed(torch.nn.Module):
    """A stand-in localizer: every window predicts ``est_norm`` (JAX's
    ``_fixed_model``), or, with ``drift``, an estimate that moves by
    ``drift`` (normalized) at every call."""

    def __init__(self, est_norm=(0.5, 0.5), drift=0.0):
        super().__init__()
        self.est = torch.tensor([*est_norm, 0.1, 0.8])
        self.drift, self.calls = drift, 0

    def forward(self, x, lengths=None):
        self.calls += 1
        out = self.est.expand(x.shape[0], 4).clone()
        if self.drift:
            out[:, :2] = 0.2 + self.drift * self.calls
        return out


def one_step(step, gs, pos, conc, act=0):
    return step(gs, torch.tensor([pos], dtype=torch.float32),
                torch.tensor([conc], dtype=torch.float32),
                torch.tensor([act]))


def test_window_fills_chronologically_then_shifts():
    cfg = EnvConfig()
    gs, step = tlg.make_learned_guide(cfg, Fixed(), window=4, min_window=2)
    gs = th.ctrl.broadcast(gs, 1, "cpu")
    for i in range(6):
        gs, _, _ = one_step(step, gs, [float(i), 100.0 + i], 10.0 + i)
    np.testing.assert_allclose(gs.window[0, :, 0].numpy() * cfg.grid_size,
                               [2.0, 3.0, 4.0, 5.0], atol=1e-4)
    assert int(gs.count[0]) == 6


def test_stability_gate_opens_and_overrides():
    cfg = EnvConfig()
    est = (250.0, 250.0)
    gs, step = tlg.make_learned_guide(
        cfg, Fixed((est[0] / 500, est[1] / 500)), window=8, min_window=4,
        check_every=4, stable_tol=6.0)
    gs = th.ctrl.broadcast(gs, 1, "cpu")
    actions, overrides = [], []
    for _ in range(12):
        gs, a, ov = one_step(step, gs, [250.0, 150.0], 5.0)
        actions.append(int(a))
        overrides.append(bool(ov))
    assert not overrides[0]
    assert overrides[-1]
    assert actions[-1] != 0
    assert bool(gs.est_ok[0]) and int(gs.mode[0]) == 1
    np.testing.assert_allclose(gs.est[0].numpy(), est, atol=1e-3)


def test_unstable_estimates_defer_to_policy():
    cfg = EnvConfig()
    gs, step = tlg.make_learned_guide(
        cfg, Fixed(drift=0.04), window=8, min_window=4, check_every=4,
        stable_tol=6.0)
    gs = th.ctrl.broadcast(gs, 1, "cpu")
    for _ in range(16):
        gs, a, ov = one_step(step, gs, [250.0, 150.0], 5.0)
        assert not bool(ov)
        assert int(a) == 0


@pytest.mark.parametrize("err", [2.0, 10.0, 19.0, 31.0, 90.0])
@pytest.mark.parametrize("window", [16, 32, 64])
def test_derive_gate_matches_jax(err, window):
    assert (tlg.derive_learned_guide_config(err, window=window)
            == jlg.derive_learned_guide_config(err, window=window))
    # JAX's operating points
    d = tlg.derive_learned_guide_config
    assert d(10.0)["stable_tol"] == 6.0
    assert abs(d(19.0)["stable_tol"] - 11.4) < 1e-6
    assert d(2.0)["stable_tol"] == 4.0 and d(90.0)["stable_tol"] == 32.0
    assert d(10.0, window=32) == {"stable_tol": 6.0, "check_every": 2,
                                  "min_window": 8}


def flights(k=48, t=40, seed=3):
    """NaN-padded (x, y, conc) flights toward random sources (JAX's
    ``test_localize`` generator) and their sources; episode 0 is all NaN
    and episode 1 a single step."""
    rng = np.random.default_rng(seed)
    trajs = np.full((k, t, 3), np.nan, np.float32)
    srcs = rng.uniform(100, 400, (k, 2)).astype(np.float32)
    for i in range(1, k):
        pos = rng.uniform(50, 450, 2)
        for j in range(1 if i == 1 else int(rng.integers(5, t))):
            d = np.linalg.norm(pos - srcs[i])
            trajs[i, j] = [pos[0], pos[1], 100.0 * np.exp(
                -d ** 2 / (2 * 31.25 ** 2)) + rng.normal(0, 1.5)]
            pos = pos + 25.0 * (srcs[i] - pos) / (d + 1e-6) + rng.normal(
                0, 4, 2)
    return trajs, srcs


def test_localizer_meta_from_either_writer(tmp_path):
    """``train_source_lstm`` of both packages on the same flights: each
    ``localizer_meta.npz`` holds the same keys and is found from the run
    dir and from the checkpoint in it; none where there is none."""
    from tpu_plume.train.lstm_trainer import train_source_lstm as j_train
    from tpu_plume_torch.train.lstm_trainer import (
        train_source_lstm as t_train,
    )

    trajs, srcs = flights()
    fp = str(tmp_path / "flights.npz")
    np.savez_compressed(fp, trajectories=trajs, sources=srcs)
    j_train(None, str(tmp_path / "jax"), flights_path=fp, window=16,
            epochs=1, hidden=8)
    t_train(None, str(tmp_path / "port"), flights_path=fp, window=16,
            epochs=1, hidden=8, device="cpu")
    want = jlg.load_localizer_meta(str(tmp_path / "jax"))
    for probe in (str(tmp_path / "port"),
                  str(tmp_path / "port" / "gaussian_params.pt"),
                  str(tmp_path / "jax" / "gaussian_params")):
        got = tlg.load_localizer_meta(probe)
        assert got.keys() == want.keys()
        assert got["window"] == 16 and got["hidden"] == 8
        assert jlg.load_localizer_meta(probe).keys() == want.keys()
    assert tlg.load_localizer_meta(str(tmp_path / "nowhere")) is None


def jax_localizer(features, hidden=16, seed=0):
    """JAX's localizer params at its init, and the port's model holding
    them."""
    dim = 6 if features == "xycd" else 3
    jmodel = JLocalizer(hidden_size=hidden)
    params = jmodel.init(jax.random.PRNGKey(seed), jnp.zeros((1, 8, dim)),
                         jnp.ones((1,), jnp.int32))
    params = jax.tree.map(np.asarray, params)
    tmodel = GaussianParamPredictor(hidden_size=hidden, input_size=dim)
    tmodel.load_state_dict(lstm_zoo_from_flax(tmodel, params))
    return jmodel, jax.tree.map(jnp.asarray, params), tmodel.eval()


@pytest.mark.parametrize("features", ["xyc", "xycd"])
def test_learned_guide_steps_teacher_forced_match_jax(features):
    """24 flights x 80 steps of ppo_v2_0's physics on a 250-cell domain,
    window 16, a check every 2 steps from step 4, stable to 3 px."""
    jcfg, tcfg = _configs("ppo_v2_0", SMALL)
    jmodel, params, tmodel = jax_localizer(features)
    kw = dict(window=16, min_window=4, check_every=2, stable_tol=3.0,
              features=features)
    j_init, j_step = jlg.make_learned_guide(jcfg.env, params, jmodel,
                                            hidden=16, **kw)
    t_init, t_step = tlg.make_learned_guide(tcfg.env, tmodel, **kw)
    with torch.no_grad():
        steps = scripted_flight(t_step, t_init, tcfg.env, 24, 80, seed=11)

    def margin(gin, gout, pos, conc):
        # the stability gate: the estimate's move against stable_tol
        move = norm2(gout.est - gin.est_prev)
        return (torch.abs(move - 3.0) / 3.0).numpy()

    dropped = teacher_forced(
        steps, jax.vmap(lambda gs, p, c, a, s: j_step(gs, p, c, a)),
        j_init, dict(rtol=1e-5, atol=1e-4), dict(rtol=1e-5, atol=EST_ATOL),
        margin, est_fields=("est", "est_prev"), fit_fields=())
    assert dropped.sum() <= 1
    opened = np.stack([s[-1][2].numpy() for s in steps])
    assert opened.any() and (~opened).any()


def test_localize_matches_jax():
    """32 flights of up to 40 steps at window 16, with an all-NaN episode
    (zeros at length 1) and a one-step one."""
    jmodel, params, tmodel = jax_localizer("xyc", hidden=32, seed=2)
    trajs, srcs = flights(k=32)
    want = j_localize(trajs, params, window=16)
    got = localize_from_trajectories(trajs, tmodel, window=16)
    assert got.shape == (32, 2) and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=0, atol=EST_ATOL)
    assert np.isfinite(got).all()


def test_learned_guided_eval_end_to_end_anisotropic(tmp_path):
    """JAX's full loop on the anisotropic plume with the port: an east
    sweep surveyor's flights train the port's localizer, which then guides
    an eval whose gate opens in more than a fifth of the episodes."""
    from tpu_plume_torch.evaluation.guidance import make_guide
    from tpu_plume_torch.train.lstm_trainer import train_source_lstm

    cfg = EnvConfig(max_steps=400, plume_model="anisotropic")
    with pytest.raises(ValueError):
        make_guide(EnvConfig(plume_model="gridded"))

    class Sweep(torch.nn.Module):
        def forward(self, obs):
            t = obs[:, 4] * cfg.max_steps
            row = torch.div(t, 20, rounding_mode="floor").to(torch.int64) % 2
            act = torch.where(row == 0, 3, 1)
            return (torch.nn.functional.one_hot(act, 5).float() * 50.0,
                    torch.zeros(obs.shape[0]))

    ev = EvalConfig(episodes=32, success_distance=40.0)
    m0 = th.evaluate_policy(Sweep(), cfg, ev,
                            torch.Generator().manual_seed(0),
                            track_trajectories=32, device="cpu")
    fp = str(tmp_path / "flights.npz")
    np.savez_compressed(fp, trajectories=m0.trajectories, sources=m0.sources)
    res = train_source_lstm(None, str(tmp_path / "loc"), flights_path=fp,
                            window=32, epochs=60, lr=3e-3, seed=0,
                            device="cpu")
    meta = tlg.load_localizer_meta(str(tmp_path / "loc"))
    assert meta is not None and meta["window"] == 32
    assert meta["val_median_err_px"] == res.extra["val_median_err_px"]
    model = GaussianParamPredictor(hidden_size=32, input_size=3)
    model.load_state_dict(res.state_dict)
    guide = tlg.make_learned_guide(cfg, model.eval(), window=32,
                                   min_window=12, check_every=4,
                                   stable_tol=25.0)
    mg = th.evaluate_policy(Sweep(), cfg, ev,
                            torch.Generator().manual_seed(1), guide=guide,
                            device="cpu")
    assert mg.guide_fit_ok.mean() > 0.2
    assert os.path.isfile(tmp_path / "loc" / "gaussian_params.pt")
