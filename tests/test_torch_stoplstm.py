"""The stop-LSTM family of the port against the JAX package's, on the CPU.

- The seven zoo models' forwards on params converted from flax, with and
  without ``lengths``, and with 2-D inputs promoted: rtol 1e-5, atol 1e-6.
  The converter round-trips; the init draws flax's distributions.
- ``.pth`` interop: JAX's ``export_*_pth`` files load into the port's
  models, and the port's state_dict files into JAX's ``import_*_pth``.
- The losses, the plateau scheduler and the minibatch shuffles equal JAX's;
  k steps of the optimizer leave params within atol 1e-6 x k of optax's.
- The trainers, started from JAX's init (put in through a monkeypatched
  model constructor), give JAX's epoch losses within rtol 1e-4 over 3
  epochs, with the same learning-rate schedule and best epoch; the
  threshold trainer with its dropout off, its dropout held by its rate and
  scale.
- The CLI: ``train-lstm`` of all four variants against JAX's (the same
  init, the threshold net's dropout off), and ``eval --stop threshold`` /
  ``--stop peakstop`` with a JAX-exported ``.pth`` against JAX's
  ``evaluate_policy`` with the same gate, given JAX's draws: steps, stop
  flags and success equal, deviations at the eval tolerance of
  ``tests/test_torch_eval.py`` (rtol 1e-5, atol 1e-4).
"""

import contextlib
import functools
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_eval import jax_draws, models
from tpu_plume.cli.main import main as j_cli_main
from tpu_plume.core.config import get_preset as j_get_preset
from tpu_plume.data import netcdf as jnc
from tpu_plume.data import torch_export as jx
from tpu_plume.data.scaler import MinMaxScaler as JScaler
from tpu_plume.evaluation import harnesses as jh
from tpu_plume.models import lstm_zoo as jz
from tpu_plume.train import lstm_trainer as jt
from tpu_plume_torch.cli.main import main as cli_main
from tpu_plume_torch.convert import lstm_zoo_from_flax, lstm_zoo_to_flax
from tpu_plume_torch.core.config import get_preset as t_get_preset
from tpu_plume_torch.evaluation import harnesses as th
from tpu_plume_torch.models import lstm_zoo as tz
from tpu_plume_torch.train import lstm_trainer as tt

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6
TRAIN_RTOL = 1e-4
B, T = 4, 9
# model: (input shape without the batch, constructor kwargs)
ZOO = {
    "LSTMModel": ((T,), {}),
    "ConcentrationThresholdPredictor": ((T,), {}),
    "ConcentrationPredictor": ((T, 6), {}),
    "GaussianLSTM": ((T,), {}),
    "GaussianParamPredictor": ((T, 6), {}),
    "GaussianParamAndStopPredictor": ((T,), {}),
    "PeakAndStopPredictor": ((T,), {}),
}
LENGTHS = np.array([T, 3, 1, 6], np.int32)


def _params(jmodel, x, seed=0):
    """flax params of ``jmodel`` with every leaf shifted by seeded noise
    (nonzero biases)."""
    p = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(seed), x))
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: (a + 0.1 * rng.standard_normal(a.shape)).astype(np.float32),
        p)


def _outputs(out):
    return [np.asarray(o) for o in (out if isinstance(out, tuple) else (out,))]


CASES = [(name, lengths) for name in ZOO for lengths in (False, True)] + [
    ("ConcentrationPredictor", "2d"), ("GaussianParamPredictor", "2d")]


@pytest.mark.parametrize("name,lengths", CASES)
def test_zoo_forward_matches_jax(name, lengths):
    shape, kw = ZOO[name]
    if lengths == "2d":
        shape = shape[1:]
    x = np.random.default_rng(1).standard_normal((B,) + shape).astype(np.float32)
    jmodel, tmodel = getattr(jz, name)(**kw), getattr(tz, name)(**kw)
    params = _params(jmodel, jnp.asarray(x))
    tmodel.load_state_dict(lstm_zoo_from_flax(tmodel, params))
    tmodel.eval()
    ln = LENGTHS if lengths is True else None
    want = jmodel.apply(params, jnp.asarray(x),
                        None if ln is None else jnp.asarray(ln))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(x),
                     None if ln is None else torch.from_numpy(ln))
    want, got = _outputs(want), _outputs(got)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", sorted(ZOO))
def test_converter_round_trips(name):
    shape, kw = ZOO[name]
    jmodel, tmodel = getattr(jz, name)(**kw), getattr(tz, name)(**kw)
    params = _params(jmodel, jnp.zeros((1,) + shape), seed=2)
    sd = lstm_zoo_from_flax(tmodel, params)
    assert sd.keys() == tmodel.state_dict().keys()
    back = lstm_zoo_to_flax(tmodel, sd)
    assert (jax.tree_util.tree_structure(back)
            == jax.tree_util.tree_structure(params))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", sorted(ZOO))
def test_init_draws_flax_distributions(name):
    _, kw = ZOO[name]
    model = getattr(tz, name)(**kw).reset_parameters(
        torch.Generator().manual_seed(3))
    again = getattr(tz, name)(**kw).reset_parameters(
        torch.Generator().manual_seed(3))
    for (k, v), w in zip(model.state_dict().items(),
                         again.state_dict().values()):
        assert torch.equal(v, w), k
    lstm = model.lstm
    h = lstm.hidden_size
    for k in range(lstm.num_layers):
        assert not getattr(lstm, f"bias_ih_l{k}").requires_grad
        for name_ in ("bias_ih", "bias_hh"):
            assert not getattr(lstm, f"{name_}_l{k}").any()
        w_ih = getattr(lstm, f"weight_ih_l{k}").detach()
        std = (1.0 / w_ih.shape[1]) ** 0.5
        assert w_ih.abs().max() <= 2.0 * std / 0.87962566103423978 + 1e-6
        w_hh = getattr(lstm, f"weight_hh_l{k}").detach()
        for g in range(4):
            block = w_hh[g * h:(g + 1) * h]
            torch.testing.assert_close(block @ block.T, torch.eye(h),
                                       atol=1e-5, rtol=0)
    for m in model.modules():
        if isinstance(m, torch.nn.Linear):
            bound = (6.0 / sum(m.weight.shape)) ** 0.5
            assert m.weight.abs().max() <= bound and not m.bias.any()
        if isinstance(m, torch.nn.LayerNorm):
            assert (m.weight == 1).all() and not m.bias.any()


@pytest.mark.parametrize("kind", ["threshold", "peak_stop"])
def test_pth_interop_both_ways(tmp_path, kind):
    name = ("ConcentrationThresholdPredictor" if kind == "threshold"
            else "PeakAndStopPredictor")
    jmodel, tmodel = getattr(jz, name)(), getattr(tz, name)()
    x = np.random.default_rng(4).uniform(0, 1, (B, 20)).astype(np.float32)
    params = _params(jmodel, jnp.asarray(x), seed=4)
    path = str(tmp_path / "jax.pth")
    getattr(jx, f"export_{kind}_lstm_pth" if kind == "threshold"
            else "export_peak_stop_pth")(params, path)
    tmodel.load_state_dict(torch.load(path, weights_only=True))
    tmodel.eval()
    with torch.no_grad():
        got = _outputs(tmodel(torch.from_numpy(x)))
    for g, w in zip(got, _outputs(jmodel.apply(params, jnp.asarray(x)))):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)
    # a reference state_dict with both biases nonzero, from the port
    sd = tmodel.state_dict()
    sd["lstm.bias_ih_l0"] = sd["lstm.bias_ih_l0"] + 0.25
    sd["lstm.bias_hh_l0"] = sd["lstm.bias_hh_l0"] - 0.5
    tmodel.load_state_dict(sd)
    torch.save(tmodel.state_dict(), tmp_path / "port.pth")
    back = getattr(jx, f"import_{kind}_lstm_pth" if kind == "threshold"
                   else "import_peak_stop_pth")(str(tmp_path / "port.pth"))
    with torch.no_grad():
        got = _outputs(tmodel(torch.from_numpy(x)))
    for g, w in zip(got, _outputs(jmodel.apply(back, jnp.asarray(x)))):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)


def test_losses_match_jax():
    rng = np.random.default_rng(5)
    pred = rng.normal(0, 3, 64).astype(np.float32)
    target = rng.normal(0, 3, 64).astype(np.float32)
    prob = rng.uniform(0, 1, 64).astype(np.float32)
    prob[:3] = (0.0, 1.0, 1e-9)
    label = (rng.uniform(0, 1, 64) > 0.5).astype(np.float32)
    for beta in (0.5, 2.0):
        np.testing.assert_allclose(
            float(tt.smooth_l1(torch.from_numpy(pred), torch.from_numpy(target),
                               beta)),
            float(jt.smooth_l1(jnp.asarray(pred), jnp.asarray(target), beta)),
            rtol=1e-6)
    np.testing.assert_allclose(
        float(tt.bce(torch.from_numpy(prob), torch.from_numpy(label))),
        float(jt.bce(jnp.asarray(prob), jnp.asarray(label))), rtol=1e-6)


def test_plateau_scheduler_and_shuffles_match_jax():
    losses = [5, 4, 4, 4.5, 4, 4, 4, 4, 4, 3.9, 4, 4, 4, 4, 4, 4, 4, 4, 4]
    got, want = tt.ReduceLROnPlateau(1e-3), jt.ReduceLROnPlateau(1e-3)
    assert [got.step(v) for v in losses] == [want.step(v) for v in losses]
    assert want.lr < 1e-3
    for n, b in ((100, 16), (64, 64), (7, 3)):
        np.testing.assert_array_equal(
            tt._shuffle_batches(np.random.default_rng(n), n, b),
            jt._shuffle_batches(np.random.default_rng(n), n, b))
    with pytest.raises(ValueError, match="smaller than batch"):
        tt._shuffle_batches(np.random.default_rng(0), 3, 4)


@pytest.mark.parametrize("wd,clip", [(0.0, 1.0), (1e-2, 1.0), (1e-4, 1e3)])
def test_optimizer_matches_optax(wd, clip):
    k = 6
    name = "PeakAndStopPredictor"
    jmodel, tmodel = getattr(jz, name)(), getattr(tz, name)()
    params = _params(jmodel, jnp.zeros((1, 20)), seed=6)
    tmodel.load_state_dict(lstm_zoo_from_flax(tmodel, params))
    opt = tt.ClippedAdamW(tmodel.parameters(), weight_decay=wd, clip=clip)
    jopt = jt._make_optimizer(weight_decay=wd, clip=clip)
    state = jopt.init(params)
    rng = np.random.default_rng(6)

    @jax.jit
    def grad_fn(p, x, y):
        def loss_fn(p):
            peak, stop = jmodel.apply(p, x)
            return ((peak - y[:, 0]) ** 2).mean() + jt.bce(stop, y[:, 1])
        return jax.grad(loss_fn)(p)

    for i in range(k):
        x = rng.uniform(0, 1, (8, 20)).astype(np.float32)
        y = rng.uniform(0, 1, (8, 2)).astype(np.float32)
        grads = grad_fn(params, x, y)
        updates, state = jopt.update(grads, state, params, 1e-2)
        params = jax.tree.map(lambda p, u: p + u, params, updates)
        opt.zero_grad()
        peak, stop = tmodel(torch.from_numpy(x))
        yt = torch.from_numpy(y)
        (((peak - yt[:, 0]) ** 2).mean() + tt.bce(stop, yt[:, 1])).backward()
        opt.step(1e-2)
    want = lstm_zoo_from_flax(tmodel, params)
    for key, v in tmodel.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[key].numpy(), rtol=0,
                                   atol=1e-6 * k, err_msg=key)


def test_dropout_keeps_its_rate_and_scale():
    x = torch.full((400, 500), 2.0)
    y = tz.dropout(x, 0.3, torch.Generator().manual_seed(0))
    kept = y != 0
    assert abs(kept.float().mean().item() - 0.7) < 0.005
    torch.testing.assert_close(y[kept], torch.full_like(y[kept], 2.0 / 0.7))
    again = tz.dropout(x, 0.3, torch.Generator().manual_seed(0))
    assert torch.equal(y, again)
    assert tz.dropout(x, 0.0, None) is x


def test_threshold_net_layers_one_by_one_as_the_stacked_lstm():
    """The training forward with dropout runs the layers one by one; with
    both rates 0 it is the stacked LSTM's forward, and with the rates on
    it draws its masks from the generator passed in."""
    x = torch.from_numpy(np.random.default_rng(7).uniform(0, 1, (B, 10))
                         .astype(np.float32))
    model = tz.ConcentrationThresholdPredictor().reset_parameters(
        torch.Generator().manual_seed(7))
    model.eval()
    want = model(x, torch.from_numpy(LENGTHS))
    model.train()
    model.dropout = model.head_dropout = 1e-12
    got = model(x, torch.from_numpy(LENGTHS), torch.Generator())
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-7)
    model.dropout, model.head_dropout = 0.3, 0.1
    a = model(x, generator=torch.Generator().manual_seed(1))
    b = model(x, generator=torch.Generator().manual_seed(1))
    c = model(x, generator=torch.Generator().manual_seed(2))
    assert torch.equal(a, b) and not torch.equal(a, c)


# ---------------------------------------------------------------------------
# Trainers from JAX's init
# ---------------------------------------------------------------------------

MAX_STEPS = 90


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """A JAX-written V2.1 trajectory file of 30 seeded episodes whose
    concentration rises toward the source, its conc CSV, and an ``eval
    --save-flights`` npz."""
    d = tmp_path_factory.mktemp("lstm_data")
    rng = np.random.default_rng(8)
    seqs, srcs, trajs = [], [], np.full((12, MAX_STEPS, 3), np.nan, np.float32)
    with jnc.NetCDFWriter(str(d / "training_data.nc"), grid_size=500,
                          max_episodes=40, max_steps=MAX_STEPS,
                          with_gaussian_params=True) as w:
        for i in range(30):
            steps = int(rng.integers(25, MAX_STEPS))
            src = rng.uniform(100, 400, 2)
            start = rng.uniform(0, 500, 2)
            f = np.linspace(0, 1, steps)[:, None]
            pos = (start + (src - start) * f
                   + rng.normal(0, 3, (steps, 2))).astype(np.float32)
            conc = (100 * np.exp(-((pos - src) ** 2).sum(1) / (2 * 60.0**2))
                    + rng.uniform(0, 2, steps)).astype(np.float32)
            w.write_episode_data(i, steps, pos[:, 0], pos[:, 1], conc,
                                 float(src[0]), float(src[1]),
                                 float(conc[-1]), 15.0, 100.0)
            seqs.append(conc)
            srcs.append(conc[-1])
            if i < 12:
                trajs[i, :steps] = np.column_stack([pos, conc])
    from tpu_plume.data.conc_csv import save_conc_rows

    save_conc_rows(str(d / "data.csv"), seqs, srcs)
    np.savez(d / "flights.npz", trajectories=trajs,
             sources=rng.uniform(100, 400, (12, 2)).astype(np.float32))
    return d


def jax_init(monkeypatch, name, jmodel, x, seed, **kw):
    """The port's trainer builds ``name`` with JAX's init from
    ``PRNGKey(seed)`` over an input like ``x``."""
    make = getattr(tz, name)

    def build(*a, **k):
        model = make(*a, **{**k, **kw})
        sd = lstm_zoo_from_flax(model, jax.tree.map(
            np.asarray, jmodel.init(jax.random.PRNGKey(seed), *x)))

        def reset_parameters(generator=None):
            model.load_state_dict(sd)
            return model
        model.reset_parameters = reset_parameters
        return model

    monkeypatch.setattr(tt, name, build)


def no_dropout(monkeypatch):
    """Both packages' threshold nets with their dropout off."""
    monkeypatch.setattr(jt, "ConcentrationThresholdPredictor", functools.partial(
        jz.ConcentrationThresholdPredictor, dropout=0.0, head_dropout=0.0))
    jax_init(monkeypatch, "ConcentrationThresholdPredictor",
             jz.ConcentrationThresholdPredictor(), (jnp.zeros((1, 10)),), 0,
             dropout=0.0, head_dropout=0.0)


def assert_same_training(got, want, schedule_lr):
    np.testing.assert_allclose(got.losses, want.losses, rtol=TRAIN_RTOL)
    jsched, tsched = (jt.ReduceLROnPlateau(schedule_lr),
                      jt.ReduceLROnPlateau(schedule_lr))
    assert ([tsched.step(v) for v in got.losses]
            == [jsched.step(v) for v in want.losses])
    assert np.argmin(got.losses) == np.argmin(want.losses)
    for key in want.extra:
        if isinstance(want.extra[key], float):
            np.testing.assert_allclose(got.extra[key], want.extra[key],
                                       rtol=TRAIN_RTOL, atol=1e-5, err_msg=key)


def test_peak_stop_trainer_matches_jax(data, tmp_path, monkeypatch):
    segs = jax_load_segments(data)
    jax_init(monkeypatch, "PeakAndStopPredictor", jz.PeakAndStopPredictor(),
             (jnp.zeros((1, 20)),), 0)
    kw = dict(epochs=3, batch_size=16)
    want = jt.train_peak_stop_lstm(segs, str(tmp_path / "j"), **kw)
    got = tt.train_peak_stop_lstm(segs, str(tmp_path / "t"), device="cpu", **kw)
    assert_same_training(got, want, 1e-3)
    sd = jx.import_peak_stop_pth(str(tmp_path / "t" / "model" /
                                     "best_peak_and_stop.pth"))
    assert sd["params"].keys() == want.params["params"].keys()
    assert (torch.load(tmp_path / "t" / "best_peak_and_stop.pt").keys()
            == got.state_dict.keys())


def jax_load_segments(data):
    from tpu_plume.data.datasets import load_trajectory_segments

    return load_trajectory_segments(str(data / "training_data.nc"),
                                    window_size=20)


def test_sequence_trainer_matches_jax(data, tmp_path, monkeypatch):
    from tpu_plume.data.conc_csv import load_conc_rows

    seqs, src = load_conc_rows(str(data / "data.csv"))
    jax_init(monkeypatch, "LSTMModel", jz.LSTMModel(),
             (jnp.zeros((1, 5)), jnp.ones(1, jnp.int32)), 42)
    kw = dict(epochs=3, batch_size=8)
    want = jt.train_sequence_lstm(seqs, src, str(tmp_path / "j"), **kw)
    got = tt.train_sequence_lstm(seqs, src, str(tmp_path / "t"), device="cpu",
                                 **kw)
    assert_same_training(got, want, 1e-3)
    assert (tmp_path / "t" / "scaler_params_v12.npy").exists()


@pytest.mark.parametrize("source", ["nc", "nc_arrays", "flights", "flights_xycd"])
def test_source_trainer_matches_jax(data, tmp_path, monkeypatch, source):
    features = "xycd" if source == "flights_xycd" else "xyc"
    dim = 6 if features == "xycd" else 3
    jax_init(monkeypatch, "GaussianParamPredictor",
             jz.GaussianParamPredictor(hidden_size=16),
             (jnp.zeros((1, 32, dim)), jnp.ones((1,), jnp.int32)), 0)
    nc = str(data / "training_data.nc")
    flights = str(data / "flights.npz") if "flights" in source else None
    kw = dict(flights_path=flights, window=32, epochs=3, batch_size=32,
              hidden=16, features=features, per_episode=3)
    want = jt.train_source_lstm(nc, str(tmp_path / "j"), **kw)
    port_nc = jnc.read_nc(nc) if source == "nc_arrays" else nc
    got = tt.train_source_lstm(port_nc, str(tmp_path / "t"), device="cpu",
                               **kw)
    assert_same_training(got, want, 1e-3)
    jm = np.load(tmp_path / "j" / "localizer_meta.npz")
    tm = np.load(tmp_path / "t" / "localizer_meta.npz")
    assert jm.files == tm.files
    for key in ("window", "grid_size", "conc_peak", "features", "hidden"):
        assert tm[key] == jm[key], key


def test_threshold_trainer_matches_jax_without_dropout(data, tmp_path,
                                                       monkeypatch):
    from tpu_plume.data.datasets import load_raw_sequences

    seqs, src = load_raw_sequences(str(data / "training_data.nc"))
    no_dropout(monkeypatch)
    kw = dict(epochs=3, batch_size=8)
    want = jt.train_threshold_lstm(seqs, src, str(tmp_path / "j"), **kw)
    got = tt.train_threshold_lstm(seqs, src, str(tmp_path / "t"), device="cpu",
                                  **kw)
    assert_same_training(got, want, 3e-4)
    np.testing.assert_allclose(got.extra["r2"], want.extra["r2"], rtol=1e-4)
    for name in ("scaler_params.npy", "model/lstm_threshold_predictor.pth",
                 "lstm_threshold_predictor.pt"):
        assert (tmp_path / "t" / name).exists(), name
    assert (JScaler.load(str(tmp_path / "t" / "scaler_params.npy")).data_min_
            == want.extra["scaler"].data_min_)
    back = jx.import_threshold_lstm_pth(
        str(tmp_path / "t" / "model" / "lstm_threshold_predictor.pth"))
    assert back["params"].keys() == want.params["params"].keys()


def test_threshold_trainer_dropout_draws_from_its_seed(data, tmp_path):
    from tpu_plume.data.datasets import load_raw_sequences

    seqs, src = load_raw_sequences(str(data / "training_data.nc"))
    runs = [tt.train_threshold_lstm(seqs, src, str(tmp_path / str(i)),
                                    epochs=2, batch_size=8, seed=s,
                                    device="cpu")
            for i, s in enumerate((0, 0, 1))]
    assert runs[0].losses == runs[1].losses != runs[2].losses


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------


def _json(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(argv)
    return json.loads(out.getvalue().strip().splitlines()[-1])


@pytest.mark.parametrize("variant", ["threshold", "peakstop", "v12", "params"])
def test_cli_train_lstm_matches_jax(data, tmp_path, monkeypatch, variant):
    nc = str(data / ("data.csv" if variant == "v12" else "training_data.nc"))
    if variant == "threshold":
        no_dropout(monkeypatch)
    elif variant == "peakstop":
        jax_init(monkeypatch, "PeakAndStopPredictor",
                 jz.PeakAndStopPredictor(), (jnp.zeros((1, 20)),), 0)
    elif variant == "v12":
        jax_init(monkeypatch, "LSTMModel", jz.LSTMModel(),
                 (jnp.zeros((1, 5)), jnp.ones(1, jnp.int32)), 42)
    else:
        jax_init(monkeypatch, "GaussianParamPredictor",
                 jz.GaussianParamPredictor(), (jnp.zeros((1, 32, 3)),
                                               jnp.ones((1,), jnp.int32)), 0)
    flags = ["train-lstm", "--variant", variant, "--nc", nc, "--epochs", "2",
             "--window", "32"]
    want = _json(j_cli_main, flags + ["--out", str(tmp_path / "j")])
    got = _json(cli_main, flags + ["--cpu", "--out", str(tmp_path / "t")])
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=TRAIN_RTOL, atol=1e-5,
                                   err_msg=k)


def test_cli_train_lstm_needs_its_data():
    for flags, match in ((["--variant", "threshold"], "needs --nc"),
                         (["--variant", "params"], "needs --nc or --flights")):
        with pytest.raises(SystemExit, match=match):
            cli_main(["train-lstm", "--cpu", *flags])


EPISODES = 32
# Stop nets whose gates stop some of the episodes, at various steps: the
# threshold net predicts about 5 (threshold 4.75); the peak-stop net's
# stop probability rises over 0.8 once the window holds enough
# concentrations over 3.
THRESHOLD_BIAS = 5.0
PEAK_GAIN, PEAK_LEVEL = 50.0, 0.03


def _stop_nets():
    tp = jax.tree.map(np.array, jz.ConcentrationThresholdPredictor().init(
        jax.random.PRNGKey(5), jnp.zeros((1, 10))))
    tp["params"]["Dense_1"]["bias"][:] = THRESHOLD_BIAS
    pp = jax.tree.map(lambda a: np.zeros_like(np.array(a)),
                      jz.PeakAndStopPredictor().init(jax.random.PRNGKey(6),
                                                     jnp.zeros((1, 20))))
    cell = pp["params"]["OptimizedLSTMCell_0"]
    for g in "ifo":
        cell["h" + g]["bias"][:] = 10.0
    cell["ig"]["kernel"][0, 0] = PEAK_GAIN
    cell["hg"]["bias"][0] = -PEAK_GAIN * PEAK_LEVEL
    pp["params"]["fc_stop"]["kernel"][0, 0] = 4.0
    pp["params"]["fc_stop"]["bias"][:] = -1.0
    return tp, pp


def _jax_gate(kind, params, scaler, cfg):
    """JAX's ``_lstm_gate`` over the given params."""
    if kind == "threshold":
        model = jz.ConcentrationThresholdPredictor()
        lo, scale = jnp.float32(scaler.data_min_), jnp.float32(scaler._scale)

        def predict(window):
            return model.apply(params, ((window - lo) * scale)[None, :])[0]

        return jh.make_threshold_gate(predict, cfg.stop)
    model = jz.PeakAndStopPredictor()

    def predict(window_norm):
        peak, stop = model.apply(params, window_norm[None, :])
        return peak[0], stop[0]

    return jh.make_peak_stop_gate(predict, cfg.stop)


@pytest.mark.parametrize("kind", ["threshold", "peakstop"])
def test_cli_eval_lstm_gate_matches_jax(tmp_path, monkeypatch, kind):
    jcfg, tcfg = j_get_preset("ppo_v2_0"), t_get_preset("ppo_v2_0")
    jmodel, policy, _ = models(jcfg.env)
    pth = str(tmp_path / "policy.pth")
    jx.export_actor_critic_pth(jax.tree.map(np.asarray, policy), pth)
    tp, pp = _stop_nets()
    model_dir = tmp_path / "lstm" / "model"
    model_dir.mkdir(parents=True)
    if kind == "threshold":
        ckpt = str(model_dir / "lstm_threshold_predictor.pth")
        jx.export_threshold_lstm_pth(tp, ckpt)
        np.save(model_dir / "scaler_params.npy", np.array([0.0, 100.0]))
        params = jx.import_threshold_lstm_pth(ckpt)
    else:
        ckpt = str(model_dir / "best_peak_and_stop.pth")
        jx.export_peak_stop_pth(pp, ckpt)
        params = jx.import_peak_stop_pth(ckpt)
    scaler = JScaler.load(str(model_dir / "scaler_params.npy")) if kind == "threshold" else None
    key = jax.random.PRNGKey(3)
    jm = jh.evaluate_policy(policy, jmodel.apply, jcfg.env, jcfg.eval, key,
                            num_episodes=EPISODES,
                            stop_gate=_jax_gate(kind, params, scaler, jcfg))
    draws = jax_draws(key, tcfg.env, EPISODES, tcfg.env.max_steps)
    monkeypatch.setattr(th, "draw_eval", lambda *a, **k: draws)
    out = tmp_path / "eval"
    summary = _json(cli_main, [
        "eval", "--cpu", "--pth", pth, "--episodes", str(EPISODES), "--seed",
        "3", "--stop", kind, "--lstm-ckpt", ckpt, "--out", str(out)])
    got = np.load(out / "validation_metrics.npz")
    for name in ("steps", "stopped_early", "success"):
        np.testing.assert_array_equal(got[name], np.asarray(getattr(jm, name)),
                                      err_msg=name)
    np.testing.assert_allclose(got["deviations"], np.asarray(jm.deviations),
                               rtol=1e-5, atol=1e-4)
    stopped = int(np.asarray(jm.stopped_early).sum())
    assert 0 < stopped < EPISODES
    assert len(set(np.asarray(jm.steps)[np.asarray(jm.stopped_early)])) > 2
    assert summary["early_stop_rate"] == stopped / EPISODES


def test_cli_eval_runs_the_ports_own_checkpoints(data, tmp_path):
    """``train-lstm`` writes checkpoints that ``eval --lstm-ckpt`` reads."""
    for variant in ("threshold", "peakstop"):
        _json(cli_main, ["train-lstm", "--cpu", "--variant", variant, "--nc",
                         str(data / "training_data.nc"), "--epochs", "1",
                         "--out", str(tmp_path / variant)])
    _, policy, _ = models(j_get_preset("ppo_v2_0").env)
    pth = str(tmp_path / "policy.pth")
    jx.export_actor_critic_pth(jax.tree.map(np.asarray, policy), pth)
    for kind, ckpt in (("threshold", "threshold/lstm_threshold_predictor.pt"),
                       ("peakstop", "peakstop/best_peak_and_stop.pt"),
                       ("peakstop", "peakstop/model/best_peak_and_stop.pth")):
        summary = _json(cli_main, [
            "eval", "--cpu", "--pth", pth, "--episodes", "8", "--stop", kind,
            "--lstm-ckpt", str(tmp_path / ckpt)])
        assert 0.0 <= summary["early_stop_rate"] <= 1.0


@pytest.mark.parametrize("case", ["no_ckpt", "orbax_dir", "no_scaler"])
def test_cli_lstm_ckpt_errors(tmp_path, case):
    _, policy, _ = models(j_get_preset("ppo_v2_0").env)
    pth = str(tmp_path / "policy.pth")
    jx.export_actor_critic_pth(jax.tree.map(np.asarray, policy), pth)
    flags = ["eval", "--cpu", "--pth", pth, "--episodes", "2", "--stop",
             "threshold"]
    if case == "no_ckpt":
        match = "requires --lstm-ckpt"
    elif case == "orbax_dir":
        (tmp_path / "lstm_threshold_predictor").mkdir()
        flags += ["--lstm-ckpt", str(tmp_path / "lstm_threshold_predictor")]
        match = "Orbax"
    else:
        tp, _ = _stop_nets()
        (tmp_path / "lonely").mkdir()
        ckpt = str(tmp_path / "lonely" / "net.pth")
        jx.export_threshold_lstm_pth(tp, ckpt)
        flags += ["--lstm-ckpt", ckpt]
        match = str(tmp_path / "lonely" / "scaler_params.npy")
    with pytest.raises(SystemExit, match=match):
        cli_main(flags)
