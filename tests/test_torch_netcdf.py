"""NetCDF trajectory capture and field-bank files of the port against the
JAX package's, on the CPU (h5py is installed here).

- ``NetCDFWriter``: the file JAX writes and the port's for the same
  seeded episodes are equal variable by variable (values, dtypes, fill
  values, attributes, compression, dimension scales); ``read_nc`` and
  ``describe_nc`` give the same dict and text; ``EpisodeArrays`` holds the
  file's variables in memory.
- The ragged conc CSV and the scaler files read and write across the
  packages; the dataset builders, given the same file and the same
  ``np.random.Generator`` seed, are bit-equal to JAX's.
- ``ingest_netcdf`` reads ``tests/fixtures/external_bank.nc`` as JAX's
  does; ``export_bank_netcdf`` round-trips both ways across the packages.
- The capture of ``train_ppo``: the port's host loop, fed the
  trajectories of a tiny JAX ``train_ppo`` capture run iteration by
  iteration, writes the same ``training_data.nc``, ``data.csv`` and
  ``training_results.csv``.
- The CLI: ``train --netcdf --conc-csv``, ``inspect-nc`` (JAX's text),
  ``--bank file.nc`` on ``train`` / ``eval`` / ``expert`` (the eval against
  JAX's CLI given JAX's draws), and the errors JAX gives for a missing or
  foreign-layout bank file.
"""

import contextlib
import dataclasses
import io
import json
import os
import types

import h5py
import jax
import numpy as np
import pytest
import torch

from test_torch_eval import jax_draws, models
from tpu_plume.cli.main import main as j_cli_main
from tpu_plume.core.config import RolloutConfig as JRolloutCfg
from tpu_plume.core.config import get_preset as j_get_preset
from tpu_plume.data import conc_csv as jcsv
from tpu_plume.data import datasets as jds
from tpu_plume.data import netcdf as jnc
from tpu_plume.data.scaler import MinMaxScaler as JScaler
from tpu_plume.data.torch_export import export_actor_critic_pth
from tpu_plume.fields import gridded as jg
from tpu_plume.train import ppo_trainer as jtrain
from tpu_plume_torch.cli.main import main as cli_main
from tpu_plume_torch.core.config import RolloutConfig
from tpu_plume_torch.core.config import get_preset as t_get_preset
from tpu_plume_torch.data import conc_csv as tcsv
from tpu_plume_torch.data import datasets as tds
from tpu_plume_torch.data import netcdf as tnc
from tpu_plume_torch.data.scaler import MinMaxScaler as TScaler
from tpu_plume_torch.evaluation import harnesses as th
from tpu_plume_torch.fields import gridded as tg
from tpu_plume_torch.train import ppo_trainer as ttrain
from tpu_plume_torch.train.hostsync import drain_window

torch.set_num_threads(1)

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                       "external_bank.nc")
MAX_STEPS, MAX_EPISODES, GRID = 40, 12, 100


def seeded_episodes(seed=0, n=9):
    """``write_episode_data`` keyword arguments of ``n`` seeded episodes,
    two of them full length."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        steps = MAX_STEPS if i in (2, 5) else int(rng.integers(3, MAX_STEPS))
        out.append(dict(
            episode_idx=i, steps=steps,
            x=rng.uniform(0, GRID, steps).astype(np.float32),
            y=rng.uniform(0, GRID, steps).astype(np.float32),
            conc=rng.uniform(0, 100, steps).astype(np.float32),
            source_x=float(rng.uniform(0, GRID)),
            source_y=float(rng.uniform(0, GRID)),
            source_conc=float(rng.uniform(50, 100)),
            sigma=None if i == 3 else float(rng.uniform(5, 20)),
            peak=None if i == 4 else float(rng.uniform(50, 150))))
    return out


def write_nc(mod, path, episodes, gaussian):
    with mod.NetCDFWriter(str(path), grid_size=GRID,
                          max_episodes=MAX_EPISODES, max_steps=MAX_STEPS,
                          with_gaussian_params=gaussian) as w:
        for kw in episodes:
            w.write_episode_data(**kw)


def _attrs(obj) -> dict:
    """An HDF5 object's attributes without the dimension-scale references
    (object references differ between files)."""
    skip = ("DIMENSION_LIST", "REFERENCE_LIST")
    return {k: np.asarray(v) for k, v in obj.attrs.items() if k not in skip}


def assert_same_file(got_path, want_path):
    with h5py.File(got_path, "r") as got, h5py.File(want_path, "r") as want:
        assert list(got) == list(want)
        assert _attrs(got).keys() == _attrs(want).keys()
        for k, v in _attrs(want).items():
            np.testing.assert_array_equal(_attrs(got)[k], v, err_msg=k)
        for name in want:
            g, w = got[name], want[name]
            assert (g.shape, g.dtype, g.compression, g.compression_opts) == (
                w.shape, w.dtype, w.compression, w.compression_opts), name
            assert g.chunks == w.chunks, name
            np.testing.assert_array_equal(np.asarray(g.fillvalue),
                                          np.asarray(w.fillvalue), err_msg=name)
            assert _attrs(g).keys() == _attrs(w).keys(), name
            for k, v in _attrs(w).items():
                np.testing.assert_array_equal(_attrs(g)[k], v, err_msg=k)
            assert g.is_scale == w.is_scale, name
            assert ([[s.name for s in d.values()] for d in g.dims]
                    == [[s.name for s in d.values()] for d in w.dims]), name
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w),
                                          err_msg=name)


@pytest.mark.parametrize("gaussian", [False, True])
def test_writer_writes_jax_file(tmp_path, gaussian):
    eps = seeded_episodes()
    write_nc(jnc, tmp_path / "jax.nc", eps, gaussian)
    write_nc(tnc, tmp_path / "port.nc", eps, gaussian)
    assert_same_file(tmp_path / "port.nc", tmp_path / "jax.nc")


@pytest.mark.parametrize("gaussian", [False, True])
def test_read_nc_and_describe_nc_match_jax(tmp_path, gaussian):
    write_nc(jnc, tmp_path / "jax.nc", seeded_episodes(1), gaussian)
    path = str(tmp_path / "jax.nc")
    got, want = tnc.read_nc(path), jnc.read_nc(path)
    assert got.keys() == want.keys()
    for k in want:
        if k == "__attrs__":
            assert got[k].keys() == want[k].keys()
            continue
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert tnc.describe_nc(path) == jnc.describe_nc(path)


@pytest.mark.parametrize("gaussian", [False, True])
def test_episode_arrays_hold_the_file(tmp_path, gaussian):
    eps = seeded_episodes(2)
    write_nc(jnc, tmp_path / "jax.nc", eps, gaussian)
    arrays = tnc.EpisodeArrays(MAX_STEPS, gaussian)
    for kw in eps:
        arrays.write_episode_data(**kw)
    assert len(arrays) == len(eps)
    want = jnc.read_nc(str(tmp_path / "jax.nc"))
    got = arrays.arrays()
    assert set(got) == set(want) - {"__attrs__", "episode", "step"}
    for k, v in got.items():
        assert v.dtype == want[k].dtype, k
        np.testing.assert_array_equal(v, want[k][:len(eps)], err_msg=k)


def test_netcdf_without_h5py_raises_as_jax(tmp_path, monkeypatch):
    import builtins

    real_import = builtins.__import__

    def no_h5py(name, *a, **k):
        if name == "h5py":
            raise ImportError("no h5py")
        return real_import(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_h5py)
    with pytest.raises(RuntimeError, match="h5py is required for NetCDF output"):
        tnc.NetCDFWriter(str(tmp_path / "x.nc"), grid_size=GRID)
    arrays = tnc.EpisodeArrays(MAX_STEPS)
    arrays.write_episode_data(**seeded_episodes(0, 1)[0])
    assert arrays.arrays()["x"].shape == (1, MAX_STEPS)


def _module_level_imports(path) -> set:
    """The root names a file imports outside any function or class."""
    import ast

    roots = set()
    for node in ast.parse(open(path).read()).body:
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            roots.add(node.module.split(".")[0])
    return roots


def test_no_module_of_the_port_imports_h5py_at_module_level():
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    paths = [os.path.join(repo, "chip_smoke.py")]
    for root, _, files in os.walk(os.path.join(repo, "tpu_plume_torch")):
        paths += [os.path.join(root, f) for f in files if f.endswith(".py")]
    assert len(paths) > 30
    for path in paths:
        assert "h5py" not in _module_level_imports(path), path


def test_no_module_of_the_port_imports_matplotlib_or_pandas_at_module_level():
    """The plots import matplotlib (and pandas for the curves) where they
    draw: the card's machine has neither."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    paths = [os.path.join(repo, "chip_smoke.py")]
    for root, _, files in os.walk(os.path.join(repo, "tpu_plume_torch")):
        paths += [os.path.join(root, f) for f in files if f.endswith(".py")]
    assert any(p.endswith(os.path.join("viz", "plots.py")) for p in paths)
    for path in paths:
        assert not {"matplotlib", "pandas"} & _module_level_imports(path), (
            path)


def test_conc_csv_reads_and_writes_across_packages(tmp_path):
    rng = np.random.default_rng(3)
    seqs = [rng.uniform(0, 100, int(rng.integers(1, 30))) for _ in range(7)]
    src = rng.uniform(0, 100, 7)
    jcsv.save_conc_rows(str(tmp_path / "jax.csv"), seqs[:4], src[:4])
    jcsv.save_conc_rows(str(tmp_path / "jax.csv"), seqs[4:], src[4:],
                        append=True)
    tcsv.save_conc_rows(str(tmp_path / "port.csv"), seqs[:4], src[:4])
    tcsv.save_conc_rows(str(tmp_path / "port.csv"), seqs[4:], src[4:],
                        append=True)
    assert (tmp_path / "port.csv").read_bytes() == (tmp_path / "jax.csv").read_bytes()
    got, want = (m.load_conc_rows(str(tmp_path / "jax.csv"))
                 for m in (tcsv, jcsv))
    for g, w in zip(got[0], want[0], strict=True):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("params", [[3.0, 9.0], [4.5]])
def test_scaler_matches_jax(tmp_path, params):
    x = np.random.default_rng(4).uniform(-5, 20, 50)
    path = str(tmp_path / "scaler_params.npy")
    np.save(path, np.array(params))
    for scaler_cls in (TScaler, JScaler):
        assert scaler_cls.load(path).data_min_ == params[0]
    got, want = TScaler.load(path), JScaler.load(path)
    np.testing.assert_array_equal(got.transform(x), want.transform(x))
    np.testing.assert_array_equal(got.inverse_transform(x),
                                  want.inverse_transform(x))
    fit_t, fit_j = TScaler().fit(x), JScaler().fit(x)
    np.testing.assert_array_equal(fit_t.fit_transform(x), fit_j.fit_transform(x))
    fit_t.save(str(tmp_path / "t.npy"))
    assert JScaler.load(str(tmp_path / "t.npy")).data_max_ == fit_j.data_max_


@pytest.fixture(scope="module")
def nc_files(tmp_path_factory):
    """A JAX-written trajectory file of 9 seeded episodes, with and without
    V2.1's variables."""
    d = tmp_path_factory.mktemp("nc")
    eps = seeded_episodes(5)
    for gaussian in (False, True):
        write_nc(jnc, d / f"g{int(gaussian)}.nc", eps, gaussian)
    return d


def _assert_tree_equal(got, want):
    if isinstance(want, dict):
        assert got.keys() == want.keys()
        for k in want:
            _assert_tree_equal(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _assert_tree_equal(g, w)
    else:
        g, w = np.asarray(got), np.asarray(want)
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("gaussian", [False, True])
@pytest.mark.parametrize("loader", [
    "load_raw_sequences", "load_trajectory_segments",
    "load_enhanced_samples", "source_window_dataset"])
def test_loaders_match_jax_from_file_and_arrays(nc_files, loader, gaussian):
    path = str(nc_files / f"g{int(gaussian)}.nc")
    kw = {"load_trajectory_segments": dict(window_size=5),
          "load_enhanced_samples": dict(window_size=6),
          "source_window_dataset": dict(window_size=16, per_episode=4,
                                        grid_size=GRID)}.get(loader, {})

    def call(mod, source):
        if loader == "source_window_dataset":
            kw["rng"] = np.random.default_rng(11)
        fn = getattr(mod, loader)
        if source is not path:     # the port's numpy body
            fn = getattr(mod, {"load_raw_sequences": "raw_sequences",
                               "load_trajectory_segments": "trajectory_segments",
                               "load_enhanced_samples": "enhanced_samples",
                               "source_window_dataset": "source_windows"}[loader])
        return fn(source, **kw)

    want = call(jds, path)
    _assert_tree_equal(call(tds, path), want)
    _assert_tree_equal(call(tds, tnc.read_nc(path)), want)
    if loader == "load_enhanced_samples" and gaussian:
        assert want
    if loader != "load_enhanced_samples" or gaussian:
        assert len(want[0]) if isinstance(want, tuple) else want


@pytest.mark.parametrize("bug_compat", [False, True])
@pytest.mark.parametrize("max_episodes", [1000, 4])
def test_window_builders_match_jax(nc_files, bug_compat, max_episodes):
    path = str(nc_files / "g1.nc")
    segs = jds.load_trajectory_segments(path, window_size=5)
    kw = dict(window_size=5, max_episodes=max_episodes, bug_compat=bug_compat,
              stop_radius=40.0)
    got = tds.peak_stop_dataset(segs, rng=np.random.default_rng(2), **kw)
    want = jds.peak_stop_dataset(segs, rng=np.random.default_rng(2), **kw)
    _assert_tree_equal(got, want)
    assert want[1][:, 1].any() or bug_compat
    seqs, src = jds.load_raw_sequences(path)
    _assert_tree_equal(tds.tail_window_dataset(seqs, src, 10),
                       jds.tail_window_dataset(seqs, src, 10))
    for seg in segs[::7]:
        assert (tds.calculate_dynamic_label(seg)
                == jds.calculate_dynamic_label(seg))


def _bank_equal(got, want):
    """A port ``FieldBank`` and a JAX one hold the same arrays."""
    np.testing.assert_array_equal(got.conc.numpy(), np.asarray(want.conc))
    np.testing.assert_array_equal(got.source.numpy(), np.asarray(want.source))
    assert (got.wind is None) == (want.wind is None)
    if want.wind is not None:
        np.testing.assert_array_equal(got.wind.numpy(), np.asarray(want.wind))
    assert got.steps_per_frame == want.steps_per_frame
    assert got.z_extent == want.z_extent


FIXTURE_VARS = dict(conc_var="ch4", source_x_var="release_x",
                    source_y_var="release_y", wind_u_var="U", wind_v_var="V")


@pytest.mark.parametrize("kw", [
    dict(steps_per_frame=10.0, z_extent=30.0),
    dict(scale_to_peak=100.0),
])
def test_ingest_external_fixture_matches_jax(kw):
    got = tg.ingest_netcdf(FIXTURE, **FIXTURE_VARS, **kw)
    want = jg.ingest_netcdf(FIXTURE, **FIXTURE_VARS, **kw)
    assert got.conc.shape == (1, 3, 4, 24, 24)
    _bank_equal(got, want)


def test_ingest_errors_match_jax(tmp_path):
    for exc, args in ((KeyError, (FIXTURE,)),
                      (FileNotFoundError, (str(tmp_path / "none.nc"),))):
        with pytest.raises(exc) as want:
            jg.ingest_netcdf(*args)
        with pytest.raises(exc) as got:
            tg.ingest_netcdf(*args)
        assert str(got.value) == str(want.value)


def _jax_bank(kind):
    cfg = dataclasses.replace(j_get_preset("wrf_les_3d").env, grid_size=32)
    key = jax.random.PRNGKey(3)
    if kind == "static":
        return jg.synthesize_bank(key, cfg, num_fields=3)
    if kind == "time":
        return jg.synthesize_time_varying_bank(key, cfg, num_fields=2,
                                               num_frames=3)
    return jg.synthesize_3d_bank(key, cfg, num_fields=2, num_frames=2,
                                 num_levels=3)


@pytest.mark.parametrize("kind", ["static", "time", "3d"])
def test_export_bank_round_trips_across_packages(tmp_path, kind):
    jbank = _jax_bank(kind)
    jg.export_bank_netcdf(jbank, str(tmp_path / "jax.nc"))
    tbank = tg.ingest_netcdf(str(tmp_path / "jax.nc"))
    _bank_equal(tbank, jg.ingest_netcdf(str(tmp_path / "jax.nc")))
    tg.export_bank_netcdf(tbank, str(tmp_path / "port.nc"))
    _bank_equal(tbank, jg.ingest_netcdf(str(tmp_path / "port.nc")))
    _bank_equal(tg.ingest_netcdf(str(tmp_path / "port.nc")), jbank)


# ---------------------------------------------------------------------------
# The capture of train_ppo
# ---------------------------------------------------------------------------

CAP_N, CAP_T, CAP_ITERS = 16, 16, 8


def _capture_cfg(cfg, rollout_cls):
    """A tiny run whose episodes reach the goal often (a wide first radius
    that the curriculum then shrinks) and whose capture fills before the
    run ends."""
    return cfg.replace(
        env=dataclasses.replace(cfg.env, max_steps=MAX_STEPS,
                                initial_radius=150.0),
        ppo=dataclasses.replace(cfg.ppo, hidden_sizes=(32, 16),
                                minibatch_size=64, epochs=1),
        curriculum=dataclasses.replace(cfg.curriculum, initial_radius=150.0,
                                       window_size=4),
        rollout=rollout_cls(num_envs=CAP_N, unroll_length=CAP_T),
        total_episodes=150,
    )


def _replay_step(recorded):
    """A ``build_train_step`` whose iterations return JAX's recorded stats
    and trajectories, as port tensors."""
    it = iter(recorded)

    def t(x):
        return torch.from_numpy(np.array(x))

    def build(cfg, bank=None, time_phases=False, guide=None, with_grads=False):
        def step(loop, draws=None, shuffles=None):
            stats, traj = next(it)
            stats = {k: (int(v) if k in ("rollout/episodes",
                                         "rollout/successes") else float(v))
                     for k, v in stats.items()}
            ep = types.SimpleNamespace(**{
                f.name: t(getattr(traj.episode, f.name))
                for f in dataclasses.fields(traj.episode)})
            return loop, stats, types.SimpleNamespace(
                pos=t(traj.pos), conc=t(traj.conc), done=t(traj.done),
                episode=ep)
        return step

    return build


@pytest.mark.parametrize("preset", ["ppo_v2_0", "ppo_v2_1"])
def test_capture_writes_the_episodes_jax_writes(tmp_path, monkeypatch,
                                                preset):
    jcfg = _capture_cfg(j_get_preset(preset), JRolloutCfg)
    tcfg = _capture_cfg(t_get_preset(preset), RolloutConfig)
    recorded = []
    build = jtrain.build_train_step

    def recording_build(*a, **k):
        step = build(*a, **k)

        def wrapped(loop):
            loop, stats, traj = step(loop)
            recorded.append(jax.device_get((stats, traj)))
            return loop, stats, traj
        return wrapped

    monkeypatch.setattr(jtrain, "build_train_step", recording_build)
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    jres = jtrain.train_ppo(jcfg, str(jdir), capture_netcdf=True,
                            capture_conc_csv=True, max_iterations=CAP_ITERS,
                            verbose=False, sync_every=3)
    monkeypatch.setattr(ttrain, "build_train_step", _replay_step(recorded))
    tres = ttrain.train_ppo(tcfg, str(tdir), device="cpu",
                            capture_netcdf=True, capture_conc_csv=True,
                            max_iterations=CAP_ITERS, verbose=False,
                            sync_every=3)
    assert (tres.episodes, tres.successes) == (jres.episodes, jres.successes)
    assert_same_file(tdir / "training_data.nc", jdir / "training_data.nc")
    for name in ("data.csv", "training_results.csv"):
        assert (tdir / name).read_text() == (jdir / name).read_text(), name
    want = jnc.read_nc(str(jdir / "training_data.nc"))
    written = int((~np.isnan(want["source_x"])).sum())
    assert 0 < written <= jcfg.total_episodes
    assert len(tres.trajectories) == written
    for k, v in tres.trajectories.arrays().items():
        np.testing.assert_array_equal(v, want[k][:written], err_msg=k)
    assert len((tdir / "data.csv").read_text().splitlines()) >= written


def test_window_to_host_is_one_transfer_of_every_dtype():
    window = [{"a": torch.arange(6, dtype=torch.int32).reshape(2, 3),
               "b": torch.tensor([True, False]),
               "c": torch.linspace(0, 1, 4)},
              {"a": torch.full((1, 3), 16777216, dtype=torch.int32),
               "b": torch.tensor([False]), "c": torch.ones(2)}]
    host = drain_window(window)
    for got, want in zip(host, window, strict=True):
        for k, v in want.items():
            assert got[k].dtype == v.numpy().dtype, k
            np.testing.assert_array_equal(got[k], v.numpy(), err_msg=k)


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------


def _run(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(argv)
    return out.getvalue()


def test_cli_train_captures_and_inspect_nc_prints_jax_text(tmp_path):
    out = tmp_path / "run"
    printed = _run(cli_main, [
        "train", "--cpu", "--preset", "ppo_v2_1", "--envs", "32", "--unroll",
        "64", "--minibatch", "256", "--iterations", "4", "--episodes", "20",
        "--netcdf", "--conc-csv", "--out", str(out)])
    res = json.loads(printed.strip().splitlines()[-1])
    assert res["episodes"] > 0
    path = str(out / "training_data.nc")
    data = jnc.read_nc(path)
    assert data["x"].shape == (20, 1000)
    written = ~np.isnan(data["source_x"])
    assert written.any() and "gaussian_sigma" in data
    assert (data["is_source"].sum(1) == written).all()
    assert (out / "data.csv").read_text().count("\n") >= written.sum()
    text = _run(cli_main, ["inspect-nc", path])
    assert text == _run(j_cli_main, ["inspect-nc", path])
    assert text.strip().endswith("file check complete.")


@pytest.fixture(scope="module")
def bank_file(tmp_path_factory):
    """A JAX-exported [2, 2, 3, 500, 500] bank at wrf_les_3d's grid."""
    path = str(tmp_path_factory.mktemp("bank") / "bank.nc")
    cfg = j_get_preset("wrf_les_3d").env
    jg.export_bank_netcdf(jg.synthesize_3d_bank(
        jax.random.PRNGKey(1), cfg, num_fields=2, num_frames=2,
        num_levels=3), path)
    return path


def test_cli_eval_bank_file_matches_jax(bank_file, tmp_path, monkeypatch):
    jmodel, params, _ = models(j_get_preset("wrf_les_3d").env)
    pth = str(tmp_path / "policy.pth")
    export_actor_critic_pth(jax.tree.map(np.asarray, params), pth)
    flags = ["eval", "--cpu", "--preset", "wrf_les_3d", "--bank", bank_file,
             "--pth", pth, "--episodes", "16", "--seed", "2"]
    want = json.loads(_run(j_cli_main, flags + ["--out", str(tmp_path / "j")])
                      .strip().splitlines()[-1])
    tcfg = t_get_preset("wrf_les_3d")
    draws = jax_draws(jax.random.PRNGKey(2), tcfg.env, 16,
                      min(tcfg.env.max_steps, tcfg.eval.max_eval_steps),
                      bank_rows=2)
    monkeypatch.setattr(th, "draw_eval", lambda *a, **k: draws)
    got = json.loads(_run(cli_main, flags + ["--out", str(tmp_path / "t")])
                     .strip().splitlines()[-1])
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-4,
                                   err_msg=k)
    for name in ("steps", "stopped_early", "success"):
        np.testing.assert_array_equal(
            np.load(tmp_path / "t" / "validation_metrics.npz")[name],
            np.load(tmp_path / "j" / "validation_metrics.npz")[name])


def test_cli_train_and_expert_run_on_a_bank_file(bank_file, tmp_path):
    out = tmp_path / "run"
    res = json.loads(_run(cli_main, [
        "train", "--cpu", "--preset", "wrf_les_3d", "--bank", bank_file,
        "--envs", "16", "--unroll", "8", "--minibatch", "32", "--iterations",
        "2", "--out", str(out)]).strip().splitlines()[-1])
    assert res["env_steps"] == 256
    path = str(tmp_path / "expert.npz")
    res = json.loads(_run(cli_main, [
        "expert", "--cpu", "--preset", "wrf_les_3d", "--bank", bank_file,
        "--ckpt", str(out), "--episodes", "4", "--out", path])
        .strip().splitlines()[-1])
    assert np.load(path)["states"].shape == (res["samples"], 7)


@pytest.mark.parametrize("cmd", ["train", "eval", "expert"])
def test_cli_bank_file_errors_match_jax(cmd, tmp_path):
    """A file in another layout (the fixture's variable names) raises
    JAX's KeyError; ``train --bank`` on an analytic plume is refused."""
    flags = [cmd, "--cpu", "--preset", "wrf_les_3d", "--bank", FIXTURE]
    if cmd == "train":
        flags += ["--iterations", "1", "--out", str(tmp_path / "run")]
    else:
        _, params, _ = models(j_get_preset("wrf_les_3d").env)
        pth = str(tmp_path / "policy.pth")
        export_actor_critic_pth(jax.tree.map(np.asarray, params), pth)
        flags += ["--pth", pth]
    with pytest.raises(KeyError) as want:
        j_cli_main(flags)
    with pytest.raises(KeyError) as got:
        cli_main(flags)
    assert str(got.value) == str(want.value)
    if cmd == "train":
        with pytest.raises(SystemExit, match="would ignore it"):
            cli_main([cmd, "--cpu", "--bank", FIXTURE] + flags[6:])
