"""The port's ``flux`` and ``plot`` commands against JAX's, on the CPU.

- The parsers of ``flux`` and ``plot`` against JAX's: the same options
  and defaults.
- ``flux --cpu`` through both CLIs on the same argv, the port given the
  draws JAX's study consumes (``draw_eval`` monkeypatched to
  ``flux_draws``): the same JSON keys, and at the true source positions
  the same summary (counts and shares equal, errors within rtol 1e-4, on
  the anisotropic plume 1e-3: its kernels agree to rtol 1e-4 and the
  normal equations amplify that),
  for the random and raster surveys and the MLP policy of a reference
  ``.pth``; both CLIs hand their studies the same arguments (the raster
  bands widened under ``--refine-steps`` by the same rule).
- The refusals: ``--arch lstm`` (the survey policy is the MLP) and
  ``--plume-model gridded`` (no kernel to invert), each with a message.
- ``_episode_field`` of a ``training_data.nc`` written by the port's
  ``cli train --cpu --netcdf`` equals JAX's; ``plot --what field`` and
  ``--what curves`` on that run's files write PNGs over 10 kB and print
  ``{"saved": path}``; ``training_dashboard`` too.
"""

import contextlib
import importlib
import io
import json
import os

import jax
import numpy as np
import pytest
import torch

from test_torch_eval import models
from test_torch_flux import flux_draws
from tpu_plume.cli.main import build_parser as j_build_parser
from tpu_plume.cli.main import main as j_cli_main
from tpu_plume.data.torch_export import export_actor_critic_pth
from tpu_plume_torch.core.config import get_preset as t_get_preset
from tpu_plume_torch.evaluation import harnesses as th

tcli = importlib.import_module("tpu_plume_torch.cli.main")
torch.set_num_threads(1)

FLUX = ["flux", "--cpu", "--episodes", "8", "--steps", "150"]


def run(main, argv):
    """``main(argv)``'s last printed line as JSON."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(argv)
    return json.loads(out.getvalue().strip().splitlines()[-1])


def parser_options(build, cmd) -> set:
    sub = next(a for a in build()._actions if a.dest == "cmd")
    return {s for a in sub.choices[cmd]._actions for s in a.option_strings}


@pytest.mark.parametrize("cmd, only_jax", [("flux", set()),
                                           ("plot", set())])
def test_flux_and_plot_are_declared_as_in_jax(cmd, only_jax):
    got = parser_options(tcli.build_parser, cmd)
    want = parser_options(j_build_parser, cmd)
    assert want - got == only_jax and not got - want
    argv = [cmd]
    jargs = j_build_parser().parse_args(argv)
    for key, value in vars(tcli.build_parser().parse_args(argv)).items():
        if key != "fn":
            assert value == getattr(jargs, key), key


def with_jax_draws(monkeypatch, seed=0):
    """The port's study draws what JAX's CLI study draws for ``--seed``."""
    monkeypatch.setattr(
        th, "draw_eval", lambda generator, cfg, length, n, greedy=True:
        flux_draws(jax.random.PRNGKey(seed), cfg, n, length))


def same_summaries(got, want, rtol=1e-4):
    assert got.keys() == want.keys()
    for key, value in want.items():
        if isinstance(value, float) and "error" in key:
            np.testing.assert_allclose(got[key], value, rtol=rtol,
                                       err_msg=key)
        else:
            assert got[key] == value, key


@pytest.mark.parametrize("flags", [[], ["--survey", "raster", "--seed", "3"],
                                   ["--sources", "2", "--preset", "wrf_les"]])
def test_cli_flux_matches_jax(flags, monkeypatch):
    argv = FLUX + flags
    seed = 3 if "--seed" in flags else 0
    with_jax_draws(monkeypatch, seed)
    same_summaries(run(tcli.main, argv), run(j_cli_main, argv),
                   rtol=1e-3 if "wrf_les" in flags else 1e-4)


def test_cli_flux_policy_of_a_pth_matches_jax(tmp_path, monkeypatch):
    cfg = t_get_preset("ppo_v2_0")
    _, params, _ = models(cfg.env, key=4)
    pth = str(tmp_path / "policy.pth")
    export_actor_critic_pth(params, pth)
    argv = FLUX + ["--pth", pth]
    with_jax_draws(monkeypatch)
    same_summaries(run(tcli.main, argv), run(j_cli_main, argv))
    est = run(tcli.main, argv + ["--estimated"])
    assert est.keys() == run(j_cli_main, argv + ["--estimated"]).keys()
    assert est["estimated_positions"] is True


@pytest.mark.parametrize("flags", [
    ["--survey", "raster", "--refine-steps", "60", "--estimated"],
    ["--survey", "raster", "--refine-steps", "120", "--steps", "400"],
    ["--refine-steps", "30", "--plume-model", "anisotropic"],
])
def test_cli_flux_gives_the_study_jax_arguments(flags, monkeypatch):
    """Both CLIs' studies replaced by recorders: the same env, episodes,
    steps, estimated flag, refine steps and raster band scale."""
    import tpu_plume.evaluation as jev
    import tpu_plume.evaluation.oracle as jor
    from tpu_plume_torch.evaluation import flux as tflux
    from tpu_plume_torch.evaluation import oracle as tor

    seen = {}

    def recorder(side, make):
        def fn(*a, **kw):
            seen.setdefault(side, {}).update(kw)
            return make(*a, **kw)
        return fn

    def study(side):
        def fn(cfg, key, **kw):
            seen.setdefault(side, {}).update(
                kw, env=(cfg.num_sources, cfg.plume_model))
            return {"ok": 1}
        return fn

    monkeypatch.setattr(jor, "make_oracle",
                        recorder("jax", jor.make_oracle))
    monkeypatch.setattr(tor, "make_oracle", recorder("port", tor.make_oracle))
    monkeypatch.setattr(jev, "flux_inversion_study", study("jax"))
    monkeypatch.setattr(tflux, "flux_inversion_study", study("port"))
    argv = ["flux", "--cpu"] + flags
    run(j_cli_main, argv)
    run(tcli.main, argv)
    jax_kw, port_kw = seen["jax"], seen["port"]
    for key in ("num_episodes", "num_steps", "estimated_positions",
                "refine_steps", "env"):
        assert port_kw[key] == jax_kw[key], key
    assert port_kw.get("raster_band_scale") == jax_kw.get("raster_band_scale")
    assert ("raster_band_scale" in port_kw) == ("raster" in flags)


def test_cli_flux_refuses_what_its_survey_cannot_fly(tmp_path, capsys):
    with pytest.raises(SystemExit) as exc:
        tcli.main(["flux", "--cpu", "--arch", "lstm", "--ckpt",
                   str(tmp_path)])
    assert "the survey policy is the MLP" in str(exc.value)
    with pytest.raises(SystemExit) as exc:
        tcli.main(["flux", "--cpu", "--plume-model", "gridded"])
    assert 'plume_model="gridded"' in str(exc.value)


@pytest.fixture(scope="module")
def train_run(tmp_path_factory):
    """A tiny ``cli train --cpu --netcdf`` run of the port."""
    out = tmp_path_factory.mktemp("plot") / "run"
    run(tcli.main, [
        "train", "--cpu", "--preset", "ppo_v2_1", "--envs", "32", "--unroll",
        "64", "--minibatch", "256", "--iterations", "4", "--episodes", "20",
        "--netcdf", "--out", str(out)])
    return out


def test_episode_field_matches_jax(train_run):
    from tpu_plume.viz.plots import _episode_field as j_episode_field
    from tpu_plume_torch.data.netcdf import read_nc
    from tpu_plume_torch.viz.plots import _episode_field

    data = read_nc(str(train_run / "training_data.nc"))
    grid = int(data["__attrs__"].get("GRID_SIZE", 500))
    written = np.flatnonzero(~np.isnan(data["source_x"]))
    assert len(written)
    for ep in written[:3]:
        got, src = _episode_field(data, int(ep), grid)
        want, want_src = j_episode_field(data, int(ep), grid)
        np.testing.assert_array_equal(got, want)
        assert src == want_src


@pytest.mark.parametrize("what", ["field", "curves"])
def test_cli_plot_writes_a_png(what, train_run, tmp_path):
    out = str(tmp_path / f"{what}.png")
    src = (["--nc", str(train_run / "training_data.nc")] if what == "field"
           else ["--csv", str(train_run / "training_results.csv")])
    printed = run(tcli.main, ["plot", "--what", what, *src, "--out", out])
    assert printed == {"saved": out}
    assert os.path.getsize(out) > 10_000
    if what == "field":
        jout = str(tmp_path / "jax.png")
        assert run(j_cli_main, ["plot", "--what", what, *src, "--out",
                                jout]) == {"saved": jout}


def test_training_dashboard_writes_a_png(tmp_path):
    from tpu_plume_torch.viz import training_dashboard

    rng = np.random.default_rng(0)
    path = str(tmp_path / "dash.png")
    assert training_dashboard(
        rng.random(300) * 50, rng.random((100, 100)).astype(np.float32),
        np.cumsum(rng.normal(size=(50, 2)), axis=0) + 50, (60, 60), 25.0,
        save_path=path) == path
    assert os.path.getsize(path) > 10_000
