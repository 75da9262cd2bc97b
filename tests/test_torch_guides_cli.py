"""The eval's bank-match guide and the oracles through the port's CLI
against JAX's CLI, and the parsers' remaining differences, on the CPU.

- ``eval --guide bank`` with JAX's defaults and with the other knobs over
  wrf_les's 16-row static bank, ``eval --oracle phase``, ``--oracle
  raster --guide fit`` and ``expert --oracle naive``, with ``--cpu`` at 8
  episodes, each against JAX's CLI on the same argv, the port given the
  draws JAX consumes (``draw_eval`` monkeypatched to ``jax_draws``) and
  JAX's bank (``make_bank`` monkeypatched): the same summaries (with
  ``bank_gate_rate`` and ``bank_match_accuracy``) at the env tolerance,
  the expert samples equal.  No policy file where JAX needs none.
- The parsers of ``eval``, ``expert`` and the imitation commands have
  JAX's options; ``--debug-nans`` runs ``expert``; the distill flags parse
  on ``eval`` and ``expert`` as in JAX.
"""

import argparse
import contextlib
import importlib
import io
import json

import jax
import numpy as np
import pytest
import torch

from test_torch_eval import jax_draws, models
from tpu_plume.cli.main import _make_bank as j_make_bank
from tpu_plume.cli.main import build_parser as j_build_parser
from tpu_plume.cli.main import main as j_cli_main
from tpu_plume.core.config import get_preset as j_get_preset
from tpu_plume.data.torch_export import export_actor_critic_pth
from tpu_plume_torch.convert import field_bank_from_numpy
from tpu_plume_torch.core.config import get_preset as t_get_preset
from tpu_plume_torch.evaluation import harnesses as th

# the CLI module (``tpu_plume_torch.cli.main`` the attribute is its main)
tcli = importlib.import_module("tpu_plume_torch.cli.main")
torch.set_num_threads(1)

EPISODES = 8
BANK = ["--preset", "wrf_les", "--plume-model", "gridded", "--synth-bank",
        "static", "--bank-fields", "16"]


def run(main, argv):
    """``main(argv)``'s printed lines; the last parsed as JSON."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(argv)
    lines = out.getvalue().strip().splitlines()
    return json.loads(lines[-1]), lines[:-1]


def same_summaries(got, want, rtol=1e-5, atol=1e-4):
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol,
                                   err_msg=k)


def as_jax(argv, seed, monkeypatch, expert=False):
    """Run the port's CLI on ``argv`` given the draws JAX's CLI consumes
    for it and, for a gridded preset, JAX's bank; returns (port, JAX)
    outputs of ``run``."""
    jargs = j_build_parser().parse_args(argv)
    preset = jargs.preset
    jcfg = j_get_preset(preset)
    from tpu_plume.cli.main import _apply_overrides

    jcfg = _apply_overrides(jcfg, jargs)
    jbank = j_make_bank(jargs, jcfg)
    tcfg = tcli.apply_overrides(t_get_preset(preset),
                                tcli.build_parser().parse_args(argv))
    n = jargs.episodes
    draws = jax_draws(jax.random.PRNGKey(seed), tcfg.env, n,
                      tcfg.env.max_steps,
                      bank_rows=None if jbank is None else
                      int(jbank.conc.shape[0]), expert=expert)
    monkeypatch.setattr(th, "draw_eval", lambda *a, **k: draws)
    if jbank is not None:
        tbank = field_bank_from_numpy(
            np.asarray(jbank.conc), np.asarray(jbank.source), None,
            jbank.steps_per_frame, jbank.z_extent)
        monkeypatch.setattr(tcli, "make_bank", lambda *a: tbank)
    return run(tcli.main, argv), run(j_cli_main, argv)


@pytest.fixture(scope="module")
def bank_policy(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("bank") / "policy.pth")
    _, params, _ = models(j_get_preset("wrf_les").env, key=2)
    export_actor_critic_pth(jax.tree.map(np.asarray, params), path)
    return path


BANK_OPTIONS = {
    "defaults": [],
    "options": ["--guide-guard-top", "2", "--guide-sticky-target",
                "--guide-dive-bias", "--guide-margin", "2.0",
                "--guide-margin-until", "200", "--guide-search-after", "-1",
                "--guide-min-window", "3", "--guide-check-every", "2",
                "--guide-rim-expire", "300"],
}


@pytest.mark.parametrize("case", sorted(BANK_OPTIONS))
def test_cli_eval_guide_bank_matches_jax(case, bank_policy, monkeypatch):
    argv = ["eval", "--cpu", *BANK, "--pth", bank_policy, "--episodes",
            str(EPISODES), "--seed", "5", "--guide", "bank",
            *BANK_OPTIONS[case]]
    (got, _), (want, _) = as_jax(argv, 5, monkeypatch)
    assert {"bank_gate_rate", "bank_match_accuracy"} <= got.keys()
    same_summaries(got, want)


def test_cli_eval_guide_bank_needs_a_bank_as_jax_does(bank_policy):
    argv = ["eval", "--cpu", "--preset", "wrf_les", "--pth", bank_policy,
            "--guide", "bank"]
    with pytest.raises(SystemExit) as want:
        j_cli_main(argv)
    with pytest.raises(SystemExit) as got:
        tcli.main(argv)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("tail", [["--oracle", "phase"],
                                  ["--oracle", "raster", "--guide", "fit"]],
                         ids=["phase", "raster_fit"])
def test_cli_eval_oracle_matches_jax(tail, monkeypatch):
    """No policy file: the oracle replaces the policy in both CLIs."""
    argv = ["eval", "--cpu", "--episodes", str(EPISODES), "--seed", "7",
            *tail]
    (got, _), (want, _) = as_jax(argv, 7, monkeypatch)
    same_summaries(got, want)


def test_cli_expert_oracle_matches_jax(tmp_path, monkeypatch):
    argv = ["expert", "--cpu", "--episodes", str(EPISODES), "--seed", "8",
            "--oracle", "naive", "--out", "{}"]
    jout, tout = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    tcfg = t_get_preset("ppo_v2_0")
    draws = jax_draws(jax.random.PRNGKey(8), tcfg.env, EPISODES,
                      tcfg.env.max_steps, expert=True)
    monkeypatch.setattr(th, "draw_eval", lambda *a, **k: draws)
    got, _ = run(tcli.main, [tout if a == "{}" else a for a in argv])
    want, _ = run(j_cli_main, [jout if a == "{}" else a for a in argv])
    assert got["samples"] == want["samples"] > 0
    tz, jz = np.load(tout), np.load(jout)
    np.testing.assert_array_equal(tz["actions"], jz["actions"])
    np.testing.assert_allclose(tz["states"], jz["states"], rtol=1e-5,
                               atol=1e-4)


def parser_options(build, cmd):
    sub = next(a for a in build()._actions
               if isinstance(a, argparse._SubParsersAction))
    return {o for a in sub.choices[cmd]._actions for o in a.option_strings}


@pytest.mark.parametrize("cmd", ["eval", "expert"])
def test_eval_parsers_differ_from_jax_only_by_later_slices(cmd):
    jax_only = (parser_options(j_build_parser, cmd)
                - parser_options(tcli.build_parser, cmd))
    assert jax_only == set()
    assert not (parser_options(tcli.build_parser, cmd)
                - parser_options(j_build_parser, cmd))


@pytest.mark.parametrize("argv", [
    ["expert", "--debug-nans", "--oracle", "phase", "--episodes", "2"]])
def test_debug_nans_runs_on_expert(argv, tmp_path):
    """``--debug-nans``, refused until slice 12, runs the command with its
    checks (the expert data's eval steps are finite)."""
    out, _ = run(tcli.main, [argv[0], "--cpu", *argv[1:], "--out",
                             str(tmp_path / "x.npz")])
    assert out["samples"] > 0


@pytest.mark.parametrize("argv", [
    ["eval", "--distill", "phase"], ["expert", "--distill-coef", "0.1"],
    ["eval", "--distill-gate=0.2"]])
def test_distill_flags_parse_on_eval_and_expert_as_in_jax(argv):
    """Slice 10's distill flags, declared on every command as JAX's
    ``common()`` declares them, parse to JAX's values and set JAX's config
    fields (which eval and expert do not read)."""
    from tpu_plume.cli.main import _apply_overrides

    jargs = j_build_parser().parse_args(argv)
    targs = tcli.build_parser().parse_args(argv)
    for key, value in vars(targs).items():
        if key != "fn":
            assert value == getattr(jargs, key), key
    jcfg = _apply_overrides(j_get_preset("ppo_v2_0"), jargs)
    tcfg = tcli.apply_overrides(t_get_preset("ppo_v2_0"), targs)
    for key in ("distill_oracle", "distill_coef", "distill_conc_gate"):
        assert getattr(tcfg.ppo, key) == getattr(jcfg.ppo, key), key


@pytest.mark.parametrize("cmd", ["train-bc", "train-dagger", "train-gail"])
def test_commands_of_slice_10_are_declared_as_in_jax(cmd, capsys):
    """The imitation commands are the port's parser's choices with JAX's
    flags and defaults."""
    assert (parser_options(j_build_parser, cmd)
            - parser_options(tcli.build_parser, cmd)) == set()
    assert not (parser_options(tcli.build_parser, cmd)
                - parser_options(j_build_parser, cmd))
    argv = [cmd] + (["--expert", "x.npz"] if cmd != "train-dagger" else [])
    jargs = j_build_parser().parse_args(argv)
    for key, value in vars(tcli.build_parser().parse_args(argv)).items():
        if key != "fn":
            assert value == getattr(jargs, key), key
    if cmd != "train-dagger":
        with pytest.raises(SystemExit) as exc:
            tcli.main([cmd, "--cpu"])
        assert exc.value.code == 2
        assert "--expert" in capsys.readouterr().err

