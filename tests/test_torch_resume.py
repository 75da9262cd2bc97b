"""The ``train`` flags of slice 12 on the CPU: ``--snapshot-every`` and
``--resume`` (JAX's ``tests/test_train.py::test_snapshot_every`` and
``test_kill_and_resume_equivalence`` on the port, for the feedforward and
the recurrent policy, a gridded bank, ``fused_update`` and a capture run),
``--tensorboard`` (JAX's ``test_grad_histograms_logged``),
``--profile-steps``, ``--debug-nans`` and the CLI's precision settings.

A run killed after a snapshot and resumed from it must equal the
uninterrupted run bit for bit: params, optimizer state, counters,
curriculum and ``training_results.csv``.
"""

import contextlib
import csv
import dataclasses
import io
import json
import os
import sys

import numpy as np
import pytest
import torch

from tpu_plume_torch.cli.main import main as cli_main
from tpu_plume_torch.core.config import (
    CurriculumConfig,
    EnvConfig,
    PPOConfig,
    RolloutConfig,
    TrainConfig,
)
from tpu_plume_torch.core import debug
from tpu_plume_torch.core.debug import check_finite, debug_nans
from tpu_plume_torch.fields.gridded import synthesize_bank
from tpu_plume_torch.models import ActorCritic
from tpu_plume_torch.obsv.metrics import TrainLogger
from tpu_plume_torch.train import ppo_trainer as ttrain

torch.set_num_threads(1)

SMALL = ["--cpu", "--envs", "16", "--unroll", "8", "--minibatch", "32",
         "--hidden", "64,32", "--episodes", "100000"]


def _tiny_cfg(**ppo):
    """JAX's ``tests/test_train.py`` ``_tiny_cfg``, with ``ppo`` set."""
    return TrainConfig(
        name="ppo_v2_0",
        env=EnvConfig(max_steps=40, plume_sigma=500 / 16),
        ppo=PPOConfig(minibatch_size=128, epochs=2, **ppo),
        curriculum=CurriculumConfig(window_size=16),
        rollout=RolloutConfig(num_envs=32, unroll_length=32),
        total_episodes=60,
    )


def _run(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cli_main(argv)
    return json.loads(out.getvalue().strip().splitlines()[-1])


def test_snapshot_every(tmp_path):
    """Snapshots land at drain-window boundaries and carry the full resume
    bundle, which ``eval --ckpt`` also reads."""
    out = str(tmp_path / "run")
    ttrain.train_ppo(_tiny_cfg(), out, device="cpu", verbose=False,
                     max_iterations=3, write_csv=False, snapshot_every=2)
    # sync_every defaults to 8 > max_iterations, so the only drain window
    # is the final one at iteration 3.
    snap = os.path.join(out, "checkpoint_iter000003")
    assert os.path.isdir(snap)
    assert not os.path.exists(os.path.join(out, "checkpoint_iter000002"))
    bundle = torch.load(os.path.join(snap, "checkpoint.pt"),
                        weights_only=True)
    for k in ("model", "optimizer", "rollout", "curriculum", "generator",
              "counters", "config"):
        assert k in bundle, k
    assert int(bundle["counters"]["iteration"]) == 3
    out_eval = _run(["eval", "--cpu", "--ckpt", snap, "--episodes", "2"])
    assert "success_rate" in out_eval


def _bank_cfg():
    cfg = _tiny_cfg()
    return cfg.replace(env=dataclasses.replace(
        cfg.env, grid_size=64, source_padding=10.0, plume_model="gridded",
        subcell_sampling=True, initial_radius=30.0))


CASES = {
    "mlp": (_tiny_cfg, None),
    "lstm": (lambda: _tiny_cfg(arch="lstm", lstm_hidden=16, lstm_embed=16),
             None),
    "fused_update": (lambda: _tiny_cfg(fused_update=True), None),
    "static bank": (_bank_cfg, 4),
}


def _bank(cfg, fields):
    if fields is None:
        return None
    return synthesize_bank(torch.Generator().manual_seed(3), cfg.env,
                           num_fields=fields)


def _state_equal(a, b, where=""):
    if isinstance(a, torch.Tensor):
        assert torch.equal(a, b), where
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _state_equal(a[k], b[k], f"{where}/{k}")
    elif isinstance(a, (list, tuple)):
        for i, (x, y) in enumerate(zip(a, b, strict=True)):
            _state_equal(x, y, f"{where}[{i}]")
    else:
        assert a == b, where


@pytest.mark.parametrize("case", sorted(CASES))
def test_kill_and_resume_equivalence(tmp_path, monkeypatch, case):
    """A run killed after a snapshot and resumed from it is bit-identical
    to the uninterrupted run: params, optimizer state, counters,
    curriculum and the per-episode CSV."""
    make, fields = CASES[case]
    cfg = dataclasses.replace(make(), total_episodes=100_000)
    monkeypatch.setattr(ttrain, "LOG_EVERY", 2)
    kw = dict(device="cpu", verbose=False, sync_every=2)
    full_dir, part_dir = str(tmp_path / "full"), str(tmp_path / "part")
    full = ttrain.train_ppo(cfg, full_dir, max_iterations=6,
                            bank=_bank(cfg, fields), **kw)
    ttrain.train_ppo(cfg, part_dir, max_iterations=4, snapshot_every=2,
                     bank=_bank(cfg, fields), **kw)
    assert os.path.isdir(os.path.join(part_dir, "checkpoint_iter000002"))
    res = ttrain.train_ppo(
        cfg, part_dir, max_iterations=6, bank=_bank(cfg, fields),
        resume_from=os.path.join(part_dir, "checkpoint_iter000004"), **kw)

    _state_equal(full.state_dict, res.state_dict, "params")
    assert (res.episodes, res.successes, res.env_steps) == (
        full.episodes, full.successes, full.env_steps)
    assert full.episodes > 0
    assert dataclasses.asdict(res.curriculum) == dataclasses.asdict(
        full.curriculum)
    a, b = (torch.load(os.path.join(d, "checkpoint.pt"), weights_only=True)
            for d in (full_dir, part_dir))
    for key in ("optimizer", "rollout", "generator", "counters",
                "curriculum"):
        _state_equal(a[key], b[key], key)
    for name in ("training_results.csv",):
        with open(os.path.join(full_dir, name)) as f1, \
                open(os.path.join(part_dir, name)) as f2:
            assert f1.read() == f2.read(), name
    for run_dir in (full_dir, part_dir):
        # one header; the resumed run's row appended to the killed run's
        with open(os.path.join(run_dir, "train_log.csv")) as fh:
            steps = [int(r["step"]) for r in csv.DictReader(fh)]
        assert steps == [2, 4, 6], run_dir


def test_resume_refuses_init_params_and_another_config(tmp_path):
    cfg = dataclasses.replace(_tiny_cfg(), total_episodes=100_000)
    out = str(tmp_path / "run")
    res = ttrain.train_ppo(cfg, out, device="cpu", verbose=False,
                           max_iterations=1)
    with pytest.raises(ValueError):
        ttrain.train_ppo(cfg, str(tmp_path / "bad"), device="cpu",
                         verbose=False, max_iterations=2,
                         init_params=res.state_dict, resume_from=out)
    wider = cfg.replace(rollout=dataclasses.replace(cfg.rollout,
                                                    num_envs=64))
    with pytest.raises(ValueError, match="num_envs"):
        ttrain.train_ppo(wider, str(tmp_path / "bad"), device="cpu",
                         verbose=False, max_iterations=2, resume_from=out)
    lstm = cfg.replace(ppo=dataclasses.replace(cfg.ppo, arch="lstm"))
    with pytest.raises(ValueError, match="arch"):
        ttrain.train_ppo(lstm, str(tmp_path / "bad"), device="cpu",
                         verbose=False, max_iterations=2, resume_from=out)
    gridded = _bank_cfg().replace(
        rollout=cfg.rollout, total_episodes=100_000)
    with pytest.raises(ValueError, match="plume_model"):
        ttrain.train_ppo(gridded, str(tmp_path / "bad"), device="cpu",
                         verbose=False, max_iterations=2, resume_from=out,
                         bank=_bank(gridded, 4))


def test_resume_refuses_ckpt_with_jax_message(tmp_path):
    with pytest.raises(SystemExit, match=r"--resume restores its own params; "
                                         r"drop --ckpt/--pth"):
        cli_main(["train", *SMALL, "--resume", str(tmp_path), "--ckpt",
                  str(tmp_path), "--out", str(tmp_path / "run")])


def test_capture_run_resumes_appending_data_csv(tmp_path):
    """With the capture on, ``data.csv`` is kept and appended to and
    ``training_data.nc`` restarts with the resumed run's episodes, as in
    JAX (the capture's host buffers are not in the bundle)."""
    pytest.importorskip("h5py")
    from tpu_plume_torch.data.netcdf import read_nc

    cfg = dataclasses.replace(_tiny_cfg(), total_episodes=100_000)
    out = str(tmp_path / "run")
    kw = dict(device="cpu", verbose=False, sync_every=2,
              capture_netcdf=True, capture_conc_csv=True)
    ttrain.train_ppo(cfg, out, max_iterations=4, snapshot_every=2, **kw)
    with open(os.path.join(out, "data.csv")) as fh:
        before = fh.read()
    res = ttrain.train_ppo(
        cfg, out, max_iterations=8,
        resume_from=os.path.join(out, "checkpoint_iter000004"), **kw)
    with open(os.path.join(out, "data.csv")) as fh:
        after = fh.read()
    assert before and after.startswith(before) and len(after) > len(before)
    nc = read_nc(os.path.join(out, "training_data.nc"))
    written = int((~np.isnan(nc["source_x"])).sum())
    assert written == len(res.trajectories)


def test_grad_histograms_logged(tmp_path, monkeypatch):
    """With TensorBoard on, the step returns the full-batch gradient by
    parameter name, and the logger writes event files with ``grads/`` and
    ``params/`` histograms."""
    cfg = _tiny_cfg()
    loop = ttrain.init_loop(cfg, "cpu")
    names = [k for k, _ in loop.model.named_parameters()]
    _, stats, _ = ttrain.build_train_step(cfg, with_grads=True)(loop)
    grads = stats["grads"]
    assert list(grads) == names
    assert all(torch.isfinite(g).all() for g in grads.values())
    assert any(g.abs().max() > 0 for g in grads.values())

    out = str(tmp_path / "run")
    monkeypatch.setattr(ttrain, "LOG_EVERY", 1)
    ttrain.train_ppo(_tiny_cfg(), out, device="cpu", verbose=False,
                     max_iterations=2, write_csv=False, use_tensorboard=True)
    events = [os.path.join(out, "tb", f) for f in os.listdir(
        os.path.join(out, "tb")) if f.startswith("events.out.tfevents.")]
    assert events
    data = b"".join(open(e, "rb").read() for e in events)
    assert b"grads/" in data and b"params/" in data


def test_tensorboard_missing_logs_the_csv_alone(tmp_path, monkeypatch,
                                                capsys):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    logger = TrainLogger(str(tmp_path), use_tensorboard=True)
    logger.log(1, {"a": 1.0})
    logger.log_histograms(1, {"w": torch.ones(3)})
    logger.close()
    assert "--tensorboard" in capsys.readouterr().err
    assert not (tmp_path / "tb").exists()
    assert (tmp_path / "train_log.csv").read_text().splitlines()[0] == "step,a"


def test_profile_steps_writes_a_trace(tmp_path):
    out = tmp_path / "run"
    _run(["train", *SMALL, "--iterations", "3", "--profile-steps", "1",
          "--out", str(out)])
    with open(out / "profile" / "trace.json") as fh:
        trace = json.load(fh)
    assert trace["traceEvents"]


def _nan_rollout(rollout_chunk):
    def chunk(*args, **kw):
        carry, traj, bootstrap = rollout_chunk(*args, **kw)
        traj.reward[-1, 0] = float("nan")
        return carry, traj, bootstrap
    return chunk


def _nan_gae(compute_gae):
    def gae(*args, **kw):
        advantages, returns = compute_gae(*args, **kw)
        return advantages * float("nan"), returns
    return gae


@pytest.mark.parametrize("phase, name, poison", [
    ("rollout", "rollout_chunk", _nan_rollout), ("gae", "compute_gae",
                                                 _nan_gae)])
def test_debug_nans_names_the_phase_of_train(tmp_path, monkeypatch, phase,
                                             name, poison):
    """A NaN injected into one phase: ``--debug-nans`` names that phase;
    without it the NaN tripwire stops the run naming the flag."""
    monkeypatch.setattr(ttrain, name, poison(getattr(ttrain, name)))
    argv = ["train", *SMALL, "--iterations", "1", "--out",
            str(tmp_path / "run")]
    with pytest.raises(FloatingPointError,
                       match=rf"first non-finite values are in the {phase} "):
        cli_main(argv + ["--debug-nans"])
    with pytest.raises(RuntimeError, match="re-run with --debug-nans"):
        cli_main(argv)


def test_debug_nans_names_the_eval_step(tmp_path):
    model = ActorCritic(6, 5, (256, 128))
    model.reset_parameters(torch.Generator().manual_seed(0))
    with torch.no_grad():
        model.actor.bias[0] = float("nan")
    pth = str(tmp_path / "nan.pth")
    torch.save(model.state_dict(), pth)
    with pytest.raises(FloatingPointError, match="eval step phase: logits"):
        cli_main(["eval", "--cpu", "--pth", pth, "--episodes", "2",
                  "--debug-nans"])


def test_check_finite_is_off_outside_debug_nans():
    nan = torch.tensor([float("nan")])
    assert not debug.enabled()
    check_finite("rollout", x=nan)
    with debug_nans():
        assert debug.enabled()
        check_finite("rollout", x=torch.ones(2), y=None)
        with pytest.raises(FloatingPointError, match="rollout phase: x"):
            check_finite("rollout", x=nan)
    assert not debug.enabled()
    check_finite("rollout", x=nan)


def test_train_step_checks_nothing_outside_debug_nans(monkeypatch):
    """Without ``--debug-nans`` the step does not even call the phase
    checks; with it, it checks the rollout, GAE and the update."""
    phases = []
    monkeypatch.setattr(debug, "check_finite",
                        lambda phase, **tensors: phases.append(phase))
    cfg = _tiny_cfg()
    step = ttrain.build_train_step(cfg)
    step(ttrain.init_loop(cfg, "cpu"))
    assert phases == []
    with debug_nans():
        step(ttrain.init_loop(cfg, "cpu"))
    assert phases == ["rollout", "gae", "update"]


def test_cli_turns_off_tf32_and_reduced_precision(tmp_path):
    backends = torch.backends
    backends.cuda.matmul.allow_tf32 = True
    backends.cudnn.allow_tf32 = True
    backends.cuda.matmul.allow_bf16_reduced_precision_reduction = True
    _run(["train", *SMALL, "--iterations", "1", "--out",
          str(tmp_path / "run")])
    assert not backends.cuda.matmul.allow_tf32
    assert not backends.cudnn.allow_tf32
    assert not backends.cuda.matmul.allow_bf16_reduced_precision_reduction
