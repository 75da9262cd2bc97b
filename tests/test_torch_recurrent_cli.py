"""The recurrent policy through the port's CLI and ``train_ppo``, on the CPU.

- ``train --arch lstm [--ln-lstm] --cpu`` writes ``checkpoint.pt``, whose
  config records the arch, and no reference ``.pth`` (its layout is the
  2-layer MLP), as JAX's ``train_ppo`` writes none for the LSTM.
- ``eval --arch lstm --ckpt`` evaluates that policy as JAX's
  ``evaluate_policy(rnn=)`` does with the same params (converted with
  ``recurrent_actor_critic_to_flax``) and JAX's draws; ``expert`` writes
  the ``expert_data.npz`` contract.
- ``--pth`` with ``--arch lstm``, and a ``--ckpt`` of another arch, exit
  with a message; a training guide with the LSTM is refused as JAX refuses
  it.
- Both packages' parsers build the same config from ``--arch lstm
  --ln-lstm`` for ``train``, ``eval`` and ``expert``.

Tolerances are ``tests/test_torch_eval.py``'s: steps, stop flags and
success equal, deviations rtol 1e-5 / atol 1e-4.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_eval import MOVE, jax_draws
from test_torch_evalcli import _run
from tpu_plume.cli.main import _apply_overrides as j_apply_overrides
from tpu_plume.cli.main import build_parser as j_build_parser
from tpu_plume.core.config import get_preset as j_get_preset
from tpu_plume.evaluation import harnesses as jh
from tpu_plume.models.recurrent import RecurrentActorCritic as JRecurrent
from tpu_plume_torch.cli.main import apply_overrides, build_parser
from tpu_plume_torch.cli.main import main as cli_main
from tpu_plume_torch.convert import recurrent_actor_critic_to_flax
from tpu_plume_torch.core.config import get_preset as t_get_preset
from tpu_plume_torch.evaluation import harnesses as th
from tpu_plume_torch.models import RecurrentActorCritic
from tpu_plume_torch.train import ppo_trainer as ttrain

torch.set_num_threads(1)

TINY = ["--envs", "16", "--unroll", "8", "--minibatch", "32", "--seed", "1"]
CELLS = {"plain": [], "ln": ["--ln-lstm"]}


@pytest.fixture(scope="module", params=sorted(CELLS))
def lstm_run(request, tmp_path_factory):
    """Two iterations of ``train --arch lstm`` on the CPU at a tiny size:
    (run directory, the cell's flags, the printed result)."""
    out = tmp_path_factory.mktemp(f"lstm_{request.param}")
    flags = ["--arch", "lstm", *CELLS[request.param]]
    res = _run(cli_main, ["train", "--cpu", *TINY, "--iterations", "2",
                          "--out", str(out), *flags])
    return out, flags, res


def test_cli_train_lstm_writes_checkpoint_and_no_pth(lstm_run):
    out, flags, res = lstm_run
    assert res["env_steps"] == 2 * 16 * 8
    assert os.path.isfile(out / "checkpoint.pt")
    assert os.path.isfile(out / "training_results.csv")
    assert not os.path.exists(out / "model" / "ppo_successful_models.pth")
    ckpt = torch.load(out / "checkpoint.pt", weights_only=True)
    assert ckpt["config"]["ppo"]["arch"] == "lstm"
    assert ckpt["config"]["ppo"]["lstm_layer_norm"] == ("--ln-lstm" in flags)
    assert ckpt["counters"]["iteration"] == 2
    model = RecurrentActorCritic(6, 5, layer_norm_cell="--ln-lstm" in flags)
    model.load_state_dict(ckpt["model"])
    assert all(torch.isfinite(p).all() for p in model.parameters())


def test_cli_eval_lstm_ckpt_evaluates_like_jax(lstm_run, monkeypatch):
    out, flags, _ = lstm_run
    argv = ["eval", "--cpu", "--ckpt", str(out), "--episodes", "16",
            "--seed", "3", "--goal-radius", "30", *flags]
    tcfg = t_get_preset("ppo_v2_0")
    draws = jax_draws(jax.random.PRNGKey(3), tcfg.env, 16, tcfg.env.max_steps)
    monkeypatch.setattr(th, "draw_eval", lambda *a, **k: draws)
    got = _run(cli_main, argv + ["--out", str(out / "eval")])
    tz = np.load(out / "eval" / "validation_metrics.npz")

    jcfg = j_get_preset("ppo_v2_0")
    ckpt = torch.load(out / "checkpoint.pt", weights_only=True)
    jm = JRecurrent(num_actions=5, layer_norm_cell="--ln-lstm" in flags)
    params = jax.tree.map(jnp.asarray,
                          recurrent_actor_critic_to_flax(ckpt["model"]))
    jmetrics = jh.evaluate_policy(params, jm.apply, jcfg.env, jcfg.eval,
                                  jax.random.PRNGKey(3), num_episodes=16,
                                  goal_radius=30.0, rnn=jm)
    np.testing.assert_array_equal(tz["steps"], np.asarray(jmetrics.steps))
    np.testing.assert_array_equal(tz["success"],
                                  np.asarray(jmetrics.success))
    np.testing.assert_allclose(tz["deviations"],
                               np.asarray(jmetrics.deviations), rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_allclose(got["mean_steps"],
                               float(np.mean(jmetrics.steps)))


def test_cli_expert_lstm_ckpt_writes_expert_data(lstm_run):
    out, flags, _ = lstm_run
    path = out / "expert_data.npz"
    res = _run(cli_main, ["expert", "--cpu", "--ckpt", str(out / "checkpoint.pt"),
                          "--episodes", "4", "--out", str(path), *flags])
    data = np.load(path)
    assert sorted(data.files) == ["actions", "states"]
    assert data["states"].shape == (res["samples"], 6)
    assert 0 < res["samples"] <= 4 * 1000
    assert data["actions"].dtype == np.int64


def test_expert_rnn_matches_the_model_given_directly(lstm_run):
    """``generate_expert_data(rnn=)`` through the model the CLI loads: the
    same rows as the model loaded by hand, so ``--ckpt`` and ``--arch``
    rebuild the trained policy."""
    out, flags, _ = lstm_run
    from tpu_plume_torch.cli.main import load_policy

    args = build_parser().parse_args(["expert", "--cpu", "--ckpt", str(out),
                                      *flags])
    cfg = apply_overrides(t_get_preset("ppo_v2_0"), args)
    loaded = load_policy(args, cfg, "cpu")
    by_hand = ttrain.make_policy_model(cfg)
    by_hand.load_state_dict(torch.load(out / "checkpoint.pt",
                                       weights_only=True)["model"])
    env = dataclasses.replace(cfg.env, **MOVE, max_steps=30)
    draws = th.draw_eval(torch.Generator().manual_seed(0), env, 30, 8)
    runs = [th.generate_expert_data(m, env, num_episodes=8, draws=draws,
                                    device="cpu", rnn=m)
            for m in (loaded, by_hand)]
    for a, b in zip(*runs):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("cmd", ["train", "eval", "expert"])
def test_pth_with_lstm_exits_with_a_message(cmd, tmp_path):
    with pytest.raises(SystemExit, match="reference .pth layout is the "
                                         "2-layer MLP"):
        cli_main([cmd, "--cpu", "--arch", "lstm", "--pth",
                  str(tmp_path / "policy.pth"), "--out", str(tmp_path / "o")])


def test_ckpt_of_another_arch_exits_with_a_message(lstm_run, tmp_path):
    out, flags, _ = lstm_run
    other = [] if "--ln-lstm" in flags else ["--arch", "lstm", "--ln-lstm"]
    with pytest.raises(SystemExit, match="give the --arch and --ln-lstm"):
        cli_main(["eval", "--cpu", "--ckpt", str(out), "--episodes", "2",
                  *other])


def test_train_ppo_refuses_a_guide_with_the_lstm_as_jax_does(tmp_path):
    cfg = t_get_preset("ppo_v2_0")
    cfg = cfg.replace(ppo=dataclasses.replace(cfg.ppo, arch="lstm"))
    with pytest.raises(ValueError, match="feedforward arch only"):
        ttrain.train_ppo(cfg, str(tmp_path), device="cpu", guide=object(),
                         max_iterations=1)


def test_an_unknown_arch_raises():
    cfg = t_get_preset("ppo_v2_0")
    cfg = cfg.replace(ppo=dataclasses.replace(cfg.ppo, arch="gru"))
    with pytest.raises(ValueError, match="arch must be one of"):
        ttrain.make_policy_model(cfg)


ARCH_FLAGS = {
    "lstm": ["--arch", "lstm"],
    "ln_lstm": ["--arch", "lstm", "--ln-lstm"],
    "mlp": ["--arch", "mlp", "--ln-lstm"],
}


@pytest.mark.parametrize("cmd", ["train", "eval", "expert"])
@pytest.mark.parametrize("flags", sorted(ARCH_FLAGS))
def test_parsers_build_jax_config_from_arch_flags(cmd, flags):
    argv = [cmd, "--preset", "ppo_v2_0", *ARCH_FLAGS[flags]]
    jcfg = j_apply_overrides(j_get_preset("ppo_v2_0"),
                             j_build_parser().parse_args(argv))
    tcfg = apply_overrides(t_get_preset("ppo_v2_0"),
                           build_parser().parse_args(argv))
    assert dataclasses.asdict(tcfg.ppo) == dataclasses.asdict(jcfg.ppo)
    assert tcfg.ppo.arch == ARCH_FLAGS[flags][1]
