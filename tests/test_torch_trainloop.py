"""The host loop and CLI of ``train`` against the JAX package, on the CPU.

``train_ppo`` of both packages runs ppo_v2_0 at a tiny size until
``total_episodes`` episodes have been drained, at ``sync_every`` 1 and 8:
the iterations run, the episode count and the steps that ``train_log.csv``
logs must be equal.  Episodes are 6 steps long and the goal lies beyond
the grid, so every episode ends by timeout and both packages count the
same episodes per iteration, whatever their random draws.  The ``train``
parsers of both CLIs must build the same config from the flags the port
shares with JAX.
"""

import csv
import dataclasses

import pytest
import torch

from tpu_plume.cli.main import _apply_overrides as j_apply_overrides
from tpu_plume.cli.main import build_parser as j_build_parser
from tpu_plume.core.config import RolloutConfig as JRolloutCfg
from tpu_plume.core.config import get_preset as j_get_preset
from tpu_plume.train import ppo_trainer as jtrain
from tpu_plume_torch.cli.main import apply_overrides, build_parser
from tpu_plume_torch.core.config import RolloutConfig
from tpu_plume_torch.core.config import get_preset as t_get_preset
from tpu_plume_torch.train import ppo_trainer as ttrain

torch.set_num_threads(1)

N, T, MB, EPISODES = 16, 8, 32, 40


def _tiny(cfg, rollout_cls):
    """ppo_v2_0 at 16 envs x 8 steps, minibatch 32, a (64, 32) trunk and
    6-step episodes that cannot reach the goal (radius 1, floor 0)."""
    return cfg.replace(
        env=dataclasses.replace(cfg.env, max_steps=6, initial_radius=1.0),
        ppo=dataclasses.replace(cfg.ppo, hidden_sizes=(64, 32),
                                minibatch_size=MB, epochs=1),
        curriculum=dataclasses.replace(cfg.curriculum, initial_radius=1.0,
                                       min_radius=0.0, window_size=4),
        rollout=rollout_cls(num_envs=N, unroll_length=T),
        total_episodes=EPISODES,
    )


def _logged_steps(out_dir) -> list[int]:
    with open(out_dir / "train_log.csv", newline="") as fh:
        rows = list(csv.reader(fh))
    return [int(r[0]) for r in rows[1:]]


@pytest.mark.parametrize("sync_every", [1, 8])
def test_train_ppo_stops_and_logs_as_jax(tmp_path, sync_every):
    jdir, tdir = tmp_path / "jax", tmp_path / "torch"
    jres = jtrain.train_ppo(_tiny(j_get_preset("ppo_v2_0"), JRolloutCfg),
                            str(jdir), write_csv=False, max_iterations=50,
                            verbose=False, sync_every=sync_every)
    tres = ttrain.train_ppo(_tiny(t_get_preset("ppo_v2_0"), RolloutConfig),
                            str(tdir), device="cpu", write_csv=False,
                            max_iterations=50, verbose=False,
                            sync_every=sync_every)
    assert tres.env_steps == jres.env_steps          # iterations run
    assert tres.episodes == jres.episodes >= EPISODES
    assert tres.successes == jres.successes == 0
    assert _logged_steps(tdir) == _logged_steps(jdir)
    assert _logged_steps(tdir)                       # the target's row
    ckpt = torch.load(tdir / "checkpoint.pt", weights_only=False)
    assert ckpt["counters"]["iteration"] * N * T == jres.env_steps


def test_log_every_is_jax_default():
    import inspect

    default = inspect.signature(jtrain.train_ppo).parameters["log_every"]
    assert ttrain.LOG_EVERY == default.default


FLAGS = {
    "depth_coef": ["--depth-coef", "0.5"],
    "depth_power": ["--depth-power", "2.0"],
    "terminal_gate": ["--terminal-gate", "40"],
    "terminal_gate_zero": ["--terminal-gate", "0"],
    "inplume_bonus": ["--inplume-bonus", "0.1"],
    "min_radius": ["--min-radius", "50"],
    "hidden": ["--hidden", "512,256"],
    "recipe": ["--min-radius", "50", "--terminal-gate", "40"],
    "none": [],
}


@pytest.mark.parametrize("flags", sorted(FLAGS))
def test_train_parser_builds_jax_config(flags):
    argv = ["train", "--preset", "ppo_v2_0", *FLAGS[flags]]
    jcfg = j_apply_overrides(j_get_preset("ppo_v2_0"),
                             j_build_parser().parse_args(argv))
    tcfg = apply_overrides(t_get_preset("ppo_v2_0"),
                           build_parser().parse_args(argv))
    for part in ("env", "curriculum", "ppo"):
        want = dataclasses.asdict(getattr(jcfg, part))
        got = dataclasses.asdict(getattr(tcfg, part))
        for key, value in got.items():
            assert key in want, (part, key)
            assert value == want[key], (part, key, value, want[key])
