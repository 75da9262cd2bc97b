"""The eval's localizer and learned guide through the port's CLI against
JAX's CLI, on the CPU.

- ``eval --guide learned --localize`` and ``--guide fit --localize``
  with ``--cpu`` at 8 episodes, each against JAX's CLI on the same argv,
  the port given the draws JAX consumes (``draw_eval`` monkeypatched to
  ``jax_draws``): the same summary keys (``localize_*``, ``hybrid_*``)
  and printed lines, the summaries at the env tolerance (the localizer's
  errors at 1e-3 px).
- The localizer is the port's ``train-lstm --variant params`` checkpoint,
  given to JAX as its Orbax checkpoint through
  ``convert.lstm_zoo_to_flax``, with the same ``localizer_meta.npz``.
"""

import os
import shutil

import jax
import numpy as np
import pytest
import torch

from test_torch_eval import jax_draws, models
from test_torch_guides_cli import EPISODES, run, same_summaries, tcli
from tpu_plume.cli.main import main as j_cli_main
from tpu_plume.core.config import get_preset as j_get_preset
from tpu_plume.data.checkpoint import save_checkpoint
from tpu_plume.data.torch_export import export_actor_critic_pth
from tpu_plume_torch.convert import lstm_zoo_to_flax
from tpu_plume_torch.core.config import get_preset as t_get_preset
from tpu_plume_torch.evaluation import harnesses as th
from tpu_plume_torch.models.lstm_zoo import GaussianParamPredictor

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def localizer(tmp_path_factory):
    """The port's ``train-lstm --variant params`` run on flights of the
    port's ``eval --save-flights`` (a random policy), and the same
    localizer as JAX's Orbax checkpoint beside the same meta file."""
    tmp = tmp_path_factory.mktemp("loc")
    _, params, _ = models(j_get_preset("ppo_v2_0").env, key=3)
    pth = str(tmp / "policy.pth")
    export_actor_critic_pth(jax.tree.map(np.asarray, params), pth)
    flights = str(tmp / "flights.npz")
    run(tcli.main, ["eval", "--cpu", "--pth", pth, "--episodes", "16",
                    "--save-flights", flights])
    run(tcli.main, ["train-lstm", "--cpu", "--variant", "params",
                    "--flights", flights, "--window", "16", "--epochs", "3",
                    "--out", str(tmp / "port")])
    state = torch.load(tmp / "port" / "gaussian_params.pt")
    os.makedirs(tmp / "jax")
    save_checkpoint(str(tmp / "jax" / "gaussian_params"), {
        "params": lstm_zoo_to_flax(GaussianParamPredictor, state)})
    shutil.copy(tmp / "port" / "localizer_meta.npz", tmp / "jax")
    return pth, tmp / "port", tmp / "jax"


@pytest.mark.parametrize("guide", ["learned", "fit"])
def test_cli_eval_localize_matches_jax(guide, localizer, monkeypatch):
    """``--localize`` after a learned (``--guide-ckpt``: the run dir for
    the port, the Orbax dir for JAX) or a fit-guided eval: the
    ``localize_*`` and ``hybrid_*`` errors, and the derived gate's line."""
    pth, port, jax_dir = localizer
    tail = ["--guide", guide, "--localize-window", "16"]
    if guide == "learned":
        tail += ["--guide-ckpt", "{}"]
    argv = ["eval", "--cpu", "--pth", pth, "--episodes", str(EPISODES),
            "--seed", "6", "--localize", "{}", *tail]

    def with_dir(d):
        return [str(d) if a == "{}" else a for a in argv]

    jargs = with_dir(jax_dir / "gaussian_params")
    tcfg = t_get_preset("ppo_v2_0")
    draws = jax_draws(jax.random.PRNGKey(6), tcfg.env, EPISODES,
                      tcfg.env.max_steps)
    monkeypatch.setattr(th, "draw_eval", lambda *a, **k: draws)
    got, got_lines = run(tcli.main, with_dir(port))
    want, want_lines = run(j_cli_main, jargs)
    assert {"localize_median_err", "hybrid_within_40"} <= got.keys()
    same_summaries(got, want, atol=1e-3)
    assert got_lines == want_lines


def test_cli_eval_guide_ckpt_refuses_an_orbax_directory(localizer):
    pth, _, jax_dir = localizer
    with pytest.raises(SystemExit, match="no gaussian_params.pt"):
        tcli.main(["eval", "--cpu", "--pth", pth, "--guide", "learned",
                   "--guide-ckpt", str(jax_dir / "gaussian_params")])
    with pytest.raises(SystemExit, match="requires --guide-ckpt"):
        tcli.main(["eval", "--cpu", "--pth", pth, "--guide", "learned"])
