"""A recurrent configuration added as files alone: the benchmark's files
copied under a temporary root, with two configurations of the port's
``--arch lstm`` policy on ``ppo_v2_0``'s env, the plain cell and the
LayerNorm cell, and a cell of each under the ``train.n16384`` traffic.

Each cell's limits lie between the largest sound reading and the least
upper reading measured on an H100 at N = 16384 (PERF.md section 7), on
every number: the TF32 control's least ``first_loss_gap`` is 4.21e-7 and
2.18e-7, its least ``grad_gap`` 4.14e-5 and 1.02e-4, its least
``change_gap`` 5.63e-3 and 4.27e-4, the sound runs' largest 0, 5.65e-8
and 2.76e-5 (plain) and 0, 4.16e-8 and 2.00e-5 (LayerNorm)."""

import json
import os
import shutil

from plumebench import registry

BENCH = registry.ROOT
# cell -> the configuration's ppo.lstm_layer_norm
CELLS = {"ppo_v2_0_lstm.train.n16384": False,
         "ppo_v2_0_lnlstm.train.n16384": True}
LIMITS = {
    "ppo_v2_0_lstm.train.n16384":
        {"first_loss_gap": 1e-7, "grad_gap": 2e-6, "change_gap": 5e-4},
    "ppo_v2_0_lnlstm.train.n16384":
        {"first_loss_gap": 1e-7, "grad_gap": 2e-6, "change_gap": 1.5e-4},
}


def config(layer_norm: bool) -> dict:
    """``ppo_v2_0`` with the recurrent policy: encoder 6 -> 128, LSTM of
    H = 128, heads of 5 and 1."""
    with open(os.path.join(BENCH, "configs", "ppo_v2_0.json")) as fh:
        cfg = json.load(fh)
    cfg["name"] = "ppo_v2_0_lnlstm" if layer_norm else "ppo_v2_0_lstm"
    cfg["policy"] = {"obs_dim": 6, "embed": 128, "hidden": 128,
                     "num_actions": 5}
    cfg["ppo"] = dict(cfg["ppo"], arch="lstm", lstm_embed=128,
                      lstm_hidden=128, lstm_layer_norm=layer_norm)
    return cfg


def install(root, monkeypatch) -> None:
    """The benchmark's files under ``root`` with the recurrent
    configurations and cells added, and ``registry.ROOT`` pointed there."""
    for kind in ("configs", "traffic", "workloads", "metrics", "reference"):
        shutil.copytree(os.path.join(BENCH, kind), root / kind,
                        ignore=shutil.ignore_patterns("__pycache__"))
    for cell, layer_norm in CELLS.items():
        cfg = config(layer_norm)
        (root / "configs" / f"{cfg['name']}.json").write_text(json.dumps(cfg))
        (root / "workloads" / f"{cell}.json").write_text(json.dumps(
            {"config": cfg["name"], "traffic": "train.n16384", "chips": 1,
             "checked_steps": 3, "limits": LIMITS[cell]}))
    monkeypatch.setattr(registry, "ROOT", str(root))
