"""The benchmark's files are found by name, agree with BENCHMARK.json, and
a new configuration, traffic mix, cell or metric is picked up from new
files alone."""

import json
import os
import shutil

import pytest

from plumebench import check, registry

REPO = os.path.dirname(registry.ROOT)
CELLS = ("ppo_v2_0.train.n16384", "wrf_les_3d.train.n32768",
         "ppo_v2_0.train-fused.n16384")


def benchmark():
    with open(os.path.join(REPO, "BENCHMARK.json")) as fh:
        return json.load(fh)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_spec(cell):
    s = registry.spec(cell)
    assert s.unroll_length == 128 and s.epochs == 5 and s.chips == 1
    assert s.minibatch_size * 8 == s.num_envs * s.unroll_length
    cfg = registry.train_config(s, 2**31 + 5)
    assert cfg.rollout.num_envs == s.num_envs
    assert cfg.ppo.minibatch_size == s.minibatch_size
    assert cfg.ppo.fused_update == ("fused" in cell)
    assert cfg.env.obs_dim == s.policy["obs_dim"]
    assert cfg.env.num_actions == s.policy["num_actions"]
    assert list(cfg.ppo.hidden_sizes) == s.policy["hidden"]
    assert set(s.limits) <= set(check.NAMES) and s.limits


def test_unknown_names_raise():
    with pytest.raises(KeyError, match="no workloads file"):
        registry.spec("no_such.cell")
    with pytest.raises(KeyError, match="unknown overrides"):
        registry.spec(CELLS[0], {"epochs": 2})


def test_benchmark_json_matches_the_files():
    doc = benchmark()
    assert doc["paths"] == ["plumebench"]
    for c in doc["configs"]:
        path = os.path.join(REPO, c["file"])
        with open(path) as fh:
            cfg = json.load(fh)
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]
    for w in doc["workloads"]:
        s = registry.spec(w["name"])
        assert s.workload["config"] == w["config"]
        assert s.workload["traffic"] == w["traffic"]
        assert s.chips == w["chips"]
    per_layer = {m["name"]: m for m in doc["per_layer"]}
    assert set(per_layer) == set(registry.names("metrics"))
    for m in registry.metrics():
        for key in ("unit", "better", "source", "layer", "moves"):
            assert m.entry[key] == per_layer[m.name][key], (m.name, key)
    names = [m["name"] for m in doc["end_to_end"]]
    assert names == ["train_env_steps_per_s", "peak_mem_gib", "setup_s"]


def test_new_files_are_found_without_edits(tmp_path, monkeypatch):
    root = tmp_path / "plumebench"
    for kind in ("configs", "traffic", "workloads", "metrics", "reference"):
        shutil.copytree(os.path.join(registry.ROOT, kind), root / kind)
    monkeypatch.setattr(registry, "ROOT", str(root))
    with open(root / "configs" / "ppo_v2_0.json") as fh:
        cfg = json.load(fh)
    cfg["name"] = "ppo_v2_0_wide"
    cfg["ppo"] = dict(cfg["ppo"], arch="wide")
    (root / "configs" / "ppo_v2_0_wide.json").write_text(json.dumps(cfg))
    (root / "reference" / "policy_wide.py").write_text(
        "from plumebench.reference.policy_mlp import *  # noqa: F401,F403\n"
        "NAME = 'wide'\n")
    traffic = {"why": "x", "num_envs": 4096, "unroll_length": 64,
               "epochs": 2, "minibatches_per_epoch": 4, "sync_every": 2,
               "ppo": {}}
    (root / "traffic" / "short.n4096.json").write_text(json.dumps(traffic))
    (root / "workloads" / "ppo_v2_0_wide.short.n4096.json").write_text(
        json.dumps({"config": "ppo_v2_0_wide", "traffic": "short.n4096",
                    "chips": 1, "checked_steps": 2,
                    "limits": {"loss_gap": 1, "grad_gap": 1,
                               "change_gap": 1}}))
    (root / "metrics" / "new_metric.json").write_text(json.dumps(
        {"name": "new_metric", "unit": "ms", "better": "lower",
         "source": "host_clock", "layer": "x",
         "moves": "train_env_steps_per_s", "kernels": ["a_kernel"]}))
    (root / "metrics" / "new_metric.py").write_text(
        "def read(ctx, metric):\n    return 1.5\n")
    (root / "metrics" / "env_step_roofline.kernels.fused.json").write_text(
        json.dumps({"kernels": ["fused_env_kernel"]}))

    s = registry.spec("ppo_v2_0_wide.short.n4096")
    assert (s.num_envs, s.unroll_length, s.epochs) == (4096, 64, 2)
    assert s.minibatch_size == 4096 * 64 // 4 and s.checked_steps == 2
    assert s.config["name"] == "ppo_v2_0_wide"
    policy = registry.reference_policy(s)
    assert policy.NAME == "wide"
    assert policy.__file__ == str(root / "reference" / "policy_wide.py")
    assert registry.reference_field(s).__file__.startswith(str(root))
    found = {m.name: m for m in registry.metrics()}
    assert found["new_metric"].read(None, found["new_metric"]) == 1.5
    assert found["new_metric"].kernels == ("a_kernel",)
    assert found["env_step_roofline"].kernels == ("env_step_kernel",
                                                  "fused_env_kernel")
    assert "env_step_roofline.kernels.fused" not in registry.names("metrics")
