"""The result's last line: its keys and their order, with --trace 0 and 1,
and no result without a card."""

import json

import pytest
import torch

from plumebench import harness, registry, run

E2E = {"train_env_steps_per_s": "env-steps/s", "peak_mem_gib": "GiB",
       "setup_s": "s"}


@pytest.mark.parametrize("trace", [0, 1])
def test_result_line(trace):
    s = registry.spec("ppo_v2_0.train.n16384",
                      {"num_envs": 32, "unroll_length": 4})
    out = harness.run(s, 2**31 + 3, 0.2, bool(trace), "cpu",
                      run.process_start())
    result = json.loads(json.dumps(run.line(out)))
    keys = list(result)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert keys[-1] == "checks"
    assert result["correct"] is True and result["attempted"] >= 1
    assert result["failed"] == 0
    assert set(result["checks"]) == set(s.limits)
    for c in result["checks"].values():
        assert set(c) == {"value", "limit"}
    dev = result["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    if trace:
        assert {"busy_s", "window_s"} <= set(dev)
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
        metrics = {m.name: m.entry["unit"] for m in registry.metrics()}
        # a CPU run reads no device trace: those metrics are left out
        assert set(result["metrics"]) == {"iter_ms_p90", "rollout_ms",
                                          "gae_ms", "update_ms", "train_mfu"}
        for name, m in result["metrics"].items():
            assert m["unit"] == metrics[name] and m["value"] > 0
    else:
        assert {k: m["unit"] for k, m in result["metrics"].items()} == E2E
        assert result["metrics"]["setup_s"]["value"] > 0


def test_no_card_no_result(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", "ppo_v2_0.train.n16384", "--seed", "1",
                   "--seconds", "1", "--trace", "0"])
    captured = capsys.readouterr()
    assert rc == 1 and captured.out == ""
    assert "no CUDA device" in captured.err


def test_too_few_cards_no_result(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    rc = run.main(["--workload", "ppo_v2_0.train.n16384", "--seed", "1",
                   "--seconds", "1", "--trace", "0"])
    captured = capsys.readouterr()
    assert rc == 1 and captured.out == "" and "needs 1 cards" in captured.err
