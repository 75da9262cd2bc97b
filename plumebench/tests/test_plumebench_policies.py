"""The reference policy is the one of the program's ``ppo.arch``: the
MLP's inputs are drawn as before policies were chosen (a frozen copy of
that draw is kept here), the policy follows the architecture as run, and
each policy counts its multiply-adds as by hand."""

import json
import math

import pytest
import torch

from plumebench import inputs, registry
from plumebench.tests import recurrent

CELLS = {"ppo_v2_0.train.n16384": {"num_envs": 16, "unroll_length": 4},
         "ppo_v2_0.train-fused.n16384": {"num_envs": 32, "unroll_length": 4},
         "wrf_les_3d.train.n32768": {"num_envs": 16, "unroll_length": 4,
                                     "bank": {"fields": 2, "frames": 3,
                                              "levels": 2}}}


def frozen_layout(policy: dict) -> list:
    """The MLP's layout as ``inputs.layout`` drew it before a
    configuration named its policy."""
    out = []
    width = policy["obs_dim"]
    for i, h in enumerate(policy["hidden"]):
        lin, ln = f"feature.{3 * i}", f"feature.{3 * i + 1}"
        out += [(f"{lin}.weight", (h, width), "w", math.sqrt(2.0)),
                (f"{lin}.bias", (h,), "b", 0.0),
                (f"{ln}.weight", (h,), "g", 0.0),
                (f"{ln}.bias", (h,), "b", 0.0)]
        width = h
    a = policy["num_actions"]
    out += [("actor.weight", (a, width), "w", 0.01), ("actor.bias", (a,), "b", 0.0),
            ("critic.weight", (1, width), "w", 1.0), ("critic.bias", (1,), "b", 0.0)]
    return out


def frozen_params(policy: dict, gen: torch.Generator) -> dict:
    """``inputs.make_params`` as it was: one normal draw of every weight."""
    dev = gen.device
    spec = frozen_layout(policy)
    weights = [(name, shape, gain) for name, shape, kind, gain in spec
               if kind == "w"]
    flat = torch.randn(sum(math.prod(s) for _, s, _ in weights), device=dev,
                       generator=gen)
    params, at = {}, 0
    for name, shape, gain in weights:
        size = math.prod(shape)
        params[name] = (flat[at:at + size].reshape(shape)
                        * (gain / math.sqrt(shape[1])))
        at += size
    for name, shape, kind, _ in spec:
        if kind == "b":
            params[name] = torch.zeros(shape, device=dev)
        elif kind == "g":
            params[name] = torch.ones(shape, device=dev)
    return {name: params[name].contiguous() for name, *_ in spec}


def frozen_draws(s, seed: int, steps: int):
    """Every draw of the MLP's ``Inputs`` in the order it made them: the
    params, the bank, the initial episodes', then per checked step the
    chunk's draws and ``epochs`` roll offsets of the flat batch."""
    gen = torch.Generator().manual_seed(seed)
    out = {"params": frozen_params(s.policy, gen)}
    out["bank"] = (inputs.make_bank(s.bank, s.env, gen)
                   if s.bank is not None else None)
    out["u_src"] = torch.rand(s.num_envs, 2, generator=gen)
    out["bits"] = inputs.random_bits((s.num_envs,), gen)
    out["u_wind"] = (torch.rand(s.num_envs, 2, generator=gen)
                     if inputs.reads_wind(s.env) else None)
    out["steps"] = []
    for _ in range(steps):
        draws = inputs.chunk_draws(s.env, s.unroll_length, s.num_envs, gen)
        offsets = torch.randint(0, s.num_envs * s.unroll_length, (s.epochs,),
                                generator=gen).tolist()
        out["steps"].append((draws, offsets))
    return out


def same(a, b) -> bool:
    if a is None or b is None:
        return a is None and b is None
    return a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_mlp_inputs_are_the_frozen_draws(cell):
    s = registry.spec(cell, CELLS[cell])
    seed = 2**31 + 41
    want = frozen_draws(s, seed, 3)
    got = inputs.Inputs(s, seed, "cpu")
    assert list(got.params) == list(want["params"])
    for name, x in want["params"].items():
        assert same(got.params[name], x), name
    if want["bank"] is None:
        assert got.bank is None
    else:
        for k in ("conc", "source", "wind"):
            assert same(got.bank[k], want["bank"][k]), k
    for k in ("u_src", "bits", "u_wind"):
        assert same(getattr(got, k), want[k]), k
    for k, (draws, offsets) in enumerate(want["steps"]):
        got_draws, got_offsets = got.step(k)
        assert got_offsets == offsets
        assert set(got_draws) == set(draws)
        for key, x in draws.items():
            assert same(got_draws[key], x), (k, key)


def test_policy_follows_the_program_architecture(tmp_path, monkeypatch):
    recurrent.install(tmp_path, monkeypatch)
    for cell in recurrent.CELLS:
        s = registry.spec(cell)
        assert s.ppo()["arch"] == "lstm"
        want = tmp_path / "reference" / "policy_lstm.py"
        assert registry.reference_policy(s).__file__ == str(want)
    s = registry.spec("ppo_v2_0.train.n16384")
    assert registry.reference_policy(s).__file__.endswith("policy_mlp.py")
    # a traffic mix whose PPO fields turn the MLP's program recurrent
    (tmp_path / "traffic" / "train-lstm.json").write_text(json.dumps(
        {"why": "x", "num_envs": 64, "unroll_length": 8, "epochs": 2,
         "minibatches_per_epoch": 4, "sync_every": 2,
         "ppo": {"arch": "lstm"}}))
    (tmp_path / "workloads" / "ppo_v2_0.train-lstm.json").write_text(
        json.dumps({"config": "ppo_v2_0", "traffic": "train-lstm",
                    "chips": 1, "checked_steps": 1,
                    "limits": recurrent.LIMITS[next(iter(recurrent.CELLS))]}))
    s = registry.spec("ppo_v2_0.train-lstm")
    assert registry.reference_policy(s).__file__.endswith("policy_lstm.py")
    # an architecture with no reference policy
    cfg = recurrent.config(False)
    cfg["ppo"] = dict(cfg["ppo"], arch="gru")
    (tmp_path / "configs" / "ppo_v2_0_lstm.json").write_text(json.dumps(cfg))
    s = registry.spec("ppo_v2_0_lstm.train.n16384")
    with pytest.raises(KeyError, match="no reference policy 'gru'"):
        registry.reference_policy(s)


def test_policy_macs_by_hand(tmp_path, monkeypatch):
    s = registry.spec("ppo_v2_0.train.n16384")
    assert registry.reference_policy(s).macs_per_row(s) == 35072
    recurrent.install(tmp_path, monkeypatch)
    # 6 -> 128 encoder, 128 -> 512 input side, 128 -> 512 hidden side,
    # 128 -> {5, 1}: 768 + 65536 + 65536 + 768 multiply-adds a row, in
    # either cell (the LayerNorms are not products)
    for cell in recurrent.CELLS:
        s = registry.spec(cell)
        assert registry.reference_policy(s).macs_per_row(s) == 132608
