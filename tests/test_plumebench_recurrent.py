"""The benchmark's recurrent cell ``ppo_v2_0_lstm.train.n16384`` on the CPU
at N = 32, T = 8, on seeded random weights, with its own configuration and
limits: the program's checked steps equal the plain PPO-LSTM reference's
(``plumebench/reference/policy_lstm.py``) bit for bit, the cell comes out
``correct`` when sound, and not ``correct`` with half of each sequence
minibatch's envs left out of the loss."""

import torch

from plumebench import check, harness, registry
from plumebench.inputs import Inputs
from plumebench.reference import train as reference

CELL = "ppo_v2_0_lstm.train.n16384"
SMALL = {"num_envs": 32, "unroll_length": 8}
SEED = 2**31 + 23


def test_the_cell_is_the_recurrent_policy_on_ppo_v2_0():
    s = registry.spec(CELL)
    mlp = registry.spec("ppo_v2_0.train.n16384")
    assert s.ppo()["arch"] == "lstm" and not s.ppo()["lstm_layer_norm"]
    assert s.policy == {"obs_dim": 6, "embed": 128, "hidden": 128,
                        "num_actions": 5}
    assert s.env == mlp.env and s.traffic == mlp.traffic
    assert s.config["curriculum"] == mlp.config["curriculum"]
    assert {k: v for k, v in s.ppo().items() if not k.startswith("lstm")
            and k != "arch"} == {k: v for k, v in mlp.ppo().items()
                                 if not k.startswith("lstm") and k != "arch"}
    assert s.minibatch_size // s.unroll_length == 2048
    assert s.checked_steps == 3 and set(s.limits) == set(check.NAMES)
    assert registry.reference_policy(s).__file__.endswith("policy_lstm.py")


def test_checked_steps_equal_the_reference():
    s = registry.spec(CELL, SMALL)
    # 5-step episodes: the chunks' carries are zeroed at their ends and
    # the replays restart there
    s.config = dict(s.config, env=dict(s.env, max_steps=5))
    cpu = torch.device("cpu")
    prog = harness.build(s, SEED, cpu)
    got = harness.checked_steps(prog, s.checked_steps)
    assert prog.loop.rollout.hidden is not None
    want = reference.run(s, registry.reference_field(s),
                         registry.reference_policy(s), Inputs(s, SEED, cpu),
                         s.checked_steps)
    assert got["losses"] == want["losses"]
    d = check.details(got, want)
    for key in ("first_grad", "first_moment", "change"):
        assert max(d[key].values()) == 0.0, (key, d[key])
    assert len(got["first_grad"]) == len(want["first_grad"]) == 11


def run():
    return harness.run(registry.spec(CELL, SMALL), SEED, 0.05, False, "cpu",
                       0.0)


def test_sound_cell_is_correct():
    out = run()
    assert out["result"]["correct"] is True, out["checks"]


def test_half_of_each_minibatch_is_not_correct(monkeypatch):
    from tpu_plume_torch.rl import ppo

    loss = ppo.ppo_loss_recurrent
    monkeypatch.setattr(ppo, "ppo_loss_recurrent",
                        lambda m, b, c, s=None: loss(
                            m, b.envs(slice(0, b.obs.shape[1] // 2)), c, s))
    out = run()
    assert out["result"]["correct"] is False, out["checks"]
