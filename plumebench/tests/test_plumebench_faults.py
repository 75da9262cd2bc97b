"""A run with the timed path broken underneath comes out not correct, past
the harness's look for a card, on the CPU at a tiny size: an update that
leaves the state unchanged, half of each minibatch left out with the mean
over the rest, and the rollout's rewards altered where they are produced.
(One chip: no exchange between chips to leave out.)  The same run with
nothing broken comes out correct.  And the control (the reference in TF32,
put in the program's place) fails a limit, on the CPU with TF32's rounding
and on the card in TF32."""

import pytest
import torch

from plumebench import check, harness, registry
from plumebench.inputs import Inputs
from plumebench.reference import train as reference

CELLS = {"ppo_v2_0.train.n16384": {"num_envs": 64, "unroll_length": 8},
         "ppo_v2_0.train-fused.n16384": {"num_envs": 128, "unroll_length": 8},
         "wrf_les_3d.train.n32768": {"num_envs": 64, "unroll_length": 8,
                                     "bank": {"fields": 2, "frames": 3,
                                              "levels": 2}}}


def frozen(monkeypatch):
    from tpu_plume_torch.train import ppo_trainer

    monkeypatch.setattr(ppo_trainer.ClippedAdam, "step", lambda self: None)


def half_batch(monkeypatch):
    from tpu_plume_torch.ops import ppo as fused
    from tpu_plume_torch.rl import ppo

    loss, grads = ppo.ppo_loss, fused.fused_ppo_grads

    def half(batch):
        n = batch.obs.shape[0] // 2
        return batch.map(lambda x: x[:n])

    monkeypatch.setattr(ppo, "ppo_loss", lambda m, b, c, s=None: loss(
        m, half(b), c, s))
    monkeypatch.setattr(fused, "fused_ppo_grads",
                        lambda m, b, c: grads(m, half(b), c))


def altered_rewards(monkeypatch):
    from tpu_plume_torch.train import ppo_trainer

    chunk = ppo_trainer.rollout_chunk

    def altered(*a, **k):
        carry, traj, boot = chunk(*a, **k)
        traj.reward[-1] += 1.0
        return carry, traj, boot

    monkeypatch.setattr(ppo_trainer, "rollout_chunk", altered)


FAULTS = {"frozen": frozen, "half_batch": half_batch,
          "altered_rewards": altered_rewards}


def run(cell):
    s = registry.spec(cell, CELLS[cell])
    return harness.run(s, 2**31 + 99, 0.05, False, "cpu", 0.0)


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_broken_path_is_not_correct(cell, fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    out = run(cell)
    assert out["result"]["correct"] is False, out["checks"]


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_sound_path_is_correct(cell):
    out = run(cell)
    assert out["result"]["correct"] is True, out["checks"]


def control(cell, device, overrides):
    s = registry.spec(cell, overrides)
    field = registry.reference_field(s)
    harness.set_precision()
    want = reference.run(s, field, Inputs(s, 2**31 + 7, device),
                         s.checked_steps)
    got = reference.run(s, field, Inputs(s, 2**31 + 7, device),
                        s.checked_steps, "tf32")
    return check.verdict(check.readings(got, want), s.limits)


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_control_fails_on_cpu(cell):
    ok, checks = control(cell, "cpu", dict(CELLS[cell], num_envs=256))
    assert not ok, checks


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_control_fails_on_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    ok, checks = control(cell, "cuda", {"num_envs": 4096})
    assert not ok, checks
