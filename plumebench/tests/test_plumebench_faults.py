"""A run with the timed path broken underneath comes out not correct, past
the harness's look for a card, on the CPU at a tiny size: an update that
leaves the state unchanged, half of each minibatch left out with the mean
over the rest, and the rollout's rewards altered where they are produced.
(One chip: no exchange between chips to leave out.)  The same run with
nothing broken comes out correct.  And the control (the reference in TF32,
put in the program's place) fails a limit, on the CPU with TF32's rounding
and on the card in TF32.  The recurrent policy's cells (plain and LayerNorm
cell, added as files under a temporary root) are held to the same: half
of each sequence minibatch's envs left out."""

import pytest
import torch

from plumebench import check, harness, registry
from plumebench.inputs import Inputs
from plumebench.reference import train as reference
from plumebench.tests import recurrent

CELLS = {"ppo_v2_0.train.n16384": {"num_envs": 64, "unroll_length": 8},
         "ppo_v2_0.train-fused.n16384": {"num_envs": 128, "unroll_length": 8},
         "wrf_les_3d.train.n32768": {"num_envs": 64, "unroll_length": 8,
                                     "bank": {"fields": 2, "frames": 3,
                                              "levels": 2}},
         **{cell: {"num_envs": 64, "unroll_length": 8}
            for cell in recurrent.CELLS}}


@pytest.fixture
def room(tmp_path, monkeypatch):
    """The registry with the recurrent cells added as files."""
    recurrent.install(tmp_path, monkeypatch)


def frozen(monkeypatch):
    from tpu_plume_torch.train import ppo_trainer

    monkeypatch.setattr(ppo_trainer.ClippedAdam, "step", lambda self: None)


def half_batch(monkeypatch):
    from tpu_plume_torch.ops import ppo as fused
    from tpu_plume_torch.rl import ppo

    loss, grads = ppo.ppo_loss, fused.fused_ppo_grads
    recurrent_loss = ppo.ppo_loss_recurrent

    def half(batch):
        n = batch.obs.shape[0] // 2
        return batch.map(lambda x: x[:n])

    def half_envs(batch):
        return batch.envs(slice(0, batch.obs.shape[1] // 2))

    monkeypatch.setattr(ppo, "ppo_loss", lambda m, b, c, s=None: loss(
        m, half(b), c, s))
    monkeypatch.setattr(fused, "fused_ppo_grads",
                        lambda m, b, c: grads(m, half(b), c))
    monkeypatch.setattr(ppo, "ppo_loss_recurrent",
                        lambda m, b, c, s=None: recurrent_loss(
                            m, half_envs(b), c, s))


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
def test_broken_path_is_not_correct(cell, fault, monkeypatch, room):
    FAULTS[fault](monkeypatch)
    out = run(cell)
    assert out["result"]["correct"] is False, out["checks"]


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_sound_path_is_correct(cell, room):
    out = run(cell)
    assert out["result"]["correct"] is True, out["checks"]


def control(cell, device, overrides, variant="tf32"):
    s = registry.spec(cell, overrides)
    field, policy = registry.reference_field(s), registry.reference_policy(s)
    harness.set_precision()
    want = reference.run(s, field, policy, Inputs(s, 2**31 + 7, device),
                         s.checked_steps)
    got = reference.run(s, field, policy, Inputs(s, 2**31 + 7, device),
                        s.checked_steps, variant)
    return check.verdict(check.readings(got, want), s.limits)


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_control_fails_on_cpu(cell, room):
    ok, checks = control(cell, "cpu", dict(CELLS[cell], num_envs=256))
    assert not ok, checks


@pytest.mark.parametrize("variant", ["half", "reward"])
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_reference_faults_are_not_correct(cell, variant, room):
    """The planted faults of the upper readings, in the reference put in
    the program's place (half of each minibatch's rows, or of a sequence
    minibatch's envs; the last reward row altered)."""
    ok, checks = control(cell, "cpu", CELLS[cell], variant)
    assert not ok, checks


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_control_fails_on_card(cell, room):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    ok, checks = control(cell, "cuda", {"num_envs": 4096})
    assert not ok, checks
