"""The reference against the port's CPU path, two tiny iterations of each
configuration and each update path, from the same inputs (the recurrent
policy's, plain and LayerNorm cell, added as files under a temporary
root); and the inputs made twice from one seed are the same."""

import pytest
import torch

from plumebench import check, harness, registry
from plumebench.inputs import Inputs
from plumebench.reference import train as reference
from plumebench.tests import recurrent

SMALL_BANK = {"fields": 2, "frames": 3, "levels": 2}
CASES = {
    "ppo_v2_0.train.n16384": {"num_envs": 32, "unroll_length": 8},
    "ppo_v2_0.train-fused.n16384": {"num_envs": 128, "unroll_length": 8},
    "wrf_les_3d.train.n32768": {"num_envs": 32, "unroll_length": 8,
                                "bank": SMALL_BANK},
    **{cell: {"num_envs": 32, "unroll_length": 8} for cell in recurrent.CELLS},
}
# The program's leaves: the MLP's 2 x 4 of its trunk and 4 of its heads;
# the recurrent policy's encoder and its norm, the cell's two kernels, its
# bias (plain) or its two LayerNorms (LayerNorm cell), and the heads.
LEAVES = {"ppo_v2_0.train.n16384": 12, "ppo_v2_0.train-fused.n16384": 12,
          "wrf_les_3d.train.n32768": 12, "ppo_v2_0_lstm.train.n16384": 11,
          "ppo_v2_0_lnlstm.train.n16384": 14}


def small(cell, steps=1):
    s = registry.spec(cell, CASES[cell])
    s.workload = dict(s.workload, checked_steps=steps)
    return s


@pytest.mark.parametrize("cell", sorted(CASES))
def test_reference_follows_the_port(cell, tmp_path, monkeypatch):
    if cell in recurrent.CELLS:
        recurrent.install(tmp_path, monkeypatch)
    s = small(cell, steps=2)
    if cell in recurrent.CELLS:
        # 5-step episodes: the chunks' carries are zeroed at their ends and
        # the replays restart there
        s.config = dict(s.config, env=dict(s.env, max_steps=5))
    cpu = torch.device("cpu")
    prog = harness.build(s, 11, cpu)
    got = harness.checked_steps(prog, s.checked_steps)
    want = reference.run(s, registry.reference_field(s),
                         registry.reference_policy(s), Inputs(s, 11, cpu),
                         s.checked_steps)
    d = check.details(got, want)
    if cell in recurrent.CELLS:
        assert prog.loop.rollout.hidden is not None
    # plain PyTorch on both sides, the recurrent replay included: bit-equal,
    # but for the fused gradients' plain version, which sums in the
    # kernel's order
    tol = 1e-5 if "fused" in cell else 0.0
    assert max(d["loss"]) <= tol
    for key in ("first_grad", "first_moment", "change"):
        assert max(d[key].values()) <= tol, (key, d[key])
    assert len(got["first_grad"]) == len(want["first_grad"]) == LEAVES[cell]


def test_inputs_repeat_from_the_seed():
    s = small("wrf_les_3d.train.n32768")
    a, b = Inputs(s, 2**31 + 17, "cpu"), Inputs(s, 2**31 + 17, "cpu")
    for k in a.params:
        assert torch.equal(a.params[k], b.params[k])
    for k in ("conc", "source", "wind"):
        assert torch.equal(a.bank[k], b.bank[k])
    assert torch.equal(a.u_src, b.u_src) and torch.equal(a.bits, b.bits)
    (da, oa), (db, ob) = a.step(0), b.step(0)
    assert oa == ob and all(torch.equal(da[k], db[k]) for k in
                            ("turb_noise", "gumbel", "u_src", "bits"))
    c = Inputs(s, 2**31 + 18, "cpu")
    assert not torch.equal(a.params["feature.0.weight"],
                           c.params["feature.0.weight"])
    with pytest.raises(ValueError, match="out of order"):
        a.step(2)


def test_reference_refuses_what_it_does_not_model():
    s = small("ppo_v2_0.train.n16384")
    s.config = dict(s.config, env=dict(s.env, reward_variant="delta"))
    with pytest.raises(ValueError, match="reward_variant"):
        reference.run(s, registry.reference_field(s),
                      registry.reference_policy(s), Inputs(s, 1, "cpu"), 1)
