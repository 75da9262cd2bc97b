"""The frozen counts of bytes, operations and FLOPs, pinned to hand-worked
values at small shapes."""

import math

import pytest
import torch

from plumebench import counts


def test_env_step_bytes_by_hand():
    # ppo_v2_0: 5 actions, 2-D, 6 obs, a 10 x 10 visit grid.  Per env:
    # reads 40 + 4 + 8 + 8 + 4 + 4 + 8 + 4 + 16 + 24 = 120, trajectory 33,
    # record 49, state 80: 282, plus the visit cell's 4 B of an env that
    # does not finish, or the reset's 24 B and the 400 B grid of one that
    # does.
    assert counts.env_step_bytes(5, 2, 6, 10, 1, 0) == 286
    assert counts.env_step_bytes(5, 2, 6, 10, 1, 1) == 706
    assert counts.env_step_bytes(5, 2, 6, 10, 4096, 0) == 1171456
    assert counts.env_step_ops(2, 1) == 2 * 203 + 113


def test_env_step_bytes_agree_with_the_port():
    from tpu_plume_torch.core.config import get_preset
    from tpu_plume_torch.ops import plume

    cfg = get_preset("ppo_v2_0").env
    for n, d in ((1, 0), (4096, 17), (16384, 300)):
        assert counts.env_step_bytes(5, 2, 6, 10, n, d) == plume.env_step_bytes(
            cfg, n, d, greedy=False)


def test_bank_sample_bytes_by_hand():
    # a [1, 2, 2, 2, 2] bank has 16 cells; a query at step 0 reads frames 0
    # and 1, both levels, all four corners: every cell once.
    shape = (1, 2, 2, 2, 2)
    rows = torch.zeros(1, dtype=torch.int32)
    pos = torch.tensor([[0.5, 0.5, 0.0]])
    t = torch.zeros(1, dtype=torch.int32)
    assert counts.bank_sample_bytes(shape, 1.0, 1.0, rows, pos, t) == 32 + 64
    two = counts.bank_sample_bytes(shape, 1.0, 1.0, rows.repeat(2),
                                   pos.repeat(2, 1), t.repeat(2))
    assert two == 2 * 32 + 64
    # a [2, 4, 3, 5, 5] bank: one query in row 1 at step 5 (frame 5 / 2 =
    # 2.5: frames 2 and 3) and height 0.25 (level 0.5: levels 0 and 1) at
    # (1.5, 2.5): 2 frames x 2 levels x 4 corners = 16 cells.
    one = counts.bank_sample_bytes((2, 4, 3, 5, 5), 2.0, 1.0,
                                   torch.tensor([1], dtype=torch.int32),
                                   torch.tensor([[1.5, 2.5, 0.25]]),
                                   torch.tensor([5], dtype=torch.int32))
    assert one == 32 + 4 * 16


def test_bank_sample_bytes_agree_with_the_port():
    from tpu_plume_torch.core.config import get_preset
    from tpu_plume_torch.fields.gridded import FieldBank
    from tpu_plume_torch.ops import gather

    g = torch.Generator().manual_seed(3)
    conc = torch.rand(3, 4, 5, 40, 40, generator=g)
    bank = FieldBank(conc=conc, source=torch.zeros(3, 2), steps_per_frame=7.0,
                     z_extent=100.0)
    cfg = get_preset("wrf_les_3d").env
    n = 300
    rows = torch.randint(0, 3, (n,), dtype=torch.int32, generator=g)
    pos = torch.rand(n, 3, generator=g) * torch.tensor([45.0, 45.0, 110.0]) - 2
    t = torch.randint(0, 40, (n,), dtype=torch.int32, generator=g)
    assert counts.bank_sample_bytes(tuple(conc.shape), 7.0, 100.0, rows, pos,
                                    t) == gather.sample_moved_bytes(
        bank, rows, pos, t, cfg)


def test_flops_and_ppo_bound_by_hand():
    # 6 -> 256 -> 128 -> {5, 1}: 1536 + 32768 + 768 multiply-adds a row
    assert counts.mlp_macs(6, [256, 128], 5) == 35072
    # n 2, t 3, 5 epochs: 6 + 2 rollout and bootstrap rows, 3 x 5 x 6
    assert counts.train_flops(35072, 2, 3, 5) == 2 * 35072 * 98
    # the recurrent policy at E = H = 128: 6 128 + 128 512 + 128 512
    # + 128 (5 + 1)
    assert counts.lstm_macs(6, 128, 128, 5) == 768 + 65536 + 65536 + 768
    # one row: 48 B of batch, 36230 params read and written (289840 B)
    want = 289888 / counts.HBM_BYTES_PER_S
    assert math.isclose(counts.ppo_bound_seconds(1, 6, 256, 128, 5), want)
    # 2^20 rows are bound by operations: 215808 a row
    assert math.isclose(counts.ppo_bound_seconds(2**20, 6, 256, 128, 5),
                        2**20 * 215808 / counts.F32_OPS_PER_S)


@pytest.mark.parametrize("n", [1, 7])
def test_least_seconds(n):
    assert counts.least_seconds(n * 3.35e12) == pytest.approx(n)
    assert counts.least_seconds(0, n * 67e12) == pytest.approx(n)
