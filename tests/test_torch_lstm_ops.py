"""The LSTM recurrence as one autograd Function (``ops/lstm.py``) on the
CPU: ``lstm_sequence_plain``, the CUDA kernels' plain version with the
same loop, products and hand-written backward, against autodiff through
the eager loop (``models.recurrent.cell_loop``), and the dispatch of
``sequence``.

Tolerances: outputs and gradients at rtol 1e-5, atol 1e-6 (the port's f32
forward parity).  The forward repeats the loop's ops; the backward sums
the weight's and the bias's gradients over all T x N rows at once where
autodiff sums a step at a time, and adds the two gradients of each h and c
in its own order.
"""

import pytest
import torch

from tpu_plume_torch.models import recurrent
from tpu_plume_torch.models.recurrent import LayerNormLSTMCell, LSTMCell, RecurrentActorCritic
from tpu_plume_torch.ops import lstm as lstm_ops

RTOL, ATOL = 1e-5, 1e-6


def _inputs(n, t, h, seed):
    """A cell, xi [T, N, 4H], resets [T, N] set at several steps (step 0
    and the last among them) and a nonzero initial carry."""
    g = torch.Generator().manual_seed(seed)
    cell = LSTMCell(8, h)
    cell.reset_parameters(g)
    with torch.no_grad():
        cell.hh.bias.normal_(0.0, 0.5, generator=g)
    xi = torch.randn(t, n, 4 * h, generator=g)
    resets = torch.rand(t, n, generator=g) < 0.2
    resets[0, : n // 3] = True
    resets[-1, n // 2:] = True
    carry = tuple(torch.randn(n, h, generator=g) for _ in range(2))
    return cell, xi, resets, carry


def _grads(fn, cell, xi, resets, carry, with_carry, seed):
    """The outputs of ``fn`` and the gradients of a random linear function
    of hs (and of the carry after the last step) with respect to xi, the
    initial carry and the cell's recurrent weight and bias."""
    xi = xi.clone().requires_grad_(True)
    carry = tuple(x.clone().requires_grad_(True) for x in carry)
    cell.zero_grad(set_to_none=True)
    hs, (c, h) = fn(cell, carry, xi, resets)
    g = torch.Generator().manual_seed(seed)
    loss = (hs * torch.randn(hs.shape, generator=g)).sum()
    if with_carry:
        loss = loss + (c * torch.randn(c.shape, generator=g)).sum() + (
            h * torch.randn(h.shape, generator=g)).sum()
    loss.backward()
    return {"hs": hs.detach(), "c": c.detach(), "h": h.detach(),
            "xi": xi.grad, "c0": carry[0].grad, "h0": carry[1].grad,
            "weight": cell.hh.weight.grad, "bias": cell.hh.bias.grad}


def _loop(cell, carry, xi, resets):
    return recurrent.cell_loop(cell, carry, xi, resets, torch.float32)


@pytest.mark.parametrize("with_carry", [False, True],
                         ids=["hs", "hs_and_carry"])
@pytest.mark.parametrize("n, t, h", [(32, 8, 16), (7, 5, 6)])
def test_plain_recurrence_matches_autodiff_through_the_loop(n, t, h,
                                                            with_carry):
    cell, xi, resets, carry = _inputs(n, t, h, seed=n + t + h)
    want = _grads(_loop, cell, xi, resets, carry, with_carry, seed=1)
    got = _grads(lstm_ops.lstm_sequence_plain, cell, xi, resets, carry,
                 with_carry, seed=1)
    assert want.keys() == got.keys()
    for key in want:
        if not with_carry and key in ("c", "h"):
            continue
        torch.testing.assert_close(got[key], want[key], rtol=RTOL, atol=ATOL,
                                   msg=key)
    # every reset row of step 0 passes no gradient to the initial carry
    assert not got["c0"][resets[0]].any()
    assert not got["h0"][resets[0]].any()


def test_lstm_sequence_on_cpu_is_the_plain_version_and_launches_nothing():
    cell, xi, resets, carry = _inputs(16, 6, 8, seed=3)
    before = lstm_ops.fwd_launches, lstm_ops.bwd_launches
    want = _grads(lstm_ops.lstm_sequence_plain, cell, xi, resets, carry,
                  True, seed=2)
    got = _grads(lstm_ops.lstm_sequence, cell, xi, resets, carry, True,
                 seed=2)
    for key in want:
        assert torch.equal(got[key], want[key]), key
    assert (lstm_ops.fwd_launches, lstm_ops.bwd_launches) == before


@pytest.mark.parametrize("layer_norm_cell", [False, True], ids=["plain", "ln"])
def test_sequence_on_cpu_takes_the_loop(monkeypatch, layer_norm_cell):
    """On the CPU ``sequence`` runs ``cell_loop`` whatever the cell: no
    call of the wrapper, no launch counted, T replayed steps."""
    def refuse(*args):
        raise AssertionError("lstm_sequence called on the CPU")

    monkeypatch.setattr(lstm_ops, "lstm_sequence", refuse)
    model = RecurrentActorCritic(6, 5, 8, 8, layer_norm_cell=layer_norm_cell)
    model.reset_parameters(torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    obs = torch.randn(5, 4, 6, generator=g)
    resets = torch.rand(5, 4, generator=g) < 0.3
    carry = model.initial_state(4)
    before = (lstm_ops.fwd_launches, lstm_ops.bwd_launches,
              recurrent.replayed_steps)
    (c, h), logits, values = model.sequence(carry, obs, resets)
    (logits.sum() + values.sum()).backward()
    assert (lstm_ops.fwd_launches, lstm_ops.bwd_launches) == before[:2]
    assert recurrent.replayed_steps == before[2] + 5
    hs, (wc, wh) = recurrent.cell_loop(
        model.cell, carry, model._input_product(obs), resets, model.dtype)
    want_logits, want_values = model._heads(hs)
    for a, b in ((c, wc), (h, wh), (logits, want_logits),
                 (values, want_values)):
        assert torch.equal(a, b)


def test_lstm_sequence_refuses_the_layer_norm_cell():
    cell = LayerNormLSTMCell(8, 8)
    assert not lstm_ops.supports(cell)
    xi = torch.zeros(3, 4, 32)
    carry = (torch.zeros(4, 8), torch.zeros(4, 8))
    with pytest.raises(TypeError, match="LayerNormLSTMCell"):
        lstm_ops.lstm_sequence(cell, carry, xi,
                               torch.zeros(3, 4, dtype=torch.bool))


@pytest.mark.parametrize("what", ["weights", "xi", "carry"])
def test_lstm_sequence_refuses_bf16(what):
    cell, xi, resets, carry = _inputs(4, 3, 8, seed=0)
    if what == "weights":
        cell = cell.to(torch.bfloat16)
    elif what == "xi":
        xi = xi.bfloat16()
    else:
        carry = (carry[0], carry[1].bfloat16())
    with pytest.raises(TypeError, match="float32|bfloat16"):
        lstm_ops.lstm_sequence(cell, carry, xi, resets)


def test_lstm_sequence_refuses_a_subclass_and_bad_inputs():
    class Other(LSTMCell):
        pass

    cell, xi, resets, carry = _inputs(4, 3, 8, seed=0)
    other = Other(8, 8)
    assert lstm_ops.supports(cell) and not lstm_ops.supports(other)
    with pytest.raises(TypeError, match="Other"):
        lstm_ops.lstm_sequence(other, carry, xi, resets)
    with pytest.raises(TypeError, match="resets"):
        lstm_ops.lstm_sequence(cell, carry, xi, resets.float())
    with pytest.raises(ValueError, match="xi must have shape"):
        lstm_ops.lstm_sequence(cell, carry, xi[..., :-1], resets)
    with pytest.raises(ValueError, match="contiguous"):
        lstm_ops.lstm_sequence(cell, carry, xi.transpose(0, 1).contiguous()
                               .transpose(0, 1), resets)
    with pytest.raises(ValueError, match="row of resets must be contiguous"):
        lstm_ops.lstm_sequence(cell, carry, xi,
                               resets.t().contiguous().t())


def test_lstm_sequence_takes_a_column_slice_of_the_resets():
    """The eager update's minibatch is a column slice of the batch: its
    resets' rows are strided, each row contiguous."""
    cell, xi, resets, carry = _inputs(6, 4, 8, seed=5)
    wide = torch.zeros(4, 10, dtype=torch.bool)
    wide[:, 2:8] = resets
    assert not wide[:, 2:8].is_contiguous()
    want = _grads(lstm_ops.lstm_sequence, cell, xi, resets, carry, True, 3)
    got = _grads(lstm_ops.lstm_sequence, cell, xi, wide[:, 2:8], carry, True,
                 3)
    for key in want:
        assert torch.equal(got[key], want[key]), key
