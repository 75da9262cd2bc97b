"""The plain LSTM cell's recurrence over a BPTT chunk as one autograd
Function, with a hand-written backward.

``lstm_sequence(cell, carry, xi, resets)`` -> ``(hs, (c, h))`` runs
``models.recurrent.LSTMCell`` (flax's ``OptimizedLSTMCell``) over T steps,
as ``models.recurrent.cell_loop`` does: before step t the carry is zeroed
where ``resets[t]``, then

    z = h @ W_hh^T + b + xi[t];  i, f, g, o = z in four, in that order
    c = sigmoid(f) c + sigmoid(i) tanh(g);  h = sigmoid(o) tanh(c)

``xi`` f32[T, N, 4H] is the input-side product, ``resets`` bool[T, N]
(each step's row contiguous: a minibatch's column slice of the batch's
resets will do), ``carry`` the ``(c, h)`` f32[N, H] entering step 0; ``hs`` f32[T, N, H]
holds each step's h and ``(c, h)`` is the carry after step T - 1.  The
gradients reach ``xi``, the carry, ``cell.hh.weight`` and
``cell.hh.bias``.

Each step's product ``h @ W_hh^T + b`` is ``torch.addmm`` into one
preallocated buffer, the call the eager cell makes; its gate arithmetic is
one launch of ``lstm_step_fwd_kernel`` (``csrc/lstm.cu``).  The backward
walks the steps from T - 1 down to 0: one product ``dz_{t+1} @ W_hh`` and
one launch of ``lstm_step_bwd_kernel``, which writes dz_t into a [T, N, 4H]
buffer, the gradient of ``xi``.  The weight's gradient is then one product
``dz^T @ h_in`` over all T x N rows (``h_in``: the masked h entering each
step, which the forward keeps) and the bias's one reduction, in place of a
product and a sum a step.  So a step is four launches, forward and
backward, against about 38 of the eager loop's ops.

The kernels replace no TPU kernel (the JAX package leaves the replay's scan
to XLA); they are bound by bytes, and their design fuses each step's
pointwise chain (``csrc/lstm.cu``'s note).  On CUDA f32 tensors
``lstm_sequence`` launches them or raises; on CPU tensors it runs
``lstm_sequence_plain``, the same loop, products and backward with each
step's arithmetic in PyTorch ops, which is also the kernels' yardstick on
the card.  It takes nothing else: another cell, another dtype or another
device raises.  Both launch on the current stream and allocate only
through PyTorch, so a CUDA graph captures them.

``fwd_launches`` and ``bwd_launches`` count the launches of the two
kernels (T each a call, forward and backward), so that a run can show
that its replays went through them; a replay of a CUDA graph that
captured a call launches without calling the wrapper, and
``rl.ppo.RecurrentGraph`` adds the captured launches itself.
"""

from __future__ import annotations

import ctypes
import types

import torch
from torch.autograd.function import once_differentiable

GATES = 4

fwd_launches = 0
bwd_launches = 0


def supports(cell: torch.nn.Module) -> bool:
    """True for ``models.recurrent.LSTMCell`` itself (a subclass may change
    its arithmetic) with f32 parameters: the cell the kernels compute."""
    from tpu_plume_torch.models.recurrent import LSTMCell

    return type(cell) is LSTMCell and cell.hh.weight.dtype == torch.float32


def _plain_fwd(t: int, b) -> None:
    """Step t's gate arithmetic in PyTorch ops, the eager cell's."""
    z = b.z + b.xi[t]
    i, f, g, o = z.chunk(GATES, -1)
    c = b.c0 if t == 0 else b.cs[t - 1]
    c = torch.where(b.resets[t][:, None], 0.0, c)
    si, sf, tg, so = (torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g),
                      torch.sigmoid(o))
    c = sf * c + si * tg
    h = so * torch.tanh(c)
    torch.cat((si, sf, tg, so), -1, out=b.act[t])
    b.cs[t].copy_(c)
    b.hs[t].copy_(h)
    if t + 1 < b.steps:
        b.h_in[t + 1].copy_(torch.where(b.resets[t + 1][:, None], 0.0, h))


def _plain_bwd(t: int, b) -> None:
    """Step t's backward in PyTorch ops, with the kernel's formulas: dz_t
    into ``b.dz[t]``, ``b.dc`` from c_t's gradient to c_{t-1}'s."""
    dh = torch.zeros_like(b.dc) if b.dhs is None else b.dhs[t]
    if t + 1 < b.steps:
        dh = dh + torch.where(b.resets[t + 1][:, None], 0.0, b.rec)
    si, sf, tg, so = b.act[t].chunk(GATES, -1)
    tc = torch.tanh(b.cs[t])
    c = b.c0 if t == 0 else b.cs[t - 1]
    c = torch.where(b.resets[t][:, None], 0.0, c)
    d = b.dc + (dh * so) * (1.0 - tc * tc)
    torch.cat((((d * tg) * (1.0 - si)) * si,
               ((d * c) * (1.0 - sf)) * sf,
               (d * si) * (1.0 - tg * tg),
               ((dh * tc) * (1.0 - so)) * so), -1, out=b.dz[t])
    b.dc.copy_(torch.where(b.resets[t][:, None], 0.0, d * sf))


_entries = None   # the loaded C entry points, set at first launch


def _library():
    global _entries
    if _entries is None:
        from tpu_plume_torch.ops import build

        lib = build.load("lstm")
        fwd = lib.lstm_step_fwd
        fwd.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 3 + [
            ctypes.c_void_p]
        fwd.restype = ctypes.c_int
        bwd = lib.lstm_step_bwd
        bwd.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 3 + [
            ctypes.c_void_p]
        bwd.restype = ctypes.c_int
        _entries = (fwd, bwd)
    return _entries


def _ptr(x: torch.Tensor | None, t: int = -1) -> int | None:
    """The address of ``x`` (``x[t]`` for t >= 0, ``x`` contiguous), or
    None."""
    if x is None:
        return None
    if t < 0:
        return x.data_ptr()
    return x.data_ptr() + t * x.stride(0) * x.element_size()


def _vec(b, *tensors) -> int:
    """4 when H is a multiple of 4 and every base address 16-byte aligned,
    so that every step's slice is too; else 1."""
    if b.h % 4 or any(x.data_ptr() % 16 for x in tensors if x is not None):
        return 1
    return 4


def _cuda_fwd(t: int, b) -> None:
    global fwd_launches
    last = t + 1 == b.steps
    err = _library()[0](
        _ptr(b.z), _ptr(b.xi, t), _ptr(b.c0) if t == 0 else _ptr(b.cs, t - 1),
        _ptr(b.resets, t), None if last else _ptr(b.resets, t + 1),
        _ptr(b.act, t), _ptr(b.cs, t), _ptr(b.hs, t),
        None if last else _ptr(b.h_in, t + 1), b.n, b.h, b.vec, b.stream)
    if err != 0:
        raise RuntimeError(f"lstm_step_fwd_kernel launch failed: cudaError "
                           f"{err}")
    fwd_launches += 1


def _cuda_bwd(t: int, b) -> None:
    global bwd_launches
    last = t + 1 == b.steps
    err = _library()[1](
        _ptr(b.dhs, t), None if last else _ptr(b.rec),
        None if last else _ptr(b.resets, t + 1), _ptr(b.act, t),
        _ptr(b.cs, t), _ptr(b.c0) if t == 0 else _ptr(b.cs, t - 1),
        _ptr(b.resets, t), _ptr(b.dc), _ptr(b.dz, t), b.n, b.h, b.vec,
        b.stream)
    if err != 0:
        raise RuntimeError(f"lstm_step_bwd_kernel launch failed: cudaError "
                           f"{err}")
    bwd_launches += 1


_PLAIN = (_plain_fwd, _plain_bwd)
_CUDA = (_cuda_fwd, _cuda_bwd)


def _stream(x: torch.Tensor):
    return torch.cuda.current_stream().cuda_stream if x.is_cuda else None


class _Recurrence(torch.autograd.Function):
    """(hs, c after the last step) of the chunk, its steps' gate arithmetic
    by ``steps`` (``_PLAIN`` or ``_CUDA``)."""

    @staticmethod
    def forward(ctx, steps, xi, resets, c0, h0, weight, bias):
        T, n, g = xi.shape
        h = g // GATES
        new = lambda *shape: torch.empty(shape, dtype=xi.dtype,
                                         device=xi.device)
        b = types.SimpleNamespace(
            steps=T, n=n, h=h, xi=xi, resets=resets, c0=c0, z=new(n, g),
            h_in=new(T, n, h), cs=new(T, n, h), hs=new(T, n, h),
            act=new(T, n, g), stream=_stream(xi))
        b.vec = _vec(b, xi, c0, b.z, b.h_in, b.cs, b.hs, b.act)
        b.h_in[0].copy_(torch.where(resets[0][:, None], 0.0, h0))
        weight_t = weight.t()
        for t in range(T):
            torch.addmm(bias, b.h_in[t], weight_t, out=b.z)
            steps[0](t, b)
        ctx.steps = steps
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(resets, c0, weight, b.h_in, b.cs, b.act)
        return b.hs, b.cs[T - 1]

    @staticmethod
    @once_differentiable
    def backward(ctx, dhs, dc_last):
        resets, c0, weight, h_in, cs, act = ctx.saved_tensors
        T, n, h = cs.shape
        b = types.SimpleNamespace(
            steps=T, n=n, h=h, resets=resets, c0=c0, cs=cs, act=act,
            dhs=None if dhs is None else dhs.contiguous(),
            dc=(torch.zeros_like(c0) if dc_last is None
                else dc_last.contiguous().clone()),
            dz=torch.empty_like(act), rec=torch.empty_like(c0),
            stream=_stream(act))
        b.vec = _vec(b, c0, cs, act, b.dhs, b.dc, b.dz, b.rec)
        for t in range(T - 1, -1, -1):
            if t + 1 < T:
                torch.mm(b.dz[t + 1], weight, out=b.rec)
            ctx.steps[1](t, b)
        need = ctx.needs_input_grad
        rows = b.dz.view(T * n, GATES * h)
        d_h0 = (torch.where(resets[0][:, None], 0.0, b.dz[0] @ weight)
                if need[4] else None)
        d_weight = rows.t() @ h_in.view(T * n, h) if need[5] else None
        d_bias = rows.sum(0) if need[6] else None
        return (None, b.dz, None, b.dc if need[3] else None, d_h0, d_weight,
                d_bias)


def _check(cell, carry, xi: torch.Tensor, resets: torch.Tensor) -> None:
    if not supports(cell):
        raise TypeError(f"lstm_sequence computes models.recurrent.LSTMCell "
                        f"in f32, got {type(cell).__name__} with "
                        f"{cell.hh.weight.dtype} weights")
    if xi.dim() != 3:
        raise ValueError(f"xi must be [T, N, 4H], got {tuple(xi.shape)}")
    T, n, g = xi.shape
    weight, bias = cell.hh.weight, cell.hh.bias
    h = weight.shape[1]
    want = (("xi", xi, torch.float32, (T, n, GATES * h)),
            ("resets", resets, torch.bool, (T, n)),
            ("carry c", carry[0], torch.float32, (n, h)),
            ("carry h", carry[1], torch.float32, (n, h)),
            ("hh.weight", weight, torch.float32, (GATES * h, h)),
            ("hh.bias", bias, torch.float32, (GATES * h,)))
    for name, t, dtype, shape in want:
        if t.device != xi.device:
            raise ValueError(f"{name} is on {t.device}, xi on {xi.device}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got "
                             f"{tuple(t.shape)}")
        if t is resets:
            # a column slice of a wider batch's resets will do: a step is
            # a row
            if n > 1 and t.stride(1) != 1:
                raise ValueError("each step's row of resets must be "
                                 "contiguous")
        elif not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if T < 1 or n < 1:
        raise ValueError(f"xi must hold at least one step and row, got "
                         f"{tuple(xi.shape)}")


def _run(steps, cell, carry, xi, resets):
    hs, c = _Recurrence.apply(steps, xi, resets, carry[0], carry[1],
                              cell.hh.weight, cell.hh.bias)
    return hs, (c, hs[-1])


def lstm_sequence_plain(cell, carry, xi: torch.Tensor, resets: torch.Tensor):
    """``lstm_sequence`` with each step's arithmetic in PyTorch ops, on any
    device."""
    _check(cell, carry, xi, resets)
    return _run(_PLAIN, cell, carry, xi, resets)


def lstm_sequence(cell, carry, xi: torch.Tensor, resets: torch.Tensor):
    """(hs f32[T, N, H], carry after the last step) of ``cell`` over the
    chunk: the kernels for CUDA tensors, ``lstm_sequence_plain`` for CPU
    tensors; anything else raises."""
    _check(cell, carry, xi, resets)
    if xi.device.type == "cpu":
        return _run(_PLAIN, cell, carry, xi, resets)
    if xi.device.type != "cuda":
        raise ValueError(f"lstm_sequence takes CPU or CUDA tensors, got "
                         f"{xi.device}")
    if xi.device.index != torch.cuda.current_device():
        raise ValueError(f"tensors on {xi.device}, current device is "
                         f"cuda:{torch.cuda.current_device()}")
    return _run(_CUDA, cell, carry, xi, resets)
