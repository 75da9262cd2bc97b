"""Fused PPO minibatch gradients: the port of ``tpu_plume/ops/pallas_ppo.py``.

``fused_ppo_grads(model, batch, cfg)`` returns ``(grads, metrics)`` for one
minibatch of the feedforward ``ActorCritic``

    obs -> Dense(H1) -> LayerNorm -> relu -> Dense(H2) -> LayerNorm -> relu
        -> {Dense(A) logits, Dense(1) value}

under the clipped PPO loss of ``tpu_plume_torch.rl.ppo.ppo_loss``: the
forward pass and a backward pass derived by hand, in one kernel.  ``grads``
maps each parameter name of ``model.named_parameters()`` to its gradient in
the torch layout (Dense weights [out, in]); ``metrics`` holds the loss
metrics of ``ppo_loss`` as 0-d tensors.

On a CUDA tensor it launches the hand-written kernels of
``tpu_plume_torch/csrc/ppo.cu`` or raises: the row kernel (forward, loss
gradients and backward of 32-row tiles, with every gradient but dW2 summed
per block, h1 and dz2 written to a workspace), the split-K dW2 kernel over
that workspace, and the ordered reduction over blocks.  On a CPU tensor it
runs ``fused_ppo_grads_plain``, the kernels' own formulas in plain PyTorch
(not autograd), which is also the yardstick the kernels are held against on
the card.

The kernel's choices are kept as the Pallas kernel makes them: LayerNorm
variance as E[z^2] - E[z]^2 with eps 1e-6; subgradients ``s1 <= s2`` for
the surrogate's minimum, strict bounds for the ratio's clip range and
``e1^2 >= e2^2`` for the value loss's maximum; under ``cfg.bf16_compute``
(and only then: ``bf16_update`` alone runs the kernel in f32, as the JAX
fused path drops the update's bf16 twin) the four forward products round
their operands to bf16 (round to nearest even) and accumulate in f32, while
every backward contraction takes f32 operands.

The plain version sums the bf16 products that feed a bf16 rounding in the
kernel's order (see ``fused_ppo_grads_plain``), so the two agree at the f32
tolerance in both modes.  The kernel reads the actions as i64, the port's dtype (the Pallas
kernel takes i32), and the model's own parameters, so flax params reach it
through ``tpu_plume_torch.convert`` like every other path; there is no
second converter.  ``launches`` counts launches of the row kernel,
``dw2_launches`` those of the dW2 kernel and ``reduce_launches`` those of the
reduction, so a run can show that its minibatch steps went through the
kernels.
"""

from __future__ import annotations

import ctypes

import torch

from tpu_plume_torch.core.config import PPOConfig

LN_EPS = 1e-6

# The parameters of the standard ActorCritic, in the order of the kernel's
# gradient buffer.
PARAM_NAMES = (
    "feature.0.weight", "feature.0.bias", "feature.1.weight", "feature.1.bias",
    "feature.3.weight", "feature.3.bias", "feature.4.weight", "feature.4.bias",
    "actor.weight", "actor.bias", "critic.weight", "critic.bias",
)
METRIC_NAMES = ("loss/total", "loss/policy", "loss/value", "loss/entropy",
                "loss/approx_kl", "loss/clip_frac")
# Rows of one tile of the row kernel (kRows in csrc/ppo.cu).
KERNEL_ROWS = 32
# The dW2 kernel's output tile edge and rows staged per step (kTile,
# kStepRows in csrc/ppo.cu).
DW2_TILE = 128
DW2_STEP_ROWS = 16
# Workspace segments start on 256-byte boundaries (16-byte loads).
_ALIGN = 64

launches = 0
dw2_launches = 0
reduce_launches = 0


def supports(model: torch.nn.Module) -> bool:
    """True when ``model`` has the standard feedforward ActorCritic's
    parameters (two Dense+LayerNorm trunk layers, logits and value heads),
    which the kernel hard-codes, in f32."""
    params = dict(model.named_parameters())
    if set(params) != set(PARAM_NAMES):
        return False
    if params["critic.weight"].shape[0] != 1:
        return False
    return params["feature.0.weight"].dtype == torch.float32


def pick_tile(n: int) -> int:
    """The JAX kernel's row tile for a minibatch of ``n`` rows; 0 means the
    fused path declines the minibatch."""
    for r in (1024, 512, 256, 128):
        if n % r == 0:
            return r
    return 0


def _params(model: torch.nn.Module) -> list[torch.Tensor]:
    params = dict(model.named_parameters())
    return [params[name].detach() for name in PARAM_NAMES]


def _metrics(sums: torch.Tensor, n: int, cfg: PPOConfig) -> dict:
    """The loss metrics from the five per-row sums (policy, value, entropy,
    approx_kl, clip_frac), as ``pallas_ppo.py:321-332`` takes them."""
    inv_n = 1.0 / n
    pol, val, ent = sums[0] * inv_n, sums[1] * inv_n, sums[2] * inv_n
    return {
        "loss/total": pol + val - float(cfg.entropy_beta) * ent,
        "loss/policy": pol,
        "loss/value": val,
        "loss/entropy": ent,
        "loss/approx_kl": sums[3] * inv_n,
        "loss/clip_frac": sums[4] * inv_n,
    }


def _ordered_mm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a[R, K] @ w[N, K]^T in f32, each output summed over k in turn from 0
    with one rounding per step, as the kernel's ``__fmaf_rn`` does: a step
    is ``s + a_k w_k`` in f64, rounded to f32.  The product of two f32
    values is exact in f64, so this is the fused multiply-add's single
    rounding, up to a rare double rounding of the f64 sum."""
    s = torch.zeros(a.shape[0], w.shape[0], dtype=torch.float32,
                    device=a.device)
    a, w = a.double(), w.double()
    for k in range(a.shape[1]):
        s = (s.double() + a[:, k, None] * w[:, k]).float()
    return s


def _lane_mean(t: torch.Tensor) -> torch.Tensor:
    """Mean of each row of t[R, h] in the kernel's order (``warp_sum`` in
    ``layer_norm_rows``): lane l of a warp adds t[:, l], t[:, l + 32], ...
    in turn, the 32 lane sums combine by the xor butterfly 16, 8, 4, 2, 1,
    and the sum is divided by h."""
    r, h = t.shape
    t = torch.nn.functional.pad(t, (0, (-h) % 32)).view(r, -1, 32)
    s = t[:, 0]
    for i in range(1, t.shape[1]):
        s = s + t[:, i]
    lanes = torch.arange(32, device=t.device)
    for m in (16, 8, 4, 2, 1):
        s = s + s[:, lanes ^ m]
    s = s[:, :1]
    return s / torch.full_like(s, h)


@torch.no_grad()
def fused_ppo_grads_plain(model: torch.nn.Module, batch, cfg: PPOConfig):
    """The kernel's function in plain PyTorch: its hand-derived forward and
    backward formulas, with the same roundings.

    Under bf16 compute z1, z2 and the LayerNorm stats are also summed in
    the kernel's order, one rounding per multiply-add: the activations are
    rounded to bf16 before the next product, which turns a difference of
    one f32 ulp from another summation order into one of a bf16 ulp now
    and then.  The heads, which no bf16 rounding follows, are summed in
    another order than the kernel's and agree at the f32 tolerance."""
    (w1, b1, g1, be1, w2, b2, g2, be2, wp, bp, wv, bv) = _params(model)
    x = batch.obs
    n = x.shape[0]
    inv_n = 1.0 / n
    eps = float(cfg.clip_epsilon)
    bf16 = bool(cfg.bf16_compute)

    def mm(a, w):  # a[R, K] @ w[N, K]^T, operands rounded to bf16 if bf16
        if bf16:
            return _ordered_mm(a.to(torch.bfloat16).float(),
                               w.to(torch.bfloat16).float())
        return a @ w.T

    def layer_norm(z, g, be):
        if bf16:
            mu, ez2 = _lane_mean(z), _lane_mean(z * z)
        else:
            mu, ez2 = z.mean(1, keepdim=True), (z * z).mean(1, keepdim=True)
        var = ez2 - mu * mu
        rstd = torch.rsqrt(var + LN_EPS)
        xh = (z - mu) * rstd
        y = xh * g + be
        return xh, rstd, y, torch.clamp(y, min=0.0)

    # forward
    xh1, rstd1, y1, h1 = layer_norm(mm(x, w1) + b1, g1, be1)
    xh2, rstd2, y2, h2 = layer_norm(mm(h1, w2) + b2, g2, be2)
    logits = mm(h2, wp) + bp                        # [R, A]
    v = mm(h2, wv) + bv                             # [R, 1]

    # loss gradients per row (mean over the minibatch -> inv_n)
    lmax = logits.max(1, keepdim=True).values
    lp = logits - (torch.log(torch.exp(logits - lmax).sum(1, keepdim=True))
                   + lmax)
    p = torch.exp(lp)
    aoh = torch.nn.functional.one_hot(batch.actions.long(),
                                      logits.shape[1]).float()
    newlp = (lp * aoh).sum(1, keepdim=True)
    oldlp = batch.old_log_probs[:, None]
    adv = batch.advantages[:, None]
    ret = batch.returns[:, None]
    oldv = batch.old_values[:, None]

    ratio = torch.exp(newlp - oldlp)
    s1 = ratio * adv
    s2 = torch.clamp(ratio, 1.0 - eps, 1.0 + eps) * adv
    use1 = s1 <= s2                                 # min picks arg 0 at ties
    inclip = (ratio > 1.0 - eps) & (ratio < 1.0 + eps)
    zero = torch.zeros_like(ratio)
    dmin = torch.where(use1 | inclip, ratio * adv, zero)
    g_newlp = -dmin * inv_n
    ent = -(p * lp).sum(1, keepdim=True)
    dlogits = g_newlp * (aoh - p) + (cfg.entropy_beta * inv_n) * p * (lp + ent)

    vc = oldv + torch.clamp(v - oldv, -eps, eps)
    e1 = v - ret
    e2 = vc - ret
    usev1 = (e1 * e1) >= (e2 * e2)                  # max picks arg 0 at ties
    inclip_v = (v - oldv > -eps) & (v - oldv < eps)
    dv = (cfg.value_loss_coef * inv_n) * torch.where(
        usev1, 2.0 * e1, torch.where(inclip_v, 2.0 * e2, zero))

    sums = torch.cat([
        -torch.minimum(s1, s2),
        cfg.value_loss_coef * torch.maximum(e1 * e1, e2 * e2),
        ent,
        oldlp - newlp,
        ((ratio - 1.0).abs() > eps).float(),
    ], dim=1).sum(0)

    # backward
    dh2 = dlogits @ wp + dv @ wv                    # [R, H2]
    dy2 = dh2 * (y2 > 0.0).float()
    dxh2 = dy2 * g2
    dz2 = rstd2 * (dxh2 - dxh2.mean(1, keepdim=True)
                   - xh2 * (dxh2 * xh2).mean(1, keepdim=True))
    dh1 = dz2 @ w2                                  # [R, H1]
    dy1 = dh1 * (y1 > 0.0).float()
    dxh1 = dy1 * g1
    dz1 = rstd1 * (dxh1 - dxh1.mean(1, keepdim=True)
                   - xh1 * (dxh1 * xh1).mean(1, keepdim=True))

    grads = (
        dz1.T @ x, dz1.sum(0), (dy1 * xh1).sum(0), dy1.sum(0),
        dz2.T @ h1, dz2.sum(0), (dy2 * xh2).sum(0), dy2.sum(0),
        dlogits.T @ h2, dlogits.sum(0), dv.T @ h2, dv.sum(0),
    )
    return dict(zip(PARAM_NAMES, grads)), _metrics(sums, n, cfg)


def _check(batch, params):
    obs = batch.obs
    if obs.dim() != 2:
        raise ValueError(f"obs must be [B, D], got {tuple(obs.shape)}")
    n = obs.shape[0]
    want = (
        ("obs", obs, torch.float32, tuple(obs.shape)),
        ("actions", batch.actions, torch.int64, (n,)),
        ("old_log_probs", batch.old_log_probs, torch.float32, (n,)),
        ("advantages", batch.advantages, torch.float32, (n,)),
        ("returns", batch.returns, torch.float32, (n,)),
        ("old_values", batch.old_values, torch.float32, (n,)),
    ) + tuple((name, t, torch.float32, tuple(t.shape))
              for name, t in zip(PARAM_NAMES, params))
    for name, t, dtype, shape in want:
        if t.device != obs.device:
            raise ValueError(f"{name} is on {t.device}, obs on {obs.device}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if params[0].shape[1] != obs.shape[1]:
        raise ValueError(f"obs has {obs.shape[1]} columns, the first layer "
                         f"takes {params[0].shape[1]}")
    if n % KERNEL_ROWS:
        raise ValueError(f"minibatch {n} is not a multiple of the kernel's "
                         f"{KERNEL_ROWS}-row tile")
    if batch.weights is not None:
        raise ValueError("the fused kernel takes no per-sample weights")


def dw2_split(n: int, h1: int, h2: int, sms: int) -> tuple[int, int]:
    """(splits, rows per split) of the dW2 kernel for ``n`` rows: about one
    block per SM over the 128 x 128 output tiles of [h2, h1], each split a
    whole number of 16-row steps and none of them empty."""
    tiles = -(-h2 // DW2_TILE) * -(-h1 // DW2_TILE)
    want = max(1, min(n // DW2_STEP_ROWS, -(-sms // tiles)))
    rows = -(-(-(-n // want)) // DW2_STEP_ROWS) * DW2_STEP_ROWS
    return -(-n // rows), rows


def workspace(n: int, d: int, h1: int, h2: int, a: int, blocks: int,
              splits: int) -> dict:
    """(offset, floats) of each segment of the kernels' one f32 workspace:
    the row kernel's ``blocks`` slabs (every gradient but dW2, then the 5
    metric sums), h1 [n, h1], dz2 [n, h2] and the ``splits`` dW2 slabs
    [h2, h1].  The output is a tensor of its own, so that the gradients,
    views of it, do not hold the workspace."""
    small = h1 * d + 3 * h1 + 3 * h2 + (a + 1) * h2 + a + 1 + 5
    sizes = {"slab": blocks * small, "h1": n * h1, "dz2": n * h2,
             "slab2": splits * h2 * h1}
    out, offset = {}, 0
    for name, size in sizes.items():
        out[name] = (offset, size)
        offset += -(-size // _ALIGN) * _ALIGN
    out["total"] = (0, offset)
    return out


_entries = None   # the loaded C entry points, set at first launch
_plans: dict = {}


def _library():
    global _entries
    if _entries is None:
        from tpu_plume_torch.ops import build

        lib = build.load("ppo")
        plan = lib.ppo_fused_plan
        plan.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)] * 3
        plan.restype = ctypes.c_int
        rows = lib.ppo_fused_rows
        rows.argtypes = ([ctypes.c_void_p] * 21 + [ctypes.c_int] * 8
                         + [ctypes.c_float] * 7 + [ctypes.c_void_p])
        rows.restype = ctypes.c_int
        dw2 = lib.ppo_fused_dw2
        dw2.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [
            ctypes.c_void_p]
        dw2.restype = ctypes.c_int
        reduce = lib.ppo_fused_reduce
        reduce.argtypes = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
                           + [ctypes.c_int] * 3 + [ctypes.c_float] * 2
                           + [ctypes.c_void_p])
        reduce.restype = ctypes.c_int
        _entries = (plan, rows, dw2, reduce)
    return _entries


def _plan(device: int, d: int, h1: int, h2: int, a: int
          ) -> tuple[int, int, int]:
    """(dynamic shared memory bytes, blocks the card holds at once, SMs) of
    the row kernel for these widths, cached per device and widths."""
    key = (device, d, h1, h2, a)
    if key not in _plans:
        smem, blocks, sms = (ctypes.c_int(0) for _ in range(3))
        err = _library()[0](d, h1, h2, a, ctypes.byref(smem),
                            ctypes.byref(blocks), ctypes.byref(sms))
        if err != 0:
            raise RuntimeError(
                f"ppo_fused cannot take widths D={d}, H1={h1}, H2={h2}, "
                f"A={a} (H1 and H2 must be multiples of 16 up to 256, A at "
                f"most 7): "
                f"{smem.value} bytes of shared memory, cudaError {err}")
        _plans[key] = (smem.value, blocks.value, sms.value)
    return _plans[key]


def fused_ppo_grads_cuda(model: torch.nn.Module, batch, cfg: PPOConfig):
    """Launches the CUDA kernels on the current stream of the current
    device, which must hold the batch and the model."""
    global launches, dw2_launches, reduce_launches
    obs = batch.obs
    if obs.device.type != "cuda":
        raise ValueError(f"fused_ppo_grads_cuda needs CUDA tensors, got "
                         f"{obs.device}")
    if obs.device.index != torch.cuda.current_device():
        raise ValueError(f"tensors on {obs.device}, current device is "
                         f"cuda:{torch.cuda.current_device()}")
    params = _params(model)
    _check(batch, params)
    n, d = obs.shape
    h1, h2, a = params[0].shape[0], params[4].shape[0], params[8].shape[0]
    smem, capacity, sms = _plan(obs.device.index, d, h1, h2, a)
    blocks = min(n // KERNEL_ROWS, capacity)
    splits, rows_per_split = dw2_split(n, h1, h2, sms)
    ws = workspace(n, d, h1, h2, a, blocks, splits)
    buf = torch.empty(ws["total"][1], dtype=torch.float32, device=obs.device)
    ptr = {name: buf.data_ptr() + 4 * off for name, (off, _) in ws.items()}
    sizes = [t.numel() for t in params]
    ngrad = sum(sizes)
    out = torch.empty(ngrad + len(METRIC_NAMES), dtype=torch.float32,
                      device=obs.device)
    plan, rows, dw2, reduce = _library()
    inv_n = 1.0 / n
    eps = float(cfg.clip_epsilon)
    stream = torch.cuda.current_stream().cuda_stream
    err = rows(
        obs.data_ptr(), batch.actions.data_ptr(),
        batch.old_log_probs.data_ptr(), batch.advantages.data_ptr(),
        batch.returns.data_ptr(), batch.old_values.data_ptr(),
        *(t.data_ptr() for t in params), ptr["slab"], ptr["h1"], ptr["dz2"],
        blocks, smem, n, d, h1, h2, a, int(bool(cfg.bf16_compute)),
        inv_n, 1.0 - eps, 1.0 + eps, eps,
        cfg.value_loss_coef * inv_n, float(cfg.value_loss_coef),
        cfg.entropy_beta * inv_n, stream)
    if err != 0:
        raise RuntimeError(f"ppo_fused row kernel launch failed: cudaError "
                           f"{err}")
    launches += 1
    err = dw2(ptr["dz2"], ptr["h1"], ptr["slab2"], n, h1, h2, splits,
              rows_per_split, stream)
    if err != 0:
        raise RuntimeError(f"ppo_fused dW2 kernel launch failed: cudaError "
                           f"{err}")
    dw2_launches += 1
    err = reduce(ptr["slab"], blocks, ws["slab"][1] // blocks, ptr["slab2"],
                 splits, out.data_ptr(), sum(sizes[:4]), sizes[4], ngrad, inv_n,
                 float(cfg.entropy_beta), stream)
    if err != 0:
        raise RuntimeError(f"ppo_fused reduction launch failed: cudaError "
                           f"{err}")
    reduce_launches += 1

    grads, offset = {}, 0
    for name, t, size in zip(PARAM_NAMES, params, sizes):
        grads[name] = out[offset:offset + size].view(t.shape)
        offset += size
    metrics = {k: out[offset + i] for i, k in enumerate(METRIC_NAMES)}
    return grads, metrics


def fused_ppo_grads(model: torch.nn.Module, batch, cfg: PPOConfig):
    """(grads by parameter name, loss metrics) of one minibatch: the CUDA
    kernel for CUDA tensors, the plain version for CPU tensors.  The caller
    checks ``supports(model)`` and ``pick_tile(minibatch) > 0`` first, as
    ``tpu_plume_torch.rl.ppo.ppo_update`` does."""
    if batch.obs.device.type == "cpu":
        return fused_ppo_grads_plain(model, batch, cfg)
    return fused_ppo_grads_cuda(model, batch, cfg)
