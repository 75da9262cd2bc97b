"""Tests of the port's CUDA kernels that need the card.

They carry the ``cuda`` marker and skip on a machine without a GPU.  This
file imports neither JAX nor the JAX package, so it also runs where only
PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -m cuda

The plume kernel is held to its plain PyTorch version with the tolerance
the CPU tests give the plume sample (rtol 1e-5, atol 1e-4).  The fused PPO
kernels (row kernel, split-K dW2 kernel, reduction) are held to their
plain version with the tolerances of ``tests/test_fused_update.py`` (grads
atol 2e-5 x max|grad|, metrics rtol 2e-5, atol 2e-6), in f32 and under bf16
compute, two calls give bit-equal grads, and widths the kernels do not take
raise.  The bilinear and trilinear gather kernels repeat their
plain versions' operations in order with no contracted multiply-adds, so
they are held to them within 1e-6 x max|field| (bit-equal in practice), at
the TPU kernels' own call (a stack of one) and at a bank's stacks.  The
same kernels' bank sample (one launch per env-step sample) is held to
``sample_bank_conc_tke_plain`` at the plume sample's tolerance, and to the
bit where the turbulence is off, at every bank layout.
"""

import dataclasses

import pytest
import torch

from tpu_plume_torch.core import PPOConfig, get_preset
from tpu_plume_torch.fields.gridded import FieldBank
from tpu_plume_torch.models import ActorCritic
from tpu_plume_torch.ops import gather, plume
from tpu_plume_torch.ops import ppo as fused_ops
from tpu_plume_torch.rl.ppo import PPOBatch

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(n, seed, device):
    g = torch.Generator(device=device).manual_seed(seed)
    pos = torch.rand(n, 2, device=device, generator=g) * 520.0 - 10.0
    source = 50.0 + 400.0 * torch.rand(n, 2, device=device, generator=g)
    bits = torch.randint(-(2**31), 2**31, (n,), dtype=torch.int32,
                         device=device, generator=g)
    return pos, source, bits


@pytest.mark.parametrize("preset", ["ppo_v2_0", "ppo_v1_0"])
@pytest.mark.parametrize("n", [1, 4096, 100_003])
def test_plume_kernel_matches_plain(card, preset, n):
    cfg = get_preset(preset).env
    args = _inputs(n, n, card)
    before = plume.launches
    conc, tke = plume.sample_plume(*args, cfg)
    torch.cuda.synchronize()
    assert plume.launches == before + 1
    want_c, want_t = plume.sample_plume_plain(*args, cfg)
    torch.testing.assert_close(conc, want_c, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(tke, want_t, rtol=1e-5, atol=1e-4)


def test_plume_wrapper_raises_on_bad_cuda_inputs(card):
    cfg = get_preset("ppo_v2_0").env
    pos, source, bits = _inputs(64, 0, card)
    with pytest.raises(TypeError):
        plume.sample_plume(pos, source, bits.to(torch.int64), cfg)
    with pytest.raises(ValueError):
        plume.sample_plume(pos, source.cpu(), bits, cfg)
    with pytest.raises(ValueError):
        plume.sample_plume(pos.t().contiguous().t(), source, bits, cfg)


def _ppo_batch(b, d, seed, device):
    g = torch.Generator(device=device).manual_seed(seed)
    return PPOBatch(
        obs=torch.randn(b, d, device=device, generator=g),
        actions=torch.randint(0, 5, (b,), device=device, generator=g),
        old_log_probs=-1.6 + 0.2 * torch.randn(b, device=device, generator=g),
        advantages=torch.randn(b, device=device, generator=g),
        returns=torch.randn(b, device=device, generator=g),
        old_values=torch.randn(b, device=device, generator=g))


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("b,d,hidden", [(512, 6, (64, 32)),
                                        (512, 12, (256, 128)),
                                        (65536, 6, (256, 128))])
def test_fused_ppo_kernel_matches_plain(card, b, d, hidden, bf16):
    model = ActorCritic(d, 5, hidden).reset_parameters(
        torch.Generator().manual_seed(b + d)).to(card)
    batch = _ppo_batch(b, d, d, card)
    cfg = PPOConfig(minibatch_size=b, bf16_compute=bf16)
    before = (fused_ops.launches, fused_ops.dw2_launches,
              fused_ops.reduce_launches)
    grads, metrics = fused_ops.fused_ppo_grads(model, batch, cfg)
    again, _ = fused_ops.fused_ppo_grads(model, batch, cfg)
    torch.cuda.synchronize()
    assert (fused_ops.launches, fused_ops.dw2_launches,
            fused_ops.reduce_launches) == tuple(c + 2 for c in before)
    want, want_m = fused_ops.fused_ppo_grads_plain(model, batch, cfg)
    for name, g in grads.items():
        assert torch.equal(g, again[name]), name
        atol = 2e-5 * float(want[name].abs().max().clamp(min=1e-8))
        torch.testing.assert_close(g, want[name], rtol=0, atol=atol)
    for k, v in metrics.items():
        torch.testing.assert_close(v, want_m[k], rtol=2e-5, atol=2e-6)


def test_fused_ppo_wrapper_raises_on_bad_cuda_inputs(card):
    model = ActorCritic(6, 5, (64, 32)).to(card)
    batch = _ppo_batch(512, 6, 0, card)
    cfg = PPOConfig(minibatch_size=512)
    bad = batch.map(lambda x: x)
    bad.actions = batch.actions.to(torch.int32)
    with pytest.raises(TypeError):
        fused_ops.fused_ppo_grads(model, bad, cfg)
    bad = batch.map(lambda x: x[:500])
    with pytest.raises(ValueError):
        fused_ops.fused_ppo_grads(model, bad, cfg)
    with pytest.raises(ValueError):
        fused_ops.fused_ppo_grads(model.cpu(), batch, cfg)
    bad = batch.map(lambda x: x[:496])        # 16-row multiple, not 32
    with pytest.raises(ValueError):
        fused_ops.fused_ppo_grads(model, bad, cfg)


@pytest.mark.parametrize("hidden", [(64, 24), (512, 256), (100, 50)])
def test_fused_ppo_plan_refuses_widths(card, hidden):
    """Widths the kernels do not take (H1 or H2 not a multiple of 16, or
    above 256) raise before any launch."""
    model = ActorCritic(6, 5, hidden).to(card)
    batch = _ppo_batch(512, 6, 0, card)
    before = fused_ops.launches
    with pytest.raises(RuntimeError, match="cannot take widths"):
        fused_ops.fused_ppo_grads(model, batch, PPOConfig(minibatch_size=512))
    assert fused_ops.launches == before


def _gather_inputs(shape, n, seed, device):
    """A stack of the given shape, rows over it, and points over every axis
    after the first, from 1 beyond each edge, with exact grid points, the
    last index, the top level and points outside both sides."""
    g = torch.Generator(device=device).manual_seed(seed)
    stack = 100.0 * torch.rand(shape, device=device, generator=g)
    rows = torch.randint(0, shape[0], (n,), dtype=torch.int32, device=device,
                         generator=g)
    dims = torch.tensor(shape[1:], dtype=torch.float32, device=device)
    pts = torch.rand(n, len(shape) - 1, device=device, generator=g) * (
        dims + 2.0) - 1.0
    pts[:4] = torch.stack([torch.zeros_like(dims), dims - 1, dims + 5.0,
                           -3.0 * torch.ones_like(dims)])
    pts[4:8] = torch.floor(pts[4:8])
    return stack, rows, pts.contiguous()


@pytest.mark.parametrize("n", [1, 4096, 100_003])
@pytest.mark.parametrize("shape", [(1, 500, 500), (64, 500, 500), (3, 7, 9),
                                   (1, 8, 500, 500), (32, 8, 500, 500),
                                   (5, 1, 6, 4), (2, 2, 2, 2)])
def test_gather_kernels_match_plain(card, shape, n):
    stack, rows, pts = _gather_inputs(shape, max(n, 8), n + len(shape), card)
    wrapper, plain = ((gather.bilinear, gather.bilinear_plain)
                      if len(shape) == 3 else
                      (gather.trilinear_zyx, gather.trilinear_zyx_plain))
    before = wrapper.launches
    got = wrapper(stack, rows, pts)
    again = wrapper(stack, rows, pts)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 2
    assert torch.equal(got, again)
    want = plain(stack, rows, pts)
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-6 * float(stack.abs().max()))


def test_gather_wrappers_raise_on_bad_cuda_inputs(card):
    stack, rows, pts = _gather_inputs((4, 6, 8), 64, 0, card)
    with pytest.raises(TypeError):
        gather.bilinear(stack, rows.long(), pts)
    with pytest.raises(ValueError):
        gather.bilinear(stack, rows.cpu(), pts)
    with pytest.raises(ValueError):
        gather.bilinear(stack, rows, pts.t().contiguous().t())
    with pytest.raises(ValueError):
        gather.trilinear_zyx(stack, rows, pts)
    with pytest.raises(ValueError):
        gather.bilinear(stack[:, :1].contiguous(), rows, pts)
    # 2-D points are read as float2: the entry point refuses them unaligned
    odd = torch.empty(2 * 64 + 1, device=card)[1:].view(64, 2)
    odd.copy_(pts)
    with pytest.raises(ValueError, match="aligned"):
        gather.bilinear(stack, rows, odd)
    # the entry points check their own arguments before any launch
    ext = gather._library()
    with pytest.raises(TypeError):
        ext.bilinear_gather(0, 0)
    with pytest.raises(OverflowError):
        ext.bilinear_gather(stack.data_ptr(), rows.data_ptr(), pts.data_ptr(),
                            0, 2**31, stack.shape, 0)


# bank sample layouts: (bank shape, 3-D flight)
BANK_LAYOUTS = {"static": ((3, 20, 24), False),
                "frames": ((3, 4, 20, 24), False),
                "volumes": ((3, 4, 5, 20, 24), True),
                "one_frame": ((3, 1, 5, 20, 24), True),
                "volumes_2d_flight": ((3, 4, 5, 20, 24), False)}


def _bank_sample_inputs(layout, n, seed, device, **env):
    shape, env_3d = BANK_LAYOUTS[layout]
    cfg = dataclasses.replace(get_preset("wrf_les_3d").env, grid_size=24,
                              domain_height=30.0, env_3d=env_3d, **env)
    g = torch.Generator(device=device).manual_seed(seed)
    bank = FieldBank(conc=100.0 * torch.rand(shape, device=device, generator=g),
                     source=torch.zeros(shape[0], 2, device=device),
                     steps_per_frame=7.0, z_extent=30.0)
    idx = torch.randint(0, shape[0], (n,), dtype=torch.int32, device=device,
                        generator=g)
    scale = torch.tensor([27.0, 27.0, 34.0][:cfg.pos_dim], device=device)
    pos = torch.rand(n, cfg.pos_dim, device=device, generator=g) * scale - 2.0
    t = torch.randint(0, 60, (n,), dtype=torch.int32, device=device,
                      generator=g)
    bits = torch.randint(-(2**31), 2**31, (n,), dtype=torch.int32,
                         device=device, generator=g)
    return bank, (idx, pos, t, bits), cfg


@pytest.mark.parametrize("n", [1, 4096, 100_003])
@pytest.mark.parametrize("layout", sorted(BANK_LAYOUTS))
def test_bank_sample_kernel_matches_plain(card, layout, n):
    bank, args, cfg = _bank_sample_inputs(layout, n, n + len(layout), card)
    counter = gather.bilinear if layout == "static" else gather.trilinear_zyx
    before = counter.launches
    got = gather.sample_bank_conc_tke(bank, *args, cfg)
    again = gather.sample_bank_conc_tke(bank, *args, cfg)
    torch.cuda.synchronize()
    assert counter.launches == before + 2
    want = gather.sample_bank_conc_tke_plain(bank, *args, cfg)
    for a, b, w in zip(got, again, want):
        assert torch.equal(a, b)
        torch.testing.assert_close(a, w, rtol=1e-5, atol=1e-4)
    # without turbulence the sample is the bank read, clipped: to the bit
    quiet = dataclasses.replace(cfg, turbulence_intensity=0.0)
    got = gather.sample_bank_conc_tke(bank, *args, quiet)[0]
    assert torch.equal(got, gather.sample_bank_conc_tke_plain(
        bank, *args, quiet)[0])


def test_bank_sampler_raises_on_bad_cuda_inputs(card):
    bank, (idx, pos, t, bits), cfg = _bank_sample_inputs("volumes", 64, 0,
                                                          card)
    sampler = bank.sampler(cfg)
    assert bank.sampler(cfg) is sampler      # validated once, then kept
    with pytest.raises(TypeError):
        sampler(idx.long(), pos, t, bits)
    with pytest.raises(ValueError):
        sampler(idx, pos.cpu(), t, bits)
    with pytest.raises(ValueError):
        sampler(idx, pos[:, :2].contiguous(), t, bits)
    with pytest.raises(ValueError):
        sampler(idx, pos.t().contiguous().t(), t, bits)
    with pytest.raises(TypeError):
        FieldBank(conc=bank.conc.double(), source=bank.source).sampler(cfg)
