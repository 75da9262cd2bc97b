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
bit where the turbulence is off, at every bank layout.  The env-step
kernel is held to ``env_step_plain`` teacher-forced (each step from the
plain path's state): integers, bools and positions equal, floats at the env
tolerance (rtol 1e-5, atol 1e-4), at every analytic mode (isotropic and
anisotropic, one or three sources, 2-D and 3-D flight, with and without
wind advection); a rollout on the card launches it once a step and leaves
the carry it was given as it was.  The plume kernel is held to its plain
version at the same modes.
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
from tpu_plume_torch.rollout import rollout

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


# The env cases of tests/test_torch_env.py: the v1_1, v1_0 (elastic walls)
# and delta (in-plume, depth and gate terms) rewards and obs_memory.
ENV_CASES = {
    "v1_1": ("ppo_v2_0", {}),
    "v1_0": ("ppo_v1_0", {"max_steps": 7}),
    "delta": ("ppo_v2_0", {"reward_variant": "delta", "inplume_bonus": 0.5,
                           "terminal_depth_coef": 30.0,
                           "terminal_depth_power": 2.0,
                           "terminal_gate_radius": 200.0}),
    "obs_memory": ("ppo_v1_1", {"obs_memory": True, "max_steps": 9}),
    "wrf_les": ("wrf_les", {}),
    "aniso_advect": ("wrf_les", {"wind_advect_coef": 0.5, "max_steps": 8}),
    "iso_s3": ("ppo_v2_0", {"num_sources": 3}),
    "aniso_3d": ("wrf_les_3d", {"plume_model": "anisotropic",
                                "wind_speed_range": (1.0, 4.0)}),
    "iso_3d": ("wrf_les_3d", {"plume_model": "isotropic", "max_steps": 10}),
    "aniso_3d_s3_delta": ("wrf_les_3d", {
        "plume_model": "anisotropic", "wind_speed_range": (1.0, 4.0),
        "num_sources": 3, "reward_variant": "delta", "obs_memory": True}),
}
# The analytic plumes beside ppo_v2_0's isotropic one.
ANALYTIC_CASES = ("wrf_les", "aniso_advect", "iso_s3", "aniso_3d", "iso_3d",
                  "aniso_3d_s3_delta")


def _env_cfg(case):
    preset, kw = ENV_CASES[case]
    return dataclasses.replace(get_preset(preset).env, **kw)


def _env_start(cfg, n, seed, device):
    g = torch.Generator(device=device).manual_seed(seed)
    carry = rollout.init_rollout(cfg, n, g)
    state = carry.env_state.replace(
        radius=40.0 + 260.0 * torch.rand(n, device=device, generator=g))
    return state, carry.accum, g


@pytest.mark.parametrize("greedy", [False, True], ids=["gumbel", "greedy"])
@pytest.mark.parametrize("n", [4096, 4133])
@pytest.mark.parametrize("case", sorted(ENV_CASES))
def test_env_step_kernel_matches_plain(card, case, n, greedy):
    """Teacher-forced: each step starts the kernel from a copy of the plain
    path's state, with the same logits, values and draws; integers, bools
    and positions equal, floats within the env tolerance."""
    cfg = _env_cfg(case)
    state, accum, g = _env_start(cfg, n, n + len(case), card)
    dones = 0
    for _ in range(8):
        logits = 2.0 * torch.randn(n, cfg.num_actions, device=card,
                                   generator=g)
        value = torch.randn(n, device=card, generator=g)
        draws = rollout.draw_chunk(g, cfg, 1, n, greedy)
        traj, obs = rollout.empty_trajectory(1, n, cfg, card)
        k_state, k_acc = rollout.own_copy(state), rollout.own_copy(accum)
        before = plume.env_step_launches
        plume.EnvStepper(k_state, k_acc, draws, traj, obs, cfg)(0, logits,
                                                                value)
        assert plume.env_step_launches == before + 1
        w_traj, w_obs = rollout.empty_trajectory(1, n, cfg, card)
        state, _, accum = rollout.env_step_plain(
            logits, value, draws, 0, state, accum, w_traj, w_obs, cfg)
        torch.cuda.synchronize()
        for a, b in ((traj.action, w_traj.action), (traj.done, w_traj.done),
                     (traj.episode.steps, w_traj.episode.steps),
                     (traj.episode.success, w_traj.episode.success),
                     (traj.pos, w_traj.pos), (k_state.pos, state.pos),
                     (k_state.t, state.t), (k_state.visited, state.visited),
                     (k_state.prev_action, state.prev_action),
                     (k_state.field.seed, state.field.seed)):
            assert torch.equal(a, b)
        assert (k_state.field.wind is None) == (state.field.wind is None)
        if state.field.wind is not None:
            torch.testing.assert_close(k_state.field.wind, state.field.wind,
                                       rtol=1e-5, atol=1e-6)
        for a, b in ((obs[1], w_obs[1]), (traj.reward, w_traj.reward),
                     (traj.log_prob, w_traj.log_prob),
                     (traj.episode.total_reward, w_traj.episode.total_reward),
                     (traj.episode.distance, w_traj.episode.distance),
                     (k_state.conc, state.conc), (k_state.tke, state.tke),
                     (k_state.field.source, state.field.source),
                     (k_acc.total_reward, accum.total_reward)):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-4)
        dones += int(traj.done.sum())
    assert dones > 0


def test_rollout_on_the_card_is_one_env_step_launch_a_step(card):
    cfg = _env_cfg("v1_1")
    g = torch.Generator(device=card).manual_seed(0)
    carry = rollout.init_rollout(cfg, 256, g)
    kept = rollout.own_copy(carry.env_state)
    model = ActorCritic(cfg.obs_dim, cfg.num_actions, (64, 32)).to(card)
    before = (plume.launches, plume.env_step_launches)
    rollout.rollout_chunk(model, carry, cfg, 16)
    torch.cuda.synchronize()
    assert (plume.launches, plume.env_step_launches) == (before[0],
                                                         before[1] + 16)
    # the carry passed in is not modified
    assert torch.equal(carry.env_state.pos, kept.pos)
    assert torch.equal(carry.env_state.visited, kept.visited)


def test_env_stepper_raises_on_bad_cuda_inputs(card):
    cfg = _env_cfg("v1_1")
    n = 64
    state, accum, g = _env_start(cfg, n, 0, card)
    draws = rollout.draw_chunk(g, cfg, 1, n)
    traj, obs = rollout.empty_trajectory(1, n, cfg, card)
    stepper = plume.EnvStepper(state, accum, draws, traj, obs, cfg)
    logits = torch.zeros(n, cfg.num_actions, device=card)
    value = torch.zeros(n, device=card)
    with pytest.raises(TypeError):
        stepper(0, logits.double(), value)
    with pytest.raises(ValueError):
        stepper(0, logits[:, :4].contiguous(), value)
    with pytest.raises(ValueError):
        stepper(0, logits, value.cpu())
    with pytest.raises(IndexError):
        stepper(1, logits, value)
    with pytest.raises(TypeError):
        plume.EnvStepper(state.replace(t=state.t.long()), accum, draws, traj,
                         obs, cfg)


@pytest.mark.parametrize("n", [1, 4096, 100_003])
@pytest.mark.parametrize("case", ANALYTIC_CASES)
def test_plume_kernel_matches_plain_on_the_analytic_modes(card, case, n):
    """The fresh-episode sample of every analytic mode: positions over the
    grid (and heights over the domain), fields from the rollout's draws."""
    cfg = _env_cfg(case)
    g = torch.Generator(device=card).manual_seed(n + len(case))
    state = rollout.init_rollout(cfg, n, g).env_state
    scale = torch.tensor([520.0, 520.0, cfg.domain_height + 10.0][
        :cfg.pos_dim], device=card)
    pos = torch.rand(n, cfg.pos_dim, device=card, generator=g) * scale - 5.0
    field = state.field
    before = plume.launches
    conc, tke = plume.sample_plume(pos, field.source, field.seed, cfg,
                                   field.wind)
    torch.cuda.synchronize()
    assert plume.launches == before + 1
    want_c, want_t = plume.sample_plume_plain(pos, field.source, field.seed,
                                              cfg, field.wind)
    torch.testing.assert_close(conc, want_c, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(tke, want_t, rtol=1e-5, atol=1e-4)


def test_analytic_wrappers_raise_on_bad_cuda_inputs(card):
    cfg = _env_cfg("aniso_3d")
    n = 64
    state, accum, g = _env_start(cfg, n, 0, card)
    field = state.field
    with pytest.raises(ValueError, match="wind"):
        plume.sample_plume(state.pos, field.source, field.seed, cfg)
    with pytest.raises(ValueError, match="shape"):
        plume.sample_plume(state.pos[:, :2].contiguous(), field.source,
                           field.seed, cfg, field.wind)
    too_many = dataclasses.replace(cfg, num_sources=plume.MAX_SOURCES + 1)
    with pytest.raises(ValueError, match="sources"):
        plume.sample_plume(state.pos, field.source, field.seed, too_many,
                           field.wind)
    draws = rollout.draw_chunk(g, cfg, 1, n)
    traj, obs = rollout.empty_trajectory(1, n, cfg, card)
    with pytest.raises(ValueError, match="u_wind"):
        plume.EnvStepper(state, accum, dataclasses.replace(draws, u_wind=None),
                         traj, obs, cfg)
    with pytest.raises(ValueError, match="sources"):
        plume.EnvStepper(state, accum, draws, traj, obs, too_many)
