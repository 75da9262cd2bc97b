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
the carry it was given as it was.  The bank step kernel (the same step
around a bank's sub-cell sample) is held to ``env_step_plain`` over a bank
on the card to the bit: every trajectory, record, next-obs, state and
totals tensor of a 128-step chunk with resets, at each bank layout (static,
frames, one-frame and two-frame 3-D), N = 4096 and 32768, sampled and
greedy, and with an executed action at each of its instantiations; a
rollout over a bank on the card launches it once a step and no sample
kernel.  The plume kernel is held to its plain
version at the same modes.  The evaluation harness on the card is held to
the same evaluation on the CPU, given the same draws: steps and stop flags
equal in all but at most one of 64 episodes (a position one float ulp
apart can land in another cell), deviations of the others at the env
tolerance, and one plume-sample launch per eval step plus one at the
reset.  The recurrent policy's rollout on the card is held to the same
rollout on the CPU from the same start, carry and draws: one env-step
launch a step, actions and dones equal in all but at most one env in 64
(the carry takes the card's rounding from step to step), the others'
values and carries at the env tolerance, and the carry zeroed where the
last step ended an episode.  Its update through CUDA graphs
(``rl.ppo.RecurrentGraph``) is held to the eager update on the card over
four updates, metrics within a few ulps and params within one learning
rate, with one capture kept until the parameters move.  The LSTM step
kernels (``ops/lstm.py``, ``csrc/lstm.cu``) are held to autodiff through
the eager loop and to their plain version on the card: outputs to the
bit, gradients within 2e-5 x max|grad|, T launches of each a call; a
graphed update through them to the same update through the loop, params
within one learning rate, each replay adding T launches to each
counter.  The stop LSTMs (cuDNN on the card, TF32
off) are held to the CPU: a zoo forward and one minibatch step of a
trainer at rtol 1e-4, atol 1e-5, and an eval with the threshold gate at 64
episodes x 200 steps as the eval above.  The env-step kernel's executed
action (a guided rollout's launch) is held to ``env_step_plain`` as above,
the sampled action it records equal to the PyTorch argmax a guide sees;
the fit guide's rollout (one env-step launch a step) and eval on the card
are held to the CPU, at most one env or episode in 64 apart; so are the
bank guide's evals (one bank-sample launch a step) and the learned
guide's (its localizer cuDNN, TF32 off; the post-hoc localization within
1e-2 px), and the phase oracle's eval and expert data agree in every
episode.  Distilled PPO's labelled rollout (one env-step launch a step,
the teacher reading the state before the kernel updates it) is held to
the CPU's labels, at most one env in 64 apart, and one closed-loop GAIL
iteration to the CPU's at the losses' tolerance.  The flux study (raster
and two-pass surveys) launches the plume sample once a survey step plus
once at the reset and no other counted kernel, and is held to the CPU:
flights within the env tolerance, observed flags and the observed
sources' true-position strengths equal within rtol 1e-3, most estimated
positions within 0.05 px.  A run on the card killed after a snapshot and
resumed from it equals the uninterrupted run bit for bit (params,
optimizer state, rollout carry, generator, counters, curriculum and
``training_results.csv``), and the data-parallel step at world size 1
through NCCL equals the plain step bit for bit with the same launches.
"""

import dataclasses

import numpy as np
import pytest
import torch

from tpu_plume_torch.core import PPOConfig, get_preset
from tpu_plume_torch.evaluation import harnesses
from tpu_plume_torch.fields.gridded import FieldBank
from tpu_plume_torch.models import ActorCritic, RecurrentActorCritic
from tpu_plume_torch.models import lstm_zoo, recurrent
from tpu_plume_torch.ops import gather, plume
from tpu_plume_torch.ops import lstm as lstm_ops
from tpu_plume_torch.ops import ppo as fused_ops
from tpu_plume_torch.rl import ppo as rl_ppo
from tpu_plume_torch.rl.ppo import PPOBatch, RecurrentPPOBatch
from tpu_plume_torch.rollout import rollout
from tpu_plume_torch.train import lstm_trainer
from tpu_plume_torch.train.ppo_trainer import ClippedAdam

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
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


def test_eval_on_the_card_matches_the_cpu(card):
    cfg = get_preset("ppo_v2_0")
    n, length = 64, 200
    model = ActorCritic(cfg.env.obs_dim, cfg.env.num_actions)
    model.reset_parameters(torch.Generator().manual_seed(0))
    draws = harnesses.draw_eval(torch.Generator().manual_seed(1), cfg.env,
                                length, n)
    gate = harnesses.make_heuristic_gate(cfg.eval, cfg.env.conc_peak)
    kw = dict(num_episodes=n, max_steps=length, stop_gate=gate,
              goal_radius=120.0)
    want = harnesses.evaluate_policy(model, cfg.env, cfg.eval, draws=draws,
                                     device="cpu", **kw)
    before = plume.launches
    got = harnesses.evaluate_policy(model, cfg.env, cfg.eval, draws=draws,
                                    device=card, **kw)
    assert plume.launches == before + length + 1
    same = ((got.steps == want.steps)
            & (got.stopped_early == want.stopped_early))
    assert same.sum() >= n - 1, (got.steps, want.steps)
    torch.testing.assert_close(torch.from_numpy(got.deviations[same]),
                               torch.from_numpy(want.deviations[same]),
                               rtol=1e-5, atol=1e-4)
    assert (want.steps < length).any()


def _moved(obj, device):
    """Tensors of (nested) dataclasses and tuples moved to ``device``."""
    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    if isinstance(obj, tuple):
        return tuple(_moved(x, device) for x in obj)
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **{
            f.name: _moved(getattr(obj, f.name), device)
            for f in dataclasses.fields(obj)
            if isinstance(getattr(obj, f.name), (torch.Tensor, tuple))
            or dataclasses.is_dataclass(getattr(obj, f.name))})
    return obj


@pytest.mark.parametrize("layer_norm_cell", [False, True], ids=["plain", "ln"])
def test_recurrent_rollout_on_the_card_matches_the_cpu(card, layer_norm_cell):
    cfg = dataclasses.replace(_env_cfg("v1_1"), max_steps=6)
    n, length, hidden = 256, 16, 32
    g = torch.Generator().manual_seed(0)
    model = RecurrentActorCritic(cfg.obs_dim, cfg.num_actions, hidden, hidden,
                                 layer_norm_cell=layer_norm_cell)
    model.reset_parameters(g)
    carry = rollout.init_rollout(
        cfg, n, g, radius=200.0, hidden=tuple(
            0.5 * torch.randn(n, hidden, generator=g) for _ in range(2)))
    draws = rollout.draw_chunk(g, cfg, length, n)
    want_carry, want, want_boot = rollout.rollout_chunk(model, carry, cfg,
                                                        length, draws=draws)
    before = (plume.launches, plume.env_step_launches)
    got_carry, got, got_boot = rollout.rollout_chunk(
        model.to(card), _moved(carry, card), cfg, length,
        draws=_moved(draws, card))
    torch.cuda.synchronize()
    assert (plume.launches, plume.env_step_launches) == (before[0],
                                                         before[1] + length)
    got, got_carry = _moved(got, "cpu"), _moved(got_carry, "cpu")
    off = (got.action != want.action) | (got.done != want.done)
    agree = ~off.any(0)
    assert int((~agree).sum()) <= n // 64, off.nonzero()
    assert want.done[:, agree].any()
    for a, b in ((got.value, want.value), (got.log_prob, want.log_prob),
                 (got.reward, want.reward)):
        torch.testing.assert_close(a[:, agree], b[:, agree], rtol=1e-5,
                                   atol=1e-4)
    torch.testing.assert_close(got_boot.cpu()[agree], want_boot[agree],
                               rtol=1e-5, atol=1e-4)
    for a, b in zip(got_carry.hidden, want_carry.hidden):
        torch.testing.assert_close(a[agree], b[agree], rtol=1e-5, atol=1e-4)
        assert not a[got.done[-1]].any()


def _recurrent_batch(length, n, hidden, device, seed):
    g = torch.Generator().manual_seed(seed)

    def on(x):
        return x.to(device)

    return RecurrentPPOBatch(
        obs=on(torch.randn(length, n, 6, generator=g)),
        actions=on(torch.randint(0, 5, (length, n), generator=g)),
        old_log_probs=on(-2.0 * torch.rand(length, n, generator=g)),
        advantages=on(torch.randn(length, n, generator=g)),
        returns=on(torch.randn(length, n, generator=g)),
        old_values=on(torch.randn(length, n, generator=g)),
        resets=on(torch.rand(length, n, generator=g) < 0.05),
        h_init=tuple(on(0.5 * torch.randn(n, hidden, generator=g))
                     for _ in range(2)))


@pytest.mark.parametrize("layer_norm_cell", [False, True], ids=["plain", "ln"])
def test_recurrent_update_graph_is_the_eager_update(card, layer_norm_cell):
    """The recurrent update through its CUDA graphs against the eager
    update on the card (a one-rank mesh takes that path), from the same
    start and permutations over four updates, the parameters moved off the
    card and back before the last: one capture kept until the move, T
    replayed cell steps a minibatch, the metrics within a few ulps (a mean
    over a gathered minibatch against one over a strided slice) and the
    params within one learning rate (where a gradient element is near 0,
    its round-off can turn that element's Adam step)."""
    from types import SimpleNamespace

    length, n, hidden = 16, 256, 128
    cfg = dataclasses.replace(get_preset("ppo_v2_0").ppo, arch="lstm",
                              minibatch_size=length * 64, epochs=2)
    one_rank = SimpleNamespace(world_size=1, sum_grads=lambda params: None)
    runs = []
    for mesh in (None, one_rank):
        model = RecurrentActorCritic(6, 5, hidden, hidden,
                                     layer_norm_cell=layer_norm_cell)
        model.reset_parameters(torch.Generator().manual_seed(0)).to(card)
        opt = ClippedAdam(model.parameters(), cfg.learning_rate, 0.5)
        g = torch.Generator(device=card).manual_seed(1)
        metrics, captures = [], []
        for k in range(4):
            if k == 3:
                model.cpu().to(card)
            before = recurrent.replayed_steps
            metrics.append(rl_ppo.ppo_update_recurrent(
                model, opt, _recurrent_batch(length, n, hidden, card, k),
                cfg, generator=g, mesh=mesh))
            torch.cuda.synchronize()
            assert recurrent.replayed_steps - before == 2 * 4 * length
            captures.append(rl_ppo._GRAPHS[opt].graphs if mesh is None
                            else opt not in rl_ppo._GRAPHS)
        runs.append((model, metrics, captures))
    (got, got_metrics, captures), (want, want_metrics, eager) = runs
    assert all(eager)
    assert all(c is not None for c in captures)
    assert captures[0] is captures[1] is captures[2] is not captures[3]
    for a, b in zip(got_metrics, want_metrics, strict=True):
        assert a.keys() == b.keys()
        for key in a:
            torch.testing.assert_close(a[key], b[key], rtol=1e-6, atol=1e-7)
    for a, b in zip(got.parameters(), want.parameters(), strict=True):
        torch.testing.assert_close(a, b, rtol=0, atol=cfg.learning_rate)


class _LoopCell(recurrent.LSTMCell):
    """The plain cell under another type: ``sequence`` runs it through the
    eager loop on the card too (``ops.lstm.supports``)."""


@pytest.mark.parametrize("n, t, h", [(2048, 32, 128), (2047, 9, 128),
                                     (333, 7, 30)])
def test_lstm_kernels_match_the_loop_and_the_plain_version(card, n, t, h):
    """``ops.lstm.lstm_sequence`` on the card (one forward and one backward
    launch a step, 16-byte accesses, and one unit a thread at H = 30)
    against autodiff through the eager loop and against its plain version
    on the card, on ``chip_smoke.lstm_chunk``'s inputs (resets at step 0
    and the last step among them): the outputs equal the loop's (the
    same ops, roundings and products), the gradients within 2e-5 x
    max|grad| (the fused PPO kernels' tolerance; the weight's and bias's
    are summed over all rows at once)."""
    from chip_smoke import lstm_chunk, lstm_grads

    cell, xi, resets, carry = lstm_chunk(recurrent, n, t, h, n + t)
    loop = lambda *a: recurrent.cell_loop(*a, torch.float32)
    before = lstm_ops.fwd_launches, lstm_ops.bwd_launches
    got, got_grads = lstm_grads(lstm_ops.lstm_sequence, cell, carry, xi,
                                resets, 1)
    assert (lstm_ops.fwd_launches, lstm_ops.bwd_launches) == (
        before[0] + t, before[1] + t)
    for fn in (loop, lstm_ops.lstm_sequence_plain):
        want, want_grads = lstm_grads(fn, cell, carry, xi, resets, 1)
        for key in want:
            assert torch.equal(got[key], want[key]), key
        for key, w in want_grads.items():
            torch.testing.assert_close(got_grads[key], w, rtol=0,
                                       atol=2e-5 * float(w.abs().max()),
                                       msg=key)
    assert (lstm_ops.fwd_launches, lstm_ops.bwd_launches) == (
        before[0] + t, before[1] + t)


def test_lstm_wrapper_raises_on_cuda_inputs_it_does_not_take(card):
    from chip_smoke import lstm_chunk

    cell, xi, resets, carry = lstm_chunk(recurrent, 64, 3, 16, 0)
    with pytest.raises(TypeError):
        lstm_ops.lstm_sequence(cell, carry, xi.bfloat16(), resets)
    with pytest.raises(TypeError):
        lstm_ops.lstm_sequence(_LoopCell(16, 16).to(card), carry, xi, resets)
    ln = recurrent.LayerNormLSTMCell(16, 16).to(card)
    with pytest.raises(TypeError):
        lstm_ops.lstm_sequence(ln, carry, xi, resets)
    with pytest.raises(ValueError):
        lstm_ops.lstm_sequence(cell, (carry[0].cpu(), carry[1]), xi, resets)


def test_recurrent_update_graph_through_the_kernels_is_the_loops(card):
    """One graphed recurrent update (2 epochs x 2 minibatches) through the
    LSTM kernels against the same update through the eager loop, from the
    same start and permutations: the params within one learning rate (as
    the graphed-against-eager test above), the metrics at the kernels'
    gradient tolerance; each replay adds T to both launch counters, the
    loop's none, and the capture counts nothing."""
    length, n, hidden = 32, 512, 128
    cfg = dataclasses.replace(get_preset("ppo_v2_0").ppo, arch="lstm",
                              minibatch_size=length * n // 2, epochs=2)
    runs = []
    for loop in (False, True):
        model = RecurrentActorCritic(6, 5, hidden, hidden)
        model.reset_parameters(torch.Generator().manual_seed(0)).to(card)
        if loop:
            model.cell.__class__ = _LoopCell
        opt = ClippedAdam(model.parameters(), cfg.learning_rate, 0.5)
        before = lstm_ops.fwd_launches, lstm_ops.bwd_launches
        metrics = rl_ppo.ppo_update_recurrent(
            model, opt, _recurrent_batch(length, n, hidden, card, 0), cfg,
            generator=torch.Generator(device=card).manual_seed(1))
        torch.cuda.synchronize()
        replays = 0 if loop else cfg.epochs * 2
        assert (lstm_ops.fwd_launches - before[0],
                lstm_ops.bwd_launches - before[1]) == (replays * length,
                                                       replays * length)
        assert rl_ppo._GRAPHS[opt].launches == (
            (0, 0) if loop else (length, length))
        runs.append((model, metrics))
    (got, got_metrics), (want, want_metrics) = runs
    for key in want_metrics:
        torch.testing.assert_close(got_metrics[key], want_metrics[key],
                                   rtol=2e-5, atol=2e-6, msg=key)
    for a, b in zip(got.parameters(), want.parameters(), strict=True):
        torch.testing.assert_close(a, b, rtol=0, atol=cfg.learning_rate)


# cuDNN's LSTM against the CPU's: other accumulation orders over up to 3
# layers x 20 steps; after one Adam step, a move of at most 3% of the
# learning rate 3e-4 where a gradient element is near 0.
LSTM_RTOL, LSTM_ATOL = 1e-4, 1e-5


@pytest.mark.parametrize("name", ["ConcentrationThresholdPredictor",
                                  "PeakAndStopPredictor"])
def test_zoo_forward_on_the_card_matches_the_cpu(card, name):
    model = getattr(lstm_zoo, name)().reset_parameters(
        torch.Generator().manual_seed(0))
    model.eval()
    x = torch.rand(1000, 20, generator=torch.Generator().manual_seed(1))
    lengths = torch.randint(1, 21, (1000,),
                            generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        want = model(x, lengths)
        got = model.to(card)(x.to(card), lengths.to(card))
    if not isinstance(want, tuple):
        got, want = (got,), (want,)
    for a, b in zip(got, want, strict=True):
        torch.testing.assert_close(a.cpu(), b, rtol=LSTM_RTOL,
                                   atol=LSTM_ATOL)


def test_lstm_trainer_step_on_the_card_matches_the_cpu(card):
    """One minibatch step of the threshold trainer (its dropout off): the
    loss and the updated params."""
    x = torch.rand(64, 10, generator=torch.Generator().manual_seed(3))
    y = 100.0 * torch.rand(64, generator=torch.Generator().manual_seed(4))
    out = {}
    for device in ("cpu", card):
        model = lstm_zoo.ConcentrationThresholdPredictor(
            dropout=0.0, head_dropout=0.0).reset_parameters(
                torch.Generator().manual_seed(5)).to(device)
        opt = lstm_trainer.ClippedAdamW(model.parameters(), 1e-2, 1.0)
        loss = lstm_trainer._run_epoch(
            model, opt, 3e-4, torch.arange(64)[None].numpy(),
            lambda a, b: lstm_trainer.smooth_l1(model(a), b, 2.0),
            x.to(device), y.to(device))
        out[str(device)] = (float(loss), {k: v.cpu() for k, v in
                                          model.state_dict().items()})
    (want_loss, want), (got_loss, got) = out["cpu"], out[str(card)]
    assert got_loss == pytest.approx(want_loss, rel=1e-5)
    for k, v in want.items():
        torch.testing.assert_close(got[k], v, rtol=LSTM_RTOL, atol=LSTM_ATOL)


def test_threshold_gated_eval_on_the_card_matches_the_cpu(card):
    cfg = get_preset("ppo_v2_0")
    n, length = 64, 200
    model = ActorCritic(cfg.env.obs_dim, cfg.env.num_actions)
    model.reset_parameters(torch.Generator().manual_seed(0))
    net = lstm_zoo.ConcentrationThresholdPredictor().reset_parameters(
        torch.Generator().manual_seed(1))
    with torch.no_grad():
        net.fc[4].bias.fill_(5.0)
    net.eval()
    draws = harnesses.draw_eval(torch.Generator().manual_seed(1), cfg.env,
                                length, n)
    out = {}
    for device in ("cpu", card):
        net.to(device)

        @torch.no_grad()
        def predict(window):
            return net(window / 100.0)

        gate = harnesses.make_threshold_gate(predict, cfg.stop)
        out[str(device)] = harnesses.evaluate_policy(
            model, cfg.env, cfg.eval, draws=draws, device=device,
            num_episodes=n, max_steps=length, stop_gate=gate)
    want, got = out["cpu"], out[str(card)]
    same = ((got.steps == want.steps)
            & (got.stopped_early == want.stopped_early))
    assert same.sum() >= n - 1, (got.steps, want.steps)
    torch.testing.assert_close(torch.from_numpy(got.deviations[same]),
                               torch.from_numpy(want.deviations[same]),
                               rtol=1e-5, atol=1e-4)
    assert want.stopped_early.any()


@pytest.mark.parametrize("case", ["v1_1", "v1_0", "obs_memory", "wrf_les"])
def test_env_step_kernel_with_an_executed_action_matches_plain(card, case):
    """The guided rollout's launch: a third of the envs execute another
    action than the one sampled; the record keeps the sampled action (the
    PyTorch argmax a guide sees), the override rows mark the others, and
    integers, bools and positions equal the plain version's."""
    cfg = _env_cfg(case)
    n = 4096
    state, accum, g = _env_start(cfg, n, 11 + len(case), card)
    for _ in range(8):
        logits = 2.0 * torch.randn(n, cfg.num_actions, device=card,
                                   generator=g)
        value = torch.randn(n, device=card, generator=g)
        draws = rollout.draw_chunk(g, cfg, 1, n)
        sampled = torch.argmax(logits + draws.gumbel[0], dim=-1)
        other = (sampled + torch.randint(1, cfg.num_actions, (n,),
                                         device=card, generator=g)
                 ) % cfg.num_actions
        executed = torch.where(
            torch.rand(n, device=card, generator=g) < 1 / 3, other, sampled)
        traj, obs = rollout.empty_trajectory(1, n, cfg, card, guided=True)
        k_state, k_acc = rollout.own_copy(state), rollout.own_copy(accum)
        plume.EnvStepper(k_state, k_acc, draws, traj, obs, cfg)(
            0, logits, value, executed)
        w_traj, w_obs = rollout.empty_trajectory(1, n, cfg, card,
                                                 guided=True)
        state, _, accum = rollout.env_step_plain(
            logits, value, draws, 0, state, accum, w_traj, w_obs, cfg,
            exec_action=executed)
        torch.cuda.synchronize()
        assert torch.equal(traj.action[0], sampled)
        assert torch.equal(traj.override[0], executed != sampled)
        for a, b in ((traj.action, w_traj.action), (traj.done, w_traj.done),
                     (traj.override, w_traj.override),
                     (traj.pos, w_traj.pos), (k_state.pos, state.pos),
                     (k_state.t, state.t), (k_state.visited, state.visited),
                     (k_state.prev_action, state.prev_action)):
            assert torch.equal(a, b)
        for a, b in ((obs[1], w_obs[1]), (traj.reward, w_traj.reward),
                     (traj.log_prob, w_traj.log_prob)):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-4)


def test_env_stepper_refuses_an_executed_action_without_override_rows(card):
    cfg = _env_cfg("v1_1")
    n = 64
    state, accum, g = _env_start(cfg, n, 0, card)
    draws = rollout.draw_chunk(g, cfg, 1, n)
    traj, obs = rollout.empty_trajectory(1, n, cfg, card)
    stepper = plume.EnvStepper(state, accum, draws, traj, obs, cfg)
    logits = torch.zeros(n, cfg.num_actions, device=card)
    value = torch.zeros(n, device=card)
    with pytest.raises(ValueError, match="override"):
        stepper(0, logits, value, torch.zeros(n, dtype=torch.int64,
                                              device=card))
    guided, gobs = rollout.empty_trajectory(1, n, cfg, card, guided=True)
    stepper = plume.EnvStepper(state, accum, draws, guided, gobs, cfg)
    with pytest.raises(TypeError):
        stepper(0, logits, value, torch.zeros(n, dtype=torch.int32,
                                              device=card))


# The bank step kernel's layouts: (bank shape, the bank's wind: None, a
# [K, 2] wind (0) or a [K, T, 2] one (T), 3-D flight).  The first four are
# the main layouts, each in the flight it is flown in; the others fly the
# kernel's remaining instantiations.
BANK_STEP_LAYOUTS = {
    "static": ((3, 64, 64), 0, False),
    "frames": ((3, 4, 64, 64), 4, False),
    "one_frame": ((3, 1, 5, 64, 64), None, True),
    "volumes": ((3, 4, 5, 64, 64), 4, True),
    "static_3d_flight": ((3, 64, 64), None, True),
    "frames_3d_flight": ((3, 4, 64, 64), 4, True),
    "one_frame_2d_flight": ((3, 1, 5, 64, 64), 0, False),
    "volumes_2d_flight": ((3, 4, 5, 64, 64), 4, False),
}
MAIN_BANK_LAYOUTS = ("static", "frames", "one_frame", "volumes")


def _bank_step_start(layout, n, seed, device):
    """wrf_les_3d's env on a 64-cell grid over a random bank of ``layout``
    (frames of 7 env steps, wind advection 0.5), episodes of 24 steps and
    radii of 4-40 cells, so that envs finish and reset within a chunk:
    ``(cfg, bank, state, accum, generator)`` from fresh episodes."""
    shape, wind_frames, env_3d = BANK_STEP_LAYOUTS[layout]
    cfg = dataclasses.replace(get_preset("wrf_les_3d").env, grid_size=64,
                              source_padding=8.0, domain_height=30.0,
                              env_3d=env_3d, max_steps=24)
    g = torch.Generator(device=device).manual_seed(seed)
    k = shape[0]
    wind = None
    if wind_frames is not None:
        frames = (wind_frames,) if wind_frames else ()
        wind = 2.0 * torch.randn((k,) + frames + (2,), device=device,
                                 generator=g)
    bank = FieldBank(
        conc=100.0 * torch.rand(shape, device=device, generator=g),
        source=8.0 + 48.0 * torch.rand(k, 2, device=device, generator=g),
        wind=wind, steps_per_frame=7.0, z_extent=30.0)
    carry = rollout.init_rollout(cfg, n, g, bank=bank)
    state = carry.env_state.replace(
        radius=4.0 + 36.0 * torch.rand(n, device=device, generator=g))
    return cfg, bank, state, carry.accum, g


def _bank_chunks(cfg, bank, state, accum, g, steps, greedy, guided, device):
    """One chunk of ``steps`` from ``state`` through the bank step kernel
    and through ``env_step_plain``, with the same logits, values and draws
    (and, ``guided``, a third of the sampled actions replaced by others):
    ``{kernel?: (traj, obs rows, state, totals)}``."""
    n, a = state.pos.shape[0], cfg.num_actions
    draws = rollout.draw_chunk(g, cfg, steps, n, greedy)
    logits = 2.0 * torch.randn(steps, n, a, device=device, generator=g)
    values = torch.randn(steps, n, device=device, generator=g)
    other = torch.randint(0, a, (steps, n), device=device, generator=g)
    flip = torch.rand(steps, n, device=device, generator=g) < 1 / 3
    runs = {}
    for kernel in (True, False):
        s, acc = rollout.own_copy(state), rollout.own_copy(accum)
        traj, obs = rollout.empty_trajectory(steps, n, cfg, device,
                                             guided=guided)
        if kernel:
            stepper = plume.BankStepper(s, acc, draws, traj, obs, cfg, bank)
        for t in range(steps):
            executed = None
            if guided:
                noisy = logits[t] if greedy else logits[t] + draws.gumbel[t]
                executed = torch.where(flip[t], other[t],
                                       torch.argmax(noisy, -1))
            if kernel:
                stepper(t, logits[t], values[t], executed)
            else:
                s, _, acc = rollout.env_step_plain(
                    logits[t], values[t], draws, t, s, acc, traj, obs, cfg,
                    bank, exec_action=executed)
        runs[kernel] = (traj, obs, s, acc)
    torch.cuda.synchronize()
    return runs


def _assert_bit_equal(got, want):
    """Every trajectory, record, next-obs, state and totals tensor equal."""
    (traj, obs, s, acc), (w_traj, w_obs, w_s, w_acc) = got, want
    pairs = {"obs rows": (obs[1:], w_obs[1:])}
    for f in dataclasses.fields(traj):
        x, y = getattr(traj, f.name), getattr(w_traj, f.name)
        if f.name == "episode":
            for e in dataclasses.fields(x):
                pairs["record " + e.name] = (getattr(x, e.name),
                                             getattr(y, e.name))
        elif x is not None and f.name != "obs":
            pairs["step " + f.name] = (x, y)
    for f in dataclasses.fields(s):
        if f.name == "field":
            for e in ("source", "seed", "idx"):
                pairs["field " + e] = (getattr(s.field, e),
                                       getattr(w_s.field, e))
        else:
            pairs[f.name] = (getattr(s, f.name), getattr(w_s, f.name))
    for name in plume.ACCUM_FIELDS:
        pairs["accum " + name] = (getattr(acc, name), getattr(w_acc, name))
    for name, (x, y) in pairs.items():
        assert torch.equal(x, y), (name, int((x != y).sum()))


@pytest.mark.parametrize("greedy", [False, True], ids=["gumbel", "greedy"])
@pytest.mark.parametrize("n", [4096, 32768])
@pytest.mark.parametrize("layout", MAIN_BANK_LAYOUTS)
def test_bank_step_kernel_is_bit_equal_to_plain(card, layout, n, greedy):
    """128 steps of the bank step kernel against ``env_step_plain`` on the
    card from the same start, each path on its own state: every tensor
    equal to the bit, one launch a step, envs finishing and resetting."""
    cfg, bank, state, accum, g = _bank_step_start(layout, n, n + len(layout),
                                                  card)
    before = plume.bank_step_launches
    runs = _bank_chunks(cfg, bank, state, accum, g, 128, greedy, False, card)
    assert plume.bank_step_launches == before + 128
    _assert_bit_equal(runs[True], runs[False])
    assert int(runs[True][0].done.sum()) > n


@pytest.mark.parametrize("layout", sorted(BANK_STEP_LAYOUTS))
def test_bank_step_kernel_with_an_executed_action_is_bit_equal_to_plain(
        card, layout):
    """The guided launch over a bank: a third of the envs execute another
    action than the one sampled, the override rows mark them; every tensor
    equal to the plain version's, at each of the kernel's instantiations."""
    cfg, bank, state, accum, g = _bank_step_start(layout, 4096, 7, card)
    runs = _bank_chunks(cfg, bank, state, accum, g, 128, False, True, card)
    _assert_bit_equal(runs[True], runs[False])
    override = runs[True][0].override
    assert override.any() and not override.all()


def test_rollout_over_a_bank_on_the_card_is_one_bank_step_launch_a_step(card):
    cfg, bank, _, _, g = _bank_step_start("volumes", 512, 0, card)
    carry = rollout.init_rollout(cfg, 512, g, bank=bank)
    kept = rollout.own_copy(carry.env_state)
    model = ActorCritic(cfg.obs_dim, cfg.num_actions, (64, 32)).to(card)

    def counts():
        return (plume.launches, plume.env_step_launches,
                plume.bank_step_launches, gather.bilinear.launches,
                gather.trilinear_zyx.launches)

    before = counts()
    new, _, _ = rollout.rollout_chunk(model, carry, cfg, 16, bank=bank)
    torch.cuda.synchronize()
    assert counts() == (before[0], before[1], before[2] + 16, before[3],
                        before[4])
    # the carry passed in is not modified
    for name in ("pos", "t", "visited"):
        assert torch.equal(getattr(carry.env_state, name),
                           getattr(kept, name))
    assert torch.equal(carry.env_state.field.idx, kept.field.idx)
    assert not torch.equal(new.env_state.pos, carry.env_state.pos)


def test_bank_stepper_raises_on_bad_cuda_inputs(card):
    cfg, bank, state, accum, g = _bank_step_start("volumes", 64, 0, card)
    draws = rollout.draw_chunk(g, cfg, 1, 64)
    traj, obs = rollout.empty_trajectory(1, 64, cfg, card)
    stepper = plume.BankStepper(state, accum, draws, traj, obs, cfg, bank)
    logits = torch.zeros(64, cfg.num_actions, device=card)
    value = torch.zeros(64, device=card)
    with pytest.raises(TypeError):
        stepper(0, logits.double(), value)
    with pytest.raises(IndexError):
        stepper(1, logits, value)
    with pytest.raises(ValueError, match="override"):
        stepper(0, logits, value, torch.zeros(64, dtype=torch.int64,
                                              device=card))
    with pytest.raises(ValueError):
        plume.BankStepper(state, accum, draws, traj, obs, cfg,
                          bank.to("cpu"))
    with pytest.raises(ValueError):
        plume.BankStepper(state, accum, draws, traj, obs,
                          dataclasses.replace(cfg, subcell_sampling=False),
                          bank)


@pytest.mark.parametrize("preset", ["ppo_v2_0", "wrf_les"])
def test_guided_rollout_on_the_card_matches_the_cpu(card, preset):
    """The fit guide in a rollout chunk of 256 envs x 24 steps on a small
    domain: one env-step launch a step, and at most one env in 64 apart
    from the CPU's actions, overrides or dones."""
    from tpu_plume_torch.evaluation.guidance import make_guide

    cfg = dataclasses.replace(get_preset(preset).env, grid_size=250,
                              source_padding=25.0, move_frac=0.1,
                              max_steps=20)
    n, t = 256, 24
    guide = make_guide(cfg)
    model = ActorCritic(cfg.obs_dim, cfg.num_actions, (64, 32))
    model.reset_parameters(torch.Generator().manual_seed(0))
    carry = rollout.init_rollout(cfg, n, torch.Generator().manual_seed(1),
                                 guide=guide)
    draws = rollout.draw_chunk(torch.Generator().manual_seed(2), cfg, t, n)
    _, want, _ = rollout.rollout_chunk(model, carry, cfg, t, draws=draws,
                                       guide=guide)
    before = plume.env_step_launches
    _, got, _ = rollout.rollout_chunk(
        model.to(card), _moved(carry, card), cfg, t,
        draws=_moved(draws, card), guide=guide)
    torch.cuda.synchronize()
    assert plume.env_step_launches == before + t
    off = ((got.action.cpu() != want.action)
           | (got.override.cpu() != want.override)
           | (got.done.cpu() != want.done)).any(0)
    assert int(off.sum()) <= n // 64
    assert want.override.any() and want.done.any()


@pytest.mark.parametrize("preset", ["ppo_v2_0", "wrf_les"])
def test_guided_eval_on_the_card_matches_the_cpu(card, preset):
    from tpu_plume_torch.evaluation.guidance import make_guide

    cfg = get_preset(preset)
    cfg = cfg.replace(env=dataclasses.replace(
        cfg.env, grid_size=250, source_padding=25.0, move_frac=0.1))
    n, length = 64, 200
    model = ActorCritic(cfg.env.obs_dim, cfg.env.num_actions)
    model.reset_parameters(torch.Generator().manual_seed(0))
    draws = harnesses.draw_eval(torch.Generator().manual_seed(1), cfg.env,
                                length, n)
    kw = dict(num_episodes=n, max_steps=length, draws=draws,
              guide=make_guide(cfg.env))
    want = harnesses.evaluate_policy(model, cfg.env, cfg.eval, device="cpu",
                                     **kw)
    before = plume.launches
    got = harnesses.evaluate_policy(model, cfg.env, cfg.eval, device=card,
                                    **kw)
    assert plume.launches == before + length + 1
    same = ((got.steps == want.steps)
            & (got.guide_fit_ok == want.guide_fit_ok)
            & (got.guide_samples == want.guide_samples))
    assert same.sum() >= n - 1, (got.steps, want.steps)
    torch.testing.assert_close(torch.from_numpy(got.deviations[same]),
                               torch.from_numpy(want.deviations[same]),
                               rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("kind", ["static", "3d"])
def test_bank_guided_eval_on_the_card_matches_the_cpu(card, kind):
    """The bank guide over a small bank (a static [3, 64, 64] one read
    between cells, a 3-D [2, 3, 4, 64, 64] one in 3-D flight with
    guard_top, sticky_target and dive_bias), 64 episodes x 150 steps: one
    bank-sample launch a step plus one at the reset, and at most one
    episode in 64 apart from the CPU in steps, gate or matched row."""
    from tpu_plume_torch.evaluation.bank_guide import make_bank_guide
    from tpu_plume_torch.fields import gridded

    preset, kw = (("ppo_v2_0", {}) if kind == "static" else
                  ("wrf_les_3d", dict(guard_top=1, sticky_target=True,
                                      dive_bias=True)))
    cfg = get_preset(preset)
    env = dataclasses.replace(cfg.env, grid_size=64, source_padding=8.0,
                              move_frac=0.0625, plume_model="gridded",
                              subcell_sampling=True, initial_radius=12.0,
                              domain_height=24.0)
    cfg = cfg.replace(env=env)
    gen = torch.Generator().manual_seed(0)
    if kind == "static":
        bank = gridded.synthesize_bank(gen, env, num_fields=3)
        name = "bilinear"
    else:
        bank = gridded.synthesize_3d_bank(gen, env, num_fields=2,
                                          num_frames=3, num_levels=4,
                                          steps_per_frame=8.0)
        name = "trilinear_zyx"
    n, length = 64, 150
    model = ActorCritic(env.obs_dim, env.num_actions)
    model.reset_parameters(torch.Generator().manual_seed(0))
    draws = harnesses.draw_eval(torch.Generator().manual_seed(1), env,
                                length, n)
    guide = make_bank_guide(env, len(bank.source), terminate_radius=12.0,
                            success_radius=18.0, search_after=20, **kw)
    args = dict(num_episodes=n, max_steps=length, draws=draws, guide=guide)
    want = harnesses.evaluate_policy(model, env, cfg.eval, device="cpu",
                                     bank=bank, **args)
    kernel = getattr(gather, name)
    before = kernel.launches
    got = harnesses.evaluate_policy(model, env, cfg.eval, device=card,
                                    bank=bank.to(card), **args)
    torch.cuda.synchronize()
    assert kernel.launches == before + length + 1
    same = ((got.steps == want.steps)
            & (got.guide_fit_ok == want.guide_fit_ok)
            & (got.guide_match == want.guide_match)
            & np.isclose(got.deviations, want.deviations, rtol=1e-5,
                         atol=1e-4))
    assert same.sum() >= n - 1, (got.steps, want.steps)
    assert want.guide_fit_ok.any()


@pytest.mark.parametrize("features", ["xyc", "xycd"])
def test_learned_guided_eval_on_the_card_matches_the_cpu(card, features):
    """The learned guide (a localizer of its init, window 16) in ppo_v2_0's
    eval on a small domain, 64 episodes x 200 steps: one plume-sample
    launch a step plus one, at most one episode in 64 apart from the CPU;
    ``localize_from_trajectories`` on the card within 1e-2 px of the
    CPU's."""
    from tpu_plume_torch.evaluation.learned_guide import make_learned_guide
    from tpu_plume_torch.evaluation.localize import (
        localize_from_trajectories,
    )

    cfg = get_preset("ppo_v2_0")
    cfg = cfg.replace(env=dataclasses.replace(
        cfg.env, grid_size=250, source_padding=25.0, move_frac=0.1))
    n, length = 64, 200
    model = ActorCritic(cfg.env.obs_dim, cfg.env.num_actions)
    model.reset_parameters(torch.Generator().manual_seed(0))
    loc = lstm_zoo.GaussianParamPredictor(
        hidden_size=16, input_size=6 if features == "xycd" else 3)
    loc.reset_parameters(torch.Generator().manual_seed(2)).eval()
    draws = harnesses.draw_eval(torch.Generator().manual_seed(1), cfg.env,
                                length, n)
    out, preds = {}, {}
    for device in ("cpu", card):
        loc.to(device)
        guide = make_learned_guide(cfg.env, loc, window=16, min_window=4,
                                   check_every=2, stable_tol=4.0,
                                   features=features)
        before = plume.launches
        out[str(device)] = harnesses.evaluate_policy(
            model, cfg.env, cfg.eval, device=device, num_episodes=n,
            max_steps=length, draws=draws, guide=guide,
            track_trajectories=n)
        if device != "cpu":
            torch.cuda.synchronize()
            assert plume.launches == before + length + 1
        if features == "xyc":
            preds[str(device)] = localize_from_trajectories(
                out["cpu"].trajectories, loc, window=16,
                grid_size=cfg.env.grid_size)
    want, got = out["cpu"], out[str(card)]
    same = ((got.steps == want.steps)
            & (got.guide_fit_ok == want.guide_fit_ok)
            & np.isclose(got.deviations, want.deviations, rtol=1e-5,
                         atol=1e-4))
    assert same.sum() >= n - 1, (got.steps, want.steps)
    if preds:
        gap = abs(preds[str(card)] - preds["cpu"]).max()
        assert gap < 1e-2, gap


def test_oracle_eval_on_the_card_matches_the_cpu(card):
    """The phase oracle in place of the policy, 256 episodes x 200 steps,
    and its expert data: the same steps, deviations at the env tolerance,
    the same samples and actions."""
    from tpu_plume_torch.evaluation.oracle import make_oracle

    cfg = get_preset("ppo_v2_0")
    n, length = 256, 200
    draws = harnesses.draw_eval(torch.Generator().manual_seed(3), cfg.env,
                                length, n)
    oracle = make_oracle("phase", cfg.env)
    kw = dict(num_episodes=n, max_steps=length, draws=draws, oracle=oracle)
    want = harnesses.evaluate_policy(None, cfg.env, cfg.eval, device="cpu",
                                     **kw)
    got = harnesses.evaluate_policy(None, cfg.env, cfg.eval, device=card,
                                    **kw)
    assert (got.steps == want.steps).all()
    torch.testing.assert_close(torch.from_numpy(got.deviations),
                               torch.from_numpy(want.deviations),
                               rtol=1e-5, atol=1e-4)
    assert want.success.mean() > 0.5
    env = dataclasses.replace(cfg.env, max_steps=length)
    expert = {}
    for device in ("cpu", card):
        expert[str(device)] = harnesses.generate_expert_data(
            None, env, num_episodes=n, draws=draws, device=device,
            oracle=oracle)
    (ws, wa), (gs, ga) = expert["cpu"], expert[str(card)]
    assert (ga == wa).all() and len(wa) > 0
    torch.testing.assert_close(torch.from_numpy(gs), torch.from_numpy(ws),
                               rtol=1e-5, atol=1e-4)


def test_labelled_rollout_on_the_card_matches_the_cpu(card):
    """Distilled PPO's teacher in a rollout chunk of 256 envs x 24 steps:
    one env-step launch a step (the oracle reads the state before the
    kernel updates it in place), and at most one env in 64 apart from the
    CPU's labels, actions or dones."""
    from tpu_plume_torch.evaluation.oracle import make_oracle

    cfg = dataclasses.replace(get_preset("ppo_v2_0").env, grid_size=250,
                              source_padding=25.0, move_frac=0.1,
                              max_steps=20)
    n, t = 256, 24
    oracle = make_oracle("phase", cfg)
    model = ActorCritic(cfg.obs_dim, cfg.num_actions, (64, 32))
    model.reset_parameters(torch.Generator().manual_seed(0))
    carry = rollout.init_rollout(cfg, n, torch.Generator().manual_seed(1))
    draws = rollout.draw_chunk(torch.Generator().manual_seed(2), cfg, t, n)
    _, want, _ = rollout.rollout_chunk(model, carry, cfg, t, draws=draws,
                                       oracle=oracle)
    before = plume.env_step_launches
    _, got, _ = rollout.rollout_chunk(
        model.to(card), _moved(carry, card), cfg, t,
        draws=_moved(draws, card), oracle=oracle)
    torch.cuda.synchronize()
    assert plume.env_step_launches == before + t
    off = ((got.oracle_action.cpu() != want.oracle_action)
           | (got.action.cpu() != want.action)
           | (got.done.cpu() != want.done)).any(0)
    assert int(off.sum()) <= n // 64
    assert want.done.any() and len(want.oracle_action.unique()) > 1


def test_gail_step_on_the_card_matches_the_cpu(card):
    """One closed-loop GAIL iteration of 64 envs x 16 steps from the same
    params, discriminator, draws, shuffles and discriminator rows: actions
    and dones equal, the discriminator's loss and the policy's losses at
    rtol 1e-4 / atol 1e-5, 16 env-step launches."""
    from tpu_plume_torch.train import gail_trainer as tgail
    from tpu_plume_torch.train import ppo_trainer as ttrain

    cfg = get_preset("ppo_v2_0")
    cfg = cfg.replace(
        env=dataclasses.replace(cfg.env, max_steps=6, initial_radius=200.0),
        ppo=dataclasses.replace(cfg.ppo, hidden_sizes=(64, 32),
                                minibatch_size=256),
        rollout=dataclasses.replace(cfg.rollout, num_envs=64,
                                    unroll_length=16))
    g = torch.Generator().manual_seed(4)
    expert = (torch.randn(128, cfg.env.obs_dim, generator=g),
              torch.randint(0, cfg.env.num_actions, (128,), generator=g))
    rows = (torch.randint(0, 128, (64,), generator=g),
            torch.randint(0, 64 * 16, (64,), generator=g))
    draws = rollout.draw_chunk(torch.Generator().manual_seed(5), cfg.env, 16,
                               64)
    shuffles = [3, 77, 0, 101, 64]
    cpu = ttrain.init_loop(cfg, "cpu")
    out = {}
    for dev in ("cpu", card):
        model = ttrain.make_policy_model(cfg).to(dev)
        model.load_state_dict(cpu.model.state_dict())
        loop = dataclasses.replace(
            cpu, model=model,
            optimizer=ttrain.ClippedAdam(model.parameters(),
                                         cfg.ppo.learning_rate,
                                         cfg.ppo.max_grad_norm),
            rollout=dataclasses.replace(
                _moved(cpu.rollout, dev),
                generator=torch.Generator(device=dev)))
        disc, opt = tgail.make_disc_state(cfg, dev, 1)
        step = tgail.build_gail_train_step(
            cfg, *(x.to(dev) for x in expert), closed_loop=True,
            disc_batch=64)
        before = plume.env_step_launches
        _, stats, traj = step(
            tgail.GAILCarry(ppo=loop, disc=disc, disc_optimizer=opt), 0.1,
            draws=_moved(draws, dev), shuffles=shuffles,
            disc_idx=tuple(x.to(dev) for x in rows))
        out[str(dev)] = (stats, traj, plume.env_step_launches - before)
    (cstats, ctraj, _), (gstats, gtraj, launches) = out["cpu"], out[str(card)]
    assert launches == 16
    assert torch.equal(gtraj.action.cpu(), ctraj.action)
    assert torch.equal(gtraj.done.cpu(), ctraj.done)
    for key in ("loss/total", "loss/value", "gail/disc_loss",
                "gail/disc_acc"):
        assert np.isclose(float(gstats[key]), float(cstats[key]), rtol=1e-4,
                          atol=1e-5), key


def _counts():
    return (plume.launches, plume.env_step_launches, fused_ops.launches,
            gather.bilinear.launches, gather.trilinear_zyx.launches)


@pytest.mark.parametrize("survey", ["raster", "two_pass"])
def test_flux_study_on_the_card_matches_the_cpu(card, survey):
    """The flux study, 16 episodes x 160 steps of the raster survey (40 of
    them pass 2 in the two-pass survey), estimated positions: one
    plume-sample launch a survey step plus the reset's and no other
    counted launch; on the card against the CPU from the same draws, the
    flights within the env tolerance in all but at most one episode (and, after two passes,
    those whose pass-1 estimates part beyond 0.05 px), on the others the
    observed flags equal and the observed sources' true-position strengths
    within rtol 1e-3 (an unobserved source's column is near zero and its
    ridge-regularised strength ill-conditioned),
    and the estimated positions within 0.05 px in at least 12 of 16 (the
    fits and the LM of a near-degenerate mixture amplify rounding)."""
    from tpu_plume_torch.evaluation import flux
    from tpu_plume_torch.evaluation.oracle import make_oracle

    cfg = dataclasses.replace(get_preset("ppo_v2_0").env, num_sources=3)
    n, steps = 16, 160
    refine = 40 if survey == "two_pass" else 0
    draws = harnesses.draw_eval(torch.Generator().manual_seed(5), cfg, steps,
                                n, greedy=False)
    oracle = make_oracle("raster", cfg, raster_band_scale=2.0)
    before = _counts()
    out = flux.flux_inversion_study(cfg, num_episodes=n, num_steps=steps,
                                    estimated_positions=True, oracle=oracle,
                                    refine_steps=refine, draws=draws,
                                    device=card)
    after = _counts()
    assert after[0] - before[0] == steps + 1
    assert after[1:] == before[1:]
    assert out["episodes"] == n
    parts = {}
    for device in ("cpu", card):
        _, _, _, d, state, obs = harnesses._start(
            None, cfg, device, None, draws, n, steps, False, None, None)
        sv = flux.fly_survey(cfg, state, obs, d, steps, oracle=oracle,
                             refine_steps=refine)
        parts[str(device)] = sv, [
            [x.cpu() for x in flux.score_survey(sv, cfg, est)]
            for est in (False, True)]
    (sv_c, (true_c, est_c)), (sv_g, (true_g, est_g)) = (
        parts["cpu"], parts[str(card)])
    same = torch.isclose(sv_g.points.cpu(), sv_c.points, rtol=1e-5,
                         atol=1e-4).all(-1).all(-1)
    if refine:
        seeds_apart = (sv_g.seeds.cpu() - sv_c.seeds).abs().amax((1, 2)) > 0.05
        same_or_seeds = same | seeds_apart
    else:
        same_or_seeds = same
    assert int((~same_or_seeds).sum()) <= 1
    seen = same[:, None] & true_c[4]
    torch.testing.assert_close(true_g[0][seen], true_c[0][seen], rtol=1e-3,
                               atol=1e-6)
    assert torch.equal(true_g[4][same], true_c[4][same])
    gap = (est_g[2] - est_c[2]).abs().amax((1, 2))
    assert int((gap[same] <= 0.05).sum()) >= int(same.sum()) - 4


def _small_train_cfg(**ppo):
    cfg = get_preset("ppo_v2_0")
    return cfg.replace(
        ppo=dataclasses.replace(cfg.ppo, minibatch_size=1024, **ppo),
        rollout=dataclasses.replace(cfg.rollout, num_envs=256,
                                    unroll_length=16))


def _same(a, b, where=""):
    if isinstance(a, torch.Tensor):
        assert torch.equal(a, b), where
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _same(a[k], b[k], f"{where}/{k}")
    elif isinstance(a, (list, tuple)):
        for i, (x, y) in enumerate(zip(a, b, strict=True)):
            _same(x, y, f"{where}[{i}]")
    else:
        assert a == b, where


@pytest.mark.parametrize("ppo", [{}, {"fused_update": True}])
def test_resume_on_the_card_is_bit_exact(card, tmp_path, ppo):
    from tpu_plume_torch.train import ppo_trainer as ttrain

    cfg = _small_train_cfg(**ppo)
    kw = dict(device="cuda", verbose=False, sync_every=2)
    full, part = str(tmp_path / "full"), str(tmp_path / "part")
    ttrain.train_ppo(cfg, full, max_iterations=4, **kw)
    ttrain.train_ppo(cfg, part, max_iterations=2, snapshot_every=2, **kw)
    ttrain.train_ppo(cfg, part, max_iterations=4, **kw,
                     resume_from=str(tmp_path / "part" /
                                     "checkpoint_iter000002"))
    a, b = (torch.load(f"{d}/checkpoint.pt", weights_only=True)
            for d in (full, part))
    for key in ("model", "optimizer", "rollout", "generator", "counters",
                "curriculum"):
        _same(a[key], b[key], key)
    assert ((tmp_path / "full" / "training_results.csv").read_text()
            == (tmp_path / "part" / "training_results.csv").read_text())


def test_mesh_step_at_world_size_1_is_the_plain_step(card, tmp_path):
    import torch.distributed as dist

    from tpu_plume_torch.parallel import make_mesh, shard_loop_carry
    from tpu_plume_torch.train import ppo_trainer as ttrain

    dist.init_process_group(
        "nccl", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
        world_size=1)
    try:
        mesh = make_mesh(1)
        assert mesh.device.type == "cuda" and mesh.world_size == 1
        for ppo in ({}, {"fused_update": True}):
            cfg = _small_train_cfg(**ppo)
            step = ttrain.build_train_step(cfg)
            outs = []
            for laid in (False, True):
                loop = ttrain.init_loop(cfg, "cuda")
                if laid:
                    loop = shard_loop_carry(loop, mesh)
                before = (plume.env_step_launches, fused_ops.launches)
                for _ in range(2):
                    loop, stats, traj = step(loop)
                launches = (plume.env_step_launches - before[0],
                            fused_ops.launches - before[1])
                outs.append((traj, stats, loop.model.state_dict(), launches))
            (pt, ps, pm, pl), (mt, ms, mm, ml) = outs
            assert pl == ml and pl[0] == 2 * 16
            for f in ("action", "done", "reward", "value", "log_prob"):
                assert torch.equal(getattr(pt, f), getattr(mt, f)), f
            for k in ps:
                assert float(ps[k]) == float(ms[k]), k
            _same(pm, mm, "params")
    finally:
        dist.destroy_process_group()
