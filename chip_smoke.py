"""Smoke run of the PyTorch/CUDA port (``tpu_plume_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA card and ``nvcc``; exits non-zero without them, and when run
outside a checkout of the repository.  Phases, each of which must pass:

1. the card's name and power limit, torch and CUDA versions;
2. the build of every CUDA kernel of the main paths from
   ``tpu_plume_torch/csrc``, one ``nvcc`` per source, all started together;
3. each kernel against its plain PyTorch version on the same inputs, with
   the tolerance the CPU tests use: the plume sample at the main path's
   shape and a large one, and the fresh-episode sample of the anisotropic,
   3-D and three-source fields; the env-step kernel (one analytic env step
   of every env a launch) against ``env_step_plain``, teacher-forced over
   24 steps (each from the plain path's state) of the v1_1 (Gumbel and
   greedy), v1_0, delta and obs_memory cases and of the analytic modes of
   the wrf_les slice (wrf_les's anisotropic plume, with and without wind
   advection, three isotropic sources, 3-D flight over the isotropic and
   the anisotropic plume, and the anisotropic plume of three sources in
   3-D flight with the delta reward) at N = 4096 and 4133, with integers,
   bools and positions bit-equal; the fused PPO gradients in
   f32 and bf16 compute, at obs widths 6 and 12, hidden widths (256, 128) and (64, 32) and
   minibatches of 65536 and 512 rows, with two calls giving bit-equal
   gradients, and in f32 also against autodiff of ``ppo_loss``; the
   bilinear and trilinear gathers at the TPU kernels' own call (one
   [500, 500] field, one [8, 500, 500] volume) and at a bank's stacks
   ([64, 500, 500], [32, 8, 500, 500]) at N = 4096 and 2^20, bit-equal or
   within 1e-6 x max|field|, two calls bit-equal; the same kernels' bank
   sample (the env step's sub-cell sample, one launch) against
   ``sample_bank_conc_tke_plain`` at every bank layout (static [64, 500,
   500], time-varying [8, 16, 500, 500], 3-D [4, 8, 8, 500, 500] in 3-D
   and 2-D flight, one-frame [4, 1, 8, 500, 500]) with frames of 100 env
   steps, N = 4096 and 2^20, both turbulence flag sets, within the plume
   tolerance, two calls bit-equal, and bit-equal with the turbulence off;
4. each kernel's time, its plain version's and the least time the card
   could take for the same bytes and operations (the plume sample and the
   env step with the host cost of each piece of their wrappers; the env
   step on ppo_v2_0's isotropic plume and on wrf_les's anisotropic one);
   for the
   fused PPO
   gradients (three launches: the row kernel, the split-K dW2 kernel and
   the reduction) the device time of each launch, their sum and its share
   of the bound, and autodiff's forward and backward of ``ppo_loss`` on the
   same minibatch; for the gathers also ``grid_sample`` on the same field or
   volume (checked to agree within 1e-4 x max|field|), in two alternating
   blocks (kernel, grid_sample, grid_sample, kernel); for the bank sample
   its time over the main paths' banks and the host cost of each piece of
   its wrapper;
5. one train iteration at a small size on the card against the same
   iteration on the CPU (the CPU path is the one the tests hold to the JAX
   package): f32, ``fused_update``, ``bf16_compute``, and both; wrf_les;
   wrf_les_3d over a 64-cell [2, 3, 4, 64, 64] bank; a static [3, 64, 64]
   bank read between cells;
6. the main paths at full width, 4096 envs x 128 steps, minibatch 65536,
   5 epochs, each driven as ``train_ppo`` drives it, with the kernel launch
   counts set to 0 just before ``init_loop`` and read just after the last
   iteration (``init_loop``, one warm-up and the timed iterations, each
   stretch's launches checked), then one rollout chunk and one iteration
   under the profiler (the chunk's launches per env step and the
   iteration's launches printed): the ppo_v2_0 train step (one env-step
   launch per env step) with
   the 6->256->128 network in three variants (f32 autodiff,
   ``fused_update``, ``bf16_compute``); wrf_les (the anisotropic plume in
   a per-episode wind, one env-step launch per env step, the 6->256->128
   network); wrf_les_3d (3-D flight through the
   [4, 8, 8, 500, 500] bank of ``--synth-bank 3d``, the 7->256->128 network;
   one trilinear launch a sample); the 64-field static bank of
   ``--synth-bank static`` read between cells (one bilinear launch a
   sample);
7. the ``train`` CLI for two iterations at the same width: ppo_v2_0 in f32
   and with ``--bf16``, ``--preset wrf_les``, and ``--preset wrf_les_3d
   --synth-bank 3d``.

Then it prints the ``kernels`` JSON line, the card's name and power limit,
and, last, the result line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import ctypes
import dataclasses
import io
import json
import math
import os
import subprocess
import sys
import tempfile
import time
import types

REPO = os.path.dirname(os.path.abspath(__file__))

# Published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, float32
# operations/s outside the tensor cores, and dense bf16 operations/s in them.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
BF16_TENSOR_OPS_PER_S = 989e12
# Operations of one plume query, counting each transcendental as one: about
# 12 for the Gaussian base, 69 integer operations for three two-round cell
# hashes, 9 to turn three hashes into uniforms, 8 for Box-Muller, 6 for the
# wave term and 9 for turbulence, clip and TKE.
PLUME_OPS_PER_QUERY = 113
MAIN_N = 4096
LARGE_N = 1 << 20
RTOL, ATOL = 1e-5, 1e-4
# Fused PPO gradients: the tolerances of tests/test_fused_update.py.
GRAD_ATOL_PER_MAX = 2e-5
METRIC_RTOL, METRIC_ATOL = 2e-5, 2e-6
# The main path's minibatch, obs width, hidden widths and actions.
MAIN_MB, MAIN_D, MAIN_HIDDEN, MAIN_A = 65536, 6, (256, 128), 5
# LayerNorm, ReLU and their backward: operations per hidden unit and row.
PPO_ELEMENTWISE_OPS = 22
# Gathers: the TPU kernels' own calls and a bank's stacks (the static bank
# of ``--synth-bank static``, and the [K*T, Z, H, W] view of a [32, ...]
# 3-D bank); parity within this share of max|field|.
GATHER_SHAPES = {"bilinear": ((1, 500, 500), (64, 500, 500)),
                 "trilinear_zyx": ((1, 8, 500, 500), (32, 8, 500, 500))}
GATHER_ATOL_PER_MAX = 1e-6
GRID_SAMPLE_ATOL_PER_MAX = 1e-4
# Bank samples: (bank shape, 3-D flight) of each layout, frames of a
# number of env steps that is not a power of two; the main paths' layouts
# are the static bank of ``--synth-bank static`` and the bank of
# ``--synth-bank 3d`` in 3-D flight.
SAMPLE_LAYOUTS = {"static": ((64, 500, 500), False),
                  "frames": ((8, 16, 500, 500), False),
                  "volumes": ((4, 8, 8, 500, 500), True),
                  "volumes_2d_flight": ((4, 8, 8, 500, 500), False),
                  "one_frame": ((4, 1, 8, 500, 500), True)}
SAMPLE_SPF = 100.0
V10_FLAGS = dict(turbulence_signed_normal=True, tke_abs_times_two=True)
# The env-step kernel: the env cases of tests/test_torch_env.py (the v1_1,
# v1_0 with elastic walls, and delta rewards with its in-plume, depth and
# gate terms, and obs_memory), teacher-forced over ENV_STEPS steps, at the
# main path's N and at an N that is not a multiple of the kernel's block.
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
# The fresh-episode samples of the analytic modes beside ppo_v2_0's and
# ppo_v1_0's isotropic plume.
SAMPLE_MODES = ("wrf_les", "aniso_3d", "iso_s3", "aniso_3d_s3_delta")
ENV_STEPS = 24
ENV_ODD_N = MAIN_N + 37
# Operations of one env step beside its plume samples, counting each
# transcendental as one: the action sample (about 4 a logit, an exp each
# and a log), the move and its clip (about 20), the visit, reward terms,
# terminal bonus and obs (about 50).
ENV_STEP_OPS = 90
# Operations the anisotropic base adds to a plume query's, a source: the
# unit wind (about 8), the downwind and crosswind distances (about 8), the
# crosswind spread with its pow (4), the centerline (3), two exponentials
# with their arguments (8), and the blob's max and select (4).
ANISO_OPS_PER_SOURCE = 35


def log(*parts):
    print(*parts, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean ms of ``fn()`` over ``reps`` back-to-back calls, by CUDA events
    after a warm-up."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def plume_inputs(n: int, seed: int):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    pos = torch.rand(n, 2, device="cuda", generator=g) * 520.0 - 10.0
    source = 50.0 + 400.0 * torch.rand(n, 2, device="cuda", generator=g)
    seed_bits = torch.randint(-(2**31), 2**31, (n,), dtype=torch.int32,
                              device="cuda", generator=g)
    return pos, source, seed_bits


def check_plume_kernel(get_preset, plume) -> dict:
    """Kernel against plain version at both sizes and both flag sets; the
    kernel's and plain version's times and the bound at both sizes."""
    import torch

    worst = 0.0
    for preset in ("ppo_v2_0", "ppo_v1_0"):
        cfg = get_preset(preset).env
        for n in (MAIN_N, LARGE_N):
            args = plume_inputs(n, seed=n + len(preset))
            conc, tke = plume.sample_plume_cuda(*args, cfg)
            torch.cuda.synchronize()
            want_c, want_t = plume.sample_plume_plain(*args, cfg)
            err = max(float((conc - want_c).abs().max()),
                      float((tke - want_t).abs().max()))
            log(f"parity plume_sample {preset} N={n}: max_abs_err {err:.3e}")
            torch.testing.assert_close(conc, want_c, rtol=RTOL, atol=ATOL)
            torch.testing.assert_close(tke, want_t, rtol=RTOL, atol=ATOL)
            assert torch.isfinite(conc).all() and torch.isfinite(tke).all()
            worst = max(worst, err)

    cfg = get_preset("ppo_v2_0").env
    timing = {}
    for n, reps in ((MAIN_N, 2000), (LARGE_N, 200)):
        args = plume_inputs(n, seed=7)
        ms = cuda_ms(lambda: plume.sample_plume_cuda(*args, cfg), reps)
        plain_ms = cuda_ms(lambda: plume.sample_plume_plain(*args, cfg),
                           max(reps // 10, 20))
        bytes_s = plume.BYTES_PER_QUERY * n / HBM_BYTES_PER_S
        ops_s = PLUME_OPS_PER_QUERY * n / F32_OPS_PER_S
        bound_ms = max(bytes_s, ops_s) * 1e3
        bound_by = "bytes" if bytes_s >= ops_s else "operations"
        device_ms = kernel_device_ms(
            lambda: plume.sample_plume_cuda(*args, cfg), "plume_sample_kernel")
        timing[n] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                         bound_by=bound_by, device_ms=device_ms)
        log(f"time plume_sample N={n}: per call {ms:.5f} ms, on the device "
            f"{device_ms} ms, plain {plain_ms:.5f} ms, bound {bound_ms:.6f} "
            f"ms ({bound_by})")
        if n == MAIN_N:
            timing["split_ns"] = plume_split(plume, args, cfg)
    return {"max_abs_err": worst, "timing": timing}


def plume_split(plume, args, cfg) -> dict:
    """The pieces of one plume sample call (``sample_plume_cuda``): its
    one-expression check, the check and build of the config's field
    scalars, the one allocation of conc and tke, the stream read, the entry
    point's call with its launch and without (N = 0), and the whole
    wrapper."""
    import torch

    pos, source, seed = args
    n, index = pos.shape[0], pos.get_device()
    conc, tke = pos.new_empty((2, n)).unbind()
    ext, stream = plume._library(), plume._raw_stream(index)
    field = plume.plume_field(cfg)
    ptrs = (ctypes.addressof(field), pos.data_ptr(), source.data_ptr(),
            seed.data_ptr(), None, conc.data_ptr(), tke.data_ptr())
    return host_split("the plume sample wrapper", {
        "checks": lambda: (pos.dtype is torch.float32 and pos.shape == (n, 2)
                           and source.shape == (n, 2) and seed.shape == (n,)
                           and pos.is_contiguous() and source.is_contiguous()
                           and seed.is_contiguous()),
        "field": lambda: (plume.check_field(cfg), plume.plume_field(cfg)),
        "allocate": lambda: pos.new_empty((2, n)).unbind(),
        "stream": lambda: plume._raw_stream(index),
        "entry_no_launch": lambda: ext.plume_sample(*ptrs, 0, stream),
        "entry_launch": lambda: ext.plume_sample(*ptrs, n, stream),
        "wrapper": lambda: plume.sample_plume_cuda(*args, cfg),
    })


def env_cfg(get_preset, case: str):
    preset, kw = ENV_CASES[case]
    return dataclasses.replace(get_preset(preset).env, **kw)


def check_plume_modes(get_preset, plume, rollout) -> float:
    """The sample kernel against its plain version on the fresh fields of
    each of SAMPLE_MODES (their sources, seeds and winds from the rollout's
    draws), at positions over the grid and heights over the domain, N =
    4096 and 2^20.  Returns the worst absolute error."""
    import torch

    worst = 0.0
    for case in SAMPLE_MODES:
        cfg = env_cfg(get_preset, case)
        for n in (MAIN_N, LARGE_N):
            g = torch.Generator(device="cuda").manual_seed(n + len(case))
            field = rollout.init_rollout(cfg, n, g).env_state.field
            scale = torch.tensor([520.0, 520.0, cfg.domain_height + 10.0][
                :cfg.pos_dim], device="cuda")
            pos = (torch.rand(n, cfg.pos_dim, device="cuda", generator=g)
                   * scale - 5.0)
            args = (pos, field.source, field.seed, cfg, field.wind)
            conc, tke = plume.sample_plume_cuda(*args)
            torch.cuda.synchronize()
            want_c, want_t = plume.sample_plume_plain(*args)
            err = max(float((conc - want_c).abs().max()),
                      float((tke - want_t).abs().max()))
            log(f"parity plume_sample {case} ({cfg.plume_model}, "
                f"{cfg.num_sources} sources, pos_dim {cfg.pos_dim}) N={n}: "
                f"max_abs_err {err:.3e}")
            torch.testing.assert_close(conc, want_c, rtol=RTOL, atol=ATOL)
            torch.testing.assert_close(tke, want_t, rtol=RTOL, atol=ATOL)
            assert torch.isfinite(conc).all() and torch.isfinite(tke).all()
            worst = max(worst, err)
    return worst


def env_start(rollout, cfg, n: int, seed: int, wide: bool = True):
    """Fresh episodes in ``n`` envs on the card and the generator that drew
    them; with ``wide``, curriculum radii of 40-300, so that envs reach the
    source and reset within a few steps."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    carry = rollout.init_rollout(cfg, n, g)
    state = carry.env_state
    if wide:
        state = state.replace(radius=40.0 + 260.0 * torch.rand(
            n, device="cuda", generator=g))
    return state, carry.accum, g


def policy_outputs(cfg, n: int, g):
    """Logits f32[N, A] and values f32[N] as a policy's forward gives
    them."""
    import torch

    return (2.0 * torch.randn(n, cfg.num_actions, device="cuda", generator=g),
            torch.randn(n, device="cuda", generator=g))


def compare_env_step(plume, cfg, got, want, state, accum) -> tuple:
    """Asserts one kernel step ``got`` = (traj, obs rows, state, totals)
    equal to the plain step ``want`` in every integer and bool (actions,
    dones, successes, steps, t, visit grids, prev_action, seeds, cells of
    the step's and the next position) and within RTOL/ATOL in every float.
    Returns (envs whose position differs in any bit, in the step's row or
    the next state; the worst absolute float error; envs whose wind, made
    by the kernel at a reset, differs in any bit)."""
    import torch

    traj, obs, k_state, k_acc = got
    w_traj, w_obs = want
    cell = lambda pos: torch.stack(plume.cell_of(pos, cfg.grid_size), -1)
    equal = {
        "action": (traj.action, w_traj.action),
        "done": (traj.done, w_traj.done),
        "success": (traj.episode.success, w_traj.episode.success),
        "steps": (traj.episode.steps, w_traj.episode.steps),
        "t": (k_state.t, state.t), "visited": (k_state.visited, state.visited),
        "prev_action": (k_state.prev_action, state.prev_action),
        "seed": (k_state.field.seed, state.field.seed),
        "step cells": (cell(traj.pos), cell(w_traj.pos)),
        "cells": (cell(k_state.pos), cell(state.pos)),
        "value": (traj.value, w_traj.value),
    }
    for name, (a, b) in equal.items():
        assert torch.equal(a, b), (name, int((a != b).sum()))
    close = {"obs": (obs[1], w_obs[1]), "pos": (k_state.pos, state.pos),
             "source": (k_state.field.source, state.field.source)}
    for name in ("log_prob", "reward", "pos", "conc"):
        close["step " + name] = (getattr(traj, name), getattr(w_traj, name))
    for name in plume.ACCUM_FIELDS + ("final_conc", "source_x", "source_y",
                                      "radius", "distance"):
        close["record " + name] = (getattr(traj.episode, name),
                                   getattr(w_traj.episode, name))
    for name in ("conc", "tke", "prev_conc"):
        close[name] = (getattr(k_state, name), getattr(state, name))
    for name in plume.ACCUM_FIELDS:
        close["accum " + name] = (getattr(k_acc, name), getattr(accum, name))
    assert (k_state.field.wind is None) == (state.field.wind is None)
    wind_bits = 0
    if state.field.wind is not None:
        close["wind"] = (k_state.field.wind, state.field.wind)
        wind_bits = int((k_state.field.wind != state.field.wind).any(-1)
                        .sum())
    err = 0.0
    for name, (a, b) in close.items():
        assert torch.isfinite(a).all(), name
        torch.testing.assert_close(a, b, rtol=RTOL, atol=ATOL, msg=name)
        err = max(err, float((a - b).abs().max()))
    moved = ((traj.pos != w_traj.pos).any(-1)
             | (k_state.pos != state.pos).any(-1))
    return int(moved.sum()), err, wind_bits


def check_env_step_kernel(get_preset, plume, rollout) -> float:
    """The env-step kernel against ``env_step_plain`` on the card over
    ENV_STEPS steps of each env case, Gumbel-sampled (and, for v1_1 and
    wrf_les, greedy), at N = 4096 and ENV_ODD_N, teacher-forced: each step
    starts both from the plain path's state, the kernel from a copy of it,
    with the same logits, values and draws.  Integers and bools equal, no
    position differing in any bit, floats within RTOL/ATOL; some envs
    finish and reset in every case.  The winds the kernel draws at resets
    are held within RTOL/ATOL and the count of those differing in any bit
    printed.  Returns the worst absolute float error."""
    import torch

    worst = 0.0
    for case in ENV_CASES:
        cfg = env_cfg(get_preset, case)
        for n in (MAIN_N, ENV_ODD_N):
            both = case in ("v1_1", "wrf_les")
            for greedy in ((False, True) if both else (False,)):
                state, accum, g = env_start(rollout, cfg, n,
                                            seed=n + len(case))
                moved = dones = winds = 0
                err = 0.0
                for _ in range(ENV_STEPS):
                    logits, value = policy_outputs(cfg, n, g)
                    draws = rollout.draw_chunk(g, cfg, 1, n, greedy)
                    traj, obs = rollout.empty_trajectory(1, n, cfg, "cuda")
                    k_state = rollout.own_copy(state)
                    k_acc = rollout.own_copy(accum)
                    plume.EnvStepper(k_state, k_acc, draws, traj, obs, cfg)(
                        0, logits, value)
                    want = rollout.empty_trajectory(1, n, cfg, "cuda")
                    state, _, accum = rollout.env_step_plain(
                        logits, value, draws, 0, state, accum, *want, cfg)
                    torch.cuda.synchronize()
                    m, e, w = compare_env_step(plume, cfg,
                                               (traj, obs, k_state, k_acc),
                                               want, state, accum)
                    moved += m
                    winds += w
                    err = max(err, e)
                    dones += int(traj.done.sum())
                log(f"parity env_step {case} N={n} "
                    f"{'greedy' if greedy else 'Gumbel'}: {ENV_STEPS} steps "
                    f"teacher-forced, {dones} envs finished; actions, dones, "
                    f"t, visit grids, prev_action, seeds and cells equal; "
                    f"pos mismatches {moved}; winds not bit-equal {winds}; "
                    f"max_abs_err {err:.3e}")
                assert moved == 0, (case, n, "pos mismatches", moved)
                assert dones > 0, (case, n, "no env finished")
                worst = max(worst, err)
    return worst


def time_env_step_kernel(get_preset, plume, rollout,
                         presets=("ppo_v2_0", "wrf_les")) -> dict:
    """The env-step kernel's per-call and device time at N = 4096 and 2^20
    on ppo_v2_0 (the isotropic plume) and wrf_les (the anisotropic plume in
    a wind) from fresh episodes at the initial radius, beside
    ``env_step_plain``'s and the bound: the larger of ``env_step_bytes``
    (with the finished envs of the timed step) over the memory rate and the
    plume samples' and ENV_STEP_OPS operations over the f32 rate.  The
    stepper steps its copy of the state in place at every call.  Also the
    split of the wrapper's host cost at N = 4096 on ppo_v2_0.  Returns
    {preset: {N: times}} of ``presets``, with the split under ppo_v2_0's
    "split_ns"."""
    import torch

    out = {}
    for preset in presets:
        cfg = get_preset(preset).env
        sample_ops = PLUME_OPS_PER_QUERY + (
            ANISO_OPS_PER_SOURCE if cfg.plume_model == "anisotropic" else 0)
        out[preset] = {}
        for n, reps in ((MAIN_N, 2000), (LARGE_N, 100)):
            state, accum, g = env_start(rollout, cfg, n, seed=5, wide=False)
            logits, value = policy_outputs(cfg, n, g)
            draws = rollout.draw_chunk(g, cfg, 1, n)
            traj, obs = rollout.empty_trajectory(1, n, cfg, "cuda")
            stepper = plume.EnvStepper(rollout.own_copy(state),
                                       rollout.own_copy(accum), draws, traj,
                                       obs, cfg)

            def call():
                stepper(0, logits, value)

            call()
            torch.cuda.synchronize()
            dones = int(traj.done.sum())
            ms = cuda_ms(call, reps)
            device_ms = kernel_device_ms(call, "env_step_kernel")
            want = rollout.empty_trajectory(1, n, cfg, "cuda")
            plain_ms = cuda_ms(lambda: rollout.env_step_plain(
                logits, value, draws, 0, state, accum, *want, cfg),
                max(reps // 20, 20))
            moved = plume.env_step_bytes(cfg, n, dones, greedy=False)
            bytes_s = moved / HBM_BYTES_PER_S
            ops_s = ((n * (sample_ops + ENV_STEP_OPS) + dones * sample_ops)
                     / F32_OPS_PER_S)
            bound_ms = max(bytes_s, ops_s) * 1e3
            bound_by = "bytes" if bytes_s >= ops_s else "operations"
            out[preset][n] = dict(ms=ms, device_ms=device_ms,
                                  plain_ms=plain_ms, bound_ms=bound_ms,
                                  bound_by=bound_by, bytes=moved, dones=dones)
            log(f"time env_step {preset} N={n}: per call {ms:.5f} ms, on "
                f"the device {device_ms} ms, plain {plain_ms:.5f} ms, bound "
                f"{bound_ms:.6f} ms ({bound_by}; {moved} B, {dones} envs "
                f"finished)")
            if n == MAIN_N and preset == "ppo_v2_0":
                stream = plume._raw_stream(stepper.index)
                args = (stepper.address, 0, logits.data_ptr(),
                        value.data_ptr())
                out[preset]["split_ns"] = host_split("the env-step wrapper", {
                    "checks": lambda: stepper.takes(logits, value),
                    "stream": lambda: plume._raw_stream(stepper.index),
                    "data_ptr": lambda: (logits.data_ptr(), value.data_ptr()),
                    "entry_launch": lambda: stepper.launch(*args, stream),
                    "wrapper": call,
                }, reps=5000)
    return out


def profile_rollout(rollout_chunk, loop, cfg, bank=None) -> dict:
    """Device launches per env step, device ms and wall ms of one rollout
    chunk of the main path (``loop``'s carry is not modified), from
    torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    length = cfg.rollout.unroll_length
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        rollout_chunk(loop.model, loop.rollout, cfg.env, length, bank=bank)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = device_kernels(prof)
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    count = sum(e.count for e in kernels)
    return dict(launches_per_step=count / length, launches=count,
                device_ms=device_ms, wall_ms=wall_ms)


def device_kernels(prof):
    """The profiler's device events, without user annotations such as the
    optimizer's step range, which span kernels already counted."""
    from torch.autograd import DeviceType

    return [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.count
            and not getattr(e, "is_user_annotation", False)
            and "#" not in e.key]


def kernel_device_ms(fn, kernel_name: str, reps: int = 100):
    """Mean device ms of the kernel ``kernel_name`` over ``reps`` calls of
    ``fn``, from torch.profiler; None if the profiler recorded no device
    time for it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    for e in prof.key_averages():
        if kernel_name in e.key and e.count:
            total_us = e.self_device_time_total
            return total_us / e.count / 1e3 if total_us else None
    return None


def ppo_batch(PPOBatch, b: int, d: int, seed: int):
    """A minibatch on the card drawn from ``seed``, as the tests draw it."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    return PPOBatch(
        obs=torch.randn(b, d, device="cuda", generator=g),
        actions=torch.randint(0, MAIN_A, (b,), device="cuda", generator=g),
        old_log_probs=-1.6 + 0.2 * torch.randn(b, device="cuda", generator=g),
        advantages=torch.randn(b, device="cuda", generator=g),
        returns=torch.randn(b, device="cuda", generator=g),
        old_values=torch.randn(b, device="cuda", generator=g))


def ppo_bound(b: int, d: int, h1: int, h2: int, a: int, bf16: bool):
    """(ms, "bytes" or "operations") the card needs at least for the fused
    gradients of ``b`` rows: each product's multiply-adds (2 operations),
    forward and backward, plus ``PPO_ELEMENTWISE_OPS`` per hidden unit and
    row; under bf16 compute the four forward products count at the bf16
    tensor-core rate, the rest at the f32 rate.  Bytes: the batch read once
    (obs, i64 actions, four f32 columns), the params read and their
    gradients written once."""
    fwd = 2 * (d * h1 + h1 * h2 + h2 * (a + 1))
    bwd = (2 * 2 * h2 * (a + 1) + 2 * 2 * h1 * h2 + 2 * d * h1
           + PPO_ELEMENTWISE_OPS * (h1 + h2))
    ops_s = b * (fwd / (BF16_TENSOR_OPS_PER_S if bf16 else F32_OPS_PER_S)
                 + bwd / F32_OPS_PER_S)
    params = d * h1 + 3 * h1 + h1 * h2 + 3 * h2 + (a + 1) * h2 + a + 1
    bytes_s = (b * (4 * d + 8 + 16) + 2 * 4 * params) / HBM_BYTES_PER_S
    return max(ops_s, bytes_s) * 1e3, ("bytes" if bytes_s >= ops_s
                                       else "operations")


def check_ppo_kernel(ActorCritic, PPOConfig, PPOBatch, fused_ops,
                     ppo_loss) -> float:
    """The fused kernel against its plain version (and, in f32, autodiff of
    ppo_loss) over the covered shapes; two calls bit-equal.  Returns the
    largest absolute gradient error against the plain version."""
    import torch

    def compare(grads, metrics, want, want_m, label):
        worst_rel = worst_abs = 0.0
        for name, g in grads.items():
            scale = max(float(want[name].abs().max()), 1e-8)
            err = float((g - want[name]).abs().max())
            assert err <= GRAD_ATOL_PER_MAX * scale, (label, name, err, scale)
            worst_rel, worst_abs = max(worst_rel, err / scale), max(worst_abs,
                                                                    err)
        for k, v in metrics.items():
            torch.testing.assert_close(v, want_m[k], rtol=METRIC_RTOL,
                                       atol=METRIC_ATOL, msg=f"{label} {k}")
        return worst_rel, worst_abs

    worst = 0.0
    for bf16 in (False, True):
        for d in (MAIN_D, 12):
            for hidden in (MAIN_HIDDEN, (64, 32)):
                for b in (MAIN_MB, 512):
                    model = ActorCritic(d, MAIN_A, hidden).reset_parameters(
                        torch.Generator().manual_seed(b + d)).cuda()
                    batch = ppo_batch(PPOBatch, b, d, seed=d + hidden[1])
                    cfg = PPOConfig(minibatch_size=b, bf16_compute=bf16)
                    grads, metrics = fused_ops.fused_ppo_grads_cuda(
                        model, batch, cfg)
                    again, _ = fused_ops.fused_ppo_grads_cuda(model, batch,
                                                              cfg)
                    torch.cuda.synchronize()
                    for name, g in grads.items():
                        assert torch.equal(g, again[name]), (
                            "repeat call differs", name)
                    label = (f"B={b} D={d} {hidden} "
                             f"{'bf16' if bf16 else 'f32'}")
                    want, want_m = fused_ops.fused_ppo_grads_plain(
                        model, batch, cfg)
                    rel, err = compare(grads, metrics, want, want_m, label)
                    worst = max(worst, err)
                    line = (f"parity ppo_fused {label}: vs plain worst "
                            f"|err|/max|grad| {rel:.3e} (max_abs_err "
                            f"{err:.3e}), repeat bit-equal")
                    if not bf16:
                        model.zero_grad(set_to_none=True)
                        loss, auto_m = ppo_loss(model, batch, cfg)
                        loss.backward()
                        auto = {n: p.grad for n, p in
                                model.named_parameters()}
                        rel, _ = compare(grads, metrics, auto, auto_m,
                                         label + " autodiff")
                        line += f"; vs autodiff {rel:.3e}"
                    log(line)
    return worst


def time_ppo_kernel(ActorCritic, PPOConfig, PPOBatch, fused_ops,
                    ppo_loss) -> dict:
    """The fused kernel's times at the main path's minibatch, f32 and bf16,
    beside its plain version's, autodiff's forward and backward of ppo_loss
    on the same minibatch, and the bound."""
    import torch

    model = ActorCritic(MAIN_D, MAIN_A, MAIN_HIDDEN).reset_parameters(
        torch.Generator().manual_seed(11)).cuda()
    batch = ppo_batch(PPOBatch, MAIN_MB, MAIN_D, seed=11)
    out = {}
    for bf16 in (False, True):
        cfg = PPOConfig(minibatch_size=MAIN_MB, bf16_compute=bf16)

        def kernel():
            fused_ops.fused_ppo_grads_cuda(model, batch, cfg)

        net = model.twin(torch.bfloat16) if bf16 else model

        def autodiff():
            net.zero_grad(set_to_none=True)
            ppo_loss(net, batch, cfg)[0].backward()

        ms = cuda_ms(kernel, 50)
        plain_ms = cuda_ms(
            lambda: fused_ops.fused_ppo_grads_plain(model, batch, cfg), 5)
        autodiff_ms = cuda_ms(autodiff, 20)
        parts = {name: kernel_device_ms(kernel, f"ppo_{name}_kernel", reps=20)
                 for name in ("row", "dw2", "reduce")}
        device_ms = (sum(parts.values()) if None not in parts.values()
                     else None)
        bound_ms, bound_by = ppo_bound(MAIN_MB, MAIN_D, *MAIN_HIDDEN, MAIN_A,
                                       bf16)
        key = "bf16" if bf16 else "f32"
        out[key] = dict(ms=ms, plain_ms=plain_ms, autodiff_ms=autodiff_ms,
                        device_ms=device_ms,
                        **{f"{name}_device_ms": v for name, v in
                           parts.items()},
                        bound_ms=bound_ms, bound_by=bound_by)
        share = (f"{bound_ms / device_ms:.3f}" if device_ms
                 else "not measured")
        smem, blocks, sms = fused_ops._plan(torch.cuda.current_device(),
                                            MAIN_D, *MAIN_HIDDEN, MAIN_A)
        out[key]["row_blocks_per_sm"] = blocks / sms
        out[key]["bound_share"] = bound_ms / device_ms if device_ms else None
        log(f"time ppo_fused {key} B={MAIN_MB}: per call {ms:.4f} ms, on the "
            f"device row {parts['row']} + dW2 {parts['dw2']} + reduction "
            f"{parts['reduce']} = {device_ms} ms (bound share {share}), plain "
            f"{plain_ms:.4f} ms, autodiff fwd+bwd {autodiff_ms:.4f} ms, "
            f"bound {bound_ms:.6f} ms ({bound_by}); row kernel {smem} B of "
            f"shared memory, {blocks // sms} blocks per SM")
    return out


def gather_inputs(shape, n: int, seed: int):
    """A stack of ``shape`` on the card with values in [0, 100), a random
    row per query, and points from 1 beyond each edge of every axis after
    the first, with exact grid points, the last index (and top level), and
    points outside the grid on both sides."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    stack = 100.0 * torch.rand(shape, device="cuda", generator=g)
    rows = torch.randint(0, shape[0], (n,), dtype=torch.int32, device="cuda",
                         generator=g)
    dims = torch.tensor(shape[1:], dtype=torch.float32, device="cuda")
    pts = torch.rand(n, len(shape) - 1, device="cuda", generator=g) * (
        dims + 2.0) - 1.0
    pts[:4] = torch.stack([torch.zeros_like(dims), dims - 1, dims + 5.0,
                           -3.0 * torch.ones_like(dims)])
    pts[4:64] = torch.floor(pts[4:64])
    return stack, rows, pts.contiguous()


def _gather_fns(gather, name):
    if name == "bilinear":
        return gather.bilinear_cuda, gather.bilinear_plain
    return gather.trilinear_zyx_cuda, gather.trilinear_zyx_plain


def check_gather_kernels(gather) -> dict:
    """Each gather kernel against its plain version at the TPU kernel's own
    call and at a bank's stack, N = 4096 and 2^20; two calls bit-equal.
    Returns the worst absolute error of each kernel."""
    import torch

    worst = {}
    for name, shapes in GATHER_SHAPES.items():
        kernel, plain = _gather_fns(gather, name)
        worst[name] = 0.0
        for shape in shapes:
            for n in (MAIN_N, LARGE_N):
                args = gather_inputs(shape, n, seed=n + len(shape) + shape[0])
                got = kernel(*args)
                again = kernel(*args)
                torch.cuda.synchronize()
                assert torch.equal(got, again), (name, shape, n, "repeat")
                want = plain(*args)
                err = float((got - want).abs().max())
                scale = float(args[0].abs().max())
                equal = torch.equal(got, want)
                log(f"parity {name} {list(shape)} N={n}: max_abs_err "
                    f"{err:.3e} ({'bit-equal' if equal else 'not bit-equal'}"
                    f"), repeat bit-equal")
                assert err <= GATHER_ATOL_PER_MAX * scale, (name, shape, n,
                                                             err)
                assert torch.isfinite(got).all()
                worst[name] = max(worst[name], err)
    return worst


def grid_sample_call(stack, pts):
    """``torch.nn.functional.grid_sample`` over a stack of one field or
    volume at ``pts`` (index units, (x, y) or (z, x, y)): the one PyTorch
    call that computes the gathers' function.  The normalised grid is built
    here, outside the returned call."""
    import torch

    fn = torch.nn.functional.grid_sample
    sizes = stack.shape[1:]
    # grid_sample orders the grid's last axis innermost first: (y, x[, z]).
    norm = [pts[:, i] * (2.0 / (sizes[i] - 1)) - 1.0
            for i in reversed(range(len(sizes)))]
    grid = torch.stack(norm, -1).view((1,) * len(sizes) + (-1, len(sizes)))
    inp = stack.view((1,) + tuple(stack.shape))

    def call():
        return fn(inp, grid, mode="bilinear", padding_mode="border",
                  align_corners=True).view(-1)

    return call


def time_gather_kernels(gather) -> dict:
    """Each gather kernel's time at N = 4096 and 2^20 over the TPU kernel's
    own call (and per call over the bank stack), beside its plain version's,
    ``grid_sample``'s and the bound.  The bound counts each query's point,
    row and output once, and each cell the corners touch once
    (``gather.moved_bytes``).  At 2^20 also ``torch.take`` of every corner
    offset the kernel reads: the same scattered loads in one PyTorch call,
    the yardstick of the rate the memory system gives them."""
    import torch

    out = {}
    for name, (one, stack_shape) in GATHER_SHAPES.items():
        kernel, plain = _gather_fns(gather, name)
        kname = "bilinear_kernel" if name == "bilinear" else "trilinear_zyx"
        out[name] = {}
        for n, reps in ((MAIN_N, 2000), (LARGE_N, 200)):
            args = gather_inputs(one, n, seed=n + 3)
            lib = grid_sample_call(args[0], args[2])
            lib_err = float((lib() - kernel(*args)).abs().max())
            assert lib_err <= GRID_SAMPLE_ATOL_PER_MAX * float(
                args[0].abs().max()), (name, n, lib_err)
            # two alternating blocks: kernel, grid_sample, grid_sample, kernel
            ms_a = cuda_ms(lambda: kernel(*args), reps)
            library_a = cuda_ms(lib, reps)
            library_b = cuda_ms(lib, reps)
            ms_b = cuda_ms(lambda: kernel(*args), reps)
            ms, library_ms = (ms_a + ms_b) / 2, (library_a + library_b) / 2
            device_ms = kernel_device_ms(lambda: kernel(*args), kname)
            plain_ms = cuda_ms(lambda: plain(*args), max(reps // 10, 20))
            library_device_ms = kernel_device_ms(lib, "grid_sampler")
            bound_ms = gather.moved_bytes(*args) / HBM_BYTES_PER_S * 1e3
            big = gather_inputs(stack_shape, n, seed=n + 5)
            stack_ms = cuda_ms(lambda: kernel(*big), reps)
            if name == "trilinear_zyx" and n == MAIN_N:
                out["split_ns"] = gather_split(gather, *args, lib)
            take = {}
            if n == LARGE_N:
                corners = gather._corner_cells(*args)
                flat = args[0].reshape(-1)
                take_ms = cuda_ms(lambda: torch.take(flat, corners), reps)
                take = dict(take_ms=take_ms, loads=corners.numel())
                log(f"scattered loads of {name} N={n}: {corners.numel()} "
                    f"corner loads, torch.take of them {take_ms:.5f} ms "
                    f"({corners.numel() / take_ms / 1e6:.1f} G loads/s), "
                    f"the kernel on the device {device_ms} ms")
            out[name][n] = dict(
                **take, ms=ms, ms_blocks=[ms_a, ms_b],
                library_ms_blocks=[library_a, library_b],
                device_ms=device_ms, plain_ms=plain_ms,
                library_ms=library_ms, library_device_ms=library_device_ms,
                library_max_abs_err=lib_err, bound_ms=bound_ms,
                bound_by="bytes", stack_ms=stack_ms)
            log(f"time {name} {list(one)} N={n}: per call {ms_a:.5f} / "
                f"{ms_b:.5f} ms (blocks 1 and 4), on the device {device_ms} "
                f"ms, plain {plain_ms:.5f} ms, grid_sample {library_a:.5f} / "
                f"{library_b:.5f} ms (blocks 2 and 3; device "
                f"{library_device_ms} ms, max_abs_err {lib_err:.3e}), bound "
                f"{bound_ms:.6f} ms (bytes); per call over "
                f"{list(stack_shape)} {stack_ms:.5f} ms; kernel per call <= "
                f"grid_sample's in both blocks: "
                f"{ms_a <= library_a and ms_b <= library_b}")
    return out


def sample_bank_of(gridded, layout: str, z_extent: float, seed: int):
    """A bank of ``layout`` on the card with values in [0, 100)."""
    import torch

    shape = SAMPLE_LAYOUTS[layout][0]
    g = torch.Generator(device="cuda").manual_seed(seed)
    return gridded.FieldBank(
        conc=100.0 * torch.rand(shape, device="cuda", generator=g),
        source=torch.zeros(shape[0], 2, device="cuda"),
        steps_per_frame=SAMPLE_SPF, z_extent=z_extent)


def sample_queries(bank, pos_dim: int, n: int, seed: int):
    """(idx, pos, t, seed bits) on the card: rows, positions from 10 beyond
    each edge (heights from 5 beyond the levels) with exact cell edges,
    steps over 10 frames' worth (past the last frame of every bank)."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    k, h, w = bank.conc.shape[0], *bank.conc.shape[-2:]
    idx = torch.randint(0, k, (n,), dtype=torch.int32, device="cuda",
                        generator=g)
    lo = torch.tensor([-10.0, -10.0, -5.0][:pos_dim], device="cuda")
    hi = torch.tensor([h + 10.0, w + 10.0, bank.z_extent + 5.0][:pos_dim],
                      device="cuda")
    pos = lo + (hi - lo) * torch.rand(n, pos_dim, device="cuda", generator=g)
    pos[4:64, :2] = torch.floor(pos[4:64, :2])
    t = torch.randint(0, int(10 * SAMPLE_SPF), (n,), dtype=torch.int32,
                      device="cuda", generator=g)
    bits = torch.randint(-(2**31), 2**31, (n,), dtype=torch.int32,
                         device="cuda", generator=g)
    return idx, pos.contiguous(), t, bits


def check_sample_kernels(get_preset, gridded, gather) -> dict:
    """The bank sample kernels against ``sample_bank_conc_tke_plain`` at
    every layout, N = 4096 and 2^20, both turbulence flag sets: within
    RTOL/ATOL, two calls bit-equal, and, with the turbulence off, bit-equal
    (the frame division, the level scale, the gathers and the lerps are the
    plain version's to the bit).  Returns the worst absolute error of each
    kernel."""
    import torch

    base = get_preset("wrf_les_3d").env
    worst = {"bilinear": 0.0, "trilinear_zyx": 0.0}
    for i, (layout, (_, env_3d)) in enumerate(SAMPLE_LAYOUTS.items()):
        name = "bilinear" if layout == "static" else "trilinear_zyx"
        bank = sample_bank_of(gridded, layout, base.domain_height, seed=i)
        for n in (MAIN_N, LARGE_N):
            for flags in ({}, V10_FLAGS):
                cfg = dataclasses.replace(base, env_3d=env_3d, **flags)
                args = sample_queries(bank, cfg.pos_dim, n, seed=n + i)
                got = gather.sample_bank_conc_tke(bank, *args, cfg)
                again = gather.sample_bank_conc_tke(bank, *args, cfg)
                torch.cuda.synchronize()
                want = gather.sample_bank_conc_tke_plain(bank, *args, cfg)
                err = 0.0
                for a, b, c in zip(got, again, want):
                    assert torch.equal(a, b), (layout, n, "repeat")
                    assert torch.isfinite(a).all(), (layout, n)
                    torch.testing.assert_close(a, c, rtol=RTOL, atol=ATOL)
                    err = max(err, float((a - c).abs().max()))
                quiet = dataclasses.replace(cfg, turbulence_intensity=0.0)
                q_got = gather.sample_bank_conc_tke(bank, *args, quiet)[0]
                q_want = gather.sample_bank_conc_tke_plain(bank, *args,
                                                           quiet)[0]
                assert torch.equal(q_got, q_want), (layout, n, "quiet")
                log(f"parity bank sample ({name}) {layout} "
                    f"{list(bank.conc.shape)} N={n} "
                    f"{'v1_0 flags' if flags else 'v1_1 flags'}: "
                    f"max_abs_err {err:.3e}, repeat bit-equal, bit-equal "
                    f"without turbulence")
                worst[name] = max(worst[name], err)
        del bank
        torch.cuda.empty_cache()
    return worst


def host_split(label: str, pieces: dict, reps: int = 20000) -> dict:
    """Host ns per call of each of ``pieces`` (name: function of no
    arguments), by ``time.perf_counter_ns`` over ``reps`` calls after 100
    warm-up calls; the card is synchronised around each piece."""
    import torch

    out = {}
    for key, fn in {"loop": lambda: None, **pieces}.items():
        for _ in range(100):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter_ns()
        for _ in range(reps):
            fn()
        out[key] = (time.perf_counter_ns() - t0) / reps
        torch.cuda.synchronize()
    log(f"host split of {label}, ns per call over {reps} calls: "
        + ", ".join(f"{k} {v:.0f}" for k, v in out.items()))
    return out


def sample_split(gather, bank, args, cfg) -> dict:
    """The pieces of one bank sample call (``BankSampler.__call__``): the
    lookup of the bank's kept launch, the per-query checks, the one
    allocation of conc and tke (beside two allocations), the stream read,
    the six data_ptr reads, the entry point's call with its launch and
    without (N = 0), and the whole wrapper."""
    idx, pos, t, seed = args
    sampler = bank.sampler(cfg)
    n, index = idx.shape[0], sampler.index
    conc, tke = pos.new_empty((2, n)).unbind()
    ptrs = (idx.data_ptr(), pos.data_ptr(), t.data_ptr(), seed.data_ptr(),
            conc.data_ptr(), tke.data_ptr())
    stream = gather._raw_stream(index)
    return host_split("the bank sample wrapper", {
        "lookup": lambda: bank.sampler(cfg),
        "checks": lambda: sampler.takes(idx, pos, t, seed),
        "allocate": lambda: pos.new_empty((2, n)).unbind(),
        "allocate_two": lambda: (pos.new_empty(n), pos.new_empty(n)),
        "stream": lambda: gather._raw_stream(index),
        "data_ptr": lambda: (idx.data_ptr(), pos.data_ptr(), t.data_ptr(),
                             seed.data_ptr(), conc.data_ptr(),
                             tke.data_ptr()),
        "entry_no_launch": lambda: sampler.launch(sampler.address, *ptrs, 0,
                                                  stream),
        "entry_launch": lambda: sampler.launch(sampler.address, *ptrs, n,
                                               stream),
        "wrapper": lambda: gather.sample_bank_conc_tke(bank, *args, cfg),
    })


def gather_split(gather, stack, rows, pts, lib) -> dict:
    """The pieces of one trilinear gather call over a stack (the TPU
    kernel's own call), beside ``grid_sample``'s whole call."""
    index = stack.get_device()
    n = pts.shape[0]
    out = pts.new_empty(n)
    fn = gather._gathers[4]
    ptrs = (stack.data_ptr(), rows.data_ptr(), pts.data_ptr(), out.data_ptr())
    stream = gather._raw_stream(index)
    shape = stack.shape
    return host_split("the trilinear gather wrapper", {
        "checks": lambda: gather._takes(stack, rows, pts, 4, index, n),
        "allocate": lambda: pts.new_empty(n),
        "entry_no_launch": lambda: fn(*ptrs, 0, shape, stream),
        "entry_launch": lambda: fn(*ptrs, n, shape, stream),
        "wrapper": lambda: gather.trilinear_zyx(stack, rows, pts),
        "grid_sample": lib,
    })


def time_sample_kernels(get_preset, gridded, gather) -> dict:
    """Each sample kernel's per-call, device and plain time at N = 4096 and
    2^20 over a main path's bank (bilinear: the static [64, 500, 500] bank;
    trilinear: the [4, 8, 8, 500, 500] bank in 3-D flight), and the bound:
    the larger of its bytes (``gather.sample_moved_bytes``) over the memory
    rate and the plume kernel's operations a query over the f32 rate.  Also
    the split of the wrapper's host cost at N = 4096 over the 3-D bank."""
    import torch

    base = get_preset("wrf_les_3d").env
    out = {}
    for name, layout, kname in (("bilinear", "static", "bilinear_kernel"),
                                ("trilinear_zyx", "volumes",
                                 "trilinear_zyx")):
        env_3d = SAMPLE_LAYOUTS[layout][1]
        cfg = dataclasses.replace(base, env_3d=env_3d)
        bank = sample_bank_of(gridded, layout, base.domain_height, seed=21)
        out[name] = {}
        for n, reps in ((MAIN_N, 2000), (LARGE_N, 200)):
            args = sample_queries(bank, cfg.pos_dim, n, seed=n + 21)

            def call():
                return gather.sample_bank_conc_tke(bank, *args, cfg)

            ms = cuda_ms(call, reps)
            device_ms = kernel_device_ms(call, kname)
            plain_ms = cuda_ms(lambda: gather.sample_bank_conc_tke_plain(
                bank, *args, cfg), max(reps // 10, 20))
            bytes_s = gather.sample_moved_bytes(bank, args[0], args[1],
                                                args[2], cfg) / HBM_BYTES_PER_S
            ops_s = PLUME_OPS_PER_QUERY * n / F32_OPS_PER_S
            bound_ms = max(bytes_s, ops_s) * 1e3
            bound_by = "bytes" if bytes_s >= ops_s else "operations"
            out[name][n] = dict(ms=ms, device_ms=device_ms, plain_ms=plain_ms,
                                bound_ms=bound_ms, bound_by=bound_by)
            log(f"time bank sample ({name}) {layout} "
                f"{list(bank.conc.shape)} N={n}: per call {ms:.5f} ms, on "
                f"the device {device_ms} ms, plain {plain_ms:.5f} ms, bound "
                f"{bound_ms:.6f} ms ({bound_by})")
            if name == "trilinear_zyx" and n == MAIN_N:
                out["split_ns"] = sample_split(gather, bank, args, cfg)
        del bank
        torch.cuda.empty_cache()
    return out


def profile_iteration(step, loop):
    """Device kernel time, kernel count and busy share of one main-path
    iteration, from torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        loop, _, _ = step(loop)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = device_kernels(prof)
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    count = sum(e.count for e in kernels)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    log(f"profile of one main-path iteration (profiler on): wall "
        f"{wall_ms:.1f} ms, device kernels {device_ms:.1f} ms in {count} "
        f"launches, device busy share {device_ms / wall_ms:.3f}")
    for e in top:
        log(f"  {e.self_device_time_total / 1e3:9.2f} ms {e.count:6d}x "
            f"{e.key[:90]}")
    return loop, device_ms / wall_ms, count


def to_device(obj, device):
    """Tensors of (nested) dataclasses moved to ``device``."""
    import torch

    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **{
            f.name: to_device(getattr(obj, f.name), device)
            for f in dataclasses.fields(obj)
            if isinstance(getattr(obj, f.name), torch.Tensor)
            or dataclasses.is_dataclass(getattr(obj, f.name))})
    return obj


KERNEL_NAMES = ("plume_sample", "env_step", "ppo_fused", "ppo_dw2",
                "ppo_reduce", "bilinear", "trilinear_zyx")


def zero_counts(k) -> None:
    """Set every kernel's launch count to 0 (``k`` holds the plume, ppo and
    gather ops modules)."""
    k.plume.launches = k.plume.env_step_launches = 0
    k.fused_ops.launches = k.fused_ops.dw2_launches = 0
    k.fused_ops.reduce_launches = 0
    k.gather.bilinear.launches = k.gather.trilinear_zyx.launches = 0


def read_counts(k) -> dict:
    return dict(zip(KERNEL_NAMES, (
        k.plume.launches, k.plume.env_step_launches, k.fused_ops.launches,
        k.fused_ops.dw2_launches, k.fused_ops.reduce_launches,
        k.gather.bilinear.launches, k.gather.trilinear_zyx.launches)))


def count_diff(after: dict, before: dict) -> dict:
    return {name: after[name] - before[name] for name in KERNEL_NAMES}


def _field_sample(env, bank):
    """The kernel that one field sample of ``env`` launches (None: no
    kernel, a gridded read at the cell)."""
    if env.plume_model != "gridded":
        return "plume_sample"
    if env.subcell_sampling:
        return "bilinear" if bank.conc.dim() == 3 else "trilinear_zyx"
    return None


def expected_init_counts(cfg, bank) -> dict:
    """Launches of ``init_loop``: one field sample of the fresh episodes."""
    want = dict.fromkeys(KERNEL_NAMES, 0)
    kernel = _field_sample(cfg.env, bank)
    if kernel is not None:
        want[kernel] = 1
    return want


def expected_counts(cfg, bank, iters: int) -> dict:
    """Launches of each kernel in ``iters`` train iterations by the port's
    design: on the analytic plume one env-step launch per env step (action
    sample, move, sample, reward, auto-reset and trajectory rows), and no
    plume sample; over a bank two field samples per env step (the step and
    the branchless reset), a sub-cell sample one launch of the sample
    kernel (bilinear for a static bank, trilinear for a time-varying or 3-D
    one); each minibatch step of the fused update one launch each of the
    row kernel, the dW2 kernel and the reduction."""
    env, ppo = cfg.env, cfg.ppo
    n, t = cfg.rollout.num_envs, cfg.rollout.unroll_length
    want = dict.fromkeys(KERNEL_NAMES, 0)
    kernel = _field_sample(env, bank)
    if kernel == "plume_sample":
        want["env_step"] = iters * t
    elif kernel is not None:
        want[kernel] = iters * 2 * t
    if ppo.fused_update:
        want["ppo_fused"] = want["ppo_dw2"] = want["ppo_reduce"] = (
            iters * ppo.epochs * (n * t // ppo.minibatch_size))
    return want


def small_bank(gridded, kind, env):
    """The small banks of the card-vs-CPU iterations, on the CPU: a 3-D
    [2, 3, 4, 64, 64] bank or a static [3, 64, 64] one."""
    import torch

    gen = torch.Generator().manual_seed(0)
    if kind == "3d":
        return gridded.synthesize_3d_bank(gen, env, num_fields=2,
                                          num_frames=3, num_levels=4,
                                          steps_per_frame=8.0)
    return gridded.synthesize_bank(gen, env, num_fields=3)


def check_small_iteration_against_cpu(get_preset, RolloutConfig, ttrain,
                                      draw_chunk, k, preset="ppo_v2_0",
                                      bank_kind=None, env=None, **ppo):
    """One small train iteration on the card and on the CPU from the same
    start, draws and shuffles, with the PPO config fields ``ppo`` and the
    env fields ``env`` set; with ``bank_kind`` on a 64-cell grid over a
    small bank of that kind."""
    import torch

    cfg = get_preset(preset)
    ppo.setdefault("minibatch_size", 32)
    env = dict(max_steps=6, initial_radius=200.0, **(env or {}))
    radius = 200.0
    if bank_kind is not None:
        env.update(grid_size=64, source_padding=10.0, initial_radius=30.0)
        radius = 30.0
    cfg = cfg.replace(
        env=dataclasses.replace(cfg.env, **env),
        ppo=dataclasses.replace(cfg.ppo, hidden_sizes=(64, 32), **ppo),
        curriculum=dataclasses.replace(cfg.curriculum, initial_radius=radius,
                                       window_size=4),
        rollout=RolloutConfig(num_envs=16, unroll_length=8))
    bank = (None if bank_kind is None
            else small_bank(k.gridded, bank_kind, cfg.env))
    cpu = ttrain.init_loop(cfg, "cpu", bank)
    draws = draw_chunk(torch.Generator().manual_seed(1), cfg.env, 8, 16)
    shuffles = [3, 77, 0, 101, 64]

    model = ttrain.make_policy_model(cfg).cuda()
    model.load_state_dict(cpu.model.state_dict())
    gpu = dataclasses.replace(
        cpu, model=model,
        optimizer=ttrain.ClippedAdam(model.parameters(),
                                     cfg.ppo.learning_rate,
                                     cfg.ppo.max_grad_norm),
        rollout=to_device(cpu.rollout, "cuda"))
    gpu = dataclasses.replace(
        gpu, rollout=dataclasses.replace(
            gpu.rollout, generator=torch.Generator(device="cuda")))
    _, cstats, ctraj = ttrain.build_train_step(cfg, bank)(
        cpu, draws=draws, shuffles=shuffles)
    gpu_bank = None if bank is None else bank.to("cuda")
    gstep = ttrain.build_train_step(cfg, gpu_bank)
    zero_counts(k)
    _, gstats, gtraj = gstep(gpu, draws=to_device(draws, "cuda"),
                             shuffles=shuffles)
    torch.cuda.synchronize()
    counts = read_counts(k)
    want = expected_counts(cfg, bank, 1)
    assert counts == want, f"launches {counts} != {want}"
    assert torch.equal(gtraj.action.cpu(), ctraj.action), "actions differ"
    assert torch.equal(gtraj.done.cpu(), ctraj.done), "dones differ"
    torch.testing.assert_close(gtraj.reward.cpu(), ctraj.reward, rtol=RTOL,
                               atol=ATOL)
    torch.testing.assert_close(gtraj.obs.cpu(), ctraj.obs, rtol=RTOL,
                               atol=ATOL)
    for key in ("loss/total", "loss/value", "loss/entropy"):
        assert math.isclose(float(gstats[key]), float(cstats[key]),
                            rel_tol=1e-4, abs_tol=1e-5), (
            key, gstats[key], cstats[key])
    label = {"preset": preset, "bank": bank_kind, **(env or {}), **ppo}
    log(f"small iteration {label}, card vs CPU: actions and dones equal, "
        f"{int(ctraj.done.sum())} episodes ended, launches "
        f"{ {n: c for n, c in counts.items() if c} }, loss/total "
        f"{float(gstats['loss/total']):.6f} vs "
        f"{float(cstats['loss/total']):.6f}")


def run_main_path(ttrain, rollout_chunk, k, label, cfg, bank=None, iters=3,
                  profile=True):
    """The full-width train step of ``cfg`` (over ``bank``, on the card),
    driven as ``train_ppo`` drives it, with every launch count set to 0
    just before ``init_loop`` and read just after the last iteration:
    ``init_loop``, a warm-up iteration, then ``iters`` timed iterations,
    each stretch's launches checked against the design's; then, with
    ``profile``, one profiled rollout chunk and one profiled iteration.
    Returns the counts (the whole run's and the timed iterations'),
    env-steps/s, phase ms, busy share and peak device memory."""
    import torch

    n, t = cfg.rollout.num_envs, cfg.rollout.unroll_length
    zero_counts(k)
    loop = ttrain.init_loop(cfg, "cuda", bank)
    torch.cuda.synchronize()
    after_init = read_counts(k)
    step = ttrain.build_train_step(cfg, bank, time_phases=True)
    t0 = time.perf_counter()
    loop, stats, _ = step(loop)
    torch.cuda.synchronize()
    log(f"main path {label} warm-up iteration: "
        f"{time.perf_counter() - t0:.3f} s")

    phases = {"rollout": 0.0, "gae": 0.0, "update": 0.0}
    torch.cuda.reset_peak_memory_stats()
    before = read_counts(k)
    t0 = time.perf_counter()
    for _ in range(iters):
        loop, stats, traj = step(loop)
        for key in phases:
            phases[key] += stats[f"time/{key}_ms"]
        for key in ("loss/total", "loss/policy", "loss/value",
                    "loss/entropy"):
            assert math.isfinite(float(stats[key])), (key, stats[key])
        assert traj.obs.shape == (t, n, cfg.env.obs_dim)
        assert torch.isfinite(traj.obs).all() and torch.isfinite(traj.reward).all()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    total = read_counts(k)
    counts = count_diff(total, before)
    checks = ((after_init, expected_init_counts(cfg, bank), "init_loop"),
              (count_diff(before, after_init), expected_counts(cfg, bank, 1),
               "warm-up"),
              (counts, expected_counts(cfg, bank, iters), "timed"))
    for got, want, stretch in checks:
        assert got == want, (label, stretch, got, want)
    max_mem = torch.cuda.max_memory_allocated()
    sps = iters * n * t / wall
    log(f"main path {label}: {cfg.name} {n} envs x {t} steps, minibatch "
        f"{cfg.ppo.minibatch_size}, {cfg.ppo.epochs} epochs: {iters} "
        f"iterations in {wall:.3f} s = {sps:.1f} env-steps/s")
    log(f"main path {label} ms per iteration: " + ", ".join(
        f"{key} {v / iters:.2f}" for key, v in phases.items())
        + f", whole {wall / iters * 1e3:.2f}; max_memory_allocated "
        f"{max_mem} B")
    log(f"main path {label} last iteration: loss/total "
        f"{float(stats['loss/total']):.5f}, episodes "
        f"{stats['rollout/episodes']}, radius "
        f"{stats['curriculum/radius']:.2f}; launches of init_loop "
        f"{ {name: c for name, c in after_init.items() if c} }, over the "
        f"whole run {total}, per timed iteration "
        f"{ {name: c // iters for name, c in counts.items()} }")
    busy = profiled = roll = None
    if profile:
        roll = profile_rollout(rollout_chunk, loop, cfg, bank)
        log(f"profile of one main-path rollout chunk (profiler on): "
            f"{roll['launches']} device launches, "
            f"{roll['launches_per_step']:.2f} per env step, device "
            f"{roll['device_ms']:.2f} ms of {roll['wall_ms']:.2f} ms wall")
        loop, busy, profiled = profile_iteration(step, loop)
    return dict(counts=counts, total_counts=total, sps=sps,
                whole_ms=wall / iters * 1e3, busy=busy,
                profiled_launches=profiled, rollout_profile=roll,
                max_memory_allocated=max_mem,
                **{key: v / iters for key, v in phases.items()})


def run_cli(cli_main, ActorCritic, preset, obs_dim, num_actions, *flags):
    import torch

    with tempfile.TemporaryDirectory() as tmp:
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            cli_main(["train", "--preset", preset, "--out", tmp,
                      "--iterations", "2", "--minibatch", str(MAIN_MB),
                      *flags])
        res = json.loads(out.getvalue().strip().splitlines()[-1])
        assert res["env_steps"] == 2 * 4096 * 128, res
        with open(os.path.join(tmp, "training_results.csv")) as fh:
            rows = fh.read().strip().splitlines()
        assert len(rows) - 1 == res["episodes"], (len(rows), res)
        ckpt = torch.load(os.path.join(tmp, "checkpoint.pt"),
                          weights_only=False)
        assert ckpt["counters"]["iteration"] == 2
        model = ActorCritic(obs_dim, num_actions, MAIN_HIDDEN)
        model.load_state_dict(torch.load(
            os.path.join(tmp, "model", "ppo_successful_models.pth")))
        assert all(torch.isfinite(p).all() for p in model.parameters())
        log(f"cli train --preset {preset} {' '.join(flags) or '(f32)'}: 2 "
            f"iterations, {res['episodes']} episodes in the CSV, "
            f"{res['steps_per_sec']:.1f} env-steps/s after the first; "
            "checkpoint and .pth load")


def build_kernels(build, names) -> None:
    """One nvcc per source, all started together."""
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        for name, _ in zip(names, pool.map(
                lambda name: build.build(name, verbose=True), names)):
            log(f"kernel build: {name} done at "
                f"{time.perf_counter() - t0:.2f} s")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from tpu_plume_torch.cli.main import main as cli_main
    from tpu_plume_torch.core.config import PPOConfig, RolloutConfig, get_preset
    from tpu_plume_torch.fields import gridded
    from tpu_plume_torch.models import ActorCritic
    from tpu_plume_torch.ops import build, gather, plume
    from tpu_plume_torch.ops import ppo as fused_ops
    from tpu_plume_torch.rl.ppo import PPOBatch, ppo_loss
    from tpu_plume_torch.rollout import rollout
    from tpu_plume_torch.rollout.rollout import draw_chunk
    from tpu_plume_torch.train import ppo_trainer as ttrain

    # Products in full f32 and bf16 products with f32 reductions, as the
    # parity checks assume.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    card = card_line()
    log(f"card: {card}; {torch.cuda.get_device_name(0)}; torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")

    build_kernels(build, ("plume", "ppo", "gather"))

    plume_report = check_plume_kernel(get_preset, plume)
    modes_err = check_plume_modes(get_preset, plume, rollout)
    env_err = check_env_step_kernel(get_preset, plume, rollout)
    env_time = time_env_step_kernel(get_preset, plume, rollout)
    ppo_args = (ActorCritic, PPOConfig, PPOBatch, fused_ops, ppo_loss)
    ppo_err = check_ppo_kernel(*ppo_args)
    ppo_time = time_ppo_kernel(*ppo_args)
    gather_err = check_gather_kernels(gather)
    gather_time = time_gather_kernels(gather)
    sample_err = check_sample_kernels(get_preset, gridded, gather)
    sample_time = time_sample_kernels(get_preset, gridded, gather)

    k = types.SimpleNamespace(plume=plume, fused_ops=fused_ops, gather=gather,
                              gridded=gridded)
    small = (get_preset, RolloutConfig, ttrain, draw_chunk, k)
    check_small_iteration_against_cpu(*small)
    check_small_iteration_against_cpu(*small, fused_update=True,
                                      minibatch_size=128)
    check_small_iteration_against_cpu(*small, bf16_compute=True)
    check_small_iteration_against_cpu(*small, fused_update=True,
                                      bf16_compute=True, minibatch_size=128)
    check_small_iteration_against_cpu(*small, preset="wrf_les")
    check_small_iteration_against_cpu(*small, preset="wrf_les_3d",
                                      bank_kind="3d")
    check_small_iteration_against_cpu(
        *small, bank_kind="static",
        env=dict(plume_model="gridded", subcell_sampling=True))

    # The three ppo_v2_0 variants in turns, A B C C B A, each block on a
    # fresh loop, so that a drift of the host's speed during the run shows
    # as a difference between a variant's two blocks.
    variants = {"f32": {}, "fused_update": dict(fused_update=True),
                "bf16_compute": dict(bf16_compute=True)}
    runs = {name: [] for name in variants}
    v20 = get_preset("ppo_v2_0")
    for i, name in enumerate(list(variants) + list(reversed(variants))):
        cfg = v20.replace(ppo=dataclasses.replace(
            v20.ppo, minibatch_size=MAIN_MB, **variants[name]))
        runs[name].append(run_main_path(ttrain, rollout.rollout_chunk, k,
                                        name, cfg, profile=i < 3))
        torch.cuda.empty_cache()
    for name, blocks in runs.items():
        log(f"main path summary {name} (blocks in run order): env-steps/s "
            + ", ".join(f"{b['sps']:.1f}" for b in blocks) + "; ms "
            + "; ".join(", ".join(f"{key} {b[key]:.2f}" for key in
                                  ("rollout", "gae", "update", "whole_ms"))
                        for b in blocks))
    launches = runs["f32"][0]["total_counts"]
    fused_launches = runs["fused_update"][0]["total_counts"]

    # wrf_les at full width: the anisotropic plume in a per-episode wind,
    # one env-step launch per env step, no cuts.
    wl = get_preset("wrf_les")
    wl = wl.replace(ppo=dataclasses.replace(wl.ppo, minibatch_size=MAIN_MB))
    aniso = run_main_path(ttrain, rollout.rollout_chunk, k, "wrf_les", wl)
    torch.cuda.empty_cache()

    # wrf_les_3d at full width: the bank of --synth-bank 3d, no cuts.
    w3 = get_preset("wrf_les_3d")
    w3 = w3.replace(ppo=dataclasses.replace(w3.ppo, minibatch_size=MAIN_MB))
    bank = gridded.synthesize_3d_bank(
        torch.Generator(device="cuda").manual_seed(0), w3.env)
    log(f"wrf_les_3d bank {list(bank.conc.shape)}, {bank.conc.numel() * 4} B")
    wrf = run_main_path(ttrain, rollout.rollout_chunk, k, "wrf_les_3d", w3,
                        bank)
    del bank
    torch.cuda.empty_cache()
    # A static bank read between cells: the bilinear kernel's path.
    st = v20.replace(
        ppo=dataclasses.replace(v20.ppo, minibatch_size=MAIN_MB),
        env=dataclasses.replace(v20.env, plume_model="gridded",
                                subcell_sampling=True))
    bank = gridded.synthesize_bank(
        torch.Generator(device="cuda").manual_seed(0), st.env, num_fields=64)
    static = run_main_path(ttrain, rollout.rollout_chunk, k,
                           "static_subcell", st, bank, iters=2)
    del bank
    torch.cuda.empty_cache()
    profiled = (("ppo_v2_0 f32", runs["f32"][0]),
                ("ppo_v2_0 fused_update", runs["fused_update"][0]),
                ("ppo_v2_0 bf16_compute", runs["bf16_compute"][0]),
                ("wrf_les", aniso), ("wrf_les_3d", wrf),
                ("static_subcell", static))
    log("profiled launches per iteration: " + ", ".join(
        f"{label} {run['profiled_launches']}" for label, run in profiled))
    log("profiled rollout launches per env step: " + ", ".join(
        f"{label} {run['rollout_profile']['launches_per_step']:.2f}"
        for label, run in profiled))

    run_cli(cli_main, ActorCritic, "ppo_v2_0", MAIN_D, MAIN_A)
    run_cli(cli_main, ActorCritic, "ppo_v2_0", MAIN_D, MAIN_A, "--bf16")
    run_cli(cli_main, ActorCritic, "wrf_les", 6, 5)
    run_cli(cli_main, ActorCritic, "wrf_les_3d", 7, 7, "--synth-bank", "3d")

    main_t = plume_report["timing"][MAIN_N]
    env_t = env_time["ppo_v2_0"][MAIN_N]
    aniso_t = env_time["wrf_les"]
    ppo_t = ppo_time["f32"]
    kernels = [{
        "name": "plume_sample",
        "route": "cuda",
        "source": "tpu_plume_torch/csrc/plume.cu",
        "replaces": "tpu_plume/ops/pallas_plume.py:29",
        "launches": launches["plume_sample"],
        "max_abs_err": max(plume_report["max_abs_err"], modes_err),
        "ms": main_t["ms"],
        "plain_ms": main_t["plain_ms"],
        "bound_ms": main_t["bound_ms"],
        "bound_by": main_t["bound_by"],
        "library_ms": None,
        "device_ms": main_t["device_ms"],
        "split_ns": plume_report["timing"]["split_ns"],
    }, {
        "name": "env_step",
        "route": "cuda",
        "source": "tpu_plume_torch/csrc/plume.cu",
        "replaces": "tpu_plume/ops/pallas_plume.py:29",
        "launches": launches["env_step"],
        "launches_timed": runs["f32"][0]["counts"]["env_step"],
        "max_abs_err": env_err,
        "ms": env_t["ms"],
        "plain_ms": env_t["plain_ms"],
        "bound_ms": env_t["bound_ms"],
        "bound_by": env_t["bound_by"],
        "library_ms": None,
        "device_ms": env_t["device_ms"],
        "bytes": env_t["bytes"],
        "large_n": env_time["ppo_v2_0"][LARGE_N],
        "split_ns": env_time["ppo_v2_0"]["split_ns"],
        "wrf_les": {
            "launches": aniso["total_counts"]["env_step"],
            "launches_timed": aniso["counts"]["env_step"],
            "rollout_launches_per_step":
                aniso["rollout_profile"]["launches_per_step"],
            **aniso_t[MAIN_N], "large_n": aniso_t[LARGE_N]},
    }, {
        "name": "ppo_fused",
        "route": "cuda",
        "source": "tpu_plume_torch/csrc/ppo.cu",
        "replaces": "tpu_plume/ops/pallas_ppo.py:60",
        "launches": fused_launches["ppo_fused"],
        "launches_timed": runs["fused_update"][0]["counts"]["ppo_fused"],
        "max_abs_err": ppo_err,
        "ms": ppo_t["ms"],
        "plain_ms": ppo_t["plain_ms"],
        "bound_ms": ppo_t["bound_ms"],
        "bound_by": ppo_t["bound_by"],
        "library_ms": None,
        "device_ms": ppo_t["device_ms"],
        "kernels": ["ppo_row_kernel", "ppo_dw2_kernel", "ppo_reduce_kernel"],
        "row_device_ms": ppo_t["row_device_ms"],
        "dw2_launches": fused_launches["ppo_dw2"],
        "dw2_device_ms": ppo_t["dw2_device_ms"],
        "reduce_launches": fused_launches["ppo_reduce"],
        "reduce_device_ms": ppo_t["reduce_device_ms"],
        "autodiff_ms": ppo_t["autodiff_ms"],
        "bf16": ppo_time["bf16"],
    }]
    for name, replaces, run in (
            ("bilinear", "tpu_plume/ops/pallas_gather.py:31", static),
            ("trilinear_zyx", "tpu_plume/ops/pallas_trilinear.py:41", wrf)):
        t4 = gather_time[name][MAIN_N]
        s4 = sample_time[name][MAIN_N]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "tpu_plume_torch/csrc/gather.cu",
            "replaces": replaces,
            "launches": run["total_counts"][name],
            "launches_timed": run["counts"][name],
            "max_abs_err": gather_err[name],
            "ms": t4["ms"],
            "plain_ms": t4["plain_ms"],
            "bound_ms": t4["bound_ms"],
            "bound_by": t4["bound_by"],
            "library_ms": t4["library_ms"],
            "device_ms": t4["device_ms"],
            "ms_blocks": t4["ms_blocks"],
            "library_ms_blocks": t4["library_ms_blocks"],
            "large_n": gather_time[name][LARGE_N],
            "sample_ms": s4["ms"],
            "sample_device_ms": s4["device_ms"],
            "sample_plain_ms": s4["plain_ms"],
            "sample_bound_ms": s4["bound_ms"],
            "sample_bound_by": s4["bound_by"],
            "sample_max_abs_err": sample_err[name],
            "sample_large_n": sample_time[name][LARGE_N],
        })
    log("host split (ns per call) of the bank sample wrapper: "
        + json.dumps(sample_time["split_ns"]) + "; of the trilinear gather "
        "wrapper: " + json.dumps(gather_time["split_ns"]))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
