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
   bools and positions bit-equal; the same kernel given a guide's executed
   actions (a third of the envs overridden each step) against
   ``env_step_plain(exec_action=)`` in the v1_1, v1_0, obs_memory and
   wrf_les cases, the override rows bit-equal too and the sampled action
   the kernel records bit-equal to the PyTorch argmax the guide saw; the
   fused PPO gradients in
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
   the bank step kernel (the env step around the bank sample, one launch)
   against ``env_step_plain`` over the [4, 8, 8, 500, 500] bank of
   wrf_les_3d in 3-D flight at N = 32768 and the [64, 500, 500] static
   bank of static_subcell in 2-D flight at N = 4096, 128 steps from three
   starts each with radii of 40-300, every trajectory, record, next-obs,
   state and totals tensor bit-equal;
4. each kernel's time, its plain version's and the least time the card
   could take for the same bytes and operations (the plume sample and the
   env step with the host cost of each piece of their wrappers; the env
   step on ppo_v2_0's isotropic plume and on wrf_les's anisotropic one, and
   on ppo_v2_0 without and with the executed action in alternating
   blocks; the bank step against ``env_step_plain`` per step in
   alternating blocks at N = 4096 and 32768, with its device time and
   the bound ``bank_step_bytes``);
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
   bank read between cells; the recurrent policy (``arch="lstm"``) in f32,
   with the LayerNorm cell, and with it in bf16 (at most one of the 16 envs
   may part from the CPU's actions, the step where it parts logged);
6. the main paths at full width, 4096 envs x 128 steps, minibatch 65536,
   5 epochs, each driven as ``train_ppo`` drives it, with the kernel launch
   counts set to 0 just before ``init_loop`` and read just after the last
   iteration (``init_loop``, one warm-up and the timed iterations, each
   stretch's launches checked), then one rollout chunk and one iteration
   under the profiler, recording the device's activity alone (the chunk's
   launches per env step and the iteration's launches printed): the
   ppo_v2_0 train step (one env-step
   launch per env step) with
   the 6->256->128 network in three variants (f32 autodiff,
   ``fused_update``, ``bf16_compute``); wrf_les (the anisotropic plume in
   a per-episode wind, one env-step launch per env step, the 6->256->128
   network); wrf_les_3d (3-D flight through the
   [4, 8, 8, 500, 500] bank of ``--synth-bank 3d``, the 7->256->128 network;
   one bank-step launch per env step); the 64-field static bank of
   ``--synth-bank static`` read between cells (one bank-step launch per
   env step); ppo_v2_0 with the recurrent policy (``--arch lstm``, 6 -> 128
   -> LayerNorm -> LSTM 128 -> {5, 1}, f32, the BPTT update over 512-env
   sequence minibatches; one env-step launch per env step, and T launches
   of each LSTM step kernel a minibatch's graph replays), its rollout
   chunk profiled and its iteration not (the processing of its 135 k
   launches took 52.7 s on an NVIDIA H100 80GB HBM3, 700.00 W); then one
   minibatch step of its update, forward and backward, through
   ``sequence`` and through a chain of
   ``step`` calls (the same loss and gradients, each one's ms and
   launches); the LSTM step kernels (``ops/lstm.py``) against autodiff
   through the eager loop and their plain version at LSTM_CHECKS (T
   launches each a call; the forward's unequal elements, the gradients
   within 2e-5 x max|grad|), each kernel's time beside its byte bound and
   its plain step's, and one minibatch's recurrence through the kernels,
   the loop and the plain version; ppo_v2_0 and wrf_les with the training guide (``train
   --train-guide fit --min-radius 50 --terminal-gate 40``: the fit guide in
   the rollout, still one env-step launch per env step, the overridden
   steps masked out of the update; 3 and 1 timed iterations), their share
   of overridden steps, and a GUIDED_PROFILE_STEPS-step chunk profiled on
   the device alone for the launches per env step;
7. the evaluation harness at the reference protocol's width, 1000
   episodes x 1000 steps, each episode reset once and frozen once it ends:
   eval A, ppo_v2_0 with the heuristic stop and the params of the f32 main
   path (one plume-sample launch per eval step plus one at the reset), and
   eval B, wrf_les_3d over the main path's bank with its params (one bank
   sample, the trilinear kernel, per step plus one), and eval A with the
   recurrent main path's policy as ``rnn=``; each with the launch
   counts set to 0 just before it and read just after, its summary, wall
   ms and eval env-steps/s, then its first EVAL_PROFILE_STEPS steps again
   unprofiled and under the profiler for their launches per eval step and
   device busy share (device kernel time over the unprofiled wall of the
   same steps); and each at that width on the
   card against the CPU from the same draws (at most one episode in 64
   may differ in steps, stop flag or deviation beyond the env tolerance;
   where each such path departs is logged), with a third such check of
   the heuristic gate in a setting where it stops some episodes early and
   not all;
8. the ``train`` CLI for two iterations at the same width: ppo_v2_0 in f32
   and with ``--bf16``, ``--preset wrf_les``, and ``--preset wrf_les_3d
   --synth-bank 3d``, and ``--arch lstm`` (``checkpoint.pt`` and no
   ``.pth``); on the f32 run ``eval --pth`` and ``eval --ckpt``
   with the heuristic stop (the same summary, the reference's
   ``validation_metrics.npz`` and ``evaluation_results.csv``) and ``expert
   --episodes 100`` (the ``expert_data.npz`` contract); on the recurrent
   run ``eval --arch lstm --ckpt`` and ``expert --arch lstm --ckpt``; on
   the f32 run ``eval --pth --guide fit`` (the npz with the ten guide
   fields), and ``train --train-guide fit --min-radius 50 --terminal-gate
   40``;
9. a learning check, printed and not a gate: ppo_v2_0 f32 trained at full
   width for 20 iterations through ``train_ppo`` with the trajectory
   capture on (``capture_conc_csv``, and ``capture_netcdf`` where h5py is
   installed), its launch counts read over the run (one env-step launch
   per env step, the capture adds none), its iteration time beside a
   shorter run of the same config without the capture; then eval A's
   protocol over the same draws for the trained and the untrained initial
   params;
10. the stop LSTMs on the card, from the captured episodes: a 3-epoch run
   of ``train_threshold_lstm`` (its dropout off) and of
   ``train_peak_stop_lstm`` on the card against the same runs on the CPU
   (the same init and batches, losses within rtol 1e-4); one epoch of
   each profiled (ms and launches per minibatch step); each trained at
   the JAX package's epochs (150 and 100, cut so that each phase stays
   within TRAINER_BUDGET_S, the cut printed); then eval A with the
   trained policy and ``--stop threshold`` and ``--stop peakstop`` gates
   of those nets (the CLI's ``lstm_gate``), each run as phase 7 runs an
   eval (exact plume-sample launches, wall, launches per eval step, busy
   share) and on the card against the CPU (at most one episode in 64
   apart); then the CLI: ``train-lstm --variant v12`` on the captured
   ``data.csv`` and ``eval --stop threshold`` / ``--stop peakstop
   --lstm-ckpt`` on the checkpoints the trainers wrote, each checked for
   its JSON line;
11. ``fit_aniso`` alone on the card against the CPU over 1000 of
   wrf_les's guide buffers [1000, 128] (noisy transects, ridge segments
   and sparse reads: n_eff equal, at most one buffer in 64 whose gate
   decision or validated fit parts, see ``fits_apart``); then the fit
   guide in the protocol's evals (``eval --guide fit``, no stop),
   1000 episodes x 1000 steps: ppo_v2_0 with the learning check's trained
   params and wrf_les with its main path's params; each with exact
   plume-sample launches (the guide launches none), its summary beside the
   same eval unguided, wall, eval env-steps/s, the shares of episodes
   ending with a validated fit, in hover and committed; the first
   GUIDE_PROFILE_STEPS steps unprofiled and profiled (launches per eval
   step, busy share; on wrf_les one fit's device time over every
   episode's buffers); and the first 256 (ppo_v2_0) and 8 (wrf_les) of
   the card's episodes on the CPU from the same draws (the CPU fits every
   episode at every step), at most one episode in 64 apart (at least one
   allowed);
12. the eval guides, each in the protocol's eval (1000 episodes x 1000
   steps, no stop) with exact field-sample launches (the guides and
   oracles launch none of the counted kernels), its summary beside the
   same eval without the guide, wall, eval env-steps/s, the first
   GUIDE_PROFILE_STEPS steps profiled for launches per eval step and busy
   share, and its first 64 episodes on the CPU from the same draws (at
   most one apart; the learned guide's also teacher-forced, every
   estimate within LEARNED_EST_LIMIT px of the card's or, on a window
   where rounding moves the localizer further, SENSITIVITY_FACTOR times
   that, a free run's departure excused only at a decision within that
   limit of its bound, ``learned_against_cpu``): ``eval --guide bank``
   with JAX's defaults over wrf_les's 16-row static bank read between
   cells (the bilinear kernel), and with guard_top / sticky_target /
   dive_bias and with entry_dive over wrf_les_3d's [4, 8, 8, 500, 500]
   bank (the trilinear kernel), each policy BANK_POLICY_ITERS card
   iterations of its config; the learning check's policy's flights
   (``eval --save-flights``) train the localizer (``train-lstm --variant
   params``, its epochs cut to LOCALIZER_BUDGET_S), which then steers
   (``eval --guide learned --localize``) and localizes after the fit
   guide (``eval --guide fit --localize``, the ``hybrid_*`` errors), the
   card's localization held to the CPU's; ``eval --oracle phase`` and
   ``--oracle raster --guide fit``; ``expert --oracle phase`` at 1000
   episodes with the same samples and actions as on the CPU; and the CLI's
   ``eval --guide bank``, ``eval --guide learned --localize`` and
   ``expert --oracle phase``;
13. imitation (slice 10) at ppo_v2_0's full width on phase 12's expert
   file (1000 phase-oracle episodes): distilled PPO (``distill_oracle=
   "phase"``) in f32 and with ``fused_update`` (which takes autodiff: no
   fused launch), exact launch counts (one env-step launch per env step,
   the oracle launching none of the counted kernels), ms by phase,
   ``loss/distill``, the labelled chunk profiled for its launches per
   env step, and one labelled chunk on the card against the CPU (at most
   one env in 64 whose labels, actions or dones part, each logged);
   closed-loop GAIL with ``fused_update`` off and on (``train_ppo_gail``
   for 2 iterations with exact launch counts, then its step timed: ms by
   phase with the discriminator's step split out, its loss and accuracy,
   128 env-step launches per iteration and 40 of each fused kernel under
   ``fused_update``) and one small GAIL iteration on the card against the
   CPU (phase 5's check); DAgger against the phase oracle, 512 episodes x
   1000 steps, DAGGER_ROUNDS of JAX's 8 rounds (each collection one plume
   sample per step plus the reset's, and its fit, timed), one
   student-driven round's collection on the card against the CPU (at most
   one episode in 64 whose labels or ``valid`` rows part), and sequence
   DAgger (``--arch lstm --ln-lstm``) 2 rounds cut to 64 episodes of 250
   steps and one epoch a round; then the CLI: ``train-bc`` at JAX's
   defaults and ``eval --ckpt`` of its checkpoint, ``train-dagger
   --rounds 2``, ``train-gail --closed-loop --iterations 2`` and ``train
   --distill phase --iterations 1`` with exact launch counts;
14. flux inversion (slice 11), each study 64 episodes x 500 steps with
   estimated positions and 3 sources, through ``flux_inversion_study``:
   the raster protocol (RESULTS.md's round 5), the random survey, the
   two-pass survey (100 of the steps for pass 2), the anisotropic plume
   (wrf_les) and analytic 3-D flight; then the learning check's policy's
   survey through ``cli flux --ckpt``.  Each launches the plume sample
   exactly steps + 1 times and no other counted kernel; its wall ms, its
   first EVAL_PROFILE_STEPS steps profiled (launches per survey step,
   busy share); and on the card against the CPU from the same draws
   (``flux_against_cpu``: at most one flight in 64 apart beyond the env
   tolerance; estimates
   within FLUX_POS_LIMIT px and FLUX_Q_RTOL, or replayed stage by stage;
   each decision apart logged with its margins).  The raster protocol
   must reach within_20pct >= 0.75 and observed_frac >= 0.95;
15. the train flags and data parallel (slice 12): ``train_ppo`` resumed
   bit for bit (ppo_v2_0 f32 and ``fused_update`` at full width,
   wrf_les_3d over its bank: 4 iterations at ``sync_every`` 2 against the
   run killed after its snapshot at 2 and resumed to 4; params, optimizer
   state, rollout carry, generator, counters, curriculum and
   ``training_results.csv`` equal, exact launches); ``cli train
   --profile-steps 2 --tensorboard`` (the trace holds the traced
   iterations' env-step launches; event files, or the line saying
   tensorboard does not import) and ``--debug-nans`` for one iteration;
   the packed drain (a profiled full-width run with the CSV makes the same
   device-to-host copies as with ``--no-csv``, each window's stats copy
   carrying its compacted record rows), and iteration ms with and without
   the CSV in alternating blocks; the data-parallel step at world size 1
   through NCCL against the plain step, f32 and ``fused_update``, bit for
   bit with the same launches; and 2 gloo ranks sharing the card against
   one process at a small width.  It prints a ``scale_out`` JSON line.

``python3 chip_smoke.py --only guide`` runs, after the build, the guide's
phases alone (the executed-action mode, the guided training paths, the
learning check for a trained policy, the fit check, the guided evals of
the trained and the untrained ppo_v2_0 and wrf_les params, phase 12, the
guided CLI); ``--only stop-lstm`` runs phases 9 and 10 alone, and
``--only eval-guides`` the learning check and phase 12, ``--only
imitation`` phase 13 on an expert file of its own, ``--only flux``
the learning check and phase 14, ``--only scale-out`` phase 15, and
``--only bank-step`` the bank step kernel's parity and times and the
wrf_les_3d and static-bank main paths, and ``--only lstm-step`` the LSTM
step kernels' parity and times.  Each prints its JSON
record, each phase's seconds and the card's name and power limit.

Then it prints a JSON line of the eval phases, one of the recurrent main
path and its replay, one of the capture and the stop LSTMs
(``stop_lstm``), one of phase 12 (``eval_guides``), one of phase 13
(``imitation``), one of phase 14 (``flux``), one of the guide's
phases (``guide``), each phase's seconds, the ``kernels`` JSON line (each
kernel's launches in
evals A and B under ``eval_launches``, the recurrent path's under
``lstm`` and ``lstm_eval_launches``, the gated evals' under
``gated_eval_launches``, the capture run's under ``capture``, the guided
training's under ``guided``, the executed-action mode's parity and times
under ``exec_action``, the guided evals' under ``guided_eval_launches``,
and in every entry phase 12's under ``bank_guided_eval_launches``,
``learned_guided_eval_launches`` and ``oracle_eval_launches``; phase
13's under ``imitation``; phase 14's plume-sample launches under
``flux_launches``; phase 15's under ``scale_out_launches``; the LSTM
step kernels' entry last, with their parity and times), the
card's
name and power limit, and, last, the result line ``{"ok": true,
"device": {...}}``.  h5py is never imported here (``find_spec`` tells
whether it is installed): the card's machine may have none.
"""

from __future__ import annotations

import concurrent.futures
import argparse
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
# The bank step kernel against env_step_plain: wrf_les_3d's envs over the
# main path's bank, a chunk from each of three starts.
BANK_STEP_N = 32768
BANK_STEP_STEPS = 128
BANK_STEP_SEEDS = (3, 1009, 2718281828)
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
# The small recurrent iterations on the card against the CPU: how many of
# their 16 envs may part from the CPU's actions.
SMALL_LSTM_APART = 1
# The recurrent update's minibatch at full width: 512 env sequences of 128
# steps; episode ends at about one in 200 steps.
LSTM_MB_ENVS, LSTM_RESET_RATE = 512, 1.0 / 200.0
# The LSTM step kernels' checks (N, T, H): the benchmarked cell's
# minibatch (2048 sequences of 128 steps) and a ragged N; their times at
# the first.
LSTM_CHECKS = ((2048, 128, 128), (1999, 128, 128))
# The eval phases: the warm-up's steps and the learning check's
# iterations.
EVAL_WARMUP = 16
# The steps of an eval of phases 7 and 10 run again under the profiler (the
# whole eval profiled took 25-40 s each).
EVAL_PROFILE_STEPS = 100
LEARN_ITERS = 20
# Iterations of the same run without the capture, for its iteration time,
# and the learning check's episode target (the NetCDF capture's rows).
NO_CAPTURE_ITERS = 8
LEARN_EPISODE_CAP = 10**6
# The stop-LSTM trainers: the JAX package's epochs, the wall each phase may
# take before its epochs are cut, and the epochs of the card-vs-CPU runs.
THRESHOLD_EPOCHS, PEAK_STOP_EPOCHS = 150, 100
TRAINER_BUDGET_S = 6.0
EPOCH_MARGIN = 1.5
TRAINER_CHECK_EPOCHS = 3
TRAINER_RTOL = 1e-4
STOP_GATES = ("threshold", "peakstop")
# The heuristic gate's card check (tests/test_torch_eval.py's setting): a
# 100-cell grid with a wide plume, low turbulence and a goal radius of 5,
# and a policy whose stay action's bias is raised by STAY_BIAS, so that it
# stays put and the concentration at the start decides: the gate fires
# where the source lies near the start and not elsewhere.
STOP_ENV = dict(grid_size=100, source_padding=10.0, turbulence_intensity=0.5,
                plume_sigma=60.0, initial_radius=5.0)
STAY_BIAS = 1.0
# Operations the anisotropic base adds to a plume query's, a source: the
# unit wind (about 8), the downwind and crosswind distances (about 8), the
# crosswind spread with its pow (4), the centerline (3), two exponentials
# with their arguments (8), and the blob's max and select (4).
ANISO_OPS_PER_SOURCE = 35


T_START = time.perf_counter()


def log(*parts):
    print(f"[{time.perf_counter() - T_START:7.1f} s]", *parts, flush=True)


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
                        value.data_ptr(), None)
                out[preset]["split_ns"] = host_split("the env-step wrapper", {
                    "checks": lambda: stepper.takes(logits, value),
                    "stream": lambda: plume._raw_stream(stepper.index),
                    "data_ptr": lambda: (logits.data_ptr(), value.data_ptr()),
                    "entry_launch": lambda: stepper.launch(*args, stream),
                    "wrapper": call,
                }, reps=5000)
    return out


def profile_rollout(rollout_chunk, loop, cfg, bank=None, guide=None,
                    cpu=True, length=None, oracle=None) -> dict:
    """Device launches per env step, device ms and wall ms of one rollout
    chunk of the main path (``loop``'s carry is not modified; with
    ``guide`` the guided chunk, with ``oracle`` the labelled one of
    distilled PPO; of ``length`` steps, by default the unroll), from
    torch.profiler; without ``cpu`` it records the device's activity
    alone."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    length = length or cfg.rollout.unroll_length
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA] + (
            [ProfilerActivity.CPU] if cpu else [])) as prof:
        t0 = time.perf_counter()
        rollout_chunk(loop.model, loop.rollout, cfg.env, length, bank=bank,
                      guide=guide, oracle=oracle)
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
    ``fn``: the self device time of the profiler's CUDA entries whose key
    holds the name; None if they recorded none.  Where the name matches
    more than one entry, or another kind of entry, or no device time, or
    where the first matching entry's self time differs from the sum, the
    entries are logged."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):   # the profiler has kept no event in some runs
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        found = [e for e in prof.key_averages()
                 if kernel_name in e.key and e.count]
        if found:
            break
    kernels = [e for e in found if e.device_type == DeviceType.CUDA]
    total_us = sum(e.self_device_time_total for e in kernels)
    first_us = found[0].self_device_time_total if found else 0
    if (len(found) != 1 or len(kernels) != 1 or not total_us
            or first_us != total_us):
        log(f"kernel_device_ms {kernel_name}: {len(found)} profiler entries: "
            + "; ".join(f"{e.key[:80]!r} {e.device_type} x{e.count} self "
                        f"{e.self_device_time_total} total "
                        f"{e.device_time_total}" for e in found))
    if not total_us:
        return None
    return total_us / sum(e.count for e in kernels) / 1e3


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


def profile_iteration(step, loop, cpu=True):
    """Device kernel time, kernel count and busy share of one main-path
    iteration, from torch.profiler; without ``cpu`` it records the device's
    activity alone (the recurrent iteration's 150 k launches take minutes
    to sort with their host operations)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU]
                                            if cpu else [])
    with profile(activities=activities) as prof:
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
    return loop, device_ms / wall_ms, count, device_ms


def to_device(obj, device):
    """Tensors of (nested) dataclasses and tuples moved to ``device``."""
    import torch

    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    if isinstance(obj, tuple):
        return tuple(to_device(x, device) for x in obj)
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **{
            f.name: to_device(getattr(obj, f.name), device)
            for f in dataclasses.fields(obj)
            if isinstance(getattr(obj, f.name), (torch.Tensor, tuple))
            or dataclasses.is_dataclass(getattr(obj, f.name))})
    return obj


KERNEL_NAMES = ("plume_sample", "env_step", "ppo_fused", "ppo_dw2",
                "ppo_reduce", "bilinear", "trilinear_zyx", "bank_step")


def zero_counts(k) -> None:
    """Set every kernel's launch count to 0 (``k`` holds the plume, ppo and
    gather ops modules)."""
    k.plume.launches = k.plume.env_step_launches = 0
    k.plume.bank_step_launches = 0
    k.fused_ops.launches = k.fused_ops.dw2_launches = 0
    k.fused_ops.reduce_launches = 0
    k.gather.bilinear.launches = k.gather.trilinear_zyx.launches = 0


def read_counts(k) -> dict:
    return dict(zip(KERNEL_NAMES, (
        k.plume.launches, k.plume.env_step_launches, k.fused_ops.launches,
        k.fused_ops.dw2_launches, k.fused_ops.reduce_launches,
        k.gather.bilinear.launches, k.gather.trilinear_zyx.launches,
        k.plume.bank_step_launches)))


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
    plume sample; over a bank read between cells one bank-step launch per
    env step (the same step around the bank's sub-cell sample), and no
    sample launch; each minibatch step of the fused update one launch each
    of the row kernel, the dW2 kernel and the reduction (none under
    distilled PPO: a labelled batch takes autodiff, as in JAX)."""
    env, ppo = cfg.env, cfg.ppo
    n, t = cfg.rollout.num_envs, cfg.rollout.unroll_length
    want = dict.fromkeys(KERNEL_NAMES, 0)
    kernel = _field_sample(env, bank)
    if kernel == "plume_sample":
        want["env_step"] = iters * t
    elif kernel is not None:
        want["bank_step"] = iters * t
    if ppo.fused_update and ppo.distill_oracle is None:
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
                                      bank_kind=None, env=None, gail=False,
                                      **ppo):
    """One small train iteration on the card and on the CPU from the same
    start, draws and shuffles, with the PPO config fields ``ppo`` and the
    env fields ``env`` set; with ``bank_kind`` on a 64-cell grid over a
    small bank of that kind; with ``gail`` a closed-loop GAIL iteration
    (``build_gail_train_step``) from the same discriminator, expert pairs
    and discriminator rows.  Actions and dones are equal, rewards and obs
    within the env tolerance, losses (and the discriminator's) within rtol
    1e-4 / atol 1e-5.  With
    the recurrent policy the carry takes rounding from step to step, so an
    env's sampled action may flip late in the chunk: at most
    SMALL_LSTM_APART of its 16 envs may part from the CPU's actions or
    dones (the step where each parts logged), the others' rewards and obs
    are held to the env tolerance, and the losses are compared where none
    parted."""
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
    lstm = cfg.ppo.arch == "lstm"
    if lstm:
        g = torch.Generator().manual_seed(2)
        shuffles = [torch.randperm(16, generator=g) for _ in range(5)]
    else:
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
    gpu_bank = None if bank is None else bank.to("cuda")
    cstep = ttrain.build_train_step(cfg, bank)
    gstep = ttrain.build_train_step(cfg, gpu_bank)
    if gail:
        cstep, gstep, cpu, gpu = small_gail_steps(ttrain, cfg, cpu, gpu)
    _, cstats, ctraj = cstep(cpu, draws=draws, shuffles=shuffles)
    zero_counts(k)
    _, gstats, gtraj = gstep(gpu, draws=to_device(draws, "cuda"),
                             shuffles=shuffles)
    torch.cuda.synchronize()
    counts = read_counts(k)
    want = expected_counts(cfg, bank, 1)
    assert counts == want, f"launches {counts} != {want}"
    label = {"preset": preset, "bank": bank_kind, **(env or {}), **ppo,
             **({"gail": "closed loop"} if gail else {})}
    off = ((gtraj.action.cpu() != ctraj.action)
           | (gtraj.done.cpu() != ctraj.done))
    apart = torch.nonzero(off.any(0)).flatten().tolist()
    departs = [int(off[:, e].nonzero()[0]) for e in apart]
    gaps = {key: abs(float(gstats[key]) - float(cstats[key]))
            for key in ("loss/total", "loss/value", "loss/entropy")
            + (("gail/disc_loss",) if gail else ())}
    log(f"small iteration {label}, card vs CPU: {len(apart)} of 16 envs "
        f"apart in actions or dones (at steps {departs}), "
        f"{int(ctraj.done.sum())} episodes ended, launches "
        f"{ {n: c for n, c in counts.items() if c} }, loss/total "
        f"{float(gstats['loss/total']):.6f} vs "
        f"{float(cstats['loss/total']):.6f}, loss gaps "
        + ", ".join(f"{key} {gap:.3e}" for key, gap in gaps.items()))
    assert len(apart) <= (SMALL_LSTM_APART if lstm else 0), (label, apart)
    keep = torch.ones(16, dtype=torch.bool)
    keep[apart] = False
    torch.testing.assert_close(gtraj.reward.cpu()[:, keep],
                               ctraj.reward[:, keep], rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(gtraj.obs.cpu()[:, keep], ctraj.obs[:, keep],
                               rtol=RTOL, atol=ATOL)
    if not apart:
        for key in gaps:
            assert math.isclose(float(gstats[key]), float(cstats[key]),
                                rel_tol=1e-4, abs_tol=1e-5), (
                key, gstats[key], cstats[key])


def small_gail_steps(ttrain, cfg, cpu, gpu):
    """The closed-loop GAIL steps of the CPU's and the card's loops of
    ``check_small_iteration_against_cpu``: the same discriminator, 64
    expert pairs and discriminator rows on each, the imitation weight 0.1;
    ``(cpu step, card step, cpu carry, card carry)``, each step called as
    the PPO step is."""
    import torch

    from tpu_plume_torch.train import gail_trainer as tgail

    g = torch.Generator().manual_seed(4)
    expert = (torch.randn(64, cfg.env.obs_dim, generator=g),
              torch.randint(0, cfg.env.num_actions, (64,), generator=g))
    rows = (torch.randint(0, 64, (32,), generator=g),
            torch.randint(0, cfg.rollout.num_envs * cfg.rollout.unroll_length,
                          (32,), generator=g))
    out = []
    for loop, dev in ((cpu, "cpu"), (gpu, "cuda")):
        disc, opt = tgail.make_disc_state(cfg, dev, 1)
        step = tgail.build_gail_train_step(
            cfg, *(x.to(dev) for x in expert), closed_loop=True,
            disc_batch=32)
        carry = tgail.GAILCarry(ppo=loop, disc=disc, disc_optimizer=opt)
        out.append((lambda c, draws, shuffles, step=step, dev=dev: step(
            c, 0.1, draws=draws, shuffles=shuffles,
            disc_idx=tuple(x.to(dev) for x in rows)), carry))
    return out[0][0], out[1][0], out[0][1], out[1][1]


def main_bank(gridded, cfg, seed: int = 0):
    """The bank of ``--synth-bank 3d`` for ``cfg`` on the card, [4, 8, 8,
    500, 500] at wrf_les_3d's grid, as the main path's."""
    import torch

    return gridded.synthesize_3d_bank(
        torch.Generator(device="cuda").manual_seed(seed), cfg)


def bank_step_start(rollout, cfg, bank, n: int, seed: int):
    """Fresh episodes of ``n`` envs over ``bank`` with radii of 40-300, so
    that some reach their source and reset within a chunk."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    carry = rollout.init_rollout(cfg, n, g, bank=bank)
    state = carry.env_state.replace(radius=40.0 + 260.0 * torch.rand(
        n, device="cuda", generator=g))
    return state, carry.accum, g


def bank_chunk(plume, rollout, cfg, bank, state, accum, g, steps: int,
               kernel: bool):
    """``steps`` steps from ``state`` through the bank step kernel or
    ``env_step_plain``, with logits, values and draws from ``g``: (traj,
    obs rows, state, totals)."""
    import torch

    n = state.pos.shape[0]
    draws = rollout.draw_chunk(g, cfg, steps, n)
    logits = 2.0 * torch.randn(steps, n, cfg.num_actions, device="cuda",
                               generator=g)
    values = torch.randn(steps, n, device="cuda", generator=g)
    s, acc = rollout.own_copy(state), rollout.own_copy(accum)
    traj, obs = rollout.empty_trajectory(steps, n, cfg, "cuda")
    stepper = (plume.BankStepper(s, acc, draws, traj, obs, cfg, bank)
               if kernel else None)
    for t in range(steps):
        if kernel:
            stepper(t, logits[t], values[t])
        else:
            s, _, acc = rollout.env_step_plain(logits[t], values[t], draws, t,
                                               s, acc, traj, obs, cfg, bank)
    return traj, obs, s, acc


def bank_step_apart(plume, got, want) -> dict:
    """{tensor: elements not bit-equal} over every trajectory, record,
    next-obs, state and totals tensor of two chunks; empty where all are
    equal."""
    import torch

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
    return {name: int((x != y).sum()) for name, (x, y) in pairs.items()
            if not torch.equal(x, y)}


def check_bank_step_kernel(get_preset, gridded, plume, rollout) -> dict:
    """The bank step kernel against ``env_step_plain`` on the card over
    BANK_STEP_STEPS steps of each bank main path, from BANK_STEP_SEEDS
    starts: wrf_les_3d at BANK_STEP_N envs over the main path's 3-D bank in
    3-D flight, and static_subcell (ppo_v2_0 over a [64, 500, 500] static
    bank read between cells) at MAIN_N envs in 2-D flight; each path on its
    own state with the same logits, values and draws: every trajectory,
    record, next-obs, state and totals tensor bit-equal, one launch a step,
    envs finishing and resetting.  Returns {label: {seed: finished envs}}."""
    import torch

    w3 = get_preset("wrf_les_3d").env
    st = dataclasses.replace(get_preset("ppo_v2_0").env,
                             plume_model="gridded", subcell_sampling=True)
    cases = (("wrf_les_3d", w3, lambda: main_bank(gridded, w3), BANK_STEP_N),
             ("static_subcell", st, lambda: gridded.synthesize_bank(
                 torch.Generator(device="cuda").manual_seed(0), st,
                 num_fields=64), MAIN_N))
    out = {}
    for label, cfg, make_bank, n in cases:
        bank = make_bank()
        out[label] = {}
        for seed in BANK_STEP_SEEDS:
            state, accum, g = bank_step_start(rollout, cfg, bank, n, seed)
            runs = {}
            for kernel in (True, False):
                gen = torch.Generator(device="cuda").manual_seed(seed + 1)
                before = plume.bank_step_launches
                runs[kernel] = bank_chunk(plume, rollout, cfg, bank, state,
                                          accum, gen, BANK_STEP_STEPS, kernel)
                assert plume.bank_step_launches - before == (
                    BANK_STEP_STEPS if kernel else 0)
            torch.cuda.synchronize()
            apart = bank_step_apart(plume, runs[True], runs[False])
            dones = int(runs[True][0].done.sum())
            log(f"parity bank_step {label} {list(bank.conc.shape)} N={n} "
                f"seed {seed}: {BANK_STEP_STEPS} steps, {dones} envs "
                f"finished; tensors not bit-equal: {apart or 'none'}")
            assert not apart, (label, seed, apart)
            assert dones > 0, (label, seed, "no env finished")
            out[label][seed] = dones
        del bank, runs
        torch.cuda.empty_cache()
    return out


def bank_step_bytes(plume, gather, cfg, bank, traj, t: int) -> int:
    """Bytes step ``t`` of ``traj`` over ``bank`` must move at least:
    ``env_step_bytes`` with the step's finished envs, each env's bank row
    read (and a finished env's written, with its fresh row's source read),
    and the bank cells that the post-move sample's and the fresh samples'
    corners touch, each read once."""
    import torch

    n = traj.action.shape[1]
    done = traj.done[t]
    dones = int(done.sum())
    ep = traj.episode
    src = torch.stack([ep.source_x[t], ep.source_y[t]], -1)
    rows = torch.cdist(src, bank.source).argmin(-1).to(torch.int32)
    corners = gather.sample_moved_bytes(bank, rows, traj.pos[t],
                                        ep.steps[t], cfg)
    corners -= n * (4 * cfg.pos_dim + 4 * 5)
    if dones:
        fresh = torch.arange(dones, device=rows.device, dtype=torch.int32)
        fresh = fresh % bank.conc.shape[0]
        zero = torch.zeros(dones, cfg.pos_dim, device=rows.device)
        corners += (gather.sample_moved_bytes(bank, fresh, zero, None, cfg)
                    - dones * (4 * cfg.pos_dim + 4 * 5))
    return (plume.env_step_bytes(cfg, n, dones, greedy=False)
            + 4 * n + (4 + 8) * dones + corners)


def time_bank_step_kernel(get_preset, gridded, gather, plume,
                          rollout) -> dict:
    """The bank step kernel's per-step time against ``env_step_plain``'s
    over wrf_les_3d's bank at N = 4096 and BANK_STEP_N, in alternating
    blocks (kernel, plain, plain, kernel) of BANK_STEP_STEPS steps from
    the same start, CUDA events around each block; the kernel's device
    time from the profiler; and the bound: ``bank_step_bytes`` of the
    steps' mean over the memory rate.  Returns {N: times}."""
    import torch

    cfg = get_preset("wrf_les_3d").env
    bank = main_bank(gridded, cfg)
    out = {}
    for n in (MAIN_N, BANK_STEP_N):
        state, accum, _ = bank_step_start(rollout, cfg, bank, n, seed=9)
        blocks = {True: [], False: []}
        for kernel in (True, False, False, True):
            gen = torch.Generator(device="cuda").manual_seed(10)
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            traj = bank_chunk(plume, rollout, cfg, bank, state, accum, gen,
                              BANK_STEP_STEPS, kernel)[0]
            end.record()
            torch.cuda.synchronize()
            blocks[kernel].append(start.elapsed_time(end) / BANK_STEP_STEPS)
        moved = sum(bank_step_bytes(plume, gather, cfg, bank, traj, t)
                    for t in range(BANK_STEP_STEPS)) / BANK_STEP_STEPS
        bound_ms = moved / HBM_BYTES_PER_S * 1e3
        s, acc = rollout.own_copy(state), rollout.own_copy(accum)
        draws = rollout.draw_chunk(torch.Generator(device="cuda")
                                   .manual_seed(11), cfg, 1, n)
        one, obs = rollout.empty_trajectory(1, n, cfg, "cuda")
        stepper = plume.BankStepper(s, acc, draws, one, obs, cfg, bank)
        logits, value = policy_outputs(cfg, n, torch.Generator(
            device="cuda").manual_seed(12))
        device_ms = kernel_device_ms(lambda: stepper(0, logits, value),
                                     "bank_step_kernel")
        out[n] = dict(ms_blocks=blocks[True], plain_ms_blocks=blocks[False],
                      ms=sum(blocks[True]) / 2,
                      plain_ms=sum(blocks[False]) / 2, device_ms=device_ms,
                      bound_ms=bound_ms, bytes=moved,
                      share=(None if device_ms is None
                             else bound_ms / device_ms))
        log(f"time bank_step wrf_les_3d N={n}: per step {out[n]['ms']:.5f} "
            f"ms (blocks {blocks[True]}), plain {out[n]['plain_ms']:.5f} ms "
            f"(blocks {blocks[False]}), on the device {device_ms} ms, bound "
            f"{bound_ms:.6f} ms (bytes: {moved:.0f} B a step)")
    del bank
    torch.cuda.empty_cache()
    return out


def run_main_path(ttrain, rollout_chunk, k, label, cfg, bank=None, iters=3,
                  profile=True, profile_cpu=False, guide=None,
                  profile_steps=None):
    """The full-width train step of ``cfg`` (over ``bank``, on the card),
    driven as ``train_ppo`` drives it, with every launch count set to 0
    just before ``init_loop`` and read just after the last iteration:
    ``init_loop``, a warm-up iteration, then ``iters`` timed iterations,
    each stretch's launches checked against the design's; then, with
    ``profile``, one profiled rollout chunk and one profiled iteration.
    Returns the counts (the whole run's and the timed iterations'),
    env-steps/s, phase ms, busy share (the profiled iteration's device
    time over its wall, and over the unprofiled iterations' mean wall) and
    peak device memory.  With ``guide`` the guide runs in the rollout
    (still one env-step launch per env step) and the share of overridden
    steps of the timed iterations is returned too.  With
    ``profile_steps`` the profiled chunk has that many steps and no
    iteration is profiled (the busy share is then the chunk's).  Under
    distilled PPO (``distill_oracle``) the profiled chunk runs the
    teacher too, and the last iteration's ``loss/*`` are returned."""
    import torch

    from tpu_plume_torch.evaluation.oracle import make_oracle

    n, t = cfg.rollout.num_envs, cfg.rollout.unroll_length
    zero_counts(k)
    loop = ttrain.init_loop(cfg, "cuda", bank, guide=guide)
    torch.cuda.synchronize()
    after_init = read_counts(k)
    step = ttrain.build_train_step(cfg, bank, time_phases=True, guide=guide)
    t0 = time.perf_counter()
    loop, stats, _ = step(loop)
    torch.cuda.synchronize()
    log(f"main path {label} warm-up iteration: "
        f"{time.perf_counter() - t0:.3f} s")

    phases = {"rollout": 0.0, "gae": 0.0, "update": 0.0}
    torch.cuda.reset_peak_memory_stats()
    before = read_counts(k)
    overridden = 0
    t0 = time.perf_counter()
    for _ in range(iters):
        loop, stats, traj = step(loop)
        if guide is not None:
            overridden = overridden + traj.override.sum()
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
    override_share = None
    if guide is not None:
        override_share = float(overridden) / (iters * n * t)
        log(f"main path {label}: the guide overrode {override_share:.4f} of "
            f"the timed iterations' env steps")
    busy = profiled = roll = device_ms = None
    if profile:
        oracle = (None if cfg.ppo.distill_oracle is None
                  else make_oracle(cfg.ppo.distill_oracle, cfg.env))
        roll = profile_rollout(rollout_chunk, loop, cfg, bank, guide,
                               profile_cpu, profile_steps, oracle)
        log(f"profile of one main-path rollout chunk (profiler on): "
            f"{roll['launches']} device launches, "
            f"{roll['launches_per_step']:.2f} per env step, device "
            f"{roll['device_ms']:.2f} ms of {roll['wall_ms']:.2f} ms wall")
        if profile_steps is None:
            loop, busy, profiled, device_ms = profile_iteration(
                step, loop, profile_cpu)
        else:
            busy = roll["device_ms"] / roll["wall_ms"]
    return dict(counts=counts, total_counts=total, sps=sps, model=loop.model,
                whole_ms=wall / iters * 1e3, busy=busy, device_ms=device_ms,
                busy_unprofiled=(None if device_ms is None
                                 else device_ms / (wall / iters * 1e3)),
                profiled_launches=profiled, rollout_profile=roll,
                max_memory_allocated=max_mem, override_share=override_share,
                losses={key: float(v) for key, v in stats.items()
                        if key.startswith("loss/")},
                **{key: v / iters for key, v in phases.items()})


def run_cli(cli_main, ActorCritic, preset, obs_dim, num_actions, *flags,
            then=None):
    """``train`` for two iterations at full width, its files checked (with
    ``--arch lstm`` the checkpoint's recurrent policy, and no reference
    ``.pth``); then ``then(run directory)`` before the directory goes."""
    import torch

    from tpu_plume_torch.models import RecurrentActorCritic

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
        pth = os.path.join(tmp, "model", "ppo_successful_models.pth")
        if "lstm" in flags:
            assert ckpt["config"]["ppo"]["arch"] == "lstm"
            assert not os.path.exists(pth), pth
            model = RecurrentActorCritic(
                obs_dim, num_actions,
                layer_norm_cell="--ln-lstm" in flags)
            model.load_state_dict(ckpt["model"])
        else:
            model = ActorCritic(obs_dim, num_actions, MAIN_HIDDEN)
            model.load_state_dict(torch.load(pth))
        assert all(torch.isfinite(p).all() for p in model.parameters())
        log(f"cli train --preset {preset} {' '.join(flags) or '(f32)'}: 2 "
            f"iterations, {res['episodes']} episodes in the CSV, "
            f"{res['steps_per_sec']:.1f} env-steps/s after the first; "
            "the run's policy loads")
        if then is not None:
            then(tmp)


def cli_json(cli_main, argv) -> tuple:
    """``cli_main(argv)``'s last printed line as JSON, and its wall s."""
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        cli_main(argv)
    wall = time.perf_counter() - t0
    return json.loads(out.getvalue().strip().splitlines()[-1]), wall


def eval_length(cfg) -> int:
    return min(cfg.env.max_steps, cfg.eval.max_eval_steps)


def eval_gate(ev, cfg, stop, device="cuda", lstm_ckpts=None):
    """The eval's stop gate: the heuristic, or an LSTM gate (``threshold``,
    ``peakstop``) built as ``cli eval --lstm-ckpt`` builds it, on
    ``device``, from ``lstm_ckpts[stop]``."""
    if stop in STOP_GATES:
        from tpu_plume_torch.cli.main import lstm_gate

        return lstm_gate(types.SimpleNamespace(
            stop=stop, lstm_ckpt=lstm_ckpts[stop]), cfg, device)
    return (ev.make_heuristic_gate(cfg.eval, cfg.env.conc_peak)
            if stop == "heuristic" else None)


def check_eval_metrics(m, cfg, n: int, length: int) -> None:
    """What comes out of an eval: finite values of the expected shapes,
    steps within the eval's length, success at the protocol's distance."""
    import numpy as np

    assert m.deviations.shape == m.steps.shape == (n,), m.deviations.shape
    assert np.isfinite(m.deviations).all() and np.isfinite(m.final_conc).all()
    assert m.steps.min() >= 1 and m.steps.max() <= length, m.steps
    assert (m.success == (m.deviations <= cfg.eval.success_distance)).all()
    assert m.sources.shape == (n, 2)


def rnn_of(cfg, model):
    """The eval's ``rnn=``: the recurrent policy, else None."""
    return model if cfg.ppo.arch == "lstm" else None


def run_eval(ev, k, label, cfg, model, bank=None, stop=None,
             lstm_ckpts=None) -> dict:
    """The eval at the reference protocol's width (``cfg.eval.episodes``
    episodes, each reset once, over ``min(max_steps, max_eval_steps)``
    steps) on the card: after an EVAL_WARMUP-step warm-up, the whole eval
    with every launch count set to 0 just before it and read just after
    (one field-sample launch per step plus one at the reset); then its
    first EVAL_PROFILE_STEPS steps, from the same seed, unprofiled and
    under the profiler: their device launches per eval step (the reset and
    the draws included) and their device kernel time over the unprofiled
    wall of the same steps, the device's busy share."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    gate = eval_gate(ev, cfg, stop, "cuda", lstm_ckpts)
    n, length = cfg.eval.episodes, eval_length(cfg)

    def run(seed, steps=None):
        return ev.evaluate_policy(
            model, cfg.env, cfg.eval,
            torch.Generator(device="cuda").manual_seed(seed), stop_gate=gate,
            max_steps=steps, bank=bank, device="cuda",
            rnn=rnn_of(cfg, model))

    run(1, EVAL_WARMUP)
    zero_counts(k)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    m = run(0)
    wall = time.perf_counter() - t0
    counts = read_counts(k)
    want = dict.fromkeys(KERNEL_NAMES, 0)
    want[_field_sample(cfg.env, bank)] = length + 1
    assert counts == want, (label, counts, want)
    check_eval_metrics(m, cfg, n, length)
    steps = min(EVAL_PROFILE_STEPS, length)
    t0 = time.perf_counter()
    run(0, steps)
    torch.cuda.synchronize()
    short_wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(0, steps)
        torch.cuda.synchronize()
        profiled_wall = time.perf_counter() - t0
    kernels = device_kernels(prof)
    launches = sum(e.count for e in kernels)
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    summary = ev.summarize(m)
    out = dict(summary=summary, wall_ms=wall * 1e3,
               env_steps_per_s=n * length / wall,
               active_env_steps=int(m.steps.sum()), profiled_steps=steps,
               launches_per_step=launches / steps, device_ms=device_ms,
               busy=device_ms / (short_wall * 1e3),
               profiled_wall_ms=profiled_wall * 1e3, launches=counts)
    log(f"eval {label}: {cfg.name} {n} episodes x {length} steps, stop "
        f"{stop}: wall {wall * 1e3:.1f} ms = {n * length / wall:.1f} eval "
        f"env-steps/s ({out['active_env_steps']} steps of active "
        f"episodes); its first {steps} steps profiled: {launches} device "
        f"launches = {launches / steps:.2f} per eval step, device kernels "
        f"{device_ms:.2f} ms = busy share {out['busy']:.4f} of the "
        f"unprofiled wall of those steps ({short_wall * 1e3:.1f} ms; "
        f"{device_ms / (profiled_wall * 1e3):.4f} of the profiled wall, "
        f"{profiled_wall * 1e3:.1f} ms); launches "
        f"{ {name: c for name, c in counts.items() if c} }")
    log(f"eval {label} summary: " + json.dumps(summary))
    return out


def check_eval_against_cpu(ev, label, cfg, model, bank=None, stop=None,
                           mixed_stops=False, lstm_ckpts=None) -> dict:
    """The same eval at the protocol's width on the card and on the CPU
    from the same draws, every episode's path tracked.  An episode agrees
    where its steps, stop flag and deviation (within the env tolerance)
    agree; at most one in 64 may not: a position one float ulp apart can
    land in another cell, and over 1000 steps another path follows.  For
    each such episode the step where its path departs and the largest gap
    of its path before that step are logged.  With ``mixed_stops`` the gate
    must stop some episodes early, and not all, on both."""
    import copy

    import numpy as np
    import torch

    n, length = cfg.eval.episodes, eval_length(cfg)
    draws = ev.draw_eval(torch.Generator().manual_seed(7), cfg.env, length, n)
    kw = dict(num_episodes=n, max_steps=length, bank=bank, draws=draws,
              track_trajectories=n)
    cpu_model = copy.deepcopy(model)
    want = ev.evaluate_policy(
        cpu_model, cfg.env, cfg.eval, device="cpu",
        rnn=rnn_of(cfg, cpu_model),
        stop_gate=eval_gate(ev, cfg, stop, "cpu", lstm_ckpts), **kw)
    got = ev.evaluate_policy(
        model, cfg.env, cfg.eval, device="cuda", rnn=rnn_of(cfg, model),
        stop_gate=eval_gate(ev, cfg, stop, "cuda", lstm_ckpts), **kw)
    agree = ((got.steps == want.steps)
             & (got.stopped_early == want.stopped_early)
             & np.isclose(got.deviations, want.deviations, rtol=RTOL,
                          atol=ATOL))
    apart = np.flatnonzero(~agree)
    path_gap = np.abs(got.trajectories[apart, :, :2]
                      - want.trajectories[apart, :, :2]).max(-1)
    off = ~np.isclose(got.trajectories[apart, :, :2],
                      want.trajectories[apart, :, :2], rtol=RTOL, atol=ATOL,
                      equal_nan=True).all(-1)
    departs = np.where(off.any(-1), off.argmax(-1), -1)
    before = max((float(np.nanmax(g[:t])) for g, t in zip(path_gap, departs)
                  if t > 0), default=0.0)
    stopped = (int(want.stopped_early.sum()), int(got.stopped_early.sum()))
    log(f"eval {label} card vs CPU, {n} episodes x {length} steps, stop "
        f"{stop}: {len(apart)} of {n} episodes apart ("
        f"{int((got.steps != want.steps).sum())} in steps, "
        f"{int((got.stopped_early != want.stopped_early).sum())} in the "
        f"stop flag); their paths depart at steps {departs.tolist()}, the "
        f"largest gap of a path before its departure {before:.3e}; "
        f"{int((want.steps < length).sum())} episodes ended, stopped early "
        f"{stopped[0]} on the CPU and {stopped[1]} on the card")
    assert len(apart) <= n // 64, (label, apart)
    if mixed_stops:
        assert all(0 < s < n for s in stopped), (label, stopped)
    return dict(apart=len(apart), departs=departs.tolist(),
                gap_before_departure=before, stopped_early=stopped[1])


def check_eval_cli(cli_main, tmp) -> dict:
    """``eval --pth`` and ``eval --ckpt`` of the ``train`` run in ``tmp``
    at the full protocol with the heuristic stop (the same summary, the
    reference's files), and ``expert --episodes 100``."""
    import numpy as np

    pth = os.path.join(tmp, "model", "ppo_successful_models.pth")
    out = os.path.join(tmp, "eval")
    by_pth, pth_s = cli_json(cli_main, ["eval", "--pth", pth, "--stop",
                                        "heuristic", "--out", out])
    metrics = np.load(os.path.join(out, "validation_metrics.npz"))
    assert sorted(metrics.files) == ["deviations", "steps", "stopped_early",
                                     "success"], metrics.files
    assert all(metrics[f].shape == (1000,) for f in metrics.files)
    with open(os.path.join(out, "evaluation_results.csv")) as fh:
        rows = fh.read().strip().splitlines()
    assert rows[0] == "episode,steps,deviation,success,final_conc"
    assert len(rows) == 1001, len(rows)
    by_ckpt, ckpt_s = cli_json(cli_main, [
        "eval", "--ckpt", os.path.join(tmp, "checkpoint.pt"), "--stop",
        "heuristic"])
    assert by_ckpt == by_pth, (by_ckpt, by_pth)
    path = os.path.join(tmp, "expert_data.npz")
    res, expert_s = cli_json(cli_main, ["expert", "--episodes", "100",
                                        "--ckpt", tmp, "--out", path])
    data = np.load(path)
    assert sorted(data.files) == ["actions", "states"], data.files
    m = res["samples"]
    assert data["states"].shape == (m, MAIN_D) and data["actions"].shape == (m,)
    assert data["states"].dtype == np.float32
    assert data["actions"].dtype == np.int64
    assert 0 < m <= 100 * 1000 and np.isfinite(data["states"]).all()
    log(f"cli eval --pth ... --stop heuristic: {pth_s:.2f} s, "
        f"{json.dumps(by_pth)}; cli eval --ckpt: {ckpt_s:.2f} s, the same "
        f"summary; cli expert --episodes 100: {expert_s:.2f} s, {m} "
        f"(state, action) rows")
    return dict(summary=by_pth, expert_samples=m)


def check_lstm_eval_cli(cli_main, tmp) -> dict:
    """``eval --arch lstm --ckpt`` of the recurrent ``train`` run in ``tmp``
    at the full protocol with the heuristic stop (the reference's files),
    and ``expert --arch lstm --ckpt --episodes 100``."""
    import numpy as np

    out = os.path.join(tmp, "eval")
    summary, eval_s = cli_json(cli_main, [
        "eval", "--arch", "lstm", "--ckpt", tmp, "--stop", "heuristic",
        "--out", out])
    metrics = np.load(os.path.join(out, "validation_metrics.npz"))
    assert all(metrics[f].shape == (1000,) for f in metrics.files)
    assert np.isfinite(metrics["deviations"]).all()
    with open(os.path.join(out, "evaluation_results.csv")) as fh:
        assert len(fh.read().strip().splitlines()) == 1001
    path = os.path.join(tmp, "expert_data.npz")
    res, expert_s = cli_json(cli_main, [
        "expert", "--arch", "lstm", "--episodes", "100", "--ckpt", tmp,
        "--out", path])
    data = np.load(path)
    m = res["samples"]
    assert data["states"].shape == (m, MAIN_D) and data["actions"].shape == (m,)
    assert 0 < m <= 100 * 1000 and np.isfinite(data["states"]).all()
    log(f"cli eval --arch lstm --ckpt ... --stop heuristic: {eval_s:.2f} s, "
        f"{json.dumps(summary)}; cli expert --arch lstm --episodes 100: "
        f"{expert_s:.2f} s, {m} (state, action) rows")
    return dict(summary=summary, eval_s=eval_s, expert_s=expert_s,
                expert_samples=m)


def step_chain(model, carry, obs_seq, resets):
    """The replay as a chain of ``step`` calls: what ``sequence`` computes,
    with the encoder, the input-side product and the heads run per step."""
    import torch

    logits, values = [], []
    for t in range(obs_seq.shape[0]):
        carry = tuple(torch.where(resets[t][:, None], 0.0, x) for x in carry)
        carry, lt, vt = model.step(carry, obs_seq[t])
        logits.append(lt)
        values.append(vt)
    return carry, torch.stack(logits), torch.stack(values)


def time_bptt_replay(ttrain, ppo, cfg) -> dict:
    """One minibatch step's loss, forward and backward, of the recurrent
    update at full width (LSTM_MB_ENVS env sequences of the unroll length,
    episode ends at LSTM_RESET_RATE) through ``sequence``, which runs the
    encoder, the input-side product and the heads once over all rows, and
    through a chain of ``step`` calls: the same loss and gradients (rtol
    1e-5, atol 1e-6 x max|grad|), each one's ms by CUDA events and its
    device launches from the profiler."""
    import copy

    import torch
    from torch.profiler import ProfilerActivity, profile

    model, _ = ttrain.make_train_state(cfg, "cuda", cfg.seed)
    t, n = cfg.rollout.unroll_length, LSTM_MB_ENVS
    g = torch.Generator(device="cuda").manual_seed(5)
    batch = ppo.RecurrentPPOBatch(
        obs=torch.randn(t, n, MAIN_D, device="cuda", generator=g),
        actions=torch.randint(0, MAIN_A, (t, n), device="cuda", generator=g),
        old_log_probs=-1.6 + 0.1 * torch.randn(t, n, device="cuda",
                                               generator=g),
        advantages=torch.randn(t, n, device="cuda", generator=g),
        returns=torch.randn(t, n, device="cuda", generator=g),
        old_values=torch.randn(t, n, device="cuda", generator=g),
        resets=torch.rand(t, n, device="cuda", generator=g) < LSTM_RESET_RATE,
        h_init=tuple(0.1 * torch.randn(n, cfg.ppo.lstm_hidden, device="cuda",
                                       generator=g) for _ in range(2)))
    chain = copy.copy(model)
    chain.sequence = lambda *a: step_chain(model, *a)
    out = {}
    for label, m in (("sequence", model), ("step_chain", chain)):
        def fn():
            model.zero_grad(set_to_none=True)
            loss, _ = ppo.ppo_loss_recurrent(m, batch, cfg.ppo)
            loss.backward()
            return loss

        loss = fn()
        grads = [p.grad.clone() for p in model.parameters()]
        ms = cuda_ms(fn, 5)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        launches = sum(e.count for e in device_kernels(prof))
        out[label] = dict(ms=ms, launches=launches,
                          loss=float(loss.detach()),
                          grads=grads)
    for a, b in zip(out["sequence"].pop("grads"),
                    out["step_chain"].pop("grads")):
        torch.testing.assert_close(a, b, rtol=1e-5,
                                   atol=1e-6 * float(b.abs().max()))
    assert math.isclose(out["sequence"]["loss"], out["step_chain"]["loss"],
                        rel_tol=1e-5), out
    log(f"recurrent update, one minibatch step's loss forward and backward "
        f"({n} envs x {t} steps, {int(batch.resets.sum())} resets): through "
        f"sequence {out['sequence']['ms']:.2f} ms in "
        f"{out['sequence']['launches']} launches, through a chain of step "
        f"calls {out['step_chain']['ms']:.2f} ms in "
        f"{out['step_chain']['launches']} launches; the same loss and "
        f"gradients")
    return out


def lstm_chunk(recurrent, n: int, t: int, h: int, seed: int):
    """A plain LSTM cell on the card, xi [T, N, 4H], resets [T, N] at
    LSTM_RESET_RATE with step 0 and the last step among them, and a
    nonzero initial carry, from ``seed``."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    cell = recurrent.LSTMCell(h, h)
    cell.reset_parameters(torch.Generator().manual_seed(seed))
    cell = cell.cuda()
    with torch.no_grad():
        cell.hh.bias.normal_(0.0, 0.5, generator=g)
    xi = torch.randn(t, n, 4 * h, device="cuda", generator=g)
    resets = torch.rand(t, n, device="cuda", generator=g) < LSTM_RESET_RATE
    resets[0, : n // 3] = True
    resets[-1, n // 2:] = True
    carry = tuple(0.5 * torch.randn(n, h, device="cuda", generator=g)
                  for _ in range(2))
    return cell, xi, resets, carry


def lstm_grads(fn, cell, carry, xi, resets, seed: int) -> tuple:
    """(outputs, gradients) of ``fn(cell, carry, xi, resets)``: hs and the
    last carry, and the gradients of a random linear function of them with
    respect to xi, the initial carry, W_hh and b."""
    import torch

    xi = xi.clone().requires_grad_(True)
    carry = tuple(x.clone().requires_grad_(True) for x in carry)
    cell.zero_grad(set_to_none=True)
    hs, (c, h) = fn(cell, carry, xi, resets)
    g = torch.Generator(device="cuda").manual_seed(seed)
    loss = sum((x * torch.randn(x.shape, device="cuda", generator=g)).sum()
               for x in (hs, c, h))
    loss.backward()
    torch.cuda.synchronize()
    return ({"hs": hs.detach(), "c": c.detach(), "h": h.detach()},
            {"xi": xi.grad, "c0": carry[0].grad, "h0": carry[1].grad,
             "weight": cell.hh.weight.grad, "bias": cell.hh.bias.grad})


def check_lstm_kernels(lstm_ops, recurrent) -> dict:
    """``ops.lstm.lstm_sequence`` on the card at each of LSTM_CHECKS against
    autodiff through the eager loop (``models.recurrent.cell_loop``) and
    against its plain version on the card: T launches of each kernel a
    call; the forward's elements that differ from the loop's (the kernel
    repeats its ops and roundings, so none should) and its largest gap,
    held to the forward's parity tolerance (rtol 1e-5, atol 1e-6); each
    gradient's largest gap over its largest element, held to 2e-5 (the
    fused PPO kernels' tolerance)."""
    import torch

    loop = lambda *a: recurrent.cell_loop(*a, torch.float32)
    out = {}
    for n, t, h in LSTM_CHECKS:
        cell, xi, resets, carry = lstm_chunk(recurrent, n, t, h, seed=n + t)
        before = lstm_ops.fwd_launches, lstm_ops.bwd_launches
        got, got_grads = lstm_grads(lstm_ops.lstm_sequence, cell, carry, xi,
                                    resets, 1)
        launches = (lstm_ops.fwd_launches - before[0],
                    lstm_ops.bwd_launches - before[1])
        assert launches == (t, t), launches
        row = {"resets": int(resets.sum())}
        for label, fn in (("loop", loop),
                          ("plain", lstm_ops.lstm_sequence_plain)):
            want, want_grads = lstm_grads(fn, cell, carry, xi, resets, 1)
            for key, w in want.items():
                torch.testing.assert_close(got[key], w, rtol=1e-5,
                                           atol=1e-6, msg=f"{label} {key}")
            rel = {}
            for key, w in want_grads.items():
                rel[key] = float((got_grads[key] - w).abs().max()
                                 / w.abs().max())
                assert rel[key] <= 2e-5, (n, label, key, rel[key])
            row[label] = {
                "forward_unequal": {key: int((got[key] != w).sum())
                                    for key, w in want.items()},
                "forward_max_abs": max(float((got[key] - w).abs().max())
                                       for key, w in want.items()),
                "grad_rel": rel}
        out[f"{n}x{t}x{h}"] = row
        log(f"lstm kernels N={n} T={t} H={h} ({row['resets']} resets): "
            f"{launches[0]} + {launches[1]} launches; against the loop "
            f"forward unequal {row['loop']['forward_unequal']} (max "
            f"{row['loop']['forward_max_abs']:.3g}), grads / max "
            + ", ".join(f"{k} {v:.3g}" for k, v in row["loop"]["grad_rel"]
                        .items())
            + f"; against the plain version forward unequal "
            f"{row['plain']['forward_unequal']}")
    return out


def lstm_step_bytes(n: int, h: int) -> dict:
    """Device bytes of one step of each kernel at N rows and H units, each
    input read once and each output written once: the forward reads z, xi
    (4H each), c_prev (H) and two reset bytes and writes the four gates,
    c, h and the next step's masked h (7H); the backward reads dh_out,
    dh_rec, the four gates, c, c_prev, dc (9H) and two reset bytes and
    writes dz (4H) and dc (H)."""
    return {"fwd": n * (16 * h * 4 + 2), "bwd": n * (14 * h * 4 + 2)}


def time_lstm_kernels(lstm_ops, recurrent) -> dict:
    """At LSTM_CHECKS[0]: each kernel's per-call time (CUDA events over
    back-to-back launches walking the middle steps) and device time
    (profiler) beside its byte bound at HBM_BYTES_PER_S and its plain
    version's step; and one minibatch's recurrence, forward and backward,
    through the kernels, through the eager loop and through the plain
    version: ms and device launches."""
    import itertools
    import types

    import torch
    from torch.profiler import ProfilerActivity, profile

    n, t, h = LSTM_CHECKS[0]
    cell, xi, resets, carry = lstm_chunk(recurrent, n, t, h, seed=7)
    g = torch.Generator(device="cuda").manual_seed(8)
    rand = lambda *shape: torch.rand(shape, device="cuda", generator=g)
    b = types.SimpleNamespace(
        steps=t, n=n, h=h, xi=xi, resets=resets, c0=carry[0],
        z=torch.randn(n, 4 * h, device="cuda", generator=g),
        h_in=rand(t, n, h), cs=rand(t, n, h), hs=rand(t, n, h),
        act=rand(t, n, 4 * h), dhs=rand(t, n, h), rec=rand(n, h),
        dc=rand(n, h), dz=rand(t, n, 4 * h),
        stream=torch.cuda.current_stream().cuda_stream, vec=4)
    steps = itertools.cycle(range(1, t - 1))
    bytes_ = lstm_step_bytes(n, h)
    out = {"shape": [n, t, h], "bytes": bytes_}
    for i, kind in enumerate(("fwd", "bwd")):
        # each call the next middle step, as a replay walks them: its
        # slices of xi, hs, the gates and c come from device memory, the
        # product's output and the carry from L2
        kernel = lambda: lstm_ops._CUDA[i](next(steps), b)
        plain = lambda: lstm_ops._PLAIN[i](next(steps), b)
        bound_ms = bytes_[kind] / HBM_BYTES_PER_S * 1e3
        device_ms = kernel_device_ms(kernel, f"lstm_step_{kind}_kernel",
                                     reps=200)
        out[kind] = dict(ms=cuda_ms(kernel, 200), device_ms=device_ms,
                         plain_ms=cuda_ms(plain, 50), bound_ms=bound_ms,
                         bound_share=(bound_ms / device_ms if device_ms
                                      else None))
        log(f"time lstm_step_{kind}_kernel N={n} H={h}: per call "
            f"{out[kind]['ms']:.5f} ms, device {device_ms} ms, bound "
            f"{bound_ms:.5f} ms ({bytes_[kind]} B), plain "
            f"{out[kind]['plain_ms']:.5f} ms")
    loop = lambda *a: recurrent.cell_loop(*a, torch.float32)
    chunk = {}
    for label, fn in (("kernels", lstm_ops.lstm_sequence), ("loop", loop),
                      ("plain", lstm_ops.lstm_sequence_plain)):
        def once(fn=fn):
            return lstm_grads(fn, cell, carry, xi, resets, 1)

        ms = cuda_ms(once, 3)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            once()
        chunk[label] = dict(ms=ms, launches=sum(
            e.count for e in device_kernels(prof)))
    out["chunk"] = chunk
    log(f"lstm recurrence of one minibatch, forward and backward ({n} x "
        f"{t}, H {h}; with the loss's draws): " + ", ".join(
            f"{label} {r['ms']:.3f} ms in {r['launches']} launches"
            for label, r in chunk.items()))
    return out


def learning_check(ttrain, ev, k, cfg, out_dir) -> dict:
    """ppo_v2_0 f32 at full width trained for LEARN_ITERS iterations into
    ``out_dir`` with the trajectory capture on (``data.csv``, and
    ``training_data.nc`` where h5py is installed), every launch count set
    to 0 just before ``train_ppo`` and read just after (one plume sample in
    ``init_loop``, then one env-step launch per env step: the capture adds
    none); its steady env-steps/s beside NO_CAPTURE_ITERS iterations of the
    same run without the capture; then the protocol's eval (heuristic stop)
    of the result and of the untrained initial params over the same draws:
    a printed record, not a gate.  Returns the record, the run's
    ``TrainResult`` (its captured episodes in ``trajectories``) and the
    trained policy on the card."""
    import importlib.util

    import torch

    # A fixed count of iterations: more episodes than 20 iterations end,
    # and rows enough for the NetCDF capture's episode axis.
    cfg = cfg.replace(total_episodes=LEARN_EPISODE_CAP)
    netcdf = importlib.util.find_spec("h5py") is not None
    zero_counts(k)
    t0 = time.perf_counter()
    res = ttrain.train_ppo(cfg, out_dir, device="cuda",
                           max_iterations=LEARN_ITERS, write_csv=False,
                           verbose=False, capture_conc_csv=True,
                           capture_netcdf=netcdf)
    train_s = time.perf_counter() - t0
    counts = read_counts(k)
    want = dict.fromkeys(KERNEL_NAMES, 0)
    want.update(plume_sample=1,
                env_step=LEARN_ITERS * cfg.rollout.unroll_length)
    assert counts == want, (counts, want)
    captured = len(res.trajectories)
    with open(os.path.join(out_dir, "data.csv")) as fh:
        csv_rows = sum(1 for _ in fh)
    assert 0 < captured <= res.successes and csv_rows == res.successes, (
        captured, csv_rows, res.successes)
    with tempfile.TemporaryDirectory() as tmp:
        plain = ttrain.train_ppo(cfg, tmp, device="cuda",
                                 max_iterations=NO_CAPTURE_ITERS,
                                 write_csv=False, verbose=False)
    trained = ttrain.make_policy_model(cfg)
    trained.load_state_dict(res.state_dict)
    trained = trained.to("cuda")
    initial, _ = ttrain.make_train_state(cfg, "cuda", cfg.seed)
    n, length = cfg.eval.episodes, eval_length(cfg)
    draws = ev.draw_eval(torch.Generator(device="cuda").manual_seed(3),
                         cfg.env, length, n)
    gate = eval_gate(ev, cfg, "heuristic")
    out = dict(iterations=LEARN_ITERS, train_s=train_s,
               episodes=res.episodes, successes=res.successes,
               radius=float(res.curriculum.radius),
               capture=dict(netcdf=netcdf, conc_csv=True,
                            captured_episodes=captured, csv_rows=csv_rows,
                            env_step_launches_per_iteration=(
                                counts["env_step"] / LEARN_ITERS),
                            launches=counts,
                            sps=res.steps_per_sec,
                            sps_without=plain.steps_per_sec,
                            iteration_ms=per_iter_ms(cfg, res),
                            iteration_ms_without=per_iter_ms(cfg, plain)))
    for label, model in (("untrained", initial), ("trained", trained)):
        m = ev.evaluate_policy(model, cfg.env, cfg.eval, draws=draws,
                               stop_gate=gate)
        check_eval_metrics(m, cfg, n, length)
        out[label] = ev.summarize(m)
    cap = out["capture"]
    log(f"capture: train_ppo with capture_conc_csv and "
        f"{'capture_netcdf' if netcdf else 'no capture_netcdf (no h5py)'}: "
        f"{captured} episodes captured for training_data.nc's selection "
        f"(successes at the two smallest radii), {csv_rows} rows in "
        f"data.csv; {cap['env_step_launches_per_iteration']:.1f} env-step "
        f"launches per iteration, launches {counts}; steady "
        f"{cap['sps']:.1f} env-steps/s = {cap['iteration_ms']:.2f} ms per "
        f"iteration with the capture, {cap['sps_without']:.1f} = "
        f"{cap['iteration_ms_without']:.2f} ms without it "
        f"({NO_CAPTURE_ITERS} iterations)")
    log(f"learning check: ppo_v2_0 f32, {LEARN_ITERS} iterations of "
        f"{cfg.rollout.num_envs} envs x {cfg.rollout.unroll_length} steps in "
        f"{train_s:.1f} s, {res.episodes} training episodes, "
        f"{res.successes} successes, curriculum radius {out['radius']:.2f}; "
        f"the protocol's eval ({n} episodes x {length} steps, heuristic "
        f"stop, the same draws): untrained success@40 "
        f"{out['untrained']['success_rate']:.3f}, mean deviation "
        f"{out['untrained']['mean_deviation']:.2f}, mean steps "
        f"{out['untrained']['mean_steps']:.1f}; trained success@40 "
        f"{out['trained']['success_rate']:.3f}, mean deviation "
        f"{out['trained']['mean_deviation']:.2f}, mean steps "
        f"{out['trained']['mean_steps']:.1f}")
    return out, res, trained


def per_iter_ms(cfg, res) -> float:
    return cfg.rollout.num_envs * cfg.rollout.unroll_length / res.steps_per_sec * 1e3


def profile_epoch(lt, model, opt, lr, loss_fn, tensors, batch) -> dict:
    """One epoch of ``lstm_trainer._run_epoch`` on the card: its ms (CUDA
    events), its minibatch steps, and its device launches per minibatch
    step from the profiler."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    idx = lt._shuffle_batches(np.random.default_rng(0), len(tensors[0]),
                              min(batch, len(tensors[0])))
    lt._run_epoch(model, opt, lr, idx, loss_fn, *tensors)   # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss = float(lt._run_epoch(model, opt, lr, idx, loss_fn, *tensors))
    epoch_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        lt._run_epoch(model, opt, lr, idx, loss_fn, *tensors)
        torch.cuda.synchronize()
    launches = sum(e.count for e in device_kernels(prof))
    return dict(epoch_ms=epoch_ms, steps=len(idx),
                step_ms=epoch_ms / len(idx),
                launches_per_step=launches / len(idx), loss=loss)


def check_trainer_against_cpu(label, train, epochs) -> dict:
    """``train(device, epochs)`` (a trainer from the same init and batches)
    on the card and on the CPU: each epoch's loss within TRAINER_RTOL.
    Returns the card run's wall s per epoch."""
    import numpy as np

    t0 = time.perf_counter()
    got = train("cuda", epochs)
    card_s = time.perf_counter() - t0
    want = train("cpu", epochs)
    gap = float(np.max(np.abs(np.subtract(got.losses, want.losses))
                       / np.abs(want.losses)))
    log(f"{label} card vs CPU, {epochs} epochs from the same init and "
        f"batches: losses {got.losses} / {want.losses}, largest relative "
        f"gap {gap:.3e}; card {card_s:.2f} s")
    np.testing.assert_allclose(got.losses, want.losses, rtol=TRAINER_RTOL)
    return dict(losses=got.losses, cpu_losses=want.losses, rel_gap=gap,
                epoch_s=card_s / epochs)


def stop_lstm_phase(ev, k, cfg, trained, res, tmp) -> tuple:
    """The stop LSTMs on the card from the capture of ``learning_check``:
    each trainer held to the CPU, one epoch of each profiled, each trained
    at the JAX package's epochs (cut to TRAINER_BUDGET_S), then eval A
    with ``trained`` and each gate (``run_eval``, and on the card against
    the CPU).  Returns the record and the checkpoints by gate."""
    import numpy as np
    import torch

    from tpu_plume_torch.data import datasets
    from tpu_plume_torch.models import lstm_zoo
    from tpu_plume_torch.train import lstm_trainer as lt

    arrays = res.trajectories.arrays()
    seqs, src = datasets.raw_sequences(arrays)
    segs = datasets.trajectory_segments(arrays, window_size=20)
    log(f"stop LSTM data: {len(seqs)} captured sequences "
        f"({sum(len(q) >= 10 for q in seqs)} of at least 10 steps), "
        f"{len(segs)} 20-step segments")
    out = dict(sequences=len(seqs), segments=len(segs))

    # Card against CPU: the threshold net with its dropout off.
    make = lt.ConcentrationThresholdPredictor
    lt.ConcentrationThresholdPredictor = lambda: make(dropout=0.0,
                                                      head_dropout=0.0)
    try:
        out["threshold_check"] = check_trainer_against_cpu(
            "train_threshold_lstm (dropout off)",
            lambda device, epochs: lt.train_threshold_lstm(
                seqs, src, os.path.join(tmp, f"thr_{device}"),
                epochs=epochs, device=device),
            TRAINER_CHECK_EPOCHS)
    finally:
        lt.ConcentrationThresholdPredictor = make
    out["peak_stop_check"] = check_trainer_against_cpu(
        "train_peak_stop_lstm",
        lambda device, epochs: lt.train_peak_stop_lstm(
            segs, os.path.join(tmp, f"ps_{device}"), epochs=epochs,
            device=device),
        TRAINER_CHECK_EPOCHS)

    # One epoch of each profiled, on the trainers' own data and optimizer.
    feats, targs = datasets.tail_window_dataset(
        [q for q in seqs if len(q) >= 10],
        np.array([c for q, c in zip(seqs, src) if len(q) >= 10]), 10)
    scaler = lt.MinMaxScaler().fit(feats.reshape(-1, 1))
    feats = scaler.transform(feats.reshape(-1, 1)).reshape(
        feats.shape).astype(np.float32)
    model = lstm_zoo.ConcentrationThresholdPredictor().reset_parameters(
        torch.Generator().manual_seed(0)).cuda()
    opt = lt.ClippedAdamW(model.parameters(), 1e-2, 1.0)
    gen = torch.Generator(device="cuda").manual_seed(0)
    thr_prof = profile_epoch(
        lt, model, opt, 3e-4,
        lambda x, y: lt.smooth_l1(model(x, generator=gen), y, 2.0),
        [torch.from_numpy(a).cuda() for a in (feats, targs)], 64)
    pfeats, plabels = datasets.peak_stop_dataset(
        segs, window_size=20, rng=np.random.default_rng(0))
    model = lstm_zoo.PeakAndStopPredictor().reset_parameters(
        torch.Generator().manual_seed(0)).cuda()
    opt = lt.ClippedAdamW(model.parameters(), 1e-4, 1.0)

    def ps_loss(x, y):
        peak, stop = model(x)
        return ((peak - y[:, 0]) ** 2).mean() + lt.bce(stop, y[:, 1])

    ps_prof = profile_epoch(
        lt, model, opt, 1e-3, ps_loss,
        [torch.from_numpy(a).cuda() for a in (pfeats, plabels)], 64)

    # The reference trainers at the JAX package's epochs, cut to the budget.
    ckpts = {}
    for gate, name, full, prof, train in (
            ("threshold", "train_threshold_lstm", THRESHOLD_EPOCHS, thr_prof,
             lambda epochs: lt.train_threshold_lstm(
                 seqs, src, os.path.join(tmp, "threshold"), epochs=epochs,
                 device="cuda")),
            ("peakstop", "train_peak_stop_lstm", PEAK_STOP_EPOCHS, ps_prof,
             lambda epochs: lt.train_peak_stop_lstm(
                 segs, os.path.join(tmp, "peakstop"), epochs=epochs,
                 device="cuda"))):
        # the profiled epoch's ms, with a margin for the trainer's own
        # per-epoch work and the host's drift between phases
        epoch_ms = EPOCH_MARGIN * prof["epoch_ms"]
        epochs = max(1, min(full, int(TRAINER_BUDGET_S * 1e3 / epoch_ms)))
        t0 = time.perf_counter()
        r = train(epochs)
        wall = time.perf_counter() - t0
        final = dict(epochs=epochs, jax_epochs=full, wall_s=wall,
                     epoch_ms=wall * 1e3 / epochs, final_loss=r.losses[-1],
                     **{key: v for key, v in r.extra.items()
                        if isinstance(v, float)}, profile=prof)
        assert np.isfinite(r.losses).all(), r.losses
        out[gate] = final
        log(f"{name} on the card: {epochs} epochs (JAX's {full}"
            f"{'' if epochs == full else ', cut to the budget'}) in "
            f"{wall:.2f} s = {final['epoch_ms']:.2f} ms per epoch; one "
            f"profiled epoch {prof['epoch_ms']:.2f} ms, {prof['steps']} "
            f"minibatch steps of {prof['step_ms']:.3f} ms, "
            f"{prof['launches_per_step']:.1f} launches per step; final loss "
            f"{r.losses[-1]:.5f}, "
            + ", ".join(f"{key} {v:.4f}" for key, v in r.extra.items()
                        if isinstance(v, float)))
        ckpts[gate] = os.path.join(r.out_dir, (
            "lstm_threshold_predictor.pt" if gate == "threshold"
            else "best_peak_and_stop.pt"))

    # Eval A with each gate, and on the card against the CPU.
    for gate in STOP_GATES:
        e = run_eval(ev, k, f"A {gate}", cfg, trained, stop=gate,
                     lstm_ckpts=ckpts)
        e["card_vs_cpu"] = check_eval_against_cpu(
            ev, f"ppo_v2_0 {gate} gate", cfg, trained, stop=gate,
            lstm_ckpts=ckpts)
        out[f"eval_{gate}"] = e
    return out, ckpts


def check_stop_cli(cli_main, learn_dir, ckpts, tmp) -> dict:
    """``train-lstm --variant v12`` on the capture's ``data.csv`` and ``eval
    --stop threshold`` / ``--stop peakstop --lstm-ckpt`` on the trainers'
    checkpoints with the learning check's policy, each one's JSON line
    checked."""
    import numpy as np

    out_dir = os.path.join(tmp, "v12")
    v12, v12_s = cli_json(cli_main, [
        "train-lstm", "--variant", "v12", "--nc",
        os.path.join(learn_dir, "data.csv"), "--epochs", "2", "--out",
        out_dir])
    assert sorted(v12) == ["final_loss", "test_r2"], v12
    assert np.isfinite(v12["final_loss"]), v12
    assert os.path.isfile(os.path.join(out_dir, "lstm_v12.pt"))
    out = dict(v12=v12, v12_s=v12_s)
    for gate in STOP_GATES:
        summary, wall = cli_json(cli_main, [
            "eval", "--ckpt", learn_dir, "--stop", gate, "--lstm-ckpt",
            ckpts[gate]])
        assert {"success_rate", "early_stop_rate", "mean_steps"} <= set(
            summary), summary
        assert 0.0 <= summary["early_stop_rate"] <= 1.0, summary
        out[gate] = dict(summary=summary, wall_s=wall)
        log(f"cli eval --stop {gate} --lstm-ckpt {os.path.basename(ckpts[gate])}"
            f": {wall:.2f} s, {json.dumps(summary)}")
    log(f"cli train-lstm --variant v12 --nc data.csv --epochs 2: "
        f"{v12_s:.2f} s, {json.dumps(v12)}")
    return out


# --- the model-fit guide (slice 9a) ------------------------------------------

# The env-step kernel's executed-action mode: the cases it is held to
# env_step_plain in, and the share of envs a guide overrides each step.
EXEC_CASES = ("v1_1", "v1_0", "obs_memory", "wrf_les")
EXEC_SHARE = 1.0 / 3.0
# The guided evals: the steps of the eval profiled for its launches and
# device time, and the CPU's episodes in the card-vs-CPU checks (the CPU
# runs the first episodes of the card's draws; it fits every episode at
# every step).
GUIDE_PROFILE_STEPS = 16
GUIDE_CPU_EPISODES = {"ppo_v2_0": 256, "wrf_les": 8}
# The guided training paths: timed iterations, and the steps of the
# rollout chunk profiled for its launches per env step (the guide's
# launches are the same at every step).
GUIDED_ITERS = {"ppo_v2_0": 3, "wrf_les": 1}
GUIDED_PROFILE_STEPS = 8
# The anisotropic fit alone on the card against the CPU: one buffer per
# eval episode, and the tolerances of the port's flights against JAX's
# (tests/test_torch_aniso_fit.py): where both validate, the estimate in
# px and the wind angle in rad; se relative, also the band around
# ``max_se`` where a gate may decide the other way.
FIT_EPISODES = 1000
FIT_EST_ATOL, FIT_THETA_ATOL, FIT_GATE_RTOL = 0.25, 1e-2, 1e-2


def exec_actions(logits, gumbel, g):
    """The policy's sampled actions argmax(logits + Gumbel row) in PyTorch,
    as a guide sees them, and executed actions: EXEC_SHARE of the envs
    moved to another action."""
    import torch

    sampled = torch.argmax(logits + gumbel, dim=-1)
    a = logits.shape[-1]
    other = (sampled + torch.randint(1, a, sampled.shape, device="cuda",
                                     generator=g)) % a
    swap = torch.rand(sampled.shape, device="cuda", generator=g) < EXEC_SHARE
    return sampled, torch.where(swap, other, sampled)


def check_env_step_exec(get_preset, plume, rollout) -> dict:
    """The env-step kernel with an executed action (a guided rollout's
    launch) against ``env_step_plain(exec_action=)`` on the card over
    ENV_STEPS steps of each of EXEC_CASES at N = 4096 and ENV_ODD_N,
    teacher-forced as ``check_env_step_kernel`` is, a third of the envs
    overridden each step: integers, bools and positions bit-equal (the
    override rows too), floats within RTOL/ATOL, and the sampled action
    the kernel records bit-equal to the PyTorch argmax the guide saw.
    Returns the worst absolute float error and the overridden share."""
    import torch

    worst, overridden, total = 0.0, 0, 0
    for case in EXEC_CASES:
        cfg = env_cfg(get_preset, case)
        for n in (MAIN_N, ENV_ODD_N):
            state, accum, g = env_start(rollout, cfg, n, seed=n + 3 * len(case))
            moved = dones = 0
            err = 0.0
            for _ in range(ENV_STEPS):
                logits, value = policy_outputs(cfg, n, g)
                draws = rollout.draw_chunk(g, cfg, 1, n)
                sampled, executed = exec_actions(logits, draws.gumbel[0], g)
                traj, obs = rollout.empty_trajectory(1, n, cfg, "cuda",
                                                     guided=True)
                k_state = rollout.own_copy(state)
                k_acc = rollout.own_copy(accum)
                plume.EnvStepper(k_state, k_acc, draws, traj, obs, cfg)(
                    0, logits, value, executed)
                want = rollout.empty_trajectory(1, n, cfg, "cuda",
                                                guided=True)
                state, _, accum = rollout.env_step_plain(
                    logits, value, draws, 0, state, accum, *want, cfg,
                    exec_action=executed)
                torch.cuda.synchronize()
                m, e, _ = compare_env_step(plume, cfg,
                                           (traj, obs, k_state, k_acc),
                                           want, state, accum)
                assert torch.equal(traj.action[0], sampled), case
                assert torch.equal(traj.override, want[0].override), case
                assert torch.equal(traj.override[0], executed != sampled)
                assert torch.equal(k_state.prev_action, executed.where(
                    ~traj.done[0], torch.zeros_like(executed))), case
                moved += m
                err = max(err, e)
                dones += int(traj.done.sum())
                overridden += int(traj.override.sum())
                total += n
            log(f"parity env_step exec_action {case} N={n}: {ENV_STEPS} "
                f"steps teacher-forced, {dones} envs finished; the recorded "
                f"action equals the PyTorch argmax the guide saw; override "
                f"rows, actions, dones, t, visit grids, prev_action (the "
                f"executed action), seeds and cells equal; pos mismatches "
                f"{moved}; max_abs_err {err:.3e}")
            assert moved == 0, (case, n, "pos mismatches", moved)
            assert dones > 0, (case, n, "no env finished")
            worst = max(worst, err)
    return dict(max_abs_err=worst, overridden_share=overridden / total)


def time_env_step_exec(get_preset, plume, rollout) -> dict:
    """The env-step kernel per call on ppo_v2_0 at N = 4096 and 2^20
    without and with the executed action, in alternating blocks (without,
    with, with, without) over one stepper of a guided chunk, beside the
    bound of each mode's bytes; and the device time of each mode."""
    import torch

    cfg = get_preset("ppo_v2_0").env
    out = {}
    for n, reps in ((MAIN_N, 2000), (LARGE_N, 100)):
        state, accum, g = env_start(rollout, cfg, n, seed=9, wide=False)
        logits, value = policy_outputs(cfg, n, g)
        draws = rollout.draw_chunk(g, cfg, 1, n)
        _, executed = exec_actions(logits, draws.gumbel[0], g)
        traj, obs = rollout.empty_trajectory(1, n, cfg, "cuda", guided=True)
        stepper = plume.EnvStepper(rollout.own_copy(state),
                                   rollout.own_copy(accum), draws, traj,
                                   obs, cfg)
        calls = {"null": lambda: stepper(0, logits, value),
                 "exec": lambda: stepper(0, logits, value, executed)}
        for fn in calls.values():
            fn()
        torch.cuda.synchronize()
        dones = int(traj.done.sum())
        blocks = {name: [] for name in calls}
        for name in ("null", "exec", "exec", "null"):
            blocks[name].append(cuda_ms(calls[name], reps))
        row = {}
        for name, guided in (("null", False), ("exec", True)):
            moved = plume.env_step_bytes(cfg, n, dones, greedy=False,
                                         guided=guided)
            bytes_s = moved / HBM_BYTES_PER_S
            ops_s = n * (PLUME_OPS_PER_QUERY + ENV_STEP_OPS) / F32_OPS_PER_S
            row[name] = dict(
                ms=min(blocks[name]), ms_blocks=blocks[name],
                device_ms=kernel_device_ms(calls[name], "env_step_kernel"),
                bound_ms=max(bytes_s, ops_s) * 1e3,
                bound_by="bytes" if bytes_s >= ops_s else "operations",
                bytes=moved)
        out[n] = row
        log(f"time env_step ppo_v2_0 N={n} without / with exec_action "
            f"(blocks null, exec, exec, null): per call "
            f"{blocks['null']} / {blocks['exec']} ms, on the device "
            f"{row['null']['device_ms']} / {row['exec']['device_ms']} ms, "
            f"bound {row['null']['bound_ms']:.6f} / "
            f"{row['exec']['bound_ms']:.6f} ms ({row['exec']['bound_by']}; "
            f"{row['null']['bytes']} / {row['exec']['bytes']} B)")
    return out


def guide_of(cfg):
    """The guide of ``eval --guide fit`` / ``train --train-guide fit`` on
    ``cfg``: the fit at the protocol's radius 50."""
    from tpu_plume_torch.evaluation.guidance import make_guide

    return make_guide(cfg.env, terminate_radius=50.0,
                      success_radius=cfg.eval.success_distance)


def guided_train_cfg(cfg):
    """``train --train-guide fit --min-radius 50 --terminal-gate 40``: the
    curriculum floor at the protocol's radius and the terminal bonus gated
    at success@40."""
    return cfg.replace(
        env=dataclasses.replace(cfg.env, terminal_gate_radius=40.0),
        curriculum=dataclasses.replace(cfg.curriculum, min_radius=50.0),
        ppo=dataclasses.replace(cfg.ppo, minibatch_size=MAIN_MB))


def fit_device_ms(guide_state, cfg, n_rep: int = 5):
    """Device ms of one ``fit_aniso`` over the buffers of ``guide_state``
    (every episode's), from torch.profiler: the fit's share of an eval
    step's device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from tpu_plume_torch.evaluation import aniso_fit

    gcfg = aniso_fit.derive_aniso_config(cfg.env, 50.0,
                                         cfg.eval.success_distance)

    def fit():
        aniso_fit.fit_aniso(guide_state.pos_buf, guide_state.c_buf,
                            guide_state.w_buf, cfg.env, gcfg,
                            return_ambiguity=True)

    fit()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n_rep):
            fit()
        torch.cuda.synchronize()
    kernels = device_kernels(prof)
    return (sum(e.self_device_time_total for e in kernels) / 1e3 / n_rep,
            sum(e.count for e in kernels) / n_rep)


def fit_buffers(cfg, gcfg, n: int, seed: int):
    """``n`` of the anisotropic guide's sample buffers (``gcfg.buffer_size``
    slots), filled as the guide fills them, from ``seed`` with numpy: per
    buffer a source in the spawn box and a wind angle, 2 to 128 reads
    (log-uniform) taken by turns on crosswind transects at four downwind
    stations, along a ridge segment 5-60 px long, or scattered downwind;
    each read the model (``make_model_n``) plus the turbulence noise, kept
    where the guide accepts it (``conc_floor`` to ``conc_ceil``), the other
    slots empty.  Returns numpy pos f32[n, K, 2], c f32[n, K] and
    w f32[n, K]."""
    import numpy as np
    import torch

    from tpu_plume_torch.evaluation import aniso_fit

    rng = np.random.default_rng(seed)
    k = gcfg.buffer_size
    lo, hi = cfg.source_padding, cfg.grid_size - cfg.source_padding
    src = rng.uniform(lo, hi, (n, 2)).astype(np.float32)
    theta = rng.uniform(-np.pi, np.pi, n).astype(np.float32)
    u = np.stack([np.cos(theta), np.sin(theta)], -1)
    v = np.stack([-u[:, 1], u[:, 0]], -1)
    kind = (np.arange(n) % 3)[:, None]
    reads = np.exp(rng.uniform(np.log(2.0), np.log(k), n)).astype(np.int64)
    segment = rng.uniform(5.0, 60.0, (n, 1))
    down = np.where(
        kind == 0, rng.choice([70.0, 120.0, 180.0, 240.0], (n, k)),
        np.where(kind == 1,
                 rng.uniform(80.0, 200.0, (n, 1))
                 + segment * rng.random((n, k)),
                 rng.uniform(20.0, 300.0, (n, k))))
    cross = np.where(kind == 1, rng.normal(0.0, 3.0, (n, k)),
                     rng.uniform(-30.0, 30.0, (n, k)))
    pos = (src[:, None] + down[..., None] * u[:, None]
           + cross[..., None] * v[:, None]).astype(np.float32)
    noise_n = (aniso_fit._NOISE_STD_FRAC * cfg.turbulence_intensity
               / cfg.conc_peak)
    c = aniso_fit.make_model_n(cfg)(torch.from_numpy(pos),
                                    torch.from_numpy(src),
                                    torch.from_numpy(theta)).numpy()
    c = c + noise_n * rng.standard_normal(c.shape)
    keep = ((c >= gcfg.conc_floor) & (c <= gcfg.conc_ceil)
            & (np.arange(k)[None] < reads[:, None]))
    return (np.where(keep[..., None], pos, 0.0).astype(np.float32),
            np.where(keep, c, 0.0).astype(np.float32),
            keep.astype(np.float32))


def fits_apart(got, want, cfg, gcfg) -> tuple:
    """Two ``fit_aniso`` results (est, theta, se, n_eff, spread) of the
    same buffers as numpy: the buffers whose fits part, ``want``'s gate
    and the gaps where both validate.  The guide's gate validates where
    n_eff >= ``min_samples``, se <= ``max_se`` and the estimate lies in
    the domain box.  A buffer parts where its gate decides the other way
    outside rounding of a bound (se within FIT_GATE_RTOL of ``max_se``,
    the estimate within FIT_EST_ATOL px of the box), or where both
    validate and the estimates lie more than FIT_EST_ATOL px, the wind
    angles more than FIT_THETA_ATOL rad (modulo 2 pi) or se more than
    FIT_GATE_RTOL (relative) apart: the 16 damped Gauss-Newton steps stop
    short of the minimum on noisy reads and near-tied starts may swap, so
    sums in another order can end a fit elsewhere."""
    import numpy as np

    lo = cfg.source_padding - gcfg.domain_slack
    hi = cfg.grid_size - cfg.source_padding + gcfg.domain_slack

    def gate(fit):
        est, _, se, n_eff = (np.asarray(x) for x in fit[:4])
        ok = ((n_eff >= gcfg.min_samples) & (se <= gcfg.max_se)
              & ((est >= lo) & (est <= hi)).all(-1))
        near = ((np.abs(se - gcfg.max_se) <= FIT_GATE_RTOL * gcfg.max_se)
                | (np.minimum(np.abs(est - lo), np.abs(est - hi)).min(-1)
                   <= FIT_EST_ATOL))
        return ok, near

    (ok_got, near_got), (ok_want, near_want) = gate(got), gate(want)
    both = ok_got & ok_want
    est = np.abs(np.asarray(got[0]) - np.asarray(want[0])).max(-1)
    theta = np.abs((np.asarray(got[1]) - np.asarray(want[1]) + np.pi)
                   % (2 * np.pi) - np.pi)
    se = np.abs(np.asarray(got[2]) - np.asarray(want[2])) / np.asarray(
        want[2])
    apart = (((ok_got != ok_want) & ~near_got & ~near_want)
             | (both & ((est > FIT_EST_ATOL) | (theta > FIT_THETA_ATOL)
                        | (se > FIT_GATE_RTOL))))
    gaps = {name: np.quantile(x[both], [0.5, 0.99, 1.0]).tolist()
            if both.any() else None
            for name, x in (("est", est), ("theta", theta), ("se", se))}
    return apart, ok_want, gaps


def check_fit_against_cpu(get_preset) -> dict:
    """``fit_aniso`` on the card against the CPU over FIT_EPISODES of
    wrf_les's guide buffers (``fit_buffers``), as the guide calls it
    (radius 50, the spread returned): n_eff equal everywhere, and at most
    one buffer in 64 whose fits part (``fits_apart``).  The buffers hold
    identifying transects, ambiguous ridge segments and too few reads, so
    both sides of each gate are compared."""
    import numpy as np
    import torch

    from tpu_plume_torch.evaluation import aniso_fit

    cfg = get_preset("wrf_les").env
    gcfg = aniso_fit.derive_aniso_config(cfg, 50.0, 40.0)
    bufs = fit_buffers(cfg, gcfg, FIT_EPISODES, seed=3)
    fits = {}
    for device in ("cuda", "cpu"):
        out = aniso_fit.fit_aniso(
            *(torch.from_numpy(x).to(device) for x in bufs), cfg, gcfg,
            return_ambiguity=True)
        fits[device] = [x.cpu().numpy() for x in out]
    got, want = fits["cuda"], fits["cpu"]
    apart, ok, gaps = fits_apart(got, want, cfg, gcfg)
    out = dict(buffers=FIT_EPISODES, validated=int(ok.sum()),
               unvalidated_with_samples=int(
                   ((want[3] >= gcfg.min_samples) & ~ok).sum()),
               apart=np.flatnonzero(apart).tolist(),
               gaps_median_p99_max=gaps)
    log(f"fit_aniso card vs CPU over {FIT_EPISODES} wrf_les guide buffers "
        f"[{FIT_EPISODES}, {gcfg.buffer_size}]: {json.dumps(out)}")
    assert (got[3] == want[3]).all()
    assert apart.sum() <= FIT_EPISODES // 64, out
    assert 0 < out["validated"] < FIT_EPISODES, out
    assert out["unvalidated_with_samples"] > 0, out
    return out


def slice_draws(ev, draws, n: int):
    """The draws of the first ``n`` episodes of ``draws``."""
    def first(x, axis):
        return None if x is None else x.narrow(axis, 0, n).contiguous()

    return ev.EvalDraws(u_src=first(draws.u_src, 0),
                        u_wind=first(draws.u_wind, 0),
                        bits=first(draws.bits, 0),
                        turb_noise=first(draws.turb_noise, 1),
                        gumbel=first(draws.gumbel, 1))


def run_guided_eval(ev, k, label, cfg, model, cpu_episodes=0,
                    baseline=True) -> dict:
    """Eval ``label`` at the protocol's width with the fit guide
    (``guide_of``), no stop (``guides_eval``: exact plume-sample launches,
    the guide adding none, summary, wall, the shares of episodes ending
    with a validated fit, in hover and committed, the first
    GUIDE_PROFILE_STEPS steps profiled; with ``baseline`` the same eval
    unguided), its first ``cpu_episodes`` episodes also on the CPU (which
    fits each episode at every step, so fewer than the protocol's); and on
    the anisotropic plume one fit's device time over every episode's
    buffers after the profiled steps."""
    last = {}

    def make(dev):
        init, fn = guide_of(cfg)
        if dev != "cuda":
            return (init, fn), None

        def step(*args):
            # keeps the card's latest state, whose buffers time the fit
            out = fn(*args)
            last["state"] = out[0]
            return out
        return (init, step), None

    out = guides_eval(ev, k, label, cfg, model, make,
                      baseline=(model, None) if baseline else None,
                      cpu_episodes=cpu_episodes)
    if cfg.env.plume_model == "anisotropic":
        fit_ms, fit_launches = fit_device_ms(last["state"], cfg)
        step_ms = out["device_ms_per_step"]
        out.update(fit_device_ms=fit_ms, fit_launches=fit_launches,
                   fit_share=fit_ms / step_ms if step_ms else None)
        log(f"eval {label}: one fit over the {cfg.eval.episodes} episodes' "
            f"buffers after {GUIDE_PROFILE_STEPS} steps: {fit_ms:.4f} ms of "
            f"device time in {fit_launches:.0f} launches, of "
            f"{step_ms:.4f} ms per step")
    return out


def check_guide_cli(cli_main, tmp) -> dict:
    """``eval --pth ... --guide fit`` of the ``train`` run in ``tmp`` at
    the full protocol: the summary and the npz with the reference schema
    and the ten guide fields, each of 1000 episodes."""
    import numpy as np

    pth = os.path.join(tmp, "model", "ppo_successful_models.pth")
    out = os.path.join(tmp, "eval_guided")
    summary, wall = cli_json(cli_main, ["eval", "--pth", pth, "--guide",
                                        "fit", "--out", out])
    metrics = np.load(os.path.join(out, "validation_metrics.npz"))
    assert len(metrics.files) == 14 and "guide_est" in metrics.files, (
        metrics.files)
    assert all(metrics[f].shape[0] == 1000 for f in metrics.files)
    assert np.isfinite(metrics["guide_est"]).all()
    log(f"cli eval --pth ... --guide fit: {wall:.2f} s, "
        f"{json.dumps(summary)}; validation_metrics.npz holds "
        f"{sorted(metrics.files)}")
    return dict(summary=summary, wall_s=wall)


def guided_training(ttrain, rollout, k, presets) -> tuple:
    """The training guide (``train --train-guide fit --min-radius 50
    --terminal-gate 40``) at full width on each (preset, cfg) of
    ``presets``: the fit guide in the rollout, still one env-step launch
    per env step (``run_main_path(guide=)``, GUIDED_ITERS timed
    iterations).  Returns the runs' records and their policies."""
    import torch

    runs, models = {}, {}
    for preset, cfg in presets:
        runs[preset] = run_main_path(
            ttrain, rollout.rollout_chunk, k, f"{preset} guided",
            guided_train_cfg(cfg), iters=GUIDED_ITERS[preset],
            profile_cpu=False, guide=guide_of(cfg),
            profile_steps=GUIDED_PROFILE_STEPS)
        models[preset] = runs[preset].pop("model")
        torch.cuda.empty_cache()
    return runs, models


def guided_evals(ev, k, get_preset, cases) -> tuple:
    """The fit alone on the card against the CPU
    (``check_fit_against_cpu``), then the fit guide in the protocol's evals
    (``eval --guide fit``, no stop), one per (label, cfg, policy, CPU
    episodes) of ``cases`` (``run_guided_eval``).  Returns the evals'
    records and the fit check's."""
    fit = check_fit_against_cpu(get_preset)
    evals = {label: run_guided_eval(ev, k, label, cfg, model,
                                    cpu_episodes=cpu)
             for label, cfg, model, cpu in cases}
    return evals, fit


# The eval guides phase: the bank-match and learned guides, the localizer
# and the scripted oracles in the protocol's evals (1000 x 1000), each
# with its first GUIDES_CPU_EPISODES episodes also on the CPU from the same
# draws; the bank policies' card iterations; the localizer's training
# budget in s (its epochs cut to it, at most the CLI's 150).
GUIDES_CPU_EPISODES = 64
BANK_POLICY_ITERS = 3
LOCALIZER_BUDGET_S = 30.0
LOCALIZER_MAX_EPOCHS = 150
# each eval's bank: None (analytic), "static" (wrf_les's 16-row static
# bank of ``--synth-bank static --bank-fields 16``, read between cells so
# that the bilinear kernel samples it) or "3d" (``--synth-bank 3d``)
BANK_GUIDE_FLAGS = {
    "bank static": ("static", []),
    "bank 3d options": ("3d", ["--guide-guard-top", "2",
                               "--guide-sticky-target", "--guide-dive-bias"]),
    "bank 3d entry": ("3d", ["--guide-entry-dive"]),
}


# the kernels line's keys of the eval guides phase's evals
EVAL_GUIDE_GROUPS = {
    "bank_guided_eval_launches": tuple(BANK_GUIDE_FLAGS),
    "learned_guided_eval_launches": ("learned", "fit_localize"),
    "oracle_eval_launches": ("oracle phase", "oracle raster fit", "expert"),
}


def guides_bank(gridded, env, kind):
    """The bank of ``--synth-bank static --bank-fields 16`` or
    ``--synth-bank 3d`` on the card, from seed 0 (the CLI's)."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(0)
    if kind == "static":
        return gridded.synthesize_bank(gen, env, num_fields=16)
    return gridded.synthesize_3d_bank(gen, env)


def bank_guide_cfgs(get_preset):
    """wrf_les with ``--plume-model gridded`` (sub-cell reads), and
    wrf_les_3d, at the main path's minibatch."""
    wl = get_preset("wrf_les")
    static = wl.replace(env=dataclasses.replace(
        wl.env, plume_model="gridded", subcell_sampling=True))
    w3 = get_preset("wrf_les_3d")
    return {kind: c.replace(ppo=dataclasses.replace(c.ppo,
                                                    minibatch_size=MAIN_MB))
            for kind, c in (("static", static), ("3d", w3))}


def bank_policy(ttrain, cfg, bank):
    """A policy of BANK_POLICY_ITERS card iterations of ``cfg`` over
    ``bank`` (``train_ppo``)."""
    with tempfile.TemporaryDirectory() as tmp:
        res = ttrain.train_ppo(cfg, tmp, device="cuda", bank=bank,
                               max_iterations=BANK_POLICY_ITERS,
                               write_csv=False, verbose=False)
    model = ttrain.make_policy_model(cfg)
    model.load_state_dict(res.state_dict)
    log(f"bank policy {cfg.name} ({cfg.env.plume_model}, "
        f"{list(bank.conc.shape)}): {BANK_POLICY_ITERS} iterations, "
        f"{res.episodes} episodes, {res.successes} successes")
    return model.to("cuda")


def guides_eval(ev, k, label, cfg, model, make, bank=None, baseline=None,
                localizer=None, cpu_episodes=GUIDES_CPU_EPISODES) -> dict:
    """Eval ``label`` at the protocol's width, no stop, from draws made on
    the CPU from a seed, with the guide and oracle of ``make(device)``:
    after an EVAL_WARMUP-step warm-up, the whole eval with every launch
    count set to 0 just before it and read just after (one field sample
    per step plus one at the reset: the guides and oracles launch none of
    the counted kernels), its summary, wall and eval env-steps/s; then
    GUIDE_PROFILE_STEPS steps unprofiled and profiled for the launches per
    eval step and the device busy share; with ``baseline`` (a (model,
    oracle) pair) the same eval without the guide, for its summary.  With
    ``localizer`` (the model on the card and on the CPU, its window) every
    flight is tracked and localized after the eval (``eval --localize``):
    the ``localize_*`` errors, and ``hybrid_*`` where the guide estimates.

    The first ``cpu_episodes`` episodes then run on the CPU from the same
    draws (``make("cpu")``), held to the card's: an episode agrees where
    its steps, deviation (within the env tolerance) and guide registers
    agree; at most one in 64 (at least one) may not, as a position one
    float ulp apart can land in another cell, each logged with the step
    where its path departs."""
    import copy

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from tpu_plume_torch.cli.main import bank_summary

    n, length = cfg.eval.episodes, eval_length(cfg)
    guide, oracle = make("cuda")
    draws = ev.draw_eval(torch.Generator().manual_seed(7), cfg.env, length,
                         n)
    track = n if localizer else cpu_episodes

    def run(steps=None, policy=model, with_oracle=oracle, with_guide=guide,
            track_n=0):
        return ev.evaluate_policy(
            policy, cfg.env, cfg.eval,
            draws=draws if steps is None else dataclasses.replace(
                draws, turb_noise=draws.turb_noise[:steps]),
            max_steps=steps, device="cuda", bank=bank,
            track_trajectories=track_n, guide=with_guide,
            oracle=with_oracle)

    run(EVAL_WARMUP)
    zero_counts(k)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    m = run(track_n=track)
    wall = time.perf_counter() - t0
    counts = read_counts(k)
    want = dict.fromkeys(KERNEL_NAMES, 0)
    want[_field_sample(cfg.env, bank)] = length + 1
    assert counts == want, (label, counts, want)
    check_eval_metrics(m, cfg, n, length)
    if guide is not None:
        assert np.isfinite(m.guide_est).all() and m.guide_samples.min() >= 0
    p = GUIDE_PROFILE_STEPS
    t0 = time.perf_counter()
    run(p)
    torch.cuda.synchronize()
    short_wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run(p)
        torch.cuda.synchronize()
    kernels = device_kernels(prof)
    launches = sum(e.count for e in kernels)
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    summary = ev.summarize(m)
    if bank is not None and guide is not None:
        summary.update(bank_summary(m))
    out = dict(summary=summary, wall_ms=wall * 1e3,
               env_steps_per_s=n * length / wall,
               active_env_steps=int(m.steps.sum()),
               launches_per_step=launches / p,
               device_ms_per_step=device_ms / p,
               busy=device_ms / (short_wall * 1e3),
               short_wall_ms=short_wall * 1e3, launches=counts)
    if guide is not None:
        out.update(fit_ok_share=float(m.guide_fit_ok.mean()),
                   hover_share=float(m.guide_hover.mean()),
                   committed_share=float(m.guide_committed.mean()))
    if localizer is not None:
        out["localize"] = localize_on_card(m, cfg, localizer, summary)
    if baseline is not None:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plain = run(policy=baseline[0], with_oracle=baseline[1],
                    with_guide=None)
        out["unguided"] = dict(summary=ev.summarize(plain),
                               wall_ms=(time.perf_counter() - t0) * 1e3)
    log(f"eval {label}: {cfg.name} {n} episodes x {length} steps, no stop: "
        f"success@40 {summary['success_rate']:.3f} "
        + (f"(unguided {out['unguided']['summary']['success_rate']:.3f}) "
           if baseline is not None else "")
        + f"mean deviation {summary['mean_deviation']:.2f}, mean steps "
        f"{summary['mean_steps']:.1f}"
        + (f"; episodes ending with the gate open {out['fit_ok_share']:.3f}, "
           f"in hover {out['hover_share']:.3f}, committed "
           f"{out['committed_share']:.3f}" if guide is not None else "")
        + (f", match accuracy {summary['bank_match_accuracy']:.3f}" if
           "bank_match_accuracy" in summary else "")
        + f"; wall {wall * 1e3:.1f} ms = {out['env_steps_per_s']:.1f} eval "
        f"env-steps/s; launches { {a: c for a, c in counts.items() if c} }; "
        f"the first {p} steps profiled: {launches / p:.2f} launches per eval "
        f"step, device {device_ms / p:.4f} ms per step, busy share "
        f"{out['busy']:.4f} of their unprofiled wall "
        f"({short_wall * 1e3:.1f} ms)")

    c = cpu_episodes
    if not c:
        return out
    cpu_guide, cpu_oracle = make("cpu")
    t0 = time.perf_counter()
    cpu = ev.evaluate_policy(
        None if model is None else copy.deepcopy(model).cpu(), cfg.env,
        cfg.eval, device="cpu", num_episodes=c, max_steps=length,
        draws=slice_draws(ev, draws, c), track_trajectories=c,
        bank=None if bank is None else bank.to("cpu"), guide=cpu_guide,
        oracle=cpu_oracle)
    cpu_s = time.perf_counter() - t0
    agree = ((m.steps[:c] == cpu.steps)
             & np.isclose(m.deviations[:c], cpu.deviations, rtol=RTOL,
                          atol=ATOL))
    if cpu.guide_fit_ok is not None:
        for name in ("guide_fit_ok", "guide_hover", "guide_committed",
                     "guide_samples", "guide_refutes", "guide_match",
                     "guide_contacts"):
            agree &= getattr(m, name)[:c] == getattr(cpu, name)
    apart = np.flatnonzero(~agree)
    off = ~np.isclose(m.trajectories[apart, :, :2],
                      cpu.trajectories[apart, :, :2], rtol=RTOL, atol=ATOL,
                      equal_nan=True).all(-1)
    departs = np.where(off.any(-1), off.argmax(-1), -1)
    log(f"eval {label} card vs CPU, the first {c} episodes x {length} steps "
        f"(the CPU side {cpu_s:.1f} s): {len(apart)} of {c} episodes apart "
        f"({int((m.steps[:c] != cpu.steps).sum())} in steps); their paths "
        f"depart at steps {departs.tolist()}; success@40 "
        f"{m.success[:c].mean():.3f} on the card, {cpu.success.mean():.3f} "
        f"on the CPU")
    assert len(apart) <= max(1, c // 64), (label, apart)
    out["card_vs_cpu"] = dict(episodes=c, apart=len(apart),
                              departs=departs.tolist(), cpu_s=cpu_s)
    return out


# The learned guide's card-against-CPU limit on its estimate, px: above
# the gap of the localizer's cuDNN forward to the CPU's on the same
# windows (the localize pass, at most 0.0408 px over 1000 flights' tail
# windows on an NVIDIA H100 80GB HBM3, 700.00 W), far below a wrong
# localizer's pixels.  On a window where rounding alone moves the
# localizer's estimate further (``sensitivity``), the limit is
# SENSITIVITY_FACTOR times that: the card's estimate parted from the
# CPU's by 7.5-29 times it there, and by 2.54 px on a window where it is
# 0.0875 px (the same card).
LEARNED_EST_LIMIT = 0.05
SENSITIVITY_FACTOR = 64.0
# the relative noise on the localizer's weights that measures a window's
# sensitivity (fp32's machine epsilon), and its draws
FP32_EPS = 2.0 ** -23
SENSITIVITY_DRAWS = 8
# steps of the card's records the CPU's teacher-forced guide takes at once
FORCED_CHUNK = 125


def recording(guide, c: int):
    """The learned ``guide`` keeping, on its device, each step's inputs
    (window, count, checked estimate, gate, position, concentration,
    policy action) and outputs (estimate, gate, action) of the first ``c``
    episodes; returns (guide, records), the records [T] lists."""
    init, fn = guide
    rec = []

    def step(gs, pos, conc, act):
        out = fn(gs, pos, conc, act)
        rec.append([x[:c].clone() for x in (
            gs.window, gs.count, gs.est_prev, gs.est_ok, pos, conc, act,
            out[0].est, out[0].est_ok, out[1])])
        return out
    return (init, step), rec


def forced_step(cpu_step, parts):
    """The CPU's learned-guide step from the recorded inputs ``parts``
    (window, count, checked estimate, gate, position, concentration,
    policy action; [M, ...]): (state, action)."""
    import torch

    from tpu_plume_torch.evaluation.learned_guide import LearnedGuideState

    win, count, est_prev, ok, *inputs = parts
    gs = LearnedGuideState(window=win, count=count,
                           est=torch.zeros_like(est_prev), est_prev=est_prev,
                           est_ok=ok, mode=torch.zeros_like(count))
    with torch.no_grad():
        g, a, _ = cpu_step(gs, *inputs)
    return g, a


def limits(cfg, model64, g, gap):
    """Each step's estimate limit, px: LEARNED_EST_LIMIT, or where ``gap``
    exceeds it SENSITIVITY_FACTOR times the localizer's sensitivity on the
    step's window (the CPU's state ``g``): the largest per-axis spread of
    its f64 estimate over SENSITIVITY_DRAWS draws of relative noise
    FP32_EPS on its weights, a property of the model and the window
    alone."""
    import copy

    import torch

    lim = torch.full_like(gap, LEARNED_EST_LIMIT)
    over = gap > LEARNED_EST_LIMIT
    if not over.any():
        return lim
    x = g.window[over].double()
    lengths = torch.clamp(g.count[over], max=x.shape[1])
    gen = torch.Generator().manual_seed(0)
    draws = []
    with torch.no_grad():
        for _ in range(SENSITIVITY_DRAWS):
            m = copy.deepcopy(model64)
            for p in m.parameters():
                p.mul_(1.0 + FP32_EPS * torch.randn(
                    p.shape, generator=gen, dtype=torch.float64))
            draws.append(m(x, lengths)[:, :2] * cfg.env.grid_size)
    spread = torch.stack(draws).std(0).amax(-1).float()
    lim[over] = torch.clamp(SENSITIVITY_FACTOR * spread,
                            min=LEARNED_EST_LIMIT)
    return lim


def near_bound(cfg, knobs, pos, est, est_prev, count, lim) -> tuple:
    """Where the learned guide's decisions at ``est`` lie within ``lim``
    (px, per row) of their bounds: the gate, where ``count`` is a check
    and the move from ``est_prev`` is within twice ``lim`` of
    ``stable_tol``; the action, where ``phase_action`` changes with the
    estimate moved by ``lim`` on either axis or both.  ``knobs`` is
    ``learned_knobs``'.  Returns (gate near, action near), bool[N]."""
    import torch

    from tpu_plume_torch.evaluation.guidance import norm2, phase_action

    tol, every, min_window, geometry = knobs
    check = (count % every == 0) & (count >= min_window)
    gate = check & ((norm2(est - est_prev) - tol).abs() <= 2 * lim)
    unit = torch.tensor([[0.0, 0.0]] + [[a, b] for a in (-1.0, 0.0, 1.0)
                                         for b in (-1.0, 0.0, 1.0) if a or b])
    k = len(unit)
    acts = phase_action(
        pos[:, None, :2].expand(-1, k, -1).reshape(-1, 2),
        (est[:, None] + unit * lim[:, None, None]).reshape(-1, 2), cfg.env,
        *geometry).view(-1, k)
    return gate, (acts != acts[:, :1]).any(-1)


def learned_teacher_forced(cfg, cpu_step, model64, knobs, card) -> dict:
    """The CPU's learned-guide step on every step the card recorded
    (``card``, ``recording``'s records stacked [T, c, ...] on the CPU):
    every estimate within its ``limits`` of the card's, the gate and the
    action equal but where ``near_bound`` (logged).  Returns the gaps,
    the steps over LEARNED_EST_LIMIT with their limits, the flips near
    their bounds and the episodes apart otherwise."""
    import numpy as np
    import torch

    est_c, ok_c, act_c = card[7:]
    steps, c = card[1].shape
    outs = []
    for s in range(0, steps, FORCED_CHUNK):
        g, a = forced_step(cpu_step, [x[s:s + FORCED_CHUNK].flatten(0, 1)
                                      for x in card[:7]])
        outs.append((g, a))
    g = dataclasses.replace(outs[0][0], **{
        f.name: torch.cat([getattr(o[0], f.name) for o in outs])
        for f in dataclasses.fields(outs[0][0])})
    est = g.est.view(steps, c, 2)
    ok = g.est_ok.view(steps, c)
    a = torch.cat([o[1] for o in outs]).view(steps, c)
    gap = (est - est_c).abs().amax(-1)
    lim = limits(cfg, model64, g, gap.flatten()).view(steps, c)
    gate_near, act_near = (x.view(steps, c) for x in near_bound(
        cfg, knobs, card[4].flatten(0, 1), g.est, card[2].flatten(0, 1),
        g.count, lim.flatten()))
    gate_flip = ok != ok_c
    act_flip = (a != act_c) & ~gate_flip
    near = (gate_flip & gate_near | act_flip & ok & act_near) & (gap <= lim)
    flips = (gate_flip | act_flip) & ~near
    gp = gap.numpy()
    over = np.nonzero(gp > LEARNED_EST_LIMIT)
    return dict(
        steps=steps * c,
        gap_median_p99_max=[float(np.median(gp)),
                            float(np.quantile(gp, 0.99)), float(gp.max())],
        over_small_limit=[(int(i), int(t), float(gp[t, i]),
                           float(lim[t, i])) for t, i in zip(*over)],
        over_limit=int((gap > lim).sum()),
        near_bound=[(int(i), int(t), "gate" if gate_flip[t, i] else
                     "action", float(gp[t, i]), float(lim[t, i]))
                    for t, i in zip(*np.nonzero(near.numpy()))],
        apart=np.flatnonzero(flips.any(0).numpy()).tolist())


def learned_against_cpu(ev, cfg, model, make, model64, knobs,
                        draws) -> dict:
    """The learned guide on the card against the CPU over the episodes of
    ``draws``, both recorded (``recording``): the card's steps teacher-
    forced on the CPU (``learned_teacher_forced``: every estimate within
    its limit, at most one episode in 64 (at least one) with a decision
    apart but near its bound), then the two free runs, held as
    ``guides_eval`` holds them.  A free run's departure is excused where
    its first departing step is a guide decision whose two estimates lie
    within the step's limit (``limits``) and that lies within it of its
    bound; the rest (also the policy's own departures and the env's), at
    most one in 64 (at least one).  ``model64`` is the localizer in f64
    on the CPU."""
    import copy

    import numpy as np
    import torch

    c = draws.bits.shape[0]
    length = draws.turb_noise.shape[0]
    cpu_step = make("cpu")[0][1]
    runs, recs = {}, {}
    t0 = time.perf_counter()
    for dev in ("cuda", "cpu"):
        guide, rec = recording(make(dev)[0], c)
        runs[dev] = ev.evaluate_policy(
            copy.deepcopy(model).to(dev), cfg.env, cfg.eval, device=dev,
            num_episodes=c, max_steps=length, draws=draws, guide=guide)
        recs[dev] = [torch.stack([r[j] for r in rec]).cpu()
                     for j in range(len(rec[0]))]
    forced = learned_teacher_forced(cfg, cpu_step, model64, knobs,
                                    recs["cuda"])
    card, cpu = runs["cuda"], runs["cpu"]
    agree = ((card.steps == cpu.steps)
             & np.isclose(card.deviations, cpu.deviations, rtol=RTOL,
                          atol=ATOL)
             & (card.guide_fit_ok == cpu.guide_fit_ok))
    mine, theirs = recs["cpu"], recs["cuda"]
    excused, counted = {}, {}
    for i in np.flatnonzero(~agree):
        ok, ok_g = mine[8][:, i], theirs[8][:, i]
        differ = ((mine[9][:, i] != theirs[9][:, i]) | (ok != ok_g)).numpy()
        if not differ.any():
            counted[int(i)] = (-1, "env")
            continue
        t = int(differ.argmax())
        if not (ok[t] or ok_g[t]):
            counted[int(i)] = (t, "policy")
            continue
        at = [x[t, i][None] for x in mine]
        g, _ = forced_step(cpu_step, at[:7])
        gap = (at[7] - theirs[7][t, i][None]).abs().amax(-1)
        lim = limits(cfg, model64, g, gap)
        gate_near, act_near = near_bound(cfg, knobs, at[4], at[7], at[2],
                                         at[1] + 1, lim)
        kind = "gate" if ok[t] != ok_g[t] else "action"
        near = bool(gate_near if kind == "gate" else act_near)
        (excused if near and gap <= lim else counted)[int(i)] = (
            t, kind, float(gap), float(lim))
    budget = max(1, c // 64)
    out = dict(episodes=c, teacher_forced=forced,
               apart=int((~agree).sum()), excused=excused, counted=counted,
               seconds=time.perf_counter() - t0)
    log(f"eval learned card vs CPU, the first {c} episodes x {length} "
        f"steps: teacher-forced over {forced['steps']} steps, estimate gap "
        f"median/p99/max {forced['gap_median_p99_max']} px; (episode, "
        f"step, gap, limit) over {LEARNED_EST_LIMIT} px: "
        f"{forced['over_small_limit']}, {forced['over_limit']} over their "
        f"limit; decisions apart near their bounds {forced['near_bound']}, "
        f"otherwise in episodes {forced['apart']}; free runs: "
        f"{out['apart']} of {c} episodes apart, excused (a guide decision "
        f"within the step's limit of its bound) {excused}, counted "
        f"{counted}; success@40 {card.success.mean():.3f} on the card, "
        f"{cpu.success.mean():.3f} on the CPU ({out['seconds']:.1f} s)")
    assert forced["over_limit"] == 0, forced
    assert len(forced["apart"]) <= budget, forced
    assert len(counted) <= budget, counted
    return out


def localize_on_card(m, cfg, localizer, summary) -> dict:
    """``eval --localize``: every flight of ``m`` localized by the model on
    the card (its errors and, where the guide estimates, the hybrid's into
    ``summary``), and by the same model on the CPU (the largest gap, px)."""
    import numpy as np

    from tpu_plume_torch.cli.main import location_errors
    from tpu_plume_torch.evaluation.localize import (
        localize_from_trajectories,
    )

    card_model, cpu_model, window = localizer
    kw = dict(window=window, grid_size=cfg.env.grid_size,
              conc_peak=cfg.env.conc_peak)
    t0 = time.perf_counter()
    pred = localize_from_trajectories(m.trajectories, card_model, **kw)
    wall = time.perf_counter() - t0
    gap = float(np.abs(pred - localize_from_trajectories(
        m.trajectories, cpu_model, **kw)).max())
    summary.update(location_errors("localize", pred, m.sources))
    if m.guide_est is not None:
        summary.update(location_errors("hybrid", np.where(
            m.guide_fit_ok[:, None], m.guide_est, pred), m.sources))
    log(f"localize {len(pred)} flights (window {window}): {wall * 1e3:.1f} "
        f"ms on the card, largest gap to the CPU's estimate {gap:.3e} px; "
        f"median error {summary['localize_median_err']:.2f} px")
    assert gap <= LEARNED_EST_LIMIT, gap
    return dict(wall_ms=wall * 1e3, card_vs_cpu_max_px=gap)


def train_localizer(cli_main, lt, flights, out) -> dict:
    """``train-lstm --variant params --flights`` on the card, its epochs
    cut so that it takes about LOCALIZER_BUDGET_S (timed from a 1-epoch
    and a 3-epoch run of ``train_source_lstm``), at most
    LOCALIZER_MAX_EPOCHS."""
    walls = {}
    for epochs in (1, 3):
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.perf_counter()
            lt.train_source_lstm(None, tmp, flights_path=flights,
                                 epochs=epochs, device="cuda")
            walls[epochs] = time.perf_counter() - t0
    per_epoch = max((walls[3] - walls[1]) / 2, 1e-3)
    epochs = int(min(LOCALIZER_MAX_EPOCHS,
                     max(3, LOCALIZER_BUDGET_S / per_epoch)))
    res, wall = cli_json(cli_main, ["train-lstm", "--variant", "params",
                                    "--flights", flights, "--epochs",
                                    str(epochs), "--out", out])
    log(f"localizer: {per_epoch * 1e3:.1f} ms an epoch on the card, "
        f"{epochs} epochs (of the CLI's {LOCALIZER_MAX_EPOCHS}) in "
        f"{wall:.1f} s: {json.dumps(res)}")
    return dict(epochs=epochs, epoch_ms=per_epoch * 1e3, wall_s=wall, **res)


def learned_knobs(cli, loc, cfg) -> tuple:
    """The learned guide's gate (stable_tol, check_every, min_window) as
    ``eval --guide learned --guide-ckpt loc`` derives it, and its dive
    geometry (terminate radius, deep target, setup distance) at the
    protocol's radius 50."""
    from tpu_plume_torch.evaluation.learned_guide import (
        derive_learned_guide_config,
        load_localizer_meta,
    )

    meta = load_localizer_meta(loc)
    d = derive_learned_guide_config(meta["val_median_err_px"],
                                    window=int(meta["window"]))
    deep_target = min(cfg.eval.success_distance - 10.0, 0.8 * 50.0)
    setup = deep_target + cfg.env.grid_size * cfg.env.move_frac - 1.0
    return (d["stable_tol"], d["check_every"], d["min_window"],
            (50.0, deep_target, setup))


def expert_oracle(ev, k, cfg, oracle_of) -> dict:
    """``expert --oracle phase`` at 1000 episodes on the card against the
    CPU from the same draws: exact plume-sample launches, the same sample
    count and actions."""
    import numpy as np
    import torch

    n, length = 1000, cfg.env.max_steps
    draws = ev.draw_eval(torch.Generator().manual_seed(9), cfg.env, length,
                         n)
    zero_counts(k)
    t0 = time.perf_counter()
    states, actions = ev.generate_expert_data(
        None, cfg.env, num_episodes=n, draws=draws, device="cuda",
        oracle=oracle_of("phase", cfg.env))
    wall = time.perf_counter() - t0
    counts = read_counts(k)
    want = dict.fromkeys(KERNEL_NAMES, 0)
    want["plume_sample"] = length + 1
    assert counts == want, (counts, want)
    cpu_states, cpu_actions = ev.generate_expert_data(
        None, cfg.env, num_episodes=n, draws=draws, device="cpu",
        oracle=oracle_of("phase", cfg.env))
    assert len(actions) == len(cpu_actions) > 0, (len(actions),
                                                  len(cpu_actions))
    assert (actions == cpu_actions).all()
    gap = float(np.abs(states - cpu_states).max())
    log(f"expert --oracle phase: {n} episodes x {length} steps, "
        f"{len(actions)} samples on the card and on the CPU, actions equal, "
        f"states within {gap:.3e}; wall {wall * 1e3:.1f} ms; launches "
        f"{ {a: c for a, c in counts.items() if c} }")
    assert gap <= ATOL, gap
    return dict(samples=len(actions), wall_ms=wall * 1e3, launches=counts,
                states_max_gap=gap)


def eval_guides(ev, k, ttrain, gridded, get_preset, cli_main, v20,
                trained, expert_dir) -> dict:
    """The eval guides phase (see the module docstring, phase 12): the
    bank guide over wrf_les's static bank and wrf_les_3d's 3-D bank, the
    learned guide and the localizer of ``trained``'s own flights, the
    fit guide with the localizer, the phase oracle and the raster oracle
    under the fit guide, ``expert --oracle phase``, and the CLI's
    ``eval --guide bank``, ``eval --guide learned --localize`` and
    ``expert --oracle phase`` (its ``expert_data.npz`` written into
    ``expert_dir``, the imitation phase's expert file)."""
    import copy
    import importlib

    import torch

    from tpu_plume_torch.evaluation.oracle import make_oracle
    from tpu_plume_torch.train import lstm_trainer as lt

    cli = importlib.import_module("tpu_plume_torch.cli.main")
    out = {}
    cfgs = bank_guide_cfgs(get_preset)
    for kind in ("static", "3d"):
        cfg = cfgs[kind]
        bank = guides_bank(gridded, cfg.env, kind)
        model = bank_policy(ttrain, cfg, bank)
        for label, (bank_kind, flags) in BANK_GUIDE_FLAGS.items():
            if bank_kind != kind:
                continue
            args = cli.build_parser().parse_args(["eval", "--guide", "bank",
                                                  *flags])
            out[label] = guides_eval(
                ev, k, label, cfg, model,
                lambda dev, a=args, b=bank: (
                    cli.bank_guide(a, cfg, b if dev == "cuda"
                                   else b.to("cpu")), None),
                bank=bank, baseline=(model, None))
        if kind == "static":
            with tempfile.TemporaryDirectory() as tmp:
                pth = os.path.join(tmp, "policy.pth")
                torch.save(model.state_dict(), pth)
                summary, wall = cli_json(cli_main, [
                    "eval", "--preset", "wrf_les", "--plume-model",
                    "gridded", "--synth-bank", "static", "--bank-fields",
                    "16", "--pth", pth, "--guide", "bank"])
            assert {"bank_gate_rate", "bank_match_accuracy"} <= set(summary)
            out["cli_bank"] = dict(summary=summary, wall_s=wall)
            log(f"cli eval --preset wrf_les --plume-model gridded "
                f"--synth-bank static --bank-fields 16 --guide bank: "
                f"{wall:.2f} s, {json.dumps(summary)}")
        del bank, model
        torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as tmp:
        pth = os.path.join(tmp, "policy.pth")
        torch.save(trained.state_dict(), pth)
        flights = os.path.join(tmp, "flights.npz")
        summary, wall = cli_json(cli_main, ["eval", "--pth", pth,
                                            "--save-flights", flights])
        log(f"cli eval --save-flights: {wall:.2f} s, {json.dumps(summary)}")
        loc = os.path.join(tmp, "loc")
        out["localizer"] = train_localizer(cli_main, lt, flights, loc)
        args = cli.build_parser().parse_args([
            "eval", "--guide", "learned", "--guide-ckpt", loc, "--localize",
            loc])
        models = {dev: cli.load_localizer(loc, dev)[0]
                  for dev in ("cuda", "cpu")}
        localizer = (models["cuda"], models["cpu"], args.localize_window)
        knobs = learned_knobs(cli, loc, v20)

        def make_learned(dev):
            return cli.learned_guide(args, v20, dev), None

        out["learned"] = guides_eval(
            ev, k, "learned", v20, trained, make_learned,
            baseline=(trained, None), localizer=localizer, cpu_episodes=0)
        # the first episodes of the eval's own draws (``guides_eval``'s)
        out["learned"]["card_vs_cpu"] = learned_against_cpu(
            ev, v20, trained, make_learned,
            copy.deepcopy(models["cpu"]).double(), knobs, slice_draws(
                ev, ev.draw_eval(torch.Generator().manual_seed(7), v20.env,
                                 eval_length(v20), v20.eval.episodes),
                GUIDES_CPU_EPISODES))
        out["fit_localize"] = guides_eval(
            ev, k, "fit localize", v20, trained,
            lambda dev: (guide_of(v20), None), localizer=localizer)
        summary, wall = cli_json(cli_main, [
            "eval", "--pth", pth, "--guide", "learned", "--guide-ckpt", loc,
            "--localize", loc])
        assert {"localize_median_err", "hybrid_median_err"} <= set(summary)
        out["cli_learned"] = dict(summary=summary, wall_s=wall)
        log(f"cli eval --guide learned --localize: {wall:.2f} s, "
            f"{json.dumps(summary)}")
    del models, localizer
    torch.cuda.empty_cache()

    out["oracle phase"] = guides_eval(
        ev, k, "oracle phase", v20, None,
        lambda dev: (None, make_oracle("phase", v20.env)))
    out["oracle raster fit"] = guides_eval(
        ev, k, "oracle raster fit", v20, None,
        lambda dev: (guide_of(v20), make_oracle("raster", v20.env)),
        baseline=(None, make_oracle("raster", v20.env)))
    out["expert"] = expert_oracle(ev, k, v20, make_oracle)
    out["cli_expert"] = expert_file(cli_main, expert_dir)
    return out


def expert_file(cli_main, expert_dir) -> dict:
    """``expert --oracle phase --episodes EXPERT_EPISODES`` into
    ``expert_dir/expert_data.npz``."""
    path = os.path.join(expert_dir, "expert_data.npz")
    summary, wall = cli_json(cli_main, [
        "expert", "--oracle", "phase", "--episodes", str(EXPERT_EPISODES),
        "--out", path])
    assert summary["samples"] > 0 and os.path.isfile(path), summary
    log(f"cli expert --oracle phase --episodes {EXPERT_EPISODES}: "
        f"{wall:.2f} s, {json.dumps(summary)}")
    return dict(summary=summary, wall_s=wall)


IMIT_ITERS = 2            # timed iterations of the distill and GAIL paths
DAGGER_ROUNDS = 2         # of JAX's 8 default rounds
DAGGER_EPISODES = 512     # JAX's default episodes a round
# sequence DAgger, cut: BPTT over whole episodes is one launch chain a step
SEQ_DAGGER = dict(rounds=2, episodes_per_round=64, epochs_per_round=1)
SEQ_DAGGER_STEPS = 250
EXPERT_EPISODES = 1000


def imitation_cfg(v20, **ppo):
    """ppo_v2_0 at the main path's width with the PPO fields ``ppo``."""
    return v20.replace(ppo=dataclasses.replace(v20.ppo,
                                               minibatch_size=MAIN_MB, **ppo))


def labels_against_cpu(ttrain, rollout, cfg, model) -> dict:
    """One labelled rollout chunk of distilled PPO at full width on the
    card and on the CPU, from the same params, start and draws: an env is
    apart where its teacher labels, actions or dones differ at any step (a
    position one ulp apart can land in another cell, and another path
    follows); at most one env in 64, each logged with the step where it
    parts."""
    import copy

    import torch

    from tpu_plume_torch.evaluation.oracle import make_oracle

    n, t = cfg.rollout.num_envs, cfg.rollout.unroll_length
    oracle = make_oracle(cfg.ppo.distill_oracle, cfg.env)
    start = ttrain.init_loop(cfg, "cpu").rollout
    draws = rollout.draw_chunk(torch.Generator().manual_seed(5), cfg.env, t,
                               n)
    _, ctraj, _ = rollout.rollout_chunk(copy.deepcopy(model).cpu(), start,
                                        cfg.env, t, draws=draws,
                                        oracle=oracle)
    card = dataclasses.replace(to_device(start, "cuda"),
                               generator=torch.Generator(device="cuda"))
    _, gtraj, _ = rollout.rollout_chunk(model, card, cfg.env, t,
                                        draws=to_device(draws, "cuda"),
                                        oracle=oracle)
    label_off = gtraj.oracle_action.cpu() != ctraj.oracle_action
    path_off = ((gtraj.action.cpu() != ctraj.action)
                | (gtraj.done.cpu() != ctraj.done))
    apart = torch.nonzero((label_off | path_off).any(0)).flatten().tolist()
    for e in apart:
        first = [int(x[:, e].nonzero()[0]) if x[:, e].any() else None
                 for x in (label_off, path_off)]
        log(f"distill labels card vs CPU: env {e} parts, labels first at "
            f"step {first[0]}, actions or dones first at step {first[1]}")
    share = float((ctraj.oracle_action[:, None] == torch.arange(
        cfg.env.num_actions)[None, :, None]).float().mean((0, 2)).max())
    log(f"distill labels card vs CPU: {n} envs x {t} steps, {len(apart)} "
        f"envs apart (labels equal at "
        f"{float((~label_off).float().mean()):.6f} of the steps; the most "
        f"frequent teacher action {share:.3f} of the labels)")
    assert len(apart) <= n // 64, apart
    return dict(apart=len(apart), label_agreement=float(
        (~label_off).float().mean()))


def run_gail_path(k, ttrain, tgail, label, cfg, expert, expert_path,
                  iters=IMIT_ITERS) -> dict:
    """Closed-loop GAIL at full width on the card: ``train_ppo_gail`` on
    ``expert_path`` for ``iters`` iterations with the launch counts set to
    0 just before it and read just after (one plume sample at the reset,
    one env-step launch per env step; under ``fused_update`` three fused
    launches per minibatch step); then its parts as it drives them
    (``init_loop``, the discriminator, ``build_gail_train_step`` with the
    phases timed), a warm-up and ``iters`` timed iterations, each
    stretch's launches checked; ms per iteration by phase, the
    discriminator's step split out, and its loss and accuracy."""
    import torch

    with tempfile.TemporaryDirectory() as tmp:
        zero_counts(k)
        res = tgail.train_ppo_gail(cfg, tmp, expert_path, closed_loop=True,
                                   max_iterations=iters, device="cuda",
                                   verbose=False)
        torch.cuda.synchronize()
        entry = read_counts(k)
    want = {name: a + b for (name, a), b in zip(
        expected_init_counts(cfg, None).items(),
        expected_counts(cfg, None, iters).values())}
    assert entry == want, (label, "train_ppo_gail", entry, want)
    log(f"GAIL {label}: train_ppo_gail, {iters} iterations, {res.episodes} "
        f"episodes, launches {entry}")
    zero_counts(k)
    loop = ttrain.init_loop(cfg, "cuda")
    disc, opt = tgail.make_disc_state(cfg, "cuda", cfg.seed + 1)
    carry = tgail.GAILCarry(ppo=loop, disc=disc, disc_optimizer=opt)
    torch.cuda.synchronize()
    after_init = read_counts(k)
    step = tgail.build_gail_train_step(cfg, *expert, closed_loop=True,
                                       time_phases=True)
    carry, stats, _ = step(carry, 0.1)
    torch.cuda.synchronize()
    before = read_counts(k)
    phases = dict.fromkeys(("rollout", "gae", "update", "disc"), 0.0)
    t0 = time.perf_counter()
    for _ in range(iters):
        carry, stats, _ = step(carry, 0.1)
        for key in phases:
            phases[key] += stats[f"time/{key}_ms"]
        assert math.isfinite(float(stats["loss/total"])), stats
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = count_diff(read_counts(k), before)
    for got, want, stretch in (
            (after_init, expected_init_counts(cfg, None), "init_loop"),
            (count_diff(before, after_init), expected_counts(cfg, None, 1),
             "warm-up"),
            (counts, expected_counts(cfg, None, iters), "timed")):
        assert got == want, (label, stretch, got, want)
    out = dict(counts=counts, entry_launches=entry,
               whole_ms=wall / iters * 1e3,
               sps=iters * cfg.rollout.num_envs * cfg.rollout.unroll_length
               / wall,
               disc_loss=float(stats["gail/disc_loss"]),
               disc_acc=float(stats["gail/disc_acc"]),
               **{key: v / iters for key, v in phases.items()})
    log(f"GAIL {label}: {iters} iterations, ms per iteration " + ", ".join(
        f"{key} {out[key]:.2f}" for key in (*phases, "whole_ms"))
        + f", {out['sps']:.1f} env-steps/s; disc_loss "
        f"{out['disc_loss']:.4f}, disc_acc {out['disc_acc']:.4f}; launches "
        f"per timed iteration "
        f"{ {n: c // iters for n, c in counts.items() if c} }")
    return out


@contextlib.contextmanager
def dagger_rounds(k, dagger, bc, record: list):
    """``train_dagger`` with each round timed: the collection (its launch
    counts set to 0 just before it and read just after) and the fit, each
    between device synchronisations, appended to ``record``."""
    import torch

    real_collect = dagger._collect
    fitters = {name: getattr(bc, name)
               for name in ("make_bc_fitter", "make_seq_bc_fitter")}

    def collect(*a, **kw):
        torch.cuda.synchronize()
        zero_counts(k)
        t0 = time.perf_counter()
        out = real_collect(*a, **kw)
        torch.cuda.synchronize()
        record.append(dict(collect_ms=(time.perf_counter() - t0) * 1e3,
                           launches=read_counts(k)))
        return out

    def timed(make):
        def make_timed(*a, **kw):
            fit = make(*a, **kw)

            def fit_timed(*args, **fkw):
                t0 = time.perf_counter()
                out = fit(*args, **fkw)
                torch.cuda.synchronize()
                record[-1]["fit_ms"] = (time.perf_counter() - t0) * 1e3
                record[-1]["rows"] = int(args[0].shape[0 if args[0].dim() == 2
                                                        else 1])
                return out
            return fit_timed
        return make_timed

    dagger._collect = collect
    for name, make in fitters.items():
        setattr(bc, name, timed(make))
    try:
        yield
    finally:
        dagger._collect = real_collect
        for name, make in fitters.items():
            setattr(bc, name, make)


def run_dagger(k, dagger, bc, label, cfg, rounds, episodes, **kw) -> dict:
    """``train_dagger`` on the card, each round's collection and fit timed
    (``dagger_rounds``); a collection launches one plume sample per step
    plus the reset's, and no other counted kernel."""
    record = []
    with tempfile.TemporaryDirectory() as tmp, \
            dagger_rounds(k, dagger, bc, record):
        t0 = time.perf_counter()
        res = dagger.train_dagger(cfg, tmp, rounds=rounds,
                                  episodes_per_round=episodes, device="cuda",
                                  **kw)
        wall = time.perf_counter() - t0
        assert os.path.isfile(os.path.join(tmp, "checkpoint.pt"))
    want = dict.fromkeys(KERNEL_NAMES, 0)
    want["plume_sample"] = cfg.env.max_steps + 1
    for r, rec in enumerate(record):
        assert rec["launches"] == want, (label, r, rec["launches"], want)
        log(f"DAgger {label} round {r}: collection {episodes} episodes x "
            f"{cfg.env.max_steps} steps {rec['collect_ms']:.1f} ms, "
            f"launches {rec['launches']['plume_sample']} plume samples; fit "
            f"of {rec['rows']} {'episodes' if cfg.ppo.arch == 'lstm' else 'rows'}"
            f" {rec['fit_ms']:.1f} ms; rollout s@40 "
            f"{res.eval_success[r]:.3f}")
    log(f"DAgger {label}: {rounds} rounds in {wall:.1f} s, {res.samples} "
        f"samples, val accuracy {res.val_accuracy:.4f}")
    return dict(rounds=record, wall_s=wall, samples=res.samples,
                val_accuracy=res.val_accuracy,
                rollout_success=res.eval_success), res


def collection_against_cpu(dagger, cfg, state_dict, n) -> dict:
    """One student-driven DAgger round's collection (the greedy student of
    ``state_dict``, the phase oracle labelling) of ``n`` episodes on the
    card and on the CPU from the same draws: at most one episode in 64
    whose labels or ``valid`` rows differ, each logged with its first
    differing step."""
    import torch

    from tpu_plume_torch.evaluation import harnesses as ev
    from tpu_plume_torch.evaluation.oracle import make_oracle
    from tpu_plume_torch.train.ppo_trainer import make_policy_model

    draws = ev.draw_eval(torch.Generator().manual_seed(11), cfg.env,
                         cfg.env.max_steps, n)
    out = []
    for dev in ("cpu", "cuda"):
        model = make_policy_model(cfg)
        model.load_state_dict(state_dict)
        out.append([x.cpu() for x in dagger._collect(
            model.to(dev), make_oracle("phase", cfg.env), cfg.env, n, 0.0,
            draws=draws, device=dev)])
    (_, c_labels, c_valid, c_succ, _), (_, g_labels, g_valid, g_succ, _) = out
    off = (c_labels != g_labels) | (c_valid != g_valid)
    apart = torch.nonzero(off.any(0)).flatten().tolist()
    for e in apart:
        log(f"DAgger collection card vs CPU: episode {e} parts at step "
            f"{int(off[:, e].nonzero()[0])}")
    log(f"DAgger collection card vs CPU: {n} episodes x {cfg.env.max_steps} "
        f"steps, {len(apart)} apart in labels or valid; success "
        f"{float(g_succ.float().mean()):.3f} on the card, "
        f"{float(c_succ.float().mean()):.3f} on the CPU")
    assert len(apart) <= n // 64, apart
    return dict(apart=len(apart))


def imitation_cli(cli_main, k, expert_path, tmp) -> dict:
    """The imitation commands at full width, each checked for its JSON
    line and files: ``train-bc`` (JAX's defaults) and ``eval --ckpt`` of
    its checkpoint, ``train-dagger --rounds 2``, ``train-gail
    --closed-loop --iterations 2`` and ``train --distill phase
    --iterations 1`` with their exact launch counts."""
    import torch

    out = {}
    bc_dir = os.path.join(tmp, "bc")
    out["train_bc"], wall = cli_json(cli_main, [
        "train-bc", "--expert", expert_path, "--out", bc_dir])
    log(f"cli train-bc: {wall:.2f} s, {json.dumps(out['train_bc'])}")
    summary, wall = cli_json(cli_main, ["eval", "--ckpt", bc_dir])
    out["eval_bc"] = dict(summary=summary, wall_s=wall)
    log(f"cli eval --ckpt (the BC checkpoint): {wall:.2f} s, "
        f"{json.dumps(summary)}")
    summary, wall = cli_json(cli_main, [
        "train-dagger", "--rounds", "2", "--out", os.path.join(tmp, "dag")])
    assert len(summary["rollout_success"]) == 2, summary
    out["train_dagger"] = dict(summary=summary, wall_s=wall)
    log(f"cli train-dagger --rounds 2: {wall:.2f} s, {json.dumps(summary)}")
    for name, argv, iters in (
            ("train_gail", ["train-gail", "--closed-loop", "--expert",
                            expert_path], 2),
            ("train_distill", ["train", "--distill", "phase"], 1)):
        run_dir = os.path.join(tmp, name)
        zero_counts(k)
        summary, wall = cli_json(cli_main, [
            *argv, "--iterations", str(iters), "--minibatch", str(MAIN_MB),
            "--out", run_dir])
        counts = read_counts(k)
        want = dict.fromkeys(KERNEL_NAMES, 0)
        want.update(plume_sample=1, env_step=iters * 128)
        assert counts == want, (name, counts, want)
        out[name] = dict(summary=summary, wall_s=wall, launches=counts)
        log(f"cli {' '.join(argv[:2])} --iterations {iters}: {wall:.2f} s, "
            f"launches {counts}, {json.dumps(summary)}")
    ckpt = torch.load(os.path.join(tmp, "train_gail", "checkpoint.pt"),
                      weights_only=True)
    assert {"model", "disc_model", "curriculum", "config"} == set(ckpt)
    for name in ("ppo_gail.pth", "discriminator.pth"):
        assert os.path.isfile(os.path.join(tmp, "train_gail", "model", name))
    return out


def imitation(m, v20, expert_path) -> dict:
    """The imitation phase (slice 10) at full width: distilled PPO (f32,
    and with ``fused_update``, which takes autodiff), its labels on the
    card against the CPU; closed-loop GAIL with the fused update off and
    on, a small GAIL iteration against the CPU; BC and DAgger on the
    phase oracle's expert file ``expert_path``, DAGGER_ROUNDS DAgger
    rounds and one round's collection against the CPU, 2 rounds of
    sequence DAgger; the imitation CLI."""
    import torch

    from tpu_plume_torch.train import bc, dagger
    from tpu_plume_torch.train import gail_trainer as tgail
    from tpu_plume_torch.data.expert import load_expert_data

    ttrain, k = m.ttrain, m.k
    out = {}
    for label, kw in (("distill", {}),
                      ("distill fused_update", dict(fused_update=True))):
        cfg = imitation_cfg(v20, distill_oracle="phase", **kw)
        run = run_main_path(ttrain, m.rollout.rollout_chunk, k, label, cfg,
                            iters=IMIT_ITERS, profile=not kw)
        log(f"main path {label}: loss/distill "
            f"{run['losses']['loss/distill']:.5f}, loss/total "
            f"{run['losses']['loss/total']:.5f}")
        if not kw:
            run["card_vs_cpu"] = labels_against_cpu(ttrain, m.rollout, cfg,
                                                    run["model"])
        del run["model"]
        out[label] = run
        torch.cuda.empty_cache()
    check_small_iteration_against_cpu(m.get_preset, m.RolloutConfig, ttrain,
                                      m.draw_chunk, k, gail=True)
    states, actions = load_expert_data(expert_path)
    expert = (torch.from_numpy(states).cuda(),
              torch.from_numpy(actions).cuda())
    for label, kw in (("f32", {}), ("fused_update",
                                    dict(fused_update=True))):
        out[f"gail {label}"] = run_gail_path(k, ttrain, tgail, label,
                                             imitation_cfg(v20, **kw), expert,
                                             expert_path)
        torch.cuda.empty_cache()
    del expert
    out["dagger"], res = run_dagger(k, dagger, bc, "mlp", v20,
                                    DAGGER_ROUNDS, DAGGER_EPISODES)
    out["dagger"]["card_vs_cpu"] = collection_against_cpu(
        dagger, v20, res.state_dict, DAGGER_EPISODES)
    seq = v20.replace(
        env=dataclasses.replace(v20.env, max_steps=SEQ_DAGGER_STEPS),
        ppo=dataclasses.replace(v20.ppo, arch="lstm", lstm_layer_norm=True))
    out["dagger lstm"], _ = run_dagger(
        k, dagger, bc, "lstm (LayerNorm cell)", seq,
        SEQ_DAGGER["rounds"], SEQ_DAGGER["episodes_per_round"],
        epochs_per_round=SEQ_DAGGER["epochs_per_round"])
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        out["cli"] = imitation_cli(m.cli_main, k, expert_path, tmp)
    return out


def stop_lstm_phases(ttrain, ev, k, cli_main, cfg, phase_done) -> tuple:
    """Phases 9 and 10 on ``cfg`` (ppo_v2_0 at full width): the learning
    check with the trajectory capture, then the stop LSTMs trained on its
    captured episodes, their gated evals and their CLI.  Returns the
    learning record, the stop LSTMs' (the capture's under ``capture``) and
    the trained policy."""
    with tempfile.TemporaryDirectory() as tmp:
        learn_dir = os.path.join(tmp, "learn")
        learning, learn_res, trained = learning_check(ttrain, ev, k, cfg,
                                                      learn_dir)
        phase_done("learning check")
        stop_lstm, ckpts = stop_lstm_phase(ev, k, cfg, trained, learn_res,
                                           tmp)
        stop_lstm["cli"] = check_stop_cli(cli_main, learn_dir, ckpts, tmp)
    stop_lstm["capture"] = learning["capture"]
    phase_done("stop LSTMs")
    return learning, stop_lstm, trained


def run_only(only, m, v20, wl, phase_done) -> None:
    """``--only guide``: the guide's phases alone (the executed-action
    mode's parity and times, the guided training paths, the learning
    check for a trained policy, the fit check and four guided evals: the
    trained and the untrained ppo_v2_0 params, the guided wrf_les path's
    and the untrained wrf_les params, the trained ones' first episodes
    also on the CPU, and the guided CLI); ``--only stop-lstm``: phases 9
    and 10; ``--only eval-guides``: the learning check and phase 12;
    ``--only imitation``: phase 13 on an expert file of its own; ``--only
    flux``: the learning check and phase 14; ``--only scale-out``: phase
    15; ``--only bank-step``: the bank step kernel's checks and times, and
    the wrf_les_3d and static-bank main paths; ``--only lstm-step``: the
    LSTM step kernels' checks and times.  Each prints its JSON record."""
    if only == "lstm-step":
        out = {"parity": check_lstm_kernels(m.lstm_ops, m.recurrent),
               "time": time_lstm_kernels(m.lstm_ops, m.recurrent)}
        phase_done("lstm step kernels")
        log(json.dumps({"lstm_kernels": out}))
        return
    if only == "stop-lstm":
        _, stop_lstm, _ = stop_lstm_phases(m.ttrain, m.ev, m.k, m.cli_main,
                                           v20, phase_done)
        log(json.dumps({"stop_lstm": stop_lstm}))
        return
    if only == "eval-guides":
        with tempfile.TemporaryDirectory() as tmp:
            _, _, trained = learning_check(m.ttrain, m.ev, m.k, v20,
                                           os.path.join(tmp, "learn"))
            phase_done("learning check")
            out = eval_guides(m.ev, m.k, m.ttrain, m.gridded, m.get_preset,
                              m.cli_main, v20, trained, tmp)
        phase_done("eval guides")
        log(json.dumps({"eval_guides": out}, default=str))
        return
    if only == "flux":
        with tempfile.TemporaryDirectory() as tmp:
            _, _, trained = learning_check(m.ttrain, m.ev, m.k, v20,
                                           os.path.join(tmp, "learn"))
        phase_done("learning check")
        out = flux_phase(m, trained)
        phase_done("flux")
        log(json.dumps({"flux": out}, default=str))
        return
    if only == "scale-out":
        w3 = m.get_preset("wrf_les_3d")
        w3 = w3.replace(ppo=dataclasses.replace(w3.ppo,
                                                minibatch_size=MAIN_MB))
        scale_out_phase(m, v20, w3)
        phase_done("scale-out")
        return
    if only == "bank-step":
        import torch

        out = {"parity": check_bank_step_kernel(m.get_preset, m.gridded,
                                                m.plume, m.rollout),
               "time": time_bank_step_kernel(m.get_preset, m.gridded,
                                             m.k.gather, m.plume, m.rollout)}
        phase_done("bank step kernel")
        w3 = m.get_preset("wrf_les_3d")
        w3 = w3.replace(ppo=dataclasses.replace(w3.ppo,
                                                minibatch_size=MAIN_MB))
        st = v20.replace(env=dataclasses.replace(
            v20.env, plume_model="gridded", subcell_sampling=True))
        for label, cfg, bank, iters in (
                ("wrf_les_3d", w3, main_bank(m.gridded, w3.env), 3),
                ("static_subcell", st, m.gridded.synthesize_bank(
                    torch.Generator(device="cuda").manual_seed(0), st.env,
                    num_fields=64), 2)):
            run = run_main_path(m.ttrain, m.rollout.rollout_chunk, m.k, label,
                                cfg, bank, iters=iters)
            out[label] = {key: run[key] for key in (
                "counts", "sps", "whole_ms", "busy", "busy_unprofiled",
                "rollout", "gae", "update", "max_memory_allocated")}
            out[label]["rollout_launches_per_step"] = (
                run["rollout_profile"]["launches_per_step"])
            del bank, run
            torch.cuda.empty_cache()
        phase_done("bank main paths")
        log(json.dumps({"bank_step": out}, default=str))
        return
    if only == "imitation":
        with tempfile.TemporaryDirectory() as tmp:
            expert_file(m.cli_main, tmp)
            out = imitation(m, v20, os.path.join(tmp, "expert_data.npz"))
        phase_done("imitation")
        log(json.dumps({"imitation": out}, default=str))
        return
    out = {"exec_parity": check_env_step_exec(m.get_preset, m.plume,
                                              m.rollout)}
    out["exec_time"] = {str(n): row for n, row in time_env_step_exec(
        m.get_preset, m.plume, m.rollout).items()}
    phase_done("exec")
    out["training"], models = guided_training(
        m.ttrain, m.rollout, m.k, (("ppo_v2_0", v20), ("wrf_les", wl)))
    phase_done("guided training")
    with tempfile.TemporaryDirectory() as tmp:
        _, _, trained = learning_check(m.ttrain, m.ev, m.k, v20,
                                       os.path.join(tmp, "learn"))
    phase_done("learning check")
    untrained = {cfg.name: m.ttrain.make_train_state(cfg, "cuda",
                                                     cfg.seed)[0]
                 for cfg in (v20, wl)}
    out["evals"], out["fit_card_vs_cpu"] = guided_evals(m.ev, m.k,
                                                        m.get_preset, (
        ("A trained", v20, trained, GUIDE_CPU_EPISODES["ppo_v2_0"]),
        ("A untrained", v20, untrained["ppo_v2_0"], 0),
        ("wrf_les guided-training policy", wl, models["wrf_les"],
         GUIDE_CPU_EPISODES["wrf_les"]),
        ("wrf_les untrained", wl, untrained["wrf_les"], 0)))
    phase_done("guided evals")
    with tempfile.TemporaryDirectory() as tmp:
        out["eval_guides"] = eval_guides(m.ev, m.k, m.ttrain, m.gridded,
                                         m.get_preset, m.cli_main, v20,
                                         trained, tmp)
    phase_done("eval guides")
    out["cli"] = {}
    run_cli(m.cli_main, m.ActorCritic, "ppo_v2_0", MAIN_D, MAIN_A,
            then=lambda tmp: out["cli"].update(check_guide_cli(m.cli_main,
                                                               tmp)))
    run_cli(m.cli_main, m.ActorCritic, "ppo_v2_0", MAIN_D, MAIN_A,
            "--train-guide", "fit", "--min-radius", "50", "--terminal-gate",
            "40")
    phase_done("cli")
    log(json.dumps({"guide": out}, default=str))


FLUX_EPISODES, FLUX_STEPS = 64, 500   # RESULTS.md's round-5 protocol
FLUX_REFINE_STEPS = 100
FLUX_POS_LIMIT, FLUX_Q_RTOL = 0.05, 1e-3      # px; an episode's estimates
FLUX_STAGE_RTOL = 1e-2        # a replayed stage's strengths
# A replayed EM or log-Gaussian fit parts from the CPU's beyond
# FLUX_POS_LIMIT px (FLUX_STAGE_RTOL in its strengths) only within
# SENSITIVITY_FACTOR times the fit's own sensitivity on the CPU to an fp32
# ulp of noise on the concentrations (a near-flat fit, beta3 ~ 0, amplifies
# rounding: 1.38 px on the anisotropic plume on an NVIDIA H100 80GB HBM3,
# 700.00 W), or where its ``ok`` gate flipped within rounding of a bound:
# |beta3| or |mu_rel| - 2 within these.
FLUX_BETA3_MARGIN, FLUX_MU_REL_MARGIN = 1e-3, 1e-2
FLUX_GAIN_RTOL = 1e-5         # an LM take flip within this x the data's SSE
# The phase's studies: label -> (preset, env overrides, survey, refine
# steps); every one with estimated positions.  The policy's survey runs
# through ``cli flux --ckpt`` (``flux_phase``).
FLUX_STUDIES = {
    "raster protocol": ("ppo_v2_0", {}, "raster", 0),
    "random": ("ppo_v2_0", {}, "random", 0),
    "two-pass": ("ppo_v2_0", {}, "raster", FLUX_REFINE_STEPS),
    "anisotropic": ("wrf_les", {}, "raster", 0),
    "3-D": ("ppo_v2_0", {"env_3d": True}, "random", 0),
}


def flux_env(get_preset, preset, overrides):
    return dataclasses.replace(get_preset(preset).env, num_sources=3,
                               **overrides)


def flux_oracle(cfg, survey, refine):
    """``cli flux``'s raster surveyor (its bands widened for a two-pass
    survey), or None."""
    from tpu_plume_torch.cli.main import raster_band_scale
    from tpu_plume_torch.evaluation.oracle import make_oracle

    if survey != "raster":
        return None
    return make_oracle("raster", cfg, raster_band_scale=raster_band_scale(
        cfg, FLUX_STEPS, refine))


def flux_parts(ev, flux, cfg, draws, device, policy, oracle, refine):
    """The study's survey and scores on ``device`` from ``draws``, with the
    estimator's decisions recorded."""
    _, policy, _, draws, state, obs = ev._start(
        policy, cfg, device, None, draws, FLUX_EPISODES, FLUX_STEPS, False,
        None, None)
    survey = flux.fly_survey(cfg, state, obs, draws, FLUX_STEPS,
                             policy=policy, oracle=oracle,
                             refine_steps=refine)
    record = {}
    scores = flux.score_survey(survey, cfg, True, record=record)
    return survey, [x.cpu() for x in scores], {
        key: ([x.cpu() for x in v] if isinstance(v, list) else v.cpu())
        for key, v in record.items()}


def flux_decisions_apart(ep, got, want) -> list:
    """The decisions of episode ``ep`` that part between two records, each
    with its margins on both sides (the winning sample's lead, beta3 and
    |mu_rel| - 2 of each fit, the residual peak over its bound, the SSE
    gain of each LM step, the sectors hit)."""
    out = []
    pairs = (("pick", "pick_gap"), ("reseat", "reseat_margin"),
             ("take", "sse_gain"), ("good", "hits"))
    for key, margin in pairs:
        if key in got and not bool((got[key][ep] == want[key][ep]).all()):
            out.append(dict(decision=key, card=got[key][ep].tolist(),
                            cpu=want[key][ep].tolist(),
                            margin_card=got[margin][ep].tolist(),
                            margin_cpu=want[margin][ep].tolist()))
    for i, (a, b) in enumerate(zip(got.get("ok", []), want.get("ok", []))):
        if not bool((a[ep] == b[ep]).all()):
            out.append(dict(decision=f"ok[{i}]", card=a[ep].tolist(),
                            cpu=b[ep].tolist(),
                            beta3_card=got["beta3"][i][ep].tolist(),
                            beta3_cpu=want["beta3"][i][ep].tolist(),
                            mu_rel_minus_2_card=(got["mu_rel_norm"][i][ep]
                                                 - 2).tolist(),
                            mu_rel_minus_2_cpu=(want["mu_rel_norm"][i][ep]
                                                - 2).tolist()))
    return out


def flux_replay(flux, points, concs, cfg, seeds=None) -> dict:
    """Episode ``points`` f32[T, 2] / ``concs`` f32[T] replayed stage by
    stage, each stage on the card given the CPU's inputs to it: the greedy
    picks equal, each fit's EM candidates (from the same candidates) and
    its fit (from the CPU's EM candidates) within FLUX_POS_LIMIT px and
    FLUX_STAGE_RTOL or SENSITIVITY_FACTOR times the fit's own sensitivity
    to an ulp of noise, but where its ``ok`` gate flipped within rounding
    (FLUX_BETA3_MARGIN, FLUX_MU_REL_MARGIN; logged), each
    LM step within FLUX_POS_LIMIT px unless its take decision flipped
    within FLUX_GAIN_RTOL of the data's SSE, the coverage gate equal.
    Returns each stage's largest position gap."""
    import torch

    p, c = points[None].cpu(), concs[None].cpu()
    s = cfg.num_sources
    gaps = {}

    def both(fn, *args):
        want = fn(*args)
        got = fn(*(a.cuda() if torch.is_tensor(a) else a for a in args))
        return got, want

    def refine(pp, cc, kk, em_iters):
        rec = {}
        m, q = flux.refine_positions(pp, cc, kk, cfg, em_iters=em_iters,
                                     return_strengths=True, record=rec)
        return m.cpu(), q.cpu(), {k: v[0][0].cpu() for k, v in rec.items()}

    def limits(peaks, em_iters, want):
        """Per candidate, SENSITIVITY_FACTOR x the CPU fit's largest change
        under SENSITIVITY_DRAWS ulps of noise on the concentrations: of
        the EM's candidate, the position and the strength (relative)."""
        g = torch.Generator().manual_seed(0)
        em = pos = qr = torch.zeros(s)
        for _ in range(SENSITIVITY_DRAWS):
            noise = 1 + FP32_EPS * (2 * torch.randint(0, 2, c.shape,
                                                      generator=g) - 1)
            m, q, rec = refine(p, c * noise, peaks, em_iters)
            em = torch.maximum(em, (rec["em_peaks"] - want[2]["em_peaks"]
                                    ).abs().amax(-1))
            pos = torch.maximum(pos, (m - want[0])[0].abs().amax(-1))
            qr = torch.maximum(qr, ((q - want[1]).abs()
                                    / want[1].abs().clamp(min=1e-6))[0])
        return tuple(torch.clamp(SENSITIVITY_FACTOR * x, min=floor)
                     for floor, x in ((FLUX_POS_LIMIT, em),
                                      (FLUX_POS_LIMIT, pos),
                                      (FLUX_STAGE_RTOL, qr)))

    def fit(name, peaks, em_iters):
        """The EM from the same candidates, then the fit on the card from
        the CPU's EM candidates, each against the CPU's."""
        want = refine(p, c, peaks, em_iters)
        em_limit, pos_limit, q_limit = limits(peaks, em_iters, want)
        got_em = refine(p.cuda(), c.cuda(), peaks.cuda(), em_iters)[2][
            "em_peaks"]
        got = refine(p.cuda(), c.cuda(), want[2]["em_peaks"][None].cuda(), 0)
        em_gap = (got_em - want[2]["em_peaks"]).abs().amax(-1)
        gaps[name + " em"] = float(em_gap.max())
        gaps[name] = float((got[0] - want[0]).abs().max())
        assert bool((em_gap <= em_limit).all()), (name, em_gap, em_limit)
        near = ((got[2]["beta3"].abs() <= FLUX_BETA3_MARGIN)
                | ((got[2]["mu_rel_norm"] - 2).abs() <= FLUX_MU_REL_MARGIN))
        flipped = (got[2]["ok"] != want[2]["ok"]) & near
        keys = ("ok", "beta3", "mu_rel_norm")
        if bool(flipped.any()) or gaps[name] > FLUX_POS_LIMIT:
            log(f"flux replay {name}: position gap {gaps[name]:.3e} px "
                f"(limits {pos_limit.tolist()}), ok flipped within rounding "
                f"at {flipped.nonzero().flatten().tolist()}; card "
                f"{ {k: got[2][k].tolist() for k in keys} }, CPU "
                f"{ {k: want[2][k].tolist() for k in keys} }")
        keep = ~flipped
        pos_gap = (got[0][0] - want[0][0]).abs().amax(-1)[keep]
        q_gap = ((got[1][0] - want[1][0]).abs()
                 / want[1][0].abs().clamp(min=1e-6))[keep]
        assert bool((pos_gap <= pos_limit[keep]).all()), (name, pos_gap,
                                                           pos_limit)
        q_abs = (got[1][0] - want[1][0]).abs()[keep]
        assert bool(((q_gap <= q_limit[keep]) | (q_abs <= 1e-6)).all()), (
            name, q_gap, q_limit)
        # the later stages start from the CPU's estimate
        return want[0], want[1]

    if seeds is not None:
        fit("refine", seeds[None].cpu(), 0)
        return gaps
    radius = 3.0 * cfg.plume_sigma
    gp, peaks = both(lambda pp, cc: flux._greedy_peaks(pp, cc, s, radius,
                                                       None), p, c)
    assert torch.equal(gp.cpu(), peaks), (gp, peaks)
    m, q = fit("refine", peaks, 8)
    if cfg.plume_model != "isotropic":
        return gaps
    m, q = fit("reseat", flux._reseat_seeds(p, c, m, q, cfg, None), 0)
    cd = torch.clamp(c - cfg.turbulence_intensity * (0.7978845608 + 0.1),
                     min=0.0)
    sse_scale = float(((c < 0.95 * cfg.conc_peak) * cd ** 2).sum())
    for step in range(8):
        record = {}
        (gm, _), (m1, q1) = both(
            lambda pp, cc, mm, qq: flux.joint_refine(
                pp, cc, mm, qq, cfg, iters=1, record=record), p, c, m, q)
        gap = float((gm.cpu() - m1).abs().max())
        gain = float(record["sse_gain"][0, 0])
        gaps[f"lm{step}"] = gap
        flip_ok = abs(gain) <= FLUX_GAIN_RTOL * sse_scale
        assert gap <= FLUX_POS_LIMIT or flip_ok, (step, gap, gain, sse_scale)
        m, q = m1, q1
    gg, good = both(lambda pp, cc, mm: flux._coverage_good(pp, cc, mm, cfg,
                                                           None), p, c, m)
    assert torch.equal(gg.cpu(), good), (gg, good)
    return gaps


def flux_against_cpu(ev, flux, label, cfg, draws, policy, oracle,
                     refine) -> dict:
    """The study's survey and scores on the card and on the CPU from the
    same draws.  At most one episode in 64 whose flight parts (a position
    beyond the env tolerance RTOL / ATOL at some step: the card's positions
    differ from the CPU's in the last bits, the plume kernel's TKE
    rounding carried into the turbulence displacement); a two-pass
    survey's second pass chases each episode's pass-1 estimates, so where
    those part beyond FLUX_POS_LIMIT (each
    replayed stage by stage, ``flux_replay``) its second pass may part
    too, and is logged.  On the episodes whose flights agree: estimated
    positions within FLUX_POS_LIMIT px and strengths within FLUX_Q_RTOL of
    the CPU's, or else replayed stage by stage; observed flags equal; each
    decision that parts logged with its margins."""
    import copy

    import torch

    cpu_policy = None if policy is None else copy.deepcopy(policy).cpu()
    sv_c, sc_c, rec_c = flux_parts(ev, flux, cfg, draws, "cpu", cpu_policy,
                                   oracle, refine)
    sv_g, sc_g, rec_g = flux_parts(ev, flux, cfg, draws, "cuda", policy,
                                   oracle, refine)
    step_same = torch.isclose(sv_g.points.cpu(), sv_c.points, rtol=RTOL,
                              atol=ATOL).all(-1)                 # [N, T]
    if cfg.env_3d:
        step_same &= torch.isclose(sv_g.z.cpu(), sv_c.z, rtol=RTOL,
                                   atol=ATOL)
    t1 = FLUX_STEPS - refine
    same1 = step_same[:, :t1].all(-1)
    same = step_same.all(-1)
    seeds_apart, seed_replays = [], {}
    if refine:
        seed_gap = (sv_g.seeds.cpu() - sv_c.seeds).abs().amax((1, 2))
        seeds_apart = ((seed_gap > FLUX_POS_LIMIT) & same1).nonzero(
            ).flatten().tolist()
        for ep in seeds_apart:
            seed_replays[ep] = flux_replay(flux, sv_c.points[ep, :t1],
                                           sv_c.concs[ep, :t1], cfg)
    apart = [ep for ep in (~same).nonzero().flatten().tolist()
             if ep not in seeds_apart]
    excused = [ep for ep in seeds_apart if not bool(same[ep])]
    pos_gap = (sc_g[2] - sc_c[2]).abs().amax((1, 2))
    q_ok = torch.isclose(sc_g[0], sc_c[0], rtol=FLUX_Q_RTOL,
                         atol=1e-6).all(-1)
    parted = (same & ~((pos_gap <= FLUX_POS_LIMIT) & q_ok)).nonzero(
        ).flatten().tolist()
    decisions, replays = {}, {}
    for ep in same.nonzero().flatten().tolist():
        d = flux_decisions_apart(ep, rec_g, rec_c)
        if d:
            decisions[ep] = d
            log(f"flux {label} card vs CPU: episode {ep} decisions apart: "
                + json.dumps(d))
    for ep in parted:
        replays[ep] = flux_replay(
            flux, sv_c.points[ep], sv_c.concs[ep], cfg,
            None if sv_c.seeds is None else sv_c.seeds[ep])
    obs_apart = ((sc_g[4] != sc_c[4]).any(-1) & same).nonzero().flatten()
    summary_cpu = flux.summarize_flux(*sc_c, True)
    max_gap = float(pos_gap[same].max()) if bool(same.any()) else 0.0
    log(f"flux {label} card vs CPU, {FLUX_EPISODES} episodes x {FLUX_STEPS} "
        f"steps: flights apart {apart}"
        + (f"; pass-1 estimates beyond {FLUX_POS_LIMIT} px {seeds_apart} "
           f"(replayed, largest stage gaps "
           f"{ {ep: max(g.values()) for ep, g in seed_replays.items()} }), "
           f"of which their second pass parted {excused}" if refine else "")
        + f"; of the agreeing flights, estimates beyond {FLUX_POS_LIMIT} px "
        f"/ rtol {FLUX_Q_RTOL}: {parted} (largest position gap "
        f"{max_gap:.3e} px), each replayed stage by stage within the limits "
        f"(largest stage gaps "
        f"{ {ep: max(g.values()) for ep, g in replays.items()} }); "
        f"{len(decisions)} episodes with a decision apart; CPU summary "
        + json.dumps(summary_cpu))
    assert len(apart) <= FLUX_EPISODES // 64, (label, apart)
    assert len(obs_apart) == 0, (label, obs_apart)
    return dict(flights_apart=apart, pass1_estimates_apart=seeds_apart,
                pass2_apart_by_estimates=excused, estimates_apart=parted,
                max_pos_gap=max_gap, decisions_apart=decisions,
                replay_gaps=replays, pass1_replay_gaps=seed_replays,
                summary_cpu=summary_cpu)


def flux_study(ev, k, flux, label, cfg, policy=None, oracle=None,
               refine=0) -> dict:
    """One flux study on the card (``flux_inversion_study``, estimated
    positions; ``flux_phase`` warms up once): the whole study with every
    launch count set to 0 just before it and read just after (one plume-sample
    launch a survey step plus the reset's, nothing else), its wall ms;
    then the same study cut to its first EVAL_PROFILE_STEPS steps (one
    pass) unprofiled and under the profiler, for its launches per survey
    step and the device's busy share; then on the card against the CPU
    (``flux_against_cpu``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    draws = ev.draw_eval(torch.Generator(device="cuda").manual_seed(11),
                         cfg, FLUX_STEPS, FLUX_EPISODES, greedy=False)

    def run(steps, refine_steps):
        cut = draws if steps == FLUX_STEPS else dataclasses.replace(
            draws, turb_noise=draws.turb_noise[:steps],
            gumbel=draws.gumbel[:steps])
        return flux.flux_inversion_study(
            cfg, num_episodes=FLUX_EPISODES, num_steps=steps, policy=policy,
            estimated_positions=True, oracle=oracle,
            refine_steps=refine_steps, draws=cut, device="cuda")

    zero_counts(k)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    summary = run(FLUX_STEPS, refine)
    wall = time.perf_counter() - t0
    counts = read_counts(k)
    want = dict.fromkeys(KERNEL_NAMES, 0)
    want["plume_sample"] = FLUX_STEPS + 1
    assert counts == want, (label, counts, want)
    assert summary["episodes"] == FLUX_EPISODES and all(
        math.isfinite(summary[key]) for key in (
            "observed_frac", "mean_pos_error", "within_20pct")), summary
    steps = EVAL_PROFILE_STEPS
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run(steps, 0)
    short_wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run(steps, 0)
        torch.cuda.synchronize()
    kernels = device_kernels(prof)
    launches = sum(e.count for e in kernels)
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: -e.count)[:8]
    out = dict(summary=summary, wall_ms=wall * 1e3, launches=counts,
               profiled_steps=steps, launches_per_step=launches / steps,
               device_ms=device_ms, busy=device_ms / (short_wall * 1e3),
               top_kernels={e.key[:120]: e.count for e in top})
    log(f"flux {label}: {cfg.plume_model}{' 3-D' if cfg.env_3d else ''}, "
        f"{FLUX_EPISODES} episodes x {FLUX_STEPS} steps"
        f"{f' ({refine} of them pass 2)' if refine else ''}: wall "
        f"{wall * 1e3:.1f} ms; launches "
        f"{ {name: c for name, c in counts.items() if c} }; its first "
        f"{steps} steps as a study of their own: {launches} device launches "
        f"= {launches / steps:.2f} per survey step, device kernels "
        f"{device_ms:.2f} ms = busy share {out['busy']:.4f} of their "
        f"unprofiled wall ({short_wall * 1e3:.1f} ms); the most launched "
        f"kernels {out['top_kernels']}; summary " + json.dumps(summary))
    out["card_vs_cpu"] = flux_against_cpu(ev, flux, label, cfg, draws,
                                          policy, oracle, refine)
    return out


def flux_phase(m, trained) -> dict:
    """Phase 14: the flux studies of FLUX_STUDIES (``flux_study``), then a
    survey flown by ``trained`` (the learning check's ppo_v2_0 MLP,
    Gumbel-sampled) through ``cli flux --ckpt`` with exact launches, and
    the same survey on the card against the CPU.  The raster protocol must
    reach JAX's own thresholds (``tests/test_flux.py:153-155``):
    within_20pct >= 0.75 and observed_frac >= 0.95."""
    import torch

    from tpu_plume_torch.evaluation import flux

    out = {}
    warm = flux_env(m.get_preset, "ppo_v2_0", {})
    flux.flux_inversion_study(warm, torch.Generator(device="cuda"),
                              num_episodes=FLUX_EPISODES,
                              num_steps=EVAL_WARMUP, estimated_positions=True,
                              device="cuda")
    for label, (preset, overrides, survey, refine) in FLUX_STUDIES.items():
        cfg = flux_env(m.get_preset, preset, overrides)
        out[label] = flux_study(m.ev, m.k, flux, label, cfg,
                                oracle=flux_oracle(cfg, survey, refine),
                                refine=refine)
        torch.cuda.empty_cache()
    proto = out["raster protocol"]["summary"]
    assert proto["within_20pct"] >= 0.75 and proto["observed_frac"] >= 0.95, (
        proto)
    v20 = m.get_preset("ppo_v2_0")
    with tempfile.TemporaryDirectory() as tmp:
        m.ttrain.save_checkpoint(tmp, v20, {
            key: v.cpu() for key, v in trained.state_dict().items()})
        zero_counts(m.k)
        summary, wall = cli_json(m.cli_main, [
            "flux", "--ckpt", tmp, "--estimated", "--sources", "3",
            "--steps", str(FLUX_STEPS), "--episodes", str(FLUX_EPISODES)])
        counts = read_counts(m.k)
    want = dict.fromkeys(KERNEL_NAMES, 0)
    want["plume_sample"] = FLUX_STEPS + 1
    assert counts == want, (counts, want)
    cfg = flux_env(m.get_preset, "ppo_v2_0", {})
    draws = m.ev.draw_eval(torch.Generator(device="cuda").manual_seed(12),
                           cfg, FLUX_STEPS, FLUX_EPISODES, greedy=False)
    out["policy"] = dict(summary=summary, wall_ms=wall * 1e3,
                         launches=counts)
    log(f"cli flux --ckpt (the learning check's policy, Gumbel-sampled): "
        f"wall {wall * 1e3:.1f} ms with the policy's load; launches "
        f"{ {name: c for name, c in counts.items() if c} }; summary "
        + json.dumps(summary))
    out["policy"]["card_vs_cpu"] = flux_against_cpu(
        m.ev, flux, "policy", cfg, draws, trained, None, 0)
    log("flux within_20pct / observed_frac: " + ", ".join(
        f"{label} {r['summary']['within_20pct']:.4f} / "
        f"{r['summary']['observed_frac']:.4f}" for label, r in out.items()))
    return out


# Phase 15: the train flags and data parallel.  Each resume case runs
# SCALE_ITERS iterations uninterrupted, then the run killed after its
# snapshot at SCALE_SYNC iterations, resumed to SCALE_ITERS; the CLI's
# --profile-steps run is cut to SCALE_CLI_ENVS envs x SCALE_CLI_UNROLL steps
# in one minibatch (its trace's host events take seconds to write).
SCALE_ITERS, SCALE_SYNC = 4, 2
SCALE_CLI_ENVS, SCALE_CLI_UNROLL = 1024, 32
DRAIN_ITERS = 6          # iterations of each CSV / --no-csv block
GLOO_WORLD = 2
# The gloo ranks' small config: envs, steps, minibatch.
GLOO_N, GLOO_T, GLOO_MB = 256, 16, 1024


def counted(m, totals: dict, fn):
    """``fn()`` with every launch count set to 0 just before and read just
    after: (its result, its counts), the counts also added to ``totals``."""
    zero_counts(m.k)
    result = fn()
    counts = read_counts(m.k)
    for name, c in counts.items():
        totals[name] = totals.get(name, 0) + c
    return result, counts


def same_state(a, b, where="") -> list:
    """The paths where two saved states (nested dicts, tuples and tensors)
    differ, with the largest gap of each float tensor that does."""
    import torch

    if isinstance(a, torch.Tensor):
        if torch.equal(a, b):
            return []
        gap = ((a.double() - b.double()).abs().max().item()
               if a.is_floating_point() else "ints")
        return [f"{where} {gap}"]
    if isinstance(a, dict):
        if a.keys() != b.keys():
            return [f"{where} keys"]
        return [d for k in a for d in same_state(a[k], b[k], f"{where}/{k}")]
    if isinstance(a, (list, tuple)):
        return [d for i, (x, y) in enumerate(zip(a, b))
                for d in same_state(x, y, f"{where}[{i}]")]
    return [] if a == b else [f"{where} {a!r} != {b!r}"]


def resume_case(m, totals, label, cfg, bank=None) -> dict:
    """``label`` uninterrupted for SCALE_ITERS iterations (sync_every
    SCALE_SYNC) against the same run killed after its snapshot at
    SCALE_SYNC iterations (``snapshot_every``) and resumed from
    ``checkpoint_iter{SCALE_SYNC}`` to SCALE_ITERS: params, optimizer
    state, rollout carry, generator, counters, curriculum and
    ``training_results.csv`` must be equal."""
    import torch

    kw = dict(device="cuda", verbose=False, sync_every=SCALE_SYNC, bank=bank)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        full, part = os.path.join(tmp, "full"), os.path.join(tmp, "part")

        def runs():
            a = m.ttrain.train_ppo(cfg, full, max_iterations=SCALE_ITERS,
                                   **kw)
            m.ttrain.train_ppo(cfg, part, max_iterations=SCALE_SYNC,
                               snapshot_every=SCALE_SYNC, **kw)
            b = m.ttrain.train_ppo(cfg, part, max_iterations=SCALE_ITERS,
                                   resume_from=os.path.join(
                                       part, f"checkpoint_iter"
                                       f"{SCALE_SYNC:06d}"), **kw)
            return a, b

        (a, b), counts = counted(m, totals, runs)
        bundles = [torch.load(os.path.join(d, "checkpoint.pt"),
                              weights_only=True) for d in (full, part)]
        csvs = []
        for d in (full, part):
            with open(os.path.join(d, "training_results.csv")) as fh:
                csvs.append(fh.read())
    apart = same_state(*bundles, "bundle")
    if csvs[0] != csvs[1]:
        apart.append("training_results.csv")
    # three init_loops, and the iterations of the full run, the killed run
    # and the resumed run
    iters = SCALE_ITERS + SCALE_SYNC + (SCALE_ITERS - SCALE_SYNC)
    want = {name: 3 * c for name, c in expected_init_counts(cfg,
                                                            bank).items()}
    for name, c in expected_counts(cfg, bank, iters).items():
        want[name] += c
    out = dict(episodes=a.episodes, rows=csvs[0].count("\n") - 1,
               apart=apart, launches=counts,
               seconds=round(time.perf_counter() - t0, 1))
    log(f"resume {label}: {SCALE_ITERS} iterations against {SCALE_SYNC} + "
        f"resumed {SCALE_ITERS - SCALE_SYNC}: {a.episodes} / {b.episodes} "
        f"episodes, {out['rows']} CSV rows; apart: {apart or 'nothing'} "
        f"({out['seconds']} s)")
    assert not apart, (label, apart)
    assert counts == want, (label, counts, want)
    return out


def trace_events(prof_or_path) -> list:
    """The events of a Chrome trace (a file, or a profiler to export)."""
    if not isinstance(prof_or_path, str):
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            prof_or_path.export_chrome_trace(path)
            return trace_events(path)
    with open(prof_or_path) as fh:
        return json.load(fh)["traceEvents"]


def dtoh_bytes(events) -> list:
    """The byte counts of the trace's device-to-host copies."""
    return [int(e.get("args", {}).get("bytes", -1)) for e in events
            if e.get("cat") == "gpu_memcpy" and "DtoH" in e.get("name", "")]


def drain_check(m, totals, cfg) -> dict:
    """The packed drain of a full-width ppo_v2_0 run with the CSV on:
    profiled (device activity), its device-to-host copies against the same
    run's with ``--no-csv``.  Each window's one stats transfer must carry
    the window's compacted record rows (``hostsync.drain_window_rows``)
    with the CSV: the CSV run's copies are the no-CSV run's with each
    window's stats copy grown by the count and ``10 x cap`` f32 rows, and
    none added.  Then the iteration ms with and without the CSV in
    alternating blocks (CSV, no-CSV, no-CSV, CSV)."""
    import collections

    import torch
    from torch.profiler import ProfilerActivity, profile

    windows = SCALE_ITERS // SCALE_SYNC
    n = cfg.rollout.num_envs
    cap = 2 * n * SCALE_SYNC
    rows_bytes = 4 * (1 + (len(m.ttrain.REC_KEYS) - 1) * cap)
    copies = {}

    def profiled(csv_on):
        with tempfile.TemporaryDirectory() as tmp:
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                m.ttrain.train_ppo(cfg, tmp, device="cuda", verbose=False,
                                   max_iterations=SCALE_ITERS,
                                   sync_every=SCALE_SYNC, write_csv=csv_on)
                torch.cuda.synchronize()
            return dtoh_bytes(trace_events(prof))

    for csv_on in (True, False):
        copies[csv_on], _ = counted(m, totals, lambda: profiled(csv_on))
    added = collections.Counter(copies[True]) - collections.Counter(
        copies[False])
    gone = collections.Counter(copies[False]) - collections.Counter(
        copies[True])
    out = dict(windows=windows, cap=cap, dtoh_csv=len(copies[True]),
               dtoh_no_csv=len(copies[False]), csv_only=dict(added),
               no_csv_only=dict(gone))
    log(f"packed drain: {SCALE_ITERS} iterations in {windows} windows: "
        f"Memcpy DtoH with the CSV {len(copies[True])}, with --no-csv "
        f"{len(copies[False])}; copies (bytes: count) only with the CSV "
        f"{dict(added)}, only without {dict(gone)} (the rows add "
        f"{rows_bytes} B to a window's stats copy)")
    assert len(copies[True]) == len(copies[False]), copies
    assert sum(added.values()) == sum(gone.values()) == windows, (added, gone)
    assert sorted(added.elements()) == sorted(
        b + rows_bytes for b in gone.elements()), (added, gone)
    ms = {True: [], False: []}
    for csv_on in (True, False, False, True):
        def block():
            with tempfile.TemporaryDirectory() as tmp:
                return m.ttrain.train_ppo(
                    cfg, tmp, device="cuda", verbose=False,
                    max_iterations=DRAIN_ITERS, sync_every=SCALE_SYNC,
                    write_csv=csv_on)
        res, _ = counted(m, totals, block)
        ms[csv_on].append(n * cfg.rollout.unroll_length
                          / res.steps_per_sec * 1e3)
    out.update(iteration_ms_csv=ms[True], iteration_ms_no_csv=ms[False])
    log(f"iteration ms (blocks CSV, no-CSV, no-CSV, CSV; {DRAIN_ITERS} "
        f"iterations, the first excluded): CSV {ms[True]}, --no-csv "
        f"{ms[False]}")
    return out


def flags_cli(m, totals, tmp) -> dict:
    """``cli train --profile-steps 2 --tensorboard`` (the trace must hold
    the env-step kernel's launches of the 2 traced iterations; the event
    files appear, or the line saying tensorboard does not import) and
    ``--debug-nans`` for one iteration at full width."""
    out = {}
    prof_dir = os.path.join(tmp, "prof")
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        (res, wall), counts = counted(m, totals, lambda: cli_json(
            m.cli_main, ["train", "--out", prof_dir, "--iterations", "4",
                         "--envs", str(SCALE_CLI_ENVS), "--unroll",
                         str(SCALE_CLI_UNROLL), "--minibatch",
                         str(SCALE_CLI_ENVS * SCALE_CLI_UNROLL),
                         "--profile-steps", "2", "--tensorboard"]))
    assert counts["env_step"] == 4 * SCALE_CLI_UNROLL, counts
    events = trace_events(os.path.join(prof_dir, "profile", "trace.json"))
    traced = sum(1 for e in events if e.get("cat") == "kernel"
                 and "env_step_kernel" in e.get("name", ""))
    tb = os.path.join(prof_dir, "tb")
    tb_files = sorted(os.listdir(tb)) if os.path.isdir(tb) else []
    out["profile"] = dict(env_step_in_trace=traced, events=len(events),
                          tensorboard_files=tb_files,
                          tensorboard_stderr=err.getvalue().strip(),
                          wall_s=round(wall, 1), launches=counts)
    log(f"cli train --profile-steps 2 --tensorboard: {traced} env_step "
        f"launches of {len(events)} trace events; tb: "
        f"{tb_files or err.getvalue().strip()} ({wall:.1f} s)")
    assert traced == 2 * SCALE_CLI_UNROLL, traced
    assert tb_files or "--tensorboard" in err.getvalue(), (tb_files, err)
    (res, wall), counts = counted(m, totals, lambda: cli_json(
        m.cli_main, ["train", "--out", os.path.join(tmp, "nans"),
                     "--iterations", "1", "--minibatch", str(MAIN_MB),
                     "--debug-nans"]))
    assert res["env_steps"] == 4096 * 128 and counts["env_step"] == 128, (
        res, counts)
    out["debug_nans"] = dict(wall_s=round(wall, 1), launches=counts)
    log(f"cli train --debug-nans: 1 iteration in {wall:.1f} s with the "
        f"phase checks and anomaly mode")
    return out


def mesh_steps(m, totals, cfg, mesh, iters=2) -> tuple:
    """``iters`` steps of the plain loop and of the same loop laid out on
    ``mesh``: each run's (last trajectory, last stats, params, launch
    counts), and the kernel names of the mesh run's last step, profiled."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from tpu_plume_torch.parallel import shard_loop_carry

    step = m.ttrain.build_train_step(cfg)
    runs, names = [], []

    def run(laid):
        loop = m.ttrain.init_loop(cfg, "cuda")
        if laid:
            loop = shard_loop_carry(loop, mesh)
        for _ in range(iters - 1):
            loop, stats, traj = step(loop)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            loop, stats, traj = step(loop)
            torch.cuda.synchronize()
        names.append(sorted({e.key for e in device_kernels(prof)}))
        return traj, stats, m.ttrain.cpu_state_dict(loop.model)

    for laid in (False, True):
        result, counts = counted(m, totals, lambda: run(laid))
        runs.append((*result, counts))
    return runs, names


def nccl_world_of_one(m, totals, v20) -> dict:
    """The mesh step at world size 1 through NCCL against the plain step,
    for f32 and ``fused_update``, at full width: trajectories, stats and
    params bit-equal, the same kernel launches."""
    import socket

    import torch
    import torch.distributed as dist

    from tpu_plume_torch.parallel import make_mesh

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0)
    out = {}
    try:
        mesh = make_mesh(1)
        for name, ppo in (("f32", {}), ("fused_update",
                                        dict(fused_update=True))):
            cfg = v20.replace(ppo=dataclasses.replace(v20.ppo, **ppo))
            t0 = time.perf_counter()
            runs, (pnames, names) = mesh_steps(m, totals, cfg, mesh)
            (ptraj, pstats, psd, pcounts), (mtraj, mstats, msd, mcounts) = runs
            apart = same_state(psd, msd, "params") + [
                f"traj.{f}" for f in ("action", "done", "reward", "value",
                                      "log_prob", "obs")
                if not torch.equal(getattr(ptraj, f), getattr(mtraj, f))] + [
                f"stats.{k}" for k in pstats
                if k != "grads" and float(pstats[k]) != float(mstats[k])]
            extra = sorted(set(names) - set(pnames))
            out[name] = dict(apart=apart, counts=mcounts, plain_counts=pcounts,
                             kernels_only_in_mesh_step=extra,
                             seconds=round(time.perf_counter() - t0, 1))
            log(f"mesh step at world size 1 (NCCL) {name}: apart from the "
                f"plain step: {apart or 'nothing'}; launches {mcounts} "
                f"(plain {pcounts}); device kernels of its profiled step "
                f"that the plain step's lacks: {extra}")
            assert not apart and mcounts == pcounts, (name, apart, mcounts,
                                                      pcounts)
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    return out


def gloo_cfg(get_preset, **ppo):
    v20 = get_preset("ppo_v2_0")
    return v20.replace(
        ppo=dataclasses.replace(v20.ppo, minibatch_size=GLOO_MB, **ppo),
        rollout=dataclasses.replace(v20.rollout, num_envs=GLOO_N,
                                    unroll_length=GLOO_T))


def gloo_rank(rank: int, world: int, store: str, out_dir: str) -> None:
    """A gloo rank on the one card: ``gloo_steps`` on its share of the
    envs, saved to ``out_dir/gloo_<rank>.npz``."""
    import numpy as np
    import torch
    import torch.distributed as dist

    sys.path.insert(0, REPO)
    from tpu_plume_torch.core.config import get_preset
    from tpu_plume_torch.parallel import make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        mesh = make_mesh(world, device="cuda")
        np.savez(os.path.join(out_dir, f"gloo_{rank}.npz"),
                 **gloo_steps(get_preset, mesh))
    finally:
        dist.destroy_process_group()


def gloo_steps(get_preset, mesh=None) -> dict:
    """Two iterations of the small f32 and ``fused_update`` configs on the
    card (on ``mesh``'s share of the envs): the first iteration's actions,
    dones and rewards, the last's loss and the params."""
    from tpu_plume_torch.parallel import shard_loop_carry
    from tpu_plume_torch.train import ppo_trainer as ttrain

    out = {}
    for name, ppo in (("f32", {}), ("fused", dict(fused_update=True))):
        cfg = gloo_cfg(get_preset, **ppo)
        loop = ttrain.init_loop(cfg, "cuda")
        if mesh is not None:
            loop = shard_loop_carry(loop, mesh)
        step = ttrain.build_train_step(cfg)
        for i in range(2):
            loop, stats, traj = step(loop)
            if i == 0:
                for f in ("action", "done", "reward"):
                    out[f"{name}/{f}"] = getattr(traj, f).cpu().numpy()
        out[f"{name}/loss"] = float(stats["loss/total"])
        out.update({f"{name}/param/{k}": v.numpy() for k, v in
                    ttrain.cpu_state_dict(loop.model).items()})
    return out


def gloo_on_the_card(m, totals) -> dict:
    """GLOO_WORLD gloo ranks sharing the one card (spawned processes)
    against one process over all the envs: actions and dones equal,
    rewards rtol 1e-5 / atol 1e-5, the loss rtol 1e-4, params atol 1e-6
    per Adam step."""
    import numpy as np
    import torch.multiprocessing as mp

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        mp.start_processes(gloo_rank, args=(GLOO_WORLD,
                                            os.path.join(tmp, "store"), tmp),
                           nprocs=GLOO_WORLD, join=True,
                           start_method="spawn")
        parts = [dict(np.load(os.path.join(tmp, f"gloo_{r}.npz")))
                 for r in range(GLOO_WORLD)]
    want, _ = counted(m, totals, lambda: gloo_steps(m.get_preset))
    steps = 2 * 5 * (GLOO_N * GLOO_T // GLOO_MB)
    worst = {}
    for key, value in want.items():
        if key.endswith(("/action", "/done", "/reward")):
            got = np.concatenate([p[key] for p in parts], axis=1)
            if key.endswith("/reward"):
                np.testing.assert_allclose(got, value, rtol=1e-5, atol=1e-5,
                                           err_msg=key)
            else:
                np.testing.assert_array_equal(got, value, err_msg=key)
            continue
        for p in parts[1:]:
            np.testing.assert_array_equal(p[key], parts[0][key], err_msg=key)
        got = parts[0][key]
        if key.endswith("/loss"):
            np.testing.assert_allclose(got, value, rtol=1e-4, err_msg=key)
        else:
            np.testing.assert_allclose(got, value, rtol=0, atol=1e-6 * steps,
                                       err_msg=key)
            worst[key] = float(np.abs(got - value).max())
    out = dict(world=GLOO_WORLD, max_param_gap=max(worst.values()),
               seconds=round(time.perf_counter() - t0, 1))
    log(f"gloo, {GLOO_WORLD} ranks on the one card against one process "
        f"({GLOO_N} envs x {GLOO_T} steps, f32 and fused_update, 2 "
        f"iterations): actions and dones equal, largest param gap "
        f"{out['max_param_gap']:.3g} ({out['seconds']} s)")
    return out


def scale_out_phase(m, v20, w3) -> dict:
    """Phase 15: resume bit for bit (ppo_v2_0 f32 and ``fused_update`` at
    full width, wrf_les_3d over its bank), the CLI's ``--profile-steps``,
    ``--tensorboard`` and ``--debug-nans``, the packed drain, the mesh step
    at world size 1 through NCCL, and gloo ranks on the one card.  Returns
    each case's result and seconds, and the phase's launches."""
    import torch

    out, totals = {}, {}
    fused = v20.replace(ppo=dataclasses.replace(v20.ppo, fused_update=True))
    bank = m.gridded.synthesize_3d_bank(
        torch.Generator(device="cuda").manual_seed(0), w3.env)
    out["resume"] = {
        "ppo_v2_0 f32": resume_case(m, totals, "ppo_v2_0 f32", v20),
        "ppo_v2_0 fused_update": resume_case(m, totals,
                                             "ppo_v2_0 fused_update", fused),
        "wrf_les_3d": resume_case(m, totals, "wrf_les_3d", w3, bank)}
    del bank
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        out["cli"] = flags_cli(m, totals, tmp)
    out["cli"]["seconds"] = round(time.perf_counter() - t0, 1)
    t0 = time.perf_counter()
    out["drain"] = drain_check(m, totals, v20)
    out["drain"]["seconds"] = round(time.perf_counter() - t0, 1)
    out["nccl_world_1"] = nccl_world_of_one(m, totals, v20)
    out["gloo_on_card"] = gloo_on_the_card(m, totals)
    out["launches"] = totals
    log(json.dumps({"scale_out": out}, default=str))
    return out


def build_kernels(build, names) -> None:
    """One nvcc per source, all started together."""
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        for name, _ in zip(names, pool.map(
                lambda name: build.build(name, verbose=True), names)):
            log(f"kernel build: {name} done at "
                f"{time.perf_counter() - t0:.2f} s")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument(
        "--only", choices=("guide", "stop-lstm", "eval-guides",
                           "imitation", "flux", "scale-out", "bank-step",
                           "lstm-step"),
        help="after the build, run only the guide's phases (with the "
             "untrained policies' guided evals), only phases 9 and 10, "
             "only the learning check and phase 12, only phase 13, the "
             "imitation phase, only the learning check and phase 14, "
             "the flux studies, only phase 15, the train flags and "
             "data parallel, only the bank step kernel's checks and "
             "times and the two bank main paths, or only the LSTM step "
             "kernels' checks and times")
    args = parser.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from tpu_plume_torch.cli.main import main as cli_main
    from tpu_plume_torch.core.config import PPOConfig, RolloutConfig, get_preset
    from tpu_plume_torch.evaluation import harnesses as ev
    from tpu_plume_torch.fields import gridded
    from tpu_plume_torch.models import ActorCritic, recurrent
    from tpu_plume_torch.ops import build, gather, plume
    from tpu_plume_torch.ops import lstm as lstm_ops
    from tpu_plume_torch.ops import ppo as fused_ops
    from tpu_plume_torch.rl import ppo as ppo_mod
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

    seconds = {}
    t_phase = [time.perf_counter()]

    def phase_done(name):
        now = time.perf_counter()
        seconds[name] = round(now - t_phase[0], 1)
        t_phase[0] = now

    build_kernels(build, ("plume", "ppo", "gather", "lstm"))
    phase_done("build")
    k = types.SimpleNamespace(plume=plume, fused_ops=fused_ops, gather=gather,
                              gridded=gridded)
    v20 = get_preset("ppo_v2_0")
    v20_main = v20.replace(ppo=dataclasses.replace(v20.ppo,
                                                   minibatch_size=MAIN_MB))
    wl = get_preset("wrf_les")
    wl = wl.replace(ppo=dataclasses.replace(wl.ppo, minibatch_size=MAIN_MB))
    m = types.SimpleNamespace(
        ev=ev, k=k, ttrain=ttrain, rollout=rollout, cli_main=cli_main,
        ActorCritic=ActorCritic, get_preset=get_preset, plume=plume,
        gridded=gridded, RolloutConfig=RolloutConfig, draw_chunk=draw_chunk,
        lstm_ops=lstm_ops, recurrent=recurrent)
    if args.only:
        run_only(args.only, m, v20_main, wl, phase_done)
        log("phase seconds: " + json.dumps(seconds))
        print(card, flush=True)
        return 0

    plume_report = check_plume_kernel(get_preset, plume)
    modes_err = check_plume_modes(get_preset, plume, rollout)
    env_err = check_env_step_kernel(get_preset, plume, rollout)
    exec_parity = check_env_step_exec(get_preset, plume, rollout)
    env_time = time_env_step_kernel(get_preset, plume, rollout)
    exec_time = time_env_step_exec(get_preset, plume, rollout)
    phase_done("plume kernels")
    ppo_args = (ActorCritic, PPOConfig, PPOBatch, fused_ops, ppo_loss)
    ppo_err = check_ppo_kernel(*ppo_args)
    ppo_time = time_ppo_kernel(*ppo_args)
    gather_err = check_gather_kernels(gather)
    gather_time = time_gather_kernels(gather)
    sample_err = check_sample_kernels(get_preset, gridded, gather)
    sample_time = time_sample_kernels(get_preset, gridded, gather)
    bank_step_parity = check_bank_step_kernel(get_preset, gridded, plume,
                                              rollout)
    bank_step_time = time_bank_step_kernel(get_preset, gridded, gather,
                                           plume, rollout)
    phase_done("ppo and gather kernels")

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
    check_small_iteration_against_cpu(*small, arch="lstm")
    check_small_iteration_against_cpu(*small, arch="lstm",
                                      lstm_layer_norm=True)
    check_small_iteration_against_cpu(*small, arch="lstm",
                                      lstm_layer_norm=True,
                                      bf16_compute=True)
    phase_done("small iterations")

    # The three ppo_v2_0 variants in turns, A B C C B A, each block on a
    # fresh loop, so that a drift of the host's speed during the run shows
    # as a difference between a variant's two blocks.
    variants = {"f32": {}, "fused_update": dict(fused_update=True),
                "bf16_compute": dict(bf16_compute=True)}
    runs = {name: [] for name in variants}
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
    phase_done("ppo_v2_0 main paths")

    # Eval A: the reference protocol (1000 greedy episodes x 1000 steps,
    # heuristic stop, success@40) with the main-path ppo_v2_0 f32 params,
    # and the same params on the card against the CPU.
    f32_model = runs["f32"][0]["model"]
    eval_a = run_eval(ev, k, "A", v20_main, f32_model, stop="heuristic")
    eval_a["card_vs_cpu"] = check_eval_against_cpu(
        ev, "ppo_v2_0", v20_main, f32_model, stop="heuristic")
    stay = ActorCritic(MAIN_D, MAIN_A, MAIN_HIDDEN)
    stay.reset_parameters(torch.Generator().manual_seed(0))
    with torch.no_grad():
        stay.actor.bias[0] += STAY_BIAS
    phase_done("eval A")
    eval_a["stop_card_vs_cpu"] = check_eval_against_cpu(
        ev, "ppo_v2_0 stop setting",
        v20_main.replace(env=dataclasses.replace(v20_main.env, **STOP_ENV)),
        stay, stop="heuristic", mixed_stops=True)
    for blocks in runs.values():
        for run in blocks:
            del run["model"]
    torch.cuda.empty_cache()

    # wrf_les at full width: the anisotropic plume in a per-episode wind,
    # one env-step launch per env step, no cuts.
    aniso = run_main_path(ttrain, rollout.rollout_chunk, k, "wrf_les", wl)
    torch.cuda.empty_cache()
    phase_done("stop setting and wrf_les")
    guided_train, _ = guided_training(ttrain, rollout, k,
                                      (("ppo_v2_0", v20), ("wrf_les", wl)))
    phase_done("guided training")

    # wrf_les_3d at full width: the bank of --synth-bank 3d, no cuts.
    w3 = get_preset("wrf_les_3d")
    w3 = w3.replace(ppo=dataclasses.replace(w3.ppo, minibatch_size=MAIN_MB))
    bank = gridded.synthesize_3d_bank(
        torch.Generator(device="cuda").manual_seed(0), w3.env)
    log(f"wrf_les_3d bank {list(bank.conc.shape)}, {bank.conc.numel() * 4} B")
    wrf = run_main_path(ttrain, rollout.rollout_chunk, k, "wrf_les_3d", w3,
                        bank)
    # Eval B: wrf_les_3d at the protocol's width over the same bank, no
    # stop, with the main path's params; and on the card against the CPU.
    eval_b = run_eval(ev, k, "B", w3, wrf["model"], bank)
    eval_b["card_vs_cpu"] = check_eval_against_cpu(ev, "wrf_les_3d", w3,
                                                   wrf["model"], bank)
    del bank, wrf["model"]
    torch.cuda.empty_cache()
    phase_done("wrf_les_3d and eval B")
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
    phase_done("static bank")
    # The recurrent policy at full width (ppo_v2_0 --arch lstm, f32): one
    # env-step launch per env step, the BPTT update; its replay's two
    # formulations; eval A with it as rnn=, and on the card against the
    # CPU.
    lstm_cfg = v20.replace(ppo=dataclasses.replace(
        v20.ppo, minibatch_size=MAIN_MB, arch="lstm"))
    lstm_before = lstm_ops.fwd_launches, lstm_ops.bwd_launches
    lstm = run_main_path(ttrain, rollout.rollout_chunk, k, "lstm", lstm_cfg,
                         iters=1,
                         profile_steps=lstm_cfg.rollout.unroll_length)
    # each minibatch's graph replays launch each LSTM kernel T times, the
    # warm-up iteration's and the timed one's; the capture counts none
    t_lstm = lstm_cfg.rollout.unroll_length
    per_update = lstm_cfg.ppo.epochs * (lstm_cfg.rollout.num_envs // max(
        1, lstm_cfg.ppo.minibatch_size // t_lstm)) * t_lstm
    lstm_launches = (lstm_ops.fwd_launches - lstm_before[0],
                     lstm_ops.bwd_launches - lstm_before[1])
    assert lstm_launches == (2 * per_update, 2 * per_update), lstm_launches
    lstm_replay = time_bptt_replay(ttrain, ppo_mod, lstm_cfg)
    lstm_kernels = {"parity": check_lstm_kernels(lstm_ops, recurrent),
                    "time": time_lstm_kernels(lstm_ops, recurrent),
                    "main_path_launches": lstm_launches}
    eval_lstm = run_eval(ev, k, "A lstm", lstm_cfg, lstm["model"],
                         stop="heuristic")
    eval_lstm["card_vs_cpu"] = check_eval_against_cpu(
        ev, "ppo_v2_0 lstm", lstm_cfg, lstm["model"], stop="heuristic")
    del lstm["model"]
    torch.cuda.empty_cache()
    profiled = (("ppo_v2_0 f32", runs["f32"][0]),
                ("ppo_v2_0 fused_update", runs["fused_update"][0]),
                ("ppo_v2_0 bf16_compute", runs["bf16_compute"][0]),
                ("wrf_les", aniso), ("wrf_les_3d", wrf),
                ("static_subcell", static), ("ppo_v2_0 lstm", lstm))
    log("profiled launches per iteration: " + ", ".join(
        f"{label} {run['profiled_launches']}" for label, run in profiled))
    log("profiled rollout launches per env step: " + ", ".join(
        f"{label} {run['rollout_profile']['launches_per_step']:.2f}"
        for label, run in profiled))

    phase_done("lstm")
    cli_eval = {}

    def eval_clis(tmp):
        cli_eval.update(check_eval_cli(cli_main, tmp))
        cli_eval["guided"] = check_guide_cli(cli_main, tmp)

    run_cli(cli_main, ActorCritic, "ppo_v2_0", MAIN_D, MAIN_A,
            then=eval_clis)
    run_cli(cli_main, ActorCritic, "ppo_v2_0", MAIN_D, MAIN_A,
            "--train-guide", "fit", "--min-radius", "50", "--terminal-gate",
            "40")
    run_cli(cli_main, ActorCritic, "ppo_v2_0", MAIN_D, MAIN_A, "--bf16")
    run_cli(cli_main, ActorCritic, "wrf_les", 6, 5)
    run_cli(cli_main, ActorCritic, "wrf_les_3d", 7, 7, "--synth-bank", "3d")
    cli_lstm = {}
    run_cli(cli_main, ActorCritic, "ppo_v2_0", MAIN_D, MAIN_A, "--arch",
            "lstm", then=lambda tmp: cli_lstm.update(
                check_lstm_eval_cli(cli_main, tmp)))
    phase_done("cli")

    learning, stop_lstm, trained = stop_lstm_phases(ttrain, ev, k, cli_main,
                                                    v20_main, phase_done)
    # The fit alone on the card against the CPU, and the fit guide in the
    # protocol's evals (eval --guide fit, no stop): eval A's ppo_v2_0 with
    # the learning check's trained params, wrf_les with its main path's
    # params; each against the CPU (--only guide adds the untrained
    # params').
    guided, fit_check = guided_evals(ev, k, get_preset, (
        ("A trained", v20_main, trained, GUIDE_CPU_EPISODES["ppo_v2_0"]),
        ("wrf_les main-path policy", wl, aniso["model"],
         GUIDE_CPU_EPISODES["wrf_les"])))
    del aniso["model"]
    phase_done("guided evals")
    # The bank-match and learned guides, the localizer and the oracles in
    # the protocol's evals (phase 12), then imitation (phase 13) on phase
    # 12's expert file.
    with tempfile.TemporaryDirectory() as expert_dir:
        eval_guides_out = eval_guides(ev, k, ttrain, gridded, get_preset,
                                      cli_main, v20_main, trained,
                                      expert_dir)
        phase_done("eval guides")
        imit = imitation(m, v20, os.path.join(expert_dir,
                                              "expert_data.npz"))
        phase_done("imitation")
    # Flux inversion (phase 14): the studies, and the learning check's
    # policy's survey through cli flux --ckpt.
    flux_out = flux_phase(m, trained)
    phase_done("flux")
    # The train flags and data parallel (phase 15).
    scale_out = scale_out_phase(m, v20_main, w3)
    phase_done("scale-out")
    for gate in STOP_GATES:
        e = stop_lstm[f"eval_{gate}"]
        log(f"eval A {gate} gate: success@40 {e['summary']['success_rate']:.3f}"
            f" (a record, not a gate), early stops "
            f"{e['summary']['early_stop_rate']:.3f}, mean steps "
            f"{e['summary']['mean_steps']:.1f}")
    del trained
    torch.cuda.empty_cache()

    eval_launches = {name: eval_a["launches"][name] + eval_b["launches"][name]
                     for name in KERNEL_NAMES}
    log(json.dumps({"eval": {"A": eval_a, "B": eval_b, "cli": cli_eval,
                             "learning": learning, "A_lstm": eval_lstm,
                             "cli_lstm": cli_lstm}}))
    log(json.dumps({"lstm": {
        key: lstm[key] for key in ("sps", "rollout", "gae", "update",
                                   "whole_ms", "busy", "busy_unprofiled",
                                   "device_ms", "profiled_launches",
                                   "rollout_profile", "max_memory_allocated",
                                   "counts")}, "lstm_replay": lstm_replay,
        "lstm_kernels": lstm_kernels}))
    log(json.dumps({"stop_lstm": stop_lstm}))
    log(json.dumps({"eval_guides": eval_guides_out}, default=str))
    log(json.dumps({"imitation": imit}, default=str))
    log(json.dumps({"flux": flux_out}, default=str))
    log(json.dumps({"guide": {
        "evals": guided, "fit_card_vs_cpu": fit_check,
        "exec_parity": exec_parity, "exec_time": {
            str(n): row for n, row in exec_time.items()},
        "training": {preset: {key: run[key] for key in (
            "sps", "rollout", "gae", "update", "whole_ms", "busy",
            "busy_unprofiled", "device_ms", "profiled_launches",
            "rollout_profile", "override_share", "counts", "total_counts",
            "max_memory_allocated")}
            for preset, run in guided_train.items()}}}))
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
        "lstm_eval_launches": eval_lstm["launches"]["plume_sample"],
        "gated_eval_launches": {
            gate: stop_lstm[f"eval_{gate}"]["launches"]["plume_sample"]
            for gate in STOP_GATES},
        "guided_eval_launches": {
            label: e["launches"]["plume_sample"]
            for label, e in guided.items() if "launches" in e},
        "flux_launches": {label: r["launches"]["plume_sample"]
                          for label, r in flux_out.items()},
        "imitation": {
            f"dagger {arch} collections": [
                r["launches"]["plume_sample"]
                for r in imit[key]["rounds"]]
            for arch, key in (("mlp", "dagger"), ("lstm", "dagger lstm"))},
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
        "capture": {
            "launches": learning["capture"]["launches"]["env_step"],
            "per_iteration":
                learning["capture"]["env_step_launches_per_iteration"]},
        "lstm": {
            "launches": lstm["total_counts"]["env_step"],
            "launches_timed": lstm["counts"]["env_step"],
            "rollout_launches_per_step":
                lstm["rollout_profile"]["launches_per_step"]},
        "guided": {
            preset: {"launches": run["total_counts"]["env_step"],
                     "launches_timed": run["counts"]["env_step"],
                     "rollout_launches_per_step":
                         run["rollout_profile"]["launches_per_step"],
                     "override_share": run["override_share"]}
            for preset, run in guided_train.items()},
        "exec_action": {"max_abs_err": exec_parity["max_abs_err"],
                        **{str(n): row for n, row in exec_time.items()}},
        "imitation": {
            **{label: {"launches": imit[label]["total_counts"]["env_step"],
                       "launches_timed": imit[label]["counts"]["env_step"]}
               for label in ("distill", "distill fused_update")},
            "distill rollout_launches_per_step":
                imit["distill"]["rollout_profile"]["launches_per_step"],
            **{label: {"launches_timed": imit[label]["counts"]["env_step"]}
               for label in ("gail f32", "gail fused_update")},
            **{f"cli {name}": imit["cli"][name]["launches"]["env_step"]
               for name in ("train_gail", "train_distill")}},
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
        "imitation": {
            label: {name: imit[label]["counts"][name]
                    for name in ("ppo_fused", "ppo_dw2", "ppo_reduce")}
            for label in ("gail fused_update", "distill fused_update")},
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
    kernels.append({
        "name": "bank_step",
        "route": "cuda",
        "source": "tpu_plume_torch/csrc/plume.cu",
        "replaces": "none: the env step around the bank sample, which "
                    "env_step_plain takes in about 80 launches",
        "launches": wrf["total_counts"]["bank_step"],
        "launches_timed": wrf["counts"]["bank_step"],
        "static_launches_timed": static["counts"]["bank_step"],
        "rollout_launches_per_step":
            wrf["rollout_profile"]["launches_per_step"],
        "parity_dones": bank_step_parity,
        **bank_step_time[BANK_STEP_N],
        "n4096": bank_step_time[MAIN_N],
    })
    log("host split (ns per call) of the bank sample wrapper: "
        + json.dumps(sample_time["split_ns"]) + "; of the trilinear gather "
        "wrapper: " + json.dumps(gather_time["split_ns"]))
    for entry in kernels:
        entry["eval_launches"] = eval_launches[entry["name"]]
        entry["scale_out_launches"] = scale_out["launches"][entry["name"]]
        for key, labels in EVAL_GUIDE_GROUPS.items():
            entry[key] = {label: eval_guides_out[label]["launches"][
                entry["name"]] for label in labels}
    kernels.append({
        "name": "lstm_step",
        "route": "cuda",
        "source": "tpu_plume_torch/csrc/lstm.cu",
        "replaces": "none: the BPTT replay's gate arithmetic, which JAX "
                    "leaves to XLA's scan",
        "kernels": ["lstm_step_fwd_kernel", "lstm_step_bwd_kernel"],
        "launches": lstm_kernels["main_path_launches"],
        **lstm_kernels["time"],
        "parity": lstm_kernels["parity"],
    })
    log("phase seconds: " + json.dumps(seconds))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
