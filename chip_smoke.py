"""Smoke run of the PyTorch/CUDA port (``tpu_plume_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA card and ``nvcc``; exits non-zero without them, and when run
outside a checkout of the repository.  Phases, each of which must pass:

1. the card's name and power limit, torch and CUDA versions;
2. the build of every CUDA kernel of the main path from
   ``tpu_plume_torch/csrc``, one ``nvcc`` per source, all started together;
3. each kernel against its plain PyTorch version on the same inputs, with
   the tolerance the CPU tests use: the plume sample at the main path's
   shape and a large one; the fused PPO gradients in f32 and bf16 compute,
   at obs widths 6 and 12, hidden widths (256, 128) and (64, 32) and
   minibatches of 65536 and 512 rows, with two calls giving bit-equal
   gradients, and in f32 also against autodiff of ``ppo_loss``;
4. each kernel's time, its plain version's and the least time the card
   could take for the same bytes and operations; for the fused PPO kernel
   also autodiff's forward and backward of ``ppo_loss`` on the same
   minibatch;
5. one train iteration at a small size on the card against the same
   iteration on the CPU (the CPU path is the one the tests hold to the JAX
   package): f32, ``fused_update``, ``bf16_compute``, and both;
6. the main path at full width: the ppo_v2_0 train step with 4096 envs x
   128 steps and the 6->256->128 network in three variants (f32 autodiff,
   ``fused_update``, ``bf16_compute``), each with one warm-up and three
   timed iterations, the kernel launch counts read around the timed ones,
   and one more iteration under the profiler;
7. the ``train`` CLI for two iterations at the same width, in f32 and with
   ``--bf16``.

Then it prints the ``kernels`` JSON line, the card's name and power limit,
and, last, the result line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import io
import json
import math
import os
import subprocess
import sys
import tempfile
import time

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
    return {"max_abs_err": worst, "timing": timing}


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
        device_ms = kernel_device_ms(kernel, "ppo_fused_kernel", reps=20)
        reduce_ms = kernel_device_ms(kernel, "ppo_reduce_kernel", reps=20)
        bound_ms, bound_by = ppo_bound(MAIN_MB, MAIN_D, *MAIN_HIDDEN, MAIN_A,
                                       bf16)
        key = "bf16" if bf16 else "f32"
        out[key] = dict(ms=ms, plain_ms=plain_ms, autodiff_ms=autodiff_ms,
                        device_ms=device_ms, reduce_device_ms=reduce_ms,
                        bound_ms=bound_ms, bound_by=bound_by)
        log(f"time ppo_fused {key} B={MAIN_MB}: per call {ms:.4f} ms, on the "
            f"device {device_ms} ms + reduction {reduce_ms} ms, plain "
            f"{plain_ms:.4f} ms, autodiff fwd+bwd {autodiff_ms:.4f} ms, "
            f"bound {bound_ms:.6f} ms ({bound_by})")
    return out


def profile_iteration(step, loop):
    """Device kernel time, kernel count and busy share of one main-path
    iteration, from torch.profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        loop, _, _ = step(loop)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # Device events only, without user annotations such as the optimizer's
    # step range, which span kernels already counted.
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.count
               and not getattr(e, "is_user_annotation", False)
               and "#" not in e.key]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    count = sum(e.count for e in kernels)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    log(f"profile of one main-path iteration (profiler on): wall "
        f"{wall_ms:.1f} ms, device kernels {device_ms:.1f} ms in {count} "
        f"launches, device busy share {device_ms / wall_ms:.3f}")
    for e in top:
        log(f"  {e.self_device_time_total / 1e3:9.2f} ms {e.count:6d}x "
            f"{e.key[:90]}")
    return loop


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


def check_small_iteration_against_cpu(get_preset, RolloutConfig, ttrain,
                                      draw_chunk, fused_ops, **ppo):
    """One small train iteration on the card and on the CPU from the same
    start, draws and shuffles, with the PPO config fields ``ppo`` set."""
    import torch

    cfg = get_preset("ppo_v2_0")
    ppo.setdefault("minibatch_size", 32)
    cfg = cfg.replace(
        env=dataclasses.replace(cfg.env, max_steps=6, initial_radius=200.0),
        ppo=dataclasses.replace(cfg.ppo, hidden_sizes=(64, 32), **ppo),
        curriculum=dataclasses.replace(cfg.curriculum, initial_radius=200.0,
                                       window_size=4),
        rollout=RolloutConfig(num_envs=16, unroll_length=8))
    cpu = ttrain.init_loop(cfg, "cpu")
    draws = draw_chunk(torch.Generator().manual_seed(1), cfg.env, 8, 16)
    shuffles = [3, 77, 0, 101, 64]
    step = ttrain.build_train_step(cfg)

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
    _, cstats, ctraj = step(cpu, draws=draws, shuffles=shuffles)
    before = fused_ops.launches
    _, gstats, gtraj = step(gpu, draws=to_device(draws, "cuda"),
                            shuffles=shuffles)
    torch.cuda.synchronize()
    fused = fused_ops.launches - before
    rows = cfg.rollout.num_envs * cfg.rollout.unroll_length
    want = (cfg.ppo.epochs * rows // cfg.ppo.minibatch_size
            if cfg.ppo.fused_update else 0)
    assert fused == want, f"ppo_fused launches {fused} != {want}"
    assert torch.equal(gtraj.action.cpu(), ctraj.action), "actions differ"
    assert torch.equal(gtraj.done.cpu(), ctraj.done), "dones differ"
    torch.testing.assert_close(gtraj.reward.cpu(), ctraj.reward, rtol=RTOL,
                               atol=ATOL)
    for k in ("loss/total", "loss/value", "loss/entropy"):
        assert math.isclose(float(gstats[k]), float(cstats[k]), rel_tol=1e-4,
                            abs_tol=1e-5), (k, gstats[k], cstats[k])
    log(f"small iteration {ppo}, card vs CPU: actions and dones equal, "
        f"{int(ctraj.done.sum())} episodes ended, {fused} ppo_fused launches, "
        f"loss/total {float(gstats['loss/total']):.6f} vs "
        f"{float(cstats['loss/total']):.6f}")


def run_main_path(get_preset, ttrain, plume, fused_ops, label,
                  profile=True, **ppo):
    """The full-width train step with the PPO config fields ``ppo`` set:
    warm-up, then three timed iterations with the launch counts set to 0
    just before them and read just after, then, with ``profile``, one
    profiled iteration.  Returns the counts, env-steps/s and phase ms."""
    import torch

    cfg = get_preset("ppo_v2_0")
    cfg = cfg.replace(ppo=dataclasses.replace(cfg.ppo, minibatch_size=MAIN_MB,
                                              **ppo))
    n, t = cfg.rollout.num_envs, cfg.rollout.unroll_length
    loop = ttrain.init_loop(cfg, "cuda")
    step = ttrain.build_train_step(cfg, time_phases=True)
    t0 = time.perf_counter()
    loop, stats, _ = step(loop)
    torch.cuda.synchronize()
    log(f"main path {label} warm-up iteration: "
        f"{time.perf_counter() - t0:.3f} s")

    iters = 3
    phases = {"rollout": 0.0, "gae": 0.0, "update": 0.0}
    plume.launches = 0
    fused_ops.launches = fused_ops.reduce_launches = 0
    t0 = time.perf_counter()
    for _ in range(iters):
        loop, stats, traj = step(loop)
        for k in phases:
            phases[k] += stats[f"time/{k}_ms"]
        for k in ("loss/total", "loss/policy", "loss/value", "loss/entropy"):
            assert math.isfinite(float(stats[k])), (k, stats[k])
        assert traj.obs.shape == (t, n, cfg.env.obs_dim)
        assert torch.isfinite(traj.obs).all() and torch.isfinite(traj.reward).all()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {"plume_sample": plume.launches, "ppo_fused": fused_ops.launches,
              "ppo_reduce": fused_ops.reduce_launches}
    want = iters * 2 * t
    assert counts["plume_sample"] == want, (label, counts, want)
    steps = cfg.ppo.epochs * (n * t // cfg.ppo.minibatch_size)
    want = iters * steps if cfg.ppo.fused_update else 0
    assert counts["ppo_fused"] == counts["ppo_reduce"] == want, (
        label, counts, want)
    sps = iters * n * t / wall
    log(f"main path {label}: ppo_v2_0 {n} envs x {t} steps, minibatch "
        f"{cfg.ppo.minibatch_size}, {cfg.ppo.epochs} epochs: {iters} "
        f"iterations in {wall:.3f} s = {sps:.1f} env-steps/s")
    log(f"main path {label} ms per iteration: " + ", ".join(
        f"{k} {v / iters:.2f}" for k, v in phases.items())
        + f", whole {wall / iters * 1e3:.2f}")
    log(f"main path {label} last iteration: loss/total "
        f"{float(stats['loss/total']):.5f}, episodes "
        f"{stats['rollout/episodes']}, radius "
        f"{stats['curriculum/radius']:.2f}; launches {counts}")
    if profile:
        profile_iteration(step, loop)
    return dict(counts=counts, sps=sps, whole_ms=wall / iters * 1e3,
                **{k: v / iters for k, v in phases.items()})


def run_cli(cli_main, ActorCritic, *flags):
    import torch

    with tempfile.TemporaryDirectory() as tmp:
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            cli_main(["train", "--preset", "ppo_v2_0", "--out", tmp,
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
        model = ActorCritic(MAIN_D, MAIN_A, MAIN_HIDDEN)
        model.load_state_dict(torch.load(
            os.path.join(tmp, "model", "ppo_successful_models.pth")))
        assert all(torch.isfinite(p).all() for p in model.parameters())
        log(f"cli train {' '.join(flags) or '(f32)'}: 2 iterations, "
            f"{res['episodes']} episodes in the CSV, "
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
    from tpu_plume_torch.models import ActorCritic
    from tpu_plume_torch.ops import build, plume
    from tpu_plume_torch.ops import ppo as fused_ops
    from tpu_plume_torch.rl.ppo import PPOBatch, ppo_loss
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

    build_kernels(build, ("plume", "ppo"))

    plume_report = check_plume_kernel(get_preset, plume)
    ppo_args = (ActorCritic, PPOConfig, PPOBatch, fused_ops, ppo_loss)
    ppo_err = check_ppo_kernel(*ppo_args)
    ppo_time = time_ppo_kernel(*ppo_args)

    small = (get_preset, RolloutConfig, ttrain, draw_chunk, fused_ops)
    check_small_iteration_against_cpu(*small)
    check_small_iteration_against_cpu(*small, fused_update=True,
                                      minibatch_size=128)
    check_small_iteration_against_cpu(*small, bf16_compute=True)
    check_small_iteration_against_cpu(*small, fused_update=True,
                                      bf16_compute=True, minibatch_size=128)

    # The three variants in turns, A B C C B A, each block on a fresh loop,
    # so that a drift of the host's speed during the run shows as a
    # difference between a variant's two blocks.
    variants = {"f32": {}, "fused_update": dict(fused_update=True),
                "bf16_compute": dict(bf16_compute=True)}
    runs = {name: [] for name in variants}
    for i, name in enumerate(list(variants) + list(reversed(variants))):
        runs[name].append(run_main_path(
            get_preset, ttrain, plume, fused_ops, name, profile=i < 3,
            **variants[name]))
        torch.cuda.empty_cache()
    for name, blocks in runs.items():
        log(f"main path summary {name} (blocks in run order): env-steps/s "
            + ", ".join(f"{b['sps']:.1f}" for b in blocks) + "; ms "
            + "; ".join(", ".join(f"{k} {b[k]:.2f}" for k in
                                  ("rollout", "gae", "update", "whole_ms"))
                        for b in blocks))
    launches = runs["f32"][0]["counts"]
    fused_launches = runs["fused_update"][0]["counts"]
    run_cli(cli_main, ActorCritic)
    run_cli(cli_main, ActorCritic, "--bf16")

    main_t = plume_report["timing"][MAIN_N]
    ppo_t = ppo_time["f32"]
    kernels = [{
        "name": "plume_sample",
        "route": "cuda",
        "source": "tpu_plume_torch/csrc/plume.cu",
        "replaces": "tpu_plume/ops/pallas_plume.py:29",
        "launches": launches["plume_sample"],
        "max_abs_err": plume_report["max_abs_err"],
        "ms": main_t["ms"],
        "plain_ms": main_t["plain_ms"],
        "bound_ms": main_t["bound_ms"],
        "bound_by": main_t["bound_by"],
        "library_ms": None,
        "device_ms": main_t["device_ms"],
    }, {
        "name": "ppo_fused",
        "route": "cuda",
        "source": "tpu_plume_torch/csrc/ppo.cu",
        "replaces": "tpu_plume/ops/pallas_ppo.py:60",
        "launches": fused_launches["ppo_fused"],
        "max_abs_err": ppo_err,
        "ms": ppo_t["ms"],
        "plain_ms": ppo_t["plain_ms"],
        "bound_ms": ppo_t["bound_ms"],
        "bound_by": ppo_t["bound_by"],
        "library_ms": None,
        "device_ms": ppo_t["device_ms"],
        "reduce_launches": fused_launches["ppo_reduce"],
        "reduce_device_ms": ppo_t["reduce_device_ms"],
        "autodiff_ms": ppo_t["autodiff_ms"],
        "bf16": ppo_time["bf16"],
    }]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
