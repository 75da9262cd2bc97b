"""Smoke run of the PyTorch/CUDA port (``tpu_plume_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA card and ``nvcc``; exits non-zero without them, and when run
outside a checkout of the repository.  Phases, each of which must pass:

1. the card's name and power limit, torch and CUDA versions;
2. the build of every CUDA kernel of the main path from ``tpu_plume_torch/csrc``;
3. each kernel against its plain PyTorch version on the same inputs, at the
   main path's shape and a large one, with the tolerance the CPU tests use;
4. each kernel's time, its plain version's and the least time the card
   could take for the same bytes and operations;
5. one train iteration at a small size on the card against the same
   iteration on the CPU (the CPU path is the one the tests hold to the JAX
   package);
6. the main path at full width: the ppo_v2_0 train step with 4096 envs x
   128 steps and the 6->256->128 network, one warm-up and three timed
   iterations, with the kernel launch counts read around the timed ones;
7. the ``train`` CLI for two iterations at the same width.

Then it prints the ``kernels`` JSON line, the card's name and power limit,
and, last, the result line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

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

# Published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, and float32
# operations/s outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# Operations of one plume query, counting each transcendental as one: about
# 12 for the Gaussian base, 69 integer operations for three two-round cell
# hashes, 9 to turn three hashes into uniforms, 8 for Box-Muller, 6 for the
# wave term and 9 for turbulence, clip and TKE.
PLUME_OPS_PER_QUERY = 113
MAIN_N = 4096
LARGE_N = 1 << 20
RTOL, ATOL = 1e-5, 1e-4


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
                                      draw_chunk):
    """One small train iteration on the card and on the CPU from the same
    start, draws and shuffles."""
    import torch

    cfg = get_preset("ppo_v2_0")
    cfg = cfg.replace(
        env=dataclasses.replace(cfg.env, max_steps=6, initial_radius=200.0),
        ppo=dataclasses.replace(cfg.ppo, hidden_sizes=(64, 32),
                                minibatch_size=32),
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
    _, gstats, gtraj = step(gpu, draws=to_device(draws, "cuda"),
                            shuffles=shuffles)
    torch.cuda.synchronize()
    assert torch.equal(gtraj.action.cpu(), ctraj.action), "actions differ"
    assert torch.equal(gtraj.done.cpu(), ctraj.done), "dones differ"
    torch.testing.assert_close(gtraj.reward.cpu(), ctraj.reward, rtol=RTOL,
                               atol=ATOL)
    for k in ("loss/total", "loss/value", "loss/entropy"):
        assert math.isclose(float(gstats[k]), float(cstats[k]), rel_tol=1e-4,
                            abs_tol=1e-5), (k, gstats[k], cstats[k])
    log(f"small iteration, card vs CPU: actions and dones equal, "
        f"{int(ctraj.done.sum())} episodes ended, loss/total "
        f"{float(gstats['loss/total']):.6f} vs {float(cstats['loss/total']):.6f}")


def run_main_path(get_preset, ttrain, plume):
    """The full-width train step: warm-up, then three timed iterations with
    the launch counts read around them."""
    import torch

    cfg = get_preset("ppo_v2_0")
    cfg = cfg.replace(ppo=dataclasses.replace(cfg.ppo, minibatch_size=65536))
    n, t = cfg.rollout.num_envs, cfg.rollout.unroll_length
    loop = ttrain.init_loop(cfg, "cuda")
    step = ttrain.build_train_step(cfg, time_phases=True)
    t0 = time.perf_counter()
    loop, stats, _ = step(loop)
    torch.cuda.synchronize()
    log(f"main path warm-up iteration: {time.perf_counter() - t0:.3f} s")

    iters = 3
    phases = {"rollout": 0.0, "gae": 0.0, "update": 0.0}
    plume.launches = 0
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
    launches = plume.launches
    expected = iters * 2 * t
    assert launches == expected, f"plume launches {launches} != {expected}"
    sps = iters * n * t / wall
    log(f"main path ppo_v2_0 {n} envs x {t} steps, minibatch "
        f"{cfg.ppo.minibatch_size}, {cfg.ppo.epochs} epochs: {iters} "
        f"iterations in {wall:.3f} s = {sps:.1f} env-steps/s")
    log("main path ms per iteration: " + ", ".join(
        f"{k} {v / iters:.2f}" for k, v in phases.items())
        + f", whole {wall / iters * 1e3:.2f}")
    log(f"main path last iteration: loss/total {float(stats['loss/total']):.5f}"
        f", episodes {stats['rollout/episodes']}, radius "
        f"{stats['curriculum/radius']:.2f}; plume_sample launches {launches}")
    profile_iteration(step, loop)
    return {"plume_sample": launches}


def run_cli(cli_main, ActorCritic):
    import torch

    with tempfile.TemporaryDirectory() as tmp:
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            cli_main(["train", "--preset", "ppo_v2_0", "--out", tmp,
                      "--iterations", "2", "--minibatch", "65536"])
        res = json.loads(out.getvalue().strip().splitlines()[-1])
        assert res["env_steps"] == 2 * 4096 * 128, res
        with open(os.path.join(tmp, "training_results.csv")) as fh:
            rows = fh.read().strip().splitlines()
        assert len(rows) - 1 == res["episodes"], (len(rows), res)
        ckpt = torch.load(os.path.join(tmp, "checkpoint.pt"),
                          weights_only=False)
        assert ckpt["counters"]["iteration"] == 2
        model = ActorCritic(6, 5, (256, 128))
        model.load_state_dict(torch.load(
            os.path.join(tmp, "model", "ppo_successful_models.pth")))
        log(f"cli train: 2 iterations, {res['episodes']} episodes in the CSV, "
            f"{res['steps_per_sec']:.1f} env-steps/s after the first; "
            "checkpoint and .pth load")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from tpu_plume_torch.cli.main import main as cli_main
    from tpu_plume_torch.core.config import RolloutConfig, get_preset
    from tpu_plume_torch.models import ActorCritic
    from tpu_plume_torch.ops import build, plume
    from tpu_plume_torch.rollout.rollout import draw_chunk
    from tpu_plume_torch.train import ppo_trainer as ttrain

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(f"card: {card}; {torch.cuda.get_device_name(0)}; torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    build.build("plume", verbose=True)
    log(f"kernel build: plume {time.perf_counter() - t0:.2f} s")

    plume_report = check_plume_kernel(get_preset, plume)
    check_small_iteration_against_cpu(get_preset, RolloutConfig, ttrain,
                                      draw_chunk)
    launches = run_main_path(get_preset, ttrain, plume)
    run_cli(cli_main, ActorCritic)

    main_t = plume_report["timing"][MAIN_N]
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
    }]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
