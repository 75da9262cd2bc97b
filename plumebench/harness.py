"""One run of a cell: set-up, the checked steps, the timed window, the
traced readings and the comparison with the reference.

The program is driven as ``train_ppo`` drives it with no CSV
(``tpu_plume_torch/train/ppo_trainer.py``): one train step from
``build_train_step`` per iteration over the loop of ``init_loop``, and
every ``sync_every`` iterations the window's stats brought to the host in
one transfer (``train/hostsync.py`` ``drain_window``).  The benchmark
hands the program its inputs (``plumebench.inputs``): the policy's
parameters, the bank, the initial episodes' draws, and for the first
``checked_steps`` iterations the chunks' draws and the update's shuffles
(``train_step(loop, draws=, shuffles=)``); the window's iterations
draw their own from the loop's generator, as ``train_ppo``'s do.

Set-up ends with one iteration as ``train_ppo`` runs it, with its drain,
so every shape the window uses has run.  The window then counts the whole
iterations that end inside ``seconds``, each ending on a synchronised
device.  With ``trace`` the run goes on: three iterations with the
program's phase timing (``time_phases``), one profiled iteration, one
profiled rollout chunk; the per-layer readers read them.  Once the program
is done and its memory peak read, its state is freed and the reference
follows the checked steps from the same inputs, made again from the seed,
with the field that the configuration names and the policy of its
``ppo.arch``.
"""

from __future__ import annotations

import dataclasses
import gc
import math
import subprocess
import sys
import time
from types import SimpleNamespace

import torch

from plumebench import check, profiling, registry
from plumebench.inputs import Inputs
from plumebench.reference import train as reference

GIB = float(2**30)
PHASE_ITERS = 3


def log(t_process: float, msg: str) -> None:
    """A progress line on standard error, with the seconds since the
    process started."""
    print(f"[{time.time() - t_process:8.2f} s] {msg}", file=sys.stderr,
          flush=True)


def set_precision() -> None:
    """The precision ``cli train`` sets (``cli/main.py`` ``set_precision``):
    TF32 off in cuBLAS and cuDNN."""
    from tpu_plume_torch.cli.main import set_precision as program_precision

    program_precision()


def build(spec, seed: int, device: torch.device) -> SimpleNamespace:
    """The program's loop and train step over the benchmark's inputs."""
    from tpu_plume_torch.env.methane import reset_from_draws
    from tpu_plume_torch.fields.gridded import FieldBank
    from tpu_plume_torch.train import ppo_trainer

    inputs = Inputs(spec, seed, device)
    cfg = registry.train_config(spec, seed)
    bank = None
    if inputs.bank is not None:
        b = inputs.bank
        bank = FieldBank(conc=b["conc"], source=b["source"], wind=b["wind"],
                         steps_per_frame=b["steps_per_frame"],
                         z_extent=b["z_extent"])
    loop = ppo_trainer.init_loop(cfg, device, bank)
    loop.model.load_state_dict(inputs.params)
    state, obs = reset_from_draws(
        inputs.u_src, inputs.u_wind, inputs.bits, cfg.env,
        cfg.curriculum.initial_radius, cfg.env.explore_bonus_init, bank)
    loop = dataclasses.replace(loop, rollout=dataclasses.replace(
        loop.rollout, env_state=state, obs=obs))
    return SimpleNamespace(cfg=cfg, bank=bank, loop=loop, inputs=inputs,
                           step=ppo_trainer.build_train_step(cfg, bank))


def checked_steps(prog, steps: int) -> dict:
    """The program's first ``steps`` iterations on the benchmark's draws:
    {"losses", "first_grad", "first_moment", "change"}, as
    ``reference.run`` returns them.  Adam's first moment is read from the
    optimizer's state after its first update (through an observer on that
    one object, removed before the window) and after the first step."""
    from tpu_plume_torch.rollout.rollout import ChunkDraws

    names = [n for n, _ in prog.loop.model.named_parameters()]
    opt = prog.loop.optimizer
    seen = {}

    def moment():
        return {names[i]: s["exp_avg"].detach().clone()
                for i, s in opt.state_dict()["state"].items()
                if "exp_avg" in s}

    def observed_step(update=opt.step):
        update()
        if not seen:
            seen.update(moment())

    opt.step = observed_step
    losses, first_moment = [], None
    try:
        for k in range(steps):
            draws, shuffles = prog.inputs.step(k)
            prog.loop, stats, _ = prog.step(
                prog.loop, draws=ChunkDraws(**draws), shuffles=shuffles)
            losses.append(float(stats["loss/total"]))
            if k == 0:
                first_moment = moment()
    finally:
        del opt.step
    change = {n: p.detach() - prog.inputs.params[n]
              for n, p in prog.loop.model.named_parameters()}
    return {"losses": losses, "first_grad": seen,
            "first_moment": first_moment, "change": change}


def drain(pending: list) -> int:
    """The window's stats on the host in one transfer (``drain_window``);
    the count of iterations whose loss is not finite."""
    from tpu_plume_torch.train.hostsync import drain_window

    host = drain_window([(stats, None) for stats in pending])
    pending.clear()
    return sum(not math.isfinite(float(stats["loss/total"]))
               for stats, _ in host)


def window(prog, spec, seconds: float, device) -> dict:
    """The timed window: iterations as ``train_ppo`` runs them until one
    ends past ``seconds``; that one is not counted (the first always is).
    Returns the count, the span from the start to the last counted end,
    each counted iteration's ms, the failed count and the start's wall
    clock."""
    pending, failed, iter_ms = [], 0, []
    profiling.sync(device)
    start_wall = time.time()
    t0 = time.perf_counter()
    t_end = t0
    while True:
        ti = time.perf_counter()
        prog.loop, stats, _ = prog.step(prog.loop)
        pending.append(stats)
        if len(pending) >= spec.sync_every:
            failed += drain(pending)
        profiling.sync(device)
        t = time.perf_counter()
        if t - t0 > seconds and iter_ms:
            break
        iter_ms.append((t - ti) * 1e3)
        t_end = t
    if pending:
        failed += drain(pending)
    return {"iters": len(iter_ms), "span_s": t_end - t0, "iter_ms": iter_ms,
            "failed": failed, "start_wall": start_wall}


def power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` prints them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout else "not read"
    except (OSError, subprocess.SubprocessError):
        return "not read"


def traced(prog, spec, device, ctx: SimpleNamespace) -> None:
    """The traced run's readings into ``ctx``: phase ms, one profiled
    iteration (kernels, busy time, idle gaps, its trajectory) and one
    profiled rollout chunk's device launches."""
    from tpu_plume_torch.rollout.rollout import rollout_chunk
    from tpu_plume_torch.train import ppo_trainer

    phases = ppo_trainer.build_train_step(prog.cfg, prog.bank,
                                          time_phases=True)
    sums = {"rollout": 0.0, "gae": 0.0, "update": 0.0}
    for _ in range(PHASE_ITERS):
        prog.loop, stats, _ = phases(prog.loop)
        for k in sums:
            sums[k] += stats[f"time/{k}_ms"]
    ctx.phase_ms = {k: v / PHASE_ITERS for k, v in sums.items()}

    def iteration():
        prog.loop, _, traj = prog.step(prog.loop)
        return traj

    prof, wall, trajs = profiling.profile(iteration, device)
    ctx.kernels = profiling.device_kernels(prof)
    dev, host = profiling.timeline(prof)
    ctx.profiled_iters, ctx.profiled_wall_s = len(trajs), wall
    ctx.busy_s = profiling.busy_seconds(dev)
    ctx.idle_gaps = profiling.idle_gaps(dev, host)
    ctx.trajs = trajs
    del prof

    cfg = prog.cfg
    prof, _, _ = profiling.profile(
        lambda: rollout_chunk(prog.loop.model, prog.loop.rollout, cfg.env,
                              cfg.rollout.unroll_length, bank=prog.bank),
        device)
    ctx.rollout_launches = sum(c for _, c, _ in profiling.device_kernels(prof))
    del prof
    ctx.power = power_limit()


def kernel_time(ctx, names) -> tuple:
    """(launches, device seconds) of the profiled iteration's kernels whose
    name holds one of ``names``."""
    hits = [(c, s) for key, c, s in ctx.kernels
            if any(n in key for n in names)]
    return sum(c for c, _ in hits), sum(s for _, s in hits)


def run(spec, seed: int, seconds: float, trace: bool, device,
        t_process: float) -> dict:
    """One run of ``spec`` (``registry.Spec``) on ``device``; ``t_process``
    is the process's start (wall clock).  Returns {"result": the contract's
    line without "checks", "checks": {name: {"value", "limit"}},
    "readings"}."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    set_precision()
    log(t_process, f"{spec.cell} seed {seed}: set-up")
    prog = build(spec, seed, device)
    log(t_process, "built the loop, the train step and the inputs")
    got = checked_steps(prog, spec.checked_steps)
    log(t_process, f"ran the {spec.checked_steps} checked steps")
    # warm-up: one iteration as the window runs it, with its drain
    prog.loop, stats, _ = prog.step(prog.loop)
    drain([stats])
    del stats
    log(t_process, "warmed up; the window opens")

    w = window(prog, spec, seconds, device)
    ms = sorted(w["iter_ms"])
    log(t_process, f"window: {w['iters']} iterations in {w['span_s']:.3f} s; "
        f"iteration ms min {ms[0]:.2f} median {ms[len(ms) // 2]:.2f} max "
        f"{ms[-1]:.2f}")
    n, t = spec.num_envs, spec.unroll_length
    ctx = SimpleNamespace(spec=spec, cfg=prog.cfg, bank=prog.inputs.bank,
                          iter_ms=w["iter_ms"], window_iters=w["iters"],
                          window_s=w["span_s"], kernel_time=None)
    if trace:
        traced(prog, spec, device, ctx)
        ctx.kernel_time = lambda names: kernel_time(ctx, names)
        log(t_process, "traced")
    device_info = {
        "platform": "gpu" if cuda else device.type,
        "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
        "count": 1,
        "memory_peak_bytes": (torch.cuda.max_memory_allocated(device)
                              if cuda else 0)}
    result = {"correct": False, "attempted": w["iters"], "failed": w["failed"]}
    if trace:
        out = {}
        for m in registry.metrics():
            value = m.read(ctx, m)
            if value is not None:
                out[m.name] = {"value": value, "unit": m.entry["unit"]}
        result["metrics"] = out
        device_info.update(busy_s=ctx.busy_s, window_s=ctx.profiled_wall_s,
                           power=ctx.power)
        result["device"] = device_info
        result["breakdown"] = {"device_ops": profiling.top_ops(ctx.kernels),
                               "idle_gaps": ctx.idle_gaps}
    else:
        result["metrics"] = {
            "train_env_steps_per_s": {
                "value": w["iters"] * n * t / w["span_s"],
                "unit": "env-steps/s"},
            "peak_mem_gib": {"value": device_info["memory_peak_bytes"] / GIB,
                             "unit": "GiB"},
            "setup_s": {"value": w["start_wall"] - t_process, "unit": "s"}}
        result["device"] = device_info

    # the reference, once the program's state is freed
    del prog, ctx
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    log(t_process, "the reference")
    t_ref = time.perf_counter()
    want = reference.run(spec, registry.reference_field(spec),
                         registry.reference_policy(spec),
                         Inputs(spec, seed, device), spec.checked_steps)
    log(t_process, f"the reference took {time.perf_counter() - t_ref:.2f} s")
    values = check.readings(got, want)
    result["correct"], checks = check.verdict(values, spec.limits)
    return {"result": result, "checks": checks, "readings": values}
