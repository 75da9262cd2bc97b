"""Reductions of a ``torch.profiler`` trace: the device's kernels (the
method of ``chip_smoke.py`` ``device_kernels``), the device's busy time as
the union of its operations' intervals, and the idle gaps between them by
what the host was doing."""

from __future__ import annotations

import bisect
import time

import torch

TOP = 10


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def profile(fn, device: torch.device):
    """Run ``fn`` twice under ``torch.profiler`` (CPU activity, and the
    card's), the first as the tracer's warm-up, which the trace leaves out
    (a cold tracer loses launches): (profiler, wall seconds of the second
    call, [its result])."""
    from torch.profiler import ProfilerActivity, schedule
    from torch.profiler import profile as torch_profile

    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if device.type == "cuda" else [])
    sync(device)
    with torch_profile(activities=acts, schedule=schedule(
            wait=0, warmup=1, active=1, repeat=1)) as prof:
        fn()
        sync(device)
        prof.step()
        t0 = time.perf_counter()
        out = fn()
        sync(device)
        wall = time.perf_counter() - t0
        prof.step()
    return prof, wall, [out]


def device_kernels(prof) -> list:
    """(name, count, device seconds) of every device entry of the trace,
    user annotations left out (they span kernels already counted)."""
    from torch.autograd import DeviceType

    return [(e.key, e.count, e.self_device_time_total * 1e-6)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.count
            and not getattr(e, "is_user_annotation", False)
            and "#" not in e.key]


def timeline(prof):
    """(device intervals, host top-level intervals) in seconds: the device
    operations' [start, end] sorted, and the host's outermost operations
    of every thread (below the profiler's own step ranges) as (start, end,
    name) sorted by start."""
    from torch.autograd import DeviceType

    def step_range(e) -> bool:
        return e is not None and e.name.startswith("ProfilerStep")

    dev, host = [], []
    for e in prof.events():
        start, end = e.time_range.start * 1e-6, e.time_range.end * 1e-6
        if e.device_type == DeviceType.CUDA:
            if not getattr(e, "is_user_annotation", False) and "#" not in e.name:
                dev.append((start, end))
        elif ((e.cpu_parent is None or step_range(e.cpu_parent))
              and not step_range(e)):
            host.append((start, end, e.name))
    dev.sort()
    host.sort()
    return dev, host


def union(intervals: list) -> list:
    out = []
    for s, e in intervals:
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def busy_seconds(intervals: list) -> float:
    return sum(e - s for s, e in union(intervals))


def idle_gaps(dev: list, host: list) -> list:
    """The gaps between the device's operations, summed by the host's
    outermost operation at each gap's middle (the latest-started one that
    spans it, over all threads; "host (between ops)" where none does):
    [[name, seconds]], the longest first, at most ``TOP``."""
    busy = union(dev)
    starts = [h[0] for h in host]
    total: dict = {}
    for (_, a), (b, _) in zip(busy, busy[1:]):
        mid = 0.5 * (a + b)
        name = "host (between ops)"
        i = bisect.bisect_right(starts, mid) - 1
        # the outermost operations of one thread do not overlap, and a few
        # threads run at once: look back over a few predecessors
        for j in range(i, max(i - 8, -1), -1):
            if host[j][1] >= mid:
                name = host[j][2]
                break
        total[name] = total.get(name, 0.0) + (b - a)
    return sorted(([k, v] for k, v in total.items()),
                  key=lambda kv: -kv[1])[:TOP]


def top_ops(kernels: list) -> list:
    """[[name, seconds]] of the device entries that took most time."""
    ranked = sorted(kernels, key=lambda k: -k[2])[:TOP]
    return [[name[:160], s] for name, _, s in ranked]
