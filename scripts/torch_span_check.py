"""One traced benchmark run of a cell with the span recorder's window
checked, on the card.

    python3 scripts/torch_span_check.py --workload <cell> --seed <n>
        [--seconds 40] [--json PATH]

Runs ``plumebench.harness.run`` as ``python3 -m plumebench.run --trace 1``
does, then reads the recorder (``tpu_plume_torch/obsv/trace.py``) over the
timed window as the benchmark's span readers select it
(``plumebench/metrics/rollout_host_ms.py`` ``window``) and prints one JSON
line: the result line's per-layer metrics, device entries and breakdown, the
window's iterations and wall, the share of that wall its ``iteration``
spans and drains cover, the least resolved device duration, each phase's
host and device ms (median, least, most) and the drains' ms.  Then what
the spans cost, on the cell built again: the recorder's own host us per
iteration, over ``COST_ITERS`` iterations that record their spans and
markers around no work; the host us of one empty range under
``torch.profiler`` (CPU and CUDA activity), the recorder's and
``record_function``'s, over ``COST_ITERS`` ranges each; and ``PROFILED``
profiled iterations (the benchmark's ``profiling.profile``) with the
ranges and as many without them, in turns, each one's wall and device
busy seconds.  Needs a CUDA card; imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time
from types import SimpleNamespace

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

COST_ITERS = 2000
PROFILED = 4


def spread(values: list) -> dict:
    return {"median": statistics.median(values), "min": min(values),
            "max": max(values)} if values else None


def recorder_us(trace) -> float:
    """Host us per iteration of the recorder alone: its ``iteration``,
    three phase spans with markers and a ``read``, as a train step records
    them, on the card's stream, less the read's synchronise."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(COST_ITERS):
        torch.cuda.synchronize()            # the read's wait, alone
    t1 = time.perf_counter()
    for _ in range(COST_ITERS):
        rec = trace.begin("cuda")
        for name in trace.PHASES:
            with rec.phase(name, ranged=name == "gae"):
                pass
        with rec.read():
            torch.cuda.synchronize()
        rec.end()
    t2 = time.perf_counter()
    return ((t2 - t1) - (t1 - t0)) * 1e6 / COST_ITERS


def range_us(make) -> float:
    """Host us of one empty range ``make(name)`` under the profiler."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        t0 = time.perf_counter()
        for _ in range(COST_ITERS):
            with make("update.grads"):
                pass
        t1 = time.perf_counter()
    return (t1 - t0) * 1e6 / COST_ITERS


def profiled(prog, trace, ranges: bool) -> tuple:
    """(wall s, device busy s) of one profiled iteration of ``prog``, its
    ranges on or, with the recorder told that no profiler records, off."""
    from plumebench import profiling

    def iteration():
        prog.loop, _, _ = prog.step(prog.loop)

    recording = trace.profiling
    if not ranges:
        trace.profiling = lambda: False
    try:
        prof, wall, _ = profiling.profile(iteration,
                                          prog.loop.rollout.obs.device)
    finally:
        trace.profiling = recording
    return wall, profiling.busy_seconds(profiling.timeline(prof)[0])


def costs(spec, seed: int, trace, device: str = "cuda") -> dict:
    from plumebench import harness

    prog = harness.build(spec, seed, device)
    for _ in range(2):
        prog.loop, _, _ = prog.step(prog.loop)
    from torch.autograd.profiler import record_function

    out = {"recorder_us": recorder_us(trace),
           "range_us": range_us(trace.Range),
           "record_function_us": range_us(record_function),
           "with_ranges": [], "without_ranges": []}
    for k in range(2 * PROFILED):
        ranges = k % 4 in (0, 3)            # on, off, off, on, ...
        out["with_ranges" if ranges else "without_ranges"].append(
            profiled(prog, trace, ranges))
    return out


def main(argv=None) -> int:
    t_process = time.time()
    ap = argparse.ArgumentParser(prog="python3 scripts/torch_span_check.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=40.0)
    ap.add_argument("--json")
    args = ap.parse_args(argv)

    from plumebench import harness, registry
    from plumebench.metrics.rollout_host_ms import window as select
    from tpu_plume_torch.obsv import trace

    seen = {}
    timed = harness.window

    def spy(*a, **k):
        seen.update(timed(*a, **k))
        return seen

    harness.window = spy
    out = harness.run(registry.spec(args.workload), args.seed, args.seconds,
                      True, "cuda", t_process)
    run = select(SimpleNamespace(window_iters=seen["iters"]))
    report = {"workload": args.workload, "seed": args.seed,
              "correct": out["result"]["correct"],
              "metrics": {k: v["value"]
                          for k, v in out["result"]["metrics"].items()},
              "device": out["result"]["device"],
              "breakdown": out["result"]["breakdown"],
              "window_iters": seen["iters"], "window_s": seen["span_s"],
              "selected": None if run is None else len(run)}
    if run is not None:
        covered = sum(r.span.host_ms + sum(d.host_ms for d in r.drains)
                      for r in run)
        device = [s.device_ms for r in run for s in r.phases
                  if s.device_ms is not None]
        report.update(
            cover=covered / (seen["span_s"] * 1e3),
            least_device_ms=min(device),
            drains=spread([d.host_ms for r in run for d in r.drains]),
            iteration_ms=spread([r.span.host_ms for r in run]))
        for name in trace.PHASES + ("read",):
            spans = [r.get(name) for r in run]
            report[name] = {
                "host_ms": spread([s.host_ms for s in spans]),
                "device_ms": spread([s.device_ms for s in spans
                                     if s.device_ms is not None])}
    report["cost"] = costs(registry.spec(args.workload), args.seed, trace)
    line = json.dumps(report)
    print(line, flush=True)
    if args.json:
        os.makedirs(os.path.dirname(args.json) or ".", exist_ok=True)
        with open(args.json, "a") as fh:
            fh.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
