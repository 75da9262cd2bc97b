"""The benchmark's command: one run of one cell on the card.

    python3 -m plumebench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``tpu_plume_torch``.  It prints the
compared numbers beside their limits as its last lines on standard error,
and one JSON object as the last line of standard output: ``correct``,
``attempted`` and ``failed`` (the window's iterations and those whose loss
was not finite), ``metrics`` (``--trace 0``: the end-to-end metrics;
``--trace 1``: the per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``.  Without a card, with fewer cards than
the cell needs, or with JAX or the JAX package loaded, it prints no result
and exits 1.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

# The benchmark's fixed cache directories inside the checkout, set before
# anything loads CUDA, so that only a checkout's first run builds.
_CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CACHE = os.path.join(_CHECKOUT, ".bench_cache")
for _var, _sub in (("CUDA_CACHE_PATH", "nv"), ("TRITON_CACHE_DIR", "triton"),
                   ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[_var] = os.path.join(_CACHE, _sub)


def process_start() -> float:
    """The wall clock at which this process started (Linux ``/proc``),
    else now."""
    try:
        with open("/proc/self/stat") as fh:
            ticks = int(fh.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as fh:
            boot = next(int(line.split()[1]) for line in fh
                        if line.startswith("btime "))
        return boot + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return time.time()


def parse(argv=None):
    ap = argparse.ArgumentParser(prog="python3 -m plumebench.run",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def line(out: dict) -> dict:
    """The result's line of ``harness.run``'s output: the contract's keys,
    and the compared numbers beside their limits last."""
    return dict(out["result"], checks=out["checks"])


def fail(msg: str) -> int:
    print(f"plumebench: {msg}", file=sys.stderr, flush=True)
    return 1


def main(argv=None) -> int:
    t_process = process_start()
    args = parse(argv)
    from plumebench import imports

    found = imports.forbidden_loaded()
    if found:
        return fail(f"JAX or the JAX package is loaded: {found}")
    faults = imports.reference_faults()
    if faults:
        return fail(f"the reference imports what it may not: {faults}")

    from plumebench import registry

    spec = registry.spec(args.workload)
    import torch

    print(f"[{time.time() - t_process:8.2f} s] imported torch",
          file=sys.stderr)
    if not torch.cuda.is_available():
        return fail("no CUDA device: the benchmark runs on the card only")
    if torch.cuda.device_count() < spec.chips:
        return fail(f"{args.workload} needs {spec.chips} cards, "
                    f"{torch.cuda.device_count()} present")

    from plumebench import harness

    print(f"[{time.time() - t_process:8.2f} s] found the card",
          file=sys.stderr)
    out = harness.run(spec, args.seed, args.seconds, bool(args.trace),
                      "cuda", t_process)
    found = imports.forbidden_loaded()
    if found:
        return fail(f"JAX or the JAX package was loaded during the run: "
                    f"{found}")
    result = line(out)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(f"correct: {result['correct']}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
