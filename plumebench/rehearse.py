"""A rehearsal of a cell on the CPU at a tiny size: its set-up, the checked
steps, a short window, the traced readings and the comparison with the
reference, through the same files and the port's plain paths (the env
steps, the bank sample and the fused gradients in plain PyTorch).  What it
prints is a rehearsal, never a measurement: its numbers are the CPU's.

    python3 -m plumebench.rehearse --workload ppo_v2_0.train.n16384 --envs 64 --unroll 8
"""

from __future__ import annotations

import argparse
import json
import time

from plumebench import harness, registry


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m plumebench.rehearse")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=3)
    ap.add_argument("--envs", type=int, default=64)
    ap.add_argument("--unroll", type=int, default=8)
    ap.add_argument("--seconds", type=float, default=0.5)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=1)
    args = ap.parse_args(argv)
    spec = registry.spec(args.workload, {"num_envs": args.envs,
                                         "unroll_length": args.unroll})
    t0 = time.time()
    out = harness.run(spec, args.seed, args.seconds, bool(args.trace), "cpu",
                      t0)
    print(json.dumps({"rehearsal": args.workload, "envs": args.envs,
                      "unroll": args.unroll, "wall_s": time.time() - t0,
                      **out["result"], "checks": out["checks"]}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
