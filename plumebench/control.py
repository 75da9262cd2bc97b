"""The readings the limits are set from, for one cell, in one process (the
benchmark's runs never run this):

- the lower reading: each compared number of sound runs, the program's
  checked steps against the reference's, on every seed of ``--seeds``;
- the upper readings: on every seed of ``--control-seeds``, the control
  (the reference computed in TF32, the precision below the configuration's
  float32 with TF32 off, put in the program's place) and the planted faults
  (``reference.train.VARIANTS``: half of each minibatch left out, the
  rollout's rewards altered where produced) against the reference.  A
  state left unchanged reads 1 on ``change_gap`` and ``grad_gap`` by their
  measure, and needs no run.

    python3 -m plumebench.control --workload ppo_v2_0.train.n16384 --seeds 1,2,3 --control-seeds 4,5,6 --out chiprun_out/control.json

Each seed's readings are printed as a JSON line and all of them written to
``--out``.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import time

import torch

from plumebench import check, harness, registry
from plumebench.inputs import Inputs
from plumebench.reference import train as reference


def _free(device: torch.device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def sound(spec, seed: int, device) -> dict:
    """The program's checked steps against the reference's on ``seed``."""
    harness.set_precision()
    prog = harness.build(spec, seed, device)
    got = harness.checked_steps(prog, spec.checked_steps)
    del prog
    _free(device)
    want = reference.run(spec, registry.reference_field(spec),
                         registry.reference_policy(spec),
                         Inputs(spec, seed, device), spec.checked_steps)
    return check.details(got, want)


def upper(spec, seed: int, device) -> dict:
    """{variant: readings} of the control and the faults against the
    reference on ``seed``."""
    harness.set_precision()
    field = registry.reference_field(spec)
    policy = registry.reference_policy(spec)

    def outputs(variant):
        out = reference.run(spec, field, policy, Inputs(spec, seed, device),
                            spec.checked_steps, variant)
        _free(device)
        return out

    want = outputs("f32")
    return {v: check.details(outputs(v), want)
            for v in reference.VARIANTS if v != "f32"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m plumebench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--out", default=None)
    ap.add_argument("--cpu", action="store_true",
                    help="rehearse on the CPU (with --envs, --unroll)")
    ap.add_argument("--envs", type=int, default=None)
    ap.add_argument("--unroll", type=int, default=None)
    args = ap.parse_args(argv)
    overrides = {k: v for k, v in (("num_envs", args.envs),
                                   ("unroll_length", args.unroll))
                 if v is not None}
    spec = registry.spec(args.workload, overrides)
    device = torch.device("cpu" if args.cpu else "cuda")
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = [int(s) for s in args.control_seeds.split(",") if s]
    rows = []
    for kind, fn, todo in (("sound", sound, seeds), ("upper", upper, controls)):
        for seed in todo:
            t0 = time.perf_counter()
            row = {"cell": args.workload, "kind": kind, "seed": seed,
                   "readings": fn(spec, seed, device),
                   "seconds": time.perf_counter() - t0}
            rows.append(row)
            print(json.dumps(row), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(rows, fh, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
