"""The port's ppo_v2_0 train step against another tree's, on one GPU.

    python3 scripts/torch_rollout_ab.py --other DIR [--blocks 4]
        [--variants f32,fused_update,bf16_compute] [--json PATH]

``DIR`` is a checkout of another commit (for example the parent, unpacked
with ``git archive`` into a directory that ``.gitignore`` lists).  The
script runs the two trees in alternating blocks (other, this, this, other,
...), each block a process of its own that imports that tree's
``tpu_plume_torch``, builds its kernels (one ``nvcc`` per source, all
started together) and runs the full-width ppo_v2_0 train step (4096 envs x
128 steps, minibatch 65536, 5 epochs) in its three variants (f32,
``fused_update``, ``bf16_compute``, or those ``--variants`` names): per
variant one warm-up iteration, two timed iterations (env-steps/s, ms per
phase), one profiled rollout chunk (device launches per env step, device
and wall ms) and one profiled iteration (launches, device busy share),
with ``chip_smoke.py``'s helpers; then the env-step kernel alone on
ppo_v2_0 at N = 4096 and 2^20 (per call, device and plain ms, bound).
Prints the card's name and power limit, one line per block and variant,
and one JSON line, also written to the file ``--json`` names.  Needs a
CUDA card and ``nvcc``; imports no JAX.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import dataclasses
import glob
import importlib.util
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VARIANTS = {"f32": {}, "fused_update": dict(fused_update=True),
            "bf16_compute": dict(bf16_compute=True)}
MINIBATCH = 65536


def this_chip_smoke():
    """This tree's ``chip_smoke.py`` (its timing and profiling helpers),
    whichever tree's package is imported."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def worker(tree: str, variants) -> dict:
    """One block: ``tree``'s train step in each of ``variants``, then its
    env-step kernel alone."""
    sys.path.insert(0, tree)
    import torch

    chip_smoke = this_chip_smoke()
    from tpu_plume_torch.core.config import get_preset
    from tpu_plume_torch.ops import build, plume
    from tpu_plume_torch.rollout import rollout
    from tpu_plume_torch.rollout.rollout import rollout_chunk
    from tpu_plume_torch.train import ppo_trainer as ttrain

    torch.backends.cuda.matmul.allow_tf32 = False
    names = sorted(os.path.basename(p)[:-3] for p in glob.glob(
        os.path.join(tree, "tpu_plume_torch", "csrc", "*.cu")))
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        list(pool.map(build.build, names))
    out = {"tree": tree, "build_s": time.perf_counter() - t0}
    v20 = get_preset("ppo_v2_0")
    for name in variants:
        flags = VARIANTS[name]
        cfg = v20.replace(ppo=dataclasses.replace(
            v20.ppo, minibatch_size=MINIBATCH, **flags))
        n, t = cfg.rollout.num_envs, cfg.rollout.unroll_length
        loop = ttrain.init_loop(cfg, "cuda")
        step = ttrain.build_train_step(cfg, time_phases=True)
        loop, _, _ = step(loop)
        torch.cuda.synchronize()
        phases = {"rollout": 0.0, "gae": 0.0, "update": 0.0}
        iters = 2
        t0 = time.perf_counter()
        for _ in range(iters):
            loop, stats, _ = step(loop)
            for key in phases:
                phases[key] += stats[f"time/{key}_ms"] / iters
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        roll = chip_smoke.profile_rollout(rollout_chunk, loop, cfg)
        loop, busy, launches, _ = chip_smoke.profile_iteration(step, loop)
        out[name] = dict(sps=iters * n * t / wall, whole_ms=wall / iters * 1e3,
                         busy=busy, launches=launches, rollout_profile=roll,
                         **phases)
        del loop, step
        torch.cuda.empty_cache()
    out["env_step"] = chip_smoke.time_env_step_kernel(
        get_preset, plume, rollout, presets=("ppo_v2_0",))["ppo_v2_0"]
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", help="a checkout of the other tree")
    ap.add_argument("--blocks", type=int, default=4)
    ap.add_argument("--variants", default=",".join(VARIANTS),
                    help="comma-separated train-step variants to run")
    ap.add_argument("--json", help="also write the report here")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    variants = args.variants.split(",")
    for name in variants:
        if name not in VARIANTS:
            ap.error(f"unknown variant {name!r}; one of {list(VARIANTS)}")
    if args.worker:
        print(json.dumps(worker(args.worker, variants)), flush=True)
        return 0

    import torch

    chip_smoke = this_chip_smoke()
    if not torch.cuda.is_available():
        print("torch_rollout_ab: no CUDA device", file=sys.stderr)
        return 1
    card = chip_smoke.card_line()
    print(f"card: {card}", flush=True)
    trees = {"this": REPO, "other": os.path.abspath(args.other)}
    # other, this, this, other, ...
    order = [("other", "this")[(i + 1) // 2 % 2] for i in range(args.blocks)]
    blocks = []
    for i, label in enumerate(order):
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--worker",
             trees[label], "--variants", args.variants],
            capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            raise RuntimeError(f"block {i} ({label}) failed")
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        res["label"] = label
        blocks.append(res)
        for n, e in res["env_step"].items():
            if n != "split_ns":
                print(f"block {i} {label} env_step ppo_v2_0 N={n}: per call "
                      f"{e['ms']:.5f} ms, device {e['device_ms']} ms, plain "
                      f"{e['plain_ms']:.5f} ms, bound {e['bound_ms']:.6f} ms",
                      flush=True)
        for name in variants:
            r = res[name]
            roll = r["rollout_profile"]
            print(f"block {i} {label} {name}: {r['sps']:.1f} env-steps/s, "
                  f"rollout {r['rollout']:.2f} ms, gae {r['gae']:.2f}, "
                  f"update {r['update']:.2f}, whole {r['whole_ms']:.2f}; "
                  f"profiled rollout {roll['launches_per_step']:.2f} launches "
                  f"per env step, device {roll['device_ms']:.2f} of "
                  f"{roll['wall_ms']:.2f} ms; profiled iteration "
                  f"{r['launches']} launches, busy {r['busy']:.4f}",
                  flush=True)
    result = {"card": card, "blocks": blocks}
    if args.json:
        with open(args.json, "w") as fh:
            json.dump(result, fh)
    print(card)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
