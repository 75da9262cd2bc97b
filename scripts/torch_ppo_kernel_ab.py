"""The port's fused PPO kernels against those of another tree, on one GPU.

    python3 scripts/torch_ppo_kernel_ab.py --other DIR [--blocks 4]

``DIR`` is a checkout of another commit (for example the parent, unpacked
with ``git archive`` into a directory that ``.gitignore`` lists).  The
script builds this tree's ``tpu_plume_torch/csrc/ppo.cu`` and the other
tree's, in parallel; holds this tree's kernels to their plain version over
the 16 shapes of ``chip_smoke.py``'s ``check_ppo_kernel`` (and to autodiff
in f32), with bit-equal repeats; then times both trees' wrappers at the
main path's minibatch (65536 rows, 6 -> 256 -> 128 -> 5) in f32 and bf16
compute, in alternating blocks (this, other, other, this, ...), each block
a CUDA-event time of back-to-back calls and the device time of each kernel
from ``torch.profiler``; autodiff's forward and backward of ``ppo_loss`` on
the same minibatch once per dtype.  With ``--phases`` it also builds this
tree's kernels with ``PPO_PHASE_CLOCKS`` and prints the row kernel's clock
cycles by phase (block 0, one call).  Prints the card's name and power limit
and one JSON line, also written to the file ``--json`` names.  Needs a CUDA
card and ``nvcc``; imports no JAX.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import importlib.util
import json
import os
import subprocess
import sys
import time
from unittest import mock

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402  (its helpers: timing, batches, the bound)

# Kernel names as the profiler reports them, by tree.
NEW_KERNELS = ("ppo_row_kernel", "ppo_dw2_kernel", "ppo_reduce_kernel")
OLD_KERNELS = ("ppo_fused_kernel", "ppo_reduce_kernel")


def build_lib(build, tree: str, name: str, *flags) -> str:
    """``tree``'s ``csrc/ppo.cu`` built with ``flags`` into its
    ``_build/lib<name>.so``."""
    src = os.path.join(tree, "tpu_plume_torch", "csrc", "ppo.cu")
    out_dir = os.path.join(tree, "tpu_plume_torch", "_build")
    os.makedirs(out_dir, exist_ok=True)
    out = os.path.join(out_dir, f"lib{name}.so")
    proc = subprocess.run([build.nvcc_path(), *build.nvcc_flags(), *flags,
                           "-Xptxas", "-v", "-o", out, src],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stderr}")
    print(proc.stderr, end="")
    return out


def load_wrapper(build, tree: str, lib_path: str, name: str):
    """``tree``'s ``ops/ppo.py`` as a module of its own, bound to the
    library at ``lib_path``."""
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(tree, "tpu_plume_torch", "ops", "ppo.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    lib = ctypes.CDLL(lib_path)
    with mock.patch.object(build, "load", lambda name: lib):
        mod._library()
    return mod, lib


# The row kernel's phases as PHASE(i) in csrc/ppo.cu ends them.
PHASES = ("obs, z1", "LayerNorm 1", "z2 product", "LayerNorm 2", "heads",
          "loss", "head grads", "dy2", "dg2, dbe2", "LayerNorm 2 back",
          "db2, dz2 out", "dh1 product", "dg1, dbe1", "LayerNorm 1 back",
          "dW1, db1")


def phase_clocks(build, batch, model, cfg_cls) -> dict:
    """Clock cycles of each phase of the row kernel's block 0 over one call
    at the main width, f32 and bf16, from a build with PPO_PHASE_CLOCKS."""
    import torch

    lib_path = build_lib(build, REPO, "ppo_phases", "-DPPO_PHASE_CLOCKS")
    mod, lib = load_wrapper(build, REPO, lib_path, "ppo_phases")
    read = lib.ppo_phase_clocks
    read.argtypes = [ctypes.c_void_p]
    out = {}
    for bf16 in (False, True):
        cfg = cfg_cls(minibatch_size=batch.obs.shape[0], bf16_compute=bf16)
        cycles = (ctypes.c_ulonglong * 16)()
        mod.fused_ppo_grads_cuda(model, batch, cfg)
        torch.cuda.synchronize()
        read(ctypes.addressof(cycles))
        mod.fused_ppo_grads_cuda(model, batch, cfg)
        torch.cuda.synchronize()
        assert read(ctypes.addressof(cycles)) == 0
        total = sum(cycles)
        out["bf16" if bf16 else "f32"] = {
            name: cycles[i] for i, name in enumerate(PHASES)}
        print(f"row kernel block 0 phases, {'bf16' if bf16 else 'f32'}: "
              f"{total} cycles; " + ", ".join(
                  f"{name} {cycles[i] / total:.3f}"
                  for i, name in enumerate(PHASES)), flush=True)
    return out


def main() -> int:
    import torch

    parser = argparse.ArgumentParser()
    parser.add_argument("--other", required=True)
    parser.add_argument("--blocks", type=int, default=4)
    parser.add_argument("--reps", type=int, default=50)
    parser.add_argument("--no-parity", action="store_true")
    parser.add_argument("--phases", action="store_true",
                        help="also the row kernel's cycles by phase")
    parser.add_argument("--json", help="also write the report here")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    from tpu_plume_torch.core.config import PPOConfig
    from tpu_plume_torch.models import ActorCritic
    from tpu_plume_torch.ops import build
    from tpu_plume_torch.ops import ppo as new
    from tpu_plume_torch.rl.ppo import PPOBatch, ppo_loss

    torch.backends.cuda.matmul.allow_tf32 = False
    card = chip_smoke.card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        mine = pool.submit(build.build, "ppo", True)
        theirs = pool.submit(build_lib, build, args.other, "ppo_other")
        mine.result()
        other_lib = theirs.result()
    print(f"built both in {time.perf_counter() - t0:.2f} s", flush=True)
    old, _ = load_wrapper(build, args.other, other_lib, "ppo_other")

    mods = (ActorCritic, PPOConfig, PPOBatch, new, ppo_loss)
    worst = None if args.no_parity else chip_smoke.check_ppo_kernel(*mods)

    model = ActorCritic(chip_smoke.MAIN_D, chip_smoke.MAIN_A,
                        chip_smoke.MAIN_HIDDEN).reset_parameters(
        torch.Generator().manual_seed(11)).cuda()
    batch = chip_smoke.ppo_batch(PPOBatch, chip_smoke.MAIN_MB,
                                 chip_smoke.MAIN_D, seed=11)
    report = {"card": card, "max_abs_err": worst, "blocks": []}
    if args.phases:
        report["phase_cycles"] = phase_clocks(build, batch, model, PPOConfig)
    for bf16 in (False, True):
        key = "bf16" if bf16 else "f32"
        cfg = PPOConfig(minibatch_size=chip_smoke.MAIN_MB, bf16_compute=bf16)
        want, _ = new.fused_ppo_grads_plain(model, batch, cfg)
        got, _ = old.fused_ppo_grads_cuda(model, batch, cfg)
        torch.cuda.synchronize()
        old_err = max(float((got[n] - want[n]).abs().max()) for n in want)
        net = model.twin(torch.bfloat16) if bf16 else model

        def autodiff():
            net.zero_grad(set_to_none=True)
            ppo_loss(net, batch, cfg)[0].backward()

        bound_ms, bound_by = chip_smoke.ppo_bound(
            chip_smoke.MAIN_MB, chip_smoke.MAIN_D, *chip_smoke.MAIN_HIDDEN,
            chip_smoke.MAIN_A, bf16)
        entry = {"dtype": key, "bound_ms": bound_ms, "bound_by": bound_by,
                 "other_max_abs_err_vs_plain": old_err,
                 "autodiff_ms": chip_smoke.cuda_ms(autodiff, 20),
                 "this": [], "other": []}
        for i in range(args.blocks):
            order = (("this", new, NEW_KERNELS), ("other", old, OLD_KERNELS))
            for name, mod, kernels in (order if i % 2 == 0 else order[::-1]):
                def call(mod=mod):
                    mod.fused_ppo_grads_cuda(model, batch, cfg)

                ms = chip_smoke.cuda_ms(call, args.reps)
                dev = {k: chip_smoke.kernel_device_ms(call, k, reps=20)
                       for k in kernels}
                entry[name].append({"ms": ms, "device_ms": dev})
                print(f"{key} block {i} {name}: per call {ms:.4f} ms, device "
                      + ", ".join(f"{k} {v}" for k, v in dev.items()),
                      flush=True)
        smem, blocks, sms = new._plan(torch.cuda.current_device(),
                                      chip_smoke.MAIN_D,
                                      *chip_smoke.MAIN_HIDDEN,
                                      chip_smoke.MAIN_A)
        entry["row_plan"] = {"smem": smem, "blocks": blocks, "sms": sms}
        report["blocks"].append(entry)
        print(f"{key}: bound {bound_ms:.6f} ms ({bound_by}), autodiff "
              f"{entry['autodiff_ms']:.4f} ms, other tree vs plain "
              f"{old_err:.3e}; row kernel {smem} B of shared memory, "
              f"{blocks} blocks on {sms} SMs", flush=True)
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        with open(args.json, "w") as fh:
            json.dump(report, fh, indent=1)
    print(card)
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
