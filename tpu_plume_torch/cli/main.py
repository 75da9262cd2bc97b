"""Command line of the port:

    python -m tpu_plume_torch.cli train --preset ppo_v2_0 --out runs/torch_v20
    python -m tpu_plume_torch.cli train --preset wrf_les_3d --synth-bank 3d

Runs on the card; ``--cpu`` runs on the CPU.  The flags are the JAX CLI's
(``python -m tpu_plume.cli train``) for the paths the port runs; a flag of
a path it does not run yet is not accepted (``--bank file.nc`` among them:
banks are synthesized from ``--bank-seed``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json

from tpu_plume_torch.core.config import PRESETS, get_preset
from tpu_plume_torch.core.device import resolve_device


def apply_overrides(cfg, args):
    env = cfg.env
    if args.plume_model:
        env = dataclasses.replace(env, plume_model=args.plume_model)
    if args.obs_memory:
        env = dataclasses.replace(env, obs_memory=True)
    if args.reward:
        env = dataclasses.replace(env, reward_variant=args.reward)
    rollout = cfg.rollout
    if args.envs:
        rollout = dataclasses.replace(rollout, num_envs=args.envs)
    if args.unroll:
        rollout = dataclasses.replace(rollout, unroll_length=args.unroll)
    ppo = cfg.ppo
    if args.minibatch:
        ppo = dataclasses.replace(ppo, minibatch_size=args.minibatch)
    if args.lr:
        ppo = dataclasses.replace(ppo, learning_rate=args.lr)
    if args.entropy is not None:
        ppo = dataclasses.replace(ppo, entropy_beta=args.entropy)
    if args.shuffle_mode:
        ppo = dataclasses.replace(ppo, shuffle_mode=args.shuffle_mode)
    if args.bf16:
        ppo = dataclasses.replace(ppo, bf16_compute=True)
    if args.bf16_update:
        ppo = dataclasses.replace(ppo, bf16_update=True)
    if args.f32_heads:
        ppo = dataclasses.replace(ppo, f32_heads=True)
    cfg = cfg.replace(env=env, rollout=rollout, ppo=ppo)
    if args.episodes:
        cfg = cfg.replace(total_episodes=args.episodes)
    if args.seed is not None:
        cfg = cfg.replace(seed=args.seed)
    return cfg


def make_bank(args, cfg, device):
    """The ``FieldBank`` of a gridded config, synthesized on ``device`` from
    ``--bank-seed`` (the JAX CLI's ``_make_bank`` rules and defaults); None
    for an analytic plume model."""
    import torch

    from tpu_plume_torch.fields import gridded

    kind = args.synth_bank
    if kind is not None and cfg.env.plume_model != "gridded":
        # a bank flag on a non-gridded env would be silently ignored
        raise SystemExit(
            f"--synth-bank given but plume_model='{cfg.env.plume_model}' "
            f"would ignore it; add --plume-model gridded (or a gridded "
            f"preset)")
    if kind is None:
        if cfg.env.plume_model == "gridded":
            raise SystemExit('plume_model="gridded" needs --synth-bank')
        return None
    gen = torch.Generator(device=device).manual_seed(args.bank_seed)
    k = args.bank_fields or (4 if kind == "3d" else 64)
    if kind == "static":
        return gridded.synthesize_bank(gen, cfg.env, num_fields=k)
    if kind == "les":
        return gridded.synthesize_les_bank(
            gen, cfg.env, num_fields=args.bank_fields or 16,
            num_frames=args.bank_frames or 16,
            steps_per_frame=args.bank_spf or 64.0)
    if kind == "time":
        return gridded.synthesize_time_varying_bank(
            gen, cfg.env, num_fields=k, num_frames=args.bank_frames or 16,
            steps_per_frame=args.bank_spf or 64.0)
    return gridded.synthesize_3d_bank(
        gen, cfg.env, num_fields=k, num_frames=args.bank_frames or 8,
        num_levels=args.bank_levels or 8,
        steps_per_frame=args.bank_spf or 128.0)


def cmd_train(args):
    from tpu_plume_torch.train import train_ppo

    cfg = apply_overrides(get_preset(args.preset), args)
    device = resolve_device("cpu" if args.cpu else None)
    res = train_ppo(
        cfg,
        args.out,
        device=device,
        write_csv=not args.no_csv,
        max_iterations=args.iterations,
        sync_every=args.sync_every,
        bank=make_bank(args, cfg, device),
    )
    print(json.dumps({
        "episodes": res.episodes,
        "successes": res.successes,
        "success_rate": res.successes / max(res.episodes, 1),
        "env_steps": res.env_steps,
        "steps_per_sec": res.steps_per_sec,
        "out_dir": res.out_dir,
    }))


def build_parser():
    p = argparse.ArgumentParser(prog="tpu_plume_torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    sp = sub.add_parser("train", help="PPO training")
    sp.add_argument("--preset", default="ppo_v2_0", choices=sorted(PRESETS))
    sp.add_argument("--out", default="runs/train_torch")
    sp.add_argument("--envs", type=int)
    sp.add_argument("--unroll", type=int)
    sp.add_argument("--minibatch", type=int)
    sp.add_argument("--iterations", type=int)
    sp.add_argument("--episodes", type=int)
    sp.add_argument("--seed", type=int)
    sp.add_argument("--lr", type=float)
    sp.add_argument("--entropy", type=float)
    sp.add_argument("--reward", choices=["v1_0", "v1_1", "delta"],
                    help="reward form: v1_1 (reference code), v1_0, or delta "
                         "(the reference README's R = dCH4 - 0.2*|dtheta|)")
    sp.add_argument("--obs-memory", action="store_true",
                    help="append [dconc, prev-action one-hot] to the obs")
    sp.add_argument("--plume-model", choices=["isotropic", "gridded"],
                    help="plume field model (gridded needs --synth-bank)")
    sp.add_argument("--synth-bank", choices=["static", "time", "3d", "les"],
                    help="procedurally synthesize a gridded field bank")
    sp.add_argument("--bank-fields", type=int, help="bank rows K")
    sp.add_argument("--bank-frames", type=int, help="time frames T")
    sp.add_argument("--bank-levels", type=int, help="z levels Z (3d)")
    sp.add_argument("--bank-spf", type=float, help="env steps per frame")
    sp.add_argument("--bank-seed", type=int, default=0)
    sp.add_argument("--shuffle-mode", choices=["roll", "permutation", "affine"],
                    help="PPO minibatch shuffle: circular rotation (default), "
                         "full random permutation, or an affine bijection")
    sp.add_argument("--bf16", action="store_true",
                    help="bfloat16 compute in the whole policy (params f32)")
    sp.add_argument("--bf16-update", action="store_true",
                    help="bfloat16 compute in the PPO update only (f32 "
                         "rollout and params)")
    sp.add_argument("--f32-heads", action="store_true",
                    help="keep the actor/critic heads in f32 under --bf16 or "
                         "--bf16-update")
    sp.add_argument("--sync-every", type=int,
                    help="iterations per batched drain of episode records to "
                         "the CSV (default 8)")
    sp.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the card")
    sp.add_argument("--no-csv", action="store_true",
                    help="skip the per-episode CSV")
    sp.set_defaults(fn=cmd_train)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
