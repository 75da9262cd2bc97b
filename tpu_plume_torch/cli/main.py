"""Command line of the port:

    python -m tpu_plume_torch.cli train --preset ppo_v2_0 --out runs/torch_v20

Runs on the card; ``--cpu`` runs on the CPU.  The flags are the JAX CLI's
(``python -m tpu_plume.cli train``) for the paths the port runs; a flag of
a path it does not run yet is not accepted.
"""

from __future__ import annotations

import argparse
import dataclasses
import json

from tpu_plume_torch.core.config import PRESETS, get_preset


def apply_overrides(cfg, args):
    env = cfg.env
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


def cmd_train(args):
    from tpu_plume_torch.train import train_ppo

    cfg = apply_overrides(get_preset(args.preset), args)
    res = train_ppo(
        cfg,
        args.out,
        device="cpu" if args.cpu else None,
        write_csv=not args.no_csv,
        max_iterations=args.iterations,
        sync_every=args.sync_every,
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
