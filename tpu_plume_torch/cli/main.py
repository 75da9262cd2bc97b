"""Command line of the port:

    python -m tpu_plume_torch.cli train --preset ppo_v2_0 --out runs/torch_v20 --netcdf --conc-csv
    python -m tpu_plume_torch.cli train --preset wrf_les_3d --synth-bank 3d
    python -m tpu_plume_torch.cli train --preset wrf_les_3d --bank bank.nc
    python -m tpu_plume_torch.cli eval --pth runs/torch_v20/model/ppo_successful_models.pth --stop heuristic --out runs/eval
    python -m tpu_plume_torch.cli eval --pth runs/torch_v20/model/ppo_successful_models.pth --guide fit
    python -m tpu_plume_torch.cli eval --preset wrf_les --plume-model gridded --synth-bank static --bank-fields 16 --ckpt runs/torch_bank --guide bank
    python -m tpu_plume_torch.cli eval --pth ... --save-flights runs/flights.npz
    python -m tpu_plume_torch.cli train-lstm --variant params --flights runs/flights.npz --out runs/loc
    python -m tpu_plume_torch.cli eval --pth ... --guide learned --guide-ckpt runs/loc --localize runs/loc
    python -m tpu_plume_torch.cli eval --oracle raster --guide fit
    python -m tpu_plume_torch.cli expert --oracle phase --episodes 1000
    python -m tpu_plume_torch.cli train --train-guide fit --min-radius 50 --terminal-gate 40 --pth runs/torch_v20/model/ppo_successful_models.pth
    python -m tpu_plume_torch.cli expert --ckpt runs/torch_v20/checkpoint.pt --episodes 100
    python -m tpu_plume_torch.cli train --arch lstm --ln-lstm --out runs/torch_lstm
    python -m tpu_plume_torch.cli eval --arch lstm --ln-lstm --ckpt runs/torch_lstm --stop heuristic
    python -m tpu_plume_torch.cli train-lstm --variant threshold --nc runs/torch_v20/training_data.nc --out runs/lstm
    python -m tpu_plume_torch.cli eval --pth ... --stop threshold --lstm-ckpt runs/lstm/lstm_threshold_predictor.pt
    python -m tpu_plume_torch.cli inspect-nc runs/torch_v20/training_data.nc
    python -m tpu_plume_torch.cli train --distill phase --distill-gate 0.2
    python -m tpu_plume_torch.cli train-bc --expert expert_data.npz --out runs/bc
    python -m tpu_plume_torch.cli train-dagger --rounds 8 --envs 512 --out runs/dagger
    python -m tpu_plume_torch.cli train-gail --expert expert_data.npz --closed-loop --gail-anneal 20000 --out runs/gail
    python -m tpu_plume_torch.cli flux --estimated --survey raster --steps 500
    python -m tpu_plume_torch.cli flux --estimated --survey raster --steps 500 --refine-steps 100
    python -m tpu_plume_torch.cli flux --estimated --pth runs/torch_v20/model/ppo_successful_models.pth
    python -m tpu_plume_torch.cli plot --what curves --csv runs/torch_v20/training_results.csv --out curves.png

Runs on the card; ``--cpu`` runs on the CPU.  The flags are the JAX CLI's
(``python -m tpu_plume.cli``), with its types, defaults and override
rules, for the paths the port runs: the env's reward shaping
(``--depth-coef``, ``--depth-power``, ``--terminal-gate``,
``--inplume-bonus``), the curriculum floor (``--min-radius``) and the trunk
widths (``--hidden``) among them, so JAX's recipe ``--min-radius 50
--terminal-gate 40`` runs here too.  ``--pth`` loads a policy in the
reference ``.pth`` layout (the JAX package's ``export_actor_critic_pth``
writes one from a JAX run) and ``--ckpt`` the port's own ``checkpoint.pt``;
``train`` takes either as its initial params.  ``--arch lstm`` (with
``--ln-lstm``, the LayerNorm cell) selects the recurrent policy, whose
weights load from ``--ckpt`` only: the ``.pth`` layout is the 2-layer MLP.
``--lstm-ckpt`` loads a stop LSTM's state_dict (the port's ``<name>.pt``
or a reference ``.pth``).  ``eval --guide fit`` runs the model-fit
terminal guide (trilateration on the isotropic plume, a Gauss-Newton fit of
the anisotropic one) and ``train --train-guide fit`` the same guide inside
the training rollout; ``eval --guide bank`` identifies the episode's row
of a gridded bank and ``eval --guide learned`` steers by a trained source
localizer (``train-lstm --variant params``, loaded by ``--guide-ckpt``
from its run directory or its ``gaussian_params.pt``), which ``eval
--localize`` also runs post hoc on every flight.  ``eval --oracle`` and
``expert --oracle`` fly a scripted policy and load none.  ``train
--distill`` adds a scripted teacher's imitation term to PPO; ``train-bc``
and ``train-dagger`` write a ``checkpoint.pt`` that ``--ckpt`` loads, and
``train-gail`` one with the discriminator beside the policy and the
reference's ``model/ppo_gail.pth`` and ``model/discriminator.pth``.
``flux`` runs the flux-inversion study (random, raster, policy or two-pass
surveys, at the true or estimated source positions) and prints its
summary; ``plot`` draws an episode's field and flight from a
``training_data.nc`` or the training curves of a ``training_results.csv``
(matplotlib, and pandas for the curves).  The NetCDF files (``--netcdf``,
``--bank file.nc``, ``train-lstm --nc``, ``inspect-nc``, ``plot --what
field``) need h5py.  ``train --snapshot-every N`` writes a full resume
bundle every N or more iterations and ``--resume DIR`` continues from one
bit for bit; ``--tensorboard`` logs to ``out/tb``, ``--profile-steps N``
writes a ``torch.profiler`` trace to ``out/profile``, and ``--debug-nans``
(every command but ``train-lstm``, ``inspect-nc`` and ``plot``) names the
first phase whose outputs are not finite.  Before any command the CLI turns
off TF32 and bf16 reduced-precision reductions on the card, the precision
the checks hold the port to.
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
    if args.depth_coef is not None:
        env = dataclasses.replace(env, terminal_depth_coef=args.depth_coef)
    if args.depth_power is not None:
        env = dataclasses.replace(env, terminal_depth_power=args.depth_power)
    if args.terminal_gate is not None:
        env = dataclasses.replace(env, terminal_gate_radius=args.terminal_gate)
    if args.obs_memory:
        env = dataclasses.replace(env, obs_memory=True)
    if args.reward:
        env = dataclasses.replace(env, reward_variant=args.reward)
    if args.inplume_bonus:
        env = dataclasses.replace(env, inplume_bonus=args.inplume_bonus)
    curriculum = cfg.curriculum
    if args.min_radius is not None:
        curriculum = dataclasses.replace(curriculum,
                                         min_radius=args.min_radius)
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
    if args.hidden:
        ppo = dataclasses.replace(
            ppo, hidden_sizes=tuple(int(h) for h in args.hidden.split(",")))
    if args.arch:
        ppo = dataclasses.replace(ppo, arch=args.arch)
    if args.ln_lstm:
        ppo = dataclasses.replace(ppo, lstm_layer_norm=True)
    if args.distill:
        ppo = dataclasses.replace(ppo, distill_oracle=args.distill)
    if args.distill_coef is not None:
        ppo = dataclasses.replace(ppo, distill_coef=args.distill_coef)
    if args.distill_gate is not None:
        ppo = dataclasses.replace(ppo, distill_conc_gate=args.distill_gate)
    cfg = cfg.replace(env=env, curriculum=curriculum, rollout=rollout,
                      ppo=ppo)
    if args.episodes:
        cfg = cfg.replace(total_episodes=args.episodes)
    if args.seed is not None:
        cfg = cfg.replace(seed=args.seed)
    return cfg


def make_bank(args, cfg, device):
    """The ``FieldBank`` of a gridded config on ``device``: ``--bank
    file.nc`` ingested, else synthesized from ``--bank-seed`` (the JAX CLI's
    ``_make_bank`` rules and defaults); None for an analytic plume model."""
    import torch

    from tpu_plume_torch.fields import gridded

    kind = args.synth_bank
    if (args.bank or kind is not None) and cfg.env.plume_model != "gridded":
        # a bank flag on a non-gridded env would be silently ignored
        raise SystemExit(
            f"--synth-bank/--bank given but plume_model="
            f"'{cfg.env.plume_model}' would ignore it; add --plume-model "
            f"gridded (or a gridded preset)")
    if args.bank:
        return gridded.ingest_netcdf(args.bank, device=device)
    if kind is None:
        if cfg.env.plume_model == "gridded":
            raise SystemExit(
                'plume_model="gridded" needs --bank <file.nc> or --synth-bank')
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


def load_policy(args, cfg, device):
    """The policy network of ``cfg`` (its ``--arch``, ``--ln-lstm`` and
    ``--hidden``) on ``device``, with the weights of ``--pth`` (a state_dict
    in the reference ``.pth`` layout, e.g. ``model/ppo_successful_models.pth``
    of a run of either package; the MLP only) or ``--ckpt`` (the port's
    ``checkpoint.pt``, or a run directory holding one, whose recorded
    architecture must be ``cfg``'s)."""
    import os

    import torch

    from tpu_plume_torch.train.ppo_trainer import make_policy_model

    if args.pth and cfg.ppo.arch != "mlp":
        raise SystemExit(
            f"--pth with --arch {cfg.ppo.arch}: the reference .pth layout "
            f"is the 2-layer MLP policy; load a recurrent policy from the "
            f"port's checkpoint.pt with --ckpt")
    if args.pth:
        state_dict = torch.load(args.pth, map_location="cpu",
                                weights_only=True)
    elif args.ckpt:
        path = args.ckpt
        if os.path.isdir(path):
            path = os.path.join(path, "checkpoint.pt")
        if not os.path.isfile(path):
            raise SystemExit(
                f"--ckpt {args.ckpt}: no checkpoint.pt there.  The port "
                f"reads its own torch.save checkpoint, not an Orbax "
                f"directory of the JAX package; export a JAX run's params "
                f"with tpu_plume.data.torch_export.export_actor_critic_pth "
                f"and pass that file as --pth")
        ckpt = torch.load(path, map_location="cpu", weights_only=True)
        saved = ckpt.get("config", {}).get("ppo", {})
        fields = ("arch", "lstm_layer_norm") if cfg.ppo.arch == "lstm" else (
            "arch",)
        want = {f: getattr(cfg.ppo, f) for f in fields}
        got = {f: saved.get(f, want[f]) for f in fields}
        if got != want:
            raise SystemExit(
                f"--ckpt {args.ckpt} holds a policy of {got}, not {want}: "
                f"give the --arch and --ln-lstm it was trained with")
        state_dict = ckpt["model"]
    else:
        raise SystemExit("need --ckpt or --pth")
    model = make_policy_model(cfg)
    model.load_state_dict(state_dict)
    return model.to(device)


def lstm_gate(args, cfg, device):
    """The stop gate of ``--stop threshold`` or ``--stop peakstop`` (JAX's
    ``_lstm_gate``): its LSTM from ``--lstm-ckpt``, a state_dict file in the
    reference layout (the port's ``lstm_threshold_predictor.pt`` /
    ``best_peak_and_stop.pt``, or a ``.pth`` of either package), run on
    ``device`` in eval mode over the batch of episodes at every eval step.
    The threshold gate scales the raw window by ``scaler_params.npy`` beside
    the checkpoint; the peak-stop gate reads ``window / conc_norm``."""
    import os

    import numpy as np
    import torch

    from tpu_plume_torch.data.scaler import MinMaxScaler
    from tpu_plume_torch.evaluation import (
        make_peak_stop_gate,
        make_threshold_gate,
    )
    from tpu_plume_torch.models.lstm_zoo import (
        ConcentrationThresholdPredictor,
        PeakAndStopPredictor,
    )

    path = args.lstm_ckpt
    if not path:
        raise SystemExit("--stop threshold/peakstop requires --lstm-ckpt")
    if os.path.isdir(path):
        raise SystemExit(
            f"--lstm-ckpt {path} is a directory.  The port reads a "
            f"state_dict file (its own lstm_threshold_predictor.pt or "
            f"best_peak_and_stop.pt, or a .pth), not an Orbax directory of "
            f"the JAX package; export a JAX run's params with "
            f"tpu_plume.data.torch_export.export_threshold_lstm_pth or "
            f"export_peak_stop_pth and pass that file")
    state_dict = torch.load(path, map_location="cpu", weights_only=True)
    if args.stop == "threshold":
        scaler_path = os.path.join(os.path.dirname(path), "scaler_params.npy")
        if not os.path.isfile(scaler_path):
            raise SystemExit(f"--stop threshold scales its window by the "
                             f"scaler beside --lstm-ckpt: {scaler_path} "
                             f"not found")
        scaler = MinMaxScaler.load(scaler_path)
        model = ConcentrationThresholdPredictor()
        lo, scale = (torch.tensor(np.float32(v), device=device)
                     for v in (scaler.data_min_, scaler._scale))
    else:
        model = PeakAndStopPredictor()
    model.load_state_dict(state_dict)
    model.to(device).eval()
    if args.stop == "threshold":
        @torch.no_grad()
        def predict(window):
            return model((window - lo) * scale)

        return make_threshold_gate(predict, cfg.stop)

    @torch.no_grad()
    def predict(window_norm):
        return model(window_norm)

    return make_peak_stop_gate(predict, cfg.stop)


def load_localizer(path, device):
    """The source localizer of ``train-lstm --variant params`` from
    ``path``, its run directory or the ``gaussian_params.pt`` in it: a
    ``GaussianParamPredictor`` in eval mode on ``device``, its input width
    and hidden size read from the state_dict, and the
    ``localizer_meta.npz`` beside it (None when there is none)."""
    import os

    import torch

    from tpu_plume_torch.evaluation.learned_guide import load_localizer_meta
    from tpu_plume_torch.models.lstm_zoo import GaussianParamPredictor

    file = (os.path.join(path, "gaussian_params.pt") if os.path.isdir(path)
            else path)
    if not os.path.isfile(file):
        raise SystemExit(
            f"{path}: no gaussian_params.pt there.  The port reads the "
            f"state_dict that its train-lstm --variant params writes, not "
            f"an Orbax directory of the JAX package")
    state_dict = torch.load(file, map_location="cpu", weights_only=True)
    w_ih = state_dict["lstm.weight_ih_l0"]
    model = GaussianParamPredictor(hidden_size=w_ih.shape[0] // 4,
                                   input_size=w_ih.shape[1])
    model.load_state_dict(state_dict)
    return model.to(device).eval(), load_localizer_meta(path)


def learned_guide(args, cfg, device):
    """``--guide learned``: the localizer of ``--guide-ckpt`` in the eval
    loop, its gate derived from the validation error in
    ``localizer_meta.npz`` unless a knob is given (JAX's ``cmd_eval``)."""
    from tpu_plume_torch.evaluation.learned_guide import (
        derive_learned_guide_config,
        make_learned_guide,
    )

    if not args.guide_ckpt:
        raise SystemExit("--guide learned requires --guide-ckpt "
                         "(train-lstm --variant params checkpoint)")
    model, meta = load_localizer(args.guide_ckpt, device)
    window = int(meta["window"]) if meta else 64
    if meta:
        derived = derive_learned_guide_config(meta["val_median_err_px"],
                                              window=window)
        print(f"learned-guide gate derived from localizer val error "
              f"{meta['val_median_err_px']:.1f} px: "
              f"stable_tol={derived['stable_tol']:.1f} "
              f"check_every={derived['check_every']} "
              f"min_window={derived['min_window']}")
    else:
        derived = {"stable_tol": 6.0, "check_every": 8, "min_window": 16}
    width = model.lstm.input_size
    features = (str(meta.get("features", "xyc")) if meta
                else "xycd" if width == 6 else "xyc")
    if width != (6 if features == "xycd" else 3):
        raise SystemExit(f"--guide-ckpt {args.guide_ckpt}: a localizer of "
                         f"input width {width} for features {features!r}")

    def knob(name):
        value = getattr(args, f"guide_{name}")
        return derived[name] if value is None else value

    return make_learned_guide(
        cfg.env, model, features=features, window=window,
        terminate_radius=(50.0 if args.goal_radius is None
                          else args.goal_radius),
        success_radius=cfg.eval.success_distance,
        stable_tol=knob("stable_tol"), min_window=knob("min_window"),
        check_every=knob("check_every"))


def bank_guide(args, cfg, bank):
    """``--guide bank`` with JAX's defaults: commit on 2 reads checked
    every step, margin 1.5 until step 400, search after 50 steps (a
    negative ``--guide-search-after`` disables it), rim guard on."""
    from tpu_plume_torch.evaluation.bank_guide import make_bank_guide

    if bank is None:
        raise SystemExit("--guide bank requires a gridded bank "
                         "(--bank / --synthesize-bank)")

    def knob(value, default):
        return default if value is None else value

    search = knob(args.guide_search_after, 50)
    return make_bank_guide(
        cfg.env, int(bank.conc.shape[0]),
        terminate_radius=(50.0 if args.goal_radius is None
                          else args.goal_radius),
        success_radius=cfg.eval.success_distance,
        min_contact=knob(args.guide_min_window, 2),
        check_every=knob(args.guide_check_every, 1),
        margin=knob(args.guide_margin, 1.5),
        margin_until=knob(args.guide_margin_until, 400),
        search_after=None if search < 0 else search,
        rim_guard=args.guide_rim_guard,
        rim_expire=args.guide_rim_expire,
        guard_top=args.guide_guard_top,
        entry_dive=args.guide_entry_dive,
        dive_bias=args.guide_dive_bias,
        sticky_target=args.guide_sticky_target)


def _eval_setup(args):
    """(cfg, device, model, bank, oracle) of an ``eval`` or ``expert``
    command: with ``--oracle`` the scripted policy and no model."""
    cfg = apply_overrides(get_preset(args.preset), args)
    device = resolve_device("cpu" if args.cpu else None)
    if args.oracle:
        from tpu_plume_torch.evaluation.oracle import make_oracle

        model, oracle = None, make_oracle(args.oracle, cfg.env)
    else:
        model, oracle = load_policy(args, cfg, device), None
    return cfg, device, model, make_bank(args, cfg, device), oracle


def cmd_eval(args):
    import os

    import numpy as np
    import torch

    from tpu_plume_torch.evaluation import (
        evaluate_policy,
        make_heuristic_gate,
        summarize,
    )

    cfg, device, model, bank, oracle = _eval_setup(args)
    rnn = model if cfg.ppo.arch == "lstm" else None
    stop_gate = None
    if args.stop == "heuristic":
        stop_gate = make_heuristic_gate(cfg.eval, cfg.env.conc_peak)
    elif args.stop in ("threshold", "peakstop"):
        stop_gate = lstm_gate(args, cfg, device)
    guide = None
    if args.guide == "fit":
        from tpu_plume_torch.evaluation.guidance import make_guide

        # thresholds and dive geometry derived from the env physics and the
        # protocol; physics that cannot be guided raise
        guide = make_guide(
            cfg.env,
            terminate_radius=args.goal_radius,
            success_radius=cfg.eval.success_distance,
            max_se=args.guide_max_se,
            search_after=args.guide_search_after,
        )
    elif args.guide == "learned":
        guide = learned_guide(args, cfg, device)
    elif args.guide == "bank":
        guide = bank_guide(args, cfg, bank)
    n_eval = args.episodes or cfg.eval.episodes
    m = evaluate_policy(
        model, cfg.env, cfg.eval,
        torch.Generator(device=device).manual_seed(args.seed or 0),
        num_episodes=args.episodes, stop_gate=stop_gate,
        greedy=not args.sample, goal_radius=args.goal_radius, bank=bank,
        track_trajectories=(n_eval if args.localize or args.save_flights
                            else 0),
        device=device, rnn=rnn, guide=guide, oracle=oracle,
    )
    if args.save_flights:
        os.makedirs(os.path.dirname(args.save_flights) or ".", exist_ok=True)
        np.savez_compressed(args.save_flights, trajectories=m.trajectories,
                            sources=m.sources)
    summary = summarize(m)
    if args.guide == "bank":
        summary.update(bank_summary(m))
    if args.goal_radius is not None:
        # precision protocol: the bullseye rate (deviation within the
        # terminator itself) is the headline, not success@success_distance
        summary["bullseye_rate"] = float(
            (np.asarray(m.deviations) <= args.goal_radius).mean())
    if args.localize:
        from tpu_plume_torch.evaluation.localize import (
            localize_from_trajectories,
        )

        pred = localize_from_trajectories(
            m.trajectories, load_localizer(args.localize, device)[0],
            window=args.localize_window, grid_size=cfg.env.grid_size,
            conc_peak=cfg.env.conc_peak)
        summary.update(location_errors("localize", pred, m.sources))
        if m.guide_est is not None:
            # the guide's estimate where it validated, the localizer's
            # elsewhere
            summary.update(location_errors("hybrid", np.where(
                m.guide_fit_ok[:, None], m.guide_est, pred), m.sources))
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        m.save_npz(os.path.join(args.out, "validation_metrics.npz"))
        m.save_csv(os.path.join(args.out, "evaluation_results.csv"))
    print(json.dumps(summary))


def bank_summary(m) -> dict:
    """The bank guide's share of episodes ending with its identity gate
    open, and the share of those whose matched row is the episode's."""
    gated = m.guide_fit_ok
    return {"bank_gate_rate": float(gated.mean()),
            "bank_match_accuracy": (
                float((m.guide_match == m.field_idx)[gated].mean())
                if gated.any() else 0.0)}


def location_errors(name, pred, sources) -> dict:
    """The mean, median and within-5 / within-40 shares of the distances
    of ``pred`` [N, 2] from ``sources``, as ``{name}_*``."""
    import numpy as np

    err = np.linalg.norm(pred - sources, axis=-1)
    return {f"{name}_mean_err": float(err.mean()),
            f"{name}_median_err": float(np.median(err)),
            f"{name}_within_5": float((err <= 5.0).mean()),
            f"{name}_within_40": float((err <= 40.0).mean())}


def cmd_expert(args):
    import torch

    from tpu_plume_torch.evaluation import generate_expert_data

    cfg, device, model, bank, oracle = _eval_setup(args)
    states, _ = generate_expert_data(
        model, cfg.env,
        torch.Generator(device=device).manual_seed(args.seed or 0),
        num_episodes=args.episodes or 100, path=args.out, bank=bank,
        device=device, rnn=model if cfg.ppo.arch == "lstm" else None,
        oracle=oracle)
    print(json.dumps({"samples": int(states.shape[0]), "path": args.out}))


def cmd_train(args):
    from tpu_plume_torch.train import train_ppo

    cfg = apply_overrides(get_preset(args.preset), args)
    device = resolve_device("cpu" if args.cpu else None)
    if args.resume and (args.ckpt or args.pth):
        raise SystemExit("--resume restores its own params; drop --ckpt/--pth")
    init_params = None
    if args.ckpt or args.pth:
        init_params = load_policy(args, cfg, "cpu").state_dict()
    guide = None
    if args.train_guide == "fit":
        from tpu_plume_torch.evaluation.guidance import make_guide

        # the eval-time guide in the training rollout at the protocol's
        # radius-50 terminator (pair with --min-radius 50 --terminal-gate 40)
        guide = make_guide(cfg.env, terminate_radius=50.0,
                           success_radius=cfg.eval.success_distance)
    res = train_ppo(
        cfg,
        args.out,
        device=device,
        write_csv=not args.no_csv,
        max_iterations=args.iterations,
        sync_every=args.sync_every,
        bank=make_bank(args, cfg, device),
        init_params=init_params,
        capture_netcdf=args.netcdf,
        capture_conc_csv=args.conc_csv,
        guide=guide,
        use_tensorboard=args.tensorboard,
        profile_steps=args.profile_steps,
        snapshot_every=args.snapshot_every,
        resume_from=args.resume,
    )
    print(json.dumps({
        "episodes": res.episodes,
        "successes": res.successes,
        "success_rate": res.successes / max(res.episodes, 1),
        "env_steps": res.env_steps,
        "steps_per_sec": res.steps_per_sec,
        "out_dir": res.out_dir,
    }))


def cmd_train_bc(args):
    from tpu_plume_torch.train.bc import train_bc

    cfg = apply_overrides(get_preset(args.preset), args)
    res = train_bc(cfg, args.out, args.expert, epochs=args.bc_epochs,
                   batch_size=args.bc_batch, lr=args.bc_lr,
                   device=resolve_device("cpu" if args.cpu else None))
    print(json.dumps({
        "samples": res.samples, "train_loss": round(res.train_loss, 4),
        "val_loss": round(res.val_loss, 4),
        "val_accuracy": round(res.val_accuracy, 4), "out": args.out,
    }))


def cmd_train_dagger(args):
    from tpu_plume_torch.train.dagger import train_dagger

    cfg = apply_overrides(get_preset(args.preset), args)
    res = train_dagger(
        cfg, args.out, oracle_kind=args.oracle, rounds=args.rounds,
        episodes_per_round=args.envs or 512,
        epochs_per_round=args.bc_epochs, batch_size=args.bc_batch,
        lr=args.bc_lr, device=resolve_device("cpu" if args.cpu else None))
    print(json.dumps({
        "rounds": res.rounds, "samples": res.samples,
        "val_accuracy": round(res.val_accuracy, 4),
        "rollout_success": [round(s, 4) for s in res.eval_success],
        "out": args.out,
    }))


def cmd_train_gail(args):
    from tpu_plume_torch.train.gail_trainer import train_ppo_gail

    cfg = apply_overrides(get_preset(args.preset), args)
    res = train_ppo_gail(
        cfg, args.out, args.expert, closed_loop=args.closed_loop,
        gail_reward_coef=args.gail_coef,
        gail_anneal_episodes=args.gail_anneal,
        gail_anneal_radius=args.gail_anneal_radius,
        max_iterations=args.iterations,
        device=resolve_device("cpu" if args.cpu else None))
    print(json.dumps({"episodes": res.episodes, "successes": res.successes,
                      "out_dir": res.out_dir}))


def cmd_train_lstm(args):
    if args.variant == "params":
        if not (args.nc or args.flights):
            raise SystemExit("--variant params needs --nc or --flights")
    elif not args.nc:
        raise SystemExit(f"--variant {args.variant} needs --nc")
    from tpu_plume_torch.data.datasets import (
        load_raw_sequences,
        load_trajectory_segments,
    )
    from tpu_plume_torch.train import lstm_trainer as lt

    device = resolve_device("cpu" if args.cpu else None)
    if args.variant == "threshold":
        seqs, src = load_raw_sequences(args.nc)
        res = lt.train_threshold_lstm(seqs, src, args.out, epochs=args.epochs,
                                      verbose=True, device=device)
        print(json.dumps({"final_loss": res.losses[-1], "r2": res.extra["r2"]}))
    elif args.variant == "v12":
        if args.nc.endswith(".csv"):
            from tpu_plume_torch.data.conc_csv import load_conc_rows

            seqs, src = load_conc_rows(args.nc)
        else:
            seqs, src = load_raw_sequences(args.nc)
        res = lt.train_sequence_lstm(seqs, src, args.out, epochs=args.epochs,
                                     verbose=True, device=device)
        print(json.dumps({"final_loss": res.losses[-1],
                          "test_r2": res.extra["test_r2"]}))
    elif args.variant == "params":
        res = lt.train_source_lstm(
            args.nc, args.out, flights_path=args.flights, window=args.window,
            epochs=args.epochs, verbose=True, features=args.features,
            hidden=args.hidden_size, device=device)
        print(json.dumps({
            "best_loss": res.extra["best_loss"],
            "val_mean_err_px": res.extra["val_mean_err_px"],
            "val_median_err_px": res.extra["val_median_err_px"],
        }))
    else:
        segs = load_trajectory_segments(args.nc, window_size=20)
        res = lt.train_peak_stop_lstm(segs, args.out, epochs=args.epochs,
                                      verbose=True, device=device)
        print(json.dumps({"best_loss": res.extra["best_loss"]}))


def raster_band_scale(env, steps: int, refine_steps: int) -> float:
    """The raster surveyor's band pitch in plume sigmas for ``flux``: 1.12,
    widened under a two-pass survey so that the shortened first pass still
    covers the domain (descend g/m steps, then sweeps of g/m + 1 steps)."""
    if not refine_steps:
        return 1.12
    g, m = env.grid_size, env.move_step
    sweep = max(steps - refine_steps - g / m, 1.0)
    n_bands = max(sweep / (g / m + 1.0), 1.0)
    return max(1.12, g / n_bands / env.plume_sigma)


def cmd_flux(args):
    import torch

    from tpu_plume_torch.evaluation import flux

    cfg = get_preset(args.preset)
    env = dataclasses.replace(
        cfg.env, num_sources=args.sources,
        plume_model=args.plume_model or cfg.env.plume_model)
    try:
        flux.check_flux_env(env)
    except ValueError as err:
        raise SystemExit(f"flux: {err}") from None
    device = resolve_device("cpu" if args.cpu else None)
    policy = oracle = None
    if args.survey == "raster":
        from tpu_plume_torch.evaluation.oracle import make_oracle

        scale = raster_band_scale(env, args.steps, args.refine_steps)
        oracle = make_oracle("raster", env, raster_band_scale=scale)
    elif args.ckpt or args.pth:
        # the policy as JAX's _load_params builds it: the preset's network
        # with --hidden and --arch
        ppo = cfg.ppo
        if args.hidden:
            ppo = dataclasses.replace(ppo, hidden_sizes=tuple(
                int(h) for h in args.hidden.split(",")))
        if args.arch:
            ppo = dataclasses.replace(ppo, arch=args.arch)
        if ppo.arch != "mlp":
            raise SystemExit(
                f"flux --arch {ppo.arch}: the survey policy is the MLP, "
                f"sampled from its logits at each step; a recurrent policy's "
                f"carry has no place in the flux survey")
        policy = load_policy(args, cfg.replace(ppo=ppo), device)
    out = flux.flux_inversion_study(
        env, torch.Generator(device=device).manual_seed(args.seed or 0),
        num_episodes=args.episodes or 64, num_steps=args.steps,
        policy=policy, estimated_positions=args.estimated, oracle=oracle,
        refine_steps=args.refine_steps, device=device)
    print(json.dumps(out))


def cmd_plot(args):
    if args.what == "field":
        from tpu_plume_torch.viz import plot_gaussian_field

        path = plot_gaussian_field(args.nc, args.episode, save_path=args.out)
    else:
        from tpu_plume_torch.viz import plot_training_curves

        path = plot_training_curves(args.csv, save_path=args.out)
    print(json.dumps({"saved": path}))


def cmd_inspect_nc(args):
    from tpu_plume_torch.data.netcdf import describe_nc

    print(describe_nc(args.path))


def _common(sp, out_default):
    """The flags of every command: the preset and its overrides, the bank,
    the run's size and seed, the device and the policy to load."""
    sp.add_argument("--preset", default="ppo_v2_0", choices=sorted(PRESETS))
    sp.add_argument("--out", default=out_default)
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
    sp.add_argument("--plume-model",
                    choices=["isotropic", "anisotropic", "gridded"],
                    help="plume field model (gridded needs --bank or "
                         "--synth-bank)")
    sp.add_argument("--bank", help="WRF-LES NetCDF field bank to ingest "
                    "(plume_model=gridded; needs h5py)")
    sp.add_argument("--synth-bank", choices=["static", "time", "3d", "les"],
                    help="procedurally synthesize a gridded field bank")
    sp.add_argument("--bank-fields", type=int, help="bank rows K")
    sp.add_argument("--bank-frames", type=int, help="time frames T")
    sp.add_argument("--bank-levels", type=int, help="z levels Z (3d)")
    sp.add_argument("--bank-spf", type=float, help="env steps per frame")
    sp.add_argument("--bank-seed", type=int, default=0)
    sp.add_argument("--depth-coef", type=float,
                    help="terminal goal-ball crossing-depth bonus coef "
                         "(EnvConfig.terminal_depth_coef; default 0 = "
                         "reference parity)")
    sp.add_argument("--depth-power", type=float,
                    help="exponent on the normalized crossing depth "
                         "(EnvConfig.terminal_depth_power; >1 pays grazes "
                         "~nothing, keeping a smooth gradient)")
    sp.add_argument("--terminal-gate", type=float,
                    help="success-gated terminal bonus: pay the whole "
                         "terminal bonus only when the crossing lands within "
                         "this distance of the source "
                         "(EnvConfig.terminal_gate_radius; 40 = the "
                         "reference eval metric; default 0 = off)")
    sp.add_argument("--inplume-bonus", type=float,
                    help="per-step bonus while conc/peak >= 0.06 "
                         "(EnvConfig.inplume_bonus); default 0 = reference "
                         "parity")
    sp.add_argument("--min-radius", type=float,
                    help="curriculum radius floor (set 50 to train at the "
                         "fixed reference-protocol radius)")
    sp.add_argument("--hidden",
                    help='trunk widths, e.g. "512,256" (default 256,128 — '
                         "the reference architecture)")
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
    sp.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the card")
    sp.add_argument("--debug-nans", action="store_true",
                    help="locate the first non-finite values: autograd's "
                         "anomaly mode, and a finite check of each phase's "
                         "outputs (the rollout, GAE, the update, the GAIL "
                         "discriminator; an eval step's logits and "
                         "observations) that names the first phase that "
                         "is not finite (host reads each phase; off, "
                         "nothing is added)")
    sp.add_argument("--ckpt",
                    help="the port's checkpoint.pt (or a run directory "
                         "holding one) to load the policy from")
    sp.add_argument("--pth",
                    help="a policy state_dict in the reference .pth layout "
                         "(model/ppo_successful_models.pth of a run of "
                         "either package)")
    sp.add_argument("--arch", choices=["mlp", "lstm"],
                    help="policy architecture: mlp (reference parity) or "
                         "lstm (the recurrent PPO+LSTM policy)")
    sp.add_argument("--ln-lstm", action="store_true",
                    help="LayerNorm-LSTM cell for --arch lstm")
    sp.add_argument("--train-guide", choices=["fit"], default=None,
                    help="train: run the eval-time terminal guide inside "
                         "the training rollout: overridden steps drop out "
                         "of the policy surrogate, rewards and values see "
                         "the guided dynamics.  Pair with --min-radius 50 "
                         "--terminal-gate 40 (declared on every command, "
                         "as in JAX; eval and expert ignore it)")
    sp.add_argument("--distill", choices=["naive", "look1", "phase"],
                    help="distilled PPO: a scripted privileged teacher "
                         "labels every rollout state and the update adds "
                         "an imitation cross-entropy (declared on every "
                         "command, as in JAX; train reads it)")
    sp.add_argument("--distill-coef", type=float,
                    help="imitation-term weight (default 0.1)")
    sp.add_argument("--distill-gate", type=float,
                    help="imitate only where conc_norm exceeds this "
                         "(default 0 = everywhere)")


def build_parser():
    p = argparse.ArgumentParser(prog="tpu_plume_torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    sp = sub.add_parser("train", help="PPO training")
    _common(sp, "runs/train_torch")
    sp.add_argument("--sync-every", type=int,
                    help="iterations per batched drain of episode records to "
                         "the CSV (default 8)")
    sp.add_argument("--no-csv", action="store_true",
                    help="skip the per-episode CSV")
    sp.add_argument("--netcdf", action="store_true",
                    help="capture training_data.nc (needs h5py)")
    sp.add_argument("--conc-csv", action="store_true",
                    help="capture ragged conc sequences (V1.2 data.csv)")
    sp.add_argument("--tensorboard", action="store_true",
                    help="log the scalars and the params' and full-batch "
                         "gradients' histograms to out/tb (where "
                         "torch.utils.tensorboard imports)")
    sp.add_argument("--profile-steps", type=int, default=0,
                    help="capture a torch.profiler trace over N train steps "
                         "(from the third) in out/profile")
    sp.add_argument("--snapshot-every", type=int,
                    help="save a full resume bundle every >= N iterations "
                         "(at drain-window boundaries) to "
                         "out/checkpoint_iterNNNNNN")
    sp.add_argument("--resume", metavar="DIR",
                    help="resume an interrupted run from a full bundle "
                         "(checkpoint_iterNNNNNN or a run directory): "
                         "params, optimizer, env states, curriculum, "
                         "generator and counters; bit-exact continuation, "
                         "CSV logs append")
    sp.set_defaults(fn=cmd_train)

    sp = sub.add_parser(
        "train-bc", help="behavior-cloning pretrain on expert pairs (warm "
                         "start for train --ckpt)")
    _common(sp, "runs/bc")
    sp.add_argument("--expert", required=True)
    sp.add_argument("--bc-epochs", type=int, default=30)
    sp.add_argument("--bc-batch", type=int, default=4096)
    sp.add_argument("--bc-lr", type=float, default=1e-3)
    sp.set_defaults(fn=cmd_train_bc)

    sp = sub.add_parser(
        "train-dagger", help="DAgger against a scripted oracle teacher "
                             "(--envs = episodes per round)")
    _common(sp, "runs/dagger")
    sp.add_argument("--oracle", choices=["naive", "look1", "phase"],
                    default="phase")
    sp.add_argument("--rounds", type=int, default=8)
    sp.add_argument("--bc-epochs", type=int, default=20)
    sp.add_argument("--bc-batch", type=int, default=4096)
    sp.add_argument("--bc-lr", type=float, default=1e-3)
    sp.set_defaults(fn=cmd_train_dagger)

    sp = sub.add_parser("train-gail", help="PPO + GAIL discriminator")
    _common(sp, "runs/gail")
    sp.add_argument("--expert", required=True)
    sp.add_argument("--closed-loop", action="store_true")
    sp.add_argument("--gail-coef", type=float, default=0.1,
                    help="imitation-reward weight (closed loop only)")
    sp.add_argument("--gail-anneal", type=int,
                    help="linearly decay the imitation weight to 0 over N "
                         "episodes")
    sp.add_argument("--gail-anneal-radius", type=float,
                    help="start the --gail-anneal decay only once the "
                         "curriculum radius first reaches this value")
    sp.set_defaults(fn=cmd_train_gail)

    sp = sub.add_parser("train-lstm", help="LSTM stop-predictor training")
    sp.add_argument("--variant",
                    choices=["threshold", "peakstop", "v12", "params"],
                    default="threshold")
    sp.add_argument("--window", type=int, default=64,
                    help="window length for --variant params (the source "
                         "localizer)")
    sp.add_argument("--nc",
                    help="NC trajectory capture (required unless --flights; "
                         "a data.csv for --variant v12)")
    sp.add_argument("--flights",
                    help="flights.npz from `eval --save-flights` "
                         "(--variant params only)")
    sp.add_argument("--out", default="runs/lstm")
    sp.add_argument("--epochs", type=int, default=150)
    sp.add_argument("--features", choices=["xyc", "xycd"], default="xyc",
                    help="--variant params window features: normalized "
                         "(x, y, conc), or with the per-step deltas")
    sp.add_argument("--hidden-size", type=int, default=32,
                    help="--variant params LSTM cell/head width (kept in "
                         "localizer_meta.npz)")
    sp.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the card")
    sp.set_defaults(fn=cmd_train_lstm)

    sp = sub.add_parser("eval", help="greedy evaluation harness",
                        allow_abbrev=False)
    _common(sp, None)
    sp.add_argument("--oracle", choices=["naive", "look1", "phase", "raster"],
                    help="fly a scripted policy instead of a checkpoint: "
                         "naive, look1 and phase read the true source; "
                         "raster is the non-privileged boustrophedon "
                         "surveyor (compose with --guide fit)")
    sp.add_argument("--guide", choices=["none", "fit", "learned", "bank"],
                    default="none",
                    help="terminal guidance: 'fit' locates the source "
                         "online from the agent's own samples (isotropic "
                         "trilateration, or a Gauss-Newton fit of the "
                         "anisotropic plume); 'learned' runs the source "
                         "localizer of --guide-ckpt in the eval loop; "
                         "'bank' identifies the episode's gridded-bank row "
                         "from its samples and dives at the row's source. "
                         "Each phase-controls the goal-ball crossing")
    sp.add_argument("--guide-max-se", type=float, default=None,
                    help="override the --guide fit validation gate "
                         "(posterior worst-direction standard error, px)")
    sp.add_argument("--guide-search-after", type=int, default=None,
                    help="contact search: with no in-plume sample for this "
                         "many steps, steer a resuming serpentine survey.  "
                         "--guide bank: default 50; --guide fit "
                         "(anisotropic only): default off.  Negative "
                         "disables")
    sp.add_argument("--guide-ckpt",
                    help="--guide learned: the localizer's run directory "
                         "(train-lstm --variant params) or its "
                         "gaussian_params.pt")
    sp.add_argument("--guide-stable-tol", type=float, default=None,
                    help="--guide learned: px agreement of consecutive "
                         "estimates that opens the gate (default: derived "
                         "from localizer_meta.npz)")
    sp.add_argument("--guide-min-window", type=int, default=None,
                    help="--guide learned: steps before the first "
                         "stability check (default: derived); --guide "
                         "bank: in-plume reads before the gate may open "
                         "(default 2)")
    sp.add_argument("--guide-check-every", type=int, default=None,
                    help="steps between checks (--guide learned default: "
                         "derived; --guide bank: 1)")
    sp.add_argument("--guide-margin", type=float, default=None,
                    help="--guide bank: commit only when the runner-up "
                         "row's score exceeds the best's by this ratio "
                         "(default 1.5; 1.0 = identity stability only)")
    sp.add_argument("--guide-margin-until", type=int, default=None,
                    help="--guide bank: require the margin only before "
                         "this flight step (0 = always; default 400)")
    sp.add_argument("--guide-rim-guard",
                    action=argparse.BooleanOptionalAction, default=True,
                    help="--guide bank: while unidentified, deflect steps "
                         "landing inside any candidate row's ball and "
                         "steer to the top-2 rows' disagreement (default "
                         "on)")
    sp.add_argument("--guide-guard-top", type=int, default=0,
                    help="--guide bank: guard only the top-N scored rows' "
                         "balls once contact exists (0 = all rows)")
    sp.add_argument("--guide-entry-dive",
                    action=argparse.BooleanOptionalAction, default=False,
                    help="--guide bank: forbid only shallow-chord landings "
                         "and turn ball entries into deep dives")
    sp.add_argument("--guide-dive-bias",
                    action=argparse.BooleanOptionalAction, default=False,
                    help="--guide bank: a move entering the nearest "
                         "candidate ball takes the deepest landing")
    sp.add_argument("--guide-sticky-target",
                    action=argparse.BooleanOptionalAction, default=False,
                    help="--guide bank: seat the dive row at gate-open, "
                         "reseat on a 1.3x score margin only")
    sp.add_argument("--guide-rim-expire", type=int, default=400,
                    help="--guide bank: steps after which an unidentified "
                         "episode's rim guard fails open (default 400)")
    sp.add_argument("--stop",
                    choices=["none", "heuristic", "threshold", "peakstop"],
                    default="none",
                    help="stop gate (threshold and peakstop read the LSTM "
                         "of --lstm-ckpt)")
    sp.add_argument("--lstm-ckpt",
                    help="the stop LSTM's state_dict for --stop threshold / "
                         "peakstop (the threshold gate's scaler_params.npy "
                         "lies beside it)")
    sp.add_argument("--sample", action="store_true",
                    help="sample actions instead of greedy argmax")
    sp.add_argument("--goal-radius", type=float,
                    help="episode-termination radius (default: "
                         "INITIAL_RADIUS=50, the reference protocol; set 5.0 "
                         "for the precision metric)")
    sp.add_argument("--save-flights",
                    help="write flights.npz (trajectories + true sources)")
    sp.add_argument("--localize",
                    help="a source localizer (train-lstm --variant params: "
                         "its run directory or gaussian_params.pt): predict "
                         "each flight's source from its own (x, y, conc) "
                         "history and report the error")
    sp.add_argument("--localize-window", type=int, default=64)
    sp.set_defaults(fn=cmd_eval)

    sp = sub.add_parser("expert", help="generate expert demonstrations",
                        allow_abbrev=False)
    _common(sp, "expert_data.npz")
    sp.add_argument("--oracle", choices=["naive", "look1", "phase"],
                    help="a privileged scripted teacher (true source "
                         "known) instead of a checkpoint")
    sp.set_defaults(fn=cmd_expert)

    sp = sub.add_parser(
        "flux", help="flux-inversion study (README <20%% error goal)")
    _common(sp, None)
    sp.add_argument("--sources", type=int, default=3)
    sp.add_argument("--steps", type=int, default=400,
                    help="survey steps per episode")
    sp.add_argument("--estimated", action="store_true",
                    help="estimate the source positions from the flight "
                         "data (no oracle positions) and report the joint "
                         "position and strength error")
    sp.add_argument("--survey", choices=["random", "raster"],
                    default="random",
                    help="survey track: 'raster' flies the non-privileged "
                         "boustrophedon surveyor instead of the random walk "
                         "or the --ckpt/--pth policy")
    sp.add_argument("--refine-steps", type=int, default=0,
                    help="two-pass survey: reserve this many of --steps "
                         "for pass-2 orbits around the pass-1 position "
                         "estimates (same total budget)")
    sp.set_defaults(fn=cmd_flux)

    sp = sub.add_parser("inspect-nc", help="dump NetCDF dataset schema")
    sp.add_argument("path")
    sp.set_defaults(fn=cmd_inspect_nc)

    sp = sub.add_parser("plot", help="trajectory-field / training-curve plots")
    sp.add_argument("--what", choices=["field", "curves"], default="field")
    sp.add_argument("--nc", help="training_data.nc (field plot)")
    sp.add_argument("--csv", help="training_results.csv (curves plot)")
    sp.add_argument("--episode", type=int, default=0)
    sp.add_argument("--out", default="plot.png")
    sp.set_defaults(fn=cmd_plot)
    return p


def set_precision():
    """Full f32 products and f32 reductions of bf16 products on the card,
    the precision every check of the port assumes (TF32 is cuDNN's
    default)."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def main(argv=None):
    from tpu_plume_torch.core.debug import debug_nans

    args = build_parser().parse_args(argv)
    set_precision()
    with debug_nans(getattr(args, "debug_nans", False)):
        args.fn(args)


if __name__ == "__main__":
    main()
