"""Typed configuration, the PyTorch port's own copy.

A field-for-field copy of ``tpu_plume/core/config.py`` (which imports only
``dataclasses``), kept here so the port imports nothing of the JAX package
while both packages read the same field names and presets.  The per-field
comments describe the JAX package's measurements and are kept as they are.

The reference expresses configuration as per-version copies of a flat
``config.py`` constants module (reference: PPOV1.1/config.py:1-37,
PPOV2.0/config.py:1-46, PPOV2.1/config.py:1-44; inlined in PPOV1.0/ppo0.0.py
and PPOV1.2).  Here every knob becomes a field on a frozen dataclass and the
five reference generations become named presets: ``ppo_v1_0`` ... ``ppo_v2_1``
plus the WRF-LES north-star config ``wrf_les``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class EnvConfig:
    """Methane-plume environment knobs.

    Field semantics follow the reference env (PPOV1.1/environment.py:18-168,
    PPOV2.1/environment.py:19-178, PPOV1.0/ppo0.0.py:64-198); version
    differences are expressed as flags rather than code copies.
    """

    # Domain / episode (reference config.py: GRID_SIZE, MAX_STEPS)
    grid_size: int = 500
    max_steps: int = 1000

    # Plume field (reference: _generate_plume)
    conc_peak: float = 100.0           # CONC_PEAK / PEAK_CONCENTRATION
    plume_sigma: float = 31.25         # grid_size/16 in V1.x; GAUSSIAN_RADIUS=15.0 in V2.1
    turbulence_intensity: float = 3.0  # TURBULENCE_INTENSITY
    source_padding: float = 50.0       # reset(): source ~ U(padding, grid-padding)^2
    # Plume model selector:
    #   "isotropic"   — the reference code's isotropic Gaussian (default);
    #   "anisotropic" — the README-specified Gaussian dispersion
    #                   sigma_y = 0.3 x^0.71 with wind advection (README.md:97
    #                   — specified by the reference but never implemented);
    #   "gridded"     — fields sampled from an HBM-resident FieldBank
    #                   (WRF-LES NetCDF ingest or synthetic), see
    #                   tpu_plume.fields.gridded.
    plume_model: str = "isotropic"
    sigma_y_coef: float = 0.3
    sigma_y_exp: float = 0.71
    sigma_y_min: float = 5.0           # near-source crosswind spread floor
    wind_speed_range: tuple = (0.0, 0.0)  # per-episode |wind|, grid units/step

    # --- 3-D flight (new capability; the reference is strictly 2-D while its
    # README advertises a UAV in a WRF-LES volume — SURVEY.md §0).  With
    # ``env_3d`` the agent carries a z coordinate in [0, domain_height]
    # (grid units), gets ±z actions, and observes z/domain_height; the plume
    # gains a vertical Gaussian profile around ``source_z`` with spread
    # sigma_z = max(sigma_z_min, sigma_z_coef * downwind^sigma_z_exp)
    # (anisotropic) or the isotropic 3-D radial Gaussian.  Success stays a
    # *horizontal* distance gate: the source is a ground (x, y) point and the
    # reference's deviation metric is planimetric (PPOV2.0/evaluate_with_lstm
    # .py:100-132).
    env_3d: bool = False
    domain_height: float = 100.0       # z extent, grid units
    z_move_frac: float = 0.02          # vertical step = grid_size * z_move_frac
    source_z: float = 0.0              # plume release height
    sigma_z_coef: float = 0.2
    sigma_z_exp: float = 0.7
    sigma_z_min: float = 3.0
    # Gridded-bank sampling: integer-cell reads (reference parity) or
    # sub-cell multilinear interpolation of the (x, y[, z], t) query point
    # (the north-star per-UAV field query).
    subcell_sampling: bool = False
    # Multilinear-corner fetch formulation (all parity-tested):
    #   "auto"   — packed (t,z)-component layout when it fits HBM (4x bank
    #              memory, FOUR gathers — fastest measured), else corner;
    #   "packed" — force the packed layout;
    #   "corner" — one scattered gather per corner (2/4/8/16);
    #   "fused"  — one flat-index gather for every corner (2x slower than
    #              corner on v5e; kept for parity tests / other backends).
    # v5e @4096 queries over [4,8,8,500,500] (RESULTS.md round 3,
    # sample-only): packed 5.3M, corner 2.5M, fused ~1.1M samples/s.
    bank_gather_mode: str = "auto"
    # Horizontal advection of the agent by the field wind (grid units of
    # displacement per unit wind per step); 0 disables.  Gridded banks supply
    # per-frame wind (FieldBank.wind); the analytic models use the episode
    # wind vector.
    wind_advect_coef: float = 0.0

    # --- One-step observation memory (opt-in extension; off = reference
    # parity).  Appends [Δconc/peak, one-hot(prev action)] to the obs: the
    # minimal sufficient statistics for run-and-tumble chemotaxis (keep
    # heading while concentration rises, turn when it falls), which the
    # reference's memoryless 6-dim obs cannot express — its greedy policies
    # can only sweep, capping goal-ball crossing depth at chord geometry
    # (RESULTS.md round-2 greedy study).
    obs_memory: bool = False

    # --- Multi-source plumes (reference README.md:18 goal — flux inversion
    # <20% error — with no code anywhere in the reference).  With
    # num_sources > 1 the analytic field is a strength-weighted superposition
    # of kernels; extra source positions/strengths derive from the episode
    # seed (fields.analytic.all_sources / source_strengths) and success
    # gates on the NEAREST source.  See evaluation/flux.py for the
    # flux-inversion estimator.
    num_sources: int = 1
    source_strength_range: tuple = (0.5, 1.5)
    # V1.0 uses signed randn for the turbulence normal term and
    # tke_field = |turbulence| * 2 (PPOV1.0/ppo0.0.py:108-114); V1.1+ uses
    # |randn| and tke_field = turbulence (PPOV1.1/environment.py:56-62).
    turbulence_signed_normal: bool = False
    tke_abs_times_two: bool = False

    # Kinematics (reference: step())
    move_frac: float = 0.05            # move_step = grid_size * move_frac
    turb_displacement_coef: float = 0.2
    # V1.0 has elastic/bounce-back walls (ppo0.0.py:152-154); V1.1 clips to
    # grid-1e-6 (environment.py:105); V2.x clips to grid-1
    # (PPOV2.0/environment.py:105, PPOV2.1/environment.py:112).
    elastic_walls: bool = False
    clip_edge_eps: float = 1.0         # pos clipped to [0, grid_size - clip_edge_eps]

    # Exploration grid (reference: GRID_DIVISIONS, EXPLORE_BONUS)
    grid_divisions: int = 10
    explore_bonus_init: float = 0.6
    explore_visit_norm: float = 5.0    # explore_level = min(visits/5, 1)
    explore_visit_pow: float = 0.75    # explore_reward ~ 1/(visits^0.75 + 1)

    # Reward shaping (reference config.py:34-37 and step():139-151).
    # reward_variant "v1_1" is the V1.1+ shaped form; "v1_0" is the simpler
    # PPOV1.0 form (ppo0.0.py:158-187): flat move penalty, explore
    # bonus/(visits+1), flat -0.5 boundary penalty inside a 10% margin,
    # uncapped terminal bonus 100*(R0/R).
    # "delta" is the REFERENCE README's OWN reward specification
    # R = Δ[CH4] − 0.2·‖Δθ‖ (README.md:97-99), which no reference code
    # implements (SURVEY.md §2.2 mismatch note): the concentration term
    # becomes the per-step *change* coef·Δconc_n (rewarding gradient ascent
    # instead of loitering on high concentration) and the heading-change
    # penalty readme_turn_penalty·(1−cosΔθ)/2 is added to the move term;
    # explore/tke/boundary/terminal shaping stay as v1_1.
    reward_variant: str = "v1_1"
    readme_turn_penalty: float = 0.2
    conc_reward_coef: float = 2.0
    # Per-step bonus while the raw normalized concentration (conc/peak) is
    # above inplume_conc_floor — 0.06 raw ~ the model-fit guide's debiased
    # 0.03 sample-acceptance floor.  0 disables (default — the reference
    # has no such term).  Motivation, measured (RESULTS.md round 3, wrf
    # guided loss pool): the delta reward pays for concentration CHANGES,
    # so riding the plume earns nothing and the policy crosses the ~10-px
    # wrf ridge in 1-2 steps — 46.5% of guided episodes fail with a median
    # of FIVE usable samples.  This knob trains contact-riding: more
    # accepted samples -> more validated fits.
    inplume_bonus: float = 0.0
    inplume_conc_floor: float = 0.06
    move_penalty_coef: float = 0.15
    tke_penalty_factor: float = 0.4
    boundary_penalty: float = 0.1
    boundary_decay_start: float = 0.15
    boundary_gradient_gate: float = -0.01
    terminal_bonus_cap: float = 500.0
    terminal_bonus_coef: float = 150.0
    # Extra terminal reward proportional to crossing depth
    # (radius - distance)/radius — teaches the policy to aim through the
    # goal ball's center instead of grazing its rim, which converts
    # radius-50 reaches into <=40-deviation successes under the reference
    # eval protocol (PPOV2.0/config.py:43).  0 disables (default;
    # reference parity).
    terminal_depth_coef: float = 0.0
    # Exponent on the normalized crossing depth.  1.0 = linear (round-2
    # default).  >1 concentrates the bonus on genuinely deep crossings:
    # with move_step 25 a radius-50 crossing lands in (25, 50], i.e.
    # depth in [0, 0.5), and the protocol's success@40 needs depth >= 0.2
    # — power 2-3 pays a graze (depth 0.04) ~nothing while keeping a
    # smooth gradient, unlike a hard 1[d<=40] bonus.
    terminal_depth_power: float = 1.0
    # Success-gated terminal bonus: when > 0, the WHOLE terminal bonus
    # (base + depth) is multiplied by 1[distance <= gate] at the crossing
    # step — the training reward becomes exactly the reference eval
    # metric (success = deviation <= 40 at the first radius-50 crossing,
    # PPOV2.0/evaluate_with_lstm.py).  A shallow 40-50 graze then ends
    # the episode with NO terminal payout, so the policy learns to
    # phase-adjust its approach (tangential steps before the final
    # radial move) instead of crossing on a random chord.  0 disables
    # (default; reference parity).
    terminal_gate_radius: float = 0.0
    # v1_0-only knobs (PPOV1.0/ppo0.0.py:166-183)
    v10_flat_move_penalty: float = 0.05
    v10_boundary_margin_frac: float = 0.1
    v10_boundary_penalty: float = 0.5

    # Curriculum success radius (reference: INITIAL_RADIUS)
    initial_radius: float = 50.0

    @property
    def move_step(self) -> float:
        return self.grid_size * self.move_frac

    @property
    def z_move_step(self) -> float:
        return self.grid_size * self.z_move_frac

    @property
    def cell_size(self) -> int:
        return self.grid_size // self.grid_divisions

    @property
    def pos_dim(self) -> int:
        return 3 if self.env_3d else 2

    @property
    def obs_dim(self) -> int:
        # 3-D adds z/domain_height after (x, y); obs_memory appends
        # Δconc + a prev-action one-hot.
        base = 7 if self.env_3d else 6
        if self.obs_memory:
            base += 1 + self.num_actions
        return base

    @property
    def num_actions(self) -> int:
        # 3-D adds up/down to stay/±y/±x
        return 7 if self.env_3d else 5


@dataclass(frozen=True)
class PPOConfig:
    """PPO hyperparameters (reference config.py:11-18 and the _update_model
    implementations, e.g. PPOV2.0/train_ppo2.0.py:15-88)."""

    gamma: float = 0.99
    gae_lambda: float = 0.95
    clip_epsilon: float = 0.2
    entropy_beta: float = 0.01
    learning_rate: float = 3e-5
    minibatch_size: int = 256
    epochs: int = 5
    max_grad_norm: float = 0.5
    value_loss_coef: float = 0.5
    adv_norm_eps: float = 1e-6
    # The reference computes returns from *normalized* advantages
    # (PPOV2.0/train_ppo2.0.py:34-40) — a known quirk.  Default is the
    # corrected behavior (returns from raw advantages); set bug_compat_returns
    # to reproduce the reference exactly.
    bug_compat_returns: bool = False
    # Minibatch shuffling per epoch:
    #   "roll"   (default) — random circular rotation of the T-major flat
    #            batch: zero gather cost on TPU; every minibatch spans all
    #            envs at a random time offset.
    #   "affine" — O(1) random affine index bijection (true permutation-like
    #            mixing; costs a full random gather, ~2x slower update).
    #   "sort"   — full random permutation like the reference's randperm
    #            (PPOV2.0/train_ppo2.0.py:44); costs a 500k-element sort.
    shuffle_mode: str = "roll"
    # Compute the actor-critic trunk in bfloat16 (params stay f32, outputs
    # cast back to f32).  MXU-native; off by default for exact-parity runs.
    # NOTE the round-2 "bf16 measured as a no-op" was a false negative: the
    # model's dtype pin made flax promote everything back to f32.  Measured
    # properly (round 3): 16.7 -> 24.6M env-steps/s on the flagship fused
    # train step.
    bf16_compute: bool = False
    # Mixed split (round-4 VERDICT #5): bfloat16 compute in the PPO UPDATE
    # only (the measured 80% of the step), f32 rollout.  Params stay f32
    # either way (flax param_dtype), so full bf16_compute is already an
    # f32-master-weights config — this split additionally keeps the
    # rollout's action/value path in f32, isolating whether the wrf
    # thin-ridge quality regression under full bf16 (RESULTS.md bf16
    # study: 38.4% guided vs f32's 48-53) lives in the rollout or the
    # gradient mantissa.  Ignored when bf16_compute is already on.
    bf16_update: bool = False
    # Keep the actor/critic HEADS in f32 inside the bf16 update twin
    # (round-5 terminal-precision study): the split's one residual vs f32
    # is the radius-5 bullseye (61.0 vs 68.6) — the candidate mechanism is
    # head-matmul rounding of the value surface near terminal states.
    # Heads are 128->5 / 128->1, so this costs no measurable throughput.
    # Only meaningful with bf16_update or bf16_compute.
    f32_heads: bool = False
    # Fused Pallas fwd+bwd gradient kernel for the standard feedforward
    # ActorCritic (ops/pallas_ppo.py): activations stay in VMEM instead of
    # round-tripping HBM between the forward and backward matmuls — the
    # update was measured HBM-traffic-bound (~25 of the ~31 ms flagship
    # iteration).  Parity with jax.grad(ppo_loss) is test-pinned; silently
    # falls back to autodiff for unsupported configs (lstm arch, distill
    # labels, ragged minibatches, CPU, multi-chip).
    # MEASURED SLOWER than XLA autodiff and default OFF (flagship 40-chain
    # update, v5e-1: fused 37.3 ms vs autodiff 24.3 / 14.8 ms bf16): at
    # this model size the Mosaic grid-pipeline overhead (~10 us x 64 row
    # tiles x 40 chains) exceeds the HBM traffic it saves, and the
    # sequential-chain dependency floor (~0.4 ms/chain) is already nearly
    # reached by the autodiff path under bf16_compute.  Kept for larger
    # trunk widths where the traffic term dominates.
    fused_update: bool = False
    # Rematerialize the update's loss forward inside the backward
    # (jax.checkpoint around ppo_loss): trades +1 trunk forward of FLOPs
    # for NOT round-tripping the trunk activations through HBM between
    # fwd and bwd — the other lever on the same HBM-traffic bound the
    # Pallas fused kernel targeted.  A/B'd on the flagship 40-chain
    # update before changing any default.
    remat: bool = False
    # Actor-critic trunk widths.  (256, 128) is the reference architecture
    # (PPOV1.1/model.py:17-53); wider trunks are a performance config (the
    # MXU is indifferent up to ~1024 at these batch sizes).
    hidden_sizes: tuple = (256, 128)
    # Policy architecture: "mlp" (reference parity) or "lstm" — the
    # recurrent PPO+LSTM policy the reference's name advertises but never
    # implements (its LSTMs are offline stop predictors, SURVEY.md §2.5).
    # Memory lets the policy sense the concentration gradient across steps
    # (chemotaxis), which the memoryless 6-dim obs cannot express.
    arch: str = "mlp"
    # Distilled PPO: a scripted privileged teacher (evaluation/oracle.py —
    # "naive" / "look1" / "phase") labels every rollout state ON DEVICE and
    # the update adds distill_coef * cross-entropy(policy, teacher) to the
    # loss — on-policy DAgger composed with the RL objective (no
    # distribution shift, reward covers what the teacher's privileged
    # direction knowledge makes obs-uninferable).  None = off (no extra
    # rollout compute).
    distill_oracle: str | None = None
    distill_coef: float = 0.1
    # Imitate only where normalized conc exceeds this gate (0 = imitate
    # everywhere): far-field teacher actions ride privileged direction
    # knowledge the obs cannot carry.
    distill_conc_gate: float = 0.0
    lstm_hidden: int = 128
    lstm_embed: int = 128
    # LayerNorm-LSTM cell for the recurrent policy (Ba et al. 2016):
    # normalizes gate pre-activations + cell output — an optimization
    # stabilizer for long BPTT chunks.
    lstm_layer_norm: bool = False


@dataclass(frozen=True)
class CurriculumConfig:
    """Success-rate-windowed curriculum on the goal radius plus
    exploration-bonus decay (reference: PPOTrainer.update,
    PPOV1.1/model.py:121-164; constants config.py:20-31).

    ``variant="simple"`` is the PPOV1.0 controller (ppo0.0.py:261-287):
    per-episode explore decay, shrink-only radius (no expand / no
    anti-oscillation)."""

    variant: str = "adaptive"
    initial_radius: float = 50.0
    min_radius: float = 5.0
    radius_decay: float = 0.9
    success_threshold: float = 0.6
    window_size: int = 120
    expand_below: float = 0.25
    expand_rate: float = 1.1
    anti_oscillation_clamp: float = 5.0
    explore_decay_factor: float = 0.999
    explore_bonus_floor: float = 0.1


@dataclass(frozen=True)
class RolloutConfig:
    """On-device rollout geometry — a new capability (the reference steps a
    single env in a Python loop; SURVEY.md §2.3)."""

    num_envs: int = 4096
    unroll_length: int = 128   # steps per env per learner update


@dataclass(frozen=True)
class StopConfig:
    """Dynamic-stop subsystem knobs (reference: PPOV2.0/config.py:39-44,
    PPOV2.0/evaluate_with_lstm.py:10-37, PPOV2.1/evaluate_with_lstm.py:73-81)."""

    training_window: int = 10      # TRAINING_SIZE (V2.0 last-N conc window)
    evaluate_window: int = 10      # EVALUATE_SIZE
    min_activate_steps: int = 20   # 2 * EVALUATE_SIZE
    threshold_scale: float = 0.95  # predicted source conc * 0.95 -> threshold
    peak_stop_window: int = 20     # V2.1 last-20 window
    peak_stop_prob: float = 0.8    # V2.1 stop gate
    conc_norm: float = 100.0       # V2.1 window / 100.0


@dataclass(frozen=True)
class EvalConfig:
    """Evaluation harness knobs (reference: PPOV2.0/config.py:43,
    PPOV2.1/evaluate_with_lstm.py:88, PPOV1.1/evaluate_model.py:15-17)."""

    episodes: int = 1000
    success_distance: float = 40.0   # SUCCESS_DISTANCE_THRESHOLD (V2.0); 50 in V2.1
    # V1.1 heuristic stop: std of last-10 positions < 2.0 and conc > 0.8*peak
    heuristic_position_window: int = 10
    heuristic_stability_threshold: float = 2.0
    heuristic_conc_frac: float = 0.8
    max_eval_steps: int = 2000       # V1.1 evaluator guard (evaluate_model.py:52)


@dataclass(frozen=True)
class TrainConfig:
    """Top-level bundle for a training run."""

    name: str = "ppo_v2_0"
    env: EnvConfig = EnvConfig()
    ppo: PPOConfig = PPOConfig()
    curriculum: CurriculumConfig = CurriculumConfig()
    rollout: RolloutConfig = RolloutConfig()
    stop: StopConfig = StopConfig()
    eval: EvalConfig = EvalConfig()
    total_episodes: int = 2000     # reference trains 2000 episodes
    seed: int = 0

    def replace(self, **kw) -> "TrainConfig":
        return dataclasses.replace(self, **kw)


def _v1_0() -> TrainConfig:
    """PPOV1.0: single-file baseline (PPOV1.0/ppo0.0.py:17-41, 64-198)."""
    return TrainConfig(
        name="ppo_v1_0",
        env=EnvConfig(
            max_steps=5000,
            plume_sigma=500 / 16,
            turbulence_signed_normal=True,
            tke_abs_times_two=True,
            elastic_walls=True,
            reward_variant="v1_0",
            conc_reward_coef=3.0,
            tke_penalty_factor=0.3,
        ),
        curriculum=CurriculumConfig(variant="simple"),
        rollout=RolloutConfig(num_envs=256, unroll_length=128),
    )


def _v1_1() -> TrainConfig:
    """PPOV1.1: modular PPO + GAIL (PPOV1.1/config.py:1-37)."""
    return TrainConfig(
        name="ppo_v1_1",
        env=EnvConfig(max_steps=5000, plume_sigma=500 / 16, clip_edge_eps=1e-6),
        rollout=RolloutConfig(num_envs=256, unroll_length=128),
    )


def _v2_0() -> TrainConfig:
    """PPOV2.0: LSTM dynamic stop-threshold (PPOV2.0/config.py:1-46)."""
    return TrainConfig(
        name="ppo_v2_0",
        env=EnvConfig(max_steps=1000, plume_sigma=500 / 16),
        eval=EvalConfig(success_distance=40.0),
    )


def _v2_1() -> TrainConfig:
    """PPOV2.1: parameterized Gaussian + joint peak+stop LSTM
    (PPOV2.1/config.py:1-44, PPOV2.1/environment.py:52-69)."""
    return TrainConfig(
        name="ppo_v2_1",
        env=EnvConfig(max_steps=1000, plume_sigma=15.0),
        eval=EvalConfig(success_distance=50.0),
        stop=StopConfig(peak_stop_window=20, peak_stop_prob=0.8),
    )


def _wrf_les() -> TrainConfig:
    """North-star config: anisotropic Gaussian dispersion sigma_y=0.3 x^0.71
    with wind advection (README.md:97 of the reference — specified but never
    implemented there).  Use ``fields.gridded`` + ``plume_model="gridded"``
    for real WRF-LES NetCDF fields."""
    return TrainConfig(
        name="wrf_les",
        env=EnvConfig(
            max_steps=1000,
            plume_sigma=15.0,
            plume_model="anisotropic",
            wind_speed_range=(1.0, 4.0),
        ),
        rollout=RolloutConfig(num_envs=4096, unroll_length=128),
    )


def _wrf_les_3d() -> TrainConfig:
    """Full north-star config: 3-D flight through a time-varying gridded
    WRF-LES volume ([K, T, Z, H, W] FieldBank with per-frame wind) with
    sub-cell (x, y, z, t) field queries and wind advection.  Pair with a
    bank from ``fields.gridded.synthesize_3d_bank`` or ``ingest_netcdf``
    (CLI: ``--bank``/``--synth-bank``)."""
    return TrainConfig(
        name="wrf_les_3d",
        env=EnvConfig(
            max_steps=1000,
            plume_sigma=15.0,
            plume_model="gridded",
            env_3d=True,
            subcell_sampling=True,
            wind_advect_coef=0.5,
        ),
        rollout=RolloutConfig(num_envs=4096, unroll_length=128),
    )


PRESETS = {
    "ppo_v1_0": _v1_0,
    "ppo_v1_1": _v1_1,
    "ppo_v2_0": _v2_0,
    "ppo_v2_1": _v2_1,
    "wrf_les": _wrf_les,
    "wrf_les_3d": _wrf_les_3d,
}


def get_preset(name: str) -> TrainConfig:
    try:
        return PRESETS[name]()
    except KeyError:
        raise KeyError(f"unknown preset {name!r}; available: {sorted(PRESETS)}")
