"""The config values the port runs, checked before any work, so a config
meant for the JAX package never runs a different program here without
saying so.
"""

from __future__ import annotations

from tpu_plume_torch.core.config import EnvConfig, PPOConfig

# The JAX package's bank gather formulations; the port samples one function
# for all of them.
GATHER_MODES = ("auto", "packed", "corner", "fused")


PLUME_MODELS = ("isotropic", "anisotropic", "gridded")
ARCHS = ("mlp", "lstm")


def check_env(cfg: EnvConfig) -> None:
    if cfg.plume_model not in PLUME_MODELS:
        raise ValueError(f"plume_model must be one of {PLUME_MODELS}, got "
                         f"{cfg.plume_model!r}")
    if cfg.bank_gather_mode not in GATHER_MODES:
        raise ValueError(f"bank_gather_mode must be one of {GATHER_MODES}, "
                         f"got {cfg.bank_gather_mode!r}")


def check_ppo(cfg: PPOConfig) -> None:
    if cfg.arch not in ARCHS:
        raise ValueError(f"arch must be one of {ARCHS}, got {cfg.arch!r}")
