"""Config fields whose paths the port does not run yet.

Each raises ``NotImplementedError`` naming the ``ROADMAP.md`` item that will
port it, so a config meant for the JAX package never runs a different
program here without saying so.
"""

from __future__ import annotations

from tpu_plume_torch.core.config import EnvConfig, PPOConfig

_ANALYTIC = ("ROADMAP.md Queue 1, slice 6 (anisotropic, multi-source and "
             "3-D analytic plumes)")
_RNN = "ROADMAP.md Queue 1, slice 7 (recurrent policy)"
_GUIDES = "ROADMAP.md Queue 1, slice 9 (guides)"
_IMITATION = "ROADMAP.md Queue 1, slice 10 (imitation, GAIL and distilled PPO)"

# The JAX package's bank gather formulations; the port samples one function
# for all of them.
GATHER_MODES = ("auto", "packed", "corner", "fused")


def _unported(what: str, item: str):
    raise NotImplementedError(f"{what} is not ported yet: {item}")


def check_sources(cfg: EnvConfig) -> None:
    if cfg.num_sources > 1:
        _unported("num_sources > 1", _ANALYTIC)


def check_env(cfg: EnvConfig) -> None:
    if cfg.plume_model not in ("isotropic", "gridded"):
        _unported(f"plume_model={cfg.plume_model!r}", _ANALYTIC)
    check_sources(cfg)
    if cfg.bank_gather_mode not in GATHER_MODES:
        raise ValueError(f"bank_gather_mode must be one of {GATHER_MODES}, "
                         f"got {cfg.bank_gather_mode!r}")
    if cfg.env_3d and cfg.plume_model != "gridded":
        # The analytic 3-D field needs the plume kernel's z term.
        _unported(f"env_3d with plume_model={cfg.plume_model!r}", _ANALYTIC)


def check_ppo(cfg: PPOConfig) -> None:
    if cfg.arch != "mlp":
        _unported(f"arch={cfg.arch!r}", _RNN)
    if cfg.distill_oracle is not None:
        _unported("distill_oracle", _IMITATION)


def check_guide(guide) -> None:
    if guide is not None:
        _unported("a training guide", _GUIDES)
