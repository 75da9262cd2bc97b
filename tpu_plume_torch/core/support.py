"""Config fields whose paths the port does not run yet.

Each raises ``NotImplementedError`` naming the ``ROADMAP.md`` item that will
port it, so a config meant for the JAX package never runs a different
program here without saying so.
"""

from __future__ import annotations

from tpu_plume_torch.core.config import EnvConfig, PPOConfig

_FUSED = "ROADMAP.md Queue 1, slice 2 (fused PPO update and mixed precision)"
_BANKS = "ROADMAP.md Queue 1, slice 5 (gridded banks and 3-D flight)"
_ANALYTIC = "ROADMAP.md Queue 1, slice 6 (anisotropic and multi-source plumes)"
_RNN = "ROADMAP.md Queue 1, slice 7 (recurrent policy)"
_GUIDES = "ROADMAP.md Queue 1, slice 9 (guides)"
_IMITATION = "ROADMAP.md Queue 1, slice 10 (imitation, GAIL and distilled PPO)"


def _unported(what: str, item: str):
    raise NotImplementedError(f"{what} is not ported yet: {item}")


def check_env(cfg: EnvConfig) -> None:
    if cfg.plume_model == "gridded":
        _unported('plume_model="gridded"', _BANKS)
    if cfg.plume_model != "isotropic":
        _unported(f"plume_model={cfg.plume_model!r}", _ANALYTIC)
    if cfg.num_sources > 1:
        _unported("num_sources > 1", _ANALYTIC)
    if cfg.env_3d:
        _unported("env_3d", _BANKS)


def check_ppo(cfg: PPOConfig) -> None:
    if cfg.arch != "mlp":
        _unported(f"arch={cfg.arch!r}", _RNN)
    for flag in ("fused_update", "bf16_compute", "bf16_update", "f32_heads",
                 "remat"):
        if getattr(cfg, flag):
            _unported(flag, _FUSED)
    if cfg.distill_oracle is not None:
        _unported("distill_oracle", _IMITATION)


def check_guide(guide) -> None:
    if guide is not None:
        _unported("a training guide", _GUIDES)
