from tpu_plume_torch.core.config import (
    PRESETS,
    CurriculumConfig,
    EnvConfig,
    PPOConfig,
    RolloutConfig,
    TrainConfig,
    get_preset,
)
from tpu_plume_torch.core.device import resolve_device

__all__ = [
    "PRESETS",
    "CurriculumConfig",
    "EnvConfig",
    "PPOConfig",
    "RolloutConfig",
    "TrainConfig",
    "get_preset",
    "resolve_device",
]
