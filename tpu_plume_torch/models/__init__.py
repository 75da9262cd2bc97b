from tpu_plume_torch.models.actor_critic import ActorCritic
from tpu_plume_torch.models.discriminator import Discriminator
from tpu_plume_torch.models.lstm_zoo import (
    ConcentrationPredictor,
    ConcentrationThresholdPredictor,
    GaussianLSTM,
    GaussianParamAndStopPredictor,
    GaussianParamPredictor,
    LSTMModel,
    PeakAndStopPredictor,
)
from tpu_plume_torch.models.recurrent import RecurrentActorCritic

__all__ = [
    "ActorCritic",
    "ConcentrationPredictor",
    "ConcentrationThresholdPredictor",
    "Discriminator",
    "GaussianLSTM",
    "GaussianParamAndStopPredictor",
    "GaussianParamPredictor",
    "LSTMModel",
    "PeakAndStopPredictor",
    "RecurrentActorCritic",
]
