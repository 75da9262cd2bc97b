from tpu_plume_torch.models.actor_critic import ActorCritic
from tpu_plume_torch.models.recurrent import RecurrentActorCritic

__all__ = ["ActorCritic", "RecurrentActorCritic"]
