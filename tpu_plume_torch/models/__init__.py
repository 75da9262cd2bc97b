from tpu_plume_torch.models.actor_critic import ActorCritic

__all__ = ["ActorCritic"]
