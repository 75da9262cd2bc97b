from tpu_plume_torch.train.ppo_trainer import TrainResult, build_train_step, train_ppo

__all__ = ["TrainResult", "build_train_step", "train_ppo"]
