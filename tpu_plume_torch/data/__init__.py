from tpu_plume_torch.data.expert import load_expert_data, save_expert_data

__all__ = ["load_expert_data", "save_expert_data"]
