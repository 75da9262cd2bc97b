from tpu_plume_torch.cli.main import main

__all__ = ["main"]
