from tpu_plume_torch.viz.plots import (
    plot_gaussian_field,
    plot_training_curves,
    training_dashboard,
)

__all__ = ["plot_gaussian_field", "plot_training_curves", "training_dashboard"]
