from tpu_plume_torch.stop.controllers import (
    HeuristicStopState,
    PeakStopState,
    ThresholdState,
    broadcast,
    heuristic_stop_init,
    heuristic_stop_step,
    peak_stop_init,
    peak_stop_step,
    threshold_init,
    threshold_step,
)

__all__ = [
    "HeuristicStopState",
    "PeakStopState",
    "ThresholdState",
    "broadcast",
    "heuristic_stop_init",
    "heuristic_stop_step",
    "peak_stop_init",
    "peak_stop_step",
    "threshold_init",
    "threshold_step",
]
