from tpu_plume_torch.evaluation.harnesses import (
    EvalDraws,
    EvalMetrics,
    draw_eval,
    evaluate_policy,
    generate_expert_data,
    make_heuristic_gate,
    make_peak_stop_gate,
    make_threshold_gate,
    summarize,
)

__all__ = [
    "EvalDraws",
    "EvalMetrics",
    "draw_eval",
    "evaluate_policy",
    "generate_expert_data",
    "make_heuristic_gate",
    "make_peak_stop_gate",
    "make_threshold_gate",
    "summarize",
]
