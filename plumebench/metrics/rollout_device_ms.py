"""The rollout phase's device ms per iteration: the median, over the timed
window's iterations, of the program's ``rollout`` span's device duration
(its end marker less its start marker, CUDA events on the stream), the
window as ``rollout_host_ms.window`` selects it."""

from plumebench.metrics.rollout_host_ms import phase_ms


def read(ctx, metric):
    return phase_ms(ctx, "rollout", "device_ms")
