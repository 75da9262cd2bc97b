"""The update phase's device ms per iteration: the median, over the timed
window's iterations, of the program's ``update`` span's device duration
(its end marker less its start marker), the window as
``rollout_host_ms.window`` selects it."""

from plumebench.metrics.rollout_host_ms import phase_ms


def read(ctx, metric):
    return phase_ms(ctx, "update", "device_ms")
