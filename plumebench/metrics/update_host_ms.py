"""The update phase's host ms per iteration: the median, over the timed
window's iterations, of the program's ``update`` span, from building the
batch to ``ppo_update``'s return, with no synchronisation; the window as
``rollout_host_ms.window`` selects it."""

from plumebench.metrics.rollout_host_ms import phase_ms


def read(ctx, metric):
    return phase_ms(ctx, "update", "host_ms")
