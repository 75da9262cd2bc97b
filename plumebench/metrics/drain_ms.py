"""The drain's host ms: the median of the program's ``drain`` spans
(``train/hostsync.py``, one transfer a window of ``sync_every``
iterations) attached to the timed window's iterations, the window as
``rollout_host_ms.window`` selects it."""

import statistics

from plumebench.metrics.rollout_host_ms import window


def read(ctx, metric):
    run = window(ctx)
    if run is None:
        return None
    ms = [d.host_ms for r in run for d in r.drains]
    return statistics.median(ms) if ms else None
