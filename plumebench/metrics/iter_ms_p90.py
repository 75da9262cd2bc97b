"""The 90th percentile of the window's iteration times (host clock, each
iteration ending on the program's own per-iteration host read and a
synchronised device), over the traced run's unprofiled window."""

import statistics


def read(ctx, metric):
    ms = ctx.iter_ms
    if not ms:
        return None
    if len(ms) < 2:
        return ms[0]
    return statistics.quantiles(ms, n=10, method="inclusive")[8]
