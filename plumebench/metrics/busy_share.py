"""The device's busy share of the profiled iteration: the union of its
device operations' intervals over the iteration's wall time."""


def read(ctx, metric):
    if ctx.kernel_time is None or not ctx.profiled_wall_s or not ctx.busy_s:
        return None
    return 100.0 * ctx.busy_s / ctx.profiled_wall_s
