"""Device operations per iteration: the profiled iteration's device
entries (``profiling.device_kernels``), counted."""


def read(ctx, metric):
    if ctx.kernel_time is None or not ctx.profiled_iters:
        return None
    count = sum(c for _, c, _ in ctx.kernels)
    return count / ctx.profiled_iters if count else None
