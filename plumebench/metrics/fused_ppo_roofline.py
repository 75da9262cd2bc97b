"""The fused PPO gradients' share of their roofline: the least time of the
profiled iteration's minibatch gradients (``counts.ppo_bound_seconds`` of
a minibatch, once per launch of the first kernel the metric names) over
the device time of all the kernels its files name."""

from plumebench import counts


def read(ctx, metric):
    if ctx.kernel_time is None:
        return None
    steps, _ = ctx.kernel_time(metric.kernels[:1])
    launches, seconds = ctx.kernel_time(metric.kernels)
    if not steps or not seconds:
        return None
    p = ctx.spec.policy
    h1, h2 = p["hidden"]
    least = steps * counts.ppo_bound_seconds(
        ctx.spec.minibatch_size, p["obs_dim"], h1, h2, p["num_actions"])
    return 100.0 * least / seconds
