"""The analytic env step's share of its roofline: the least time of the
profiled iteration's env steps (``counts.env_step_bytes`` of N envs and
each step's finished envs over the memory rate, or its operations over the
f32 rate, the larger, summed over the steps) over the device time of the
kernels the metric's files name."""

from plumebench import counts, inputs


def read(ctx, metric):
    if ctx.kernel_time is None:
        return None
    launches, seconds = ctx.kernel_time(metric.kernels)
    if not launches or not seconds:
        return None
    env = ctx.spec.env
    n = ctx.spec.num_envs
    least = 0.0
    for traj in ctx.trajs:
        for d in traj.done.sum(1).tolist():
            least += counts.least_seconds(
                counts.env_step_bytes(inputs.num_actions(env),
                                      inputs.pos_dim(env),
                                      ctx.cfg.env.obs_dim,
                                      env["grid_divisions"], n, d),
                counts.env_step_ops(n, d))
    return 100.0 * least / seconds
