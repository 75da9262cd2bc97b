"""The sub-cell 3-D bank sample's share of its roofline: the least time of
the profiled iteration's bank samples (``counts.bank_sample_bytes`` over
the memory rate, summed over the samples) over the device time of the
kernels the metric's files name.  Per env step two samples of N queries:
at the moved agents, whose rows, positions and steps the trajectory
records (a row found by its source), and the auto-reset's fresh episodes
at the origin at step 0, counted over every row of the bank."""

import torch

from plumebench import counts


def read(ctx, metric):
    if ctx.kernel_time is None or ctx.bank is None:
        return None
    launches, seconds = ctx.kernel_time(metric.kernels)
    if not launches or not seconds:
        return None
    bank = ctx.bank
    shape = tuple(bank["conc"].shape)
    spf, ze = bank["steps_per_frame"], bank["z_extent"]
    n = ctx.spec.num_envs
    dev = bank["conc"].device
    fresh = counts.bank_sample_bytes(
        shape, spf, ze, torch.arange(n, device=dev) % shape[0],
        torch.zeros(n, 3, device=dev), torch.zeros(n, dtype=torch.int32,
                                                   device=dev))
    nbytes = 0
    for traj in ctx.trajs:
        ep = traj.episode
        for t in range(traj.pos.shape[0]):
            src = torch.stack([ep.source_x[t], ep.source_y[t]], -1)
            rows = torch.cdist(src, bank["source"]).argmin(-1)
            nbytes += counts.bank_sample_bytes(shape, spf, ze, rows,
                                               traj.pos[t], ep.steps[t])
            nbytes += fresh
    return 100.0 * counts.least_seconds(nbytes) / seconds
