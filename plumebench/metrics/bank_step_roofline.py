"""The env step over a 3-D bank, one kernel a step, as a share of its
roofline: the least time of the profiled iteration's steps over the device
time of the kernels the metric's files name.  A step's least bytes:
``counts.env_step_bytes`` of N envs and the step's finished envs; each
env's bank row read, and a finished env's written with its fresh row's
source read; and the bank cells that the two samples' corners touch, each
read once: at the moved agents (rows found by their sources, as
``bank_sample_roofline`` finds them) and at the origin at step 0 for the
finished envs' fresh rows, counted as the first rows of the bank.  A
sample's queries and results stay in the kernel's registers, so
``counts.bank_sample_bytes``' per-query bytes are left out."""

import torch

from plumebench import counts, inputs

# counts.bank_sample_bytes' reads and writes of one query: pos, row, t,
# seed, conc, tke.
QUERY_BYTES = 4 * 3 + 4 * 5


def read(ctx, metric):
    if ctx.kernel_time is None or ctx.bank is None:
        return None
    launches, seconds = ctx.kernel_time(metric.kernels)
    if not launches or not seconds:
        return None
    bank = ctx.bank
    shape = tuple(bank["conc"].shape)
    spf, ze = bank["steps_per_frame"], bank["z_extent"]
    dev = bank["conc"].device
    env = ctx.spec.env
    n = ctx.spec.num_envs
    nbytes = 0
    for traj in ctx.trajs:
        ep = traj.episode
        for t, d in enumerate(traj.done.sum(1).tolist()):
            src = torch.stack([ep.source_x[t], ep.source_y[t]], -1)
            rows = torch.cdist(src, bank["source"]).argmin(-1)
            nbytes += counts.env_step_bytes(
                inputs.num_actions(env), inputs.pos_dim(env),
                ctx.cfg.env.obs_dim, env["grid_divisions"], n, d)
            nbytes += 4 * n + (4 + 8) * d
            nbytes += counts.bank_sample_bytes(
                shape, spf, ze, rows, traj.pos[t], ep.steps[t])
            nbytes -= n * QUERY_BYTES
            if d:
                fresh = torch.arange(d, device=dev) % shape[0]
                nbytes += counts.bank_sample_bytes(
                    shape, spf, ze, fresh, torch.zeros(d, 3, device=dev),
                    torch.zeros(d, dtype=torch.int32, device=dev))
                nbytes -= d * QUERY_BYTES
    return 100.0 * counts.least_seconds(nbytes) / seconds
