"""The host seconds of the program's ``init_loop`` span: the port's loop
built in set-up (model, optimizer, generator, envs), the benchmark's
weights not yet loaded.  None where ``rollout_host_ms.window`` finds no
window with device markers (a program without the recorder, a CPU run)."""

from plumebench.metrics.rollout_host_ms import window


def read(ctx, metric):
    if window(ctx) is None:
        return None
    from tpu_plume_torch.obsv import trace

    span = trace.last_init()
    return None if span is None else span.host_ms * 1e-3
