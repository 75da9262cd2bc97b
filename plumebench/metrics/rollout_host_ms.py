"""The rollout phase's host ms per iteration: the median, over the timed
window's iterations, of the program's ``rollout`` span
(``tpu_plume_torch/obsv/trace.py``), from before the chunk's first launch
to after its last, with no synchronisation.

Also the window the span readers share (``window``): the run of
consecutive iteration records with no flag (``synced``, ``drawn``,
``profiled``) right after the last ``drawn`` one (the checked steps), less
its first (the warm-up) and its last (the iteration past ``seconds``,
not counted); exactly ``ctx.window_iters`` records, each phase of each
with its device duration, or None: a program without the recorder, or a
CPU run, whose host ms are no dispatch times."""

import statistics


def window(ctx):
    try:
        from tpu_plume_torch.obsv import trace
    except ImportError:
        return None
    recs = trace.records()
    drawn = [i for i, r in enumerate(recs) if r.drawn]
    if not drawn:
        return None
    run = []
    for r in recs[drawn[-1] + 1:]:
        if r.synced or r.drawn or r.profiled:
            break
        run.append(r)
    run = run[1:-1]
    if not run or len(run) != ctx.window_iters:
        return None
    for r in run:
        for name in ("rollout", "gae", "update"):
            span = r.get(name)
            if span is None or span.device_ms is None:
                return None
    return run


def phase_ms(ctx, name: str, side: str):
    """The median of the window's ``name`` spans' ``side`` ("host_ms" or
    "device_ms")."""
    run = window(ctx)
    if run is None:
        return None
    return statistics.median(getattr(r.get(name), side) for r in run)


def read(ctx, metric):
    return phase_ms(ctx, "rollout", "host_ms")
