"""The recurrent update's BPTT host ms per iteration: the median, over the
timed window's iterations (``rollout_host_ms.window``), of the sum of each
iteration's ``bptt`` spans (``tpu_plume_torch/obsv/trace.py``), one a
minibatch of ``ppo_update_recurrent``, from before its replay's first
launch to after its backward returns, with no synchronisation.

Also ``bptt_ms``, which ``bptt_device_ms`` shares: None unless every
window iteration's spans replayed epochs x minibatches x T cell steps
(their ``steps``), so a change that cuts the replay short loses the
reading instead of gaining on it; None too for a program without the
``bptt`` span and for a feedforward policy, which records none."""

import statistics

from plumebench.metrics.rollout_host_ms import window


def replayed_steps(spec) -> int:
    """The cell steps one iteration's update replays: each epoch's
    minibatches of ``minibatch_size // T`` whole sequences, T steps each."""
    t = spec.unroll_length
    return spec.epochs * spec.num_envs // (spec.minibatch_size // t) * t


def bptt_ms(ctx, side: str):
    """The median of the window's iterations' summed ``bptt`` ``side``
    ("host_ms" or "device_ms")."""
    run = window(ctx)
    if run is None:
        return None
    want = replayed_steps(ctx.spec)
    sums = []
    for r in run:
        spans = getattr(r, "bptt", None)
        if not spans or sum(s.steps for s in spans) != want:
            return None
        ms = [getattr(s, side) for s in spans]
        if None in ms:
            return None
        sums.append(sum(ms))
    return statistics.median(sums)


def read(ctx, metric):
    return bptt_ms(ctx, "host_ms")
