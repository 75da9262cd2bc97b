"""The recurrent update's BPTT device ms per iteration: the median, over
the timed window's iterations, of the sum of each iteration's ``bptt``
spans' device durations (each span's end marker less its start marker,
CUDA events on the stream); None unless every window iteration replayed
epochs x minibatches x T cell steps (``bptt_host_ms.bptt_ms``)."""

from plumebench.metrics.bptt_host_ms import bptt_ms


def read(ctx, metric):
    return bptt_ms(ctx, "device_ms")
