"""The whole training step's share of the card's f32 peak: the policy's
matmul FLOPs per iteration (``counts.train_flops`` of the reference
policy's ``macs_per_row``: the rollout's and bootstrap's forward rows, and
the update's epochs x N x T rows at three forward costs) over the traced
run's unprofiled window, against 67 TFLOP/s (f32 outside the tensor cores;
TF32 is off)."""

from plumebench import counts, registry


def read(ctx, metric):
    if not ctx.window_iters or not ctx.window_s:
        return None
    s = ctx.spec
    flops = counts.train_flops(registry.reference_policy(s).macs_per_row(s),
                               s.num_envs, s.unroll_length, s.epochs)
    return 100.0 * flops * ctx.window_iters / ctx.window_s / counts.F32_OPS_PER_S
