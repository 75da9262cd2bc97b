"""Device operations per env step of the rollout: one profiled
``rollout_chunk`` of the loop's carry (its own draws included), counted
and divided by its T steps."""


def read(ctx, metric):
    launches = getattr(ctx, "rollout_launches", None)
    if not launches:
        return None
    return launches / ctx.spec.unroll_length
