"""``--debug-nans``: where the first non-finite value of a run appears.

The JAX package turns on ``jax_debug_nans``, which re-runs the op that
produced a NaN.  The port has no such mode; inside ``debug_nans()`` it
turns on autograd's anomaly mode (a backward pass that produces a NaN
raises naming the forward op) and makes ``check_finite`` read each phase's
outputs on the host and raise ``FloatingPointError`` naming the first
phase that is not finite: the training rollout, GAE, the PPO update, the
GAIL discriminator's step, an eval step's logits and observations.  The
call sites sit under ``if debug.enabled():``, so that outside it the path
gains nothing: no host read, no launch, not even the call's arguments.
"""

from __future__ import annotations

import contextlib

import torch

_enabled = False


@contextlib.contextmanager
def debug_nans(enabled: bool = True):
    """Anomaly mode and the phase checks on, for the ``with`` block."""
    global _enabled
    if not enabled:
        yield
        return
    before = _enabled
    _enabled = True
    try:
        with torch.autograd.detect_anomaly():
            yield
    finally:
        _enabled = before


def enabled() -> bool:
    """Whether the phase checks are on (inside ``debug_nans``)."""
    return _enabled


def check_finite(phase: str, **tensors) -> None:
    """Under ``debug_nans``, raise ``FloatingPointError`` naming ``phase``
    and its tensors (keyword arguments; None is skipped) that hold a NaN
    or an infinity."""
    if not _enabled:
        return
    bad = [name for name, x in tensors.items()
           if x is not None and x.is_floating_point()
           and not bool(torch.isfinite(x).all())]
    if bad:
        raise FloatingPointError(
            f"--debug-nans: the first non-finite values are in the {phase} "
            f"phase: {', '.join(bad)}")
