"""The comparison that decides ``correct``: the program's first training
steps against the reference's, from the same inputs.

The numbers a cell may compare; its workload file names those it does and
the limit of each:

- ``first_loss_gap``: the relative gap between the program's loss of the
  first step (averaged over its minibatch steps) and the reference's;
- ``grad_gap``: the worst leaf's gap between the norms of Adam's first
  moment after its first update (the first clipped gradient as the
  optimizer got it, times 1 - b1), over the reference's norm of that leaf
  or of the median leaf, whichever is larger;
- ``change_gap``: the same of the parameters' change over the checked
  steps, over the leaves whose reference first gradient is at least a
  thousandth of the median leaf's (a leaf below that moves under Adam by
  round-off alone).

``details`` also gives the later steps' loss gaps and the first step's
moment by leaf, which ``control`` reports: the readings that showed those
numbers to swing from seed to seed (a near-tie of the Gumbel-max action
flips once the parameters differ by round-off, and the env it flips
diverges).

A number that is not finite fails its limit.
"""

from __future__ import annotations

import math
import statistics

# A leaf whose reference first gradient is below this share of the median
# leaf's is left out of the change.
QUIET_LEAF = 1e-3

NAMES = ("first_loss_gap", "grad_gap", "change_gap")


def _norms(tree: dict) -> dict:
    return {k: float(v.double().norm()) for k, v in tree.items()}


def leaf_gaps(got: dict, want: dict, leaves=None) -> dict:
    """{leaf: |norm(got) - norm(want)| / max(norm(want), median leaf norm
    of ``want``)}; a leaf missing from ``got`` has norm 0."""
    want_n = _norms(want)
    got_n = _norms({k: v for k, v in got.items() if k in want})
    median = statistics.median(want_n.values())
    return {k: abs(got_n.get(k, 0.0) - want_n[k]) / max(want_n[k], median)
            for k in (leaves if leaves is not None else want_n)}


def details(got: dict, want: dict) -> dict:
    """Every reading the numbers are taken from: the gap of each step's
    loss, and each leaf's gap of the first update's moment, of the first
    step's moment and of the change (``leaf_gaps``)."""
    loss = [abs(a - b) / abs(b) for a, b in zip(got["losses"], want["losses"])]
    if len(got["losses"]) != len(want["losses"]):
        loss.append(math.inf)
    moment_n = _norms(want["first_grad"])
    median = statistics.median(moment_n.values())
    moving = [k for k, v in moment_n.items() if v >= QUIET_LEAF * median]
    return {"loss": loss,
            "first_grad": leaf_gaps(got["first_grad"], want["first_grad"]),
            "first_moment": leaf_gaps(got["first_moment"] or {},
                                      want["first_moment"]),
            "change": leaf_gaps(got["change"], want["change"], moving)}


def readings(got: dict, want: dict) -> dict:
    """The numbers a cell may compare, of the program's outputs ``got``
    against the reference's ``want``."""
    d = details(got, want)
    worst = lambda xs: max(xs, key=lambda x: x if math.isfinite(x) else math.inf)
    return {"first_loss_gap": d["loss"][0],
            "grad_gap": worst(d["first_grad"].values()),
            "change_gap": worst(d["change"].values())}


def verdict(values: dict, limits: dict):
    """(correct, {name: {"value", "limit"}}) of the readings that
    ``limits`` names against their limits; a reading that is not finite,
    or above its limit, fails."""
    if not limits or set(limits) - set(NAMES):
        raise ValueError(f"limits must name some of {NAMES}, got "
                         f"{sorted(limits)}")
    checks = {name: {"value": values[name], "limit": limits[name]}
              for name in NAMES if name in limits}
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
             for c in checks.values())
    return ok, checks
