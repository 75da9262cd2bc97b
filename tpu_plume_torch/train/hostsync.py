"""Windowed device-to-host sync of the training loops (port of
``tpu_plume/train/hostsync.py``).

A training loop keeps each iteration's stats and episode records on the
device while the device runs ahead, and brings a whole window of them to
the host at once: every tensor of the window is packed into one flat f32
tensor on the device and moved in one transfer, then split and cast back
on the host.  f32 is exact for the payloads here: bools, and int32 step
counts below 2^24.

``drain_window_rows`` also compacts the window's episode records on the
device: only the rows where ``done`` is set, in the flat (iteration, t, n)
order, up to a fixed ``cap``, ride the same transfer as the stats, so a
window moves a few hundred rows instead of its [T, N] masks.  The
compaction reads nothing on the host before the transfer: each done row's
slot is the running count of done rows before it (a ``cumsum``), and the
rows are scattered there.

The trees are ``core.tree``'s; a leaf that is not a tensor (a host
number, or None) comes back as it was.

Each drain is a ``drain`` span (``obsv.trace``), attached to the newest
iteration recorded, the one before it.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_plume_torch.core.tree import flatten
from tpu_plume_torch.obsv import trace


def _host_dtype(dtype: torch.dtype) -> np.dtype:
    """The numpy dtype a leaf of ``dtype`` comes back as (bf16, which numpy
    lacks, as f32)."""
    if dtype == torch.bfloat16:
        return np.dtype(np.float32)
    return torch.empty(0, dtype=dtype).numpy().dtype


def _pack(leaves: list) -> torch.Tensor:
    if not leaves:
        return torch.zeros(0)
    return torch.cat([x.reshape(-1).to(torch.float32) for x in leaves])


def _unpack(buf: np.ndarray, leaves: list, at: int = 0):
    """The host arrays of ``leaves`` from ``buf`` starting at ``at``, and
    the offset after them."""
    out = []
    for x in leaves:
        n = x.numel()
        out.append(buf[at:at + n].reshape(tuple(x.shape)).astype(
            _host_dtype(x.dtype), copy=False))
        at += n
    return out, at


def drain_window(entries: list) -> list:
    """A window of trees of device tensors on the host in one packed
    transfer: each tree with numpy arrays of the original shapes and
    dtypes in place of its tensors."""
    with trace.drain():
        leaves, rebuild = flatten(list(entries))
        host, _ = _unpack(_pack(leaves).cpu().numpy(), leaves)
        return rebuild(iter(host))


def _compact_rows(dones: list, fields: list, cap: int):
    """(count, rows f32[F * cap]) of the window on the device: the true
    number of done rows and the first ``cap`` of them of each field (0
    past the count), with no host read."""
    done = torch.cat([d.reshape(-1) for d in dones]).to(torch.bool)
    count = done.sum()
    slot = torch.cumsum(done.to(torch.int64), 0) - 1
    # rows past the cap (and rows not done) go to a spill slot, dropped
    slot = torch.where(done & (slot < cap), slot, cap)
    index = torch.zeros(cap + 1, dtype=torch.int64, device=done.device)
    index.scatter_(0, slot, torch.arange(done.numel(), device=done.device))
    mat = torch.stack([torch.cat([f.reshape(-1).to(torch.float32)
                                  for f in fs]) for fs in fields])
    return count, mat[:, index[:cap]].reshape(-1)


def drain_window_rows(entries: list, rec_keys: tuple, cap: int
                      ) -> tuple[list, dict, int]:
    """Drain a window of ``(stats, record)`` pairs, the records compacted
    on the device: one transfer moves every stats tree and the at most
    ``cap`` record rows where ``done`` is set, in the flat (iteration, t,
    n) order of draining each [T, N] record in turn.

    Returns ``(host_stats, rows, count)``: ``rows`` maps each key of
    ``rec_keys`` but ``done`` to an f32[cap] array whose first ``min(count,
    cap)`` entries are valid, and ``count`` is the true number of done
    rows in the window.  Where it exceeds ``cap`` the caller drains the
    records again (a larger cap, or ``drain_window``) to keep every row."""
    with trace.drain():
        leaves, rebuild = flatten([stats for stats, _ in entries])
        recs = [rec for _, rec in entries]
        field_keys = [k for k in rec_keys if k != "done"]
        count, rows = _compact_rows([r["done"] for r in recs],
                                    [[r[k] for r in recs] for k in field_keys],
                                    cap)
        buf = torch.cat([_pack(leaves).to(count.device),
                         count.to(torch.float32)[None], rows]).cpu().numpy()
        host, at = _unpack(buf, leaves)
        host_stats = rebuild(iter(host))
        n_rows = int(buf[at])
        at += 1
        rows_host = {}
        for k in field_keys:
            rows_host[k] = buf[at:at + cap]
            at += cap
        return host_stats, rows_host, n_rows
