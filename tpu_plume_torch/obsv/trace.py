"""The port's span recorder: named host intervals at the training loop's
layer boundaries, the device's side of each phase between two CUDA event
markers, kept in a bounded ring that ``train_log.csv`` and the benchmark's
readers read.

A span has a name, a start and an end (``time.perf_counter_ns``; add
``UNIX_OFFSET_NS`` to place it on ``torch.profiler``'s clock, whose traces
count unix nanoseconds) and a parent; one iteration's spans share its
ordinal.

- ``init_loop`` (no parent): ``train.ppo_trainer.init_loop``.
- ``iteration`` (no parent): one train step, entry to return.
- ``rollout``, ``gae``, ``update`` and GAIL's ``disc`` (``iteration``):
  the phases, each with a device marker at its start and at its end, so
  its device duration is the end marker less the start marker.
- ``read`` (``iteration``): the host read of the episode counts.  It waits
  for the stream, so the markers recorded before it are resolved
  (``elapsed_time``) right after it, with no synchronise of their own.
- ``drain`` (``iteration``): a window's transfer to the host
  (``train/hostsync.py``), attached to the newest iteration, the one
  before it.

The recorder never synchronises on its own: ``synced`` iterations (the
train step's ``time_phases``) synchronise at each phase's boundaries, so
their host ms are the phases' wall ms.  A marker not yet done waits for
the next read or drain; none is recorded while the stream captures a CUDA
graph.  The ring keeps the last ``RING`` iterations, each with its phases,
its drains and three flags: ``synced``, ``drawn`` (the step was given its
draws) and ``profiled`` (``torch.profiler`` was recording at entry).

While ``torch.profiler`` records, each leaf span is a profiler range of
its own name (``init_loop``, ``gae``, ``disc``, ``read``,
``drain``), and so are the profiler-only sites of ``leaf``:
``rollout.policy`` and ``rollout.env_step`` in each rollout step,
``update.grads`` and ``update.optimizer`` in each minibatch.  A span with
children (``iteration``, ``rollout``, ``update``) is no range: it would
hide its children's names from a breakdown that names the outermost range.
With the profiler off a ``leaf`` site costs one check of a flag.  A range
is PyTorch's ``RecordFunctionFast`` where it has one: ``record_function``,
a dispatcher op, costs tens of us a range under the profiler, and the
rollout and update open about 340 an iteration.

The recorder is one per process, as the profiler is: the benchmark's
readers, outside the program, find it by importing this module.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import time

import torch
from torch.autograd.profiler import record_function

RING = 4096
# perf_counter_ns + UNIX_OFFSET_NS: the same instant on the unix clock of
# torch.profiler's traces
UNIX_OFFSET_NS = time.time_ns() - time.perf_counter_ns()
PHASES = ("rollout", "gae", "update")

Event = torch.cuda.Event
Range = getattr(torch._C._profiler, "_RecordFunctionFast", record_function)
profiling = torch.autograd._profiler_enabled
_NULL = contextlib.nullcontext()


@dataclasses.dataclass(slots=True)
class Span:
    name: str
    parent: str | None
    ordinal: int | None
    start_ns: int
    end_ns: int = 0
    # end marker less start marker, once resolved
    device_ms: float | None = None
    # (start event, end event, pool key) until resolved
    markers: tuple | None = None

    @property
    def host_ms(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-6


@dataclasses.dataclass(slots=True)
class Iteration:
    """One iteration's record: its span, its phases in order, the drains
    after it, and its flags."""

    span: Span
    synced: bool
    drawn: bool
    profiled: bool
    phases: list = dataclasses.field(default_factory=list)
    drains: list = dataclasses.field(default_factory=list)

    @property
    def ordinal(self) -> int:
        return self.span.ordinal

    def get(self, name: str) -> Span | None:
        return next((s for s in self.phases if s.name == name), None)


_ring: collections.deque = collections.deque(maxlen=RING)
_init: list = []          # the last init_loop span
_pending: list = []       # spans whose markers wait to be resolved
_free: dict = {}          # device -> free events
_count = 0


def on_card(device: torch.device) -> bool:
    """Whether spans on ``device`` take device markers."""
    return device.type == "cuda"


def capturing() -> bool:
    return torch.cuda.is_current_stream_capturing()


def leaf(name: str):
    """A profiler-only site: a range of ``name`` while ``torch.profiler``
    records, else a context that does nothing."""
    return Range(name) if profiling() else _NULL


def records() -> list:
    """The ring's iterations, oldest first."""
    return list(_ring)


def count() -> int:
    """The number of iterations begun in this process."""
    return _count


def latest() -> Iteration | None:
    return _ring[-1] if _ring else None


def last_init() -> Span | None:
    return _init[-1] if _init else None


def _marker(key: str):
    if capturing():
        return None
    free = _free.setdefault(key, [])
    event = free.pop() if free else Event(enable_timing=True)
    event.record()
    return event


def resolve() -> None:
    """The device ms of every span whose end marker is done; a span whose
    iteration has left the ring is dropped unresolved."""
    oldest = _ring[0].ordinal if _ring else 0
    keep = []
    for span in _pending:
        start, end, key = span.markers
        if end.query():
            span.device_ms = start.elapsed_time(end)
        elif span.ordinal >= oldest:
            keep.append(span)
            continue
        span.markers = None
        _free[key].extend((start, end))
    _pending[:] = keep


@contextlib.contextmanager
def init_loop():
    """The ``init_loop`` span around a loop's set-up."""
    span = Span("init_loop", None, None, time.perf_counter_ns())
    try:
        with leaf("init_loop"):
            yield span
    finally:
        span.end_ns = time.perf_counter_ns()
        _init[:] = [span]


@contextlib.contextmanager
def drain():
    """A ``drain`` span, attached to the newest iteration; the markers it
    waited for are resolved after it."""
    rec = latest()
    span = Span("drain", "iteration", rec and rec.ordinal,
                time.perf_counter_ns())
    try:
        with leaf("drain"):
            yield span
    finally:
        span.end_ns = time.perf_counter_ns()
        if rec is not None:
            rec.drains.append(span)
        resolve()


class Recording:
    """One iteration being recorded (``begin``): ``phase`` and ``read``
    spans, then ``end``."""

    __slots__ = ("device", "card", "record")

    def __init__(self, device, synced: bool, drawn: bool):
        global _count
        _count += 1
        self.device = torch.device(device)
        self.card = on_card(self.device)
        self.record = Iteration(
            span=Span("iteration", None, _count, time.perf_counter_ns()),
            synced=synced, drawn=drawn, profiled=profiling())
        _ring.append(self.record)

    def _sync(self) -> None:
        if self.record.synced and self.card:
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def phase(self, name: str, *, markers: bool = True, ranged: bool = True):
        """A child span of the iteration; with ``markers`` (on the card) a
        device marker at each end; with ``ranged`` a profiler range."""
        self._sync()
        span = Span(name, "iteration", self.record.ordinal,
                    time.perf_counter_ns())
        key = str(self.device)
        start = _marker(key) if markers and self.card else None
        try:
            with leaf(name) if ranged else _NULL:
                yield span
        finally:
            end = _marker(key) if start is not None else None
            self._sync()
            span.end_ns = time.perf_counter_ns()
            if end is not None:
                span.markers = (start, end, key)
                _pending.append(span)
            self.record.phases.append(span)

    @contextlib.contextmanager
    def read(self):
        """The ``read`` span: a host read that waits for the stream; the
        markers before it are resolved after it."""
        with self.phase("read", markers=False):
            yield
        resolve()

    def end(self) -> None:
        self.record.span.end_ns = time.perf_counter_ns()


def begin(device, *, synced: bool = False, drawn: bool = False) -> Recording:
    """Start recording one iteration on ``device`` (its ``iteration`` span
    starts now); ``synced`` makes its phases synchronise at their
    boundaries."""
    return Recording(device, synced, drawn)


def scalars(rec: Iteration, window_last: Iteration | None = None) -> dict:
    """The log's timing columns of ``rec``: each phase's
    ``time/<phase>_host_ms`` (and ``_device_ms`` where resolved),
    ``time/read_ms``, and ``time/drain_ms``, the host ms of the drains that
    brought the window ending at ``window_last`` to the host."""
    out = {}
    for span in rec.phases:
        if span.name == "read":
            out["time/read_ms"] = span.host_ms
            continue
        out[f"time/{span.name}_host_ms"] = span.host_ms
        if span.device_ms is not None:
            out[f"time/{span.name}_device_ms"] = span.device_ms
    if window_last is not None:
        out["time/drain_ms"] = sum(s.host_ms for s in window_last.drains)
    return out
