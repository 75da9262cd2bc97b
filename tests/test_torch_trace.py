"""The port's span recorder (``tpu_plume_torch/obsv/trace.py``) on the CPU:
what one train step records, the drain's span, the ring's bound,
``time_phases``' numbers, the device markers through a stand-in event
class, the ranges under ``torch.profiler``, the spans in ``train_log.csv``
(``train_ppo`` and ``train_ppo_gail``), the benchmark's six span
readers on synthetic records and on a rehearsed traced run, and the
recurrent update's ``bptt`` spans, ranges and readers."""

from __future__ import annotations

import collections
import csv
import dataclasses
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from tpu_plume_torch.core.config import (
    CurriculumConfig,
    EnvConfig,
    PPOConfig,
    RolloutConfig,
    TrainConfig,
)
from tpu_plume_torch.models import recurrent
from tpu_plume_torch.obsv import trace
from tpu_plume_torch.rl.ppo import RecurrentPPOBatch, ppo_update_recurrent
from tpu_plume_torch.rollout.rollout import draw_chunk
from tpu_plume_torch.train import gail_trainer
from tpu_plume_torch.train import ppo_trainer as ttrain
from tpu_plume_torch.train.hostsync import drain_window, drain_window_rows

N, T = 16, 8
LEAVES = ("rollout.policy", "rollout.env_step", "update.grads",
          "update.optimizer", "gae", "read")
READERS = ("rollout_host_ms", "rollout_device_ms", "update_host_ms",
           "update_device_ms", "drain_ms", "init_loop_s")
BPTT_READERS = ("bptt_host_ms", "bptt_device_ms")
LSTM_CELL = "ppo_v2_0_lstm.train.n16384"


def _cfg() -> TrainConfig:
    return TrainConfig(
        name="ppo_v2_0",
        env=EnvConfig(max_steps=40, plume_sigma=500 / 16),
        ppo=PPOConfig(minibatch_size=32, epochs=1, hidden_sizes=(32, 16)),
        curriculum=CurriculumConfig(window_size=16),
        rollout=RolloutConfig(num_envs=N, unroll_length=T),
        total_episodes=100_000,
    )


@pytest.fixture(autouse=True)
def fresh(monkeypatch):
    """An empty recorder for each test."""
    monkeypatch.setattr(trace, "_ring", collections.deque(maxlen=trace.RING))
    monkeypatch.setattr(trace, "_pending", [])
    monkeypatch.setattr(trace, "_free", {})
    monkeypatch.setattr(trace, "_init", [])


class FakeEvent:
    """A stand-in for ``torch.cuda.Event``: each record and each resolve
    logged with the host's clock."""

    log: list = []

    def __init__(self, enable_timing=False):
        self.t = None

    def record(self):
        self.t = time.perf_counter_ns()
        FakeEvent.log.append(("record", self.t))

    def query(self):
        return True

    def elapsed_time(self, end):
        FakeEvent.log.append(("resolve", time.perf_counter_ns()))
        return (end.t - self.t) * 1e-6


@pytest.fixture
def fake_card(monkeypatch):
    """Spans on the CPU take markers from ``FakeEvent``; the synchronises
    of ``time_phases`` are counted."""
    FakeEvent.log = []
    syncs = []
    monkeypatch.setattr(trace, "Event", FakeEvent)
    monkeypatch.setattr(trace, "on_card", lambda device: True)
    monkeypatch.setattr(trace, "capturing", lambda: False)
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda device=None: syncs.append(device))
    return syncs


def _loop_and_step(time_phases=False):
    cfg = _cfg()
    return (cfg, ttrain.init_loop(cfg, "cpu"),
            ttrain.build_train_step(cfg, time_phases=time_phases))


def test_one_step_records_one_iteration_with_its_phases_and_flags():
    cfg, loop, step = _loop_and_step()
    assert trace.last_init() is not None
    assert trace.last_init().end_ns >= trace.last_init().start_ns
    loop, _, _ = step(loop)
    (rec,) = trace.records()
    assert [s.name for s in rec.phases] == ["rollout", "gae", "update",
                                            "read"]
    assert (rec.drawn, rec.synced, rec.profiled) == (False, False, False)
    assert rec.span.name == "iteration" and rec.span.parent is None
    at = rec.span.start_ns
    for s in rec.phases:
        assert s.parent == "iteration" and s.ordinal == rec.ordinal
        assert at <= s.start_ns <= s.end_ns
        assert s.device_ms is None and s.markers is None      # the CPU
        at = s.end_ns
    assert at <= rec.span.end_ns
    draws = draw_chunk(loop.generator, cfg.env, T, N)
    loop, _, _ = step(loop, draws=draws)
    _, _, synced = _loop_and_step(time_phases=True)
    synced(loop)
    flags = [(r.drawn, r.synced, r.profiled) for r in trace.records()]
    assert flags == [(False, False, False), (True, False, False),
                     (False, True, False)]
    assert [r.ordinal for r in trace.records()] == list(
        range(rec.ordinal, rec.ordinal + 3))


def test_a_drain_attaches_to_the_iteration_before_it():
    cfg, loop, step = _loop_and_step()
    loop, stats, traj = step(loop)
    loop, stats2, traj2 = step(loop)
    first, last = trace.records()
    drain_window([stats, stats2])
    drain_window_rows(
        [(st, {"done": tr.done, "steps": tr.episode.steps})
         for st, tr in ((stats, traj), (stats2, traj2))], ("done", "steps"),
        64)
    assert first.drains == []
    assert [d.name for d in last.drains] == ["drain", "drain"]
    for d in last.drains:
        assert d.ordinal == last.ordinal and d.parent == "iteration"
        assert last.span.end_ns <= d.start_ns <= d.end_ns


def test_the_ring_keeps_4096_iterations():
    first = trace.count() + 1
    for _ in range(trace.RING + 5):
        trace.begin("cpu").end()
    recs = trace.records()
    assert len(recs) == trace.RING == 4096
    assert recs[0].ordinal == first + 5
    assert recs[-1].ordinal == trace.count()


def test_time_phases_are_the_spans_host_ms():
    _, loop, step = _loop_and_step(time_phases=True)
    _, stats, _ = step(loop)
    rec = trace.latest()
    assert rec.synced
    for name in ("rollout", "gae", "update"):
        assert stats[f"time/{name}_ms"] == rec.get(name).host_ms > 0


def test_markers_sit_at_the_phase_boundaries_and_resolve_after_read(
        fake_card):
    _, loop, step = _loop_and_step()
    loop, _, _ = step(loop)
    assert fake_card == []                  # no synchronise of its own
    rec = trace.latest()
    records = [t for kind, t in FakeEvent.log if kind == "record"]
    resolves = [t for kind, t in FakeEvent.log if kind == "resolve"]
    assert len(records) == 6 and len(resolves) == 3
    for k, name in enumerate(("rollout", "gae", "update")):
        span = rec.get(name)
        start, end = records[2 * k], records[2 * k + 1]
        assert span.start_ns <= start <= end <= span.end_ns
        assert span.device_ms == pytest.approx((end - start) * 1e-6)
        assert span.device_ms >= 0 and span.markers is None
    assert min(resolves) >= rec.get("read").end_ns
    assert trace._pending == []
    # the events return to the pool and are used again
    loop, _, _ = step(loop)
    assert len(FakeEvent.log) == 18 and len(trace._free["cpu"]) == 6
    # under time_phases each span synchronises at both ends
    _, _, synced = _loop_and_step(time_phases=True)
    synced(loop)
    assert len(fake_card) == 8


def test_no_marker_while_the_stream_captures(fake_card, monkeypatch):
    monkeypatch.setattr(trace, "capturing", lambda: True)
    _, loop, step = _loop_and_step()
    step(loop)
    assert FakeEvent.log == []
    assert all(s.device_ms is None for s in trace.latest().phases)


def _names(prof) -> set:
    return {e.name for e in prof.events()}


def test_leaf_ranges_under_the_profiler_and_bit_equal_steps():
    from torch.profiler import ProfilerActivity, profile

    _, plain, step = _loop_and_step()
    _, traced, _ = _loop_and_step()
    plain_stats, traced_stats = [], []
    for _ in range(2):
        plain, stats, _ = step(plain)
        plain_stats.append(stats)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        cfg = _cfg()
        ttrain.init_loop(cfg, "cpu")
        for _ in range(2):
            traced, stats, _ = step(traced)
            traced_stats.append(stats)
        drain_window([stats])
    names = _names(prof)
    for name in LEAVES + ("drain", "init_loop"):
        assert name in names, name
    assert not {"iteration", "rollout", "update"} & names
    assert [r.profiled for r in trace.records()] == [False, False, True,
                                                     True]
    for a, b in zip(plain.model.parameters(), traced.model.parameters()):
        assert torch.equal(a, b)
    for a, b in zip(plain_stats, traced_stats):
        assert a.keys() == b.keys()
        for k in a:
            assert torch.equal(torch.as_tensor(a[k]), torch.as_tensor(b[k]))
    # the spans sit on the profiler's clock
    rec = trace.latest()
    read = [e for e in prof.events() if e.name == "read"][-1]
    start_ns = prof.profiler.kineto_results.trace_start_ns()
    at = start_ns + read.time_range.start * 1e3
    assert abs(at - (rec.get("read").start_ns + trace.UNIX_OFFSET_NS)) < 5e7


def test_no_range_without_the_profiler(monkeypatch):
    calls = []
    monkeypatch.setattr(trace, "Range", lambda name: calls.append(name))
    _, loop, step = _loop_and_step()
    step(loop)
    assert calls == []


def _log_header(path) -> list:
    with open(path, newline="") as fh:
        return next(csv.reader(fh))


HOST_COLUMNS = ["time/drain_ms", "time/gae_host_ms", "time/read_ms",
                "time/rollout_host_ms", "time/update_host_ms"]


def test_train_log_has_the_host_columns_and_no_device_columns(
        tmp_path, monkeypatch):
    monkeypatch.setattr(ttrain, "LOG_EVERY", 2)
    ttrain.train_ppo(_cfg(), str(tmp_path), device="cpu", verbose=False,
                     max_iterations=4, sync_every=2)
    header = _log_header(tmp_path / "train_log.csv")
    assert [c for c in header if c.startswith("time/")] == HOST_COLUMNS
    with open(tmp_path / "train_log.csv", newline="") as fh:
        rows = list(csv.DictReader(fh))
    assert [int(r["step"]) for r in rows] == [2, 4]
    for r in rows:
        assert all(float(r[c]) > 0 for c in HOST_COLUMNS)


def test_train_gail_logs_the_same_columns(tmp_path, monkeypatch):
    from tpu_plume_torch.data.expert import save_expert_data

    monkeypatch.setattr(ttrain, "LOG_EVERY", 2)
    cfg = _cfg()
    path = str(tmp_path / "expert.npz")
    rng = np.random.default_rng(0)
    save_expert_data(path, rng.random((64, cfg.env.obs_dim)),
                     rng.integers(0, cfg.env.num_actions, 64))
    gail_trainer.train_ppo_gail(cfg, str(tmp_path / "run"), path,
                                max_iterations=2, sync_every=2,
                                verbose=False, device="cpu")
    header = _log_header(tmp_path / "run" / "train_log.csv")
    assert [c for c in header if c.startswith("time/")] == sorted(
        HOST_COLUMNS + ["time/disc_host_ms"])
    rec = trace.latest()
    assert [s.name for s in rec.phases] == ["rollout", "gae", "update",
                                            "disc", "read"]


# --- the benchmark's readers ---------------------------------------------

def _readers() -> dict:
    from plumebench import registry

    return {m.name: m for m in registry.metrics() if m.name in READERS}


def _synthetic(window_iters: int, markers: bool = True) -> list:
    """Records as a traced run leaves them: 3 checked steps (drawn), the
    warm-up, the window, the iteration past it, 3 synced, the profiler's
    warm-up (no flag) and the profiled one.  Iteration k's phases take
    k + (1, 2, 3) host ms, device ms twice that; a drain of 0.5 + k ms
    after every second one."""
    kinds = (["drawn"] * 3 + [None] * (window_iters + 2) + ["synced"] * 3
             + [None, "profiled"])
    recs = []
    for k, kind in enumerate(kinds):
        rec = trace.Iteration(span=trace.Span("iteration", None, k, 0, 1),
                              synced=kind == "synced", drawn=kind == "drawn",
                              profiled=kind == "profiled")
        for j, name in enumerate(("rollout", "gae", "update")):
            ms = k + j + 1
            rec.phases.append(trace.Span(
                name, "iteration", k, 0, int(ms * 1e6),
                device_ms=2.0 * ms if markers else None))
        if k % 2:
            rec.drains.append(trace.Span("drain", "iteration", k, 0,
                                         int((0.5 + k) * 1e6)))
        recs.append(rec)
    return recs


def _install(monkeypatch, recs, init_ms=1500.0):
    monkeypatch.setattr(trace, "_ring", collections.deque(recs,
                                                          maxlen=trace.RING))
    monkeypatch.setattr(trace, "_init", [trace.Span(
        "init_loop", None, None, 0, int(init_ms * 1e6))])


def test_the_readers_on_synthetic_records(monkeypatch):
    readers = _readers()
    assert sorted(readers) == sorted(READERS)
    n = 5
    _install(monkeypatch, _synthetic(n))
    ctx = SimpleNamespace(window_iters=n)
    window = list(range(4, 4 + n))          # 3 drawn, the warm-up
    want = {
        "rollout_host_ms": float(np.median([k + 1 for k in window])),
        "rollout_device_ms": float(np.median([2 * (k + 1) for k in window])),
        "update_host_ms": float(np.median([k + 3 for k in window])),
        "update_device_ms": float(np.median([2 * (k + 3) for k in window])),
        "drain_ms": float(np.median([0.5 + k for k in window if k % 2])),
        "init_loop_s": 1.5,
    }
    for name, m in readers.items():
        assert m.read(ctx, m) == pytest.approx(want[name]), name
    from plumebench.metrics.rollout_host_ms import window as select

    assert [r.ordinal for r in select(ctx)] == window
    for bad in (SimpleNamespace(window_iters=n + 1),
                SimpleNamespace(window_iters=n - 1)):
        for m in readers.values():
            assert m.read(bad, m) is None


def test_the_readers_return_none_without_markers_or_records(monkeypatch):
    readers = _readers()
    ctx = SimpleNamespace(window_iters=4)
    _install(monkeypatch, _synthetic(4, markers=False))
    assert all(m.read(ctx, m) is None for m in readers.values())
    _install(monkeypatch, _synthetic(4)[:6])            # too few
    assert all(m.read(ctx, m) is None for m in readers.values())
    _install(monkeypatch, [])
    assert all(m.read(ctx, m) is None for m in readers.values())


def test_a_rehearsed_traced_run_reads_all_six(fake_card):
    """The harness's own traced run on the CPU at a tiny size, with the
    stand-in markers: the six readers find exactly the window's
    iterations."""
    from plumebench import harness, registry

    seen = {}
    window = harness.window

    def spy(*a, **k):
        seen.update(window(*a, **k))
        return seen

    spec = registry.spec("ppo_v2_0.train.n16384",
                         {"num_envs": 16, "unroll_length": 4})
    try:
        harness.window = spy
        out = harness.run(spec, 2**31 + 11, 1.5, True, "cpu",
                          time.time())
    finally:
        harness.window = window
    metrics = out["result"]["metrics"]
    from plumebench.metrics.rollout_host_ms import window as select

    run = select(SimpleNamespace(window_iters=seen["iters"]))
    assert run is not None and len(run) == seen["iters"] >= 1
    # a drain every sync_every (8) iterations: the window may hold none
    drained = any(r.drains for r in run)
    assert set(metrics) >= set(READERS) - {"drain_ms"}
    assert ("drain_ms" in metrics) == drained
    assert metrics["init_loop_s"]["value"] > 0
    # the iterations and their drains cover the window's wall
    covered = sum(r.span.host_ms + sum(d.host_ms for d in r.drains)
                  for r in run)
    assert 0.9 * seen["span_s"] * 1e3 <= covered <= seen["span_s"] * 1e3


# --- the recurrent update's bptt spans -------------------------------------

def _lstm_cfg(epochs: int = 5) -> TrainConfig:
    """The recurrent policy, ``epochs`` of 8 minibatches of 2 sequences."""
    cfg = _cfg()
    return cfg.replace(ppo=dataclasses.replace(
        cfg.ppo, arch="lstm", lstm_embed=16, lstm_hidden=16, epochs=epochs,
        minibatch_size=N * T // 8))


def _lstm_loop_and_step(epochs: int = 5):
    cfg = _lstm_cfg(epochs)
    return cfg, ttrain.init_loop(cfg, "cpu"), ttrain.build_train_step(cfg)


def test_one_recurrent_iteration_records_40_bptt_spans(fake_card):
    _, loop, step = _lstm_loop_and_step()
    before = recurrent.replayed_steps
    loop, _, _ = step(loop)
    assert recurrent.replayed_steps - before == 40 * T
    rec = trace.latest()
    assert [s.name for s in rec.phases] == ["rollout", "gae", "update",
                                            "read"]
    update = rec.get("update")
    assert len(rec.bptt) == 40
    at = update.start_ns
    for span in rec.bptt:
        assert (span.name, span.parent, span.ordinal) == (
            "bptt", "update", rec.ordinal)
        assert span.steps == T
        assert at <= span.start_ns <= span.end_ns <= update.end_ns
        assert span.device_ms is not None and span.markers is None
        at = span.end_ns
    # the phases' 6 markers and the spans' 80, resolved at the read
    assert len([k for k, _ in FakeEvent.log if k == "record"]) == 86
    assert trace._pending == []
    # the log's columns are the phases' alone
    assert sorted(trace.scalars(rec)) == sorted(
        ["time/read_ms"] + [f"time/{p}_{side}_ms" for p in trace.PHASES
                            for side in ("host", "device")])
    # outside a recorded iteration the update keeps no span
    cfg = _lstm_cfg()
    batch = RecurrentPPOBatch(
        obs=torch.zeros(T, N, cfg.env.obs_dim),
        actions=torch.zeros(T, N, dtype=torch.long),
        old_log_probs=torch.zeros(T, N), advantages=torch.ones(T, N),
        returns=torch.ones(T, N), old_values=torch.zeros(T, N),
        resets=torch.zeros(T, N, dtype=torch.bool),
        h_init=loop.model.initial_state(N))
    ppo_update_recurrent(loop.model, loop.optimizer, batch, cfg.ppo,
                                generator=loop.generator)
    assert len(rec.bptt) == 40
    assert recurrent.replayed_steps - before == 80 * T


def test_recurrent_ranges_under_the_profiler():
    from torch.profiler import ProfilerActivity, profile

    _, lstm, lstm_step = _lstm_loop_and_step(epochs=1)
    _, mlp, mlp_step = _loop_and_step()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        lstm_step(lstm)
    names = _names(prof)
    assert {"update.replay", "update.backward", "update.optimizer"} <= names
    assert not {"update.grads", "bptt", "update"} & names
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        mlp_step(mlp)
    names = _names(prof)
    assert {"update.grads", "update.optimizer"} <= names
    assert not {"update.replay", "update.backward"} & names


def test_recurrent_steps_are_bit_equal_with_the_spans_off(fake_card,
                                                          monkeypatch):
    _, on, step = _lstm_loop_and_step()
    _, off, _ = _lstm_loop_and_step()
    on_stats = []
    for _ in range(2):
        on, stats, _ = step(on)
        on_stats.append(stats)
    assert len(trace.latest().bptt) == 40
    monkeypatch.setattr(trace, "bptt", lambda device: trace._NULL)
    for k in range(2):
        off, stats, _ = step(off)
        assert stats.keys() == on_stats[k].keys()
        for key in stats:
            assert torch.equal(torch.as_tensor(stats[key]),
                               torch.as_tensor(on_stats[k][key])), key
    assert trace.latest().bptt == []
    for a, b in zip(on.model.parameters(), off.model.parameters()):
        assert torch.equal(a, b)


def _with_bptt(recs, spans: int, steps: int, markers: bool = True) -> list:
    """``recs`` with ``spans`` bptt spans of ``steps`` each on every
    record: iteration k's take 0.5 + k host ms, device ms twice that."""
    for rec in recs:
        k = rec.ordinal
        rec.bptt = [trace.Span("bptt", "update", k, 0, int((0.5 + k) * 1e6),
                               device_ms=(1.0 + 2 * k) if markers else None,
                               steps=steps) for _ in range(spans)]
    return recs


def _bptt_readers() -> dict:
    from plumebench import registry

    return {m.name: m for m in registry.metrics() if m.name in BPTT_READERS}


def test_the_bptt_readers_on_synthetic_records(monkeypatch):
    from plumebench import registry

    readers = _bptt_readers()
    assert sorted(readers) == sorted(BPTT_READERS)
    spec = registry.spec(LSTM_CELL)
    n = 5
    ctx = SimpleNamespace(window_iters=n, spec=spec)
    window = list(range(4, 4 + n))
    _install(monkeypatch, _with_bptt(_synthetic(n), 40, 128))
    want = {"bptt_host_ms": float(np.median([40 * (0.5 + k)
                                             for k in window])),
            "bptt_device_ms": float(np.median([40 * (1.0 + 2 * k)
                                               for k in window]))}
    for name, m in readers.items():
        assert m.read(ctx, m) == pytest.approx(want[name]), name
    # the spans without markers: no device ms
    _install(monkeypatch, _with_bptt(_synthetic(n), 40, 128, markers=False))
    assert readers["bptt_host_ms"].read(ctx, None) == pytest.approx(
        want["bptt_host_ms"])
    assert readers["bptt_device_ms"].read(ctx, None) is None
    # no markers at all (a CPU run), a short replay (one span short, or
    # fewer steps a span), no spans (the MLP, a program without them)
    for recs in (_with_bptt(_synthetic(n, markers=False), 40, 128,
                            markers=False),
                 _with_bptt(_synthetic(n), 39, 128),
                 _with_bptt(_synthetic(n), 40, 127),
                 _synthetic(n)):
        _install(monkeypatch, recs)
        for m in readers.values():
            assert m.read(ctx, m) is None, m.name
    # one window iteration short
    recs = _with_bptt(_synthetic(n), 40, 128)
    recs[6].bptt.pop()
    _install(monkeypatch, recs)
    for m in readers.values():
        assert m.read(ctx, m) is None, m.name


def test_a_rehearsed_traced_recurrent_run_reads_the_bptt_spans(fake_card):
    """The harness's traced run of the recurrent cell on the CPU at a tiny
    size, with the stand-in markers: both bptt readers read."""
    from plumebench import harness, registry

    spec = registry.spec(LSTM_CELL, {"num_envs": 16, "unroll_length": 4})
    out = harness.run(spec, 2**31 + 13, 0.5, True, "cpu", time.time())
    metrics = out["result"]["metrics"]
    assert set(metrics) >= set(BPTT_READERS) | {"update_host_ms"}
    assert 0 < metrics["bptt_host_ms"]["value"] < metrics[
        "update_host_ms"]["value"]
    assert out["result"]["correct"] is True
