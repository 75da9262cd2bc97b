"""``tpu_plume_torch.train.hostsync`` against JAX's ``train/hostsync.py``:
JAX's four scenarios of ``tests/test_hostsync.py`` with their asserts, and
one window drained by both packages, compared row by row (f32 packing is
exact for these payloads, so the rows are equal)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_plume.train.hostsync import drain_window as j_drain_window
from tpu_plume.train.hostsync import drain_window_rows as j_drain_window_rows
from tpu_plume_torch.train.hostsync import drain_window, drain_window_rows

KEYS = ("done", "steps", "total_reward")


def test_drain_window_roundtrip():
    entries = []
    for i in range(5):
        entries.append({
            "stats": {"loss": torch.tensor(0.5 + i),
                      "count": torch.tensor(900 + i, dtype=torch.int32)},
            "rec": (torch.arange(6, dtype=torch.int32).reshape(2, 3) + i,
                    (torch.arange(4) % 2 == 0).reshape(2, 2),
                    torch.linspace(0.0, 1.0, 3) * (i + 1)),
        })
    host = drain_window(entries)
    assert len(host) == 5
    for i, h in enumerate(host):
        assert isinstance(h["stats"]["loss"], np.ndarray)
        assert h["stats"]["count"].dtype == np.int32
        assert int(h["stats"]["count"]) == 900 + i
        a, b, c = h["rec"]
        assert a.dtype == np.int32 and a.shape == (2, 3)
        np.testing.assert_array_equal(a, np.arange(6).reshape(2, 3) + i)
        assert b.dtype == bool
        np.testing.assert_array_equal(b, (np.arange(4) % 2 == 0).reshape(2, 2))
        np.testing.assert_allclose(c, np.linspace(0, 1, 3) * (i + 1),
                                   rtol=1e-6)


def test_drain_window_with_none_leaves():
    entries = [(torch.tensor(float(i)), None) for i in range(3)]
    host = drain_window(entries)
    assert [h[1] for h in host] == [None, None, None]
    assert [float(h[0]) for h in host] == [0.0, 1.0, 2.0]


def _window(seed=0, t=4, n=6, w=3, p=0.3):
    rng = np.random.default_rng(seed)
    return [({"loss": np.float32(i)},
             {"done": rng.random((t, n)) < p,
              "steps": rng.integers(1, 500, (t, n)).astype(np.int32),
              "total_reward": rng.normal(size=(t, n)).astype(np.float32)})
            for i in range(w)]


def _port(window):
    return [({k: torch.from_numpy(np.asarray(v)) for k, v in st.items()},
             {k: torch.from_numpy(v) for k, v in rec.items()})
            for st, rec in window]


def test_drain_window_rows_matches_full_drain():
    """The compaction yields exactly the rows, in the flat (iter, t, n)
    order, of the full-mask drain."""
    entries = _port(_window())
    cap = 64
    host_stats, rows, count = drain_window_rows(entries, KEYS, cap)
    assert [float(s["loss"]) for s in host_stats] == [0.0, 1.0, 2.0]

    exp_steps, exp_rew = [], []
    for _, rec in entries:
        mask = rec["done"].numpy().reshape(-1)
        exp_steps.append(rec["steps"].numpy().reshape(-1)[mask])
        exp_rew.append(rec["total_reward"].numpy().reshape(-1)[mask])
    exp_steps = np.concatenate(exp_steps)
    exp_rew = np.concatenate(exp_rew)

    assert count == len(exp_steps) <= cap
    np.testing.assert_array_equal(rows["steps"][:count].astype(np.int32),
                                  exp_steps)
    np.testing.assert_allclose(rows["total_reward"][:count], exp_rew,
                               rtol=1e-6)


def test_drain_window_rows_overflow_reports_true_count():
    t, n = 4, 8
    rec = {"done": torch.ones((t, n), dtype=torch.bool),
           "steps": torch.arange(t * n, dtype=torch.int32).reshape(t, n),
           "total_reward": torch.zeros((t, n))}
    _, rows, count = drain_window_rows([({"loss": torch.tensor(0.0)}, rec)],
                                       KEYS, 8)
    assert count == t * n  # the true count: the caller must drain again
    np.testing.assert_array_equal(rows["steps"].astype(np.int32),
                                  np.arange(8))


@pytest.mark.parametrize("cap", [4, 64, 256])
def test_window_drained_by_both_packages_row_by_row(cap):
    """The same window through JAX's and the port's drains: the stats, the
    true count and every compacted row equal (past the count both fill
    with the window's first row), at a cap below, near and above the
    count."""
    window = _window(seed=3, t=8, n=16, w=4, p=0.2)
    jstats, jrows, jcount = j_drain_window_rows(
        [({k: jnp.asarray(v) for k, v in st.items()},
          {k: jnp.asarray(v) for k, v in rec.items()})
         for st, rec in window], KEYS, cap)
    tstats, trows, tcount = drain_window_rows(_port(window), KEYS, cap)
    assert tcount == jcount > 0
    assert [float(s["loss"]) for s in tstats] == [float(s["loss"])
                                                  for s in jstats]
    for k in KEYS[1:]:
        assert trows[k].shape == jrows[k].shape == (cap,)
        np.testing.assert_array_equal(trows[k], jrows[k], err_msg=k)
    jfull = j_drain_window([rec for _, rec in window])
    tfull = drain_window([rec for _, rec in _port(window)])
    for j, t in zip(jfull, tfull, strict=True):
        for k in KEYS:
            assert t[k].dtype == j[k].dtype, k
            np.testing.assert_array_equal(t[k], j[k], err_msg=k)
