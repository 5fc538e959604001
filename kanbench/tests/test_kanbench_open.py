"""The open loop of the CF-KAN online cell on the CPU: its schedule repeats
from the seed, a user's latency runs from when it was due, the backlog is
served after the window closes, and a user scored twice in a batch fails
``correct``."""
from __future__ import annotations

import time

import numpy as np
import pytest
import torch

from kbtiny import tiny_root
from kanbench import resolve, system
from kanbench import run as bench

SEED = 3_000_000_023


def _window(seed, apply, rate=2000.0, max_batch=8):
    pool = (torch.rand(64, 40, generator=torch.Generator().manual_seed(0))
            > 0.9).float()
    return bench.OpenWindow(None, apply, pool, seed, 5, rate, max_batch,
                            2.0)


def _slow(ms):
    def apply(_, x):
        time.sleep(ms / 1e3)
        return x.clone()
    return apply


def test_schedule_repeats_from_its_seed():
    a, b, c = (_window(s, _slow(0)) for s in (SEED, SEED, SEED + 1))
    assert np.array_equal(a.due, b.due) and not np.array_equal(a.due, c.due)
    gaps = np.diff(a.due)
    assert gaps.min() >= 0 and abs(gaps.mean() * 2000.0 - 1.0) < 0.05


def test_latency_runs_from_the_due_time():
    """A server slower than the arrivals: users wait in the queue, and
    their latency counts the wait; batches fill to ``max_batch``."""
    win = _window(SEED, _slow(8))
    win.open(time.perf_counter())
    j = 0
    while win.next < 100:
        win.step(j, spans=False)
        j += 1
    n = win.next
    assert np.all(win.done[:n] >= win.dequeued[:n])
    assert np.all(win.dequeued[:n] >= 0)
    assert win.dequeued[:n].max() > 0.008       # some waited a batch
    assert np.all(win.done[:n] >= 0.008)        # every batch took 8 ms
    assert max(k for _, k in win.users) == 8
    assert [f for f, _ in win.users] == list(np.cumsum(
        [0] + [k for _, k in win.users][:-1]))


def test_close_serves_the_backlog():
    win = _window(SEED, _slow(8))
    start = time.perf_counter()
    win.open(start)
    j = 0
    while time.perf_counter() - start < 0.1:
        win.step(j, spans=False)
        j += 1
    window_s = time.perf_counter() - start
    users = win.close(window_s, j)
    assert users["due"] == int(np.searchsorted(win.due, window_s, "right"))
    assert users["backlog"] == users["due"] - users["served"] > 0
    assert win.next == users["due"]
    assert np.all(np.isfinite(users["user_ms"]))
    assert users["n_events"] < len(win.events)


def test_rows_wrap_round_the_pool():
    win = _window(SEED, _slow(0))
    assert torch.equal(win.rows(62, 4), torch.cat([win.pool[62:],
                                                   win.pool[:2]]))
    assert torch.equal(win.rows(64 + 3, 2), win.pool[3:5])


def test_result_line(tmp_path):
    root = tiny_root(tmp_path, "online.fused.b32")
    cell = resolve.cell(root, "tiny")
    res = bench.run(cell, SEED, 0.5, False, device="cpu", root=root)
    assert res["correct"] and res["failed"] == 0
    assert list(res) == ["correct", "attempted", "failed", "metrics",
                         "device", "generator", "checks", "_loaded",
                         "_batches"]
    assert set(res["metrics"]) == {"user_p50_ms", "setup_s"}
    gen = res["generator"]
    assert set(gen) == {"user_p50_ms", "user_mean_ms", "user_p95_ms",
                        "dequeue_p95_ms", "backlog", "backlog_slope",
                        "rate", "users_per_s", "users_per_batch"}
    assert gen["user_p50_ms"] == res["metrics"]["user_p50_ms"]["value"]
    assert 0 < gen["user_p50_ms"] <= gen["user_p95_ms"]
    assert gen["user_p95_ms"] >= gen["dequeue_p95_ms"]
    # ~1000 users due in 0.5 s at 2000 a second
    assert 700 < res["attempted"] < 1300
    assert gen["users_per_s"] == pytest.approx(2000, rel=0.3)


def test_backlog_is_read_through_the_window(monkeypatch):
    """Readings every ``BACKLOG_EVERY_S`` of the window only; a server
    slower than the arrivals gives a rising slope, one that keeps up none
    to speak of."""
    monkeypatch.setattr(bench, "BACKLOG_EVERY_S", 0.05)
    slopes = []
    for ms in (8, 0):
        win = _window(SEED, _slow(ms))
        monkeypatch.setattr(win, "next_read", 0.05)
        start = time.perf_counter()
        win.open(start)
        j = 0
        while time.perf_counter() - start < 0.6:
            win.step(j, spans=False)
            j += 1
        users = win.close(time.perf_counter() - start, j)
        t = [r[0] for r in win.backlog]
        assert 8 <= len(t) <= 12 and t == sorted(t) and t[-1] < 0.62
        slopes.append(users["backlog_slope"])
    # 8 users of 8 ms a batch serve 1000 a second of the 2000 due
    assert slopes[0] > 500 and abs(slopes[1]) < 100


def test_a_user_scored_twice_fails(tmp_path, monkeypatch):
    """Each batch of two or more scores its first user in its second's
    place."""
    apply = system.apply

    def twice(deployed, x):
        if x.shape[0] > 1:
            x = torch.cat([x[:1], x[:1], x[2:]])
        return apply(deployed, x)
    monkeypatch.setattr(system, "apply", twice)
    root = tiny_root(tmp_path, "online.fused.b32")
    cell = resolve.cell(root, "tiny")
    res = bench.run(cell, SEED, 0.5, False, device="cpu", root=root,
                    check_every=1)
    assert not res["correct"] and res["failed"] > 0
