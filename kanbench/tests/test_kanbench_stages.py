"""The readers of the program's stage spans and counters (``basis_ms``,
``wl_dac_ms``, ``phys_gather_ms``, ``mac_ms``, ``base_branch_ms``,
``crossbar_live_share``) and of the idle inside its ``kan.apply``
(``kan_apply_idle_ms``), on a hand-built trace and stubbed stage records:
the last ``n`` calls for the ``n`` ``kan.apply`` ranges of the window, an
older run's records left out, ``None`` where nothing was recorded. On the
card (``cuda``): in a traced run of each cell the leaf stages account for
the apply, ``mac_ms`` covers the cell's kernel, and the live share lies in
(0, 100]."""
from __future__ import annotations

import json
import re

import pytest
import torch

from kbtiny import REPO
from kanbench import resolve
from kanbench import run as bench
from kanbench import trace as ktrace
from repro_torch.obs import trace as program

STAGES = {"basis_ms": "kan.basis", "wl_dac_ms": "xbar.wl_dac",
          "phys_gather_ms": "xbar.gather", "mac_ms": "kan.mac",
          "base_branch_ms": "kan.base"}
LEAVES = list(STAGES)
KERNELS = {"fused": r"kan_fused", "cim": r"mac_kernel|cim_mac_sum_parts",
           "cim_tiled": r"mac_kernel"}
CELLS = [w["name"] for w in json.loads(
    (REPO / "BENCHMARK.json").read_text())["workloads"]]


class _Ev:
    """A stand-in for a CUDA event: a time in ms."""

    def __init__(self, t):
        self.t = t

    def elapsed_time(self, end):
        return end.t - self.t


def _call(ms, device_counts=None):
    """A stage call whose stage ``name`` took ``ms[name]`` ms, in two
    entries of half each, one in each of two passes over the stages (the
    entries of a stage sum)."""
    call = program.StageCall(torch.device("cpu"))
    t = 0.0
    for _ in range(2):
        for name, v in ms.items():
            call.marks.append((name, _Ev(t)))
            t += v / 2
    if call.marks:
        call.marks.append((None, _Ev(t)))
    for name, v in (device_counts or {}).items():
        call.device_counts[name] = [torch.tensor([v])]
    return call


@pytest.fixture
def ring(monkeypatch):
    rec = program.StageRecorder(capacity=16)
    monkeypatch.setattr(program, "STAGES", rec)
    return rec


def _trace(n_applies, ops=(), window=(0.0, 100.0)):
    host = [(10.0 * j, 10.0 * j + 8.0, "kan.apply")
            for j in range(n_applies)]
    host += [(0.0, 100.0, "kanbench.batch"), (1.0, 2.0, "aten::mm")]
    return ktrace.Trace(list(ops), window, {}, host)


def _ctx(trc, counts=()):
    return bench.Context(trc, list(counts), {}, {}, 0)


def _read(name, ctx):
    return resolve.reader(REPO, name)(ctx)


@pytest.mark.parametrize("metric", LEAVES)
def test_stage_readers_take_the_last_calls(ring, metric):
    stage = STAGES[metric]
    for _ in range(3):                         # an older run, say a control
        ring.add(_call({stage: 100.0, "kan.apply": 500.0}))
    ring.add(_call({stage: 2.0, "kan.apply": 9.0}))
    ring.add(_call({stage: 4.0, "kan.apply": 9.0}))
    assert _read(metric, _ctx(_trace(2))) == pytest.approx(3.0)
    assert _read(metric, _ctx(_trace(1))) == pytest.approx(4.0)


@pytest.mark.parametrize("metric", LEAVES + ["crossbar_live_share"])
def test_readers_return_none_where_nothing_was_recorded(ring, metric):
    counts = [[{"live_pairs": 10}]]
    assert _read(metric, _ctx(_trace(2), counts)) is None   # empty ring
    ring.add(_call({"kan.apply": 1.0, "kan.mac": 1.0, "kan.basis": 1.0,
                    "kan.base": 1.0, "xbar.wl_dac": 1.0,
                    "xbar.gather": 1.0},
                   {"xbar.rows_iterated": 20}))
    assert _read(metric, _ctx(_trace(0), counts)) is None   # no kan.apply
    ring.add(_call({}))                                     # the CPU's
    assert _read(metric, _ctx(_trace(1), counts)) is None


def test_a_backend_without_the_stage_reads_none(ring):
    """A ``fused`` call has no word-line DAC, gather or crossbar count."""
    ring.add(_call({"kan.apply": 5.0, "kan.basis": 0.5, "kan.mac": 4.0,
                    "kan.base": 0.4}))
    ctx = _ctx(_trace(1), [[{"nonzero_taps": 10}]])
    for metric in ("wl_dac_ms", "phys_gather_ms", "crossbar_live_share"):
        assert _read(metric, ctx) is None
    assert _read("mac_ms", ctx) == pytest.approx(4.0)


def test_live_share_is_live_pairs_over_iterated(ring):
    ring.add(_call({"kan.apply": 1.0}, {"xbar.rows_iterated": 999}))
    for it in (100, 300):
        ring.add(_call({"kan.apply": 1.0}, {"xbar.rows_iterated": it}))
    counts = [[{"live_pairs": 60, "batch": 4}, {"live_pairs": 20}],
              [{"live_pairs": 70}, {"live_pairs": 10}]]
    # 80 live pairs a batch over 200 iterated a batch
    assert _read("crossbar_live_share", _ctx(_trace(2), counts)) == \
        pytest.approx(40.0)
    assert _read("crossbar_live_share", _ctx(_trace(2), [[{"in": 3}]])) \
        is None


def _op(start, end):
    return ktrace.DeviceOp("k", start, end, (ktrace.BATCH,))


def test_idle_inside_apply_by_gap_midpoint():
    # gaps (µs): 10-20 (midpoint 15, in the first apply), 50-58 (54, in
    # none), 70-90 (80, in the second) and 95-100 (97.5, in none)
    ops = [_op(0, 10), _op(20, 30), _op(25, 50), _op(58, 70), _op(90, 95)]
    host = [(5.0, 18.0, "kan.apply"), (74.0, 86.0, "kan.apply"),
            (0.0, 100.0, "kanbench.batch"), (40.0, 60.0, "aten::mm")]
    trc = ktrace.Trace(ops, (0.0, 100.0), {}, host)
    assert _read("kan_apply_idle_ms", _ctx(trc)) == \
        pytest.approx((10 + 20) / 1e3 / 2)
    quiet = ktrace.Trace(ops, (0.0, 100.0), {}, host[2:])
    assert _read("kan_apply_idle_ms", _ctx(quiet)) is None
    cpu = ktrace.Trace([], (0.0, 100.0), {}, host)
    assert _read("kan_apply_idle_ms", _ctx(cpu)) is None
    busy = ktrace.Trace([_op(0, 100)], (0.0, 100.0), {}, host)
    assert _read("kan_apply_idle_ms", _ctx(busy)) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_leaf_stages_account_for_the_apply(cuda, name):
    cell = resolve.cell(REPO, name)
    res = bench.run(cell, 2 ** 33 + 5, 1.0, True)
    m = {k: v["value"] for k, v in res["metrics"].items()}
    assert set(m) == {x["name"] for x in cell.per_layer}
    leaves = sum(m[k] for k in LEAVES if k in m)
    whole = m["kan_apply_ms"] + m["kan_apply_idle_ms"]
    assert abs(leaves - whole) <= 0.1 * whole, (leaves, whole)
    n = cell.traffic["trace_batches"]
    pat = KERNELS[cell.traffic["backend"]]
    kernel_ms = 1e3 * sum(s for k, s in res["breakdown"]["device_ops"]
                          if re.search(pat, k)) / n
    assert m["mac_ms"] >= kernel_ms > 0
    if "crossbar_live_share" in m:
        assert 0 < m["crossbar_live_share"] <= 100
