"""The scoring path's stage spans and counters (``repro_torch.obs.trace``).

* With the profiler off, ``stage()`` is one shared null context and no
  call is recorded.
* Under ``torch.profiler`` on the CPU, ``kan.apply`` on ``fused`` (the
  plain path), ``cim`` and ``cim_tiled`` at CF-KAN-1's SMOKE widths emits
  the documented ranges, each nested under ``kan.apply``, and every aten
  op of the apply falls in exactly one leaf stage; ``_top_k`` emits
  ``cf_kan.rank``.
* The ring keeps the last calls and counts the ones it dropped; a call
  records an event where its stage changes, from a pool that evicted
  calls refill; the engine's phase spans are profiler ranges too.
* On the card (``cuda``): the served path's ``xbar.rows_iterated`` is the
  kernels' own count for the same inputs (``kernel_order``'s pairs on
  ``cim_tiled``, the wrapper's count called directly on ``cim``).
"""
import json

import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch.configs import cf_kan_1  # noqa: E402
from repro_torch.core import kan  # noqa: E402
from repro_torch.hw import chip, cim, tiles, variation  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import cf_kan  # noqa: E402
from repro_torch.obs import EngineRecorder  # noqa: E402
from repro_torch.obs import trace  # noqa: E402
from test_torch_attention import _one_torch_thread  # noqa: E402,F401
from test_torch_cim_tiled_order import kernel_order  # noqa: E402

MODEL = cf_kan_1.SMOKE_MODEL
RANGES = {"kan.apply", "kan.basis", "xbar.wl_dac", "xbar.gather", "kan.mac",
          "kan.base", "cf_kan.rank"}
LEAVES = {
    "fused": {"kan.basis": 2, "kan.mac": 2, "kan.base": 2},
    "cim": {"kan.basis": 4, "xbar.wl_dac": 2, "kan.mac": 4, "kan.base": 2},
    "cim_tiled": {"kan.basis": 4, "xbar.wl_dac": 2, "xbar.gather": 2,
                  "kan.mac": 4, "kan.base": 2},
}


def _hardware(backend):
    if backend == "cim":
        return cim.CIMConfig(array_size=64, gamma0=0.08)
    if backend == "cim_tiled":
        return chip.ChipConfig(
            tile=tiles.TileConfig(array_size=64, tile_cols=16, gamma0=0.08),
            variation=variation.VariationConfig(sigma=0.05, seed=3))
    return None


def _deployed(backend, device="cpu"):
    spec = MODEL.kan_spec.with_backend(backend, cim=_hardware(backend))
    return kan.deploy(kan.init(0, spec, device=device), spec)


def _users(b, device="cpu", seed=1):
    gen = torch.Generator().manual_seed(seed)
    return (torch.rand((b, MODEL.n_items), generator=gen) < 0.05).to(
        device=device, dtype=torch.float32)


def _events(prof, tmp_path):
    """The profile's complete events as (name, cat, start, end)."""
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    return [(e["name"], e.get("cat", ""), float(e["ts"]),
             float(e["ts"]) + float(e.get("dur", 0.0)))
            for e in json.loads(path.read_text())["traceEvents"]
            if e.get("ph") == "X"]


def _ranges(events):
    """The program's ranges among the events."""
    return [e for e in events if e[0] in RANGES]


@pytest.fixture
def ring(monkeypatch):
    rec = trace.StageRecorder(capacity=8)
    monkeypatch.setattr(trace, "STAGES", rec)
    return rec


def test_stage_off_is_the_shared_null_context(ring):
    null = trace.stage("kan.mac")
    assert null is trace.stage("kan.basis") is trace.profiler_range("x")
    assert null is trace.stage("kan.apply", torch.device("cpu"))
    dep = _deployed("cim")
    kan.apply(dep, _users(4))
    assert len(ring) == 0 and ring.dropped == 0
    assert trace.device_counter("xbar.rows_iterated") is None
    assert trace.stage_records(4) == []


@pytest.mark.parametrize("backend", ["fused", "cim", "cim_tiled"])
def test_apply_emits_the_documented_ranges(ring, tmp_path, backend):
    dep = _deployed(backend)
    x = _users(5)
    want = kan.apply(dep, x)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        got = kan.apply(dep, x)
    assert torch.equal(got, want)
    ranges = _ranges(_events(prof, tmp_path))
    calls = [r for r in ranges if r[0] == "kan.apply"]
    assert len(calls) == 1
    _, _, c0, c1 = calls[0]
    leaves = [r for r in ranges if r[0] != "kan.apply"]
    counts = {}
    for name, _, s, e in leaves:
        counts[name] = counts.get(name, 0) + 1
        assert c0 <= s <= e <= c1, name
    assert counts == LEAVES[backend]
    # leaves are siblings: none inside another
    for a in leaves:
        assert not any(b is not a and b[2] <= a[2] and a[3] <= b[3]
                       for b in leaves), a[0]
    # the call is kept; off the card it records no event and no counter
    assert len(ring) == 1 and trace.stage_records(1) == [{}]


@pytest.mark.parametrize("backend", ["fused", "cim", "cim_tiled"])
def test_every_aten_op_of_the_apply_falls_in_one_leaf(ring, tmp_path,
                                                      backend):
    dep = _deployed(backend)
    x = _users(3)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        kan.apply(dep, x)
    events = _events(prof, tmp_path)
    ranges = _ranges(events)
    (c0, c1), = [(s, e) for n, _, s, e in ranges if n == "kan.apply"]
    leaves = [(s, e) for n, _, s, e in ranges if n != "kan.apply"]
    ops_in = [ev for ev in events if ev[1] == "cpu_op"
              and ev[0] not in RANGES and c0 <= ev[2] <= c1]
    assert len(ops_in) > 10
    for name, _, s, e in ops_in:
        assert sum(1 for a, b in leaves if a <= s and e <= b) == 1, name


def test_top_k_emits_the_rank_range(tmp_path):
    scores = torch.randn(4, 50)
    observed = (torch.rand(4, 50) < 0.2).float()
    want = cf_kan._top_k(scores, observed, 5)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        got = cf_kan._top_k(scores, observed, 5)
    assert torch.equal(got, want)
    events = _events(prof, tmp_path)
    (r0, r1), = [(s, e) for n, _, s, e in _ranges(events)
                 if n == "cf_kan.rank"]
    sorts = [ev for ev in events if ev[0] == "aten::sort"]
    assert sorts and all(r0 <= s and e <= r1 for _, _, s, e in sorts)


def _counted_call(n):
    """A call whose only record is the device counter ``rows`` = ``n``."""
    call = trace.StageCall(torch.device("cpu"))
    call.device_counts["rows"] = [torch.tensor([n])]
    return call


def test_ring_keeps_the_last_calls_and_counts_drops(monkeypatch):
    rec = trace.StageRecorder(capacity=2)
    monkeypatch.setattr(trace, "STAGES", rec)
    dep = _deployed("cim")
    with profile(activities=[ProfilerActivity.CPU]):
        for b in range(1, 4):
            kan.apply(dep, _users(b))
    assert len(rec) == 2 and rec.dropped == 1
    for b in range(1, 6):
        rec.add(_counted_call(b))
    assert len(rec) == 2 and rec.dropped == 6
    assert trace.stage_records(5) == [{"rows": 4}, {"rows": 5}]
    assert trace.stage_records(1) == [{"rows": 5}]
    assert trace.stage_records(0) == []
    with pytest.raises(ValueError):
        trace.StageRecorder(capacity=0)


class _Event:
    """A stand-in for ``torch.cuda.Event``: counts its records."""

    def __init__(self, enable_timing=False):
        assert enable_timing
        self.records = 0

    def record(self, stream=None):
        assert stream == "stream"
        self.records += 1


def test_a_call_marks_where_its_stage_changes(monkeypatch):
    """One event where the stage changes and one at the call's end; a
    stage that follows one of its name adds none. Events come from the
    pool, which an empty pool refills by a chunk, each event recorded
    once."""
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: "stream")
    monkeypatch.setattr(trace.StageRecorder, "POOL_CHUNK", 3)
    rec = trace.StageRecorder(capacity=4)
    card = torch.device("cuda")
    with profile(activities=[ProfilerActivity.CPU]):
        with rec.stage("kan.apply", card):
            for name in ("a", "a", "b", "a"):
                with rec.stage(name):
                    pass
    (call,) = rec._calls
    assert [n for n, _ in call.marks] == ["a", "b", "a", None]
    events = [e for _, e in call.marks]
    assert len({id(e) for e in events}) == 4
    assert all(e.records == 2 for e in events)     # the pool's, the mark's
    assert len(rec._pool[card]) == 2               # 2 chunks of 3, 4 used


def test_evicted_calls_return_their_events_to_the_pool():
    rec = trace.StageRecorder(capacity=2)
    calls = [trace.StageCall(torch.device("cpu")) for _ in range(3)]
    for i, call in enumerate(calls):
        call.marks += [("a", f"ev{i}a"), (None, f"ev{i}b")]
        rec.add(call)
    assert rec.dropped == 1
    assert rec._pool[torch.device("cpu")] == ["ev0a", "ev0b"]


def test_records_sum_a_stage_over_its_entries():
    """A stage runs from its mark to the next; a call's stage ms sum over
    its entries; device counters come back as ints (events stubbed: no
    card here)."""
    class Ev:
        def __init__(self, t):
            self.t = t

        def elapsed_time(self, end):
            return end.t - self.t

    rec = trace.StageRecorder(capacity=4)
    call = trace.StageCall(torch.device("cpu"))
    call.marks += [("kan.mac", Ev(0.0)), ("kan.basis", Ev(1.5)),
                   ("kan.mac", Ev(1.75)), (None, Ev(2.25))]
    call.device_counts["xbar.rows_iterated"] = [torch.tensor([3]),
                                                torch.tensor([4])]
    rec.add(call)
    assert rec.records(1) == [{"kan.mac": 2.0, "kan.basis": 0.25,
                               "xbar.rows_iterated": 7}]


def test_ranges_fall_back_to_record_function(monkeypatch, tmp_path):
    """A torch without ``_RecordFunctionFast`` gets the public
    ``record_function`` ranges."""
    monkeypatch.delattr(torch._C._profiler, "_RecordFunctionFast")
    monkeypatch.setattr(trace, "_RANGE", None)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.profiler_range("outer"):
            torch.ones(3).sum()
    assert trace._RANGE is torch.profiler.record_function
    (cat,) = {c for n, c, *_ in _events(prof, tmp_path) if n == "outer"}
    assert cat == "user_annotation"


def test_engine_phases_and_spans_are_profiler_ranges(tmp_path):
    """``TraceRecorder.span`` and the engine's ``phase()`` open a profiler
    range of their name while the profiler records, and still record
    their trace event."""
    rec = EngineRecorder()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with rec.phase("decode") as ph:
            with rec.trace.span("inner"):
                torch.ones(3).sum()
    names = {n for n, *_ in _events(prof, tmp_path)}
    assert {"decode", "inner"} <= names
    assert ph.dur_s > 0
    xs = {e["name"] for e in rec.trace.events() if e["ph"] == "X"}
    assert xs == {"decode", "inner"}
    with rec.phase("host"):         # the profiler off: the span alone
        pass
    assert len(rec.trace.events()) == 3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _spy(monkeypatch, name):
    """Wrap ``ops.<name>`` so that it keeps each launch's arguments."""
    calls, real = [], getattr(ops, name)

    def spy(*args, **kw):
        calls.append((args, kw))
        return real(*args, **kw)
    monkeypatch.setattr(ops, name, spy)
    return calls, real


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["cim", "cim_tiled"])
def test_served_rows_iterated_is_the_kernels_count(cuda, ring, monkeypatch,
                                                   backend):
    dep = _deployed(backend, cuda)
    x = _users(37, cuda)
    kernel = "cim_mac" if backend == "cim" else "cim_mac_tiled"
    calls, real = _spy(monkeypatch, kernel)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        kan.apply(dep, x)
    (got,) = trace.stage_records(1)
    assert len(calls) == 2 and 0 < got["xbar.rows_iterated"]
    want = 0
    for (v, w, atten), kw in calls:
        if backend == "cim_tiled":
            lsb = kw["array_size"] * kw["in_scale"] / (2 ** kw["adc_bits"]
                                                       - 1)
            gain = kw["gain"]
            want += kernel_order(v.cpu(), w.cpu(),
                                 None if gain is None else gain.cpu(),
                                 atten.cpu(), kw["array_size"], lsb, 1)[1]
        else:
            counter = torch.zeros(1, dtype=torch.int64, device=cuda)
            kw = dict(kw, rows_iterated=counter)
            real(v, w, atten, **kw)
            want += int(counter)
    assert got["xbar.rows_iterated"] == want
