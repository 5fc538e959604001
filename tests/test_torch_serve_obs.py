"""Port parity for serving observability (``repro_torch.obs``) and the
serving entry points (``repro_torch.launch.serve``,
``repro_torch.examples.serve_kan_llm``).

* ``tests/test_obs.py``'s cases run on the port: the metrics registry and
  its Prometheus exposition (equal, text for text, to the reference's for
  the same calls), the trace flight recorder, the engine's recorder (the
  no-op default, a recorded run's TTFT/TPOT/compile events/trace, a first
  call per prompt length), the heap-backed admission queue against the old
  list implementation (and against the reference's queue), idle
  fast-forward, and the sketch twins of ``EngineStats.report()``.
* The launcher's ``--check`` gate and the example twin, on the CPU.
* ``kan_llm`` on ``lut_int8`` and ``cim_tiled`` through the engine while
  coefficient quantisation raises: the port's form of ``test_chip.py``'s
  requantisation-free tick (``kan.trace_requantizes`` has no torch
  counterpart); on ``lut_int8`` the completions are also the JAX
  engine's.
"""
import dataclasses
import json
import math
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.core import quant as tq  # noqa: E402
from repro_torch.examples import serve_kan_llm  # noqa: E402
from repro_torch.launch import serve as tlaunch  # noqa: E402
from repro_torch.models import transformer as ttfm  # noqa: E402
from repro_torch.obs import (DEFAULT_LATENCY_BUCKETS,  # noqa: E402
                             EngineRecorder, Histogram, MetricsRegistry,
                             NullRecorder, TraceRecorder, log_buckets)
from repro_torch.obs import profile as tprofile  # noqa: E402
from repro_torch.serve.engine import Engine, synth_trace  # noqa: E402
from repro_torch.serve.scheduler import (AdmissionQueue,  # noqa: E402
                                         EngineStats, Request)
from test_torch_attention import _one_torch_thread  # noqa: E402,F401


@pytest.fixture(scope="module")
def jx():
    """The JAX package, imported only by the parity cases."""
    jax = pytest.importorskip("jax")
    from repro import obs
    from repro.configs import get_arch
    from repro.models import transformer
    from repro.serve import engine, scheduler
    return types.SimpleNamespace(jax=jax, obs=obs, get_arch=get_arch,
                                 tfm=transformer, eng=engine,
                                 sched=scheduler)


def _model(arch_id="mamba2_1p3b", seed=0):
    m = tconfigs.get_arch(arch_id, smoke=True).model
    return m, ttfm.init_model(seed, m, device="cpu")


def _engine(params, m, **kw):
    return Engine(params, m, device="cpu", **kw)


# --- metrics ---------------------------------------------------------------

def test_log_buckets_edges(jx):
    b = log_buckets(1e-3, 1.0, per_decade=3)
    assert b[0] == pytest.approx(1e-3)
    assert b[-1] >= 1.0
    assert len(b) == 10
    ratios = [b[i + 1] / b[i] for i in range(len(b) - 1)]
    assert all(r == pytest.approx(10 ** (1 / 3)) for r in ratios)
    assert DEFAULT_LATENCY_BUCKETS[0] == pytest.approx(1e-6)
    assert DEFAULT_LATENCY_BUCKETS[-1] >= 100.0
    assert b == jx.obs.log_buckets(1e-3, 1.0, per_decade=3)
    assert DEFAULT_LATENCY_BUCKETS == jx.obs.DEFAULT_LATENCY_BUCKETS


def test_histogram_bucket_assignment_and_edges():
    h = Histogram("h", buckets=(1.0, 10.0, 100.0))
    for v in (0.5, 1.0):
        h.observe(v)
    h.observe(5.0)
    h.observe(10.0)
    h.observe(1000.0)
    assert h.counts == [2, 2, 0, 1]
    assert h.count == 5 and h.min == 0.5 and h.max == 1000.0
    cum = h.cumulative()
    assert cum[-1] == (math.inf, 5)
    assert [c for _, c in cum] == [2, 4, 4, 5]


def test_histogram_percentiles_log_interpolated():
    h = Histogram("h")
    for _ in range(100):
        h.observe(1e-3)
    assert h.percentile(50) == pytest.approx(1e-3)
    assert h.percentile(99) == pytest.approx(1e-3)
    assert Histogram("e").percentile(50) is None


def test_registry_identity_and_kinds():
    reg = MetricsRegistry()
    c1 = reg.counter("x", "help")
    assert c1 is reg.counter("x")
    c1.inc(2)
    assert reg.counter("x").value == 2
    la = reg.counter("y", labels={"phase": "a"})
    lb = reg.counter("y", labels={"phase": "b"})
    assert la is not lb
    with pytest.raises(ValueError, match="already registered|already used"):
        reg.gauge("x")
    with pytest.raises(ValueError, match="negative"):
        c1.inc(-1)


def _fill(reg):
    """The same calls on either package's registry."""
    reg.counter("reqs_total", "requests").inc(3)
    reg.gauge("slots", "active slots").set(2.5)
    h = reg.histogram("lat_seconds", "latency")
    h.observe(0.01)
    h.observe(0.5)
    reg.counter("c_total", 'help with \\ and\nnewline',
                labels={"path": 'a"b\\c\nd'}).inc(1)
    reg.gauge("g_inf").set(float("inf"))
    reg.gauge("g_ninf").set(float("-inf"))
    reg.gauge("g_nan").set(float("nan"))
    h2 = reg.histogram("lat2_seconds", buckets=(0.1, 1.0))
    for v in (0.05, 0.5, 5.0):
        h2.observe(v)
    return reg


def test_snapshot_exposition_round_trip(jx):
    reg = MetricsRegistry()
    reg.counter("reqs_total", "requests").inc(3)
    reg.gauge("slots", "active slots").set(2.5)
    h = reg.histogram("lat_seconds", "latency")
    h.observe(0.01)
    h.observe(0.5)
    snap = reg.snapshot()
    assert snap["schema"] == "obs-metrics/v1"
    again = json.loads(json.dumps(snap))
    assert again["metrics"]["reqs_total"]["value"] == 3
    hist = again["metrics"]["lat_seconds"]
    assert hist["count"] == 2 and hist["p50"] is not None
    assert hist["buckets"][-1][0] == "+Inf"
    assert hist["buckets"][-1][1] == 2
    text = reg.exposition()
    assert "# TYPE reqs_total counter" in text
    assert "reqs_total 3" in text
    assert "# TYPE lat_seconds histogram" in text
    assert 'lat_seconds_bucket{le="+Inf"} 2' in text
    assert "lat_seconds_count 2" in text
    # the reference's registry, given the same calls, says the same
    port, ref = _fill(MetricsRegistry()), _fill(jx.obs.MetricsRegistry())
    assert port.exposition() == ref.exposition()
    assert json.dumps(port.snapshot()) == json.dumps(ref.snapshot())


def test_exposition_prometheus_conformance():
    reg = MetricsRegistry()
    reg.counter("c_total", 'help with \\ and\nnewline',
                labels={"path": 'a"b\\c\nd'}).inc(1)
    reg.gauge("g_inf").set(float("inf"))
    reg.gauge("g_ninf").set(float("-inf"))
    reg.gauge("g_nan").set(float("nan"))
    h = reg.histogram("lat_seconds", buckets=(0.1, 1.0))
    for v in (0.05, 0.5, 5.0):
        h.observe(v)
    lines = reg.exposition().splitlines()
    assert 'c_total{path="a\\"b\\\\c\\nd"} 1.0' in lines
    assert "# HELP c_total help with \\\\ and\\nnewline" in lines
    assert "g_inf +Inf" in lines
    assert "g_ninf -Inf" in lines
    assert "g_nan NaN" in lines
    assert 'lat_seconds_bucket{le="0.1"} 1' in lines
    assert 'lat_seconds_bucket{le="1.0"} 2' in lines
    assert 'lat_seconds_bucket{le="+Inf"} 3' in lines
    assert "lat_seconds_count 3" in lines
    sum_line = next(ln for ln in lines if ln.startswith("lat_seconds_sum "))
    assert float(sum_line.split()[1]) == pytest.approx(5.55)
    for ln in lines:
        if not ln or ln.startswith("#"):
            continue
        val = ln.rsplit(" ", 1)[1]
        assert val in ("+Inf", "-Inf", "NaN") or float(val) is not None


# --- trace -----------------------------------------------------------------------

def test_span_nesting_and_chrome_schema():
    tr = TraceRecorder(capacity=64, pid=7)
    with tr.span("outer"):
        with tr.span("inner"):
            tr.instant("marker")
    tr.begin_async("request", "r1", args={"rid": "r1"})
    tr.end_async("request", "r1")
    ct = tr.chrome_trace()
    evs = ct["traceEvents"]
    assert ct["displayTimeUnit"] == "ms"
    by_name = {e["name"]: e for e in evs if e.get("ph") in "Xibe"}
    outer, inner = by_name["outer"], by_name["inner"]
    assert outer["ph"] == inner["ph"] == "X"
    assert outer["ts"] <= inner["ts"]
    assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"] + 1e-3
    b = next(e for e in evs if e["ph"] == "b")
    e = next(e for e in evs if e["ph"] == "e")
    assert b["id"] == e["id"] == "r1" and b["cat"] == e["cat"]
    assert any(e["ph"] == "M" and e["name"] == "thread_name" for e in evs)
    json.dumps(ct)


def test_ring_buffer_eviction_counts_drops():
    tr = TraceRecorder(capacity=8)
    for i in range(20):
        tr.instant(f"e{i}")
    assert len(tr) == 8
    assert tr.dropped == 12
    assert [e["name"] for e in tr.events()] == [f"e{i}"
                                                for i in range(12, 20)]
    ct = tr.chrome_trace()
    assert ct["otherData"]["dropped_events"] == 12
    trunc = [e for e in ct["traceEvents"]
             if e["ph"] == "M" and e["name"] == "trace_truncation"]
    assert len(trunc) == 1
    assert trunc[0]["args"] == {"dropped_events": 12, "capacity": 8}


# --- the engine's recorder ---------------------------------------------------------

def test_engine_defaults_to_null_recorder():
    m, params = _model()
    eng = _engine(params, m, n_slots=1, max_len=12)
    assert isinstance(eng.obs, NullRecorder) and not eng.obs.enabled
    assert not eng._profilers
    eng.run([Request(rid=0, tokens=np.arange(4), max_new=3)])
    rep = eng.stats.report()
    assert rep["ttft_s"]["n"] == 0 and rep["ttft_s"]["p50"] is None
    assert rep["tpot_s"]["n"] == 0
    assert eng.obs.snapshot() == {}


def _trace5(vocab):
    return synth_trace(vocab, 5, max_prompt=9, min_prompt=4, max_new=6,
                       min_new=3, stagger=2, seed=3)


def test_recorded_engine_run_full_stack():
    """TTFT/TPOT samples consistent with the completions, one first-call
    event per distinct prompt length and for the tick, a valid Chrome
    trace, and tokens identical to an unrecorded engine's."""
    m, params = _model()
    reqs = _trace5(m.vocab)
    prompt_lens = {int(np.asarray(r.tokens).shape[-1]) for r in reqs}
    rec = EngineRecorder(trace_capacity=4096)
    eng = _engine(params, m, n_slots=2, max_len=16, recorder=rec)
    comps = eng.run(list(reqs))
    assert len(comps) == len(reqs)
    stats = eng.stats
    assert len(stats.ttft_s) == stats.completed == len(reqs)
    assert all(t > 0 for t in stats.ttft_s)
    assert len(stats.tpot_s) == stats.decode_tokens
    assert stats.decode_tokens == sum(len(c.tokens) - 1 for c in comps)
    for c in comps:
        assert c.finished_tick - c.admitted_tick == max(len(c.tokens) - 2, 0)
    rep = stats.report()
    for fam in ("ttft_s", "tpot_s"):
        assert rep[fam]["p50"] <= rep[fam]["p95"] <= rep[fam]["p99"]
    assert max(stats.ttft_s) <= stats.wall_s + 1e-6

    prefill_events = [e for e in rec.compile_events
                      if e.name.startswith("prefill")]
    assert len(prefill_events) == len(prompt_lens)
    assert {e.name for e in prefill_events} == {
        f"prefill_len{n}" for n in prompt_lens}
    assert "decode_tick" in {e.name for e in rec.compile_events}
    assert "cache_write" not in {e.name for e in rec.compile_events}
    assert all(e.wall_s > 0 and e.flops is None and e.bytes_accessed is None
               for e in rec.compile_events)

    snap = rec.snapshot()
    assert snap["schema"] == "obs/v1"
    mtr = snap["metrics"]
    assert mtr["serve_ttft_seconds"]["count"] == len(reqs)
    assert mtr["serve_tpot_seconds"]["count"] == stats.decode_tokens
    assert mtr["serve_submitted_total"]["value"] == len(reqs)
    assert mtr['serve_completed_total{reason="length"}']["value"] == len(reqs)
    assert mtr["serve_queue_wait_ticks"]["count"] == len(reqs)
    for phase in ("admit", "prefill", "decode", "host"):
        assert mtr[f'serve_tick_phase_seconds{{phase="{phase}"}}']["count"] > 0
    json.dumps(snap)

    evs = rec.trace.chrome_trace()["traceEvents"]
    assert sum(1 for e in evs if e.get("ph") == "b") == len(reqs)
    assert sum(1 for e in evs if e.get("ph") == "e") == len(reqs)
    assert {e["name"] for e in evs if e.get("ph") == "X"} >= {
        "admit", "prefill", "decode", "host"}

    plain = _engine(params, m, n_slots=2, max_len=16)
    ref = {c.rid: list(c.tokens) for c in plain.run(_trace5(m.vocab))}
    assert {c.rid: list(c.tokens) for c in comps} == ref


def test_recorded_events_match_jax(jx):
    """The port records what the reference records on the same weights and
    trace: the same first-call names, tokens, and counter values."""
    m = tconfigs.get_arch("mamba2_1p3b", smoke=True).model
    jm = jx.get_arch("mamba2_1p3b", smoke=True).model
    jp = jx.tfm.init_model(jx.jax.random.PRNGKey(0), jm)
    tp = ttfm.params_from_numpy(jx.jax.tree.map(np.asarray, jp),
                                device="cpu")
    jrec, trec = jx.obs.EngineRecorder(), EngineRecorder()
    jc = jx.eng.Engine(jp, jm, n_slots=2, max_len=16, recorder=jrec).run(
        jx.eng.synth_trace(jm.vocab, 5, max_prompt=9, min_prompt=4,
                           max_new=6, min_new=3, stagger=2, seed=3))
    tc = _engine(tp, m, n_slots=2, max_len=16, recorder=trec).run(
        _trace5(m.vocab))
    assert ({c.rid: list(c.tokens) for c in tc}
            == {c.rid: list(c.tokens) for c in jc})
    assert (sorted(e.name for e in trec.compile_events)
            == sorted(e.name for e in jrec.compile_events))
    # XLA's cost analysis gives the reference FLOPs/bytes gauges; the port
    # has none to give
    js, ts = jrec.snapshot()["metrics"], trec.snapshot()["metrics"]
    js = {k: v for k, v in js.items()
          if not k.startswith(("compiled_flops", "compiled_bytes"))}
    assert set(ts) == set(js)
    for key, val in js.items():
        if "value" in val and "seconds" not in key:
            assert ts[key]["value"] == val["value"], key
        if "count" in val:
            assert ts[key]["count"] == val["count"], key


def test_compile_event_on_second_prompt_length():
    m, params = _model()
    rec = EngineRecorder()
    eng = _engine(params, m, n_slots=1, max_len=16, recorder=rec)
    eng.run([Request(rid=0, tokens=np.arange(4) % m.vocab, max_new=2)])
    assert len([e for e in rec.compile_events
                if e.name.startswith("prefill")]) == 1
    eng.run([Request(rid=1, tokens=np.arange(6) % m.vocab, max_new=2)])
    names = [e.name for e in rec.compile_events
             if e.name.startswith("prefill")]
    assert names == ["prefill_len4", "prefill_len6"]
    eng.run([Request(rid=2, tokens=np.arange(6, 12) % m.vocab, max_new=2)])
    assert len([e for e in rec.compile_events
                if e.name.startswith("prefill")]) == 2
    assert rec.metrics.get("compile_total", {"fn": "prefill_len6"}).value == 1


def test_profiler_keys_on_shapes_not_host_integers():
    calls = []
    prof = tprofile.JitProfiler(lambda *a: calls.append(a), "f", None)
    for start in (0, 4, 8):
        prof(torch.zeros(2, 3), start, {"k": [torch.ones(4)]})
    prof(torch.zeros(2, 5), 0, {"k": [torch.ones(4)]})
    assert len(calls) == 4 and prof.n_compiles == 2
    assert prof.events[0].key == "torch.float32[2, 3],int,torch.float32[4]"
    assert tprofile.maybe_profile(len, "f", NullRecorder()) is len


# --- scheduler: heap queue, idle fast-forward ---------------------------------------

class _ListQueue:
    """The previous O(n) scan-and-remove queue: the semantic reference."""

    def __init__(self, max_pending=None):
        self.max_pending = max_pending
        self._items = []
        self._n = 0

    def __len__(self):
        return len(self._items)

    def submit(self, req):
        if (self.max_pending is not None
                and len(self._items) >= self.max_pending):
            return False
        self._items.append(((-req.priority, self._n), req))
        self._n += 1
        return True

    def pop(self, tick):
        ready = [it for it in self._items if it[1].arrival <= tick]
        if not ready:
            return None
        item = min(ready, key=lambda it: it[0])
        self._items.remove(item)
        return item[1]

    def next_arrival(self):
        return min((it[1].arrival for it in self._items), default=None)


def test_admission_queue_property_equivalence(jx):
    """Random submit/pop interleavings at non-decreasing ticks: the heap
    queue pops what the list queue pops, and what the reference's pops."""
    rng = np.random.RandomState(0)
    for trial in range(25):
        cap = [None, 4, 8][trial % 3]
        heap_q, list_q = AdmissionQueue(cap), _ListQueue(cap)
        ref_q = jx.sched.AdmissionQueue(cap)
        rid = tick = 0
        for step in range(60):
            op = rng.rand()
            tick += int(rng.randint(0, 4))
            if op < 0.55:
                req = Request(rid=rid, tokens=(), max_new=1,
                              priority=int(rng.randint(0, 4)),
                              arrival=int(rng.randint(0, 30)))
                rid += 1
                ok = heap_q.submit(req)
                assert ok == list_q.submit(req) == ref_q.submit(req)
            else:
                a, b, c = heap_q.pop(tick), list_q.pop(tick), ref_q.pop(tick)
                assert ((a.rid if a else None) == (b.rid if b else None)
                        == (c.rid if c else None)), (trial, step, tick)
            assert len(heap_q) == len(list_q) == len(ref_q)
            assert (heap_q.next_arrival() == list_q.next_arrival()
                    == ref_q.next_arrival())


def test_fifo_within_priority_across_arrival_migration():
    q = AdmissionQueue()
    q.submit(Request(rid="early-sub-late-arrival", tokens=(), max_new=1,
                     arrival=10))
    q.submit(Request(rid="late-sub-early-arrival", tokens=(), max_new=1,
                     arrival=0))
    assert q.pop(5).rid == "late-sub-early-arrival"
    q.submit(Request(rid="third", tokens=(), max_new=1, arrival=0))
    assert q.pop(20).rid == "early-sub-late-arrival"
    assert q.pop(20).rid == "third"
    assert q.pop(20) is None


def test_run_fast_forwards_sparse_trace():
    m, params = _model()
    stagger = 50
    reqs = [Request(rid=i, tokens=(np.arange(4) + i) % m.vocab, max_new=3,
                    arrival=i * stagger) for i in range(3)]
    eng = _engine(params, m, n_slots=2, max_len=12)
    comps = eng.run(list(reqs))
    assert len(comps) == 3
    assert eng.stats.ff_ticks > 2 * (stagger - 10)
    assert eng.stats.idle_ticks >= eng.stats.ff_ticks
    assert eng.stats.ticks >= 2 * stagger + 2
    assert 0.0 < eng.stats.mean_occupancy() <= 1.0
    for c in comps:
        solo = _engine(params, m, n_slots=2, max_len=12)
        ref = solo.run([Request(rid="s", tokens=reqs[c.rid].tokens,
                                max_new=3)])
        assert list(c.tokens) == list(ref[0].tokens)
    assert eng.stats.ticks - eng.stats.ff_ticks < 15


def test_report_sketch_twins_track_numpy_percentiles(jx):
    rng = np.random.default_rng(7)
    ttft = list(rng.lognormal(mean=-3.0, sigma=0.8, size=500))
    tpot = list(rng.lognormal(mean=-5.0, sigma=0.5, size=500))
    st, ref = EngineStats(n_slots=2), jx.sched.EngineStats(n_slots=2)
    for s in (st, ref):
        s.ttft_s, s.tpot_s, s.completed = list(ttft), list(tpot), 500
    rep = st.report()
    for exact_key, sk_key in (("ttft_s", "ttft_sketch"),
                              ("tpot_s", "tpot_sketch")):
        sk = rep[sk_key]
        assert sk["n"] == 500
        assert 0 < sk["alpha"] < 1
        for p in ("p50", "p95", "p99"):
            assert sk[p] == pytest.approx(rep[exact_key][p], rel=0.02)
    assert rep == ref.report()


def test_report_sketch_twins_empty_stats():
    rep = EngineStats(n_slots=1).report()
    assert rep["ttft_sketch"]["n"] == 0
    assert rep["ttft_sketch"]["p95"] is None
    assert rep["tpot_sketch"]["n"] == 0


# --- the launcher and the example twin --------------------------------------------

@pytest.mark.parametrize("argv", [
    ["--arch", "mamba2_1p3b", "--requests", "4"],
    ["--arch", "kan_llm", "--requests", "6", "--page-size", "4",
     "--common-prefix", "8", "--kan-backend", "fused"],
    ["--arch", "recurrentgemma_2b", "--requests", "4", "--prompt-len", "20"],
])
def test_launcher_check_on_the_cpu(argv, tmp_path, capsys):
    out = tmp_path / "m.json"
    rep = tlaunch.main(argv + ["--smoke", "--check", "--device", "cpu",
                               "--metrics-port", "0", "--metrics-out",
                               str(out), "--trace-out",
                               str(tmp_path / "t.json")])
    text = capsys.readouterr().out
    assert "engine check OK" in text
    assert "metrics endpoint check OK" in text
    assert rep["completed"] == int(argv[3]) and rep["evicted_eos"] >= 1
    assert json.loads(out.read_text())["schema"] == "obs/v1"
    if "--common-prefix" in argv:
        assert rep["prefix_hit_pages"] > 0


@pytest.mark.parametrize("flag", [["--replicas", "2", "--mesh-model", "2"],
                                  ["--drift-replica", "0"],
                                  ["--replicas", "2", "--drift-replica", "2"],
                                  ["--mesh-model", "1"],
                                  ["--mesh-model", "2"]])
def test_launcher_later_slices_raise(flag, tmp_path):
    """``--mesh-model M`` serves on a world of M ranks (one in this
    process, two as gloo ranks through ``test_torch_mesh_ranks``), every
    rank's ``--check`` holding; the router's flags raise only the
    reference's argument errors."""
    argv = ["--arch", "mamba2_1p3b", "--smoke", "--device", "cpu"] + flag
    if flag[0] == "--mesh-model":
        n = int(flag[1])
        argv += ["--check"]
        if n == 1:
            reps = [tlaunch.main(argv)]
        else:
            from test_torch_mesh_ranks import run_ranks
            reps = run_ranks("launch_serve", n, tmp_path, {"argv": argv})
        for rep in reps:
            assert rep["completed"] == 8 and rep["slot_reuse"] > 1
        assert all(rep["slot_served"] == reps[0]["slot_served"]
                   for rep in reps)
    else:
        with pytest.raises(SystemExit, match="--replicas|--drift-replica"):
            tlaunch.main(argv)


@pytest.mark.parametrize("backend", [None, "fused"])
def test_example_twin_on_the_cpu(backend, capsys):
    argv = ["--device", "cpu"] + (["--backend", backend] if backend else [])
    rep = serve_kan_llm.main(argv)
    assert rep["completed"] == 12 and rep["slot_reuse"] > 1
    text = capsys.readouterr().out
    assert text.rstrip().endswith("OK")
    assert f"backend={backend or 'lut'}" in text


# --- KAN backends through the engine, requantisation poisoned ------------------------

@pytest.mark.parametrize("backend", ["cim_tiled", "lut_int8"])
def test_new_backends_serve_through_engine(jx, monkeypatch, backend):
    """The engine deploys once at construction; its ticks then run with
    ``quantize_coeffs`` (and the LUT builders) raising. On ``lut_int8`` the
    completions are the JAX engine's (``cim_tiled`` draws its cell
    variation from another generator than the reference's)."""
    m = dataclasses.replace(tconfigs.get_arch("kan_llm", smoke=True).model,
                            kan_backend=backend)
    jm = dataclasses.replace(jx.get_arch("kan_llm", smoke=True).model,
                             kan_backend=backend)
    jp = jx.tfm.init_model(jx.jax.random.PRNGKey(0), jm)
    tp = ttfm.params_from_numpy(jx.jax.tree.map(np.asarray, jp),
                                device="cpu")
    eng = _engine(tp, m, n_slots=2, max_len=16)
    assert eng.kan_deployed
    trace = dict(max_prompt=6, min_prompt=3, max_new=4, min_new=2, stagger=1)

    def boom(*a, **k):
        raise AssertionError("coefficient (re)quantisation while serving")
    with monkeypatch.context() as mp:
        for name in ("quantize_coeffs", "hemi_for", "quantize_hemi"):
            mp.setattr(tq, name, boom)
        comps = eng.run(synth_trace(m.vocab, 4, **trace))
    assert len(comps) == 4
    assert all(len(c.tokens) == r.max_new for c, r in zip(
        sorted(comps, key=lambda c: c.rid), synth_trace(m.vocab, 4, **trace)))
    if backend == "lut_int8":
        want = jx.eng.Engine(jp, jm, n_slots=2, max_len=16).run(
            jx.eng.synth_trace(jm.vocab, 4, **trace))
        assert ({c.rid: list(c.tokens) for c in comps}
                == {c.rid: list(c.tokens) for c in want})
