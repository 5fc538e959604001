"""The port's fleet seams and launcher path: ``Engine.adopt_compiled``,
``hw.chip.publish_report`` and ``launch.serve``'s router branch.

* ``adopt_compiled``: ``tests/test_obs.py``'s contract (the adopting
  engine logs no first call for a shape the other already ran, its own
  recorder takes the run's latencies) and the geometry ``ValueError``.
* ``publish_report`` gives the reference's gauges on the same
  ``chip_report`` (the reference's artifact carried across), and a stacked
  stage's artifact is reported repeat by repeat.
* The launcher on the CPU: ``--replicas 2 --drain-tick 3 --check``,
  ``--replicas 3 --drift-replica 1 --check``, ``kan_llm`` on ``cim_tiled``
  with the chip and canary gauges in its metrics file; ``--mesh-model``
  still raises, naming its slice.

``cuda``-marked: ``cim_mac_tiled`` against its plain version bit for bit
at the engine tick's shape (``kan_llm`` on ``cim_tiled``, 16 slots).
"""
import dataclasses
import json
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.core import kan as tk  # noqa: E402
from repro_torch.core.quant import ASPConfig  # noqa: E402
from repro_torch.hw import chip as tchip  # noqa: E402
from repro_torch.hw.tiles import TileConfig  # noqa: E402
from repro_torch.hw.variation import VariationConfig  # noqa: E402
from repro_torch.kernels import ops as tops, ref as tref  # noqa: E402
from repro_torch.launch import serve as tlaunch  # noqa: E402
from repro_torch.models import transformer as ttfm  # noqa: E402
from repro_torch.obs import EngineRecorder, MetricsRegistry  # noqa: E402
from repro_torch.serve import engine as teng  # noqa: E402
from repro_torch.serve.scheduler import Request  # noqa: E402
from test_torch_attention import _one_torch_thread  # noqa: E402,F401

TICK_SLOTS = 16


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    from repro.core import kan
    from repro.core.quant import ASPConfig as JASP
    from repro.hw import chip
    from repro.hw.tiles import TileConfig as JTile
    from repro.hw.variation import VariationConfig as JVar
    from repro.obs import MetricsRegistry as JRegistry
    return types.SimpleNamespace(jax=jax, kan=kan, ASP=JASP, chip=chip,
                                 Tile=JTile, Var=JVar, Registry=JRegistry)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _model(arch="mamba2_1p3b"):
    m = tconfigs.get_arch(arch, smoke=True).model
    return m, ttfm.init_model(0, m, device="cpu")


# --- adopt_compiled ----------------------------------------------------------

def test_adopt_compiled_keeps_warm_caches_and_rebinds_recorder():
    """``tests/test_obs.py``'s contract on the port: the adopting engine
    logs no first-call event for the shapes the other ran, and its own
    recorder captures the run's latencies."""
    m, params = _model()
    rec = EngineRecorder()
    eng = teng.Engine(params, m, n_slots=1, max_len=12, recorder=rec,
                      device="cpu")
    eng.run([Request(rid=0, tokens=np.arange(4) % m.vocab, max_new=3)])
    n_compiles = len(rec.compile_events)
    assert n_compiles > 0
    rec2 = EngineRecorder()
    eng2 = teng.Engine(params, m, n_slots=1, max_len=12, recorder=rec2,
                       device="cpu").adopt_compiled(eng)
    comps = eng2.run([Request(rid=1, tokens=np.arange(4) % m.vocab,
                              max_new=3)])
    assert len(comps) == 1
    assert len(rec.compile_events) == n_compiles
    assert rec2.compile_events == []
    assert rec2.metrics.get("serve_ttft_seconds").count == 1
    # a shape the other engine never ran is the adopter's own first call,
    # in its own recorder
    eng2.run([Request(rid=2, tokens=np.arange(6) % m.vocab, max_new=2)])
    assert [e.name for e in rec2.compile_events] == ["prefill_chunk6_first"
                                                     "_last"] or [
        e.name for e in rec2.compile_events] == ["prefill_len6"]
    assert len(rec.compile_events) == n_compiles


def test_adopt_compiled_refuses_another_geometry():
    m, params = _model()
    eng = teng.Engine(params, m, n_slots=2, max_len=12, device="cpu")
    for kw in (dict(n_slots=1, max_len=12), dict(n_slots=2, max_len=16),
               dict(n_slots=2, max_len=12, page_size=4),
               dict(n_slots=2, max_len=12, n_pages=5)):
        other = teng.Engine(params, m, device="cpu", **kw)
        with pytest.raises(ValueError, match="adopt_compiled"):
            eng.adopt_compiled(other)
    m2 = dataclasses.replace(m, n_layers=m.n_layers + 1)
    other = teng.Engine(ttfm.init_model(0, m2, device="cpu"), m2, n_slots=2,
                        max_len=12, device="cpu")
    with pytest.raises(ValueError, match="cfg/n_slots"):
        eng.adopt_compiled(other)


def test_adopt_compiled_without_recorders_changes_nothing():
    m, params = _model()
    a = teng.Engine(params, m, n_slots=2, max_len=12, device="cpu")
    b = teng.Engine(params, m, n_slots=2, max_len=12, device="cpu")
    fn = b._decode
    assert b.adopt_compiled(a) is b and b._decode is fn
    reqs = [Request(rid=i, tokens=np.arange(3 + i) % m.vocab, max_new=3)
            for i in range(3)]
    assert ({c.rid: list(c.tokens) for c in b.run(reqs)}
            == {c.rid: list(c.tokens) for c in a.run(reqs)})


# --- publish_report ----------------------------------------------------------

def _snap(reg):
    return {k: v["value"] for k, v in reg.snapshot()["metrics"].items()}


@pytest.mark.parametrize("dims,grid,cols", [((16, 8), 4, 32),
                                            ((16, 12, 8), 5, 16)])
def test_publish_report_equals_the_reference(jx, dims, grid, cols):
    """The reference's ``cim_tiled`` artifact carried across: equal
    ``chip_report`` rows and equal gauges in the registry, totals and per
    layer, with and without a prefix."""
    jccfg = jx.chip.ChipConfig(tile=jx.Tile(array_size=64, tile_cols=cols),
                               variation=jx.Var(sigma=0.0))
    tccfg = tchip.ChipConfig(tile=TileConfig(array_size=64, tile_cols=cols),
                             variation=VariationConfig(sigma=0.0))
    jspec = jx.kan.KANSpec(dims=dims, asp=tuple(jx.ASP(grid_size=grid)
                                                for _ in dims[1:]),
                           backend="cim_tiled", cim=jccfg)
    tspec = tk.KANSpec(dims=dims, asp=tuple(ASPConfig(grid_size=grid)
                                            for _ in dims[1:]),
                       backend="cim_tiled", cim=tccfg)
    jd = jx.kan.deploy(jx.kan.init(jx.jax.random.PRNGKey(0), jspec), jspec)
    layers = []
    for lay in jd.layers:
        d = {f: (None if getattr(lay, f) is None
                 else np.asarray(getattr(lay, f)))
             for f in ("codes", "scale", "hemi", "w_base", "row_order")}
        t = lay.tiles
        d["tiles"] = {f: None if getattr(t, f) is None
                      else np.asarray(getattr(t, f))
                      for f in ("w_phys", "gain", "logical_of_phys", "valid",
                                "phys_of_logical")}
        layers.append(d)
    td = tk.deployed_from_numpy(layers, tspec, device="cpu")
    want_rep = jx.chip.chip_report(jd)
    got_rep = tchip.chip_report(td)
    assert got_rep["layers"] == want_rep["layers"]
    assert {k: v for k, v in got_rep.items() if k != "layers"} \
        == pytest.approx({k: v for k, v in want_rep.items()
                          if k != "layers"}, rel=1e-12)
    for prefix in ("chip", "chip1"):
        jreg, treg = jx.Registry(), MetricsRegistry()
        jx.chip.publish_report(want_rep, jreg, prefix=prefix)
        tchip.publish_report(got_rep, treg, prefix=prefix)
        assert _snap(treg) == pytest.approx(_snap(jreg))
        assert treg.exposition() == jreg.exposition()
    snap = _snap(treg)
    assert sum(k.startswith("chip1_layer_utilization") for k in snap) == len(
        got_rep["layers"])


def test_chip_report_of_a_stacked_artifact_is_per_repeat():
    """A stacked stage's artifact (``deploy_kan`` over repeats) reports one
    row per repeat, each the report of that repeat alone; the totals add
    up (the reference reads the stack as one flat layer)."""
    m = dataclasses.replace(tconfigs.get_arch("kan_llm", smoke=True).model,
                            kan_backend="cim_tiled")
    params = ttfm.deploy_kan(ttfm.init_model(0, m, device="cpu"), m)
    stacked = params["stages"][0]["l0"]["kan"]
    rep = tchip.chip_report(stacked)
    names = list(rep["layers"])
    assert names == [f"{n}.{r}" for n in ("up", "down")
                     for r in range(m.n_layers)]
    for r in range(m.n_layers):
        alone = tchip.chip_report(ttfm.layer_of(stacked, r))
        for n in ("up", "down"):
            assert rep["layers"][f"{n}.{r}"] == alone["layers"][n]
        assert alone["tiles_used"] * m.n_layers == rep["tiles_used"]
    assert all(row["rows_empty"] >= 0 for row in rep["layers"].values())
    reg = MetricsRegistry()
    tchip.publish_report(rep, reg)
    assert 'chip_layer_rows_placed{layer="down.1"}' in _snap(reg)


# --- the launcher's router path ----------------------------------------------

def _launch(argv, tmp_path=None):
    base = ["--smoke", "--device", "cpu", "--check"]
    return tlaunch.main(argv + base)


def test_launcher_fleet_with_scheduled_drain(capsys):
    rep = _launch(["--arch", "mistral_nemo_12b", "--replicas", "2",
                   "--drain-tick", "3", "--requests", "10", "--stagger",
                   "1", "--common-prefix", "8"])
    out = capsys.readouterr().out
    assert "router check OK" in out
    assert rep["completed"] == 10 and rep["drains"] == 1
    assert rep["replicas"] == 2
    assert sum(rep["routed"]) == 10 + rep["requeued"]
    assert rep["agg_tokens_per_s"] is not None


def test_launcher_fleet_health_drains_the_drifting_replica(capsys,
                                                           tmp_path):
    path = tmp_path / "m.json"
    rep = _launch(["--arch", "mamba2_1p3b", "--replicas", "3",
                   "--drift-replica", "1", "--requests", "12",
                   "--metrics-out", str(path)])
    out = capsys.readouterr().out
    assert "health check OK: replica 1 auto-drained" in out
    assert rep["drained_for_health"] >= 1 and rep["completed"] == 12
    ev = rep["health"]["events"]
    assert ev[0]["replica"] == 1 and ev[0]["action"] == "drained"
    assert ev[0]["reasons"][0].startswith("drift:")
    snap = json.loads(path.read_text())["metrics"]
    for i in range(3):
        assert any(k.startswith("chip_canary_rel_dev{")
                   and f'replica="{i}"' in k for k in snap)


def test_launcher_fleet_on_cim_tiled_publishes_the_chip(capsys, tmp_path):
    """``kan_llm`` on ``cim_tiled`` through the router path: the chip
    placement gauges (``publish_report``) and the canary gauges land in one
    metrics file, and the run passes ``--check``."""
    path = tmp_path / "m.json"
    rep = _launch(["--arch", "kan_llm", "--kan-backend", "cim_tiled",
                   "--replicas", "2", "--drift-replica", "1",
                   "--metrics-out", str(path)])
    assert "router check OK" in capsys.readouterr().out
    assert rep["drained_for_health"] >= 1
    snap = json.loads(path.read_text())["metrics"]
    for key in ("tiles_allocated", "tiles_used", "utilization", "area_mm2",
                "power_w", "latency_ns", "energy_nj"):
        assert f"chip_{key}" in snap
    m = tconfigs.get_arch("kan_llm", smoke=True).model
    for n in ("up", "down"):
        for r in range(m.n_layers):
            key = f'chip_layer_rows_empty{{layer="{n}.{r}"}}'
            assert snap[key]["value"] >= 0
    assert snap["chip_tiles_used"]["value"] > 0


def test_launcher_single_engine_cim_tiled_publishes_the_chip(tmp_path):
    path = tmp_path / "m.json"
    tlaunch.main(["--arch", "kan_llm", "--kan-backend", "cim_tiled",
                  "--smoke", "--device", "cpu", "--metrics-out", str(path)])
    snap = json.loads(path.read_text())["metrics"]
    assert snap["chip_tiles_allocated"]["value"] > 0


def test_launcher_mesh_model_still_raises(capsys):
    """``--mesh-model`` serves (here on a world of one rank, under a 1x1
    mesh, ``--check`` holding); with ``--replicas`` it still raises the
    reference's argument error."""
    rep = tlaunch.main(["--arch", "mamba2_1p3b", "--smoke", "--device",
                        "cpu", "--mesh-model", "1", "--check"])
    assert rep["completed"] == 8
    assert "mesh={'data': 1, 'model': 1} ranks=1" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="mutually exclusive"):
        tlaunch.main(["--arch", "mamba2_1p3b", "--smoke", "--device", "cpu",
                      "--replicas", "2", "--mesh-model", "2"])


# --- cuda: cim_mac_tiled at the engine tick's shape --------------------------

@pytest.mark.cuda
def test_cim_mac_tiled_at_the_engine_tick(cuda, monkeypatch):
    """``kan_llm`` (full width) on ``cim_tiled`` through the engine on the
    card: the kernel runs in the fused tick at 16 rows for both the up and
    the down layers, and on every input the run gave it (each layer at
    each row count, tick and prefill, with the row attenuation and gains
    it was given) it equals its plain version bit for bit, twice."""
    m = dataclasses.replace(tconfigs.get_arch("kan_llm").model,
                            kan_backend="cim_tiled")
    params = ttfm.init_model(0, m, device=cuda)
    eng = teng.Engine(params, m, n_slots=TICK_SLOTS, max_len=64,
                      page_size=16, device=cuda)
    seen = {}
    fn = tops.cim_mac_tiled

    def spy(v, w, att, **kw):
        v2 = v.reshape(-1, v.shape[-1])
        seen.setdefault((w.data_ptr(), v2.shape[0]),
                        (v2.clone(), w, att.clone(), kw))
        return fn(v, w, att, **kw)
    monkeypatch.setattr(tops, "cim_mac_tiled", spy)
    reqs = teng.synth_trace(m.vocab, TICK_SLOTS, max_prompt=24,
                            min_prompt=8, max_new=4, min_new=2, stagger=0)
    comps = eng.run(reqs)
    assert len(comps) == TICK_SLOTS
    tick = {(v.shape[1], w.shape[1]) for (_, n), (v, w, _, _) in seen.items()
            if n == TICK_SLOTS}
    assert len(tick) == 2, tick     # the up and the down layers' shapes
    for v, w, att, kw in seen.values():
        got = fn(v, w, att, **kw)
        want = tref.cim_mac_tiled_ref(v, w, kw.get("gain"), att,
                                      kw["array_size"], kw["adc_bits"],
                                      kw["in_scale"])
        assert torch.equal(got, want), (tuple(v.shape), tuple(w.shape))
        assert torch.equal(fn(v, w, att, **kw), got)
