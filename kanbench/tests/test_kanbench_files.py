"""BENCHMARK.json against its format's limits, and every name in it
resolving to its files; a new cell added from new files alone."""
from __future__ import annotations

import json
import re
import shutil

import pytest

from kbtiny import REPO, tiny_root
from kanbench import resolve

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_keys_names_and_units():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["kanbench"]
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert len(names) == len(set(names))
    for n in names + [w["traffic"] for w in BENCH["workloads"]]:
        assert NAME.match(n), n
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for x in BENCH["configs"] + BENCH["workloads"]:
        assert 1 <= len(x["why"]) <= 200 and "\n" not in x["why"]
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_bounds_and_run_length_fit_their_limits():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    s = BENCH["run_seconds"]
    # 24 cells measured in full: 2 + 14 x 24 runs of s + 60 s, 2 x 90 s of
    # compile a cell and 1200 s spare fit in 43200 s
    assert (2 + 14 * 24) * (s + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("cell", CELLS + ["online", "lm"])
def test_cell_resolves_to_its_files(cell, tmp_path):
    """A closed CF-KAN cell reports users a second and the batch's tail, an
    open loop its users' median latency, an LM cell tokens a second and its
    two tails (``online``, ``lm``: those files at the program's SMOKE
    widths, as BENCHMARK.json holds no such cell yet); every cell its
    set-up, and per-layer metrics that move one of its own end-to-end
    metrics."""
    root = REPO
    if cell in ("online", "lm"):
        root = tiny_root(tmp_path, *(("online.fused.b32", "cf-kan-1")
                                     if cell == "online" else
                                     ("engine.offline.c64", "mamba2-1.3b")))
        cell = "tiny"
    c = resolve.cell(root, cell)
    assert c.chips == 1
    e2e = {m["name"] for m in c.end_to_end}
    if c.model.get("kind", "cf_kan") == "lm":
        assert e2e == {"tokens_per_s", "ttft_p95_ms", "tpot_p95_ms",
                       "setup_s"}
        assert set(c.limits) == {"token_gap", "lead_miss_share",
                                 "incomplete"}
        assert c.limits["incomplete"] == 0
        assert c.traffic["sessions"] == c.traffic["n_slots"]
    else:
        want = {"users_per_s", "batch_p95_ms", "setup_s"}
        if c.traffic.get("loop") == "open":
            # the rate fixes the users a second; the users feel the latency
            want = {"user_p50_ms", "setup_s"}
            assert c.traffic["rate"] > 0 and c.traffic["max_batch"] > 0
        assert e2e == want
        assert set(c.limits) == {"score_gap", "rank_gap", "bad_ids",
                                 "off_share"}
        assert c.traffic["backend"] in ("fused", "cim", "cim_tiled")
    assert c.per_layer
    for m in c.per_layer:
        assert m["moves"] in e2e - {"setup_s"}
        assert callable(resolve.reader(root, m["name"]))


def test_metric_lists_name_cells_that_report_what_they_move():
    cells = {c: resolve.cell(REPO, c) for c in CELLS}
    for m in BENCH["per_layer"] + BENCH["end_to_end"]:
        for w in m.get("workloads", CELLS):
            assert w in cells
            if "moves" in m:
                assert m["moves"] in {e["name"]
                                      for e in cells[w].end_to_end}
    for m in BENCH["per_layer"]:
        assert 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"]


def test_a_split_metric_is_read_by_its_base():
    """``<metric>.<part>`` without a file of its own is read by
    ``<metric>``'s reader; one with its own file by that."""
    def module(metric):
        return resolve.reader(REPO, metric).__module__

    for split, base in (("device_idle_share.online", "device_idle_share"),
                        ("peak_mem_gb.engine", "peak_mem_gb")):
        assert not (REPO / "kanbench" / "metrics" / f"{split}.py").exists()
        assert module(split) == module(base)
    assert module("mfu.engine") != module("mfu.batch")
    with pytest.raises(FileNotFoundError):
        resolve.reader(REPO, "no_such_metric.part")


def test_configs_are_the_programs():
    from repro_torch.configs import cf_kan_1, cf_kan_2
    for name, mod in (("cf-kan-1", cf_kan_1), ("cf-kan-2", cf_kan_2)):
        cfg = json.loads((REPO / "kanbench" / "configs"
                          / f"{name}.json").read_text())
        m = mod.MODEL
        assert (cfg["n_items"], cfg["hidden"]) == (m.n_items, m.hidden)
        for key, asp in (("enc", m.asp_enc), ("dec", m.asp_dec)):
            assert cfg[f"grid_size_{key}"] == asp.grid_size
            assert (cfg["order"], cfg["n_bits"], cfg["coeff_bits"],
                    cfg["x_min"], cfg["x_max"]) == (
                asp.order, asp.n_bits, asp.coeff_bits, asp.x_min, asp.x_max)


def test_a_new_cell_from_new_files_alone(tmp_path):
    """A cell added by new files and one workloads entry resolves, and the
    files of the benchmark are left as they were."""
    before = {p: p.read_bytes() for p in (REPO / "kanbench").rglob("*")
              if p.is_file() and "__pycache__" not in p.parts}
    root = tiny_root(tmp_path, "chipeval.cim.b256")
    shutil.copy(REPO / "kanbench" / "metrics" / "rank_ms.py",
                root / "kanbench" / "metrics" / "rank_ms_copy.py")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["per_layer"].append(dict(bench["per_layer"][0],
                                   name="rank_ms_copy", workloads=["tiny"]))
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    c = resolve.cell(root, "tiny")
    assert c.model["name"] == "tiny" and c.traffic["batch"] == 16
    assert "rank_ms_copy" in {m["name"] for m in c.per_layer}
    assert callable(resolve.reader(root, "rank_ms_copy"))
    after = {p: p.read_bytes() for p in before}
    assert after == before
