"""A run of the harness on the CPU at a tiny size (the card's look skipped):
its result line, the control and planted faults failing ``correct``, the
modules it loads, and refusing to run without a card or without the
program."""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

import kanbench
from kbtiny import REPO, tiny_root
from kanbench import control, resolve, system
from kanbench import run as bench

TRAFFICS = ["score.fused.b2048", "chipeval.cim_tiled.b256",
            "chipeval.cim.b256"]


def _run(tmp_path, traffic, traced=False, seconds=0.3, **kw):
    root = tiny_root(tmp_path, traffic)
    cell = resolve.cell(root, "tiny")
    return bench.run(cell, 3_000_000_017, seconds, traced, device="cpu",
                     root=root, **kw)


@pytest.mark.parametrize("traced", [False, True])
@pytest.mark.parametrize("traffic", TRAFFICS)
def test_result_line_keys(tmp_path, traffic, traced):
    res = _run(tmp_path, traffic, traced)
    res.pop("_loaded"), res.pop("_batches")
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    keys += ["breakdown", "checks"] if traced else ["checks"]
    assert list(res) == keys
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] > 0 and res["attempted"] % 16 == 0
    assert set(res["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    if traced:
        assert {"busy_s", "window_s"} <= set(res["device"])
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
        # the CPU runs no device operation: no device metric is reported
        assert res["metrics"] == {}
    else:
        assert set(res["metrics"]) == {"users_per_s", "batch_p95_ms",
                                       "setup_s"}
    assert list(res["checks"]) == ["score_gap", "rank_gap", "bad_ids",
                                   "off_share"]
    json.dumps(res, allow_nan=False)


@pytest.mark.parametrize("traffic", TRAFFICS)
def test_control_fails(tmp_path, traffic):
    """The program at int4 codes against the int8 reference."""
    root = tiny_root(tmp_path, traffic)
    cell = resolve.cell(root, "tiny")
    recs = list(control.readings(cell, [11, 12], 0.3, "codes", device="cpu",
                                 root=root))
    assert all(not r["correct"] and r["coeff_bits"] == 4 for r in recs)
    assert min(r["score_gap"] for r in recs) > 100 * cell.limits["score_gap"]


def test_taps_control_fails_by_users_off(tmp_path):
    """The reference in the program's place with bf16 taps: each user is a
    little off, nearly all of them past ``check.OFF``."""
    root = tiny_root(tmp_path, "score.fused.b2048",
                     limits={"score_gap": 0.03, "rank_gap": 0.03,
                             "bad_ids": 0, "off_share": 0.25})
    cell = resolve.cell(root, "tiny")
    (ok,) = control.readings(cell, [11], 0.3, None, device="cpu", root=root)
    (rec,) = control.readings(cell, [12], 0.3, "taps", device="cpu",
                              root=root)
    assert ok["correct"] and ok["off_share"] <= 0.25
    assert rec["taps"] == "torch.bfloat16" and not rec["correct"]
    assert rec["score_gap"] <= 0.03 and rec["off_share"] > 0.9


def test_half_the_batch_left_out_fails(tmp_path, monkeypatch):
    """The second half of each batch gets the first half's scores."""
    apply = system.apply

    def half(deployed, x):
        h = x.shape[0] // 2
        y = apply(deployed, x[:h])
        return torch.cat([y, y[:x.shape[0] - h]])
    monkeypatch.setattr(system, "apply", half)
    res = _run(tmp_path, "score.fused.b2048")
    assert not res["correct"] and res["failed"] > 0


@pytest.mark.parametrize("traffic", TRAFFICS)
def test_an_answer_altered_fails(tmp_path, monkeypatch, traffic):
    """Each user's first id becomes the unseen item the program scored
    lowest."""
    rank = system.rank

    def altered(scores, x, k):
        ids = rank(scores, x, k).clone()
        ids[:, 0] = torch.where(x > 0, torch.inf, scores).argmin(dim=1)
        return ids
    monkeypatch.setattr(system, "rank", altered)
    res = _run(tmp_path, traffic)
    assert not res["correct"]
    assert res["checks"]["rank_gap"]["value"] > \
        res["checks"]["rank_gap"]["limit"]


def test_loads_no_jax_and_no_jax_package(tmp_path):
    root = tiny_root(tmp_path, "score.fused.b2048")
    code = ("import sys; from pathlib import Path; "
            "from kanbench import resolve, run; "
            f"cell = resolve.cell(Path({str(root)!r}), 'tiny'); "
            f"run.run(cell, 1, 0.2, False, device='cpu', "
            f"root=Path({str(root)!r})); "
            "print(run.forbidden_modules(), "
            "'repro_torch' in sys.modules)")
    env = dict(os.environ, PYTHONPATH=f"{REPO}:{REPO / 'src'}")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, check=True)
    assert out.stdout.split()[-2:] == ["[]", "True"]


# the parent's values of a closed-loop cell's checks at this seed (every
# batch checked, every pool batch seen): the refactor for the open loop and
# the LM cells kept them
GOLDEN = {"score.fused.b2048": 2.559654654652897e-07,
          "chipeval.cim_tiled.b256": 2.710056802768541e-07,
          "chipeval.cim.b256": 2.3683124472000302e-07}


@pytest.mark.parametrize("traffic", TRAFFICS)
def test_closed_loop_keeps_its_result_line(tmp_path, traffic):
    res = _run(tmp_path, traffic, seconds=0.8, check_every=1)
    assert res["_batches"]["window"] >= 8
    assert list(res) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks", "_loaded", "_batches"]
    assert list(res["metrics"]) == ["users_per_s", "batch_p95_ms", "setup_s"]
    assert res["attempted"] == 16 * res["_batches"]["window"]
    assert res["checks"] == {
        "score_gap": {"value": pytest.approx(GOLDEN[traffic], rel=1e-6),
                      "limit": 1e-4},
        "rank_gap": {"value": 0.0, "limit": 1e-4},
        "bad_ids": {"value": 0.0, "limit": 0},
        "off_share": {"value": 0.0, "limit": 0.25}}


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro.core", object())
    assert bench.forbidden_modules() == ["repro.core"]
    monkeypatch.delitem(sys.modules, "repro.core")
    assert "repro_torch" not in kanbench.FORBIDDEN
    assert all(not m.startswith("repro_torch")
               for m in bench.forbidden_modules())


def test_no_card_no_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    rc = bench.main(["--workload", "cfkan1.score.fused.b2048", "--seed", "1",
                     "--seconds", "1", "--trace", "0"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == "" and "CUDA" in out.err


def test_benchmark_files_alone_do_not_run(tmp_path):
    """A directory with BENCHMARK.json and the benchmark's folder, without
    the program: the command exits with an error and prints no result."""
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(REPO / "kanbench", tmp_path / "kanbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    cmd = json.loads((REPO / "BENCHMARK.json").read_text())["command"]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable if cmd[0].startswith("python") else cmd[0]]
        + cmd[1:] + ["--workload", "cfkan1.score.fused.b2048", "--seed",
                     "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, env=env, capture_output=True, text=True)
    assert out.returncode != 0 and out.stdout.strip() == ""
