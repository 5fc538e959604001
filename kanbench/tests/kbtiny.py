"""A throwaway benchmark root holding one tiny cell, for the tests."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]

# the LM cell's traffic cut to the program's SMOKE widths: 4 slots, pages
# of 16 (chunks of 16), prompts of 8 to 48 tokens, 3 to 12 new ones
LM_TRAFFIC = {"n_slots": 4, "sessions": 4, "page_size": 16, "max_len": 64,
              "prompt": {"median": 20, "sigma": 0.7, "min": 8, "max": 48},
              "output": {"median": 6, "sigma": 0.7, "min": 3, "max": 12},
              "block": 8, "check_every": 2, "trace_lead": 1,
              "trace_steps": 2}
LM_LIMITS = {"token_gap": 1e-3, "lead_miss_share": 0.0, "incomplete": 0}
# the metrics of the cells whose mixes no cell of BENCHMARK.json runs yet
# (PERF.md section 7), by mix: (end-to-end: name, unit, better), (per
# layer: name, unit, the end-to-end metric it moves)
HELD_OUT = {
    "engine.offline.c64": (
        [("tokens_per_s", "tokens/s", "higher"),
         ("ttft_p95_ms", "ms", "lower"), ("tpot_p95_ms", "ms", "lower")],
        [("engine_step_ms", "ms", "tokens_per_s"),
         ("slot_live_share", "%", "tokens_per_s"),
         ("ssd_scan_roofline", "%", "ttft_p95_ms"),
         ("mfu.engine", "%", "tokens_per_s"),
         ("device_idle_share.engine", "%", "tokens_per_s"),
         ("peak_mem_gb.engine", "GB", "tokens_per_s")]),
    "online.fused.b32": (
        [("user_p50_ms", "ms", "lower")],
        [("device_idle_share.online", "%", "user_p50_ms"),
         ("kan_apply_idle_ms.online", "ms", "user_p50_ms"),
         ("kan_apply_ms.online", "ms", "user_p50_ms"),
         ("rank_ms.online", "ms", "user_p50_ms")]),
}


def _like(bench, traffic: str) -> str:
    """The benchmark's first cell under ``traffic``, whose metrics the tiny
    cell reports; for a held-out mix, its metrics put in their place."""
    for w in bench["workloads"]:
        if w["traffic"] == traffic:
            return w["name"]
    e2e, per_layer = HELD_OUT[traffic]
    setup = [m for m in bench["end_to_end"] if m["name"] == "setup_s"]
    bench["end_to_end"] = setup + [
        {"name": n, "unit": u, "better": b, "bound": 0.25,
         "source": "host_clock"} for n, u, b in e2e]
    bench["per_layer"] = [
        {"name": n, "unit": u, "better": "higher" if u == "%" else "lower",
         "source": "device_trace", "layer": "a test", "moves": mv}
        for n, u, mv in per_layer]
    return "tiny"


def tiny_root(tmp: Path, traffic: str, config: str = "cf-kan-1",
              limits=None) -> Path:
    """A benchmark root whose one cell, ``tiny``, is ``config`` at the
    program's SMOKE widths (CF-KAN: 256 items, hidden 16, under ``traffic``
    cut to batches of 16; an LM: ``mamba2_1p3b.SMOKE`` under
    ``LM_TRAFFIC``): new files and a BENCHMARK.json of their own, the real
    metric readers beside them."""
    kb = tmp / "kanbench"
    for d in ("configs", "traffic", "cells"):
        (kb / d).mkdir(parents=True, exist_ok=True)
    shutil.copytree(REPO / "kanbench" / "metrics", kb / "metrics",
                    dirs_exist_ok=True)
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    model = json.loads((REPO / "kanbench" / "configs"
                        / f"{config}.json").read_text())
    t = json.loads((REPO / "kanbench" / "traffic"
                    / f"{traffic}.json").read_text())
    if model.get("kind") == "lm":
        model.update(n_layers=3, d_model=64, n_heads=8, d_state=16,
                     head_dim=16, chunk=16, vocab=512, name="tiny",
                     program_config="repro_torch.configs.mamba2_1p3b.SMOKE")
        t.update(LM_TRAFFIC)
        limits = limits or LM_LIMITS
    else:
        model.update(n_items=256, hidden=16, name="tiny")
        t.update(check_every=3, trace_lead=2, trace_batches=2)
        t.update({"max_batch": 16} if "max_batch" in t else {"batch": 16})
        if "rate" in t:
            t.update(rate=2000.0, pool_users=256)
        limits = limits or {"score_gap": 1e-4, "rank_gap": 1e-4,
                            "bad_ids": 0, "off_share": 0.25}
    (kb / "configs" / "tiny.json").write_text(json.dumps(model))
    (kb / "traffic" / "tiny.json").write_text(json.dumps(t))
    (kb / "cells" / "tiny.json").write_text(json.dumps({"limits": limits}))
    like = _like(bench, traffic)
    bench["configs"] = [{"name": "tiny", "source": "a test",
                         "file": "kanbench/configs/tiny.json", "reduced": [],
                         "why": "a test"}]
    bench["workloads"] = [{"name": "tiny", "config": "tiny",
                           "traffic": "tiny", "chips": 1, "why": "a test"}]
    for key in ("end_to_end", "per_layer"):
        bench[key] = [dict(m, workloads=["tiny"]) for m in bench[key]
                      if like in m.get("workloads", [like])]
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp

