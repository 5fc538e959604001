"""A throwaway benchmark root holding one tiny cell, for the tests."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]


def tiny_root(tmp: Path, traffic: str, config: str = "cf-kan-1",
              limits=None) -> Path:
    """A benchmark root whose one cell, ``tiny``, is ``config`` at the
    program's SMOKE widths (256 items, hidden 16) under ``traffic`` cut to
    batches of 16: new files and a BENCHMARK.json of their own, the real
    metric readers beside them."""
    kb = tmp / "kanbench"
    for d in ("configs", "traffic", "cells"):
        (kb / d).mkdir(parents=True, exist_ok=True)
    shutil.copytree(REPO / "kanbench" / "metrics", kb / "metrics")
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    model = json.loads((REPO / "kanbench" / "configs"
                        / f"{config}.json").read_text())
    model.update(n_items=256, hidden=16, name="tiny")
    (kb / "configs" / "tiny.json").write_text(json.dumps(model))
    t = json.loads((REPO / "kanbench" / "traffic"
                    / f"{traffic}.json").read_text())
    t.update(batch=16, check_every=3, trace_lead=2, trace_batches=2)
    (kb / "traffic" / "tiny.json").write_text(json.dumps(t))
    limits = limits or {"score_gap": 1e-4, "rank_gap": 1e-4, "bad_ids": 0,
                        "off_share": 0.25}
    (kb / "cells" / "tiny.json").write_text(json.dumps({"limits": limits}))
    bench["configs"] = [{"name": "tiny", "source": "a test",
                         "file": "kanbench/configs/tiny.json", "reduced": [],
                         "why": "a test"}]
    bench["workloads"] = [{"name": "tiny", "config": "tiny",
                           "traffic": "tiny", "chips": 1, "why": "a test"}]
    for m in bench["per_layer"]:
        m.pop("workloads", None)
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp
