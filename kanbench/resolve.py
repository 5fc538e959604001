"""Find everything a cell needs by the names in ``BENCHMARK.json``: its
configuration (the file the entry names; its ``kind``, ``cf_kan`` where it
has none, or ``lm``, picks the system and the window, and an ``lm`` file
names its plain reference), its traffic mix
(``kanbench/traffic/<traffic>.json``; a CF-KAN mix with ``"loop":
"open"`` runs the open loop), its correctness limits
(``kanbench/cells/<cell>.json``) and the readers of the per-layer metrics
that list it (``kanbench/metrics/<metric>.py``; a metric split by the end
-to-end metric it moves, ``<metric>.<part>``, with no file of its own is
read by ``<metric>``'s). A new cell, mix, metric, or configuration of
either kind is new files and entries; no file here changes."""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    chips: int
    model: Dict                 # the configuration file
    traffic: Dict               # the traffic file
    limits: Dict[str, float]    # the numbers that decide ``correct``
    end_to_end: List[Dict]      # the metrics of BENCHMARK.json it reports
    per_layer: List[Dict]


def _load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def _reports(metric: Dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(root: Path, name: str) -> Cell:
    """The cell ``name`` of the benchmark at ``root``."""
    bench = _load_json(root / "BENCHMARK.json")
    by_name = {w["name"]: w for w in bench["workloads"]}
    if name not in by_name:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; it has "
                       f"{sorted(by_name)}")
    w = by_name[name]
    config = {c["name"]: c for c in bench["configs"]}[w["config"]]
    return Cell(
        name=name, chips=int(w["chips"]),
        model=_load_json(root / config["file"]),
        traffic=_load_json(root / "kanbench" / "traffic"
                           / f"{w['traffic']}.json"),
        limits=_load_json(root / "kanbench" / "cells" / f"{name}.json")
        ["limits"],
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, name)])


def reader(root: Path, metric: str) -> Callable:
    """The ``read(ctx)`` function of a per-layer metric's file: its own,
    or for ``<metric>.<part>`` without one, ``<metric>``'s."""
    path = root / "kanbench" / "metrics" / f"{metric}.py"
    if not path.exists() and "." in metric:
        return reader(root, metric.rsplit(".", 1)[0])
    spec = importlib.util.spec_from_file_location(
        "kanbench_metric_" + metric.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
