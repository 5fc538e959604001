"""On the card: every cell of BENCHMARK.json correct on a short window at
its own size, and its controls (int4 codes; bf16 taps on ``fused``) not. Skips without a card."""
from __future__ import annotations

import json

import pytest

from kbtiny import REPO
from kanbench import control, resolve

CELLS = [w["name"] for w in json.loads(
    (REPO / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_cell_correct_and_control_not(cuda, name):
    cell = resolve.cell(REPO, name)
    (ok,) = control.readings(cell, [2 ** 32 + 7], 1.0, None, check_every=20)
    assert ok["correct"] and ok["checked_batches"] >= 1
    kinds = ["codes"] + (["taps"] if cell.traffic["backend"] == "fused"
                         else [])
    for kind in kinds:
        (ctl,) = control.readings(cell, [2 ** 32 + 8], 1.0, kind,
                                  check_every=20)
        assert not ctl["correct"] and ctl["checked_batches"] >= 1
