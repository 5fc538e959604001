"""The readings that the limits of ``correct`` are set from, for one cell at
its own size, many seeds in one process (set-up is paid once per seed, the
card's start-up once):

    python3 -m kanbench.control --workload <cell> --seeds 1,2,3 \\
        --control-seeds 4,5,6 [--taps-seeds 7,8,9] --seconds 3 \\
        [--check-every 12] [--check-rows 2048] [--out readings.jsonl]

``--seeds``: the program as the configuration states it (the lower
readings). The controls, each held to the reference at the configuration's
precision (the upper readings): ``--control-seeds``, on CF-KAN cells the
program with its coefficient codes one precision below the
configuration's (int4 for int8, the program's own ``coeff_bits`` path),
on LM cells the engine serving the weights rounded to fp8 e4m3 (one
precision below the configuration's bf16); ``--taps-seeds`` (``fused``
cells), the reference in the program's place with its taps one precision
below the configuration's (bf16 for f32), as a contraction that rounds its
taps would serve. Each run is a run of ``kanbench.run`` (or
``kanbench.lm_run``) with a short window; it prints the compared numbers.
The benchmark's own runs never run a control.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from kanbench import resolve
from kanbench import run as bench

# the next precision below a configuration's
_BELOW = {"float32": torch.bfloat16}


def control_bits(model: dict) -> int:
    """The next coefficient precision below the configuration's."""
    return model["coeff_bits"] // 2


def readings(cell: resolve.Cell, seeds, seconds: float, control=None,
             device: str = "cuda", root=bench.ROOT, check_every=None,
             check_rows=bench.CHECK_ROWS):
    """One record per seed: the compared numbers and the run's size.
    ``control`` is None (the program as configured), ``"codes"`` or
    ``"taps"`` (on an LM cell any control is the fp8 weights)."""
    if cell.model.get("kind", "cf_kan") == "lm":
        yield from _lm_readings(cell, seeds, seconds, control, device, root,
                                check_every)
        return
    bits = control_bits(cell.model) if control == "codes" else None
    taps = _BELOW[cell.model["taps"]] if control == "taps" else None
    for seed in seeds:
        t0 = time.perf_counter()
        res = bench.run(cell, seed, seconds, False, device=device,
                        coeff_bits=bits, taps=taps, root=root,
                        check_every=check_every, check_rows=check_rows)
        yield {"cell": cell.name, "seed": seed, "control": control,
               "coeff_bits": bits or cell.model["coeff_bits"],
               "taps": str(taps or cell.model["taps"]),
               "correct": res["correct"],
               **{k: v["value"] for k, v in res["checks"].items()},
               "checked_batches": res["_batches"]["checked"],
               "checked_rows": min(check_rows, cell.traffic.get(
                   "batch", cell.traffic.get("max_batch", 0))),
               "window_batches": res["_batches"]["window"],
               "seconds": time.perf_counter() - t0}


def _lm_readings(cell, seeds, seconds, control, device, root, check_every):
    from kanbench import lm_run
    kind = "fp8" if control else None
    for seed in seeds:
        t0 = time.perf_counter()
        res = lm_run.run(cell, seed, seconds, False, device=device,
                         control=kind, root=root, check_every=check_every)
        info = res["_batches"]
        yield {"cell": cell.name, "seed": seed, "control": kind,
               "weights": "float8_e4m3fn" if kind else "float32",
               "correct": res["correct"],
               **{k: v["value"] for k, v in res["checks"].items()},
               "checked_requests": info["checked"],
               "checked_steps": info["steps_checked"],
               "completed": info["completed"],
               "share_past": info["share_past"],
               "window_steps": info["window"],
               "seconds": time.perf_counter() - t0}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--taps-seeds", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out")
    ap.add_argument("--check-every", type=int)
    ap.add_argument("--check-rows", type=int, default=bench.CHECK_ROWS)
    args = ap.parse_args(argv)
    cell = resolve.cell(bench.ROOT, args.workload)
    if not torch.cuda.is_available():
        print("kanbench.control: needs a CUDA device", file=sys.stderr)
        return 2
    out = open(args.out, "a") if args.out else None
    try:
        for seeds, control in ((args.seeds, None),
                               (args.control_seeds, "codes"),
                               (args.taps_seeds, "taps")):
            ints = [int(s) for s in seeds.split(",") if s]
            for rec in readings(cell, ints, args.seconds, control,
                                check_every=args.check_every,
                                check_rows=args.check_rows):
                line = json.dumps(rec)
                print(line, flush=True)
                if out:
                    out.write(line + "\n")
                    out.flush()
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
