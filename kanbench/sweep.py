"""The knee of an open-loop cell: its run at each of several rates and
seeds, in one process, on the card:

    python3 -m kanbench.sweep --workload <open-loop cell> \\
        --rates 10000,20000,30000 --seeds 1,2,3 --seconds 51 \\
        [--out knee.jsonl]

Each rate replaces the traffic file's ``rate``; everything else is the
cell's. One JSON line a rate and seed: the users a second served, a
user's latency (due to ids on the host: median, mean, p95) and the p95 of
the server's lateness (due to taken), the backlog when the window closed,
the slope of the backlog read every second of the window, and
``correct``. The knee is the highest rate at which, on every seed, the p95
meets the cell's latency limit and the backlog grew by less than one full
batch over the window (slope times window); the cell runs at a fixed
share of it (PERF.md §4). The benchmark's own runs never sweep.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import torch

from kanbench import resolve
from kanbench import run as bench


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seeds", default="1")
    ap.add_argument("--seconds", type=float, default=51.0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    cell = resolve.cell(bench.ROOT, args.workload)
    if not torch.cuda.is_available():
        print("kanbench.sweep: needs a CUDA device", file=sys.stderr)
        return 2
    for rate, seed in ((float(r), int(s)) for r in args.rates.split(",")
                       for s in args.seeds.split(",")):
        c = dataclasses.replace(cell, traffic=dict(cell.traffic, rate=rate))
        res = bench.run(c, seed, args.seconds, False)
        m = {k: v["value"] for k, v in res["metrics"].items()}
        line = json.dumps({**m, **res["generator"], "rate": rate,
                           "seed": seed, "correct": res["correct"],
                           "batches": res["_batches"]["window"],
                           "window_s": res["_batches"]["window_s"]})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
