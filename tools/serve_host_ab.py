"""Host time of the port's single-card serving paths, to compare two trees
of ``src/repro_torch`` on one card.

Two measurements, each on the card:

* ``kan_llm`` at full width on ``fused`` through the continuous-batching
  engine: 16 slots, pages of 64, max_len 704, on ``synth_trace(4096, 64,
  min_prompt=128, max_prompt=512, common_prefix=128, min_new=16,
  max_new=64, stagger=1, seed=0)``. One warm-up run, then ``--runs`` timed
  runs on a fresh engine each: tokens/s (``EngineStats``) and wall ms per
  tick (the run's wall over its ticks, to a synchronize).
* mistral-nemo-12b at full width, ``--layers`` of its 40 layers: a 4 x
  2048 prefill, then ``--steps`` decode steps, each timed to its
  synchronize; the median ms a step.

Run it once per tree, with that tree's ``src`` first on the path::

    PYTHONPATH=<tree>/src python tools/serve_host_ab.py --out result.json

Prints one JSON object (and writes it to ``--out``): the tree's source
path, the card's name and power limit, and the numbers above.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import time

import numpy as np
import torch

from repro_torch.configs import kan_llm, mistral_nemo_12b
from repro_torch.data import lm_synth
from repro_torch.kernels import build
from repro_torch.models import transformer as tfm
from repro_torch.serve import decode
from repro_torch.serve.engine import Engine, synth_trace

ENGINE = dict(n_slots=16, page_size=64, max_len=704)
TRACE = dict(n_requests=64, min_prompt=128, max_prompt=512,
             common_prefix=128, min_new=16, max_new=64, stagger=1, seed=0)


def engine_runs(dev, runs: int) -> dict:
    """The kan_llm engine on fused: one warm-up run, then ``runs`` timed."""
    cfg = dataclasses.replace(kan_llm.CONFIG.model, kan_backend="fused")
    params = tfm.init_model(0, cfg, device=dev)
    out = []
    for i in range(runs + 1):
        eng = Engine(params, cfg, device=dev, **ENGINE)
        reqs = synth_trace(cfg.vocab, **TRACE)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        comps = eng.run(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        rep = eng.stats.report()
        assert len(comps) == TRACE["n_requests"], len(comps)
        if i:
            out.append(dict(tokens_per_s=rep["tokens_per_s"],
                            ticks=rep["ticks"], wall_s=wall,
                            ms_per_tick=1e3 * wall / rep["ticks"]))
    return dict(runs=out,
                tokens_per_s=float(np.median([r["tokens_per_s"]
                                              for r in out])),
                ms_per_tick=float(np.median([r["ms_per_tick"]
                                             for r in out])))


def mistral_decode(dev, layers: int, steps: int) -> dict:
    """mistral-nemo-12b's 4 x 2048 prefill, then ``steps`` decode steps."""
    cfg = dataclasses.replace(mistral_nemo_12b.CONFIG.model, n_layers=layers)
    data = lm_synth.batch_at(lm_synth.LMDataConfig(
        vocab=cfg.vocab, batch=4, seq_len=2048, seed=0), 0)
    prompt = torch.from_numpy(data["tokens"]).to(dev)
    params = tfm.init_model(0, cfg, device=dev)
    s = prompt.shape[1]
    logits, cache = decode.prefill(params, cfg, {"tokens": prompt},
                                   s + steps + 1, last_only=True)
    tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
    ms = []
    for i in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = decode.decode_step(params, cache, tok, s + i, cfg)
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
    return dict(layers=layers, step_ms=ms,
                step_ms_median=float(np.median(ms)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--runs", type=int, default=2)
    ap.add_argument("--layers", type=int, default=40)
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("serve_host_ab: no CUDA device")
    dev = torch.device("cuda")
    build.load()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()[0]
    res = dict(src=str(build.CSRC.parents[2]), card=smi,
               engine=engine_runs(dev, args.runs),
               mistral=mistral_decode(dev, args.layers, args.steps))
    line = json.dumps(res)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
