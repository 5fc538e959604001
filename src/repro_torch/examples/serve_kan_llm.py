"""Serve a KAN-FFN LLM under continuous batching (port of
``examples/serve_kan_llm.py``): the paper's §1 thesis (KAN replacing the
transformer MLP blocks) behind the serving engine. The engine freezes the
KAN artifacts once at construction (``transformer.deploy_kan``: int8 codes,
scales, SH-LUT), then staggered arrivals join a running batch
(``repro_torch.serve.engine``: chunked prefill, fused multi-slot decode,
EOS/length eviction) with a decode tick that never requantises.

    PYTHONPATH=src python -m repro_torch.examples.serve_kan_llm \
        [--device cpu] [--backend fused]

The reference's trace: 12 requests every 2 ticks, 4 slots, ``MAX_LEN``
96, ``seed=0``. Without ``--device`` it runs on the card and raises if
there is none; ``--backend`` (default: the config's ``lut``) picks the KAN
backend, ``fused`` being the ``kan_fused`` kernel.
"""
from __future__ import annotations

import argparse
import dataclasses
import json

import numpy as np

from repro_torch import resolve_device
from repro_torch.configs import get_arch
from repro_torch.core import kan
from repro_torch.models import transformer as tfm
from repro_torch.serve.engine import Engine, synth_trace
from repro_torch.serve.scheduler import AdmissionQueue

SLOTS, MAX_LEN = 4, 64 + 32


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' runs on the CPU")
    ap.add_argument("--backend", default=None,
                    help="KAN backend (default: the config's)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = get_arch("kan_llm").model       # 4L d=256 KAN-FFN registry arch
    if args.backend:
        cfg = dataclasses.replace(cfg, kan_backend=args.backend)
    params = tfm.init_model(0, cfg, device=device)
    n = tfm.count_params(params)
    print(f"model: {cfg.n_layers}L d={cfg.d_model} KAN-FFN(G={cfg.kan_grid}, "
          f"backend={cfg.kan_backend}) -> {n/1e6:.1f}M params on {device}")

    # 12 requests arriving every 2 ticks, heterogeneous prompt lengths and
    # budgets, served by a 4-slot pool: requests join and leave the batch
    reqs = synth_trace(cfg.vocab, 12, max_prompt=64, min_prompt=24,
                       max_new=24, min_new=8, stagger=2, seed=0)
    eng = Engine(params, cfg, n_slots=SLOTS, max_len=MAX_LEN,
                 queue=AdmissionQueue(max_pending=32), device=device)
    if not eng.kan_deployed:
        raise RuntimeError("the engine must freeze the KAN artifacts at "
                           "construction")
    art = eng.params["stages"][0]["l0"]["kan"]
    if not isinstance(art, kan.DeployedKAN):
        raise RuntimeError(f"stage 0 serves {type(art).__name__}, not a "
                           "DeployedKAN")
    print(f"deployed once: backend={art.spec.backend}, per-layer codes "
          f"{tuple(art.layers[0].codes.shape)} int8 + SH-LUT "
          f"{tuple(art.layers[0].hemi.shape)}")
    comps = eng.run(reqs)

    rep = eng.stats.report()
    print(json.dumps(rep, indent=1))
    if rep["completed"] != len(reqs):
        raise RuntimeError(f"{rep['completed']} of {len(reqs)} completed")
    if rep["slot_reuse"] <= 1:
        raise RuntimeError("expected slot reuse over 12 requests / 4 slots")
    first = min(comps, key=lambda c: c.rid)
    print(f"rid={first.rid} ({first.reason}):",
          np.asarray(first.tokens)[:12].tolist())
    print(f"{rep['tokens_per_s']} tok/s, occupancy {rep['mean_occupancy']}")
    print("OK")
    return rep


if __name__ == "__main__":
    main()
