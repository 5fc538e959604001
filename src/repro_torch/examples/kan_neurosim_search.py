"""Per-layer operating-point search for CF-KAN, paper §3.4 and Fig. 19
(port of ``examples/kan_neurosim_search.py``, with its setting).

    PYTHONPATH=src python -m repro_torch.examples.kan_neurosim_search \\
        [--device cpu]

A thin command line over ``repro_torch.tune``:

1. train a small CF-KAN with QAT (128 items, hidden 16, G 8, 6 epochs of
   SGD at lr 3e-2 in batches of 32);
2. profile Algorithm-2 layer sensitivities on the QAT loss (``run``);
3. ``tune.search`` the per-layer (G, LD, coeff_bits) lattice, scoring each
   candidate by the DEPLOYED forward's validation Recall@20 against the
   calibrated mixed-precision cost model, with the first 16 validation
   users as the quick screen (``run``);
4. print the uniform-8-bit baseline and the Pareto frontier.

``run`` runs where the params lie. Without ``--device`` the command line
runs on the card and raises if there is none; ``--device cpu`` runs it on
the CPU.
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import Sequence

import torch

from repro_torch import resolve_device, tune
from repro_torch.core import kan, sensitivity
from repro_torch.core.quant import ASPConfig
from repro_torch.data import cf_synth
from repro_torch.models import cf_kan
from repro_torch.tune import space

N_ITEMS, HIDDEN, GRID, EPOCHS = 128, 16, 8, 6
N_USERS, BATCH, LR = 256, 32, 3e-2
QUICK_USERS = 16


def run(params, cfg: cf_kan.CFKANConfig, val_ds, *, backend: str,
        budget: int = 16, seed: int = 0,
        grids: Sequence[int] = space.DEFAULT_GRIDS) -> tune.TuneResult:
    """Algorithm-2 sensitivities of ``params`` (``sensitivity.
    layer_sensitivities`` of the QAT loss over ``val_ds`` in batches of
    32), then ``tune.search`` on ``backend``: ``score`` is the validation
    users' Recall@20 through the deployed candidate (``kan.apply``),
    ``quick`` the same on the first 16 users."""
    cfg = dataclasses.replace(cfg, backend=backend)
    device = params["enc"]["coeffs"].device
    xv = torch.from_numpy(val_ds.observed).to(device)
    hv = torch.from_numpy(val_ds.held_out).to(device)
    xq, hq = xv[:QUICK_USERS], hv[:QUICK_USERS]

    def loss(p, xb):
        return cf_kan.multinomial_loss(p, xb, cfg, qat=True)

    def score(dep):
        return float(cf_kan.recall_at_k(kan.apply(dep, xv), hv, xv, k=20))

    def quick(dep):
        return float(cf_kan.recall_at_k(kan.apply(dep, xq), hq, xq, k=20))

    batches = [(torch.from_numpy(b).to(device),)
               for b in cf_synth.batches(val_ds, BATCH)]
    sens = sensitivity.layer_sensitivities(loss, params, batches,
                                           ["enc/coeffs", "dec/coeffs"])
    return tune.search(params, cfg.kan_spec, score, sens=sens,
                       quick_fn=quick,
                       cfg=tune.TuneConfig(budget=budget, seed=seed,
                                           grids=tuple(grids)))


def train(cfg: cf_kan.CFKANConfig, train_ds, device):
    """The JAX example's QAT: ``init(0)``, then ``EPOCHS`` passes of plain
    SGD over ``cf_synth.batches(train_ds, 32, seed=epoch)``."""
    params = cf_kan.init(0, cfg, device=device)
    leaves = {(n, k): p.requires_grad_() for n, layer in params.items()
              for k, p in layer.items()}
    for e in range(EPOCHS):
        for xb in cf_synth.batches(train_ds, BATCH, seed=e):
            loss = cf_kan.multinomial_loss(
                params, torch.from_numpy(xb).to(device), cfg, qat=True)
            grads = torch.autograd.grad(loss, list(leaves.values()))
            with torch.no_grad():
                for p, g in zip(leaves.values(), grads):
                    p.sub_(LR * g)
    return {n: {k: p.detach() for k, p in layer.items()}
            for n, layer in params.items()}


def main(argv=None) -> tune.TuneResult:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' runs on the CPU")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = cf_kan.CFKANConfig(n_items=N_ITEMS, hidden=HIDDEN,
                             asp_enc=ASPConfig(grid_size=GRID),
                             asp_dec=ASPConfig(grid_size=GRID),
                             name="tune-demo")
    ds = cf_synth.generate(n_users=N_USERS, n_items=N_ITEMS, seed=1)
    train_ds, val_ds = cf_synth.split(ds)
    params = train(cfg, train_ds, device)
    result = run(params, cfg, val_ds, backend=cfg.backend, budget=16, seed=0)

    b = result.baseline
    print(f"uniform 8-bit baseline on {device}: recall@20={b.accuracy:.4f} "
          f"area={b.area_mm2:.4f}mm2 power={b.power_w:.3e}W")
    print(f"Pareto frontier ({len(result.frontier)} points, "
          f"{len(result.evaluated)} evaluated):")
    for c in result.frontier.points():
        pts = " ".join(f"(G={p.grid_size},LD={p.ld},b={p.coeff_bits})"
                       for p in c.assignment)
        tag = " [sub-8]" if c.sub8 else ""
        print(f"  recall@20={c.accuracy:.4f} area={c.area_mm2:.4f}mm2 "
              f"power={c.power_w:.3e}W  {pts}{tag}")
    best = result.best_sub8()
    if best is not None:
        print(f"\nbest sub-8 point saves "
              f"{100 * (1 - best.area_mm2 / b.area_mm2):.0f}% area / "
              f"{100 * (1 - best.power_w / b.power_w):.0f}% power at "
              f"{100 * max(0.0, 1 - best.accuracy / b.accuracy):.2f}% "
              f"accuracy loss")
    return result


if __name__ == "__main__":
    main()
