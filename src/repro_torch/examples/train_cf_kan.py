"""End-to-end example: train CF-KAN with QAT and evaluate it on simulated
RRAM-ACIM hardware, the paper's §4 pipeline (port of
``examples/train_cf_kan.py``, with the same flags and defaults).

    PYTHONPATH=src python -m repro_torch.examples.train_cf_kan \
        [--steps 300] [--device cpu]

Steps: synthetic Anime-like interactions -> QAT training with plain SGD
(``train``) -> Recall@20/NDCG@20 float vs ASP-quantised (``evaluate``) ->
CIM simulation with uniform vs KAN-SAM mapping across array sizes, the
Fig. 18 protocol, and the Fig. 19 cost-model readout (``fig18``). The
functions run where the params lie. The backend is ``CFKANConfig.backend``.

The command line takes the JAX example's flags and ``--device``: without
it ``main`` runs on the card and raises if there is none, as every entry
point of the package does; ``--device cpu`` runs it on the CPU.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Callable, Dict, List, Optional

import torch

from repro_torch import resolve_device
from repro_torch.core import kan
from repro_torch.core.quant import ASPConfig
from repro_torch.data import cf_synth
from repro_torch.hw import cim, cost_model
from repro_torch.models import cf_kan

ARRAY_SIZES = (128, 256, 512, 1024)
BATCH = 64


@dataclasses.dataclass
class TrainResult:
    params: Dict
    losses: List[float]     # the loss of every step, before its update


def _device_of(params) -> torch.device:
    return params["enc"]["coeffs"].device


def _upload(xb, device: torch.device) -> torch.Tensor:
    """A numpy batch onto ``device``; to the card from pinned memory, so
    that the copy waits for none of the work queued before it."""
    x = torch.from_numpy(xb)
    if device.type == "cuda":
        x = x.pin_memory().to(device, non_blocking=True)
    return x


def train(params: Dict, cfg: cf_kan.CFKANConfig, train_ds, *, steps: int,
          lr: float = 2e-2,
          on_step: Optional[Callable[[int, torch.Tensor], None]] = None
          ) -> TrainResult:
    """QAT training with plain SGD ``p - lr * g`` over
    ``cf_synth.batches(train_ds, BATCH, seed=step)``, the seed being the
    step at which each pass over the data starts. ``params`` is not
    changed; the trained copy is returned with each step's loss. The loop
    never waits for the card: the losses stay on it until the end, and
    ``on_step(step, loss)``, called after each update, is the caller's."""
    device = _device_of(params)
    params = {name: {k: p.detach().clone().requires_grad_()
                     for k, p in layer.items()}
              for name, layer in params.items()}
    leaves = [p for layer in params.values() for p in layer.values()]
    losses = []
    step = 0
    while step < steps:
        for xb in cf_synth.batches(train_ds, BATCH, seed=step):
            x = _upload(xb, device)
            loss = cf_kan.multinomial_loss(params, x, cfg, qat=True)
            grads = torch.autograd.grad(loss, leaves)
            with torch.no_grad():
                for p, g in zip(leaves, grads):
                    p.sub_(lr * g)
            losses.append(loss.detach())
            step += 1
            if on_step is not None:
                on_step(step, loss.detach())
            if step >= steps:
                break
    trained = {name: {k: p.detach() for k, p in layer.items()}
               for name, layer in params.items()}
    return TrainResult(trained, torch.stack(losses).tolist())


@torch.no_grad()
def evaluate(params: Dict, cfg: cf_kan.CFKANConfig, val_ds
             ) -> Dict[str, float]:
    """Recall@20 and NDCG@20 of the float model (the ``ref`` backend) and
    of the ASP-quantised one (``qat=True`` on ``cfg.backend``)."""
    device = _device_of(params)
    xv = torch.from_numpy(val_ds.observed).to(device)
    hv = torch.from_numpy(val_ds.held_out).to(device)
    s_float = cf_kan.apply(params, xv, dataclasses.replace(cfg,
                                                           backend="ref"))
    s_quant = cf_kan.apply(params, xv, cfg, qat=True)
    return {"recall_float": float(cf_kan.recall_at_k(s_float, hv, xv)),
            "recall_asp": float(cf_kan.recall_at_k(s_quant, hv, xv)),
            "ndcg_float": float(cf_kan.ndcg_at_k(s_float, hv, xv)),
            "ndcg_asp": float(cf_kan.ndcg_at_k(s_quant, hv, xv))}


@torch.no_grad()
def fig18(params: Dict, cfg: cf_kan.CFKANConfig, ds, train_ds):
    """The Fig. 18 protocol on the trained weights: every user's scores
    through the ``cim`` crossbar (gamma0 0.08), uniform and KAN-SAM mapping
    (Phase-A stats from the training users in batches of 128), each
    deployed once per As, against the quantised digital scores: the mean
    relative score error and the Recall@20 drop. Returns the rows and the
    Fig. 19 cost of ``cfg.n_params``."""
    device = _device_of(params)
    stats = cf_kan.collect_layer_stats(
        params, [torch.from_numpy(b).to(device)
                 for b in cf_synth.batches(train_ds, 128)], cfg)
    x_all = torch.from_numpy(ds.observed).to(device)
    h_all = torch.from_numpy(ds.held_out).to(device)
    s_ref = cf_kan.apply(params, x_all, cfg, qat=True)
    r_ref = float(cf_kan.recall_at_k(s_ref, h_all, x_all))
    norm = float(torch.mean(torch.abs(s_ref)))
    rows = []
    for as_ in ARRAY_SIZES:
        ccfg = cim.CIMConfig(array_size=as_, gamma0=0.08)
        row = {"As": as_}
        for name, sam in (("uniform", False), ("sam", True)):
            dep = cf_kan.deploy(params, cfg, cim_cfg=ccfg, use_sam=sam,
                                stats=stats if sam else None)
            s = kan.apply(dep, x_all)
            row[f"err_{name}"] = float(torch.mean(torch.abs(s - s_ref))) / norm
            row[f"recall_deg_{name}"] = max(
                r_ref - float(cf_kan.recall_at_k(s, h_all, x_all)), 0.0)
        rows.append(row)
    return rows, cost_model.accelerator_cost(cfg.n_params)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--items", type=int, default=512)
    ap.add_argument("--users", type=int, default=1024)
    ap.add_argument("--hidden", type=int, default=32)
    ap.add_argument("--grid", type=int, default=7)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--lr", type=float, default=2e-2)
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' runs on the CPU")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = cf_kan.CFKANConfig(
        n_items=args.items, hidden=args.hidden,
        asp_enc=ASPConfig(grid_size=args.grid),
        asp_dec=ASPConfig(grid_size=args.grid), name="cf-kan-demo")
    print(f"CF-KAN: {cfg.n_items} items, hidden {cfg.hidden}, G={args.grid} "
          f"-> {cfg.n_params/1e6:.2f}M params, backend {cfg.backend}, on "
          f"{device}")

    ds = cf_synth.generate(n_users=args.users, n_items=args.items, seed=0)
    train_ds, val_ds = cf_synth.split(ds)
    params = cf_kan.init(0, cfg, device=device)
    t0 = time.time()

    def log(step, loss):
        if step % 50 == 0:
            print(f"step {step}: loss={float(loss):.4f} "
                  f"({time.time() - t0:.0f}s)", flush=True)

    params = train(params, cfg, train_ds, steps=args.steps, lr=args.lr,
                   on_step=log).params

    m = evaluate(params, cfg, val_ds)
    r_f, r_q = m["recall_float"], m["recall_asp"]
    print(f"\nfloat:     Recall@20={r_f:.4f} NDCG@20={m['ndcg_float']:.4f}")
    print(f"ASP-8bit:  Recall@20={r_q:.4f} "
          f"(degradation {100*(r_f-r_q)/max(r_f,1e-9):.2f}%)")

    print("\nFig.18 protocol — degradation under RRAM-ACIM (uniform vs "
          "KAN-SAM mapping):")
    print("  score-err = relative score error vs the quantized-digital "
          "baseline (continuous, low-noise);")
    print("  recall-deg = Recall@20 drop (granularity ~1/(users*heldout): "
          "noisy at demo scale)")
    rows, c = fig18(params, cfg, ds, train_ds)
    for r in rows:
        print(f"  As={r['As']:4d}: score-err uniform={r['err_uniform']:.4f} "
              f"SAM={r['err_sam']:.4f} "
              f"({r['err_uniform']/max(r['err_sam'],1e-9):.2f}x) | "
              f"recall-deg uniform={r['recall_deg_uniform']:.4f} "
              f"SAM={r['recall_deg_sam']:.4f}")
    print(f"\nFig.19 cost model @22nm: {c.area_mm2:.2f} mm^2, "
          f"{c.power_w*1e3:.1f} mW, {c.latency_ns:.0f} ns, "
          f"{c.energy_nj:.1f} nJ")


if __name__ == "__main__":
    main()
