"""Algorithm 2: sensitivity-based grid assignment for KAN-NeuroSim (§3.4;
port of ``repro.core.sensitivity``).

Phase 1 — after warm-up training, each layer's sensitivity is the
validation expectation of the mean squared gradient of the loss with
respect to that layer's spline coefficients:

    S_i = E_val[ (1/M_i) * sum_j (dL/dc_ij)^2 ]

Phase 2 — percentile classes (top 33% HIGH, middle MEDIUM, bottom 33% LOW)
and the grid templates G_high / G_med / G_low.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Mapping, Sequence

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class GridAssignment:
    sensitivities: Dict[str, float]
    classes: Dict[str, str]          # layer -> "HIGH" | "MEDIUM" | "LOW"
    grids: Dict[str, int]            # layer -> assigned G


def _flatten_with_paths(tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    """Leaves of nested dicts and lists by their '/'-joined keys/indices."""
    if isinstance(tree, Mapping):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(_flatten_with_paths(v, f"{prefix}/{k}" if prefix
                                       else str(k)))
    return out


def _replace_paths(tree, new: Mapping[str, torch.Tensor], prefix: str = ""):
    """A copy of the tree's containers with the leaves at ``new``'s paths
    replaced (the other leaves shared)."""
    if isinstance(tree, Mapping):
        return {k: _replace_paths(v, new, f"{prefix}/{k}" if prefix
                                  else str(k)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_replace_paths(v, new, f"{prefix}/{i}" if prefix else str(i))
                for i, v in enumerate(tree)]
    return new.get(prefix, tree)


def layer_sensitivities(loss_fn: Callable, params, val_batches,
                        coeff_paths: Sequence[str]) -> Dict[str, float]:
    """Phase 1. ``coeff_paths`` are '/'-joined paths into the param tree
    (nested dicts and lists) selecting each layer's spline coefficients;
    ``loss_fn(params, *batch)`` is differentiated by ``torch.autograd``
    with respect to those leaves only, averaged over ``val_batches``."""
    flat = _flatten_with_paths(params)
    acc = {p: 0.0 for p in coeff_paths}
    n = 0
    for batch in val_batches:
        leaves = {p: flat[p].detach().requires_grad_() for p in coeff_paths}
        loss = loss_fn(_replace_paths(params, leaves), *batch)
        grads = torch.autograd.grad(loss, list(leaves.values()),
                                    allow_unused=True)
        for p, g in zip(coeff_paths, grads):
            if g is not None:    # a leaf the loss does not reach: zero
                acc[p] += float(torch.mean(g.to(torch.float32) ** 2))
        n += 1
    return {p: v / max(n, 1) for p, v in acc.items()}


def assign_grids(sens: Dict[str, float], *, g_high: int, g_med: int,
                 g_low: int) -> GridAssignment:
    """Phase 2: percentile thresholds at 67/33 (Alg. 2 lines 6-20)."""
    names = list(sens.keys())
    vals = np.array([sens[n] for n in names])
    tau_high = np.percentile(vals, 67)
    tau_low = np.percentile(vals, 33)
    classes, grids = {}, {}
    for n, s in zip(names, vals):
        if s >= tau_high:
            classes[n], grids[n] = "HIGH", g_high
        elif s >= tau_low:
            classes[n], grids[n] = "MEDIUM", g_med
        else:
            classes[n], grids[n] = "LOW", g_low
    return GridAssignment(sensitivities=dict(zip(names, map(float, vals))),
                          classes=classes, grids=grids)
