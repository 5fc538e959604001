"""KAN-NeuroSim hyperparameter optimization framework (paper §3.4, Fig. 11;
a copy of ``repro.hw.neurosim``: pure Python over ``hw.cost_model``, so the
port makes the same decisions).

Two-stage process:

Stage 1 (brown path in Fig. 11) — hardware-constraint screening: given a
hardware budget (area/power/latency/energy) and KAN architecture parameters
(topology, K, G), evaluate the cost model; while the budget is violated,
shrink G (finest knob) until compliant or infeasible.

Stage 2 — grid-extension training: train; every ``extend_every`` epochs,
tentatively extend G by E (coefficients refit, core.grid_extension). Keep the
extension only if (a) validation loss improved since the last extension and
(b) the NeuroSim cost model still satisfies the budget; otherwise revert to
G_pre and stop extending (paper: "the grid extension process is terminated,
with the system reverting to the preceding G_pre configuration").

RRAM non-idealities (partial-sum error statistics) enter through the val
evaluation hook — callers evaluate under hw.cim simulation so the chosen G
is optimal *on hardware*, not in float.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional

from repro_torch.core.quant import ASPConfig
from repro_torch.hw import cost_model

Params = object


@dataclasses.dataclass
class NeuroSimLog:
    epoch: int
    grid_size: int
    val_loss: float
    cost: cost_model.AcceleratorCost
    action: str


@dataclasses.dataclass
class NeuroSimResult:
    params: Params
    asp: ASPConfig
    history: List[NeuroSimLog]
    feasible: bool


def screen_constraints(asp: ASPConfig, budget: cost_model.HardwareBudget,
                       count_params: Callable[[ASPConfig], int],
                       n_channels: int, mode: str = "TD-A",
                       min_g: int = 2) -> Optional[ASPConfig]:
    """Stage 1: shrink G until the cost model satisfies the budget."""
    g = asp.grid_size
    while g >= min_g:
        cand = asp.with_grid(g)
        cost = cost_model.kan_model_cost(count_params(cand), cand,
                                         n_channels, mode)
        if budget.satisfied_by(cost):
            return cand
        g -= 1
    return None


def grid_extension_training(
    params: Params,
    asp: ASPConfig,
    *,
    train_epochs: Callable[[Params, ASPConfig, int], Params],
    val_loss: Callable[[Params, ASPConfig], float],
    extend_coeffs: Callable[[Params, ASPConfig, ASPConfig], Params],
    count_params: Callable[[ASPConfig], int],
    budget: cost_model.HardwareBudget = cost_model.HardwareBudget(),
    n_channels: int = 1,
    mode: str = "TD-A",
    extend_every: int = 1,
    extend_by: int = 2,
    max_epochs: int = 8,
    max_grid: int = 64,
) -> NeuroSimResult:
    """Stage 2 training loop with budget-guarded grid extension."""
    history: List[NeuroSimLog] = []
    best_val = float("inf")
    extension_live = True
    epoch = 0
    while epoch < max_epochs:
        params = train_epochs(params, asp, extend_every)
        epoch += extend_every
        v = float(val_loss(params, asp))
        cost = cost_model.kan_model_cost(count_params(asp), asp,
                                         n_channels, mode)
        improved = v < best_val
        best_val = min(best_val, v)
        history.append(NeuroSimLog(epoch, asp.grid_size, v, cost, "train"))

        if not extension_live or epoch >= max_epochs:
            continue
        g_new = asp.grid_size + extend_by
        if not improved or g_new > max_grid:
            extension_live = False
            history.append(NeuroSimLog(epoch, asp.grid_size, v, cost,
                                       "extension-stopped"))
            continue
        asp_new = asp.with_grid(g_new)
        cost_new = cost_model.kan_model_cost(count_params(asp_new), asp_new,
                                             n_channels, mode)
        if not budget.satisfied_by(cost_new):
            extension_live = False
            history.append(NeuroSimLog(epoch, asp.grid_size, v, cost,
                                       "extension-rejected-budget"))
            continue
        params = extend_coeffs(params, asp, asp_new)
        asp = asp_new
        history.append(NeuroSimLog(epoch, asp.grid_size, v, cost_new,
                                   "extended"))
    return NeuroSimResult(params=params, asp=asp, history=history,
                          feasible=True)
