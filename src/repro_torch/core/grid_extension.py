"""Grid extension (original-KAN §2.5, used by KAN-NeuroSim §3.4; port of
``repro.core.grid_extension``).

During training G grows by a user step E; the finer grid's coefficients
are refit by least squares so that the extended spline reproduces the
coarse one. Grids are uniform over a fixed range, so one refit matrix M
with ``C_new = M @ C_old`` serves every edge:

    M = argmin_M || A_new M - A_old ||_F ,  A_g = basis matrix on dense samples
"""
from __future__ import annotations

import functools
from typing import Dict

import torch

from repro_torch.core import splines
from repro_torch.core.quant import ASPConfig


@functools.lru_cache(maxsize=32)
def _refit_matrix(g_old: int, g_new: int, order: int, x_min: float,
                  x_max: float, device: torch.device,
                  n_samples: int = 2048) -> torch.Tensor:
    """[S_new, S_old] f32, solved in f32 on the CPU from the regularised
    normal equations, and kept per device."""
    x = torch.linspace(x_min + 1e-4, x_max - 1e-4, n_samples)
    a_old = splines.bspline_basis_uniform(x, x_min, x_max, g_old, order)
    a_new = splines.bspline_basis_uniform(x, x_min, x_max, g_new, order)
    ata = a_new.T @ a_new + 1e-8 * torch.eye(a_new.shape[1])
    return torch.linalg.solve(ata, a_new.T @ a_old).to(device)


def extend_coeffs(coeffs: torch.Tensor, asp_old: ASPConfig,
                  asp_new: ASPConfig) -> torch.Tensor:
    """coeffs [I, S_old, O] -> [I, S_new, O], the same spline function."""
    if (asp_old.order != asp_new.order or asp_old.x_min != asp_new.x_min
            or asp_old.x_max != asp_new.x_max):
        raise ValueError("grid extension changes G only")
    m = _refit_matrix(asp_old.grid_size, asp_new.grid_size, asp_old.order,
                      asp_old.x_min, asp_old.x_max, coeffs.device)
    return torch.einsum("ts,iso->ito", m.to(coeffs.dtype), coeffs)


def extend_layer_params(params: Dict[str, torch.Tensor], asp_old: ASPConfig,
                        asp_new: ASPConfig) -> Dict[str, torch.Tensor]:
    """A layer's params with its coefficients refit onto ``asp_new``'s
    grid (the other leaves shared)."""
    out = dict(params)
    out["coeffs"] = extend_coeffs(params["coeffs"], asp_old, asp_new)
    return out
