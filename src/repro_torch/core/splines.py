"""B-spline machinery for KAN layers (port of ``repro.core.splines``).

* ``bspline_basis`` — the generic Cox–de Boor recursion over an explicit
  knot vector: the oracle of the tests and of grid-extension refits.
* ``cardinal_taps`` — the uniform-grid specialisation: for a point with
  local coordinate ``u`` inside any knot interval, the K+1 active basis
  values depend only on ``u`` (translation invariance of uniform
  B-splines). The ASP-KAN-HAQ SH-LUT (quant.py) samples these taps at the
  aligned quantisation midpoints.

Conventions: a KAN edge spline over ``[x_min, x_max]`` with grid size ``G``
and order ``K`` has ``G + K`` basis functions over the uniformly extended
knot vector ``t_i = x_min + (i - K) h``, ``h = (x_max - x_min) / G``. For x in
segment ``s`` the active bases are ``B_s .. B_{s+K}``; tap ``t`` is basis
``s + t`` with value ``M_K(u + K - t)``.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def true_div(a: torch.Tensor, b: float) -> torch.Tensor:
    """``a / b`` as one IEEE f32 division. Dividing a CUDA tensor by a Python
    number multiplies by its reciprocal instead, which can move a
    quantisation code by one against the reference."""
    return a / torch.full((), b, dtype=a.dtype, device=a.device)


def make_knots(x_min: float, x_max: float, grid_size: int, order: int
               ) -> np.ndarray:
    """Uniformly extended knot vector t_0 .. t_{G+2K} (numpy, host side)."""
    h = (x_max - x_min) / grid_size
    i = np.arange(grid_size + 2 * order + 1, dtype=np.float64)
    return x_min + (i - order) * h


def bspline_basis(x: torch.Tensor, knots, order: int) -> torch.Tensor:
    """Cox–de Boor: all G+K basis values at each point. x: [...];
    knots: [G + 2K + 1] (uniformly extended). Returns [..., G+K] (rows sum
    to 1 inside the grid range)."""
    dtype = torch.promote_types(x.dtype, torch.float32)
    knots = torch.as_tensor(knots, dtype=dtype, device=x.device)
    x = x[..., None].to(dtype)
    # degree 0: the indicator of [t_i, t_{i+1}), one per knot interval
    b = ((x >= knots[:-1]) & (x < knots[1:])).to(dtype)
    for k in range(1, order + 1):
        t_i, t_ik = knots[:-(k + 1)], knots[k:-1]
        t_i1, t_ik1 = knots[1:-k], knots[k + 1:]
        left = (x - t_i) / (t_ik - t_i) * b[..., :-1]
        right = (t_ik1 - x) / (t_ik1 - t_i1) * b[..., 1:]
        b = left + right
    return b


def cardinal_taps(u: torch.Tensor, order: int) -> torch.Tensor:
    """K+1 active uniform-B-spline values at local coordinate u in [0, 1).

    ``taps[..., t] = M_K(u + K - t)``. Recurrence (uniform de Boor), A_0=[1]:
    A_k[t] = ((u + k - t) / k) A_{k-1}[t-1] + ((1 - u + t) / k) A_{k-1}[t].
    """
    taps = [torch.ones_like(u)]
    for k in range(1, order + 1):
        nxt = []
        for t in range(k + 1):
            acc = torch.zeros_like(u)
            if 0 <= t - 1 < k:
                acc = acc + true_div(u + k - t, k) * taps[t - 1]
            if t < k:
                acc = acc + true_div(1.0 - u + t, k) * taps[t]
            nxt.append(acc)
        taps = nxt
    return torch.stack(taps, dim=-1)


def locate(x: torch.Tensor, x_min: float, x_max: float, grid_size: int
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Float-path (segment int32 in [0, G-1], u in [0, 1]); points outside
    the range clamp to the first/last segment. ``u`` is clipped by a
    maximum, then a minimum, as ``jnp.clip`` does, so that its gradient is
    JAX's: 1/2 where ``u`` lands exactly on 0 or 1 (a knot, or a range
    end), where ``torch.clamp`` would pass all of it."""
    h = (x_max - x_min) / grid_size
    z = true_div(x - x_min, h)
    seg = torch.clamp(torch.floor(z), 0, grid_size - 1).to(torch.int32)
    u = torch.minimum(torch.maximum(z - seg, z.new_zeros(())),
                      z.new_ones(()))
    return seg, u


def basis_from_taps(seg: torch.Tensor, taps: torch.Tensor, grid_size: int,
                    order: int) -> torch.Tensor:
    """Route K+1 taps into the dense [..., G+K] basis vector by comparing
    against an iota and adding (no scatter); keeps the taps' dtype."""
    n_basis = grid_size + order
    i = torch.arange(n_basis, dtype=torch.int32, device=seg.device)
    t = i - seg[..., None]
    out = torch.zeros(taps.shape[:-1] + (n_basis,), dtype=taps.dtype,
                      device=taps.device)
    zero = torch.zeros((), dtype=taps.dtype, device=taps.device)
    for tap in range(order + 1):
        out = out + torch.where(t == tap, taps[..., tap:tap + 1], zero)
    return out


def bspline_basis_uniform(x: torch.Tensor, x_min: float, x_max: float,
                          grid_size: int, order: int) -> torch.Tensor:
    """Dense [..., G+K] basis via the cardinal-taps path (float oracle)."""
    seg, u = locate(x, x_min, x_max, grid_size)
    taps = cardinal_taps(u, order)
    return basis_from_taps(seg, taps, grid_size, order)


def spline_eval_reference(x: torch.Tensor, coeffs: torch.Tensor,
                          x_min: float, x_max: float, grid_size: int,
                          order: int) -> torch.Tensor:
    """Reference spline(x) = sum_i c_i B_i(x) for a single edge.
    x: [...], coeffs: [G+K] -> [...]."""
    basis = bspline_basis_uniform(x, x_min, x_max, grid_size, order)
    return torch.einsum("...i,i->...", basis, coeffs)


def lstsq_fit_coeffs(x: torch.Tensor, y: torch.Tensor, x_min: float,
                     x_max: float, grid_size: int, order: int,
                     reg: float = 1e-8) -> torch.Tensor:
    """Least-squares fit of spline coefficients to (x, y) samples, through
    the regularised normal equations. x: [N], y: [N, ...out] ->
    coeffs [G+K, ...out]."""
    a = bspline_basis_uniform(x, x_min, x_max, grid_size, order)  # [N, G+K]
    ata = a.T @ a + reg * torch.eye(a.shape[-1], dtype=a.dtype,
                                    device=a.device)
    sol = torch.linalg.solve(ata, a.T @ y.reshape(y.shape[0], -1))
    return sol.reshape((a.shape[-1],) + tuple(y.shape[1:]))
