"""The ASP-KAN-HAQ arithmetic of a deployed KAN layer, worked out again in
plain PyTorch and NumPy (paper §3.1): the aligned input codes, the SH-LUT
and its reflection, the dense quantised basis, and the symmetric int8
coefficient codes with one scale per output channel.

Nothing here comes from the program under test. Where the program's result
is defined by f32 rounding (an input code, a coefficient code), the same
IEEE f32 operations are done here, so that both sides land on the same
integer; the contraction that follows is the reference's own, in float64.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


def div(a: torch.Tensor, b: float) -> torch.Tensor:
    """``a / b`` as one IEEE division in ``a``'s dtype (a CUDA tensor divided
    by a Python number is multiplied by its reciprocal instead)."""
    return a / torch.full((), b, dtype=a.dtype, device=a.device)


@dataclasses.dataclass(frozen=True)
class Spline:
    """One layer's quantised spline family: grid size G, order K, input bits
    n, the knot range and the coefficient bits."""
    grid_size: int
    order: int
    n_bits: int
    coeff_bits: int
    x_min: float = -1.0
    x_max: float = 1.0

    @property
    def ld(self) -> int:
        """Eq. (6): the largest LD with G * 2^LD <= 2^n (alignment)."""
        ld = 0
        while self.grid_size << (ld + 1) <= 1 << self.n_bits:
            ld += 1
        return ld

    @property
    def levels(self) -> int:
        """Quantisation levels per knot interval, L = 2^LD (PowerGap)."""
        return 1 << self.ld

    @property
    def n_levels(self) -> int:
        return self.grid_size * self.levels

    @property
    def n_basis(self) -> int:
        return self.grid_size + self.order

    @property
    def step(self) -> float:
        return (self.x_max - self.x_min) / self.n_levels


def bound(x: torch.Tensor, sp: Spline) -> torch.Tensor:
    """The scaled tanh that maps a layer's input into the knot range."""
    half = 0.5 * (sp.x_max - sp.x_min)
    mid = 0.5 * (sp.x_max + sp.x_min)
    return mid + half * torch.tanh(x.to(torch.float32))


def _taps64(u: np.ndarray, order: int) -> np.ndarray:
    """The K+1 nonzero uniform B-spline values at local coordinates u, by
    the uniform de Boor recursion, in float64: ``taps[..., t] = M_K(u + K -
    t)``."""
    taps = [np.ones_like(u)]
    for k in range(1, order + 1):
        nxt = []
        for t in range(k + 1):
            acc = np.zeros_like(u)
            if t >= 1:
                acc = acc + (u + k - t) / k * taps[t - 1]
            if t < k:
                acc = acc + (1.0 - u + t) / k * taps[t]
            nxt.append(acc)
        taps = nxt
    return np.stack(taps, axis=-1)


def tap_table(sp: Spline, device) -> torch.Tensor:
    """The taps of every local code [L, K+1] in f32 as the SH-LUT serves
    them: the lower ceil(L/2) rows sampled at the cell midpoints in float64
    and rounded to f32, the upper rows their mirror image (Symmetry:
    ``taps[L-1-l, t] == taps[l, K-t]``)."""
    levels = sp.levels
    half = (levels + 1) // 2
    u = (np.arange(half, dtype=np.float64) + 0.5) / levels
    hemi = _taps64(u, sp.order).astype(np.float32)
    upper = hemi[levels - 1 - np.arange(half, levels)][:, ::-1]
    return torch.tensor(np.concatenate([hemi, upper]), device=device)


def input_codes(xb: torch.Tensor, sp: Spline) -> torch.Tensor:
    """Bounded f32 inputs -> aligned integer codes in [0, G*L - 1]."""
    q = torch.floor(div(xb - sp.x_min, sp.step))
    return torch.clamp(q, 0, sp.n_levels - 1).to(torch.int64)


def dense_basis(xb: torch.Tensor, sp: Spline, table: torch.Tensor
                ) -> torch.Tensor:
    """The quantised basis [..., I, G+K] f32: each input's K+1 taps (its
    local code's row of the table) at the bases of its segment and the K
    after it, zero elsewhere."""
    q = input_codes(xb, sp)
    seg, local = q >> sp.ld, q & (sp.levels - 1)
    where = seg[..., None] + torch.arange(sp.order + 1, device=xb.device)
    out = torch.zeros(xb.shape + (sp.n_basis,), dtype=torch.float32,
                      device=xb.device)
    return out.scatter_(-1, where, table[local])


def quantize_coeffs(coeffs: torch.Tensor, sp: Spline):
    """Float coefficients [I, S, O] -> (int8 codes [I, S, O], f32 scale [O]):
    symmetric, one scale per output channel from its |max| over I and S,
    clipped at 2^(b-1) - 1, rounded half to even."""
    qmax = 2 ** (sp.coeff_bits - 1) - 1
    amax = torch.amax(torch.abs(coeffs), dim=(0, 1), keepdim=True)
    scale = div(torch.clamp(amax, min=1e-8), qmax)
    codes = torch.clamp(torch.round(coeffs / scale), -qmax, qmax)
    return codes.to(torch.int8), scale.reshape(-1)
