"""KAN-SAM: KAN sparsity-aware weight mapping (paper §3.3, Algorithm 1;
port of ``repro.core.kan_sam``).

Every crossbar row (one per (input channel, basis) pair of the expanded
coefficient matrix) is scored by how often, how strongly and how stably its
basis fires; high-criticality rows go to the physical rows nearest the
bit-line clamp, where IR drop is smallest.

  A — per basis: activation count, sum and sum of squares of the basis
      value over the training set.
  C — C_w = alpha J + beta S J with J = p mu |c'|_Q and S = 1 / (1 + CV).
  Mapping — sort by C_w descending (stable), assign rows nearest first.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import quant
from repro_torch.core.quant import ASPConfig
from repro_torch.core.splines import true_div


@dataclasses.dataclass
class BasisStats:
    """Streaming Phase-A statistics per (input channel, basis) = row."""
    cnt: torch.Tensor   # [I, S] activation counts
    s1: torch.Tensor    # [I, S] sum of basis values
    s2: torch.Tensor    # [I, S] sum of squared basis values
    n_samples: int

    @property
    def p(self) -> torch.Tensor:
        return true_div(self.cnt, max(self.n_samples, 1))

    @property
    def mu(self) -> torch.Tensor:
        return self.s1 / torch.clamp(self.cnt, min=1.0)

    @property
    def var(self) -> torch.Tensor:
        m = self.mu
        return torch.clamp(self.s2 / torch.clamp(self.cnt, min=1.0) - m * m,
                           min=0.0)


def init_stats(in_dim: int, asp: ASPConfig, device) -> BasisStats:
    z = torch.zeros((in_dim, asp.n_basis), dtype=torch.float32,
                    device=device)
    return BasisStats(cnt=z, s1=z, s2=z, n_samples=0)


def update_stats(stats: BasisStats, x: torch.Tensor, asp: ASPConfig,
                 hemi: Optional[torch.Tensor] = None) -> BasisStats:
    """Phase A accumulation for one batch. x: [B, I] (bounded to range)."""
    if hemi is None:
        hemi = quant.hemi_for(asp, x.device)
    basis = quant.quantized_basis(x, hemi, asp)       # [B, I, S], >= 0
    active = (basis > 0).to(torch.float32)
    return BasisStats(cnt=stats.cnt + active.sum(dim=0),
                      s1=stats.s1 + basis.sum(dim=0),
                      s2=stats.s2 + (basis * basis).sum(dim=0),
                      n_samples=stats.n_samples + x.shape[0])


def collect_stats(batches: Iterable[torch.Tensor], asp: ASPConfig,
                  in_dim: int, device=None) -> BasisStats:
    """Phase A over a stream of bounded batches [B, I] on ``device``
    (``None``: the card)."""
    stats = init_stats(in_dim, asp, resolve_device(device))
    for x in batches:
        stats = update_stats(stats, x, asp)
    return stats


def criticality(stats: BasisStats, coeff_codes: torch.Tensor, *,
                alpha: float = 0.5, beta: float = 0.5,
                eps: float = 1e-6) -> torch.Tensor:
    """Phase C: criticality per crossbar row. coeff_codes: [I, S, O] int8
    (a row's magnitude is its mean |code| over the O columns).
    Returns C_w [I, S] f32."""
    if not np.isclose(alpha + beta, 1.0):
        raise ValueError("Algorithm 1 requires alpha + beta = 1")
    p = stats.p
    mu = stats.mu
    sigma = torch.sqrt(stats.var)
    cv = sigma / (mu + eps)
    s_stab = torch.reciprocal(1.0 + cv)             # monotone squash to (0,1]
    # an exact sum of integers, then one true division (torch.mean would
    # multiply by 1/O)
    mag = true_div(torch.abs(coeff_codes.to(torch.float32)).sum(dim=-1),
                   coeff_codes.shape[-1])
    j_contrib = p * mu * mag
    return alpha * j_contrib + beta * s_stab * j_contrib


def row_mapping(c_w: torch.Tensor, row_order: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sort rows by criticality (high -> low, ties by index) and assign them
    to physical rows in ``row_order`` (default 0..R-1, row 0 next to the
    clamp). Returns (phys_of_logical [R], logical_of_phys [R]) int32."""
    r = c_w.numel()
    if row_order is None:
        row_order = torch.arange(r, device=c_w.device)
    order = torch.argsort(-c_w.reshape(-1), stable=True)
    phys_of_logical = torch.zeros(r, dtype=torch.int32, device=c_w.device)
    phys_of_logical[order] = row_order.to(torch.int32)
    logical_of_phys = torch.argsort(phys_of_logical, stable=True)
    return phys_of_logical, logical_of_phys.to(torch.int32)


def sam_row_map(c_w: torch.Tensor, atten_by_position: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The KAN-SAM mapping: ``(phys_of_logical [R] int32, atten_of_logical
    [R] f32)``. The nearest-first row order sorts physical rows by
    descending attenuation with numpy's stable argsort (one near slot per
    array comes before any far slot); both outputs derive from the same
    permutation."""
    att_np = atten_by_position.detach().cpu().numpy()
    row_order = torch.as_tensor(np.argsort(-att_np, kind="stable"),
                                device=c_w.device)
    phys_of_logical, _ = row_mapping(c_w, row_order=row_order)
    return phys_of_logical, atten_by_position[phys_of_logical.long()]


def sam_attenuation(c_w: torch.Tensor, atten_by_position: torch.Tensor
                    ) -> torch.Tensor:
    """Effective per-logical-row attenuation under the KAN-SAM mapping,
    shaped like ``c_w`` [I, S]."""
    _, atten = sam_row_map(c_w, atten_by_position)
    return atten.reshape(c_w.shape)
