"""The RRAM-ACIM crossbar and the multi-tile chip (paper §3.3, §4.C,
Fig. 18), worked out again in plain PyTorch: the word-line DAC, IR-drop row
attenuation, KAN-SAM's Phase-A statistics, criticality and row mapping, the
chip's empty-row compaction, within-tile placement and per-tile variation
gains, and the bit-sliced readout with one ADC conversion per array (or
tile), bit plane and column.

An ADC conversion rounds an f32 partial sum to an integer, so a different
summation order would move a readout across a half step now and then. The
partial sums are therefore formed as the crossbar defines them: for each
array (tile) and bit plane, the terms ``fl(fl(v * atten) * (sign * gain))``
of its rows added one at a time in row order, each product and sum rounded
on its own. The integers that come out are exact; what follows is float64.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from kanbench.reference.asp import div

_MASK64 = (1 << 64) - 1


@dataclasses.dataclass(frozen=True)
class Crossbar:
    """One array's (or tile's) physics and converters."""
    array_size: int          # rows on a bit line (As)
    gamma0: float            # IR drop at As = 128
    adc_bits: int
    input_bits: int
    adc_in_scale: float      # ADC full scale = adc_in_scale * As
    tile_cols: int = 0       # columns a tile holds (the chip only)
    variation_sigma: float = 0.0
    variation_clip: float = 3.0

    @property
    def lsb(self) -> float:
        """The ADC step as the converter receives it: rounded to f32."""
        step = (float(self.array_size) * self.adc_in_scale
                / float(2 ** self.adc_bits - 1))
        return float(np.float32(step))


def quantize_wl(v: torch.Tensor, bits: int) -> torch.Tensor:
    """The word-line DAC: values in [0, 1] on 2^bits - 1 levels."""
    levels = 2 ** bits - 1
    x = div(torch.clamp(v, 0, 1.0), 1.0) * levels
    return div(torch.round(x), levels) * 1.0


def row_attenuation(n_rows: int, xb: Crossbar, device) -> torch.Tensor:
    """IR drop of each physical row: ``1 - gamma (d + 1) / As`` at distance
    ``d = row % As`` from the clamp, ``gamma = gamma0 As / 128``, floored
    at 0."""
    gamma = xb.gamma0 * xb.array_size / 128.0
    d = torch.arange(n_rows, dtype=torch.int32, device=device) % xb.array_size
    return torch.clamp(1.0 - div((d + 1.0) * gamma, xb.array_size), min=0.0)


# --- KAN-SAM (Algorithm 1) ----------------------------------------------------

@dataclasses.dataclass
class RowStats:
    """Phase A per crossbar row (input channel, basis): activation count,
    sum and sum of squares of the basis value over the sample."""
    cnt: torch.Tensor
    s1: torch.Tensor
    s2: torch.Tensor
    n: int

    @classmethod
    def empty(cls, in_dim: int, n_basis: int, device) -> "RowStats":
        z = torch.zeros((in_dim, n_basis), dtype=torch.float32,
                        device=device)
        return cls(z, z, z, 0)

    def add(self, basis: torch.Tensor) -> "RowStats":
        """Fold in one batch's dense basis [B, I, S]."""
        return RowStats(self.cnt + (basis > 0).to(torch.float32).sum(dim=0),
                        self.s1 + basis.sum(dim=0),
                        self.s2 + (basis * basis).sum(dim=0),
                        self.n + basis.shape[0])


def criticality(st: RowStats, codes: torch.Tensor) -> torch.Tensor:
    """Phase C: ``C_w = 0.5 J + 0.5 S J`` with ``J = p mu |c|`` and ``S = 1 /
    (1 + CV)``; ``|c|`` is the row's mean |code| over its columns. [I, S]."""
    p = div(st.cnt, max(st.n, 1))
    cnt1 = torch.clamp(st.cnt, min=1.0)
    mu = st.s1 / cnt1
    var = torch.clamp(st.s2 / cnt1 - mu * mu, min=0.0)
    s_stab = torch.reciprocal(1.0 + torch.sqrt(var) / (mu + 1e-6))
    mag = div(torch.abs(codes.to(torch.float32)).sum(dim=-1),
              codes.shape[-1])
    j = p * mu * mag
    return 0.5 * j + 0.5 * s_stab * j


def sam_attenuation(crit: torch.Tensor, pos_att: torch.Tensor
                    ) -> torch.Tensor:
    """KAN-SAM on one monolithic crossbar: rows sorted by criticality (high
    first, ties by index) take the physical rows in order of attenuation
    (least attenuated first, ties by position). Returns each logical row's
    attenuation [R]."""
    by_crit = torch.argsort(-crit.reshape(-1), stable=True)
    near_first = torch.as_tensor(
        np.argsort(-pos_att.cpu().numpy(), kind="stable"),
        device=pos_att.device)
    phys = torch.empty_like(near_first)
    phys[by_crit] = near_first
    return pos_att[phys]


# --- the chip's placement -----------------------------------------------------

def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def tile_seed(*ids: int) -> int:
    """The 64-bit generator seed of one tile: its ids folded in one after
    another through splitmix64."""
    h = 0
    for i in ids:
        h = _splitmix64(h ^ (int(i) & _MASK64))
    return h


def variation_gains(seed: int, layer_uid: int, n_tr: int, n_tc: int,
                    xb: Crossbar, device) -> torch.Tensor:
    """Per-cell conductance multipliers in the flat physical layout [Rp, Op]:
    tile (a, b) of layer ``layer_uid`` draws ``max(1 + sigma clip(eps), 0)``
    from a CPU generator seeded by ``tile_seed(seed, layer_uid, a, b)``."""
    a_s, c_s = xb.array_size, xb.tile_cols
    grid = torch.empty((n_tr, a_s, n_tc, c_s), dtype=torch.float32)
    for a in range(n_tr):
        for b in range(n_tc):
            gen = torch.Generator().manual_seed(
                tile_seed(seed, layer_uid, a, b))
            eps = torch.clamp(torch.randn((a_s, c_s), generator=gen),
                              -xb.variation_clip, xb.variation_clip)
            grid[a, :, b, :] = torch.clamp(1.0 + xb.variation_sigma * eps,
                                           min=0.0)
    return grid.reshape(n_tr * a_s, n_tc * c_s).to(device)


@dataclasses.dataclass(frozen=True)
class Placement:
    """Where each physical slot's row comes from, and what it holds."""
    logical: torch.Tensor          # [Rp] logical row of each slot
    valid: torch.Tensor            # [Rp] the slot holds a live row
    w: torch.Tensor                # [Rp, Op] int8 codes, columns padded
    gain: Optional[torch.Tensor]   # [Rp, Op] f32, None for ideal cells


def place(codes: torch.Tensor, crit: Optional[torch.Tensor], xb: Crossbar,
          seed: int, layer_uid: int) -> Placement:
    """The chip's mapping of one layer's rows [R = I*S, O] onto a grid of
    As x tile_cols tiles: rows whose codes are all zero take no slot and the
    live ones pack toward the first tiles in logical order; with ``crit``
    each tile's rows are then ordered by criticality, highest nearest the
    clamp (dead slots last)."""
    r = codes.shape[0] * codes.shape[1]
    o = codes.shape[-1]
    dev = codes.device
    w = codes.reshape(r, o)
    a_s = xb.array_size
    n_tr, n_tc = -(-r // a_s), -(-o // xb.tile_cols)
    rp = n_tr * a_s
    empty = (w == 0).all(dim=1)
    order = torch.argsort(empty.to(torch.int32), stable=True)
    logical = torch.cat([order, torch.zeros(rp - r, dtype=order.dtype,
                                            device=dev)])
    valid = torch.cat([~empty[order],
                       torch.zeros(rp - r, dtype=torch.bool, device=dev)])
    if crit is not None:
        key = torch.where(valid, crit.reshape(-1)[logical], -1.0)
        idx = torch.argsort(-key.reshape(n_tr, a_s), dim=1, stable=True)
        logical = torch.gather(logical.reshape(n_tr, a_s), 1, idx).reshape(rp)
        valid = torch.gather(valid.reshape(n_tr, a_s), 1, idx).reshape(rp)
    w_phys = torch.where(valid[:, None], w[logical], 0)
    w_phys = torch.nn.functional.pad(w_phys, (0, n_tc * xb.tile_cols - o))
    gain = None
    if xb.variation_sigma > 0.0:
        gain = variation_gains(seed, layer_uid, n_tr, n_tc, xb, dev)
    return Placement(logical, valid, w_phys, gain)


# --- the readout --------------------------------------------------------------

def readout(va: torch.Tensor, w: torch.Tensor, gain: Optional[torch.Tensor],
            xb: Crossbar, rows_per_block: int = 64) -> torch.Tensor:
    """Bit-sliced crossbar MAC over arrays of As consecutive rows.

    va: [B, R] f32 attenuated word-line values ``fl(v * atten)``, R a
    multiple of As; w: [R, C] int8; gain: [R, C] f32 or None. For each
    array, bit plane k and column, ``psum`` adds ``fl(va * sign(w) * gain)``
    over the array's rows whose bit k of |w| is set, in row order; the ADC
    gives ``n_k = rint(psum / lsb)``. Returns the exact integers
    ``sum_arrays sum_k 2^k n_k`` [B, C] int64 (batch rows in blocks)."""
    b, r = va.shape
    c = w.shape[1]
    a_s = xb.array_size
    n_arr = r // a_s
    w32 = w.to(torch.int32)
    sign = torch.sign(w32).to(torch.float32)
    if gain is not None:
        sign = sign * gain
    shifts = torch.arange(8, dtype=torch.int32, device=va.device)
    planes = ((torch.abs(w32)[None] >> shifts[:, None, None]) & 1)
    planes = (planes.to(torch.float32) * sign[None]).reshape(8, n_arr, a_s, c)
    weights = (torch.ones(8, dtype=torch.int64, device=va.device)
               << shifts.to(torch.int64)).reshape(8, 1, 1, 1)
    out = torch.empty((b, c), dtype=torch.int64, device=va.device)
    for s in range(0, b, rows_per_block):
        vb = va[s:s + rows_per_block].reshape(-1, n_arr, a_s)
        psum = torch.zeros((8, vb.shape[0], n_arr, c), dtype=torch.float32,
                           device=va.device)
        term = torch.empty_like(psum) if gain is not None else None
        for j in range(a_s):
            if gain is None:
                # the term is +-va or 0, exact: a fused multiply-add
                # rounds the sum alone, as the separate add does
                psum.addcmul_(vb[None, :, :, j, None],
                              planes[:, None, :, j, :])
            else:
                torch.mul(vb[None, :, :, j, None], planes[:, None, :, j, :],
                          out=term)
                psum.add_(term)
        n_k = torch.round(div(psum, xb.lsb)).to(torch.int64)
        out[s:s + rows_per_block] = (n_k * weights).sum(dim=(0, 2))
    return out
