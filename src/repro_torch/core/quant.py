"""ASP-KAN-HAQ: Alignment-Symmetry and PowerGap KAN hardware-aware
quantisation (paper §3.1; port of ``repro.core.quant``).

* **Alignment** (Eq. 4): ``G * L <= 2^n`` with integer L, so the knot grid
  and the input quantisation grid have zero offset and ONE LUT serves every
  basis function of every edge.
* **PowerGap** (Eq. 5): L is a power of two, so ``segment = q >> LD`` and
  ``local = q & (2^LD - 1)``.
* **Symmetry**: with midpoint sampling ``taps[L-1-local, t] ==
  taps[local, K-t]``; only the lower half is stored (the SH-LUT).

The jointly optimal exponent is ``LD = floor(log2(2^n / G))`` (Eq. 6).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core import splines
from repro_torch.core.splines import true_div


@dataclasses.dataclass(frozen=True)
class ASPConfig:
    """Static configuration of one ASP-KAN-HAQ quantised spline family:
    ``(grid_size, ld_cap, coeff_bits)`` is one operating point."""
    grid_size: int = 5        # G
    order: int = 3            # K
    n_bits: int = 8           # input quantisation bit-width n
    x_min: float = -1.0
    x_max: float = 1.0
    coeff_bits: int = 8       # ci' quantisation (8 | 4 | 2 bit-slices)
    # Cap on LD; None = the Eq. (6) jointly optimal maximum.
    ld_cap: Optional[int] = None

    def __post_init__(self):
        if self.grid_size > 2 ** self.n_bits:
            raise ValueError(
                f"G={self.grid_size} exceeds 2^n={2**self.n_bits}: Eq. (4) "
                f"unsatisfiable — no integer L with G*L <= 2^n.")
        if self.ld_cap is not None and self.ld_cap < 0:
            raise ValueError(f"ld_cap={self.ld_cap} < 0: LD is a bit count")
        if not 2 <= self.coeff_bits <= 8:
            raise ValueError(
                f"coeff_bits={self.coeff_bits} outside [2, 8]: codes live in "
                "int8 carriers (8-column bit-slice template, Alg. 1 Phase B).")

    @property
    def ld_max(self) -> int:
        """Eq. (6) maximum LD for (G, n): floor(log2(2^n / G))."""
        return int(np.floor(np.log2((2 ** self.n_bits) / self.grid_size)))

    @property
    def ld(self) -> int:
        """LD: log2 of quantisation levels per knot interval (capped)."""
        if self.ld_cap is None:
            return self.ld_max
        return min(self.ld_cap, self.ld_max)

    @property
    def levels_per_interval(self) -> int:
        return 1 << self.ld

    @property
    def n_levels(self) -> int:
        """Usable input range [0, G * 2^LD - 1] (<= 2^n)."""
        return self.grid_size * self.levels_per_interval

    @property
    def n_basis(self) -> int:
        return self.grid_size + self.order

    @property
    def n_taps(self) -> int:
        return self.order + 1

    @property
    def step(self) -> float:
        return (self.x_max - self.x_min) / self.n_levels

    def with_grid(self, grid_size: int) -> "ASPConfig":
        return dataclasses.replace(self, grid_size=grid_size)


# ---------------------------------------------------------------------------
# SH-LUT construction (host side, numpy float64, cast to f32 once).
# ---------------------------------------------------------------------------

def _cardinal_taps_np(u: np.ndarray, order: int) -> np.ndarray:
    """Numpy mirror of ``splines.cardinal_taps`` for the offline LUT build."""
    taps = [np.ones_like(u)]
    for k in range(1, order + 1):
        nxt = []
        for t in range(k + 1):
            acc = np.zeros_like(u)
            if 0 <= t - 1 < k:
                acc = acc + (u + k - t) / k * taps[t - 1]
            if t < k:
                acc = acc + (1.0 - u + t) / k * taps[t]
            nxt.append(acc)
        taps = nxt
    return np.stack(taps, axis=-1)


def _full_lut_np(cfg: ASPConfig) -> np.ndarray:
    """The full aligned table [2^LD, K+1] in float64: the taps at the
    quantisation midpoints."""
    L = cfg.levels_per_interval
    u = (np.arange(L, dtype=np.float64) + 0.5) / L
    return _cardinal_taps_np(u, cfg.order)


def build_full_lut(cfg: ASPConfig, device, dtype=torch.float32
                   ) -> torch.Tensor:
    """Full aligned LUT [2^LD, K+1] on ``device``: by Alignment, this one
    table serves every segment of every edge spline."""
    return torch.tensor(_full_lut_np(cfg), dtype=dtype, device=device)


def build_sh_lut(cfg: ASPConfig, device, dtype=torch.float32
                 ) -> torch.Tensor:
    """Sharable-Hemi LUT: the lower ceil(L/2) rows of the full table; the
    upper half is ``full[L-1-loc, t] == hemi[loc, K-t]``."""
    full = build_full_lut(cfg, device, dtype)
    return full[:(cfg.levels_per_interval + 1) // 2]


@functools.lru_cache(maxsize=64)
def cached_hemi_np(grid_size: int, order: int, n_bits: int,
                   x_min: float, x_max: float,
                   ld: Optional[int] = None) -> np.ndarray:
    """SH-LUT [ceil(L/2), K+1] f32: full aligned table at the quantisation
    midpoints in float64, cast to f32, lower half kept."""
    cfg = ASPConfig(grid_size=grid_size, order=order, n_bits=n_bits,
                    x_min=x_min, x_max=x_max, ld_cap=ld)
    full = _full_lut_np(cfg).astype(np.float32)
    return full[:(cfg.levels_per_interval + 1) // 2]


def hemi_for(cfg: ASPConfig, device) -> torch.Tensor:
    """The SH-LUT of a config as an f32 tensor on ``device``, made once per
    config and device and shared by every caller, which only reads it: a
    fresh upload to the card at each call would wait for all the work
    queued before it."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return _hemi_on(cfg.grid_size, cfg.order, cfg.n_bits, cfg.x_min,
                    cfg.x_max, cfg.ld, device)


@functools.lru_cache(maxsize=64)
def _hemi_on(grid_size: int, order: int, n_bits: int, x_min: float,
             x_max: float, ld: Optional[int], device: torch.device
             ) -> torch.Tensor:
    return torch.tensor(cached_hemi_np(grid_size, order, n_bits, x_min,
                                       x_max, ld), device=device)


def sh_lut_lookup(hemi: torch.Tensor, local: torch.Tensor, cfg: ASPConfig
                  ) -> torch.Tensor:
    """Gather taps from the hemi table with reflection: local [...] int32 in
    [0, L-1] -> taps [..., K+1]."""
    L = cfg.levels_per_interval
    half = hemi.shape[0]
    reflected = local >= half
    idx = torch.where(reflected, L - 1 - local, local)
    taps = hemi[idx.long()]
    return torch.where(reflected[..., None], taps.flip(-1), taps)


# ---------------------------------------------------------------------------
# Input quantisation (PowerGap decode is just shift/mask).
# ---------------------------------------------------------------------------

def quantize_input(x: torch.Tensor, cfg: ASPConfig) -> torch.Tensor:
    """Float -> aligned integer code in [0, G*2^LD - 1]: an f32 subtract and
    a true f32 divide, as the reference and the kernel compute it."""
    q = torch.floor(true_div(x - cfg.x_min, cfg.step))
    return torch.clamp(q, 0, cfg.n_levels - 1).to(torch.int32)


def dequantize_input(q: torch.Tensor, cfg: ASPConfig) -> torch.Tensor:
    """Integer code -> midpoint of its quantisation cell."""
    return cfg.x_min + (q.to(torch.float32) + 0.5) * cfg.step


def fake_quantize_input(x: torch.Tensor, cfg: ASPConfig) -> torch.Tensor:
    """Straight-through fake quantisation of the input for QAT: the forward
    is the cell midpoint, the gradient passes unchanged."""
    q = dequantize_input(quantize_input(x, cfg), cfg)
    return x + (q - x).detach()


def powergap_decode(q: torch.Tensor, cfg: ASPConfig
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """PowerGap split: (segment = q >> LD, local = q & (2^LD - 1))."""
    return q >> cfg.ld, q & (cfg.levels_per_interval - 1)


def quantized_taps(x: torch.Tensor, hemi: torch.Tensor, cfg: ASPConfig
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantise x and return (segment [...], taps [..., K+1]) via SH-LUT."""
    seg, local = powergap_decode(quantize_input(x, cfg), cfg)
    return seg, sh_lut_lookup(hemi, local, cfg)


def quantized_basis(x: torch.Tensor, hemi: torch.Tensor, cfg: ASPConfig
                    ) -> torch.Tensor:
    """Dense quantised basis [..., G+K] (the ACIM word-line values)."""
    seg, taps = quantized_taps(x, hemi, cfg)
    return splines.basis_from_taps(seg, taps, cfg.grid_size, cfg.order)


# ---------------------------------------------------------------------------
# Coefficient quantisation (ci' -> int8 with per-output-channel scale).
# ---------------------------------------------------------------------------

def quantize_coeffs(c: torch.Tensor, cfg: ASPConfig, axis=-1
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-channel int quantisation: ``axis`` names the dims
    reduced to find each channel's |max| (``(0, 1)`` for coeffs [I, S, O]
    gives one scale per output channel). Clip at ``2^(b-1)-1``. Returns
    (int8 codes, f32 scale with kept dims)."""
    qmax = 2 ** (cfg.coeff_bits - 1) - 1
    amax = torch.amax(torch.abs(c), dim=axis, keepdim=True)
    scale = true_div(torch.clamp(amax, min=1e-8), qmax)
    codes = torch.clamp(torch.round(c / scale), -qmax, qmax).to(torch.int8)
    return codes, scale


def dequantize_coeffs(codes: torch.Tensor, scale: torch.Tensor
                      ) -> torch.Tensor:
    return codes.to(torch.float32) * scale


# int8 SH-LUT for the lut_int8 backend: the cardinal taps lie in [0, 1], so
# one fixed LSB of 1/127 quantises the whole table. It is built at deploy
# time; the serving path only gathers the frozen int8 taps, so the expanded
# basis is an int8 tensor and the contraction stays integer.
HEMI_LSB = 1.0 / 127.0


def quantize_hemi(hemi: torch.Tensor) -> torch.Tensor:
    """f32 SH-LUT [ceil(L/2), K+1] -> int8 codes (dequantised: codes *
    HEMI_LSB): ``round(hemi / f32(1/127))``, a true f32 division by the f32
    value of the LSB as in the reference, rounded half to even."""
    return torch.round(true_div(hemi.to(torch.float32), HEMI_LSB)
                       ).to(torch.int8)


def bit_slices(codes: torch.Tensor) -> torch.Tensor:
    """Alg. 1 Phase B: int8 magnitude -> 8 binary slices, MSB first.
    codes [...] int8 -> [..., 8] uint8 in {0, 1}; the sign is kept apart
    (differential pair)."""
    mag = torch.abs(codes.to(torch.int32))
    shifts = torch.arange(7, -1, -1, dtype=torch.int32, device=codes.device)
    return ((mag[..., None] >> shifts) & 1).to(torch.uint8)


# ---------------------------------------------------------------------------
# Conventional (misaligned) PTQ baseline — for the Fig. 12/13 comparisons.
# ---------------------------------------------------------------------------

def conventional_quantized_basis(x: torch.Tensor, cfg: ASPConfig
                                 ) -> torch.Tensor:
    """Post-training quantisation WITHOUT alignment: 2^n uniform levels over
    [x_min, x_max] that do not line up with the knots, each input read at
    its cell's midpoint through the float basis (on silicon, one LUT per
    basis function)."""
    n = 2 ** cfg.n_bits
    step = (cfg.x_max - cfg.x_min) / n
    q = torch.clamp(torch.floor(true_div(x - cfg.x_min, step)), 0, n - 1)
    xq = cfg.x_min + (q + 0.5) * step
    return splines.bspline_basis_uniform(
        xq, cfg.x_min, cfg.x_max, cfg.grid_size, cfg.order)
