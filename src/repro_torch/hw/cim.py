"""RRAM-ACIM non-ideality model (paper §3.3, §4.C; port of
``repro.hw.cim``).

IR drop: a cell at physical position ``d`` (0 = next to the clamp) on an
array of ``As`` rows sees ``atten(d) = 1 - gamma(As) (d + 1) / As`` with
``gamma(As) = gamma0 As / 128``. Partial-sum stochastic error: per-array
readout noise with std ``sigma_psum`` LSB, added on top of the
deterministic MAC (Gaussian closure over arrays).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from repro_torch.core.splines import true_div
from repro_torch.kernels import ops as kernel_ops

GAMMA0_DEFAULT = 0.02


@dataclasses.dataclass(frozen=True)
class CIMConfig:
    array_size: int = 256          # physical rows per bit line (As)
    adc_bits: int = 8
    gamma0: float = GAMMA0_DEFAULT
    sigma_psum: float = 0.3        # per-array readout noise std (LSB units)
    input_bits: int = 8            # WL DAC resolution
    # ADC full scale = adc_in_scale * array_size (calibrated range for
    # (K+1)-of-(K+G) sparse word lines).
    adc_in_scale: float = 0.2

    def gamma(self) -> float:
        return self.gamma0 * self.array_size / 128.0


def row_attenuation(n_rows: int, cfg: CIMConfig, device) -> torch.Tensor:
    """f32 attenuation of each physical row (row r at d = r % As), floored
    at 0: a resistive bit line can kill a far row but never invert it."""
    d = torch.arange(n_rows, dtype=torch.int32, device=device) % cfg.array_size
    lin = true_div((d + 1.0) * cfg.gamma(), cfg.array_size)
    return torch.clamp(1.0 - lin, min=0.0)


def quantize_wl(v: torch.Tensor, bits: int, v_max: float = 1.0
                ) -> torch.Tensor:
    """WL input DAC quantisation (TM-DV-IG charge levels)."""
    levels = 2 ** bits - 1
    x = true_div(torch.clamp(v, 0, v_max), v_max) * levels
    return true_div(torch.round(x), levels) * v_max


def cim_forward(v: torch.Tensor, w_codes: torch.Tensor, cfg: CIMConfig, *,
                atten_of_logical: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Simulated crossbar MAC: out ~= v @ w_codes with analog error.

    v: [..., R] word-line values in [0, 1]; w_codes: [R, C] int8;
    atten_of_logical: [R] per-logical-row attenuation (default: uniform
    mapping, row r at position r % As). ``generator`` draws the stochastic
    partial-sum noise (the reference's ``rng`` key); None adds none.
    """
    r = v.shape[-1]
    if atten_of_logical is None:
        atten_of_logical = row_attenuation(r, cfg, v.device)
    vq = quantize_wl(v, cfg.input_bits)
    out = kernel_ops.cim_mac(vq, w_codes, atten_of_logical,
                             array_size=cfg.array_size,
                             adc_bits=cfg.adc_bits,
                             in_scale=cfg.adc_in_scale)
    if generator is not None:
        n_arrays = -(-r // cfg.array_size)
        fs = cfg.array_size * cfg.adc_in_scale
        lsb = fs / (2 ** cfg.adc_bits - 1)
        # 8 bit slices recombined with weights 2^k: total noise variance
        # sigma^2 * n_arrays * sum(4^k) / 8 per output.
        scale = cfg.sigma_psum * lsb * math.sqrt(
            n_arrays * sum(4.0 ** k for k in range(8)) / 8.0)
        noise = torch.randn(out.shape, generator=generator,
                            device=generator.device)
        out = out + scale * noise.to(out.device)
    return out


def mac_error_rate(v: torch.Tensor, w_codes: torch.Tensor, cfg: CIMConfig,
                   atten_of_logical: Optional[torch.Tensor] = None) -> float:
    """Mean relative MAC error vs the ideal digital result."""
    from repro_torch.kernels import ref as kref
    ideal = kref.cim_mac_ideal(v, w_codes)
    actual = cim_forward(v, w_codes, cfg, atten_of_logical=atten_of_logical)
    denom = torch.clamp(torch.mean(torch.abs(ideal)), min=1e-6)
    return float(torch.mean(torch.abs(actual - ideal)) / denom)
