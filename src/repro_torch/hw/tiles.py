"""Multi-tile ACIM crossbar math: the paper's large-array scaling story
(port of ``repro.hw.tiles``).

``hw.cim`` models ONE monolithic array. Real chips provision a *grid* of
fixed ``As x Cc`` crossbar tiles and reduce the per-tile readouts
digitally; that chip-level dataflow lives here:

* ``TileConfig`` — one physical tile: ``As`` rows on a bit line, ``Cc``
  bit-line column groups, WL-DAC / ADC resolution, IR-drop ``gamma``.
* ``grid_shape`` / ``pack_image`` — partition the expanded coefficient
  matrix ``[R, O]`` into a ``[Tr, Tc]`` grid of per-tile programming images.
* ``readout_codes`` — the per-row-tile digital partial sums: per tile,
  IR-drop attenuation (reset at every tile boundary), optional per-cell
  conductance variation, bit-sliced analog sums, per-tile ADC readout,
  shift-and-add recombination → one int32 code per (row tile, column).
* ``tiled_mac`` — the full chip MAC: codes reduced across row tiles by an
  int32 adder tree, scaled back to the analog domain once at the end. The
  deterministic path runs the kernel wrapper ``ops.cim_mac_tiled`` (the
  CUDA kernel on the card, its plain version on the CPU); the stochastic
  readout-noise path runs ``readout_codes``.

Only the ROW tiling (``As``) affects results; ``Cc`` partitions ADCs and
area and enters the chip mapper (``hw.chip``) and the cost roll-up.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.hw import cim as cim_lib
from repro_torch.kernels import ops as kernel_ops
from repro_torch.kernels import ref as kref
from repro_torch.obs import trace as obs_trace


@dataclasses.dataclass(frozen=True)
class TileConfig:
    """One physical crossbar tile. Fields and defaults match the monolithic
    ``cim.CIMConfig``, so an ideal tiled chip degenerates to it;
    ``tile_cols`` is the bit-line column groups per tile."""
    array_size: int = 256          # rows per tile (As)
    tile_cols: int = 64            # output columns per tile (Cc)
    adc_bits: int = 8
    gamma0: float = cim_lib.GAMMA0_DEFAULT
    sigma_psum: float = 0.3        # per-tile readout noise std (LSB units)
    input_bits: int = 8            # WL DAC resolution
    adc_in_scale: float = 0.2      # ADC full-scale = adc_in_scale * As

    def gamma(self) -> float:
        return self.gamma0 * self.array_size / 128.0

    @property
    def lsb(self) -> float:
        fs = float(self.array_size) * self.adc_in_scale
        return fs / float(2 ** self.adc_bits - 1)

    def as_cim(self) -> cim_lib.CIMConfig:
        """The monolithic-array view of this tile."""
        return cim_lib.CIMConfig(
            array_size=self.array_size, adc_bits=self.adc_bits,
            gamma0=self.gamma0, sigma_psum=self.sigma_psum,
            input_bits=self.input_bits, adc_in_scale=self.adc_in_scale)


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def grid_shape(n_rows: int, n_cols: int, cfg: TileConfig) -> Tuple[int, int]:
    """(Tr, Tc) tile-grid dims covering an [n_rows, n_cols] matrix."""
    return _ceil_div(n_rows, cfg.array_size), _ceil_div(n_cols, cfg.tile_cols)


def slot_attenuation(n_slots: int, cfg: TileConfig, device) -> torch.Tensor:
    """IR-drop attenuation of each physical slot, reset at every tile
    boundary (slot s sits at in-tile distance ``s % As``). Delegates to
    ``cim.row_attenuation`` so the tiled and single-array physics cannot
    diverge."""
    return cim_lib.row_attenuation(n_slots, cfg.as_cim(), device)


def pack_image(w_phys: torch.Tensor, cfg: TileConfig) -> torch.Tensor:
    """[Rp, Op] physical codes -> [Tr, Tc, As, Cc] per-tile programming
    images. Rp/Op must be tile multiples (the mapper pads)."""
    rp, op = w_phys.shape
    tr, tc = rp // cfg.array_size, op // cfg.tile_cols
    img = w_phys.reshape(tr, cfg.array_size, tc, cfg.tile_cols)
    return img.permute(0, 2, 1, 3)


def unpack_image(image: torch.Tensor, cfg: TileConfig) -> torch.Tensor:
    """[Tr, Tc, As, Cc] -> [Rp, Op] flat physical matrix."""
    tr, tc = image.shape[0], image.shape[1]
    return image.permute(0, 2, 1, 3).reshape(tr * cfg.array_size,
                                             tc * cfg.tile_cols)


def readout_codes(v_phys: torch.Tensor, w_phys: torch.Tensor,
                  cfg: TileConfig, *, gain: Optional[torch.Tensor] = None,
                  generator: Optional[torch.Generator] = None
                  ) -> torch.Tensor:
    """Per-row-tile digital readout codes (the plain per-tile readout).

    v_phys: [..., Rp] word-line values in PHYSICAL row order (already
    WL-DAC quantised), Rp % As == 0; w_phys: [Rp, Op] int8; gain: optional
    [Rp, Op] per-cell conductance multipliers (``hw.variation``).
    ``generator`` adds pre-ADC Gaussian readout noise per (tile, bit slice)
    with std ``sigma_psum`` LSBs (the reference's ``rng`` key).

    Returns [..., Tr, Op] int32; ``sum(-2) * cfg.lsb`` is the chip output.
    """
    rp = v_phys.shape[-1]
    lead = v_phys.shape[:-1]
    codes = kref.cim_mac_tiled_codes(
        v_phys.reshape(-1, rp), w_phys, gain,
        slot_attenuation(rp, cfg, v_phys.device), cfg.array_size,
        cfg.adc_bits, cfg.adc_in_scale, sigma_psum=cfg.sigma_psum,
        generator=generator)
    return codes.reshape(lead + codes.shape[1:])


def tiled_mac(v_phys: torch.Tensor, w_phys: torch.Tensor, cfg: TileConfig,
              *, gain: Optional[torch.Tensor] = None,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Full multi-tile MAC: per-tile readouts reduced across row tiles by
    the int32 adder tree, then scaled to analog units once.

    v_phys: [..., Rp] physical-order WL values, w_phys: [Rp, Op] int8.
    Returns [..., Op] float32 ~= v @ w with per-tile analog error. Without
    a generator this is the kernel path (``ops.cim_mac_tiled``); with one,
    the noisy plain readout (``readout_codes``), as in the reference.
    Inside a traced call on the card the kernel counts
    ``xbar.rows_iterated`` (``obs.trace``).
    """
    if generator is None:
        rows = obs_trace.device_counter("xbar.rows_iterated")
        acc = kernel_ops.cim_mac_tiled(
            v_phys, w_phys,
            slot_attenuation(v_phys.shape[-1], cfg, v_phys.device),
            gain=gain, array_size=cfg.array_size, adc_bits=cfg.adc_bits,
            in_scale=cfg.adc_in_scale, rows_iterated=rows)
    else:
        acc = readout_codes(v_phys, w_phys, cfg, gain=gain,
                            generator=generator).sum(-2, dtype=torch.int32)
    return acc.to(torch.float32) * cfg.lsb
