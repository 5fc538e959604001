"""Runtime chip-health telemetry: canary-row probes + ADC saturation (port
of ``repro.hw.health``).

The chip simulator (``hw.tiles`` / ``hw.chip``) models a *deployed* ACIM
part; ``hw.variation.DriftConfig`` makes its non-idealities temporal. This
module is the instrument that makes that drift VISIBLE at serve time, the
way a real RRAM-ACIM deployment monitors itself:

* **Canary-row probes.** Each probed tile keeps a reference pattern
  (full-code rows) whose ideal digital readout is known at programming
  time. ``ChipHealth.probe(age)`` replays the readout through the tile's
  current conductance state (static process corner x temporal drift at
  ``age`` ticks) and reports the relative partial-sum deviation per
  (layer, tile) — the same partial-sum-deviation metric the paper's
  Fig. 18 Monte-Carlo is built on, measured on a live canary instead of a
  Monte-Carlo sweep.
* **ADC-saturation counters.** The probe's readout clips every bit-slice
  code at the ADC full scale (``2**adc_bits - 1``) and counts clip events
  — a drifting or hot tile first shows up as codes pinned at the rails.
* **Gauge export.** With a ``registry`` attached (duck-typed
  ``repro_torch.obs.MetricsRegistry``), every probe publishes
  ``chip_canary_rel_dev`` / ``chip_adc_saturation`` gauges and a
  ``chip_adc_saturation_total`` counter per (layer, tile); the caller's
  ``labels`` (e.g. ``{"replica": "1"}``) ride on every series, giving the
  per-(replica, layer, tile) fleet view the router's ``HealthMonitor``
  polls.

The probe math runs in float64 numpy on the host (one [As] x [As, Cc]
matvec per bit-slice per tile), as in the reference, so per-tick polling
costs microseconds and launches nothing on the card. Only the gain draws
come from torch: ``variation.tile_gain`` / ``drift_gain`` (the port's
splitmix64-seeded CPU generators, not the reference's threefry, so probes
under variation or drift match the reference in distribution, not draw for
draw), cached per (layer, tile) at construction and re-drawn per age for
drift. With no gain (an ideal chip) the codes are the reference's exactly.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.hw import tiles as tiles_lib
from repro_torch.hw import variation as var_lib
from repro_torch.hw.tiles import TileConfig


def canary_readout(cfg: TileConfig, gain: Optional[np.ndarray],
                   headroom: float = 0.7) -> Tuple[np.ndarray, int]:
    """Digital readout of one canary tile (full-code rows, uniform
    wordline drive), with ADC rail clipping.

    The wordline level is chosen so the IDEAL per-slice analog sum sits at
    ``headroom`` x the ADC full scale — enough range to see conductance
    loss as falling codes, and close enough to the rails that gain
    excursions above ``1 / headroom`` saturate (``headroom > 1`` pins even
    the ideal readout, the self-test path). Returns ``(codes[Cc],
    n_saturated)``: shift-and-add recombined int codes per column and the
    number of (slice, column) readouts that clipped at
    ``2**adc_bits - 1``."""
    att = tiles_lib.slot_attenuation(cfg.array_size, cfg, "cpu").double(
        ).numpy()
    lsb = cfg.lsb
    fs_codes = 2 ** cfg.adc_bits - 1
    v0 = headroom * (cfg.array_size * cfg.adc_in_scale) / att.sum()
    g = np.ones((cfg.array_size, cfg.tile_cols)) if gain is None else \
        np.asarray(gain, dtype=np.float64)
    va = v0 * att                                   # [As]
    codes = np.zeros(cfg.tile_cols, dtype=np.int64)
    saturated = 0
    # canary rows are programmed at full code (127): every one of the 8
    # magnitude bit-slices is set, so each slice sees the same analog sum
    for k in range(8):
        psum = va @ g                               # [Cc]
        code = np.round(psum / lsb).astype(np.int64)
        saturated += int(np.count_nonzero(np.abs(code) > fs_codes))
        code = np.clip(code, -fs_codes, fs_codes)
        codes += (1 << k) * code
    return codes, saturated


@dataclasses.dataclass(frozen=True)
class ProbeGeometry:
    """Which tiles a :class:`ChipHealth` instruments: one canary per
    (layer_uid, row-tile) pair over ``layer_uids`` x ``tiles_per_layer``
    (column-tile 0 — IR drop and the gain draws vary per row tile, which
    is the axis partial-sum deviation accumulates over)."""
    layer_uids: Tuple[int, ...] = (0,)
    tiles_per_layer: int = 1


class ChipHealth:
    """Per-replica chip-health source: canary deviation + ADC saturation.

    Composes the static process corner (``VariationConfig``) with the
    temporal schedule (``DriftConfig``) and probes each instrumented tile
    on demand. ``probe(age)`` is a pure function of ``age`` (plus the
    frozen seeds), so a CI run replays the exact degradation trajectory.
    The router's ``HealthMonitor`` only needs ``probe(age) -> dict`` with
    ``max_rel_dev`` / ``adc_saturation`` keys — this class is the real
    implementation; tests may substitute any duck-typed source."""

    def __init__(self, *, tile: Optional[TileConfig] = None,
                 variation: Optional[var_lib.VariationConfig] = None,
                 drift: Optional[var_lib.DriftConfig] = None,
                 geometry: ProbeGeometry = ProbeGeometry(),
                 headroom: float = 0.7,
                 registry=None,
                 labels: Optional[Dict[str, str]] = None):
        self.tile = tile if tile is not None else TileConfig()
        self.variation = (variation if variation is not None
                          else var_lib.VariationConfig())
        self.drift = (drift if drift is not None else var_lib.DriftConfig())
        self.geometry = geometry
        self.headroom = headroom
        self.registry = registry
        self.labels = dict(labels) if labels else {}
        self.saturation_total = 0
        self.last: Optional[dict] = None
        shape = (self.tile.array_size, self.tile.tile_cols)
        # static per-tile state, frozen at "programming time": process-
        # variation gains and the ideal (no-gain) canary readout
        self._static: Dict[Tuple[int, int], np.ndarray] = {}
        self._ideal_codes, _ = canary_readout(self.tile, None,
                                              self.headroom)
        for uid in geometry.layer_uids:
            for tr in range(geometry.tiles_per_layer):
                if self.variation.sigma > 0.0:
                    g = var_lib.tile_gain(self.variation, uid, tr, 0,
                                          shape).double().numpy()
                else:
                    g = np.ones(shape)
                self._static[(uid, tr)] = g

    def _tile_gain_at(self, uid: int, tr: int, age: float) -> np.ndarray:
        g = self._static[(uid, tr)]
        if self.drift.rate != 0.0:
            shape = (self.tile.array_size, self.tile.tile_cols)
            g = g * var_lib.drift_gain(self.drift, age, uid, tr, 0,
                                       shape).double().numpy()
        return g

    def probe(self, age: float) -> dict:
        """Probe every instrumented tile at ``age`` ticks. Returns
        ``{"age", "max_rel_dev", "adc_saturation", "adc_saturation_total",
        "tiles": [{"layer", "tile", "rel_dev", "adc_saturation"}, ...]}``
        and publishes the per-(layer, tile) gauges when a registry is
        attached."""
        ideal = self._ideal_codes.astype(np.float64)
        denom = max(float(np.abs(ideal).mean()), 1.0)
        tiles: List[dict] = []
        max_dev = 0.0
        sat_this = 0
        for (uid, tr), _ in self._static.items():
            codes, sat = canary_readout(
                self.tile, self._tile_gain_at(uid, tr, age), self.headroom)
            dev = float(np.abs(codes - ideal).mean() / denom)
            max_dev = max(max_dev, dev)
            sat_this += sat
            tiles.append({"layer": int(uid), "tile": int(tr),
                          "rel_dev": round(dev, 6),
                          "adc_saturation": int(sat)})
        self.saturation_total += sat_this
        out = {"age": float(age), "max_rel_dev": round(max_dev, 6),
               "adc_saturation": int(sat_this),
               "adc_saturation_total": int(self.saturation_total),
               "tiles": tiles}
        self.last = out
        if self.registry is not None:
            self._publish(out)
        return out

    def _publish(self, out: dict) -> None:
        for t in out["tiles"]:
            labels = {**self.labels, "layer": str(t["layer"]),
                      "tile": str(t["tile"])}
            self.registry.gauge(
                "chip_canary_rel_dev",
                "canary-row partial-sum relative deviation vs programmed "
                "reference", labels=labels).set(t["rel_dev"])
            self.registry.gauge(
                "chip_adc_saturation",
                "ADC readouts clipped at full scale in the latest probe",
                labels=labels).set(t["adc_saturation"])
            self.registry.counter(
                "chip_adc_saturation_total",
                "cumulative ADC full-scale clip events",
                labels=labels).inc(t["adc_saturation"])
