"""Chip-level mapper: place a KAN stack onto a multi-tile ACIM inventory
(port of ``repro.hw.chip``).

``hw.tiles`` knows how one tile grid computes; this module decides WHAT is
programmed WHERE — the paper's sparsity-aware mapping at chip scale:

* **Empty-row compaction (across tiles)** — expanded coefficient rows whose
  int8 codes are all zero occupy no crossbar rows: live rows pack toward the
  clamp, whole row tiles at the tail go unprogrammed.
* **Criticality-aware placement (within tiles, KAN-SAM)** — with Phase-A
  stats, each tile's rows are ordered by Algorithm-1 criticality so the
  most critical land nearest that tile's clamp (attenuation resets at tile
  boundaries, so the sort is per tile).
* **Roll-up** — tiles allocated/used, utilisation, and area/power/latency
  via the calibrated ``hw.cost_model`` scale model; ``publish_report``
  writes it as gauges into an ``obs`` metrics registry.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from repro_torch.hw import cim as cim_lib
from repro_torch.hw import cost_model
from repro_torch.hw import tiles as tiles_lib
from repro_torch.hw import variation as var_lib
from repro_torch.hw.tiles import TileConfig
from repro_torch.obs import trace as obs_trace


@dataclasses.dataclass(frozen=True)
class ChipConfig:
    """A chip: a tile geometry, a tile inventory, and a process corner.
    This is what ``KANSpec.cim`` holds for the ``cim_tiled`` backend."""
    tile: TileConfig = TileConfig()
    variation: var_lib.VariationConfig = var_lib.VariationConfig()
    n_tiles: Optional[int] = None   # inventory cap; None = unbounded
    compact: bool = True            # empty-row compaction across tiles

    def with_seed(self, seed: int) -> "ChipConfig":
        """New chip instance: same design, fresh variation draw."""
        return dataclasses.replace(
            self, variation=self.variation.with_seed(seed))


@dataclasses.dataclass(frozen=True)
class TiledLayer:
    """Per-layer programming image + placement — the artifact the
    ``cim_tiled`` backend stores inside a ``DeployedLayer``. Codes and gains
    are stored in the flat physical layout the hot path consumes;
    ``layer_image`` renders the per-tile [Tr, Tc, As, Cc] view."""
    w_phys: torch.Tensor             # [Rp, Op] int8 physical codes (padded)
    gain: Optional[torch.Tensor]     # [Rp, Op] f32 per-cell variation; None=ideal
    logical_of_phys: torch.Tensor    # [Rp] int32: slot -> logical row
    valid: torch.Tensor              # [Rp] bool: slot holds a live row
    phys_of_logical: torch.Tensor    # [R] int32: logical row -> slot; -1 =
    #                                  row compacted away (no slot)

    def to(self, device) -> "TiledLayer":
        """A copy with every tensor on ``device``."""
        return TiledLayer(**{
            f.name: None if getattr(self, f.name) is None
            else getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)})


def layer_image(tiled: TiledLayer, cfg: ChipConfig) -> torch.Tensor:
    """[Tr, Tc, As, Cc] per-tile programming images (inspection view)."""
    return tiles_lib.pack_image(tiled.w_phys, cfg.tile)


def place_layer(codes: torch.Tensor, crit: Optional[torch.Tensor],
                cfg: ChipConfig, *, layer_uid: int = 0) -> TiledLayer:
    """Map one layer's expanded coefficient matrix onto tiles.

    codes: [I, S, O] int8 (deploy-time quantised codes); crit: optional [R]
    Algorithm-1 criticality (R = I*S) — None places rows in logical order
    (the uniform mapping Fig. 18 degrades). Every live logical row lands in
    exactly ONE physical slot. The gains are drawn per (layer_uid, tile) on
    the CPU and moved to the codes' device.
    """
    r = codes.shape[0] * codes.shape[1]
    o = codes.shape[-1]
    dev = codes.device
    w = codes.reshape(r, o)
    tile = cfg.tile
    tr, tc = tiles_lib.grid_shape(r, o, tile)
    if cfg.n_tiles is not None and tr * tc > cfg.n_tiles:
        raise ValueError(
            f"layer needs a {tr}x{tc}={tr * tc}-tile grid but the chip "
            f"inventory is {cfg.n_tiles} tiles")
    rp, op = tr * tile.array_size, tc * tile.tile_cols

    if cfg.compact:
        empty = (w == 0).all(dim=1)
        # stable sort: live rows first, logical order kept within each class
        order = torch.argsort(empty.to(torch.int32), stable=True)
    else:
        empty = torch.zeros((r,), dtype=torch.bool, device=dev)
        order = torch.arange(r, device=dev)
    lof = torch.cat([order.to(torch.int32),
                     torch.zeros(rp - r, dtype=torch.int32, device=dev)])
    valid = torch.cat([~empty[order],
                       torch.zeros(rp - r, dtype=torch.bool, device=dev)])

    if crit is not None:
        # within-tile KAN-SAM: per tile, highest criticality nearest the
        # clamp; dead slots (crit sentinel -1) sink to the tile's far end
        crit_slot = torch.where(valid, crit.reshape(-1)[lof.long()], -1.0)
        idx = torch.argsort(-crit_slot.reshape(tr, tile.array_size), dim=1,
                            stable=True)
        lof = torch.gather(lof.reshape(tr, tile.array_size), 1,
                           idx).reshape(rp)
        valid = torch.gather(valid.reshape(tr, tile.array_size), 1,
                             idx).reshape(rp)

    # inverse map; compacted-away logical rows keep the -1 sentinel (they
    # occupy no slot), and dead slots scatter nothing
    pol = torch.full((r,), -1, dtype=torch.int32, device=dev)
    slots = torch.arange(rp, dtype=torch.int32, device=dev)
    pol[lof[valid].long()] = slots[valid]
    w_phys = torch.where(valid[:, None], w[lof.long()], 0)
    w_phys = torch.nn.functional.pad(w_phys, (0, op - o))

    gain = None
    if cfg.variation.sigma > 0.0:
        gain = tiles_lib.unpack_image(
            var_lib.grid_gain(cfg.variation, layer_uid, tr, tc,
                              tile.array_size, tile.tile_cols),
            tile).contiguous().to(dev)
    return TiledLayer(w_phys=w_phys.contiguous(), gain=gain,
                      logical_of_phys=lof, valid=valid, phys_of_logical=pol)


def chip_forward(v: torch.Tensor, tiled: TiledLayer, cfg: ChipConfig,
                 out_dim: int, *,
                 generator: Optional[torch.Generator] = None
                 ) -> torch.Tensor:
    """Run the chip: WL-DAC quantise, gather rows into physical order, the
    multi-tile MAC (per-tile IR drop / variation / ADC, int32 digital
    reduction), then slice the padded columns back to ``out_dim``.

    v: [..., R] logical word-line values in [0, 1] -> [..., out_dim] f32.
    ``generator`` draws the per-tile readout noise (None: the kernel path).
    Stages ``xbar.wl_dac``, ``xbar.gather`` and ``kan.mac``
    (``obs.trace``).
    """
    with obs_trace.stage("xbar.wl_dac"):
        vq = cim_lib.quantize_wl(v, cfg.tile.input_bits)
    with obs_trace.stage("xbar.gather"):
        v_phys = torch.where(tiled.valid,
                             vq[..., tiled.logical_of_phys.long()], 0.0)
    with obs_trace.stage("kan.mac"):
        y = tiles_lib.tiled_mac(v_phys, tiled.w_phys, cfg.tile,
                                gain=tiled.gain, generator=generator)
        return y[..., :out_dim]


# ---------------------------------------------------------------------------
# Host-side roll-up
# ---------------------------------------------------------------------------

def layer_report(tiled: TiledLayer, out_dim: int, cfg: ChipConfig) -> Dict:
    tile = cfg.tile
    rp = int(tiled.logical_of_phys.shape[0])
    r = int(tiled.phys_of_logical.shape[0])
    n_placed = int(tiled.valid.sum())
    tr_alloc = rp // tile.array_size
    tc = int(tiled.w_phys.shape[1]) // tile.tile_cols
    row_tiles_used = -(-n_placed // tile.array_size) if n_placed else 0
    tiles_used = row_tiles_used * tc
    cells = tiles_used * tile.array_size * tile.tile_cols
    return {
        "rows": r, "rows_placed": n_placed, "rows_empty": r - n_placed,
        "slots": rp, "out_dim": out_dim,
        "grid": [tr_alloc, tc],
        "tiles_allocated": tr_alloc * tc,
        "tiles_used": tiles_used,
        "utilization": (n_placed * out_dim / cells) if cells else 0.0,
        "params_placed": n_placed * out_dim,
    }


def _repeat(tiled: TiledLayer, r: int) -> TiledLayer:
    """Repeat ``r`` of a stacked stage's placement."""
    return dataclasses.replace(tiled, **{
        f.name: getattr(tiled, f.name)[r] for f in dataclasses.fields(tiled)
        if getattr(tiled, f.name) is not None})


def chip_report(deployed, cfg: Optional[ChipConfig] = None) -> Dict:
    """Whole-chip roll-up for a ``cim_tiled``-deployed KAN: per-layer
    placement plus chip totals and the calibrated area/power/latency scale
    model of the placed parameters. The artifact of a stacked stage (its
    tensors carry a leading repeat axis, ``transformer.deploy_kan``) is
    reported repeat by repeat, its layers named ``{name}.{repeat}``; the
    reference reads such an artifact as one flat layer, which gives
    negative empty-row counts."""
    spec = deployed.spec
    if cfg is None:
        cfg = spec.cim if spec.cim is not None else ChipConfig()
    layers = {}
    for i, layer in enumerate(deployed.layers):
        if layer.tiles is None:
            raise ValueError(f"layer {i} carries no tiled placement "
                             "(was this deployed with backend='cim_tiled'?)")
        name = spec.names[i] if spec.names else f"l{i}"
        out_dim = spec.layer(i).out_dim
        if layer.tiles.w_phys.ndim == 3:
            for r in range(layer.tiles.w_phys.shape[0]):
                layers[f"{name}.{r}"] = layer_report(
                    _repeat(layer.tiles, r), out_dim, cfg)
        else:
            layers[name] = layer_report(layer.tiles, out_dim, cfg)
    alloc = sum(l["tiles_allocated"] for l in layers.values())
    used = sum(l["tiles_used"] for l in layers.values())
    params = sum(l["params_placed"] for l in layers.values())
    cost = cost_model.accelerator_cost(max(params, 1))
    tile_cells = cfg.tile.array_size * cfg.tile.tile_cols
    return {
        "layers": layers,
        "tiles_allocated": alloc,
        "tiles_used": used,
        "utilization": (params / (used * tile_cells)) if used else 0.0,
        "fits_inventory": (cfg.n_tiles is None or alloc <= cfg.n_tiles),
        "n_tiles_inventory": cfg.n_tiles,
        "area_mm2": cost.area_mm2,
        "power_w": cost.power_w,
        "latency_ns": cost.latency_ns,
        "energy_nj": cost.energy_nj,
    }


def publish_report(report: Dict, registry, *, prefix: str = "chip") -> None:
    """Publish a ``chip_report()`` roll-up into a ``repro_torch.obs``
    MetricsRegistry (duck-typed: anything with ``gauge(name, help,
    labels)``), so one ``obs`` snapshot describes serving latency AND the
    chip placement it runs on. Chip totals become plain gauges; per-layer
    placement stats become ``chip_layer_*`` gauges labeled by layer name."""
    totals = {
        "tiles_allocated": "tiles allocated across all layers",
        "tiles_used": "tiles actually programmed (after compaction)",
        "utilization": "placed params / programmed cells",
        "area_mm2": "cost-model area",
        "power_w": "cost-model power",
        "latency_ns": "cost-model latency",
        "energy_nj": "cost-model energy",
    }
    for key, help_ in totals.items():
        registry.gauge(f"{prefix}_{key}", help_).set(float(report[key]))
    for name, layer in report["layers"].items():
        labels = {"layer": name}
        for key in ("tiles_allocated", "tiles_used", "rows_placed",
                    "rows_empty", "utilization", "params_placed"):
            registry.gauge(f"{prefix}_layer_{key}",
                           f"per-layer {key.replace('_', ' ')}",
                           labels=labels).set(float(layer[key]))
