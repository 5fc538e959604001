"""The system under test: CF-KAN as the program (``repro_torch``) serves
it. Everything the benchmark asks of the program goes through here: the
configuration as the program takes it, the deploy, and the two calls of the
timed path, ``kan.apply`` on the deployed artifact and the ranking to the
top k unobserved items.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

from repro_torch.core import kan
from repro_torch.core.quant import ASPConfig
from repro_torch.hw import chip, cim, tiles, variation
from repro_torch.models import cf_kan


def cf_config(model: Dict, coeff_bits: Optional[int] = None
              ) -> cf_kan.CFKANConfig:
    """The program's CF-KAN configuration for a configuration file, with the
    coefficient codes at ``coeff_bits`` if given (the control)."""
    def asp(grid: int) -> ASPConfig:
        return ASPConfig(grid_size=grid, order=model["order"],
                         n_bits=model["n_bits"], x_min=model["x_min"],
                         x_max=model["x_max"],
                         coeff_bits=coeff_bits or model["coeff_bits"])
    return cf_kan.CFKANConfig(
        n_items=model["n_items"], hidden=model["hidden"],
        asp_enc=asp(model["grid_size_enc"]),
        asp_dec=asp(model["grid_size_dec"]), name=model["name"])


def hardware(traffic: Dict, seed: int):
    """The program's crossbar (``cim``) or chip (``cim_tiled``) configuration
    of a traffic file, the chip's variation drawn from ``seed``."""
    hw = traffic["hardware"]
    if hw is None:
        return None
    kw = dict(array_size=hw["array_size"], adc_bits=hw["adc_bits"],
              gamma0=hw["gamma0"], input_bits=hw["input_bits"],
              adc_in_scale=hw["adc_in_scale"])
    if hw["kind"] == "crossbar":
        return cim.CIMConfig(**kw)
    return chip.ChipConfig(
        tile=tiles.TileConfig(tile_cols=hw["tile_cols"], **kw),
        variation=variation.VariationConfig(sigma=hw["variation_sigma"],
                                            clip=hw["variation_clip"],
                                            seed=seed))


def deploy(params: Dict, model: Dict, traffic: Dict, seed: int,
           sample: Sequence[torch.Tensor],
           coeff_bits: Optional[int] = None) -> kan.DeployedKAN:
    """The program's deploy of the float weights on the traffic's backend;
    KAN-SAM takes its Phase-A statistics from ``sample``."""
    cfg = cf_config(model, coeff_bits)
    stats = (cf_kan.collect_layer_stats(params, list(sample), cfg)
             if traffic["sam"] else None)
    spec = cfg.kan_spec.with_backend(traffic["backend"],
                                     cim=hardware(traffic, seed),
                                     use_sam=traffic["sam"])
    return kan.deploy(params, spec, stats=stats)


def apply(deployed: kan.DeployedKAN, x: torch.Tensor) -> torch.Tensor:
    """Scores [B, n_items] of users ``x`` [B, n_items]."""
    return kan.apply(deployed, x)


def rank(scores: torch.Tensor, x: torch.Tensor, k: int) -> torch.Tensor:
    """The ids [B, k] of each user's k best unobserved items, as the
    program's Recall@k ranks them."""
    return cf_kan._top_k(scores, x, k)
