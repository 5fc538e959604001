"""CF-KAN-2 (paper §4.D, Fig. 19): 63 MB high-accuracy operating point.
Uniform G=15 grids in both layers."""
import dataclasses

from repro_torch.core.quant import ASPConfig
from repro_torch.models import cf_kan

MODEL = cf_kan.CFKANConfig(
    n_items=16384, hidden=101,
    asp_enc=ASPConfig(grid_size=15, order=3, n_bits=8),
    asp_dec=ASPConfig(grid_size=15, order=3, n_bits=8),
    name="cf-kan-2")

SMOKE_MODEL = dataclasses.replace(MODEL, n_items=256, hidden=16)
