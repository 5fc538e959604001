"""CF-KAN-2 (paper §4.D, Fig. 19): 63 MB high-accuracy operating point.
Uniform G=15 grids in both layers."""
import dataclasses

from repro_torch.configs import ArchConfig
from repro_torch.core.quant import ASPConfig
from repro_torch.models import cf_kan
from repro_torch.models.transformer import ModelConfig

MODEL = cf_kan.CFKANConfig(
    n_items=16384, hidden=101,
    asp_enc=ASPConfig(grid_size=15, order=3, n_bits=8),
    asp_dec=ASPConfig(grid_size=15, order=3, n_bits=8),
    name="cf-kan-2")

SMOKE_MODEL = dataclasses.replace(MODEL, n_items=256, hidden=16)

# ArchConfig shim so that the registry knows CF-KAN too (``MODEL`` is the
# model)
CONFIG = ArchConfig(model=ModelConfig(name="cf-kan-2", family="cfkan"),
                    optimizer="adamw", learning_rate=1e-3,
                    notes="paper's own arch; see MODEL")
SMOKE = ArchConfig(model=ModelConfig(name="cf-kan-2", family="cfkan"),
                   optimizer="adamw", learning_rate=1e-3)
