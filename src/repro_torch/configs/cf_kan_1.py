"""CF-KAN-1 (paper §4.D, Fig. 19): 39 MB high-performance operating point.
Sized to ~39M 8-bit parameters: G=7, K=3 in both layers."""
import dataclasses

from repro_torch.configs import ArchConfig
from repro_torch.core.quant import ASPConfig
from repro_torch.models import cf_kan
from repro_torch.models.transformer import ModelConfig

MODEL = cf_kan.CFKANConfig(
    n_items=16384, hidden=108,
    asp_enc=ASPConfig(grid_size=7, order=3, n_bits=8),
    asp_dec=ASPConfig(grid_size=7, order=3, n_bits=8),
    name="cf-kan-1")

SMOKE_MODEL = dataclasses.replace(MODEL, n_items=256, hidden=16)

# ArchConfig shim so that the registry knows CF-KAN too (``MODEL`` is the
# model)
CONFIG = ArchConfig(model=ModelConfig(name="cf-kan-1", family="cfkan"),
                    optimizer="adamw", learning_rate=1e-3,
                    notes="paper's own arch; see MODEL")
SMOKE = ArchConfig(model=ModelConfig(name="cf-kan-1", family="cfkan"),
                   optimizer="adamw", learning_rate=1e-3)
