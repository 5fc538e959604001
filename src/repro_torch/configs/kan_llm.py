"""KAN-FFN LLM: the paper's §1 thesis (KAN replacing the transformer MLP
blocks) as a servable registry arch, which drives the deploy()/apply()
contract end to end: ``transformer.deploy_kan`` freezes the KAN artifacts
once, and decode then runs no requantisation. The KAN-FFN is 256 -> 85 ->
256 (G=8, K=3, L=32).

Not one of the assigned published architectures: it lives in
``AUX_ARCH_IDS`` (servable extras).
"""
import dataclasses

import torch

from repro_torch.configs import ArchConfig
from repro_torch.models.transformer import LayerSpec, ModelConfig

MODEL = ModelConfig(
    name="kan-llm-30m", n_layers=4, d_model=256, n_heads=8, n_kv_heads=4,
    d_ff=1024, vocab=4096, dtype=torch.float32,
    block_pattern=(LayerSpec("attn", "kan"),),
    kan_grid=8, kan_order=3, kan_backend="lut")

CONFIG = ArchConfig(model=MODEL, optimizer="adamw", learning_rate=3e-4,
                    notes="KAN-FFN serving vehicle for the deploy/apply "
                          "contract (core.kan backend registry)")

SMOKE = ArchConfig(
    model=dataclasses.replace(
        MODEL, name="kan-llm-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=128, vocab=256),
    optimizer="adamw", learning_rate=3e-4)
