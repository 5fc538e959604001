"""mamba2-1.3b [ssm]: 48L, d_model=2048, attention-free SSD blocks
(state-space duality), ssm_state=128, vocab=50280. No FFN (d_ff=0).
[arXiv:2405.21060]"""
import dataclasses

import torch

from repro_torch.configs import ArchConfig
from repro_torch.models.transformer import LayerSpec, ModelConfig

CONFIG = ArchConfig(
    model=ModelConfig(
        name="mamba2-1.3b", family="ssm",
        n_layers=48, d_model=2048, n_heads=1, n_kv_heads=1, d_ff=0,
        vocab=50280, ssm_state=128, ssm_head_dim=64, ssm_chunk=256,
        block_pattern=(LayerSpec("ssd", "none"),),
        ce_impl="onehot", seq_shard_activations=True,
        dtype=torch.bfloat16, param_dtype=torch.float32),
    optimizer="adamw", learning_rate=6e-4, accum_steps=8,
    subquadratic=True,
    notes="attention-free: O(1) decode state; long_500k applicable")

SMOKE = dataclasses.replace(
    CONFIG,
    model=dataclasses.replace(
        CONFIG.model, n_layers=3, d_model=64, vocab=512, ssm_state=16,
        ssm_head_dim=16, ssm_chunk=16, dtype=torch.float32))
