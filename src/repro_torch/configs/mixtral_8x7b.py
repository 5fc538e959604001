"""mixtral-8x7b [moe]: 32L, d_model=4096, 32H (GQA kv=8), 8 experts top-2
with d_ff=14336 per expert, SWA window 4096, vocab=32000. [arXiv:2401.04088]"""
import dataclasses
import torch
from repro_torch.configs import ArchConfig
from repro_torch.models.transformer import LayerSpec, ModelConfig

CONFIG = ArchConfig(
    model=ModelConfig(
        name="mixtral-8x7b", family="moe",
        n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
        d_ff=14336, moe_d_ff=14336, vocab=32000,
        n_experts=8, top_k=2, window=4096,
        block_pattern=(LayerSpec("swa", "moe"),),
        ce_impl="onehot", prescan_cast=True, seq_shard_activations=True,
        kv_shard_mode="replicate", moe_serve_stationary=True,
        dtype=torch.bfloat16, param_dtype=torch.float32),
    optimizer="adamw", learning_rate=3e-4, accum_steps=8,
    subquadratic=True,
    notes="SWA => rolling 4096 cache; long_500k decode state is O(window)")

SMOKE = dataclasses.replace(
    CONFIG,
    model=dataclasses.replace(
        CONFIG.model, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        head_dim=16, d_ff=96, moe_d_ff=96, vocab=512, n_experts=4, top_k=2,
        window=16, capacity_factor=4.0, dtype=torch.float32))
# (smoke capacity_factor=4.0 => no token dropping, so teacher-forced forward
# and prefill/decode are bit-consistent; the full config keeps 1.25 — MoE
# capacity depends on the token count per dispatch, a known drop semantics)
