"""mistral-nemo-12b [dense]: 40L, d_model=5120, 32H (GQA kv=8, head_dim 128),
d_ff=14336, vocab=131072, 128k ctx. [hf:mistralai/Mistral-Nemo-Base-2407]"""
import dataclasses
import torch
from repro_torch.configs import ArchConfig
from repro_torch.models.transformer import LayerSpec, ModelConfig

CONFIG = ArchConfig(
    model=ModelConfig(
        name="mistral-nemo-12b", family="dense",
        n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8, head_dim=128,
        d_ff=14336, vocab=131072, rope_theta=1e6,
        block_pattern=(LayerSpec("attn", "mlp"),),
        ce_impl="onehot", prescan_cast=True, seq_shard_activations=True,
        kv_shard_mode="replicate",
        dtype=torch.bfloat16, param_dtype=torch.float32),
    optimizer="adamw", learning_rate=3e-4, accum_steps=8,
    subquadratic=False,
    notes="pure full attention: long_500k skipped")

SMOKE = dataclasses.replace(
    CONFIG,
    model=dataclasses.replace(
        CONFIG.model, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        head_dim=16, d_ff=128, vocab=512, dtype=torch.float32))
