"""nemotron-4-340b [dense]: 96L, d_model=18432, 96H (GQA kv=8), d_ff=73728,
vocab=256000, squared-ReLU MLP (non-gated), untied embeddings.
[arXiv:2402.16819]"""
import dataclasses
import torch
from repro_torch.configs import ArchConfig
from repro_torch.models.transformer import LayerSpec, ModelConfig

CONFIG = ArchConfig(
    model=ModelConfig(
        name="nemotron-4-340b", family="dense",
        n_layers=96, d_model=18432, n_heads=96, n_kv_heads=8, head_dim=192,
        d_ff=73728, vocab=256000, activation="relu2", gated_mlp=False,
        tie_embeddings=False,
        block_pattern=(LayerSpec("attn", "mlp"),),
        ce_impl="onehot", prescan_cast=True, seq_shard_activations=True,
        kv_shard_mode="replicate",
        dtype=torch.bfloat16, param_dtype=torch.float32),
    optimizer="adafactor", learning_rate=1.5e-4, accum_steps=16,
    subquadratic=False,
    notes="340B: Adafactor + accum=8 to fit v5e HBM at 256 chips")

SMOKE = dataclasses.replace(
    CONFIG,
    model=dataclasses.replace(
        CONFIG.model, n_layers=2, d_model=96, n_heads=6, n_kv_heads=2,
        head_dim=16, d_ff=192, vocab=512, dtype=torch.float32))
