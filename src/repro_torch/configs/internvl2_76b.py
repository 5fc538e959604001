"""internvl2-76b [vlm]: LM backbone 80L, d_model=8192, 64H (GQA kv=8),
d_ff=28672, vocab=128256 (InternViT frontend is a STUB: the batch provides
precomputed patch embeddings). [arXiv:2404.16821]"""
import dataclasses
import torch
from repro_torch.configs import ArchConfig
from repro_torch.models.transformer import LayerSpec, ModelConfig

CONFIG = ArchConfig(
    model=ModelConfig(
        name="internvl2-76b", family="vlm",
        n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
        d_ff=28672, vocab=128256, frontend="vision_stub",
        n_vision_patches=256,
        block_pattern=(LayerSpec("attn", "mlp"),),
        ce_impl="onehot", prescan_cast=True, seq_shard_activations=True,
        kv_shard_mode="replicate",
        dtype=torch.bfloat16, param_dtype=torch.float32),
    optimizer="adamw", learning_rate=2e-4, accum_steps=16,
    subquadratic=False)

SMOKE = dataclasses.replace(
    CONFIG,
    model=dataclasses.replace(
        CONFIG.model, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        head_dim=16, d_ff=128, vocab=512, n_vision_patches=8,
        dtype=torch.float32))
