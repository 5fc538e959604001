"""phi3-medium-14b [dense]: 40L, d_model=5120, 40H (GQA kv=10), d_ff=17920,
vocab=100352, RoPE + SwiGLU + GQA. [arXiv:2404.14219]"""
import dataclasses
import torch
from repro_torch.configs import ArchConfig
from repro_torch.models.transformer import LayerSpec, ModelConfig

CONFIG = ArchConfig(
    model=ModelConfig(
        name="phi3-medium-14b", family="dense",
        n_layers=40, d_model=5120, n_heads=40, n_kv_heads=10, head_dim=128,
        d_ff=17920, vocab=100352,
        block_pattern=(LayerSpec("attn", "mlp"),),
        # optimized (§Perf cell B): 40 q-heads / 10 kv-heads don't divide the
        # 16-way model axis; zero-padding to 48/16 removes the head_dim-shard
        # fallback whose score contractions all-reduced [B,S,Kv,G,T] tensors
        # (collective term 519.8s -> 4.1s at +3.5% compute).
        pad_attn_heads=16, ce_impl="onehot", prescan_cast=True,
        seq_shard_activations=True,
        dtype=torch.bfloat16, param_dtype=torch.float32),
    optimizer="adamw", learning_rate=3e-4, accum_steps=8,
    subquadratic=False,
    notes="kv=10/heads=40 don't divide the model axis: baseline falls back "
          "to head_dim KV sharding; optimized profile pads heads to 48/16")

SMOKE = dataclasses.replace(
    CONFIG,
    model=dataclasses.replace(
        CONFIG.model, n_layers=2, d_model=80, n_heads=5, n_kv_heads=5,
        head_dim=16, d_ff=128, vocab=512, dtype=torch.float32))
