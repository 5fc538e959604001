"""qwen2-72b [dense]: 80L, d_model=8192, 64H (GQA kv=8), d_ff=29568,
vocab=152064, QKV bias. [arXiv:2407.10671]"""
import dataclasses
import torch
from repro_torch.configs import ArchConfig
from repro_torch.models.transformer import LayerSpec, ModelConfig

CONFIG = ArchConfig(
    model=ModelConfig(
        name="qwen2-72b", family="dense",
        n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
        d_ff=29568, vocab=152064, qkv_bias=True, tie_embeddings=False,
        block_pattern=(LayerSpec("attn", "mlp"),),
        # optimized profile (EXPERIMENTS.md §Perf, cell A): sharded-safe CE,
        # bf16 pre-scan param cast, replicated KV activations, Megatron-SP
        # activations; accum=16 -> 6.6 GiB temp/device (fits v5e).
        ce_impl="onehot", prescan_cast=True, kv_shard_mode="replicate",
        seq_shard_activations=True,
        dtype=torch.bfloat16, param_dtype=torch.float32),
    optimizer="adamw", learning_rate=2e-4, accum_steps=16,
    subquadratic=False)

SMOKE = dataclasses.replace(
    CONFIG,
    model=dataclasses.replace(
        CONFIG.model, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        head_dim=16, d_ff=128, vocab=512, dtype=torch.float32))
