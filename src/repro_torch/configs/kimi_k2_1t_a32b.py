"""kimi-k2-1t-a32b [moe]: 61L, d_model=7168, 64H (GQA kv=8, head_dim 128),
MoE 384 experts top-8 with d_ff=2048 per expert + 1 shared expert; first
layer dense (d_ff=18432); vocab=163840. ~1T params, 32B active.
[arXiv:2501.kimi2 (paper-table)]"""
import dataclasses
import torch
from repro_torch.configs import ArchConfig
from repro_torch.models.transformer import LayerSpec, ModelConfig

CONFIG = ArchConfig(
    model=ModelConfig(
        name="kimi-k2-1t-a32b", family="moe",
        n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8, head_dim=128,
        d_ff=18432, moe_d_ff=2048, vocab=163840,
        n_experts=384, top_k=8, n_shared_experts=1,
        first_layers=(LayerSpec("attn", "mlp"),),
        block_pattern=(LayerSpec("attn", "moe"),),
        # optimized (§Perf cell C): weights-stationary MoE at decode (expert
        # weights never move; token activations replicate + one psum) and
        # replicated-KV activations: per-token collective 6.12s -> 0.16s.
        moe_serve_stationary=True, kv_shard_mode="replicate",
        ce_impl="onehot", prescan_cast=True, seq_shard_activations=True,
        dtype=torch.bfloat16, param_dtype=torch.bfloat16),
    optimizer="adafactor", learning_rate=2e-4, accum_steps=16,
    grad_dtype=torch.bfloat16,
    subquadratic=False,
    notes="1T params: bf16 params + bf16 grad accum + Adafactor. Single-pod "
          "256xv5e is ~2GB/chip over HBM budget (see EXPERIMENTS §Dry-run); "
          "multi-pod 512 fits.")

SMOKE = dataclasses.replace(
    CONFIG,
    model=dataclasses.replace(
        CONFIG.model, n_layers=3, d_model=64, n_heads=4, n_kv_heads=2,
        head_dim=16, d_ff=160, moe_d_ff=48, vocab=512, n_experts=8, top_k=2,
        dtype=torch.float32, param_dtype=torch.float32),
    grad_dtype=torch.float32, accum_steps=2)
