"""recurrentgemma-2b [hybrid]: 26L, d_model=2560, 10H MQA (kv=1), d_ff=7680,
vocab=256000; RG-LRU + local attention, pattern 1 attn : 2 recurrent
(Griffin), local window 2048. [arXiv:2402.19427]"""
import dataclasses
import torch
from repro_torch.configs import ArchConfig
from repro_torch.models.transformer import LayerSpec, ModelConfig

CONFIG = ArchConfig(
    model=ModelConfig(
        name="recurrentgemma-2b", family="hybrid",
        n_layers=26, d_model=2560, n_heads=10, n_kv_heads=1, head_dim=256,
        d_ff=7680, vocab=256000, activation="gelu", gated_mlp=True,
        local_window=2048, rnn_width=2560, logits_softcap=30.0,
        block_pattern=(LayerSpec("rglru", "mlp"), LayerSpec("rglru", "mlp"),
                       LayerSpec("local", "mlp")),
        ce_impl="onehot", prescan_cast=True, seq_shard_activations=True,
        dtype=torch.bfloat16, param_dtype=torch.float32),
    optimizer="adamw", learning_rate=4e-4, accum_steps=8,
    subquadratic=True,
    notes="RG-LRU state + 2048-window local attn => O(1) decode state")

SMOKE = dataclasses.replace(
    CONFIG,
    model=dataclasses.replace(
        CONFIG.model, n_layers=5, d_model=64, n_heads=4, n_kv_heads=1,
        head_dim=16, d_ff=128, vocab=512, local_window=16, rnn_width=64,
        dtype=torch.float32))
