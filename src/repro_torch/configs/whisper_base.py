"""whisper-base [audio]: 6L enc + 6L dec, d_model=512, 8H MHA, d_ff=2048,
vocab=51865. Encoder-decoder; conv frontend is a STUB (the batch provides
precomputed frame embeddings). [arXiv:2212.04356]"""
import dataclasses
import torch
from repro_torch.configs import ArchConfig
from repro_torch.models.transformer import LayerSpec, ModelConfig

CONFIG = ArchConfig(
    model=ModelConfig(
        name="whisper-base", family="encdec",
        n_layers=6, n_enc_layers=6, d_model=512, n_heads=8, n_kv_heads=8,
        d_ff=2048, vocab=51865, activation="gelu", gated_mlp=False,
        norm="layernorm", rope_theta=0.0, frontend="audio_stub",
        max_target_len=32768 + 8,
        block_pattern=(LayerSpec("attn", "mlp"),),
        ce_impl="onehot",
        dtype=torch.bfloat16, param_dtype=torch.float32),
    optimizer="adamw", learning_rate=1e-3, accum_steps=8,
    subquadratic=False,
    notes="full-attention enc-dec: long_500k skipped (see DESIGN.md §5)")

SMOKE = dataclasses.replace(
    CONFIG,
    model=dataclasses.replace(
        CONFIG.model, n_layers=2, n_enc_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, d_ff=128, vocab=512, max_target_len=128,
        dtype=torch.float32))
