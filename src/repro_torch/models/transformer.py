"""Unified LM (port of ``repro.models.transformer``), as far as the SSM
serving slice needs it: the config types, the stage grouping, init,
forward and parameter counting, for models whose layers are ``ssd`` mixers
without an FFN (mamba2-1.3b).

The parameter tree keeps the JAX layout, so weights carry across leaf by
leaf (``params_from_numpy``): ``{"embed", "final_norm": {"scale"},
"stages": [{"l0": {"mixer_norm", "ssd": {...}}}]}``, each stage's leaves
stacked on a leading ``[repeats]`` axis. Stages run as a Python loop over
their repeats; JAX's ``remat``/``scan_layers`` choices have no effect on
the result and none here. Sharding (``dist.sharding.shard``) is Slice F.

Other mixers and FFNs raise ``NotImplementedError`` naming the ROADMAP
slice that ports them.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple, Union

import torch

from repro_torch import resolve_device
from repro_torch.core.kan import params_from_numpy  # noqa: F401 (the LM's)
from repro_torch.models import layers
from repro_torch.models import ssd as ssd_lib

Tensor = torch.Tensor

# what is not ported yet, and the ROADMAP slice that ports it
LATER = {
    "attn": "Slice D2 (attention, with the attention archs)",
    "swa": "Slice D2 (attention, with the attention archs)",
    "local": "Slice D2 (attention, with the attention archs)",
    "bidir": "Slice D2 (attention, with the attention archs)",
    "cross_attn": "Slice D2 (attention, with the attention archs)",
    "mlp": "Slice D2 (attention, with the attention archs)",
    "kan": "Slice D3 (kan_llm through kan.apply_any)",
    "moe": "Slice D4 (MoE)",
    "rglru": "Slice D5 (RG-LRU)",
    "encdec": "Slice D6 (the other configs)",
    "frontend": "Slice D6 (the other configs)",
    # the JAX package casts the parameters to the compute dtype before the
    # layer scan so that FSDP gathers move bf16
    "prescan_cast": "Slice F (distribution)",
}


def not_ported(what: str, name: str) -> NotImplementedError:
    return NotImplementedError(f"{what} {name!r} is not ported yet: "
                               f"ROADMAP {LATER[name]}")


def check_ported(spec: "LayerSpec") -> None:
    """Raise for a layer with parts of a later slice: ported are the
    ``ssd`` (or no) mixer without an FFN."""
    if spec.mixer not in ("ssd", "none"):
        raise not_ported("mixer", spec.mixer)
    if spec.cross_attn:
        raise not_ported("layer part", "cross_attn")
    if spec.ffn != "none":
        raise not_ported("ffn", spec.ffn)


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    mixer: str = "attn"     # attn|swa|local|bidir|rglru|ssd|none
    ffn: str = "mlp"        # mlp|moe|kan|none
    cross_attn: bool = False


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "dense"   # dense|moe|ssm|hybrid|encdec|vlm|audio
    n_layers: int = 2
    d_model: int = 128
    n_heads: int = 4
    n_kv_heads: int = 4
    d_ff: int = 256
    vocab: int = 1024
    head_dim: int = 0                    # 0 -> d_model // n_heads
    activation: str = "silu"
    gated_mlp: bool = True
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    norm: str = "rmsnorm"
    tie_embeddings: bool = True
    logits_softcap: float = 0.0
    # layer pattern
    block_pattern: Tuple[LayerSpec, ...] = (LayerSpec(),)
    first_layers: Tuple[LayerSpec, ...] = ()   # override for leading layers
    window: int = 0                      # swa window
    local_window: int = 0                # griffin local-attn window
    # moe
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    n_shared_experts: int = 0
    capacity_factor: float = 1.25
    # ssm
    ssm_state: int = 128
    ssm_head_dim: int = 64
    ssm_chunk: int = 64
    rnn_width: int = 0                   # rg-lru width (0 -> d_model)
    # enc-dec
    n_enc_layers: int = 0                # >0 => family encdec
    enc_bidirectional: bool = True
    # frontend stubs
    frontend: str = "none"               # none|audio_stub|vision_stub
    n_vision_patches: int = 256
    max_target_len: int = 8192           # learned positions for enc-dec dec
    # KAN-FFN (the paper's technique as a first-class FFN option)
    kan_hidden: int = 0                  # 0 -> d_ff // (G + K + 1)
    kan_grid: int = 8
    kan_order: int = 3
    kan_backend: str = "lut"             # core.kan registry: ref|lut|fused|cim
    # execution
    dtype: Any = torch.bfloat16
    param_dtype: Any = torch.float32
    remat: bool = True                   # no effect in the port
    scan_layers: bool = True
    attn_kv_chunk: int = 512
    # perf levers of the JAX package
    ce_impl: str = "gather"              # "gather" | "onehot" (sharded-safe)
    prescan_cast: bool = False           # Slice F: raises when set
    kv_shard_mode: str = "head_dim"      # "head_dim" | "replicate" for KV
    moe_serve_stationary: bool = False   # weights-stationary MoE at decode
    pad_attn_heads: int = 0              # 0 = off; else multiple to pad to
    seq_shard_activations: bool = False  # sharding: Slice F

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def _pad(self, n: int) -> int:
        m = self.pad_attn_heads
        return n if not m else -(-n // m) * m

    @property
    def padded_heads(self) -> int:
        return self._pad(self.n_heads)

    @property
    def padded_kv_heads(self) -> int:
        return self._pad(self.n_kv_heads)

    @property
    def ssd_cfg(self) -> ssd_lib.SSDConfig:
        return ssd_lib.SSDConfig(
            d_model=self.d_model, d_state=self.ssm_state,
            head_dim=self.ssm_head_dim, chunk=self.ssm_chunk,
            dtype=self.param_dtype)

    def layer_specs(self, n_layers: Optional[int] = None) -> List[LayerSpec]:
        n = n_layers if n_layers is not None else self.n_layers
        specs = list(self.first_layers)
        i = 0
        while len(specs) < n:
            specs.append(self.block_pattern[i % len(self.block_pattern)])
            i += 1
        return specs[:n]


@dataclasses.dataclass(frozen=True)
class Stage:
    block: Tuple[LayerSpec, ...]
    repeats: int


def compute_stages(specs: Sequence[LayerSpec],
                   pattern_len: int) -> List[Stage]:
    """Group layers into (pattern block x repeats) stages."""
    stages: List[Stage] = []
    i = 0
    n = len(specs)
    while i < n:
        blk = tuple(specs[i:i + pattern_len])
        reps = 1
        while (i + (reps + 1) * len(blk) <= n
               and tuple(specs[i + reps * len(blk):
                               i + (reps + 1) * len(blk)]) == blk):
            reps += 1
        if len(blk) == pattern_len and reps > 1:
            stages.append(Stage(blk, reps))
            i += reps * len(blk)
        else:
            stages.append(Stage((specs[i],), 1))
            i += 1
    return stages


def stages_for(cfg: ModelConfig, n_layers: Optional[int] = None,
               encoder: bool = False) -> List[Stage]:
    if encoder:
        specs = [LayerSpec("bidir", "mlp")] * cfg.n_enc_layers
        if not cfg.scan_layers:
            return [Stage((sp,), 1) for sp in specs]
        return compute_stages(specs, 1)
    specs = cfg.layer_specs(n_layers)
    if cfg.family == "encdec":
        specs = [dataclasses.replace(s, cross_attn=True) for s in specs]
    if not cfg.scan_layers:
        return [Stage((sp,), 1) for sp in specs]
    return compute_stages(specs, len(cfg.block_pattern))


# ---------------------------------------------------------------------------
# parameter trees
# ---------------------------------------------------------------------------

def tree_map(fn, tree):
    """``fn`` on every tensor leaf of nested dicts and lists."""
    if isinstance(tree, Mapping):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def tree_leaves(tree) -> List[Tensor]:
    if isinstance(tree, Mapping):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_stack(trees: Sequence) -> Any:
    """Stack matching trees on a new leading axis."""
    first = trees[0]
    if isinstance(first, Mapping):
        return {k: tree_stack([t[k] for t in trees]) for k in first}
    return torch.stack(list(trees))


def layer_of(tree, r: int):
    """Repeat ``r`` of a stacked stage tree (views, no copies)."""
    return tree_map(lambda a: a[r], tree)


def count_params(params) -> int:
    return sum(int(p.numel()) for p in tree_leaves(params))


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _init_layer(gen, spec: LayerSpec, cfg: ModelConfig, device) -> Dict:
    check_ported(spec)
    p: Dict[str, Any] = {}
    if spec.mixer == "ssd":
        p["mixer_norm"] = layers.NORM_INIT[cfg.norm](cfg.d_model, device)
        p["ssd"] = ssd_lib.init_ssd_block(gen, cfg.ssd_cfg, device)
    return p


def _init_stage(gen, stage: Stage, cfg: ModelConfig, device) -> Dict:
    def init_block():
        return {f"l{i}": _init_layer(gen, sp, cfg, device)
                for i, sp in enumerate(stage.block)}
    if stage.repeats == 1:
        return init_block()
    return tree_stack([init_block() for _ in range(stage.repeats)])


def generator(seed: Union[int, torch.Generator], device) -> torch.Generator:
    """``seed`` as a generator that can fill ``device``: a CUDA generator
    on the card, a CPU one elsewhere (the meta device included)."""
    if isinstance(seed, torch.Generator):
        return seed
    gdev = device if device.type == "cuda" else torch.device("cpu")
    return torch.Generator(device=gdev).manual_seed(int(seed))


def init_model(seed: Union[int, torch.Generator], cfg: ModelConfig, *,
               device=None) -> Dict:
    """Random weights in the JAX layout, drawn from ``seed`` (an int or a
    generator on ``device``). ``device=None`` is the card; ``"meta"`` gives
    shapes only (parameter counts at full width without allocating). JAX's
    ``n_model`` argument shapes MoE experts, which are Slice D4."""
    device = resolve_device(device)
    if cfg.family == "encdec":
        raise not_ported("family", "encdec")
    gen = generator(seed, device)
    params: Dict[str, Any] = {
        "embed": layers.init_embedding(gen, cfg.vocab, cfg.d_model,
                                       dtype=cfg.param_dtype, device=device),
        "final_norm": layers.NORM_INIT[cfg.norm](cfg.d_model, device),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = layers.init_embedding(
            gen, cfg.vocab, cfg.d_model, dtype=cfg.param_dtype,
            device=device)
    params["stages"] = [_init_stage(gen, st, cfg, device)
                        for st in stages_for(cfg)]
    return params


# ---------------------------------------------------------------------------
# forward (train / prefill)
# ---------------------------------------------------------------------------

def _apply_layer(p, x: Tensor, spec: LayerSpec, cfg: ModelConfig) -> Tensor:
    check_ported(spec)
    if spec.mixer == "ssd":
        xn = layers.NORM_APPLY[cfg.norm](p["mixer_norm"], x)
        # the block returns f32; the residual add is in the compute dtype
        x = x + ssd_lib.apply_ssd_block(p["ssd"], xn, cfg.ssd_cfg
                                        ).to(x.dtype)
    return x


def _run_stages(stage_params, stages: Sequence[Stage], x: Tensor,
                cfg: ModelConfig) -> Tensor:
    """Every layer in order, a stage's repeats in a Python loop."""
    if cfg.prescan_cast:
        raise not_ported("option", "prescan_cast")
    for st_params, stage in zip(stage_params, stages):
        for r in range(stage.repeats):
            lp = st_params if stage.repeats == 1 else layer_of(st_params, r)
            for i, spec in enumerate(stage.block):
                x = _apply_layer(lp[f"l{i}"], x, spec, cfg)
    return x


def embed_inputs(params, cfg: ModelConfig, batch: Mapping) -> Tensor:
    """Token embedding in the compute dtype (the modality stubs are not
    ported)."""
    if cfg.frontend != "none":
        raise not_ported("frontend", "frontend")
    table = params["embed"]
    tokens = torch.as_tensor(batch["tokens"], device=table.device)
    return layers.embed_lookup(table, tokens).to(cfg.dtype)


def logits_from(params, cfg: ModelConfig, x: Tensor) -> Tensor:
    """Final norm and the tied (or separate) unembedding, whose table is
    cast to the compute dtype: at bf16 the product and the logits are bf16."""
    x = layers.NORM_APPLY[cfg.norm](params["final_norm"], x)
    table = params.get("unembed", params["embed"])
    logits = layers.unembed(x, table.to(cfg.dtype))
    if cfg.logits_softcap:
        c = cfg.logits_softcap
        logits = c * torch.tanh(logits / c)
    return logits


def forward(params, cfg: ModelConfig, batch: Mapping
            ) -> Tuple[Tensor, Tensor]:
    """Full forward -> (logits [B,S,V], aux loss scalar). The aux loss is
    MoE's (Slice D4); without MoE layers it is 0."""
    if cfg.family == "encdec":
        raise not_ported("family", "encdec")
    x = embed_inputs(params, cfg, batch)
    x = _run_stages(params["stages"], stages_for(cfg), x, cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return logits_from(params, cfg, x), aux
