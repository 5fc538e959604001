"""Unified LM (port of ``repro.models.transformer``): the config types, the
stage grouping, init, forward, the training loss, parameter counting and
``deploy_kan``, for decoder-only and encoder-decoder models whose layers mix
with ``attn`` (full causal GQA), ``swa`` (sliding window), ``local``
(Griffin local attention), ``bidir`` (bidirectional, the encoder's), ``ssd``
or ``rglru`` (Griffin's RG-LRU), optionally followed by cross attention
over the encoder's output, and whose FFN is ``mlp``, ``moe``
(``models.moe``, on one device), ``kan`` (the paper's ASP-KAN-HAQ KAN-FFN
through ``core.kan``) or none. The modality frontends are the reference's
stubs: ``audio_stub`` takes precomputed frame embeddings plus sinusoidal
positions as the encoder's input, ``vision_stub`` writes precomputed patch
embeddings over the first positions of the token embedding.

The parameter tree keeps the JAX layout, so weights carry across leaf by
leaf (``params_from_numpy``): ``{"embed", "final_norm": {"scale"},
"stages": [{"l0": {"mixer_norm", "attn": {...}, "ffn_norm", "mlp": ...}}]}``,
each stage's leaves stacked on a leading ``[repeats]`` axis (a deployed
KAN-FFN is one ``kan.DeployedKAN`` whose tensors carry that axis); an
encoder-decoder adds ``enc_stages``, ``enc_final_norm`` and the decoder's
learned positions ``dec_pos``, and its decoder layers ``cross_norm`` and
``cross``. Stages run as a Python loop over their repeats; JAX's
``remat``/``scan_layers`` choices have no effect on the result and none
here. ``param_spec`` gives every leaf's logical sharding names; under a
mesh (``dist.sharding.use_mesh``, parameters as DTensors placed by
``distribute_tree``) the activations are constrained with ``shard`` at the
reference's places and DTensor propagates the rest.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple, Union

import torch
import torch.utils.checkpoint

from repro_torch import resolve_device
from repro_torch.core import kan
from repro_torch.core.kan import params_from_numpy  # noqa: F401 (the LM's)
from repro_torch.core.quant import ASPConfig
from repro_torch.dist.sharding import shard
from repro_torch.models import attention as attn_lib
from repro_torch.models import layers
from repro_torch.models import moe as moe_lib
from repro_torch.models import rglru as rglru_lib
from repro_torch.models import ssd as ssd_lib

Tensor = torch.Tensor

ATTN_MIXERS = ("attn", "swa", "local", "bidir")


def check_ported(spec: "LayerSpec") -> None:
    """Raise ValueError for a layer part no package knows: the mixers are
    the attention ones, ``ssd``, ``rglru`` or none, the FFNs ``mlp``,
    ``moe``, ``kan`` or none (either with or without cross attention)."""
    if spec.mixer not in ATTN_MIXERS + ("ssd", "rglru", "none"):
        raise ValueError(f"unknown mixer {spec.mixer!r}")
    if spec.ffn not in ("mlp", "moe", "kan", "none"):
        raise ValueError(f"unknown ffn {spec.ffn!r}")


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
    kan_backend: str = "lut"             # a core.kan backend name
    # execution
    dtype: Any = torch.bfloat16
    param_dtype: Any = torch.float32
    remat: bool = True                   # per-block recompute (autograd)
    scan_layers: bool = True
    attn_kv_chunk: int = 512
    # perf levers of the JAX package
    ce_impl: str = "gather"              # "gather" | "onehot" (sharded-safe)
    prescan_cast: bool = False           # cast params to compute dtype once
    kv_shard_mode: str = "head_dim"      # "head_dim" | "replicate" for KV
    moe_serve_stationary: bool = False   # weights-stationary MoE at decode
    pad_attn_heads: int = 0              # 0 = off; else multiple to pad to
    seq_shard_activations: bool = False  # block outputs on "seq_sp"

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
    def kan_spec(self) -> kan.KANSpec:
        asp = ASPConfig(grid_size=self.kan_grid, order=self.kan_order)
        hidden = self.kan_hidden or max(
            8, self.d_ff // (self.kan_grid + self.kan_order + 1))
        return kan.KANSpec.ffn(self.d_model, hidden, asp,
                               backend=self.kan_backend,
                               dtype=self.param_dtype)

    @property
    def moe_cfg(self) -> moe_lib.MoEConfig:
        return moe_lib.MoEConfig(
            d_model=self.d_model, d_ff=self.moe_d_ff or self.d_ff,
            n_experts=self.n_experts, top_k=self.top_k,
            n_shared_experts=self.n_shared_experts,
            capacity_factor=self.capacity_factor,
            activation=self.activation, dtype=self.param_dtype)

    @property
    def ssd_cfg(self) -> ssd_lib.SSDConfig:
        return ssd_lib.SSDConfig(
            d_model=self.d_model, d_state=self.ssm_state,
            head_dim=self.ssm_head_dim, chunk=self.ssm_chunk,
            dtype=self.param_dtype)

    @property
    def rglru_cfg(self) -> rglru_lib.RGLRUConfig:
        return rglru_lib.RGLRUConfig(
            d_model=self.d_model, d_rnn=self.rnn_width or self.d_model,
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

def _fields(node) -> List[str]:
    """The fields of an artifact node (``kan.DeployedLayer`` or
    ``hw.chip.TiledLayer``) that hold tensors or further nodes."""
    return [f.name for f in dataclasses.fields(node)]


def tree_map(fn, tree):
    """``fn`` on every tensor leaf of nested dicts, lists and deployed KAN
    artifacts (``kan.DeployedKAN`` keeps its spec; a ``None`` field stays
    ``None``)."""
    if isinstance(tree, Mapping):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    if isinstance(tree, kan.DeployedKAN):
        return kan.DeployedKAN(tuple(tree_map(fn, l) for l in tree.layers),
                               tree.spec)
    if tree is None:
        return None
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f: tree_map(fn, getattr(tree, f)) for f in _fields(tree)})
    return fn(tree)


def tree_leaves(tree) -> List[Tensor]:
    if isinstance(tree, Mapping):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    if isinstance(tree, kan.DeployedKAN):
        return tree_leaves(list(tree.layers))
    if tree is None:
        return []
    if dataclasses.is_dataclass(tree):
        return tree_leaves([getattr(tree, f) for f in _fields(tree)])
    return [tree]


def tree_stack(trees: Sequence) -> Any:
    """Stack matching trees on a new leading axis."""
    first = trees[0]
    if isinstance(first, Mapping):
        return {k: tree_stack([t[k] for t in trees]) for k in first}
    if isinstance(first, kan.DeployedKAN):
        return kan.DeployedKAN(tuple(
            tree_stack([t.layers[i] for t in trees])
            for i in range(len(first.layers))), first.spec)
    if first is None:
        return None
    if dataclasses.is_dataclass(first):
        return dataclasses.replace(first, **{
            f: tree_stack([getattr(t, f) for t in trees])
            for f in _fields(first)})
    return torch.stack(list(trees))


def layer_of(tree, r: int):
    """Repeat ``r`` of a stacked stage tree (views, no copies; a view of
    one repeat of a contiguous stack is contiguous, as the kernels want)."""
    return tree_map(lambda a: a[r], tree)


def count_params(params) -> int:
    return sum(int(p.numel()) for p in tree_leaves(params))


# ---------------------------------------------------------------------------
# logical sharding names (``dist.sharding``)
# ---------------------------------------------------------------------------

def _attn_spec(cfg: ModelConfig, cross: bool = False) -> Dict:
    kv_tail = "head_dim" if cfg.kv_shard_mode == "head_dim" else "none"
    s = {"wq": ("embed", "heads", "none"),
         "wk": ("embed", "kv_heads", kv_tail),
         "wv": ("embed", "kv_heads", kv_tail),
         "wo": ("heads", "none", "embed")}
    if cfg.qkv_bias and not cross:
        s["bq"] = ("heads", "none")
        s["bk"] = ("kv_heads", kv_tail)
        s["bv"] = ("kv_heads", kv_tail)
    return s


def _mlp_spec(cfg: ModelConfig) -> Dict:
    s = {"wi": ("embed", "mlp"), "wo": ("mlp", "embed")}
    if cfg.gated_mlp:
        s["wg"] = ("embed", "mlp")
    return s


def _layer_spec_tree(spec: LayerSpec, cfg: ModelConfig) -> Dict:
    s: Dict[str, Any] = {}
    nrm = layers.norm_spec(cfg.norm)
    if spec.mixer in ATTN_MIXERS:
        s["mixer_norm"] = nrm
        s["attn"] = _attn_spec(cfg)
    elif spec.mixer == "rglru":
        s["mixer_norm"] = nrm
        s["rglru"] = rglru_lib.rglru_block_spec(cfg.rglru_cfg)
    elif spec.mixer == "ssd":
        s["mixer_norm"] = nrm
        s["ssd"] = ssd_lib.ssd_block_spec(cfg.ssd_cfg)
    if spec.cross_attn:
        s["cross_norm"] = nrm
        s["cross"] = _attn_spec(cfg, cross=True)
    if spec.ffn == "mlp":
        s["ffn_norm"] = nrm
        s["mlp"] = _mlp_spec(cfg)
    elif spec.ffn == "moe":
        s["ffn_norm"] = nrm
        s["moe"] = moe_lib.moe_spec(cfg.moe_cfg)
    elif spec.ffn == "kan":
        lay = {"coeffs": ("embed", "none", "mlp"), "w_base": ("embed", "mlp")}
        lay2 = {"coeffs": ("mlp", "none", "embed"), "w_base": ("mlp", "embed")}
        s["ffn_norm"] = nrm
        s["kan"] = {"up": lay, "down": lay2}
    return s


def stacked_spec(spec_tree):
    """``spec_tree`` with the stacked layer axis ``"layers"`` prepended to
    every leaf (a repeated stage's leaves carry ``[repeats]`` first)."""
    if isinstance(spec_tree, tuple):
        return ("layers",) + spec_tree
    if isinstance(spec_tree, Mapping):
        return {k: stacked_spec(v) for k, v in spec_tree.items()}
    return [stacked_spec(v) for v in spec_tree]


def _stage_spec(stage: Stage, cfg: ModelConfig) -> Dict:
    blk = {f"l{i}": _layer_spec_tree(sp, cfg)
           for i, sp in enumerate(stage.block)}
    return blk if stage.repeats == 1 else stacked_spec(blk)


def param_spec(cfg: ModelConfig) -> Dict:
    """Logical sharding names of every ``init_model`` leaf (the
    reference's tree, leaf for leaf)."""
    spec: Dict[str, Any] = {
        "embed": ("vocab", "embed"),
        "final_norm": layers.norm_spec(cfg.norm),
    }
    if not cfg.tie_embeddings:
        spec["unembed"] = ("vocab", "embed")
    spec["stages"] = [_stage_spec(st, cfg) for st in stages_for(cfg)]
    if cfg.family == "encdec":
        spec["enc_stages"] = [_stage_spec(st, cfg)
                              for st in stages_for(cfg, encoder=True)]
        spec["enc_final_norm"] = layers.norm_spec(cfg.norm)
        spec["dec_pos"] = ("none", "embed")
    return spec


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _init_attn(gen, cfg: ModelConfig, device, cross: bool = False) -> Dict:
    """Q/K/V/O projections [D, H, hd] / [H, hd, D]; with ``pad_attn_heads``
    the head counts are padded with zero heads (as in the reference; its
    GQA grouping then follows the padded counts). Cross attention has no
    qkv bias."""
    hd = cfg.resolved_head_dim
    hq, hkv = cfg.padded_heads, cfg.padded_kv_heads
    pdt = cfg.param_dtype
    wq = layers.dense_init(gen, cfg.d_model, (cfg.n_heads, hd), dtype=pdt,
                           device=device)
    wk = layers.dense_init(gen, cfg.d_model, (cfg.n_kv_heads, hd),
                           dtype=pdt, device=device)
    wv = layers.dense_init(gen, cfg.d_model, (cfg.n_kv_heads, hd),
                           dtype=pdt, device=device)
    wo = (layers.normal(gen, (cfg.n_heads, hd, cfg.d_model), device)
          * (cfg.n_heads * hd) ** -0.5).to(pdt)
    if hq != cfg.n_heads or hkv != cfg.n_kv_heads:
        pad = torch.nn.functional.pad
        wq = pad(wq, (0, 0, 0, hq - cfg.n_heads))
        wk = pad(wk, (0, 0, 0, hkv - cfg.n_kv_heads))
        wv = pad(wv, (0, 0, 0, hkv - cfg.n_kv_heads))
        wo = pad(wo, (0, 0, 0, 0, 0, hq - cfg.n_heads))
    p = {"wq": wq, "wk": wk, "wv": wv, "wo": wo}
    if cfg.qkv_bias and not cross:
        p["bq"] = torch.zeros((hq, hd), dtype=pdt, device=device)
        p["bk"] = torch.zeros((hkv, hd), dtype=pdt, device=device)
        p["bv"] = torch.zeros((hkv, hd), dtype=pdt, device=device)
    return p


def _init_mlp(gen, cfg: ModelConfig, device) -> Dict:
    pdt = cfg.param_dtype
    p = {"wi": layers.dense_init(gen, cfg.d_model, cfg.d_ff, dtype=pdt,
                                 device=device),
         "wo": layers.dense_init(gen, cfg.d_ff, cfg.d_model, dtype=pdt,
                                 device=device)}
    if cfg.gated_mlp:
        p["wg"] = layers.dense_init(gen, cfg.d_model, cfg.d_ff, dtype=pdt,
                                    device=device)
    return p


def _init_layer(gen, spec: LayerSpec, cfg: ModelConfig, device,
                n_model: int = 1) -> Dict:
    check_ported(spec)
    p: Dict[str, Any] = {}
    norm = layers.NORM_INIT[cfg.norm]
    if spec.mixer in ATTN_MIXERS:
        p["mixer_norm"] = norm(cfg.d_model, device)
        p["attn"] = _init_attn(gen, cfg, device)
    elif spec.mixer == "ssd":
        p["mixer_norm"] = norm(cfg.d_model, device)
        p["ssd"] = ssd_lib.init_ssd_block(gen, cfg.ssd_cfg, device)
    elif spec.mixer == "rglru":
        p["mixer_norm"] = norm(cfg.d_model, device)
        p["rglru"] = rglru_lib.init_rglru_block(gen, cfg.rglru_cfg, device)
    if spec.cross_attn:
        p["cross_norm"] = norm(cfg.d_model, device)
        p["cross"] = _init_attn(gen, cfg, device, cross=True)
    if spec.ffn == "mlp":
        p["ffn_norm"] = norm(cfg.d_model, device)
        p["mlp"] = _init_mlp(gen, cfg, device)
    elif spec.ffn == "moe":
        p["ffn_norm"] = norm(cfg.d_model, device)
        p["moe"] = moe_lib.init_moe(gen, cfg.moe_cfg, device=device,
                                    n_model=n_model)
    elif spec.ffn == "kan":
        p["ffn_norm"] = norm(cfg.d_model, device)
        p["kan"] = kan.init(gen, cfg.kan_spec, device=device)
    return p


def _init_stage(gen, stage: Stage, cfg: ModelConfig, device,
                n_model: int = 1) -> Dict:
    """A stage's params, its repeats stacked. Each repeat is copied into
    the stack as soon as it is drawn, so that making a stage takes its own
    size and one block's, not twice its size."""
    def init_block():
        return {f"l{i}": _init_layer(gen, sp, cfg, device, n_model)
                for i, sp in enumerate(stage.block)}
    block = init_block()
    if stage.repeats == 1:
        return block
    out = tree_map(lambda a: a.new_empty((stage.repeats,) + a.shape), block)
    for r in range(stage.repeats):
        block = block if r == 0 else init_block()
        for dst, src in zip(tree_leaves(out), tree_leaves(block)):
            dst[r].copy_(src)
    return out


def generator(seed: Union[int, torch.Generator], device) -> torch.Generator:
    """``seed`` as a generator that can fill ``device``: a CUDA generator
    on the card, a CPU one elsewhere (the meta device included)."""
    if isinstance(seed, torch.Generator):
        return seed
    gdev = device if device.type == "cuda" else torch.device("cpu")
    return torch.Generator(device=gdev).manual_seed(int(seed))


def init_model(seed: Union[int, torch.Generator], cfg: ModelConfig, *,
               device=None, n_model: int = 1) -> Dict:
    """Random weights in the JAX layout, drawn from ``seed`` (an int or a
    generator on ``device``). ``device=None`` is the card; ``"meta"`` gives
    shapes only (parameter counts at full width without allocating). MoE
    experts are packed device-major for ``n_model`` model shards (the
    mesh's model axis; ``moe.init_moe``)."""
    device = resolve_device(device)
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
    params["stages"] = [_init_stage(gen, st, cfg, device, n_model)
                        for st in stages_for(cfg)]
    if cfg.family == "encdec":
        params["enc_stages"] = [_init_stage(gen, st, cfg, device, n_model)
                                for st in stages_for(cfg, encoder=True)]
        params["enc_final_norm"] = layers.NORM_INIT[cfg.norm](cfg.d_model,
                                                              device)
        params["dec_pos"] = (layers.normal(
            gen, (cfg.max_target_len, cfg.d_model), device) * 0.02
            ).to(cfg.param_dtype)
    return params


# ---------------------------------------------------------------------------
# forward (train / prefill)
# ---------------------------------------------------------------------------

def heads_in(xn: Tensor, w: Tensor, dtype) -> Tensor:
    """``einsum("bsd,dhk->bshk", xn, w.astype(dtype))``."""
    d, h, k = w.shape
    return layers.matmul(xn, w.to(dtype).reshape(d, h * k)).reshape(
        xn.shape[:-1] + (h, k))


def heads_out(o: Tensor, wo: Tensor, dtype) -> Tensor:
    """``einsum("bshk,hkd->bsd", o, wo.astype(dtype))``."""
    h, k, d = wo.shape
    return layers.matmul(o.reshape(o.shape[:-2] + (h * k,)),
                         wo.to(dtype).reshape(h * k, d))


def qkv(p, xn: Tensor, cfg: ModelConfig, which: str = "attn"
        ) -> Tuple[Tensor, Tensor, Tensor]:
    """Q, K and V [B, S, H, hd] in the compute dtype, with their biases
    (``which="cross"``: the cross-attention projections of ``xn``)."""
    a = p[which]
    q, k, v = (heads_in(xn, a[w], cfg.dtype) for w in ("wq", "wk", "wv"))
    if "bq" in a:
        q = q + a["bq"].to(cfg.dtype)
        k = k + a["bk"].to(cfg.dtype)
        v = v + a["bv"].to(cfg.dtype)
    kv_tail = "head_dim" if cfg.kv_shard_mode == "head_dim" else None
    return (shard(q, "batch", "seq", "heads", None),
            shard(k, "batch", "seq", "kv_heads", kv_tail),
            shard(v, "batch", "seq", "kv_heads", kv_tail))


def _attn_mixer(p, x: Tensor, cfg: ModelConfig, spec: LayerSpec,
                positions: Tensor) -> Tensor:
    xn = layers.NORM_APPLY[cfg.norm](p["mixer_norm"], x)
    q, k, v = qkv(p, xn, cfg)
    if spec.mixer != "bidir" and cfg.rope_theta:
        q = layers.apply_rope(q, positions, cfg.rope_theta)
        k = layers.apply_rope(k, positions, cfg.rope_theta)
    if spec.mixer == "swa" and cfg.window:
        o = attn_lib.windowed_attention(q, k, v, window=cfg.window)
    elif spec.mixer == "local" and cfg.local_window:
        o = attn_lib.windowed_attention(q, k, v, window=cfg.local_window)
    else:
        o = attn_lib.chunked_attention(q, k, v,
                                       causal=(spec.mixer != "bidir"),
                                       kv_chunk=cfg.attn_kv_chunk)
    o = shard(o, "batch", "seq", "heads", None)
    return heads_out(o, p["attn"]["wo"], cfg.dtype)


def cross_q(p, x: Tensor, cfg: ModelConfig) -> Tensor:
    """The cross-attention queries of the normed stream."""
    xn = layers.NORM_APPLY[cfg.norm](p["cross_norm"], x)
    return heads_in(xn, p["cross"]["wq"], cfg.dtype)


def cross_mixer(p, x: Tensor, cfg: ModelConfig, enc_out: Tensor
                ) -> Tuple[Tensor, Tensor, Tensor]:
    """Bidirectional attention of the decoder stream over the encoder's
    output (``_cross_mixer``): (the residual update, and the cross K and V
    that prefill caches, computed once per request)."""
    ck = heads_in(enc_out, p["cross"]["wk"], cfg.dtype)
    cv = heads_in(enc_out, p["cross"]["wv"], cfg.dtype)
    o = attn_lib.chunked_attention(cross_q(p, x, cfg), ck, cv, causal=False,
                                   kv_chunk=cfg.attn_kv_chunk)
    return heads_out(o, p["cross"]["wo"], cfg.dtype), ck, cv


def mlp_ffn(p, x: Tensor, cfg: ModelConfig) -> Tensor:
    xn = layers.NORM_APPLY[cfg.norm](p["ffn_norm"], x)
    act = layers.ACTIVATIONS[cfg.activation]
    h = layers.matmul(xn, p["mlp"]["wi"].to(cfg.dtype))
    if cfg.gated_mlp:
        h = act(layers.matmul(xn, p["mlp"]["wg"].to(cfg.dtype))) * h
    else:
        h = act(h)
    h = shard(h, "batch", "seq", "mlp")
    return layers.matmul(h, p["mlp"]["wo"].to(cfg.dtype))


def kan_ffn(p, x: Tensor, cfg: ModelConfig) -> Tensor:
    """The KAN-FFN: a ``kan.DeployedKAN`` runs the frozen integer artifact,
    a raw param tree the training-path forward (``kan.apply_any``)."""
    xn = layers.NORM_APPLY[cfg.norm](p["ffn_norm"], x)
    return kan.apply_any(p["kan"], xn, cfg.kan_spec).to(x.dtype)


def moe_ffn(p, x: Tensor, cfg: ModelConfig
            ) -> Tuple[Tensor, Dict[str, Tensor]]:
    """The MoE FFN on the normed stream: (y in x's dtype, aux losses)."""
    xn = layers.NORM_APPLY[cfg.norm](p["ffn_norm"], x)
    return moe_lib.apply_moe(p["moe"], xn, cfg.moe_cfg)


def apply_ffn_aux(p, x: Tensor, spec: LayerSpec, cfg: ModelConfig
                  ) -> Tuple[Tensor, Dict[str, Tensor]]:
    """The residual stream after the layer's FFN (if it has one), and the
    FFN's aux losses (MoE's; empty otherwise)."""
    aux: Dict[str, Tensor] = {}
    if spec.ffn == "mlp":
        x = x + mlp_ffn(p, x, cfg)
    elif spec.ffn == "moe":
        y, aux = moe_ffn(p, x, cfg)
        x = x + y
    elif spec.ffn == "kan":
        x = x + kan_ffn(p, x, cfg)
    return x, aux


def apply_ffn(p, x: Tensor, spec: LayerSpec, cfg: ModelConfig) -> Tensor:
    """The residual stream after the layer's FFN (serving drops MoE's aux
    losses, as the reference's decode does)."""
    return apply_ffn_aux(p, x, spec, cfg)[0]


def _apply_layer(p, x: Tensor, spec: LayerSpec, cfg: ModelConfig,
                 positions: Tensor, enc_out: Optional[Tensor] = None
                 ) -> Tuple[Tensor, Dict[str, Tensor]]:
    check_ported(spec)
    if spec.mixer in ATTN_MIXERS:
        x = x + _attn_mixer(p, x, cfg, spec, positions)
    elif spec.mixer == "ssd":
        xn = layers.NORM_APPLY[cfg.norm](p["mixer_norm"], x)
        # the block returns f32; the residual add is in the compute dtype
        x = x + ssd_lib.apply_ssd_block(p["ssd"], xn, cfg.ssd_cfg
                                        ).to(x.dtype)
    elif spec.mixer == "rglru":
        xn = layers.NORM_APPLY[cfg.norm](p["mixer_norm"], x)
        x = x + rglru_lib.apply_rglru_block(p["rglru"], xn, cfg.rglru_cfg
                                            ).to(x.dtype)
    if spec.cross_attn and enc_out is not None:
        x = x + cross_mixer(p, x, cfg, enc_out)[0]
    x, aux = apply_ffn_aux(p, x, spec, cfg)
    x = shard(x, "batch", "seq_sp" if cfg.seq_shard_activations else "seq",
              None)
    return x, aux


def prescan_cast(stage_params, cfg: ModelConfig):
    """Every f32 or bf16 leaf of the stages (norm scales included) in the
    compute dtype, before the layer loop, as the reference's
    ``prescan_cast`` (there so that FSDP gathers move bf16). A leaf already
    in the compute dtype is the same tensor, not a copy."""
    def cast(t):
        return (t.to(cfg.dtype) if t.dtype in (torch.float32, torch.bfloat16)
                else t)
    return tree_map(cast, stage_params)


def _run_stages(stage_params, stages: Sequence[Stage], x: Tensor,
                cfg: ModelConfig, enc_out: Optional[Tensor] = None
                ) -> Tuple[Tensor, Tensor]:
    """Every layer in order, a stage's repeats in a Python loop (decoder
    layers with cross attention read ``enc_out``). Returns the stream and
    the aux loss: each block's MoE load-balance and z losses summed from
    zero, layer by layer, then the blocks' sums added in order (the
    reference's order)."""
    if cfg.prescan_cast:
        stage_params = prescan_cast(stage_params, cfg)
    positions = torch.arange(x.shape[1], device=x.device)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    grad = torch.is_grad_enabled()
    for st_params, stage in zip(stage_params, stages):
        remat = cfg.remat and grad and (x.requires_grad or any(
            t.requires_grad for t in tree_leaves(st_params)))
        for r in range(stage.repeats):
            lp = st_params if stage.repeats == 1 else layer_of(st_params, r)
            if remat:
                x, block_aux = torch.utils.checkpoint.checkpoint(
                    _apply_block, lp, x, stage, cfg, positions, enc_out,
                    use_reentrant=False)
            else:
                x, block_aux = _apply_block(lp, x, stage, cfg, positions,
                                            enc_out)
            aux_total = aux_total + block_aux
    return x, aux_total


def _apply_block(lp, x: Tensor, stage: Stage, cfg: ModelConfig,
                 positions: Tensor, enc_out: Optional[Tensor]
                 ) -> Tuple[Tensor, Tensor]:
    """One repeat of a stage's block -> (x, the block's aux loss). Under
    autograd with ``cfg.remat`` it runs inside ``torch.utils.checkpoint``,
    the reference's ``jax.checkpoint`` per block: only the block's input is
    kept, and the backward recomputes its forward."""
    block_aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, spec in enumerate(stage.block):
        x, aux = _apply_layer(lp[f"l{i}"], x, spec, cfg, positions, enc_out)
        for k in ("moe_load_balance", "moe_z"):
            if k in aux:
                block_aux = block_aux + aux[k]
    return x, block_aux


def embed_inputs(params, cfg: ModelConfig, batch: Mapping) -> Tensor:
    """Token embedding and the modality stubs, in the compute dtype: with
    ``audio_stub`` the encoder's input is ``batch["frames"]`` [B, T, D]
    plus sinusoidal positions; with ``vision_stub`` a batch's
    ``vision_embeds`` [B, P, D] replace the first P positions."""
    table = params["embed"]
    if cfg.frontend == "audio_stub":
        frames = torch.as_tensor(batch["frames"], device=table.device
                                 ).to(cfg.dtype)
        pos = layers.sinusoidal_positions(frames.shape[1], cfg.d_model,
                                          device=frames.device)
        return frames + pos.to(cfg.dtype)[None]
    tokens = torch.as_tensor(batch["tokens"], device=table.device)
    x = layers.embed_lookup(table, tokens).to(cfg.dtype)
    if cfg.frontend == "vision_stub" and "vision_embeds" in batch:
        ve = torch.as_tensor(batch["vision_embeds"], device=table.device
                             ).to(cfg.dtype)
        x = torch.cat([ve, x[:, ve.shape[1]:]], dim=1)
    return x


def embed_decoder(params, cfg: ModelConfig, tokens, positions) -> Tensor:
    """An encoder-decoder's decoder input: token embedding plus the learned
    ``dec_pos`` rows at ``positions`` ([S] for every row, or [B, 1] per
    row), in the compute dtype."""
    table = params["embed"]
    tokens = torch.as_tensor(tokens, device=table.device)
    x = layers.embed_lookup(table, tokens).to(cfg.dtype)
    pe = params["dec_pos"][positions].to(cfg.dtype)
    return x + (pe[None] if pe.ndim == 2 else pe)


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
    """Full forward -> (logits [B,S,V], aux loss scalar): the MoE layers'
    load-balance and router-z losses, 0 without MoE layers."""
    if cfg.family == "encdec":
        return _forward_encdec(params, cfg, batch)
    x = embed_inputs(params, cfg, batch)
    x, aux = _run_stages(params["stages"], stages_for(cfg), x, cfg)
    return logits_from(params, cfg, x), aux


def encode(params, cfg: ModelConfig, batch: Mapping) -> Tensor:
    """The encoder's output [B, T, D]: the frontend's input through the
    bidirectional encoder stages and ``enc_final_norm``."""
    x = embed_inputs(params, cfg, batch)
    x, _ = _run_stages(params["enc_stages"], stages_for(cfg, encoder=True),
                       x, cfg)
    return layers.NORM_APPLY[cfg.norm](params["enc_final_norm"], x)


def _forward_encdec(params, cfg: ModelConfig, batch: Mapping
                    ) -> Tuple[Tensor, Tensor]:
    """Encode, then the decoder over tokens plus ``dec_pos`` with cross
    attention; the tied embedding unembeds (the reference's: no softcap,
    no separate table)."""
    enc_out = encode(params, cfg, batch)
    tokens = torch.as_tensor(batch["tokens"], device=enc_out.device)
    x = embed_decoder(params, cfg, tokens,
                      torch.arange(tokens.shape[1], device=enc_out.device))
    x, aux = _run_stages(params["stages"], stages_for(cfg), x, cfg,
                         enc_out=enc_out)
    x = layers.NORM_APPLY[cfg.norm](params["final_norm"], x)
    return layers.unembed(x, params["embed"].to(cfg.dtype)), aux


def loss_fn(params, cfg: ModelConfig, batch: Mapping
            ) -> Tuple[Tensor, Dict[str, Tensor]]:
    """Next-token cross entropy over ``batch["labels"]`` (masked by an
    optional ``loss_mask``) plus the aux loss -> (total, {"ce", "aux"}).

    ``ce_impl="gather"``: log_softmax and the label's entry. ``"onehot"``:
    the reference's sharded-safe form, the logits less their (detached)
    max, logsumexp, and the label logit picked by a one-hot mask."""
    logits, aux = forward(params, cfg, batch)
    lf = logits.to(torch.float32)
    labels = torch.as_tensor(batch["labels"], device=lf.device).long()
    if cfg.ce_impl == "onehot":
        shifted = lf - lf.amax(dim=-1, keepdim=True).detach()
        lse = torch.log(torch.sum(torch.exp(shifted), dim=-1))
        onehot = (torch.arange(lf.shape[-1], device=lf.device)
                  == labels[..., None])
        label_logit = torch.sum(torch.where(onehot, shifted, 0.0), dim=-1)
        ll = label_logit - lse
    else:
        logp = torch.log_softmax(lf, dim=-1)
        ll = torch.gather(logp, -1, labels[..., None])[..., 0]
    mask = batch.get("loss_mask")
    mask = (torch.ones_like(ll) if mask is None else
            torch.as_tensor(mask, device=ll.device).to(ll.dtype))
    ce = -(ll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return ce + aux, {"ce": ce, "aux": aux}


# ---------------------------------------------------------------------------
# serving deployment: freeze KAN-FFN subtrees into integer artifacts
# ---------------------------------------------------------------------------

def deploy_kan(params, cfg: ModelConfig):
    """Replace every ``p["kan"]`` subtree with a frozen ``kan.DeployedKAN``
    (int8 codes + scales + SH-LUT, and the backend's extras), built exactly
    once: serving then runs no coefficient quantisation. A stacked stage is
    deployed one repeat at a time, repeat ``r`` with chip uid ``n_blocks +
    r`` (the reference's vmap over an iota), and the artifacts stacked on
    the layer axis. Idempotent: returns ``params`` itself when the model has
    no KAN layers or is deployed already."""
    if not any(sp.ffn == "kan" for sp in cfg.layer_specs()):
        return params
    spec = cfg.kan_spec
    changed = False
    new_stages = []
    n_blocks = 0   # a chip-unique uid per KAN block (cim_tiled's draws)
    for st_params, stage in zip(params["stages"], stages_for(cfg)):
        blk = dict(st_params)
        for i, sp in enumerate(stage.block):
            if sp.ffn != "kan":
                continue
            lp = dict(blk[f"l{i}"])
            if not isinstance(lp["kan"], kan.DeployedKAN):
                if stage.repeats == 1:
                    lp["kan"] = kan.deploy(lp["kan"], spec, chip_uid=n_blocks)
                else:
                    lp["kan"] = tree_stack([
                        kan.deploy(layer_of(lp["kan"], r), spec,
                                   chip_uid=n_blocks + r)
                        for r in range(stage.repeats)])
                blk[f"l{i}"] = lp
                changed = True
            n_blocks += stage.repeats
        new_stages.append(blk)
    if not changed:
        return params
    return {**params, "stages": new_stages}
