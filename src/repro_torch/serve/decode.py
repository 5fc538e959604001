"""Serving: prefill (build caches), single-token decode steps and the paged
engine's chunked prefill (port of ``repro.serve.decode``), and the
caches' logical sharding names (``cache_spec``, ``paged_cache_spec``).

Cache layouts per layer (stacked [repeats, ...] inside a repeated stage):
  attn        — K/V caches [B, T, Kv, hd] in the compute dtype, T =
                ``max_len``;
  swa, local  — K/V ring buffers of T = min(window, max_len) slots: token
                at position i lives in slot i mod T (softmax does not depend
                on the slots' order);
  ssd         — the recurrent state [B, H, P, N] f32 and the depthwise
                conv's ring buffer [B, K-1, di+2N] in the compute dtype. The
                prefill's scan runs the ``ssd_scan`` kernel on the card
                (``models.ssd.ssd_chunked``), which also gives the final
                state the cache keeps;
  rglru       — the hidden state [B, dr] f32 and the conv buffer [B, K-1,
                dr] of pre-conv inputs in the compute dtype;
  cross       — an encoder-decoder's cross-attention K/V ``ck``/``cv``
                [B, T_enc, Kv, hd], computed once at prefill from the
                encoder's output and read-only at decode.
A ``bidir`` mixer has no cache and, as in the reference, prefill and decode
skip it (it is the encoder's, which prefill runs once through
``transformer.encode``).

Paged serving (the continuous-batching engine's layout, ``serve.engine``):
full-attention K/V lives in a shared page pool instead of per-slot rows.
``init_paged_cache`` builds [n_pages, page_size, Kv, hd] pools for every
``attn`` layer (one page-id space indexes all of them); SWA/local rings,
SSD/RG-LRU state, conv buffers and cross-attention K/V stay per slot.
``decode_step(..., pages=[B, P])`` routes reads and writes through the
page tables, and ``prefill_chunk`` consumes a prompt one page-aligned
chunk at a time.
``chunk_tokens_for`` gives the largest chunk that keeps the math identical
to a solo run, or None for families that prefill in one piece. Unlike the
reference, which returns new caches (donated, so XLA writes them in
place), the paged functions write the engine's cache in place and return
it: the pools are the whole KV memory, and a copy per tick would move all
of it. The static-batch functions still return new caches. Under a mesh
the engine's cache is DTensors placed by ``paged_cache_spec``, and every
in-place write goes through ``sharding.setitem_``: each rank writes its own
shard.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Mapping, Optional, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.dist import sharding as shlib
from repro_torch.dist.sharding import setitem_
from repro_torch.models import attention as attn_lib
from repro_torch.models import rglru as rglru_lib
from repro_torch.models import ssd as ssd_lib
from repro_torch.models import transformer as tfm
from repro_torch.models import layers
from repro_torch.models.transformer import LayerSpec, ModelConfig

Tensor = torch.Tensor


def _kv_len(spec: LayerSpec, cfg: ModelConfig, max_len: int
            ) -> Tuple[int, bool]:
    """(cache slots, rolling) of an attention layer."""
    if spec.mixer == "swa" and cfg.window:
        return min(cfg.window, max_len), True
    if spec.mixer == "local" and cfg.local_window:
        return min(cfg.local_window, max_len), True
    return max_len, False


def _init_layer_cache(spec: LayerSpec, cfg: ModelConfig, batch: int,
                      max_len: int, device, enc_len: int = 0
                      ) -> Dict[str, Tensor]:
    tfm.check_ported(spec)
    c: Dict[str, Tensor] = {}
    kv_shape = (cfg.padded_kv_heads, cfg.resolved_head_dim)
    if spec.mixer in ("attn", "swa", "local"):
        t, _ = _kv_len(spec, cfg, max_len)
        for k in ("k", "v"):
            c[k] = torch.zeros((batch, t) + kv_shape, dtype=cfg.dtype,
                               device=device)
    elif spec.mixer == "ssd":
        c.update(ssd_lib.init_ssd_cache(batch, cfg.ssd_cfg, cfg.dtype,
                                        device))
    elif spec.mixer == "rglru":
        c.update(rglru_lib.init_rglru_cache(batch, cfg.rglru_cfg, cfg.dtype,
                                            device))
    if spec.cross_attn:
        for k in ("ck", "cv"):
            c[k] = torch.zeros((batch, enc_len) + kv_shape, dtype=cfg.dtype,
                               device=device)
    return c


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device=None, enc_len: int = 0) -> list:
    """Cache tree parallel to params["stages"] (``device=None``: the
    card). ``max_len`` sizes the attention caches; SSD layers keep O(1)
    state; ``enc_len`` sizes the cross-attention K/V."""
    device = resolve_device(device)
    out = []
    for stage in tfm.stages_for(cfg):
        blk = {f"l{i}": _init_layer_cache(sp, cfg, batch, max_len, device,
                                          enc_len)
               for i, sp in enumerate(stage.block)}
        if stage.repeats > 1:
            blk = tfm.tree_map(lambda x, r=stage.repeats: x[None].repeat(
                (r,) + (1,) * x.ndim), blk)
        out.append(blk)
    return out


def init_paged_cache(cfg: ModelConfig, n_slots: int, max_len: int, *,
                     page_size: int, n_pages: int, device=None,
                     enc_len: int = 0) -> list:
    """Cache tree of the paged serving engine (``device=None``: the card).
    As ``init_cache``, except that every full-attention layer's K/V is a
    shared page pool [n_pages, page_size, Kv, hd]: slots address it through
    page tables (``pages`` in ``decode_step``), so memory scales with live
    tokens, not ``n_slots * max_len``. Every other leaf keeps its per-slot
    [n_slots, ...] rows (cross-attention K/V of ``enc_len`` rows
    included)."""
    device = resolve_device(device)
    pool_shape = (n_pages, page_size, cfg.padded_kv_heads,
                  cfg.resolved_head_dim)
    out = []
    for stage in tfm.stages_for(cfg):
        blk = {}
        for i, sp in enumerate(stage.block):
            # an attn layer's K/V are the pools, not per-slot rows
            c = _init_layer_cache(
                dataclasses.replace(sp, mixer="none") if sp.mixer == "attn"
                else sp, cfg, n_slots, max_len, device, enc_len)
            if sp.mixer == "attn":
                c.update({k: torch.zeros(pool_shape, dtype=cfg.dtype,
                                         device=device) for k in ("k", "v")})
            blk[f"l{i}"] = c
        if stage.repeats > 1:
            blk = tfm.tree_map(lambda x, r=stage.repeats: x[None].repeat(
                (r,) + (1,) * x.ndim), blk)
        out.append(blk)
    return out


def _cache_spec(cfg: ModelConfig, paged: bool) -> list:
    kv_tail = "head_dim" if cfg.kv_shard_mode == "head_dim" else "none"

    def layer_spec(spec: LayerSpec):
        s = {}
        if spec.mixer == "attn" and paged:
            # page pool: page axis replicated, heads sharded as usual
            s["k"] = ("none", "none", "kv_heads", kv_tail)
            s["v"] = ("none", "none", "kv_heads", kv_tail)
        elif spec.mixer in ("attn", "swa", "local"):
            s["k"] = ("batch", "seq", "kv_heads", kv_tail)
            s["v"] = ("batch", "seq", "kv_heads", kv_tail)
        elif spec.mixer == "ssd":
            s["state"] = ("batch", "heads", "none", "none")
            s["conv_buf"] = ("batch", "none", "state")
        elif spec.mixer == "rglru":
            s["h"] = ("batch", "state")
            s["conv_buf"] = ("batch", "none", "state")
        if spec.cross_attn:
            s["ck"] = ("batch", "seq", "kv_heads", kv_tail)
            s["cv"] = ("batch", "seq", "kv_heads", kv_tail)
        return s
    out = []
    for stage in tfm.stages_for(cfg):
        blk = {f"l{i}": layer_spec(sp) for i, sp in enumerate(stage.block)}
        out.append(tfm.stacked_spec(blk) if stage.repeats > 1 else blk)
    return out


def cache_spec(cfg: ModelConfig) -> list:
    """Logical sharding names for the ``init_cache`` tree (kv_heads falls
    back to head_dim sharding when the head count does not divide the model
    axis)."""
    return _cache_spec(cfg, paged=False)


def paged_cache_spec(cfg: ModelConfig) -> list:
    """Logical sharding names for the ``init_paged_cache`` tree: page
    pools replicate their page axis and shard kv_heads/head_dim exactly
    like monolithic rows; per-slot leaves keep the ``cache_spec`` names."""
    return _cache_spec(cfg, paged=True)


def chunk_tokens_for(cfg: ModelConfig, page_size: int) -> Optional[int]:
    """Chunked-prefill unit (tokens per engine tick), or None when the arch
    must prefill each prompt in one piece.

    Only where chunking is exact against a solo whole-prompt run:
    pure-attention stacks (masked page slots add exact zeros to the online
    softmax) and attention+SSD stacks (``ssd_chunked`` carries
    ``init_state`` across chunks whose boundaries are multiples of the SSD
    scan chunk, hence the lcm). RG-LRU, SWA/local windows, MoE, enc-dec and
    frontends prefill whole, still into the paged pool."""
    if cfg.family == "encdec" or cfg.frontend != "none":
        return None
    specs = [sp for st in tfm.stages_for(cfg) for sp in st.block]
    mixers = {sp.mixer for sp in specs}
    if any(sp.ffn == "moe" for sp in specs) or not mixers <= {"attn", "ssd"}:
        return None
    step = page_size
    if "ssd" in mixers:
        c = cfg.ssd_cfg.chunk
        step = step * c // math.gcd(step, c)
    return step


def prefix_sharing_ok(cfg: ModelConfig) -> bool:
    """Whether hash-matched prompt prefixes may share physical pages: only
    pure-attention decoder stacks, whose whole sequence state lies in the
    pages. A recurrent mixer carries per-slot state the pool does not
    hold."""
    if chunk_tokens_for(cfg, 1) is None:
        return False
    return {sp.mixer for st in tfm.stages_for(cfg)
            for sp in st.block} == {"attn"}


def _decode_positions(index, device):
    """RoPE positions of the decoded token: [1] for an int or a scalar
    tensor index, [B, 1] for a [B] tensor."""
    if isinstance(index, int):
        return torch.full((1,), index, device=device)
    return index[:, None] if index.ndim else index.reshape(1)


def _decode_layer(p, cache, x: Tensor, spec: LayerSpec, cfg: ModelConfig,
                  index) -> Tuple[Tensor, Dict[str, Tensor]]:
    """x: [B, 1, D]; index: the 0-based position of the decoded token, a
    scalar or a [B] vector. SSD and RG-LRU layers do not read it: their
    state carries the position."""
    tfm.check_ported(spec)
    new_cache = dict(cache)
    if spec.mixer in ("attn", "swa", "local"):
        xn = layers.NORM_APPLY[cfg.norm](p["mixer_norm"], x)
        q, k, v = tfm.qkv(p, xn, cfg)
        if cfg.rope_theta:
            pos = _decode_positions(index, x.device)
            q = layers.apply_rope(q, pos, cfg.rope_theta)
            k = layers.apply_rope(k, pos, cfg.rope_theta)
        rolling = spec.mixer in ("swa", "local")
        ck, cv = attn_lib.cache_update(cache["k"], cache["v"], k, v, index,
                                       rolling=rolling)
        new_cache["k"], new_cache["v"] = ck, cv
        o = attn_lib.decode_attention(q, ck, cv, index + 1, rolling=rolling)
        x = x + tfm.heads_out(o, p["attn"]["wo"], cfg.dtype)
    elif spec.mixer == "ssd":
        xn = layers.NORM_APPLY[cfg.norm](p["mixer_norm"], x)
        y, sc = ssd_lib.apply_ssd_block_decode(
            p["ssd"], xn, {"state": cache["state"],
                           "conv_buf": cache["conv_buf"]}, cfg.ssd_cfg)
        new_cache.update(sc)
        x = x + y.to(x.dtype)
    elif spec.mixer == "rglru":
        xn = layers.NORM_APPLY[cfg.norm](p["mixer_norm"], x)
        y, rc = rglru_lib.apply_rglru_block_decode(
            p["rglru"], xn, {"h": cache["h"],
                             "conv_buf": cache["conv_buf"]}, cfg.rglru_cfg)
        new_cache.update(rc)
        x = x + y.to(x.dtype)
    if spec.cross_attn:
        x = x + _cross_decode(p, cache, x, cfg)
    return tfm.apply_ffn(p, x, spec, cfg), new_cache


def _cross_decode(p, cache, x: Tensor, cfg: ModelConfig) -> Tensor:
    """Cross attention of the decoded token over the cached encoder K/V
    (every encoder row valid)."""
    o = attn_lib.decode_attention(tfm.cross_q(p, x, cfg), cache["ck"],
                                  cache["cv"], cache["ck"].shape[1])
    return tfm.heads_out(o, p["cross"]["wo"], cfg.dtype)


def _run_layers(params, cache, x: Tensor, cfg: ModelConfig, layer_fn
                ) -> Tuple[Tensor, list]:
    """``layer_fn(p, c, x, spec) -> (x, c)`` over every layer in order, the
    repeats of a stage in a loop; the new caches are stacked as the old."""
    new_caches = []
    for st_params, st_cache, stage in zip(params["stages"], cache,
                                          tfm.stages_for(cfg)):
        reps = []
        for r in range(stage.repeats):
            lp, lc = ((st_params, st_cache) if stage.repeats == 1 else
                      (tfm.layer_of(st_params, r), tfm.layer_of(st_cache, r)))
            nc = {}
            for i, sp in enumerate(stage.block):
                x, nc[f"l{i}"] = layer_fn(lp[f"l{i}"], lc[f"l{i}"], x, sp)
            reps.append(nc)
        new_caches.append(reps[0] if stage.repeats == 1
                          else tfm.tree_stack(reps))
    return x, new_caches


def _run_layers_(params, cache, x: Tensor, cfg: ModelConfig, layer_fn
                 ) -> Tensor:
    """``layer_fn(p, c, x, spec) -> x``, which writes the layer's cache
    ``c`` in place, over every layer in order; a stacked stage's repeats
    get views of its stacks, so their writes land in the engine's
    tensors."""
    for st_params, st_cache, stage in zip(params["stages"], cache,
                                          tfm.stages_for(cfg)):
        for r in range(stage.repeats):
            lp, lc = ((st_params, st_cache) if stage.repeats == 1 else
                      (tfm.layer_of(st_params, r), tfm.layer_of(st_cache, r)))
            for i, sp in enumerate(stage.block):
                x = layer_fn(lp[f"l{i}"], lc[f"l{i}"], x, sp)
    return x


def _mask_state_writes_(new, cache, pages: Tensor) -> None:
    """Write recurrent per-slot state (ssd/rglru rows) in place, but only
    for slots that are decoding: a slot mid chunked-prefill holds real
    carried state that a tick between its chunks must not overwrite. The
    page table doubles as the activity mask: the engine points an inactive
    slot's whole row at the garbage page, so entry 0 is a real page iff the
    slot decodes."""
    act = pages[:, 0] != 0                   # paging.GARBAGE_PAGE
    for k, v in new.items():
        c = cache[k]
        mask = act.reshape((-1,) + (1,) * (v.ndim - 1))
        setitem_(c, (), torch.where(mask, v.to(c.dtype), c))


def _decode_layer_paged(p, cache, x: Tensor, spec: LayerSpec,
                        cfg: ModelConfig, index: Tensor, pages: Tensor
                        ) -> Tensor:
    """One layer of the engine's fused tick, writing ``cache`` in place.
    x: [B, 1, D]; index, pages: [B], [B, P]. Full attention reads and
    writes the page pool; the other mixers run the static step on their
    per-slot rows, the recurrent ones masked to the decoding slots (as the
    reference; a SWA/local ring of a slot that is not decoding takes a
    garbage write at slot 0, which the next whole prefill overwrites)."""
    if spec.mixer != "attn":
        x, new = _decode_layer(p, cache, x, spec, cfg, index)
        new = {k: v for k, v in new.items() if v is not cache[k]}
        if spec.mixer in ("ssd", "rglru"):
            _mask_state_writes_(new, cache, pages)
        else:
            for k, v in new.items():
                setitem_(cache[k], (), v)
        return x
    xn = layers.NORM_APPLY[cfg.norm](p["mixer_norm"], x)
    q, k, v = tfm.qkv(p, xn, cfg)
    if cfg.rope_theta:
        q = layers.apply_rope(q, index[:, None], cfg.rope_theta)
        k = layers.apply_rope(k, index[:, None], cfg.rope_theta)
    attn_lib.paged_cache_update(cache["k"], cache["v"], k, v, pages, index)
    o = attn_lib.decode_attention(q, attn_lib.paged_gather(cache["k"], pages),
                                  attn_lib.paged_gather(cache["v"], pages),
                                  index + 1)
    x = x + tfm.heads_out(o, p["attn"]["wo"], cfg.dtype)
    if spec.cross_attn:
        x = x + _cross_decode(p, cache, x, cfg)
    return tfm.apply_ffn(p, x, spec, cfg)


def decode_step(params, cache, tokens: Tensor, index, cfg: ModelConfig, *,
                pages: Optional[Tensor] = None) -> Tuple[Tensor, list]:
    """One decode step. tokens: [B, 1] -> (logits [B, 1, V], new cache).

    ``index`` is the 0-based position of the incoming token: a scalar when
    the whole batch decodes in lockstep, or a [B] vector (each row at its
    own position).

    ``pages`` ([B, P] long page tables, the paged engine's) makes every
    full-attention layer read and write the shared page pool; the cache
    must come from ``init_paged_cache``, and is written in place and
    returned. Inactive slots point every entry at the garbage page, so
    their writes touch no live page. An encoder-decoder adds the decoder's
    learned position ``dec_pos[index]`` to the token embedding and reads
    the cached cross K/V."""
    table = params["embed"]
    tokens = torch.as_tensor(tokens, device=table.device)
    if cfg.family == "encdec":
        pos = _decode_positions(index if isinstance(index, int) else
                                torch.as_tensor(index, device=table.device),
                                table.device)
        x = tfm.embed_decoder(params, cfg, tokens, pos)
    else:
        x = layers.embed_lookup(table, tokens).to(cfg.dtype)
    if pages is not None:
        pages = torch.as_tensor(pages, device=x.device)
        index = torch.as_tensor(index, device=x.device).expand(x.shape[0])
        x = _run_layers_(params, cache, x, cfg, lambda p, c, xx, sp:
                         _decode_layer_paged(p, c, xx, sp, cfg, index, pages))
        return tfm.logits_from(params, cfg, x), cache
    if not isinstance(index, int):
        index = torch.as_tensor(index, device=x.device)
    x, new_caches = _run_layers(
        params, cache, x, cfg,
        lambda p, c, xx, sp: _decode_layer(p, c, xx, sp, cfg, index))
    return tfm.logits_from(params, cfg, x), new_caches


# ---------------------------------------------------------------------------
# prefill
# ---------------------------------------------------------------------------

def _ssd_prefill(p, x: Tensor, cfg: ModelConfig
                 ) -> Tuple[Tensor, Dict[str, Tensor]]:
    """Like ``apply_ssd_block`` but also returns the final recurrent state
    and the conv buffer (the last K-1 conv inputs, rounded to the compute
    dtype as JAX stores them)."""
    scfg = cfg.ssd_cfg
    b, t, _ = x.shape
    s = ssd_lib.ssd_inputs(p, x, scfg)
    conv_buf = s["conv_in"][:, -(scfg.conv_width - 1):].to(cfg.dtype)
    y, state = ssd_lib.ssd_chunked(s["x"], s["dt"], s["a"], s["B"], s["C"],
                                   s["d_skip"], chunk=scfg.chunk)
    y = ssd_lib.ssd_output(p, y.reshape(b, t, scfg.d_inner), s["z"], x.dtype)
    return y, {"state": state, "conv_buf": conv_buf}


def _rglru_prefill(p, x: Tensor, cfg: ModelConfig
                   ) -> Tuple[Tensor, Dict[str, Tensor]]:
    """Like ``apply_rglru_block`` but also returns the cache: the last
    hidden state (f32) and the last K-1 conv inputs (before the conv,
    rounded to the compute dtype)."""
    rcfg = cfg.rglru_cfg
    gate = layers.gelu(layers.matmul(x, p["w_gate"]))
    main = layers.matmul(x, p["w_main"])
    conv_buf = main[:, -(rcfg.conv_width - 1):].to(cfg.dtype)
    main = ssd_lib._causal_conv(main, p["conv"])
    h = rglru_lib.rglru_scan(p, main)
    y = layers.matmul(h.to(x.dtype) * gate, p["w_out"])
    return y, {"h": h[:, -1], "conv_buf": conv_buf}


def _fill_cache(k: Tensor, t_cache: int, dtype) -> Tensor:
    """The prompt's K or V [B, S, Kv, hd] as a cache of ``t_cache`` slots:
    slot i holds position i, the rest zeros."""
    return torch.nn.functional.pad(
        k, (0, 0, 0, 0, 0, t_cache - k.shape[1])).to(dtype)


def _ring_cache(k: Tensor, t_cache: int, dtype) -> Tensor:
    """The last ``t_cache`` positions of a prompt longer than the ring, in
    ring order: position i in slot i mod t_cache."""
    s = k.shape[1]
    order = torch.argsort(torch.arange(s - t_cache, s, device=k.device)
                          % t_cache)
    return k[:, -t_cache:][:, order].to(dtype)


def _prefill_layer(p, cache, x: Tensor, spec: LayerSpec, cfg: ModelConfig,
                   positions: Tensor, enc_out: Optional[Tensor] = None
                   ) -> Tuple[Tensor, Dict[str, Tensor]]:
    tfm.check_ported(spec)
    new_cache = dict(cache)
    if spec.mixer in ("attn", "swa", "local"):
        xn = layers.NORM_APPLY[cfg.norm](p["mixer_norm"], x)
        q, k, v = tfm.qkv(p, xn, cfg)
        if cfg.rope_theta:
            q = layers.apply_rope(q, positions, cfg.rope_theta)
            k = layers.apply_rope(k, positions, cfg.rope_theta)
        t_cache = cache["k"].shape[1]
        if spec.mixer in ("swa", "local"):
            win = cfg.window if spec.mixer == "swa" else cfg.local_window
            o = attn_lib.windowed_attention(q, k, v, window=win)
            fill = _fill_cache if k.shape[1] <= t_cache else _ring_cache
        else:
            o = attn_lib.chunked_attention(q, k, v, causal=True,
                                           kv_chunk=cfg.attn_kv_chunk)
            fill = _fill_cache
        new_cache["k"] = fill(k, t_cache, cfg.dtype)
        new_cache["v"] = fill(v, t_cache, cfg.dtype)
        x = x + tfm.heads_out(o, p["attn"]["wo"], cfg.dtype)
    elif spec.mixer == "ssd":
        xn = layers.NORM_APPLY[cfg.norm](p["mixer_norm"], x)
        y, sc = _ssd_prefill(p["ssd"], xn, cfg)
        new_cache.update(sc)
        x = x + y.to(x.dtype)
    elif spec.mixer == "rglru":
        xn = layers.NORM_APPLY[cfg.norm](p["mixer_norm"], x)
        y, rc = _rglru_prefill(p["rglru"], xn, cfg)
        new_cache.update(rc)
        x = x + y.to(x.dtype)
    if spec.cross_attn and enc_out is not None:
        y, new_cache["ck"], new_cache["cv"] = tfm.cross_mixer(p, x, cfg,
                                                              enc_out)
        x = x + y
    return tfm.apply_ffn(p, x, spec, cfg), new_cache


def prefill(params, cfg: ModelConfig, batch: Mapping, max_len: int,
            last_only: bool = False) -> Tuple[Tensor, list]:
    """Run the prompt, return (logits, cache at position S). With
    ``last_only`` only the final position is unembedded: the full [B,S,V]
    logits never exist. ``batch`` holds ``tokens`` and, for the frontend
    stubs, ``frames`` (an encoder-decoder, which encodes them once and
    then runs the decoder on the tokens plus ``dec_pos``) or
    ``vision_embeds``."""
    enc_out = None
    if cfg.family == "encdec":
        enc_out = tfm.encode(params, cfg, batch)
        tokens = torch.as_tensor(batch["tokens"], device=enc_out.device)
        x = tfm.embed_decoder(params, cfg, tokens, torch.arange(
            tokens.shape[1], device=enc_out.device))
    else:
        x = tfm.embed_inputs(params, cfg, batch)
    cache = init_cache(cfg, x.shape[0], max_len, device=x.device,
                       enc_len=0 if enc_out is None else enc_out.shape[1])
    positions = torch.arange(x.shape[1], device=x.device)
    x, new_caches = _run_layers(
        params, cache, x, cfg, lambda p, c, xx, sp: _prefill_layer(
            p, c, xx, sp, cfg, positions, enc_out))
    if last_only:
        x = x[:, -1:]
    return tfm.logits_from(params, cfg, x), new_caches


def _ssd_prefill_chunk(p, x: Tensor, cfg: ModelConfig,
                       row: Dict[str, Tensor], first: bool
                       ) -> Tuple[Tensor, Dict[str, Tensor]]:
    """One chunk of SSD prefill for one slot (batch 1). ``row`` holds the
    slot's carried ``state`` [1,H,P,N] and ``conv_buf`` [1,K-1,di+2N];
    ``first`` means zero history, which is the solo ``_ssd_prefill``'s
    math. A later chunk starts the scan from the carried state
    (``ssd_chunked``'s ``init_state``), exact because chunk boundaries are
    multiples of the scan's chunk (``chunk_tokens_for``)."""
    scfg = cfg.ssd_cfg
    b, t, _ = x.shape
    hist = None if first else row["conv_buf"]
    s = ssd_lib.ssd_inputs(p, x, scfg, conv_hist=hist)
    conv_in = s["conv_in"]
    prev = (conv_in.new_zeros((b, scfg.conv_width - 1, conv_in.shape[-1]))
            if first else hist.to(conv_in.dtype))
    full = torch.cat([prev, conv_in], dim=1)
    new_buf = full[:, full.shape[1] - (scfg.conv_width - 1):].to(cfg.dtype)
    y, state = ssd_lib.ssd_chunked(
        s["x"], s["dt"], s["a"], s["B"], s["C"], s["d_skip"],
        chunk=scfg.chunk,
        init_state=None if first else row["state"].to(torch.float32))
    y = ssd_lib.ssd_output(p, y.reshape(b, t, scfg.d_inner), s["z"], x.dtype)
    return y, {"state": state.to(row["state"].dtype), "conv_buf": new_buf}


def _chunk_layer(p, cache, x: Tensor, spec: LayerSpec, cfg: ModelConfig,
                 positions: Tensor, start: int, slot: int,
                 pages_row: Tensor, first: bool) -> Tensor:
    """One layer of chunked prefill for one slot, writing ``cache`` in
    place. x: [1, L, D]. Full attention writes the chunk into the slot's
    pages and, after the first chunk, reads every earlier page back; SSD
    runs on the slot's row of the per-slot state, written back into that
    row. Only the families ``chunk_tokens_for`` admits reach here."""
    tfm.check_ported(spec)
    if spec.mixer == "attn":
        xn = layers.NORM_APPLY[cfg.norm](p["mixer_norm"], x)
        q, k, v = tfm.qkv(p, xn, cfg)
        if cfg.rope_theta:
            q = layers.apply_rope(q, positions, cfg.rope_theta)
            k = layers.apply_rope(k, positions, cfg.rope_theta)
        attn_lib.paged_prefill_update(cache["k"], cache["v"], k, v,
                                      pages_row, start)
        if first:       # start == 0: self-contained, the solo math
            o = attn_lib.chunked_attention(q, k, v, causal=True,
                                           kv_chunk=cfg.attn_kv_chunk)
        else:
            o = attn_lib.chunked_attention(
                q, attn_lib.paged_gather(cache["k"], pages_row[None]),
                attn_lib.paged_gather(cache["v"], pages_row[None]),
                causal=True, q_offset=start, kv_valid_len=start + x.shape[1],
                kv_chunk=cfg.attn_kv_chunk)
        x = x + tfm.heads_out(o, p["attn"]["wo"], cfg.dtype)
    elif spec.mixer == "ssd":
        xn = layers.NORM_APPLY[cfg.norm](p["mixer_norm"], x)
        row = {k: cache[k][slot:slot + 1] for k in ("state", "conv_buf")}
        y, rc = _ssd_prefill_chunk(p["ssd"], xn, cfg, row, first)
        for k, v in rc.items():
            setitem_(cache[k], (slice(slot, slot + 1),), v)
        x = x + y.to(x.dtype)
    else:
        raise NotImplementedError(
            f"chunked prefill does not support mixer={spec.mixer!r} "
            "(chunk_tokens_for should have returned None)")
    return tfm.apply_ffn(p, x, spec, cfg)


def prefill_chunk(params, cfg: ModelConfig, cache, tokens: Tensor,
                  start: int, slot: int, pages_row: Tensor, *, first: bool,
                  last: bool) -> Tuple[Tensor, list]:
    """Consume one page-aligned prompt chunk for one slot of the paged
    engine. tokens: [1, L] at positions [start, start + L); ``cache`` is
    the engine's ``init_paged_cache`` tree, written in place and returned;
    ``pages_row`` [P] is the slot's page table.

    Returns (token [1] long, cache): the greedy next token after the
    prompt when ``last``, else zeros (a non-final chunk never unembeds)."""
    table = params["embed"]
    tokens = torch.as_tensor(tokens, device=table.device)
    x = layers.embed_lookup(table, tokens).to(cfg.dtype)
    positions = start + torch.arange(tokens.shape[1], device=x.device)
    pages_row = torch.as_tensor(pages_row, device=x.device)
    x = _run_layers_(params, cache, x, cfg, lambda p, c, xx, sp: _chunk_layer(
        p, c, xx, sp, cfg, positions, start, slot, pages_row, first))
    if not last:
        return torch.zeros((1,), dtype=torch.long, device=x.device), cache
    logits = tfm.logits_from(params, cfg, x[:, -1:])
    return greedy(logits), cache


def greedy(logits: Tensor) -> Tensor:
    """The argmax over the vocab of the last position [B, ..., V] -> [B],
    on logits whole on every rank (a vocab-parallel DTensor is gathered
    first), so every rank picks the same ids."""
    return torch.argmax(shlib.full(logits)[:, -1], dim=-1)


def generate(params, cfg: ModelConfig, prompt, n_new: int,
             max_len: Optional[int] = None) -> Tensor:
    """Greedy generation for a rectangular [B, S] prompt (static batch,
    lockstep decode).

    Contract (pinned, as in JAX): returns exactly ``n_new`` tokens per
    request, [B, n_new]. Token 0 is the argmax over the prefill logits at
    the last prompt position, so ``n_new=1`` runs no decode step;
    ``n_new < 1`` raises. A list of 1-D prompts of different lengths goes
    through the continuous-batching engine (``engine.generate_dynamic``),
    on the device of the parameters, and still returns [len(prompt),
    n_new].
    """
    if n_new < 1:
        raise ValueError(f"n_new must be >= 1, got {n_new}")
    if isinstance(prompt, (list, tuple)):
        from repro_torch.serve import engine as engine_lib
        return engine_lib.generate_dynamic(params, cfg, prompt, n_new,
                                           max_len=max_len,
                                           device=params["embed"].device)
    prompt = torch.as_tensor(prompt, device=params["embed"].device)
    b, s = prompt.shape
    max_len = max_len or (s + n_new)
    logits, cache = prefill(params, cfg, {"tokens": prompt}, max_len,
                            last_only=True)
    tok = torch.argmax(logits[:, -1:], dim=-1)
    out: List[Tensor] = [tok]
    for i in range(n_new - 1):
        logits, cache = decode_step(params, cache, tok, s + i, cfg)
        tok = torch.argmax(logits[:, -1:, :], dim=-1)
        out.append(tok)
    return torch.cat(out, dim=1)
