"""Serving: prefill (build caches) and single-token decode steps (port of
``repro.serve.decode``, restricted to static-batch serving of SSD models).

Cache layout per ``ssd`` layer (stacked [repeats, ...] inside a repeated
stage): the recurrent state [B, H, P, N] f32 and the depthwise conv's ring
buffer [B, K-1, di+2N] in the compute dtype. The prefill's scan runs the
``ssd_scan`` kernel on the card (``models.ssd.ssd_chunked``), which also
gives the final state the cache keeps.

Attention caches, the paged pool (``pages``) and the continuous-batching
engine behind a list-of-prompts ``generate`` are later slices (ROADMAP D2
and E).
"""
from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.models import ssd as ssd_lib
from repro_torch.models import transformer as tfm
from repro_torch.models import layers
from repro_torch.models.transformer import LayerSpec, ModelConfig

Tensor = torch.Tensor


def _init_layer_cache(spec: LayerSpec, cfg: ModelConfig, batch: int,
                      device) -> Dict[str, Tensor]:
    tfm.check_ported(spec)
    if spec.mixer == "ssd":
        return ssd_lib.init_ssd_cache(batch, cfg.ssd_cfg, cfg.dtype, device)
    return {}


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device=None) -> list:
    """Cache tree parallel to params["stages"] (``device=None``: the
    card). ``max_len`` sizes attention caches (Slice D2); SSD layers keep
    O(1) state."""
    device = resolve_device(device)
    out = []
    for stage in tfm.stages_for(cfg):
        blk = {f"l{i}": _init_layer_cache(sp, cfg, batch, device)
               for i, sp in enumerate(stage.block)}
        if stage.repeats > 1:
            blk = tfm.tree_map(lambda x, r=stage.repeats: x[None].repeat(
                (r,) + (1,) * x.ndim), blk)
        out.append(blk)
    return out


def _decode_layer(p, cache, x: Tensor, spec: LayerSpec, cfg: ModelConfig
                  ) -> Tuple[Tensor, Dict[str, Tensor]]:
    """x: [B, 1, D]. An SSD layer needs no position: its state carries it."""
    tfm.check_ported(spec)
    new_cache = dict(cache)
    if spec.mixer == "ssd":
        xn = layers.NORM_APPLY[cfg.norm](p["mixer_norm"], x)
        y, sc = ssd_lib.apply_ssd_block_decode(
            p["ssd"], xn, {"state": cache["state"],
                           "conv_buf": cache["conv_buf"]}, cfg.ssd_cfg)
        new_cache.update(sc)
        x = x + y.to(x.dtype)
    return x, new_cache


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


def decode_step(params, cache, tokens: Tensor, index, cfg: ModelConfig, *,
                pages: Optional[Tensor] = None) -> Tuple[Tensor, list]:
    """One decode step. tokens: [B, 1] -> (logits [B, 1, V], new cache).

    ``index`` is the 0-based position of the incoming token: a scalar when
    the whole batch decodes in lockstep, or a [B] vector; SSD layers do not
    read it (attention, Slice D2, will). ``pages`` (the paged engine's page
    tables) is Slice E and must be None."""
    if pages is not None:
        raise NotImplementedError("paged decode is not ported yet: ROADMAP "
                                  "Slice E (serving engine)")
    if cfg.family == "encdec":
        raise tfm.not_ported("family", "encdec")
    table = params["embed"]
    x = layers.embed_lookup(table, torch.as_tensor(tokens, device=table.device)
                            ).to(cfg.dtype)
    x, new_caches = _run_layers(
        params, cache, x, cfg,
        lambda p, c, xx, sp: _decode_layer(p, c, xx, sp, cfg))
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


def _prefill_layer(p, cache, x: Tensor, spec: LayerSpec, cfg: ModelConfig
                   ) -> Tuple[Tensor, Dict[str, Tensor]]:
    tfm.check_ported(spec)
    new_cache = dict(cache)
    if spec.mixer == "ssd":
        xn = layers.NORM_APPLY[cfg.norm](p["mixer_norm"], x)
        y, sc = _ssd_prefill(p["ssd"], xn, cfg)
        new_cache.update(sc)
        x = x + y.to(x.dtype)
    return x, new_cache


def prefill(params, cfg: ModelConfig, batch: Mapping, max_len: int,
            last_only: bool = False) -> Tuple[Tensor, list]:
    """Run the prompt, return (logits, cache at position S). With
    ``last_only`` only the final position is unembedded: the full [B,S,V]
    logits never exist."""
    if cfg.family == "encdec":
        raise tfm.not_ported("family", "encdec")
    x = tfm.embed_inputs(params, cfg, batch)
    cache = init_cache(cfg, x.shape[0], max_len, device=x.device)
    x, new_caches = _run_layers(
        params, cache, x, cfg,
        lambda p, c, xx, sp: _prefill_layer(p, c, xx, sp, cfg))
    if last_only:
        x = x[:, -1:]
    return tfm.logits_from(params, cfg, x), new_caches


def generate(params, cfg: ModelConfig, prompt, n_new: int,
             max_len: Optional[int] = None) -> Tensor:
    """Greedy generation for a rectangular [B, S] prompt (static batch,
    lockstep decode).

    Contract (pinned, as in JAX): returns exactly ``n_new`` tokens per
    request, [B, n_new]. Token 0 is the argmax over the prefill logits at
    the last prompt position, so ``n_new=1`` runs no decode step;
    ``n_new < 1`` raises. A list of prompts of different lengths goes
    through the continuous-batching engine in JAX, which is Slice E here.
    """
    if n_new < 1:
        raise ValueError(f"n_new must be >= 1, got {n_new}")
    if isinstance(prompt, (list, tuple)):
        raise NotImplementedError(
            "a list of prompts needs the continuous-batching engine, which "
            "is not ported yet: ROADMAP Slice E")
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
