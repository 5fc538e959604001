"""Mixture-of-Experts FFN (Mixtral, Kimi-K2 style; port of
``repro.models.moe`` on its single-device path).

Routing and capacity dispatch are the reference's:

  1. router logits in f32, softmax, top-k experts per token (on equal
     probabilities the lower expert index first, as ``jax.lax.top_k``),
     renormalised weights;
  2. the capacity-dispatch buffer [E, C, D]: one stable argsort orders the
     (token, k) slots by expert, a slot's rank within its expert is its
     position minus the expert's start, and slots at rank >= C are dropped
     (GShard token dropping, their combine weight gone);
  3. the batched expert FFN (SwiGLU) over [E, C, D] in the weights' dtype;
  4. the weighted combine back onto the tokens in f32.

``capacity = max(1, int(T * top_k * capacity_factor / E))`` is computed on
the T tokens of one call with Python's float arithmetic, as the reference
does, so which tokens are dropped depends on the batch (at a capacity
factor where nothing is dropped, a token's output does not).

The reference adds each token's k weighted expert outputs into an f32
buffer with a scatter-add, which on its CPU runs the updates in buffer
order: by expert id. The port gathers each token's k rows through their
buffer positions, which the dispatch already knows, and adds them in that
same order, starting from zero, with no atomics, so the combine is
deterministic on the card (top-2's two addends onto zero commute bitwise
anyway; kimi's top-8 do not).

The weights keep the reference's device-major layout ``wi``/``wg``
``[n_model, E_loc, D, F_s]``, ``wo`` ``[n_model, E_loc, F_s, D]`` at
``n_model = 1``, so its parameters carry across as they are. Weights
packed for more model shards, the expert-parallel paths (``shard_map``
over a mesh, weights-stationary decode) and ``moe_spec`` are ROADMAP
Slice F. ``weights_stationary`` is
accepted and, on one device, does what the reference does without a mesh.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from repro_torch.models import layers

Tensor = torch.Tensor
MESH_SLICE = "ROADMAP Slice F (distribution)"


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    d_model: int
    d_ff: int                 # per-expert hidden dim
    n_experts: int
    top_k: int
    n_shared_experts: int = 0  # Kimi-K2: dense shared expert(s) alongside
    capacity_factor: float = 1.25
    activation: str = "silu"   # SwiGLU gating
    router_z_coef: float = 1e-3
    load_balance_coef: float = 1e-2
    dtype: object = torch.float32


def init_moe(gen: torch.Generator, cfg: MoEConfig, device=None
             ) -> Dict[str, Tensor]:
    """Weights in the reference's device-major layout for one model shard:
    ``wi``/``wg`` [1, E, D, F], ``wo`` [1, E, F, D], drawn from ``gen``
    (router, wi, wg, wo, then the shared expert's wi, wg, wo) as N(0, 1) *
    std in f32, cast to ``cfg.dtype``; the router then goes back to f32,
    as in the reference."""
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    std_in = d ** -0.5
    std_out = f ** -0.5

    def w(shape, std):
        return (layers.normal(gen, shape, device) * std).to(cfg.dtype)
    params = {
        "router": w((d, e), std_in).to(torch.float32),
        "wi": w((1, e, d, f), std_in),
        "wg": w((1, e, d, f), std_in),
        "wo": w((1, e, f, d), std_out),
    }
    if cfg.n_shared_experts:
        dsh = f * cfg.n_shared_experts
        params["shared"] = {
            "wi": w((d, dsh), std_in),
            "wg": w((d, dsh), std_in),
            "wo": w((dsh, d), std_out),
        }
    return params


def top_k(probs: Tensor, k: int) -> Tuple[Tensor, Tensor]:
    """The k largest entries of each row and their indices, largest first
    and, on equal values, the lower index first (``jax.lax.top_k``'s
    order; ``torch.topk`` promises no order for ties)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _dispatch(tokens: Tensor, router_w: Tensor, cfg: MoEConfig,
              capacity: int):
    """Routing + capacity dispatch. tokens: [T, D].

    Returns (buf [E, C, D], combine_idx [E, C] token ids (T = empty),
    combine_w [E, C], valid [E, C], aux losses dict, slot_dst [T, K]: each
    (token, k) slot's position in the flattened [E, C] buffer, E * C where
    it was dropped)."""
    t, d = tokens.shape
    e, k = cfg.n_experts, cfg.top_k
    dev = tokens.device
    logits = layers.matmul(tokens.to(torch.float32), router_w)   # [T, E]
    probs = torch.softmax(logits, dim=-1)
    top_w, top_e = top_k(probs, k)                                # [T, K]
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)

    # aux losses (Switch/Mixtral style)
    me = probs.mean(dim=0)                                        # [E]
    ce = (torch.bincount(top_e.reshape(-1), minlength=e).to(torch.float32)
          / (t * k))
    lb_loss = cfg.load_balance_coef * e * torch.sum(me * ce)
    z_loss = cfg.router_z_coef * torch.mean(
        torch.logsumexp(logits, dim=-1) ** 2)

    # slot ordering: sort (token, k) slots by expert id, stably
    slot_e = top_e.reshape(-1)                                    # [T*K]
    slot_w = top_w.reshape(-1)
    order = torch.argsort(slot_e, stable=True)
    se, sw = slot_e[order], slot_w[order]
    st = torch.div(order, k, rounding_mode="floor")   # the slot's token
    counts = torch.bincount(se, minlength=e)
    starts = torch.cumsum(counts, 0) - counts                     # [E]
    rank = torch.arange(t * k, device=dev) - starts[se]
    keep = rank < capacity
    # scatter into [E, C]; overflow slots all go to one pad entry past the
    # end (the reference sends an expert's overflow to the next expert's
    # first slot, which that slot's own later write then overwrites: the
    # same result, with no slot written by two kept slots)
    dst = torch.where(keep, se * capacity + rank, e * capacity)
    combine_tok = torch.full((e * capacity + 1,), t, dtype=torch.long,
                             device=dev)
    combine_tok[dst] = torch.where(keep, st, t)
    combine_w = torch.zeros((e * capacity + 1,), dtype=torch.float32,
                            device=dev)
    combine_w[dst] = torch.where(keep, sw, 0.0)
    combine_tok = combine_tok[:-1].reshape(e, capacity)
    combine_w = combine_w[:-1].reshape(e, capacity)
    valid = combine_tok < t
    # gather tokens (padded row at index t)
    tok_pad = torch.cat([tokens, tokens.new_zeros((1, d))], 0)
    buf = tok_pad[combine_tok]                                    # [E, C, D]
    # the mean as the reference's XLA computes it: the sum times the f32
    # reciprocal of the count (a true division rounds differently)
    kept = keep.to(torch.float32).sum() * torch.tensor(
        1.0 / (t * k), dtype=torch.float32, device=dev)
    aux = {"moe_load_balance": lb_loss, "moe_z": z_loss,
           "moe_drop_frac": 1.0 - kept}
    slot_dst = torch.empty_like(dst)
    slot_dst[order] = dst
    return buf, combine_tok, combine_w, valid, aux, slot_dst.reshape(t, k)


def _expert_ffn(buf: Tensor, wi: Tensor, wg: Tensor, wo: Tensor,
                activation: str) -> Tensor:
    """buf: [E_loc, C, D] x wi/wg [E_loc, D, F] -> wo [E_loc, F, D]."""
    act = layers.ACTIVATIONS[activation]
    h = torch.bmm(buf, wi)
    g = torch.bmm(buf, wg)
    return torch.bmm(act(g) * h, wo)


def _combine(out: Tensor, combine_w: Tensor, slot_dst: Tensor) -> Tensor:
    """[T, D] f32: each token's ``out * w`` rows added from zero in
    expert order (the reference's scatter-add order over the flattened
    [E, C] buffer). ``slot_dst`` [T, K] holds the rows' buffer positions,
    which grow with the expert id; a dropped slot points past the buffer,
    at a zero row, and sorts last."""
    e, c, d = out.shape
    rows = torch.cat([(out * combine_w[..., None]).reshape(e * c, d),
                      out.new_zeros((1, d), dtype=torch.float32)])
    idx = torch.sort(slot_dst, dim=-1).values
    y = rows.new_zeros((slot_dst.shape[0], d))
    for j in range(idx.shape[1]):
        y = y + rows[idx[:, j]]
    return y


def _moe_local(tokens: Tensor, router_w: Tensor, wi: Tensor, wg: Tensor,
               wo: Tensor, cfg: MoEConfig, capacity: int
               ) -> Tuple[Tensor, Dict[str, Tensor]]:
    """The whole expert set on one device (the reference's ``_moe_local``
    at ``m_idx = 0``, ``n_model = 1``). tokens: [T, D] -> [T, D] f32."""
    buf, _, cw, _, aux, slot_dst = _dispatch(tokens, router_w, cfg,
                                             capacity)
    out = _expert_ffn(buf.to(wi.dtype), wi, wg, wo, cfg.activation)
    return _combine(out, cw, slot_dst), aux


def capacity_for(n_tokens: int, cfg: MoEConfig) -> int:
    """Slots per expert for ``n_tokens`` tokens routed in one call, in
    Python's float arithmetic as the reference (a float32 product can
    round the other way at an integer boundary)."""
    return max(1, int(n_tokens * cfg.top_k * cfg.capacity_factor
                      / cfg.n_experts))


def apply_moe(params: Dict[str, Tensor], x: Tensor, cfg: MoEConfig, *,
              weights_stationary: bool = False
              ) -> Tuple[Tensor, Dict[str, Tensor]]:
    """x: [B, S, D] -> (y [B, S, D] in x's dtype, aux losses), all B*S
    tokens routed together. ``weights_stationary`` selects the reference's
    sharded decode dataflow, which needs a mesh; on one device both paths
    are this one."""
    del weights_stationary
    if params["wi"].shape[0] != 1:
        raise NotImplementedError(
            f"MoE weights packed for {params['wi'].shape[0]} model shards "
            f"are not ported yet: {MESH_SLICE}")
    b, s, d = x.shape
    tokens = x.reshape(-1, d)
    y, aux = _moe_local(tokens, params["router"], params["wi"][0],
                        params["wg"][0], params["wo"][0], cfg,
                        capacity_for(tokens.shape[0], cfg))
    y = y.reshape(b, s, d).to(x.dtype)
    if cfg.n_shared_experts:
        sh = params["shared"]
        act = layers.ACTIVATIONS[cfg.activation]
        h = act(layers.matmul(x, sh["wg"])) * layers.matmul(x, sh["wi"])
        y = y + layers.matmul(h, sh["wo"]).to(y.dtype)
    return y, aux
