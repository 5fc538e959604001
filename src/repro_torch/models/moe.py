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
``[n_model, E_loc, D, F_s]``, ``wo`` ``[n_model, E_loc, F_s, D]`` (``ep_split``
gives E_loc and the d_ff ways), so its parameters carry across as they
are. Under a mesh with a ``model`` axis (``dist.sharding.current_mesh``)
``apply_moe`` runs the reference's ``shard_map`` bodies through
``local_map``:

* expert-parallel (training, prefill): tokens split over the batch axes
  that divide B, replicated over ``model``; each model rank routes its
  block, slices its experts (or its d_ff share when E < n_model), and its
  output is a partial sum over ``model``. Capacity comes from the tokens
  of one data shard. The aux losses are averaged over ``model`` and, as
  the reference returns them (``out_specs=P()`` unchecked), are data
  shard 0's; their gradient is that of the mean over the data shards, as
  JAX differentiates that output;
* weights-stationary (``weights_stationary=True``): tokens replicated;
  each rank computes its expert x d_ff/n_data tile, and the output is a
  partial sum over ``data`` and ``model``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from repro_torch.dist.sharding import as_dtensors, current_mesh, mesh_sizes
from repro_torch.models import layers

Tensor = torch.Tensor


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


def ep_split(cfg: MoEConfig, n_model: int) -> Tuple[int, int]:
    """(experts per shard, ffn-shard ways). n_model % n_experts == 0 or
    n_experts % n_model == 0 required."""
    if cfg.n_experts % n_model == 0:
        return cfg.n_experts // n_model, 1
    if n_model % cfg.n_experts == 0:
        return 1, n_model // cfg.n_experts
    raise ValueError(f"experts={cfg.n_experts} vs model axis {n_model}")


def init_moe(gen: torch.Generator, cfg: MoEConfig, device=None,
             n_model: int = 1) -> Dict[str, Tensor]:
    """Weights pre-packed device-major for ``n_model`` model shards:
    ``wi``/``wg`` [n_model, E_loc, D, F_s], ``wo`` [n_model, E_loc, F_s, D]
    (``ep_split``), drawn from ``gen`` (router, wi, wg, wo, then the shared
    expert's wi, wg, wo) as N(0, 1) * std in f32, cast to ``cfg.dtype``;
    the router then goes back to f32, as in the reference."""
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    e_loc, fs = ep_split(cfg, n_model)
    f_s = f // fs
    std_in = d ** -0.5
    std_out = f ** -0.5

    def w(shape, std):
        return (layers.normal(gen, shape, device) * std).to(cfg.dtype)
    params = {
        "router": w((d, e), std_in).to(torch.float32),
        "wi": w((n_model, e_loc, d, f_s), std_in),
        "wg": w((n_model, e_loc, d, f_s), std_in),
        "wo": w((n_model, e_loc, f_s, d), std_out),
    }
    if cfg.n_shared_experts:
        dsh = f * cfg.n_shared_experts
        params["shared"] = {
            "wi": w((d, dsh), std_in),
            "wg": w((d, dsh), std_in),
            "wo": w((dsh, d), std_out),
        }
    return params


def moe_spec(cfg: MoEConfig) -> Dict:
    """Logical sharding names of ``init_moe``'s leaves: the packed leading
    axis over the experts' shards."""
    spec = {
        "router": ("none", "none"),
        "wi": ("experts", "none", "embed", "none"),
        "wg": ("experts", "none", "embed", "none"),
        "wo": ("experts", "none", "none", "embed"),
    }
    if cfg.n_shared_experts:
        spec["shared"] = {"wi": ("embed", "mlp"),
                          "wg": ("embed", "mlp"),
                          "wo": ("mlp", "embed")}
    return spec


def top_k(probs: Tensor, k: int) -> Tuple[Tensor, Tensor]:
    """The k largest entries of each row and their indices, largest first
    and, on equal values, the lower index first (``jax.lax.top_k``'s
    order; ``torch.topk`` promises no order for ties)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]



def _bincount(ids: Tensor, n: int) -> Tensor:
    """``torch.bincount(ids, minlength=n)`` for ids in [0, n): the same
    counts, with a shape known from the shapes alone (so it also runs on
    meta tensors, where ``bincount`` has no kernel)."""
    return torch.zeros(n, dtype=torch.long, device=ids.device).scatter_add(
        0, ids, torch.ones_like(ids))

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
    ce = (_bincount(top_e.reshape(-1), e).to(torch.float32)
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
    counts = _bincount(se, e)
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


def _combine(out: Tensor, combine_w: Tensor, slot_dst: Tensor,
             e0: int = 0) -> Tensor:
    """[T, D] f32: each token's ``out * w`` rows added from zero in
    expert order (the reference's scatter-add order over the flattened
    [E, C] buffer). ``out`` and ``combine_w`` hold experts ``e0`` to ``e0 +
    E_loc`` (a model shard's). ``slot_dst`` [T, K] holds the rows' buffer
    positions, which grow with the expert id; a dropped slot, or one of
    another shard's experts, points past the buffer, at a zero row, and
    sorts last."""
    e, c, d = out.shape
    rows = torch.cat([(out * combine_w[..., None]).reshape(e * c, d),
                      out.new_zeros((1, d), dtype=torch.float32)])
    loc = slot_dst - e0 * c
    loc = torch.where((loc >= 0) & (loc < e * c), loc, e * c)
    idx = torch.sort(loc, dim=-1).values
    y = rows.new_zeros((slot_dst.shape[0], d))
    for j in range(idx.shape[1]):
        y = y + rows[idx[:, j]]
    return y


def _moe_local(tokens: Tensor, router_w: Tensor, wi: Tensor, wg: Tensor,
               wo: Tensor, cfg: MoEConfig, capacity: int, m_idx: int = 0,
               n_model: int = 1) -> Tuple[Tensor, Dict[str, Tensor]]:
    """One model shard's part (tokens replicated over ``model``): route
    every token, run the shard's E_loc experts (or its d_ff share of
    expert ``m_idx // (n_model / E)`` when E < n_model) on their slots,
    and combine. tokens: [T, D] -> ([T, D] f32, partial over the model
    shards; aux losses)."""
    buf, _, cw, _, aux, slot_dst = _dispatch(tokens, router_w, cfg,
                                             capacity)
    e_loc = wi.shape[0]
    if cfg.n_experts % n_model == 0:
        e0 = m_idx * e_loc
    else:
        e0 = m_idx // (n_model // cfg.n_experts)
    out = _expert_ffn(buf[e0:e0 + e_loc].to(wi.dtype), wi, wg, wo,
                      cfg.activation)
    return _combine(out, cw[e0:e0 + e_loc], slot_dst, e0), aux


def capacity_for(n_tokens: int, cfg: MoEConfig) -> int:
    """Slots per expert for ``n_tokens`` tokens routed in one call, in
    Python's float arithmetic as the reference (a float32 product can
    round the other way at an integer boundary)."""
    return max(1, int(n_tokens * cfg.top_k * cfg.capacity_factor
                      / cfg.n_experts))


def _shared_experts(params, x: Tensor, y: Tensor, cfg: MoEConfig) -> Tensor:
    if not cfg.n_shared_experts:
        return y
    sh = params["shared"]
    act = layers.ACTIVATIONS[cfg.activation]
    h = act(layers.matmul(x, sh["wg"])) * layers.matmul(x, sh["wi"])
    return y + layers.matmul(h, sh["wo"]).to(y.dtype)


def apply_moe(params: Dict[str, Tensor], x: Tensor, cfg: MoEConfig, *,
              weights_stationary: bool = False
              ) -> Tuple[Tensor, Dict[str, Tensor]]:
    """x: [B, S, D] -> (y [B, S, D] in x's dtype, aux losses).

    Without a mesh (or with a model axis of 1) all B*S tokens are routed
    together on every rank. Under a mesh with a model axis the
    expert-parallel path runs, or with ``weights_stationary`` (serving,
    decode) the weights-stationary one (the module docstring)."""
    mesh = current_mesh()
    n_model = mesh_sizes(mesh).get("model", 1)
    if mesh is not None and n_model > 1:
        if weights_stationary:
            y, aux = _apply_moe_stationary(params, x, cfg, mesh, n_model)
        else:
            y, aux = _apply_moe_ep(params, x, cfg, mesh, n_model)
        return _shared_experts(params, x, y, cfg), aux
    if params["wi"].shape[0] != 1:
        raise ValueError(f"MoE weights packed for {params['wi'].shape[0]} "
                         f"model shards need a mesh with that model axis")
    if mesh is not None:
        return _apply_moe_replicated(params, x, cfg, mesh)
    b, s, d = x.shape
    tokens = x.reshape(-1, d)
    y, aux = _moe_local(tokens, params["router"], params["wi"][0],
                        params["wg"][0], params["wo"][0], cfg,
                        capacity_for(tokens.shape[0], cfg))
    y = y.reshape(b, s, d).to(x.dtype)
    return _shared_experts(params, x, y, cfg), aux


_AUX = ("moe_load_balance", "moe_z", "moe_drop_frac")


def _mesh_call(mesh, fn, args, in_pl, out_pl, in_grad):
    from torch.distributed.tensor.experimental import local_map
    _, args = as_dtensors(*args)
    return local_map(fn, out_placements=out_pl, in_placements=in_pl,
                     in_grad_placements=in_grad, device_mesh=mesh,
                     redistribute_inputs=True)(*args)


def _apply_moe_replicated(params, x: Tensor, cfg: MoEConfig, mesh):
    """A mesh without a model axis: every rank routes all the tokens (the
    reference's unsharded path, which GSPMD runs whole)."""
    from torch.distributed.tensor import Replicate
    rep = [Replicate()] * mesh.ndim

    def local(xl, router, wi, wg, wo):
        b, s, d = xl.shape
        tokens = xl.reshape(-1, d)
        y, aux = _moe_local(tokens, router, wi[0], wg[0], wo[0], cfg,
                            capacity_for(tokens.shape[0], cfg))
        return (y.reshape(b, s, d).to(xl.dtype),) + tuple(aux[k]
                                                          for k in _AUX)
    outs = _mesh_call(mesh, local, (x, params["router"], params["wi"],
                                    params["wg"], params["wo"]),
                      (rep,) * 5, (rep,) * 4, (rep,) * 5)
    return outs[0], dict(zip(_AUX, outs[1:]))


def _apply_moe_ep(params, x: Tensor, cfg: MoEConfig, mesh, n_model: int):
    """The reference's expert-parallel ``shard_map`` body under
    ``local_map``: the output is a partial sum over ``model`` (and
    Shard(0) over the batch axes that divide B). Each aux loss is a partial
    sum over the split axes whose value is data shard 0's (its mean over
    ``model``), as the reference returns it, and whose gradient is that of
    the mean over the data shards, as JAX differentiates the reference's
    unchecked ``out_specs=P()``: every rank adds aux / (n_model * n_dp)
    plus, detached, the difference to its share of shard 0's value."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    b, s, d = x.shape
    names = list(mesh.mesh_dim_names)
    sizes = mesh_sizes(mesh)
    axes, dp = [], 1
    for a in ("pod", "data"):
        if a in sizes and b % (dp * sizes[a]) == 0:
            axes.append(a)
            dp *= sizes[a]
    t_per_shard = (b // dp) * s
    capacity = capacity_for(t_per_shard, cfg)
    split = set(axes) | {"model"}
    x_pl = [Shard(0) if n in axes else Replicate() for n in names]
    w_pl = [Shard(0) if n == "model" else Replicate() for n in names]
    rep = [Replicate()] * mesh.ndim
    # a replicated input used on shards of another gets a partial gradient;
    # over a data axis that does not divide B every rank computes the same
    x_g = [Shard(0) if n in axes else
           (Partial() if n == "model" else Replicate()) for n in names]
    r_g = [Partial() if n in split else Replicate() for n in names]
    w_g = [Shard(0) if n == "model" else
           (Partial() if n in axes else Replicate()) for n in names]
    y_pl = [Shard(0) if n in axes else
            (Partial() if n == "model" else Replicate()) for n in names]
    aux_pl = [Partial() if n in split else Replicate() for n in names]
    coord = mesh.get_coordinate()
    m_idx = coord[names.index("model")]
    first = all(coord[names.index(a)] == 0 for a in axes)
    keep = (1.0 if first else 0.0) / n_model
    share = 1.0 / (n_model * dp)

    def local(xl, router, wi, wg, wo):
        bl = xl.shape[0]
        y, aux = _moe_local(xl.reshape(-1, d), router, wi[0], wg[0], wo[0],
                            cfg, capacity, m_idx, n_model)
        return (y.reshape(bl, s, d),) + tuple(
            aux[k] * share + (aux[k] * keep - aux[k] * share).detach()
            for k in _AUX)
    outs = _mesh_call(mesh, local, (x, params["router"], params["wi"],
                                    params["wg"], params["wo"]),
                      (x_pl, rep, w_pl, w_pl, w_pl),
                      (y_pl,) + (aux_pl,) * 3,
                      (x_g, r_g, w_g, w_g, w_g))
    # the f32 partial sums are added, then cast (the reference's psum)
    y = outs[0].redistribute(mesh, [p if p.is_shard() else Replicate()
                                    for p in y_pl]).to(x.dtype)
    return y, {k: v.redistribute(mesh, rep) for k, v in zip(_AUX, outs[1:])}


def _apply_moe_stationary(params, x: Tensor, cfg: MoEConfig, mesh,
                          n_model: int):
    """The reference's weights-stationary ``shard_map`` body under
    ``local_map``: tokens replicated, each rank's expert x d_ff/n_data tile
    of weights; the output a partial sum over every axis."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    b, s, d = x.shape
    names = list(mesh.mesh_dim_names)
    sizes = mesh_sizes(mesh)
    data_axes = [a for a in ("pod", "data") if a in sizes]
    n_data = 1
    for a in data_axes:
        n_data *= sizes[a]
    ff_s = params["wi"].shape[-1]
    if ff_s % n_data != 0:
        raise ValueError(f"d_ff slice {ff_s} not divisible by data={n_data}")
    capacity = capacity_for(b * s, cfg)
    rep = [Replicate()] * mesh.ndim
    part = [Partial()] * mesh.ndim

    def w_pl(ff_dim):
        return [Shard(0) if n == "model" else
                (Shard(ff_dim) if n in data_axes else Replicate())
                for n in names]
    m_idx = mesh.get_coordinate()[names.index("model")]
    share = 1.0 / (n_model * n_data)

    def local(xl, router, wi, wg, wo):
        y, aux = _moe_local(xl.reshape(-1, d), router, wi[0], wg[0], wo[0],
                            cfg, capacity, m_idx, n_model)
        return (y.reshape(b, s, d),) + tuple(aux[k] * share for k in _AUX)
    outs = _mesh_call(mesh, local, (x, params["router"], params["wi"],
                                    params["wg"], params["wo"]),
                      (rep, rep, w_pl(3), w_pl(3), w_pl(2)),
                      (part,) * 4,
                      (part, part, w_pl(3), w_pl(3), w_pl(2)))
    return (outs[0].redistribute(mesh, rep).to(x.dtype),
            {k: v.redistribute(mesh, rep) for k, v in zip(_AUX, outs[1:])})
