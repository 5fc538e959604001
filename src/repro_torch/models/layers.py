"""Shared neural-net building blocks (port of ``repro.models.layers``):
plain functions on tensors and dicts of tensors, in the JAX package's
layouts.

Initialisers draw from an explicit ``torch.Generator`` on the device they
fill (a CUDA generator for the card, so the draws never leave it; any
generator with ``device="meta"``, which only gives shapes). The two
frameworks' generators give different numbers from one seed: parity tests
carry the JAX weights across instead.

JAX promotes mixed dtypes in a product (bf16 @ f32 is f32); ``torch.matmul``
raises on them. ``matmul`` makes that promotion explicit, and every product
of the port's LM stack goes through it.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from repro_torch.dist.sharding import (as_dtensors, is_dtensor, pin_grad,
                                       placements_of, shard)

Tensor = torch.Tensor


def matmul(a: Tensor, b: Tensor) -> Tensor:
    """``a @ b`` in the dtype JAX gives a mixed product: both operands are
    cast to their promoted type first (bf16 @ f32 runs, and returns, f32).
    A DTensor ``a`` split on a leading dim other than the first (the
    sequence, under ``seq_sp``) is gathered on that dim first, as
    Megatron's sequence parallelism gathers before a projection, and the
    product's gradient comes back placed as the product (``pin_grad``):
    the product flattens the leading dims, forward and backward, which
    DTensor (torch 2.11) refuses with an inner one split. A product whose
    contraction is split comes back summed over the ranks in its own dtype,
    before any cast (DTensor would otherwise cast the partial sums, e.g. an
    f32 projection's to bf16, and add them rounded)."""
    rt = torch.promote_types(a.dtype, b.dtype)
    if not (is_dtensor(a) and a.ndim > 2):
        return a.to(rt) @ b.to(rt)
    pl = placements_of(a)
    if any(p.is_shard() and 0 < p.dim < a.ndim - 1 for p in pl):
        from torch.distributed.tensor import Replicate
        a = a.redistribute(a.device_mesh, [
            Replicate() if p.is_shard() and 0 < p.dim < a.ndim - 1 else p
            for p in pl])
    out = a.to(rt) @ b.to(rt)
    if any(p.is_partial() for p in out.placements):
        from torch.distributed.tensor import Replicate
        out = out.redistribute(out.device_mesh, [
            Replicate() if p.is_partial() else p for p in out.placements])
    return pin_grad(out)


def normal(gen: Optional[torch.Generator], shape, device) -> Tensor:
    """Standard normal f32 draws of ``shape`` on ``device`` from ``gen``."""
    return torch.randn(shape, generator=gen, device=device,
                       dtype=torch.float32)


# --- norms -------------------------------------------------------------------

def init_rmsnorm(d: int, device=None) -> Dict[str, Tensor]:
    return {"scale": torch.ones((d,), dtype=torch.float32, device=device)}


def rmsnorm(params: Dict[str, Tensor], x: Tensor, eps: float = 1e-6
            ) -> Tensor:
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps) * params["scale"]
    return y.to(x.dtype)


def norm_spec(kind: str):
    """Logical sharding names of a norm's params (replicated)."""
    return ({"scale": ("none",)} if kind == "rmsnorm"
            else {"scale": ("none",), "bias": ("none",)})


def init_layernorm(d: int, device=None) -> Dict[str, Tensor]:
    return {"scale": torch.ones((d,), dtype=torch.float32, device=device),
            "bias": torch.zeros((d,), dtype=torch.float32, device=device)}


def layernorm(params: Dict[str, Tensor], x: Tensor, eps: float = 1e-5
              ) -> Tensor:
    xf = x.to(torch.float32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean((xf - mu) ** 2, dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps) * params["scale"] + params["bias"]
    return y.to(x.dtype)


NORM_INIT = {"rmsnorm": init_rmsnorm, "layernorm": init_layernorm}
NORM_APPLY = {"rmsnorm": rmsnorm, "layernorm": layernorm}


# --- dense -------------------------------------------------------------------

def dense_init(gen: Optional[torch.Generator], d_in: int, d_out,
               dtype=torch.float32, scale: Optional[float] = None,
               device=None) -> Tensor:
    shape = (d_in,) + (d_out if isinstance(d_out, tuple) else (d_out,))
    std = scale if scale is not None else 1.0 / math.sqrt(d_in)
    return (normal(gen, shape, device) * std).to(dtype)


# --- activations -------------------------------------------------------------

def _const(v: float, x: Tensor) -> Tensor:
    """A constant rounded to x's dtype first, as a weakly typed constant is
    in JAX (at bf16, 0.044715 becomes 0.0446777...)."""
    return torch.tensor(v, dtype=x.dtype, device=x.device)


def sigmoid(x: Tensor) -> Tensor:
    """``jax.nn.sigmoid`` as XLA lowers it: ``1 / (1 + exp(-x))``, op by
    op in x's dtype (at bf16 each op rounds, as there)."""
    return 1.0 / (1.0 + torch.exp(-x))


def silu(x: Tensor) -> Tensor:
    """``jax.nn.silu``: ``x * sigmoid(x)``, op by op in x's dtype."""
    return x * sigmoid(x)


def gelu(x: Tensor) -> Tensor:
    """``jax.nn.gelu``'s default, the tanh approximation, op by op in x's
    dtype as XLA computes it: ``x * (0.5 * (1 + tanh(sqrt(2/pi) * (x +
    0.044715 * x*x*x))))`` with both constants in x's dtype."""
    inner = _const(math.sqrt(2 / math.pi), x) * (
        x + _const(0.044715, x) * (x * x * x))
    return x * (0.5 * (1.0 + torch.tanh(inner)))


def squared_relu(x: Tensor) -> Tensor:
    r = torch.relu(x)
    return r * r


ACTIVATIONS = {
    "gelu": gelu,
    "silu": silu,
    "relu": torch.relu,
    "relu2": squared_relu,
}


# --- rotary position embedding -----------------------------------------------

def rope_frequencies(head_dim: int, theta: float = 10000.0,
                     device=None) -> Tensor:
    half = head_dim // 2
    return theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=device) / half)


def apply_rope(x: Tensor, positions: Tensor, theta: float = 10000.0
               ) -> Tensor:
    """x: [B, S, H, hd]; positions: [B, S] or [S] integers."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)     # [hd/2]
    if positions.ndim == 1:
        positions = positions[None, :]
    angles = positions[..., None].to(torch.float32) * freqs    # [B, S, hd/2]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(seq: int, d: int, max_scale: float = 10000.0,
                         device=None) -> Tensor:
    """Whisper-style fixed sinusoidal embeddings [seq, d]."""
    half = d // 2
    freq = torch.exp(-math.log(max_scale)
                     * torch.arange(half, dtype=torch.float32, device=device)
                     / (half - 1))
    args = (torch.arange(seq, dtype=torch.float32, device=device)[:, None]
            * freq[None, :])
    return torch.cat([torch.sin(args), torch.cos(args)], dim=-1)


# --- embedding ---------------------------------------------------------------

def init_embedding(gen: Optional[torch.Generator], vocab: int, d: int,
                   dtype=torch.float32, device=None) -> Tensor:
    return (normal(gen, (vocab, d), device) * (1.0 / math.sqrt(d))).to(dtype)


def embed_lookup(table: Tensor, ids: Tensor) -> Tensor:
    """``table[ids]`` [..., D]. A DTensor table runs vocab-parallel on each
    rank's shard (``_vocab_parallel_lookup``)."""
    if is_dtensor(table) or is_dtensor(ids):
        return shard(_vocab_parallel_lookup(table, ids), "batch", "seq",
                     None)
    return table[ids.to(torch.long)]


def _vocab_parallel_lookup(table: Tensor, ids: Tensor) -> Tensor:
    """The lookup under ``local_map``, per mesh dim: where the table's
    vocab is split, each rank looks up the ids in its range (zeros
    elsewhere) and the rows are a partial sum; else where the ids are
    split, they stay split and the table is gathered there (its embed
    shards: the lookup needs whole rows); else all replicate. The table's
    gradient is partial where the ids are split."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh, (table, ids) = as_dtensors(table, ids)
    t_pl, i_pl, o_pl, g_pl = [], [], [], []
    vocab = []   # (mesh dim, ways) of the vocab splits, outermost first
    for i, (pt, pi) in enumerate(zip(placements_of(table),
                                     placements_of(ids))):
        if pt.is_shard(0):
            col = (Shard(0), Replicate(), Partial(), Shard(0))
            vocab.append((i, mesh.size(i)))
        elif pi.is_shard(0):
            col = (Replicate(), Shard(0), Shard(0), Partial())
        else:
            col = (Replicate(),) * 4
        for lst, p in zip((t_pl, i_pl, o_pl, g_pl), col):
            lst.append(p)
    coord = mesh.get_coordinate()

    def local(tl, il):
        lo, rows = 0, table.shape[0]
        for i, n in vocab:
            rows //= n
            lo += coord[i] * rows
        idx = il.to(torch.long) - lo
        inside = (idx >= 0) & (idx < tl.shape[0])
        out = tl[torch.where(inside, idx, 0)]
        return torch.where(inside[..., None], out, out.new_zeros(()))
    return local_map(local, out_placements=o_pl, in_placements=(t_pl, i_pl),
                     in_grad_placements=(g_pl, i_pl), device_mesh=mesh,
                     redistribute_inputs=True)(table, ids)


def unembed(x: Tensor, table: Tensor) -> Tensor:
    """Tied output projection: ``einsum("bsd,vd->bsv")`` in the promoted
    dtype (bf16 x bf16 stays bf16)."""
    return shard(matmul(x, table.transpose(0, 1)), "batch", "seq", "vocab")
