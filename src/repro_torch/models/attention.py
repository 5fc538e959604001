"""Attention: GQA/MQA/MHA with a chunked online softmax (port of
``repro.models.attention``), in plain PyTorch.

* ``chunked_attention`` — full (causal or bidirectional) attention with an
  online softmax over KV chunks, in f32, chunk by chunk as the reference
  scans them: peak memory O(S * chunk) instead of O(S^2).
* ``windowed_attention`` — sliding-window attention (Mistral/Mixtral SWA,
  Griffin local attention): with the window W as chunk size, a query in
  chunk i needs key chunks i-1 and i only.
* ``decode_attention`` — a one-token query against a (possibly rolling) KV
  cache; ``cache_update`` writes one token's K/V into it.

GQA groups the query heads as [B, S, Kv, G, hd] with ``Kv = k.shape[2]``:
query head h reads kv head ``h // (Hq // Kv)`` of the (padded) head counts,
as in the reference. Internally the scores are kept as [B, Kv, S, G, T] so
that each product is one batched matmul over (B, Kv).

The softmax is written out rather than taken from
``scaled_dot_product_attention``, which sums in another order: the port
follows the reference. Masked scores are ``NEG_INF = -1e30``, not -inf, so a
fully masked row gives uniform weights, not NaN.

The serving engine's page pool (``serve.decode.init_paged_cache``) is read
by ``paged_gather`` and written by ``paged_cache_update`` (one decode token
per slot) and ``paged_prefill_update`` (one slot's prefill chunk). Where
the reference returns updated pools (donated, so XLA updates them in
place), these write the given pool in place: the engine's pools are the
whole KV memory, and a copy per tick would move all of it. Under a mesh
(DTensor pools, split on their kv heads or head dim and never on the page
axes) each rank gathers and writes its own shard (``sharding.setitem_``).
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.dist.sharding import (as_dtensors, contiguous_grad,
                                       is_dtensor, placements_of, setitem_)

Tensor = torch.Tensor
NEG_INF = -1e30


def _split_heads(q: Tensor, n_kv: int) -> Tensor:
    """[B, S, Hq, hd] -> [B, S, Kv, G, hd]."""
    b, s, hq, hd = q.shape
    return q.reshape(b, s, n_kv, hq // n_kv, hd)


def _grouped_queries(q: Tensor, n_kv: int) -> Tensor:
    """[B, S, Hq, hd] -> f32 [B, Kv, S*G, hd], scaled by hd^-1/2."""
    b, s, hq, hd = q.shape
    qg = _split_heads(q, n_kv).to(torch.float32) * (hd ** -0.5)
    return qg.permute(0, 2, 1, 3, 4).reshape(b, n_kv, s * (hq // n_kv), hd)


def _heads_out(out: Tensor, b: int, s: int, hq: int, dtype) -> Tensor:
    """[B, Kv, S*G, hd] -> [B, S, Hq, hd] in ``dtype``."""
    n_kv, hd = out.shape[1], out.shape[-1]
    out = out.reshape(b, n_kv, s, hq // n_kv, hd).permute(0, 2, 1, 3, 4)
    return out.reshape(b, s, hq, hd).to(dtype)


def _on_shards(fn, q: Tensor, k: Tensor, v: Tensor, rows=None, **kw
               ) -> Tensor:
    """``fn(q, k, v, **kw)`` on each rank's shard when an input is a
    DTensor (``local_map``): per mesh dim the batch stays split if q's is,
    else the heads if q's and the kv heads both are (query head h reads kv
    head h // G, so contiguous splits of both keep each group whole), else
    all three replicate. Every split is one that attention runs apart on,
    so no gradient is partial. ``rows``, a [B] tensor, goes to ``fn`` as
    its keyword ``rows``, split as the batch is."""
    if rows is not None:
        kw["rows"] = rows
    mesh, (q, k, v) = as_dtensors(q, k, v)
    if mesh is None:
        return fn(q, k, v, **kw)
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    pl = []
    for pq, pk, pv in zip(placements_of(q), placements_of(k),
                          placements_of(v)):
        if pq.is_shard(0):
            pl.append(Shard(0))
        elif pq.is_shard(2) and pk.is_shard(2) and pv.is_shard(2):
            pl.append(Shard(2))
        else:
            pl.append(Replicate())
    ins, in_pl = [q, k, v], [pl, pl, pl]
    if rows is not None:
        ins.append(DTensor.from_local(kw.pop("rows"), mesh,
                                      [Replicate()] * mesh.ndim,
                                      run_check=False))
        in_pl.append([p if p.is_shard(0) else Replicate() for p in pl])

    def local(a, b, c, *r):
        extra = {"rows": r[0]} if r else {}
        return fn(contiguous_grad(a), contiguous_grad(b), contiguous_grad(c),
                  **kw, **extra)
    return local_map(local, out_placements=pl, in_placements=tuple(in_pl),
                     device_mesh=mesh, redistribute_inputs=True)(*ins)


def chunked_attention(q: Tensor, k: Tensor, v: Tensor, *, causal: bool = True,
                      q_offset=0, kv_valid_len=None,
                      kv_chunk: int = 512) -> Tensor:
    """Online-softmax attention over KV chunks.

    q: [B, S, Hq, hd]; k, v: [B, T, Kv, hd]; query i sits at position
    ``q_offset + i``. ``kv_valid_len``: keys at positions >= it are masked.
    Returns [B, S, Hq, hd] in q's dtype. DTensor inputs run on each rank's
    shard (``_on_shards``).
    """
    return _on_shards(_chunked_attention, q, k, v, causal=causal,
                      q_offset=q_offset, kv_valid_len=kv_valid_len,
                      kv_chunk=kv_chunk)


def _chunked_attention(q: Tensor, k: Tensor, v: Tensor, *, causal: bool,
                       q_offset, kv_valid_len, kv_chunk: int) -> Tensor:
    b, s, hq, hd = q.shape
    t, n_kv = k.shape[1], k.shape[2]
    g = hq // n_kv
    kv_chunk = min(kv_chunk, t)
    nkc = -(-t // kv_chunk)
    dev = q.device
    qg = _grouped_queries(q, n_kv)                          # [B, Kv, S*G, hd]
    q_pos = q_offset + torch.arange(s, device=dev)
    m = torch.full((b, n_kv, s * g), NEG_INF, dtype=torch.float32,
                   device=dev)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, n_kv, s * g, hd), dtype=torch.float32, device=dev)
    for ci in range(nkc):
        lo = ci * kv_chunk
        kb, vb = k[:, lo:lo + kv_chunk], v[:, lo:lo + kv_chunk]
        if kb.shape[1] < kv_chunk:              # the zero-padded last chunk
            pad = kv_chunk - kb.shape[1]
            kb = torch.nn.functional.pad(kb, (0, 0, 0, 0, 0, pad))
            vb = torch.nn.functional.pad(vb, (0, 0, 0, 0, 0, pad))
        k_pos = lo + torch.arange(kv_chunk, device=dev)
        scores = qg @ kb.to(torch.float32).permute(0, 2, 3, 1)  # [B,Kv,SG,T]
        mask = (k_pos < t)[None, :]
        if causal:
            mask = mask & (q_pos[:, None] >= k_pos[None, :])
        if kv_valid_len is not None:
            mask = mask & (k_pos < kv_valid_len)[None, :]
        scores = scores.reshape(b, n_kv, s, g, kv_chunk).masked_fill_(
            ~mask.expand(s, kv_chunk)[None, None, :, None, :], NEG_INF
        ).reshape(b, n_kv, s * g, kv_chunk)
        m_new = torch.maximum(m, scores.amax(dim=-1))
        p = torch.exp(scores - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + p @ vb.to(torch.float32).transpose(1, 2)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return _heads_out(out, b, s, hq, q.dtype)


def windowed_attention(q: Tensor, k: Tensor, v: Tensor, *, window: int,
                       q_offset=0) -> Tensor:
    """Banded causal attention: position i attends to (i - window, i].

    S is padded to a multiple of ``window``; each query chunk attends to its
    own and the previous key chunk. ``q_offset`` is accepted for the
    reference's signature and, as there, not read. DTensor inputs run on
    each rank's shard (``_on_shards``).
    """
    del q_offset
    return _on_shards(_windowed_attention, q, k, v, window=window)


def _windowed_attention(q: Tensor, k: Tensor, v: Tensor, *, window: int
                        ) -> Tensor:
    b, s, hq, hd = q.shape
    n_kv = k.shape[2]
    g, w = hq // n_kv, window
    pad = (-s) % w
    if pad:
        q, k, v = (torch.nn.functional.pad(a, (0, 0, 0, 0, 0, pad))
                   for a in (q, k, v))
    sp = s + pad
    nc = sp // w
    dev = q.device
    # [B, Kv, nc, w*G, hd]
    qg = _grouped_queries(q, n_kv).reshape(b, n_kv, nc, w * g, hd)

    def chunks(x):                        # [B, Sp, Kv, hd] -> [B,Kv,nc,2w,hd]
        xc = x.to(torch.float32).permute(0, 2, 1, 3).reshape(b, n_kv, nc, w,
                                                            hd)
        prev = torch.nn.functional.pad(xc, (0, 0, 0, 0, 1, 0))[:, :, :-1]
        return torch.cat([prev, xc], dim=3)

    kc, vc = chunks(k), chunks(v)
    scores = qg @ kc.transpose(-1, -2)                   # [B, Kv, nc, wG, 2w]
    q_idx = torch.arange(w, device=dev)[:, None]         # within the chunk
    t_idx = torch.arange(2 * w, device=dev)[None, :] - w  # from chunk start
    rel = q_idx - t_idx                                  # q_pos - k_pos
    mask = (rel >= 0) & (rel < w)                        # causal, banded
    c_idx = torch.arange(nc, device=dev)
    valid_abs = (c_idx[:, None, None] * w + t_idx[None]) >= 0
    full_mask = mask[None] & valid_abs                   # [nc, w, 2w]
    scores = scores.reshape(b, n_kv, nc, w, g, 2 * w).masked_fill_(
        ~full_mask[None, None, :, :, None, :], NEG_INF
    ).reshape(b, n_kv, nc, w * g, 2 * w)
    p = torch.softmax(scores, dim=-1)
    out = (p @ vc).reshape(b, n_kv, sp * g, hd)
    return _heads_out(out, b, sp, hq, q.dtype)[:, :s]


def decode_attention(q: Tensor, k_cache: Tensor, v_cache: Tensor,
                     cache_index, *, rolling: bool = False) -> Tensor:
    """One-token decode. q: [B, 1, Hq, hd]; caches: [B, T, Kv, hd].

    ``cache_index`` = the number of valid tokens in the cache INCLUDING the
    current one: a scalar, or a [B] vector (each row at its own count). For
    a rolling (windowed) cache every slot < min(index, T) is valid; softmax
    does not depend on the slots' order. DTensor inputs run on each rank's
    shard (``_on_shards``).
    """
    if isinstance(cache_index, Tensor) and cache_index.ndim:
        return _on_shards(_decode_attention, q, k_cache, v_cache,
                          rows=cache_index, rolling=rolling)
    return _on_shards(_decode_attention, q, k_cache, v_cache,
                      cache_index=cache_index, rolling=rolling)


def _decode_attention(q: Tensor, k_cache: Tensor, v_cache: Tensor,
                      cache_index=None, *, rolling: bool,
                      rows=None) -> Tensor:
    if rows is not None:
        cache_index = rows
    b, _, hq, hd = q.shape
    t, n_kv = k_cache.shape[1], k_cache.shape[2]
    dev = q.device
    qg = _grouped_queries(q, n_kv)                        # [B, Kv, G, hd]
    scores = qg @ k_cache.to(torch.float32).permute(0, 2, 3, 1)
    pos = torch.arange(t, device=dev)
    if isinstance(cache_index, int):    # no host-to-device copy
        mask = (pos < (min(cache_index, t) if rolling else cache_index)
                ).expand(b, t)
    else:
        limit = torch.as_tensor(cache_index, device=dev)
        if rolling:
            limit = torch.clamp(limit, max=t)
        limit = limit.expand(b) if limit.ndim == 0 else limit
        mask = pos[None, :] < limit[:, None]                       # [B, T]
    scores = scores.masked_fill_(~mask[:, None, None, :], NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = p @ v_cache.to(torch.float32).transpose(1, 2)   # [B, Kv, G, hd]
    return _heads_out(out, b, 1, hq, q.dtype)


def cache_update(k_cache: Tensor, v_cache: Tensor, k_new: Tensor,
                 v_new: Tensor, index, *, rolling: bool = False
                 ) -> Tuple[Tensor, Tensor]:
    """Caches with one token's K/V written at ``index`` (mod T for a rolling
    cache); the given caches are left as they were.

    ``index`` is a scalar (the whole batch at one position) or a [B] vector
    (a position per row). As ``dynamic_update_slice`` does in the
    reference, a slot past the end is clamped to the last one (T - 1).
    """
    t = k_cache.shape[1]
    if isinstance(index, int):          # no host-to-device copy
        slot = min(max(index % t if rolling else index, 0), t - 1)
    else:
        index = torch.as_tensor(index, device=k_cache.device)
        slot = torch.remainder(index, t) if rolling else index
        slot = torch.clamp(slot, 0, t - 1)
    k_out, v_out = k_cache.clone(), v_cache.clone()
    if isinstance(slot, torch.Tensor) and slot.ndim:   # a position per row
        rows = torch.arange(k_cache.shape[0], device=k_cache.device)
        k_out[rows, slot] = k_new[:, 0].to(k_cache.dtype)
        v_out[rows, slot] = v_new[:, 0].to(v_cache.dtype)
    else:
        k_out[:, slot] = k_new[:, 0].to(k_cache.dtype)
        v_out[:, slot] = v_new[:, 0].to(v_cache.dtype)
    return k_out, v_out


def paged_gather(pool: Tensor, pages: Tensor) -> Tensor:
    """Per-slot K or V rows from a page pool.

    pool: [n_pages, ps, Kv, hd] (one layer's pages, shared by all slots);
    pages: [B, P] page tables (long) — entry j is the physical page holding
    logical tokens [j*ps, (j+1)*ps). Returns [B, P*ps, Kv, hd] in logical
    position order, so it drops into ``decode_attention`` and
    ``chunked_attention`` like a cache row (garbage-page entries lie past
    the valid length, where they are masked)."""
    if is_dtensor(pool):
        from torch.distributed.tensor.experimental import local_map
        pl = list(placements_of(pool))   # the page axes are whole
        return local_map(_paged_gather, out_placements=pl,
                         in_placements=(pl, None),
                         device_mesh=pool.device_mesh)(pool, pages)
    return _paged_gather(pool, pages)


def _paged_gather(pool: Tensor, pages: Tensor) -> Tensor:
    b, p = pages.shape
    _, ps, n_kv, hd = pool.shape
    return pool[pages].reshape(b, p * ps, n_kv, hd)


def paged_cache_update(k_pool: Tensor, v_pool: Tensor, k_new: Tensor,
                       v_new: Tensor, pages: Tensor, index: Tensor) -> None:
    """Write one decode token's K/V per slot through the page tables, in
    place. k_new/v_new: [B, 1, Kv, hd]; pages: [B, P]; index: [B], the
    0-based position of the incoming token. Slot b writes page
    ``pages[b, index[b] // ps]`` at offset ``index[b] % ps``. Live slots
    write distinct pages (the engine gives each its own write pages);
    inactive slots all write the garbage page, where which of the colliding
    writes lands does not matter: it is never read."""
    ps = k_pool.shape[1]
    phys = torch.gather(pages, 1, (index // ps)[:, None])[:, 0]
    within = index % ps
    setitem_(k_pool, (phys, within), k_new[:, 0])
    setitem_(v_pool, (phys, within), v_new[:, 0])


def paged_prefill_update(k_pool: Tensor, v_pool: Tensor, k_new: Tensor,
                         v_new: Tensor, pages_row: Tensor, start: int
                         ) -> None:
    """Write one prefill chunk's K/V into a single slot's pages, in place.

    k_new/v_new: [1, L, Kv, hd], the chunk at logical positions [start,
    start + L), ``start`` page-aligned; pages_row: [P], the slot's page
    table. The chunk is zero-padded to whole pages (the tail of a partial
    last page is masked garbage) and written to ``pages_row[start // ps :
    start // ps + ceil(L / ps)]``: pages the slot allocated itself, never
    a shared prefix page."""
    ps = k_pool.shape[1]
    n_cp = -(-k_new.shape[1] // ps)
    dst = pages_row[start // ps:start // ps + n_cp]
    write_pages_(k_pool, (), dst, k_new[0])
    write_pages_(v_pool, (), dst, v_new[0])


def write_pages_(pool: Tensor, lead: tuple, pages: Tensor, rows: Tensor
                 ) -> None:
    """Write ``rows`` [..., L, Kv, hd] into the pages ``pages`` [ceil(L /
    ps)] of ``pool`` [..., n_pages, ps, Kv, hd] (``lead``: the selectors of
    its leading dims), in place, the last page's tail zeroed: what padding
    the rows to whole pages and writing them would give, without padding a
    DTensor (a plain pool is padded and written at once)."""
    ps = pool.shape[len(lead) + 1]
    if not is_dtensor(pool):
        n_cp = pages.shape[0]
        pad = n_cp * ps - rows.shape[-3]
        if pad:
            rows = torch.nn.functional.pad(rows, (0, 0, 0, 0, 0, pad))
        pool[lead + (pages,)] = rows.reshape(
            rows.shape[:-3] + (n_cp, ps) + rows.shape[-2:]).to(pool.dtype)
        return
    n_full, rem = divmod(rows.shape[-3], ps)
    if n_full:
        setitem_(pool, lead + (pages[:n_full],), rows[
            ..., :n_full * ps, :, :].reshape(rows.shape[:-3] + (n_full, ps)
                                              + rows.shape[-2:]))
    if rem:
        last = pages[n_full:n_full + 1]
        setitem_(pool, lead + (last, slice(0, rem)),
                 rows[..., n_full * ps:, :, :].unsqueeze(-4))
        setitem_(pool, lead + (last, slice(rem, ps)), torch.zeros(
            rows.shape[:-3] + (1, ps - rem) + rows.shape[-2:],
            dtype=pool.dtype, device=pool.device))
