"""Continuous-batching serving engine (port of ``repro.serve.engine``): a
fixed pool of decode slots fed by an admission queue, so requests join and
leave a *running* batch instead of waiting for the slowest sequence of a
static batch.

Design (the reference's, on one device)
------
* **Paged KV pool**: full-attention K/V lives in a shared page pool
  (``decode.init_paged_cache``), ``n_pages`` pages of ``page_size``
  tokens addressed through per-slot page tables; the host bookkeeping
  (free list, refcounts, prefix hashes) is ``serve.paging.PagedAllocator``.
  Admission reserves a request's worst-case page demand
  (``ceil((prompt + max_new - 1) / page_size)``) and decode pages are
  allocated as a sequence crosses page boundaries, so admitted requests
  never deadlock on pages. Page 0 is the garbage page: inactive slots'
  tables point at it, so the fused tick's dummy writes touch no live page.
* **Prefix reuse**: for pure-attention stacks (``decode.prefix_sharing_ok``)
  a finished prompt registers each full page's cumulative hash; a later
  prompt that matches page for page shares the physical pages (refcount >
  1) and skips computing them. Shared pages are never written; a
  copy-on-write ``fork`` guards the case anyway.
* **Chunked prefill**: chunk-exact families (``decode.chunk_tokens_for``:
  pure attention, attention + SSD) consume a prompt one page-aligned chunk
  per tick, interleaved with the fused decode, so a long prompt does not
  block running requests. Other families (RG-LRU, SWA/local windows, MoE,
  encoder-decoder, frontends) prefill whole, into the paged pool, in one
  tick. An encoder-decoder's requests bring their encoder input
  (``Request.frames``, ``enc_len`` rows each); its cross-attention K/V
  stays in per-slot rows.
* **Fused multi-slot decode**: every tick runs ONE ``decode_step`` over all
  N slots with per-slot index and page-table vectors. Inactive and
  prefilling slots flow through with index 0 and all-garbage tables.
* **Eviction** on EOS or when ``max_new`` is spent: pages are released
  (shared ones drop a reference), reservations returned, and the next
  queued request is admitted on the same tick.
* **KAN deploy-once**: KAN-FFN models serve frozen ``kan.DeployedKAN``
  artifacts built at construction (``transformer.deploy_kan``), never
  inside a tick.

Where the reference donates the cache to each jitted call, the port writes
the pools and the per-slot rows in place (``decode``'s paged functions),
and where it compiles one executable per prompt length, the port has
nothing to compile: with a recorder, ``obs.profile.JitProfiler`` records
each callable's first call per shape key under the reference's names. A
tick synchronises once, when it brings the argmaxes of the fused decode to
the host in one copy; a non-final prefill chunk does not synchronise.

Per-request outputs do not depend on co-resident slots for every family
the port serves (tests/test_torch_engine.py holds them to solo runs and to
the JAX engine). Decoding is greedy (argmax).
"""
from __future__ import annotations

import functools
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import kan
from repro_torch.dist import sharding as shlib
from repro_torch.dist.sharding import setitem_
from repro_torch.models import attention as attn_lib
from repro_torch.models import transformer as tfm
from repro_torch.models.transformer import ModelConfig
from repro_torch.obs.recorder import NullRecorder
from repro_torch.serve import decode as dec
from repro_torch.serve.paging import GARBAGE_PAGE, PagedAllocator, page_hashes
from repro_torch.serve.scheduler import (AdmissionQueue, Completion,
                                         EngineStats, Request)

# The device calls are module-level functions parameterised by
# functools.partial on the config, never bound to the Engine.

def _decode_fn(params, cache, tokens, index, pages, *, cfg):
    """Fused tick: [N, 1] last tokens, [N] indices and [N, P] page tables ->
    the next tokens [N] (long). Writes the cache in place."""
    logits, cache = dec.decode_step(params, cache, tokens, index, cfg,
                                    pages=pages)
    return dec.greedy(logits), cache


def _prefill_fn(params, batch, *, cfg, max_len):
    logits, cache = dec.prefill(params, cfg, batch, max_len=max_len,
                                last_only=True)
    return dec.greedy(logits), cache


def _chunk_fn(params, cache, tokens, start, slot, pages_row, *, cfg, first,
              last):
    """One chunked-prefill step (``decode.prefill_chunk``)."""
    return dec.prefill_chunk(params, cfg, cache, tokens, start, slot,
                             pages_row, first=first, last=last)


def _scatter_fn(pool, solo, slot, pages_row, *, stages, page_size):
    """Write a whole-prompt solo prefill cache into the engine's cache, in
    place: full-attention K/V [.., 1, max_len, Kv, hd] through the slot's
    page table (padded to whole pages; entries still at the garbage page,
    past the prompt, overwrite garbage), every per-slot leaf into row
    ``slot``."""
    for pool_blk, solo_blk, stage in zip(pool, solo, stages):
        lead = (slice(None),) if stage.repeats > 1 else ()
        for i, sp in enumerate(stage.block):
            pc, sc = pool_blk[f"l{i}"], solo_blk[f"l{i}"]
            for key, pl in pc.items():
                row = sc[key][lead + (0,)]
                if sp.mixer == "attn" and key in ("k", "v"):
                    # row: [.., T, Kv, hd], T = max_len: the table's
                    # ceil(T / page_size) pages
                    attn_lib.write_pages_(pl, lead, pages_row, row)
                else:
                    setitem_(pl, lead + (slot,), row)
    return pool


def _copy_page_fn(cache, src: int, dst: int, *, stages):
    """Copy page ``src`` to ``dst`` in every full-attention pool (the
    device half of copy-on-write ``fork``), in place."""
    for blk, stage in zip(cache, stages):
        lead = (slice(None),) if stage.repeats > 1 else ()
        for i, sp in enumerate(stage.block):
            if sp.mixer == "attn":
                for key in ("k", "v"):
                    leaf = blk[f"l{i}"][key]
                    setitem_(leaf, lead + (dst,), leaf[lead + (src,)])
    return cache


def _chunk_name(key: Tuple[int, bool, bool]) -> str:
    """Profiler name of a chunked-prefill call, as the reference names its
    jits: a first-and-last chunk IS a whole prompt (``prefill_len{n}``);
    other chunks by length and position."""
    length, first, last = key
    if first and last:
        return f"prefill_len{length}"
    name = f"prefill_chunk{length}"
    if first:
        name += "_first"
    if last:
        name += "_last"
    return name


class Engine:
    """Continuous-batching engine over a paged KV pool.

    Parameters
    ----------
    params, cfg : model weights + ModelConfig (a family the port serves).
    n_slots     : decode-slot pool size (the fused tick's batch dimension).
    max_len     : per-slot sequence capacity; a request needs
                  ``len(prompt) + max_new - 1 <= max_len``.
    page_size   : tokens per KV page; default ``min(64, max_len)``.
    n_pages     : page-pool capacity (page 0 is the garbage page); default
                  ``n_slots * ceil(max_len / page_size) + 1``, every slot's
                  worst case. Set it lower to oversubscribe memory and let
                  admission block on pages.
    queue       : optional AdmissionQueue (bounded => backpressure).
    eos_id      : engine-wide EOS (``Request.eos_id`` overrides).
    enc_len     : encoder-decoder only: the encoder length every request's
                  ``frames`` must have.
    device      : where the params (moved there) and the cache live;
                  ``None`` is the card, ``"cpu"`` the CPU.
    recorder    : optional ``repro_torch.obs.EngineRecorder``; the default
                  ``NullRecorder`` adds no timing calls to the tick.
    """

    def __init__(self, params, cfg: ModelConfig, *, n_slots: int,
                 max_len: int, page_size: Optional[int] = None,
                 n_pages: Optional[int] = None,
                 queue: Optional[AdmissionQueue] = None,
                 eos_id: Optional[int] = None, enc_len: int = 0,
                 device=None, recorder=None):
        self.mesh = shlib.current_mesh()
        if self.mesh is not None:
            if device is not None:
                raise ValueError("Engine: device placement and an active "
                                 "sharding mesh are mutually exclusive — "
                                 "a replica is either pinned whole to one "
                                 "device or sharded across the mesh")
            self.device = _rank_device(self.mesh)
        else:
            self.device = resolve_device(device)
        params = tfm.tree_map(
            lambda t: t.to(self.device) if isinstance(t, torch.Tensor)
            and not shlib.is_dtensor(t) else t, params)
        # deploy() runs exactly once, here: no tick quantises coefficients
        # or builds a LUT
        self.params = tfm.deploy_kan(params, cfg)
        if self.mesh is not None:
            # the reference serves unplaced (replicated) params under a
            # mesh; a KAN artifact stays whole and plain on every rank,
            # where kan.apply runs it on the rank's rows
            self.params = shlib.replicate_tree(self.params, self.mesh)
        self.kan_deployed = kan.contains_deployed(self.params)
        self.cfg = cfg
        self.n_slots = n_slots
        self.max_len = max_len
        self.enc_len = enc_len
        self.queue = queue if queue is not None else AdmissionQueue()
        self.eos_id = eos_id
        self.stages = tfm.stages_for(cfg)

        if page_size is None:
            page_size = min(64, max_len)
        if not 1 <= page_size <= max_len:
            raise ValueError(f"page_size must be in [1, max_len], got "
                             f"{page_size} (max_len={max_len})")
        self.page_size = page_size
        self.n_slot_pages = -(-max_len // page_size)      # table width P
        if n_pages is None:
            n_pages = n_slots * self.n_slot_pages + 1
        self.n_pages = n_pages
        self.alloc = PagedAllocator(n_pages, page_size)
        #: chunked-prefill unit (tokens/tick), or None => whole-prompt path
        self.chunk_tokens = dec.chunk_tokens_for(cfg, page_size)
        #: hash-matched prompt prefixes may share physical pages
        self.share_ok = dec.prefix_sharing_ok(cfg)
        self.cache = dec.init_paged_cache(cfg, n_slots, max_len,
                                          page_size=page_size,
                                          n_pages=n_pages, device=self.device,
                                          enc_len=enc_len)
        if self.mesh is not None:
            self.cache = shlib.distribute_tree(self.cache, self.mesh,
                                               dec.paged_cache_spec(cfg))

        # host-side per-slot state
        self.active = np.zeros(n_slots, dtype=bool)       # decoding
        self.prefilling = np.zeros(n_slots, dtype=bool)   # consuming prompt
        self.index = np.zeros(n_slots, dtype=np.int64)    # tokens in cache
        self.last_tok = np.zeros(n_slots, dtype=np.int64)
        self.remaining = np.zeros(n_slots, dtype=np.int64)
        self.slot_req: List[Optional[Request]] = [None] * n_slots
        self.slot_tokens: List[List[int]] = [[] for _ in range(n_slots)]
        self.slot_admitted = np.zeros(n_slots, dtype=np.int64)
        # paging state: page table rows, unspent reservations, prefill
        # cursor, held prompt + its page digests (prefix registration)
        self.slot_pages = np.full((n_slots, self.n_slot_pages),
                                  GARBAGE_PAGE, dtype=np.int64)
        self.slot_reserved = np.zeros(n_slots, dtype=np.int64)
        self.slot_pos = np.zeros(n_slots, dtype=np.int64)
        self.slot_prompt: List[Optional[np.ndarray]] = [None] * n_slots
        self.slot_hashes: List[List[bytes]] = [[] for _ in range(n_slots)]

        self.tick_no = 0
        self.stats = EngineStats(n_slots=n_slots, page_size=page_size,
                                 n_pages=n_pages)
        self.obs = recorder if recorder is not None else NullRecorder()
        self._profilers: Dict[tuple, object] = {}
        self._decode = self._profiled(
            ("decode",), "decode_tick", functools.partial(_decode_fn, cfg=cfg))
        self._scatter = self._profiled(
            ("scatter",), "cache_write", functools.partial(
                _scatter_fn, stages=tuple(self.stages), page_size=page_size))
        self._copy = functools.partial(_copy_page_fn,
                                       stages=tuple(self.stages))

    def _profiled(self, key: tuple, name: str, fn):
        """``fn`` itself without a recording recorder; with one, the one
        ``JitProfiler`` kept for ``key`` (its first call per shape key is
        the reference's compile event)."""
        if not self.obs.enabled:
            return fn
        if key not in self._profilers:
            from repro_torch.obs import profile as obs_profile
            self._profilers[key] = obs_profile.JitProfiler(fn, name, self.obs)
        return self._profilers[key]

    def _prefill_for(self, prompt_len: int, enc_len: int):
        name = f"prefill_len{prompt_len}"
        if enc_len:
            name += f"_enc{enc_len}"
        return self._profiled(
            ("prefill", prompt_len, enc_len), name,
            functools.partial(_prefill_fn, cfg=self.cfg,
                              max_len=self.max_len))

    def _chunk_for(self, length: int, first: bool, last: bool):
        key = (length, first, last)
        return self._profiled(
            ("chunk",) + key, _chunk_name(key),
            functools.partial(_chunk_fn, cfg=self.cfg, first=first,
                              last=last))

    # -- admission / eviction ----------------------------------------------

    def _worst_case_pages(self, prompt_len: int, max_new: int) -> int:
        """Pages needed if the request runs to its full budget (the cache
        holds ``prompt + max_new - 1`` tokens at most)."""
        return -(-(prompt_len + max_new - 1) // self.page_size)

    def validate_request(self, req: Request) -> None:
        """Raise ValueError for a request this engine's geometry can never
        serve: non-positive budget, over-length against the slot cache,
        worst-case page demand beyond the pool, or an encoder-decoder's
        frames mismatch."""
        s = int(np.asarray(req.tokens).shape[-1])
        if req.max_new < 1:
            raise ValueError(f"request {req.rid!r}: max_new must be >= 1")
        if s + req.max_new - 1 > self.max_len:
            raise ValueError(
                f"request {req.rid!r}: prompt {s} + max_new {req.max_new} - 1 "
                f"exceeds slot capacity max_len={self.max_len}")
        if self._worst_case_pages(s, req.max_new) > self.n_pages - 1:
            raise ValueError(
                f"request {req.rid!r}: worst case needs "
                f"{self._worst_case_pages(s, req.max_new)} pages but the "
                f"pool only has {self.n_pages - 1} allocatable pages")
        if req.frames is not None:
            f = int(np.shape(req.frames)[-2])
            if f != self.enc_len:
                # a shorter write would fill only f of the enc_len rows,
                # and cross attention reads them all: zero (or a previous
                # occupant's) encoder K/V would enter the softmax
                raise ValueError(
                    f"request {req.rid!r}: frames length {f} != engine "
                    f"enc_len {self.enc_len}")
        elif self.enc_len:
            raise ValueError(f"request {req.rid!r}: engine was built with "
                             f"enc_len={self.enc_len} but request has no "
                             "frames")

    def submit(self, req: Request) -> bool:
        """Queue a request. False = backpressure (bounded queue full).
        Raises ValueError for requests that can never fit."""
        self.validate_request(req)
        ok = self.queue.submit(req)
        if ok:
            self.obs.on_submit(req, self.tick_no)
        else:
            self.stats.rejected += 1
            self.obs.on_reject(req)
        return ok

    def _eos_for(self, req: Request) -> Optional[int]:
        return req.eos_id if req.eos_id is not None else self.eos_id

    def _try_admit_pages(self, req: Request):
        """Transactional page admission: claim shared prefix pages, then
        reserve the rest of the worst case. Returns (matched page ids,
        reservation, page digests), or None with every claim rolled back
        when the pool cannot cover it."""
        prompt = np.asarray(req.tokens).ravel()
        s = int(prompt.shape[-1])
        worst = self._worst_case_pages(s, req.max_new)
        digests: List[bytes] = []
        matched: List[int] = []
        if self.share_ok:
            digests = page_hashes(prompt, self.page_size)
            # the page holding the last prompt token is never matched: its
            # logits must be computed for the first output token
            matched = self.alloc.match_prefix(
                digests[:(s - 1) // self.page_size])
        need = worst - len(matched)
        if not self.alloc.reserve(need):
            for pid in matched:
                self.alloc.release(pid)
            return None
        return matched, need, digests

    def _admit(self, slot: int, req: Request, matched: List[int],
               reserved: int, digests: List[bytes]) -> None:
        """Bind a request to a slot: install matched prefix pages, allocate
        the pages its prompt will write, mark the slot prefilling. No device
        work: the prefill phase consumes the prompt."""
        self.obs.on_admit(req, slot, self.tick_no)
        prompt = np.asarray(np.asarray(req.tokens).ravel(), dtype=np.int64)
        s = int(prompt.shape[-1])
        n_prompt_pages = -(-s // self.page_size)
        self.slot_pages[slot, :len(matched)] = matched
        for i in range(len(matched), n_prompt_pages):
            self.slot_pages[slot, i] = self.alloc.alloc(reserved=True)
            reserved -= 1
        self.slot_reserved[slot] = reserved
        self.slot_pos[slot] = len(matched) * self.page_size
        self.slot_prompt[slot] = prompt
        self.slot_hashes[slot] = digests
        self.prefilling[slot] = True
        self.active[slot] = False
        self.slot_req[slot] = req
        self.slot_tokens[slot] = []
        self.slot_admitted[slot] = self.tick_no
        self.stats.slot_served[slot] += 1
        if self.share_ok:
            eligible = (s - 1) // self.page_size
            self.stats.prefix_hit_pages += len(matched)
            self.stats.prefix_eligible_pages += eligible
            self.obs.on_prefix(len(matched), eligible)

    def _prefill_tick(self, slot: int) -> List[Completion]:
        """Advance one prefilling slot: the whole prompt for single-piece
        families (solo prefill, then scattered through the page table), one
        ``chunk_tokens`` chunk otherwise. Returns completions when the
        prompt's first token already meets a stop rule."""
        prompt = self.slot_prompt[slot]
        s = int(prompt.shape[-1])
        pages_row = torch.from_numpy(self.slot_pages[slot]).to(self.device)
        if self.chunk_tokens is None:
            toks = torch.from_numpy(prompt).to(self.device)[None]
            batch = {"tokens": toks}
            frames = self.slot_req[slot].frames
            enc_len = 0
            if frames is not None:
                batch["frames"] = torch.as_tensor(frames,
                                                  device=self.device)[None]
                enc_len = batch["frames"].shape[1]
            tok0, solo = self._prefill_for(s, enc_len)(self.params, batch)
            self.cache = self._scatter(self.cache, solo, slot, pages_row)
            return self._finish_prefill(slot, int(tok0[0]))
        pos = int(self.slot_pos[slot])
        length = min(self.chunk_tokens, s - pos)
        first = pos == 0
        last = pos + length == s
        chunk = torch.from_numpy(prompt[pos:pos + length]).to(self.device)
        tok, self.cache = self._chunk_for(length, first, last)(
            self.params, self.cache, chunk[None], pos, slot, pages_row)
        self.slot_pos[slot] = pos + length
        self.stats.prefill_chunks += 1
        if last:
            return self._finish_prefill(slot, int(tok[0]))
        return []

    def _finish_prefill(self, slot: int, tok0: int) -> List[Completion]:
        """Prompt consumed: publish page hashes for prefix reuse, record
        TTFT, and flip the slot to decoding (it joins this tick's decode)."""
        req = self.slot_req[slot]
        s = int(self.slot_prompt[slot].shape[-1])
        if self.share_ok:
            # every full prompt page is written and immutable until
            # eviction (first writer wins for pages that were matched)
            for i, d in enumerate(self.slot_hashes[slot]):
                self.alloc.register_hash(int(self.slot_pages[slot, i]), d)
        ttft = self.obs.on_first_token(req, self.tick_no)
        if ttft is not None:
            self.stats.ttft_s.append(ttft)
        self.prefilling[slot] = False
        self.active[slot] = True
        self.index[slot] = s
        self.last_tok[slot] = tok0
        self.remaining[slot] = req.max_new - 1
        self.slot_tokens[slot] = [tok0]
        self.stats.prefills += 1
        eos = self._eos_for(req)
        if eos is not None and tok0 == eos:
            return [self._evict(slot, "eos")]
        if self.remaining[slot] <= 0:
            return [self._evict(slot, "length")]
        return []

    def try_admit(self, req: Request) -> bool:
        """Transactional slot + page admission that bypasses the local
        queue: True binds ``req`` to a free slot (prefill starts next
        ``step``), False changes nothing."""
        free = np.flatnonzero(~self.active & ~self.prefilling)
        if not len(free):
            return False
        adm = self._try_admit_pages(req)
        if adm is None:
            return False
        self._admit(int(free[0]), req, *adm)
        return True

    def _release_slot(self, slot: int) -> None:
        """Free a slot's pages (shared pages drop one reference), return
        unspent reservations, and clear the slot's host state."""
        for pg in range(self.n_slot_pages):
            pid = int(self.slot_pages[slot, pg])
            if pid != GARBAGE_PAGE:
                self.alloc.release(pid)
        self.slot_pages[slot, :] = GARBAGE_PAGE
        self.alloc.unreserve(int(self.slot_reserved[slot]))
        self.slot_reserved[slot] = 0
        self.active[slot] = False
        self.prefilling[slot] = False
        self.slot_req[slot] = None
        self.slot_tokens[slot] = []
        self.slot_prompt[slot] = None
        self.slot_hashes[slot] = []

    def _evict(self, slot: int, reason: str) -> Completion:
        req = self.slot_req[slot]
        comp = Completion(
            rid=req.rid, tokens=np.asarray(self.slot_tokens[slot]),
            reason=reason, slot=slot,
            admitted_tick=int(self.slot_admitted[slot]),
            finished_tick=self.tick_no)
        self._release_slot(slot)
        self.stats.completed += 1
        if reason == "eos":
            self.stats.evicted_eos += 1
        else:
            self.stats.evicted_length += 1
        self.obs.on_evict(comp)
        return comp

    def preempt(self, slot: int) -> Request:
        """Evict the request bound to ``slot`` and hand it back for
        requeueing; its progress is discarded (greedy decoding reruns to
        the same tokens)."""
        req = self.slot_req[slot]
        if req is None:
            raise ValueError(f"preempt: slot {slot} is idle")
        self._release_slot(slot)
        self.stats.preempted += 1
        self.obs.on_preempt(req, slot)
        return req

    def drain_queued(self) -> List[Request]:
        """Remove and return every request still in the local admission
        queue (pop order)."""
        return self.queue.drain()

    # -- the tick -----------------------------------------------------------

    def _ensure_decode_pages(self) -> None:
        """Give every active slot a writable page for this tick's token:
        allocate it (from the slot's reservation) when the table still
        points at the garbage page, and copy-on-write fork a shared one
        (unreachable by construction: decode writes only past the
        registered prompt pages)."""
        for slot in np.flatnonzero(self.active):
            slot = int(slot)
            pg = int(self.index[slot]) // self.page_size
            pid = int(self.slot_pages[slot, pg])
            if pid == GARBAGE_PAGE:
                self.slot_pages[slot, pg] = self.alloc.alloc(reserved=True)
                self.slot_reserved[slot] -= 1
            elif self.alloc.refcount[pid] > 1:
                new = self.alloc.fork(pid)
                self.cache = self._copy(self.cache, pid, new)
                self.slot_pages[slot, pg] = new

    def step(self) -> List[Completion]:
        """One engine tick: admit whatever fits (slots AND pages), advance
        every prefilling slot by one chunk, then one fused decode over all
        slots. Returns the requests completed during this tick. The tick
        runs under the engine's own mesh (or none), whatever mesh the
        caller has entered."""
        with shlib.use_mesh(self.mesh):
            return self._step()

    def _step(self) -> List[Completion]:
        done: List[Completion] = []
        obs = self.obs
        with obs.phase("admit"):
            while True:
                free = np.flatnonzero(~self.active & ~self.prefilling)
                if not len(free):
                    break
                req = self.queue.peek(self.tick_no)
                if req is None:
                    break
                adm = self._try_admit_pages(req)
                if adm is None:
                    break               # page pool full: head of queue waits
                self.queue.pop(self.tick_no)
                self._admit(int(free[0]), req, *adm)

        if self.prefilling.any():
            with obs.phase("prefill"):
                for slot in np.flatnonzero(self.prefilling):
                    done += self._prefill_tick(int(slot))

        if self.active.any():
            self._ensure_decode_pages()
            # inactive/prefilling slots flow through the fused step with
            # index 0 and an all-garbage page table; one host-to-device
            # copy carries tokens, indices and tables
            act = self.active
            packed = np.concatenate(
                [np.where(act, self.last_tok, 0)[:, None],
                 np.where(act, self.index, 0)[:, None],
                 np.where(act[:, None], self.slot_pages, GARBAGE_PAGE)],
                axis=1)
            feed = torch.from_numpy(packed).to(self.device)
            with obs.phase("decode") as ph:
                nxt, self.cache = self._decode(self.params, self.cache,
                                               feed[:, :1], feed[:, 1],
                                               feed[:, 2:])
                nxt = nxt.cpu().numpy()    # the tick's one synchronisation
            n_active = int(self.active.sum())
            if obs.enabled:
                # each active slot's token saw the tick's wall time as TPOT
                obs.on_decode_tick(n_active, ph.dur_s)
                self.stats.tpot_s.extend([ph.dur_s] * n_active)
            self.stats.occupancy_ticks += n_active
            self.stats.decode_tokens += n_active
            with obs.phase("host"):
                for slot in np.flatnonzero(self.active):
                    slot = int(slot)
                    tok = int(nxt[slot])
                    self.slot_tokens[slot].append(tok)
                    self.index[slot] += 1
                    self.last_tok[slot] = tok
                    self.remaining[slot] -= 1
                    eos = self._eos_for(self.slot_req[slot])
                    if eos is not None and tok == eos:
                        done.append(self._evict(slot, "eos"))
                    elif self.remaining[slot] <= 0:
                        done.append(self._evict(slot, "length"))
        elif not self.prefilling.any():
            self.stats.idle_ticks += 1
        self.stats.pages_in_use_peak = self.alloc.in_use_peak
        obs.on_page_pool(self.alloc.in_use, self.n_pages)
        self.tick_no += 1
        self.stats.ticks += 1
        return done

    def adopt_compiled(self, other: "Engine") -> "Engine":
        """Take over another engine's per-shape-key profiler state, for
        replicas and probe engines of identical geometry (cfg, n_slots,
        max_len, page_size, n_pages), as the reference shares its compiled
        executables. The port compiles nothing; what carries over is the
        record of the shapes already run, so this engine logs no first-call
        event for them. With a recording recorder the adopted profilers are
        re-bound to this engine's (sharing the other's record) and its own
        are kept for the shapes the other never profiled; without one there
        is nothing to adopt: the port's callables are the same functions
        either way."""
        mine = (self.cfg, self.n_slots, self.max_len, self.page_size,
                self.n_pages)
        theirs = (other.cfg, other.n_slots, other.max_len, other.page_size,
                  other.n_pages)
        if mine != theirs:
            raise ValueError("adopt_compiled: engines differ in "
                             "cfg/n_slots/max_len/page_size/n_pages")
        if self.obs.enabled:
            from repro_torch.obs import profile as obs_profile
            self._profilers.update({
                key: obs_profile.JitProfiler(prof, prof.name, self.obs)
                for key, prof in other._profilers.items()})
            self._decode = self._profilers[("decode",)]
            self._scatter = self._profilers[("scatter",)]
        return self

    def run(self, requests: Sequence[Request] = (),
            max_ticks: int = 1_000_000) -> List[Completion]:
        """Submit ``requests`` then tick until the queue drains and every
        slot is free. Idle stretches are fast-forwarded: when every slot is
        free and the queue holds only future arrivals, ``tick_no`` jumps to
        the next arrival (the skipped ticks count in ``idle_ticks`` and
        ``ff_ticks``). With a bounded queue, requests it refuses are held
        back and resubmitted as it drains."""
        pending = list(requests)
        t0 = time.perf_counter()
        out: List[Completion] = []
        while (pending or self.active.any() or self.prefilling.any()
               or len(self.queue)):
            while pending and (self.queue.max_pending is None
                               or len(self.queue) < self.queue.max_pending):
                self.submit(pending.pop(0))
            if (not self.active.any() and not self.prefilling.any()
                    and len(self.queue)):
                nxt = self.queue.next_arrival()
                if nxt is not None and nxt > self.tick_no:
                    skip = nxt - self.tick_no
                    self.tick_no = nxt
                    self.stats.ticks += skip
                    self.stats.idle_ticks += skip
                    self.stats.ff_ticks += skip
            if self.stats.ticks >= max_ticks:
                raise RuntimeError(f"engine exceeded max_ticks={max_ticks}")
            out.extend(self.step())
        self.stats.wall_s += time.perf_counter() - t0
        return out


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def _rank_device(mesh) -> torch.device:
    """This rank's device on ``mesh``: its current card, or the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def synth_trace(vocab: int, n_requests: int, *, max_prompt: int = 12,
                min_prompt: int = 4, max_new: int = 8, min_new: int = 3,
                stagger: int = 2, n_priorities: int = 2,
                common_prefix: int = 0, seed: int = 0) -> List[Request]:
    """Staggered-arrival synthetic trace (the reference's draws, request
    for request): request i arrives at tick ``i * stagger`` with a random
    prompt length and budget and a cycling priority class;
    ``common_prefix`` prepends that many shared tokens (drawn once) to
    every prompt."""
    rng = np.random.RandomState(seed)
    prefix = (rng.randint(0, vocab, size=(common_prefix,)).astype(np.int32)
              if common_prefix else np.zeros((0,), np.int32))
    reqs = []
    for i in range(n_requests):
        s = int(rng.randint(min_prompt, max_prompt + 1))
        toks = np.concatenate(
            [prefix, rng.randint(0, vocab, size=(s,)).astype(np.int32)])
        reqs.append(Request(
            rid=i,
            tokens=toks,
            max_new=int(rng.randint(min_new, max_new + 1)),
            priority=i % n_priorities,
            arrival=i * stagger))
    return reqs


def generate_dynamic(params, cfg: ModelConfig, prompts: Sequence,
                     n_new: int, max_len: Optional[int] = None,
                     n_slots: Optional[int] = None,
                     device=None) -> torch.Tensor:
    """Ragged-batch greedy generation through the engine: ``prompts`` is a
    list of 1-D token arrays of different lengths. Returns [B, n_new] long
    on ``device`` (every request generates exactly ``n_new`` tokens; no
    EOS)."""
    lens = [int(np.asarray(p).shape[-1]) for p in prompts]
    max_len = max_len or (max(lens) + n_new)
    n_slots = n_slots or min(len(prompts), 4)
    eng = Engine(params, cfg, n_slots=n_slots, max_len=max_len,
                 device=device)
    reqs = [Request(rid=i, tokens=np.asarray(p), max_new=n_new)
            for i, p in enumerate(prompts)]
    out = np.zeros((len(prompts), n_new), dtype=np.int64)
    for c in eng.run(reqs):
        out[c.rid] = c.tokens
    return torch.from_numpy(out).to(eng.device)
