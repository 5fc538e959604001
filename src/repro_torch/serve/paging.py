"""Paged KV-cache bookkeeping: page allocator, refcounts, prefix hashes.

A copy of ``repro.serve.paging``: the port imports nothing of ``repro``.

The serving engine stores full-attention K/V in a shared *page pool*
(``serve.decode.init_paged_cache``): ``n_pages`` fixed-size pages of
``page_size`` tokens each, instead of one monolithic ``max_len`` row per
slot. This module owns the host-side bookkeeping for that pool:

* :class:`PagedAllocator` — free-list + refcount allocator. Page 0 is
  permanently reserved as the *garbage page*: inactive slots' page tables
  point at it, so the fused decode tick's garbage writes can never land in
  a live page. Freed pages keep their content hash until reallocated
  ("cached-free"), so a later request with the same prompt prefix can
  revive them without recomputation.
* :func:`page_hashes` — cumulative content hashes of full prompt pages.
  Two requests share a physical page iff their token prefixes are
  identical through that page (the hash chains, so page ``i`` commits to
  every token in pages ``0..i``).

Sharing protocol (engine side): prefix pages are matched *only* against
hashes registered after the page content was fully written, a match bumps
the page's refcount (many slots, one physical page), and a slot only ever
*writes* pages it allocated itself — ``fork`` implements copy-on-write
for the residual case of a write landing on a page with refcount > 1.

Everything here is plain host Python/numpy — no torch, no device state.
"""
from __future__ import annotations

import hashlib
from collections import deque
from typing import Dict, List, Optional, Sequence

import numpy as np

#: physical page id reserved for garbage writes from inactive slots
GARBAGE_PAGE = 0


def page_hashes(tokens, page_size: int, *, salt: bytes = b"") -> List[bytes]:
    """Cumulative digests of the full pages of a prompt.

    Returns one 16-byte blake2b digest per *complete* page of ``tokens``
    (``len(tokens) // page_size`` entries). Digest ``i`` hashes digest
    ``i-1`` plus page ``i``'s token ids, so equal digests imply equal
    token prefixes through that page — the property prefix sharing needs.
    ``salt`` distinguishes incompatible cache spaces (e.g. engines that
    also condition on non-token inputs)."""
    toks = np.ascontiguousarray(np.asarray(tokens, dtype=np.int64).ravel())
    n_full = len(toks) // page_size
    digest = hashlib.blake2b(salt, digest_size=16).digest()
    out: List[bytes] = []
    for i in range(n_full):
        h = hashlib.blake2b(digest, digest_size=16)
        h.update(toks[i * page_size:(i + 1) * page_size].tobytes())
        digest = h.digest()
        out.append(digest)
    return out


class PagedAllocator:
    """Free-list page allocator with refcounts and cached-free prefix reuse.

    Pages ``1..n_pages-1`` are allocatable; page ``GARBAGE_PAGE`` (0) is
    never handed out. The free list is FIFO: a page released now is reused
    *last*, which maximizes the window during which its retained content
    hash can be matched by a new request ("cached-free" reuse, the same
    idea as vLLM's free-but-cached blocks).

    Reservations (``reserve``/``unreserve``) let the engine gate admission
    on the *worst-case* page demand of a request (prompt + full ``max_new``
    budget) while physically allocating decode pages lazily: ``alloc``
    with ``reserved=True`` consumes one unit of the reservation.
    """

    def __init__(self, n_pages: int, page_size: int):
        if n_pages < 2:
            raise ValueError(f"n_pages must be >= 2 (page 0 is the garbage "
                             f"page), got {n_pages}")
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        self.n_pages = n_pages
        self.page_size = page_size
        self.refcount = np.zeros(n_pages, dtype=np.int64)
        self._free = deque(range(1, n_pages))
        self._page_hash: Dict[int, bytes] = {}
        self._hash_page: Dict[bytes, int] = {}
        self._reserved = 0
        self.in_use_peak = 0

    # -- capacity ----------------------------------------------------------

    @property
    def in_use(self) -> int:
        """Pages currently held by at least one slot (excludes garbage)."""
        return self.n_pages - 1 - len(self._free)

    def available(self) -> int:
        """Free pages not spoken for by an outstanding reservation."""
        return len(self._free) - self._reserved

    def reserve(self, n: int) -> bool:
        """Set aside ``n`` free pages for later ``alloc(reserved=True)``
        calls. False (and no state change) when fewer are available."""
        if n < 0:
            raise ValueError(f"reserve: n must be >= 0, got {n}")
        if self.available() < n:
            return False
        self._reserved += n
        return True

    def unreserve(self, n: int) -> None:
        """Return ``n`` unused reservation units (eviction path)."""
        if n < 0 or n > self._reserved:
            raise ValueError(f"unreserve({n}) with {self._reserved} reserved")
        self._reserved -= n

    # -- alloc / release ---------------------------------------------------

    def alloc(self, *, reserved: bool = False) -> int:
        """Take one page off the free list (refcount 1). ``reserved=True``
        consumes one previously reserved unit; otherwise the page must be
        available beyond all reservations. Any stale content hash the page
        carried from a prior life is dropped."""
        if reserved:
            if self._reserved <= 0:
                raise RuntimeError("alloc(reserved=True) without reservation")
            if not self._free:
                raise RuntimeError("alloc: reservation outstanding but free "
                                   "list empty (accounting bug)")
            self._reserved -= 1
        elif self.available() <= 0:
            raise RuntimeError("alloc: no unreserved free pages")
        pid = self._free.popleft()
        old = self._page_hash.pop(pid, None)
        if old is not None and self._hash_page.get(old) == pid:
            del self._hash_page[old]
        self.refcount[pid] = 1
        self.in_use_peak = max(self.in_use_peak, self.in_use)
        return pid

    def release(self, pid: int) -> None:
        """Drop one reference. At refcount 0 the page returns to the free
        list *tail* but keeps its content hash (cached-free): until it is
        reallocated, a prefix match can revive it via ``match_prefix``."""
        if pid == GARBAGE_PAGE:
            raise ValueError("release: the garbage page is never allocated")
        if self.refcount[pid] <= 0:
            raise ValueError(f"release: page {pid} is not allocated")
        self.refcount[pid] -= 1
        if self.refcount[pid] == 0:
            self._free.append(pid)

    def fork(self, pid: int, *, reserved: bool = False) -> int:
        """Copy-on-write: give the caller a private copy slot for a page it
        shares with others. Allocates a fresh page, drops one reference on
        ``pid`` and returns the new page id — the caller must copy the
        device contents before writing."""
        if self.refcount[pid] < 2:
            raise ValueError(f"fork: page {pid} is not shared "
                             f"(refcount {self.refcount[pid]})")
        new = self.alloc(reserved=reserved)
        self.release(pid)
        return new

    # -- prefix sharing ----------------------------------------------------

    def register_hash(self, pid: int, digest: bytes) -> None:
        """Publish a fully-written page for prefix matching. First writer
        wins: if the digest is already mapped (a concurrent slot computed
        the same prefix) the existing mapping is kept."""
        if self.refcount[pid] <= 0:
            raise ValueError(f"register_hash: page {pid} is not allocated")
        if digest in self._hash_page:
            return
        self._hash_page[digest] = pid
        self._page_hash[pid] = digest

    def probe_prefix(self, digests: Sequence[bytes]) -> int:
        """Longest registered prefix run (in pages) — no state change."""
        n = 0
        for d in digests:
            if d not in self._hash_page:
                break
            n += 1
        return n

    def match_prefix(self, digests: Sequence[bytes]) -> List[int]:
        """Claim the longest registered prefix run: each matched page gets
        one more reference; cached-free pages are revived off the free
        list. Returns the claimed physical page ids in prefix order."""
        out: List[int] = []
        for d in digests:
            pid = self._hash_page.get(d)
            if pid is None:
                break
            if self.refcount[pid] == 0:
                if self.available() <= 0:
                    break               # reviving would starve a reservation
                self._free.remove(pid)
                self.in_use_peak = max(self.in_use_peak, self.in_use + 1)
            self.refcount[pid] += 1
            out.append(pid)
        return out

    def hash_of(self, pid: int) -> Optional[bytes]:
        """Registered content hash of a page (None when unhashed)."""
        return self._page_hash.get(pid)

    # -- invariants --------------------------------------------------------

    def check(self) -> None:
        """Raise AssertionError when internal bookkeeping is inconsistent
        (used by the property tests in tests/test_paged_cache.py)."""
        free = list(self._free)
        assert len(set(free)) == len(free), "free list holds duplicates"
        assert GARBAGE_PAGE not in free, "garbage page on the free list"
        for pid in free:
            assert self.refcount[pid] == 0, \
                f"free page {pid} has refcount {self.refcount[pid]}"
        live = [p for p in range(1, self.n_pages) if self.refcount[p] > 0]
        assert len(free) + len(live) == self.n_pages - 1, \
            "page leaked: not free and not referenced"
        assert 0 <= self._reserved <= len(free), \
            f"reserved {self._reserved} exceeds free {len(free)}"
        for digest, pid in self._hash_page.items():
            assert self._page_hash.get(pid) == digest, \
                f"hash maps disagree for page {pid}"
