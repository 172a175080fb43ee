"""Paged KV cache: device page pool + host-side allocator with prefix reuse.

The pool is a pair of tensors ``[n_layers, num_pages * page_size,
n_kv_heads, head_dim]`` on the serving device; the forward writes into them
in place. An int8 pool holds, for K and for V, a ``(values int8, scales
float32 [n_layers, num_pages * page_size, n_kv_heads])`` tuple with one
absmax scale per (token, kv head) (``ops/attention.py::quantize_kv``).
Logical->physical mapping lives in per-slot page tables (int32), and the
free list is host-side.

Prefix caching: full pages are content-addressed by a hash chain over their
token ids. When a new request's prompt shares a page-aligned prefix with
pages still resident, those pages are reused (refcounted; shared pages are
never written, because decode only ever writes the last, unshared page of a
sequence) and prefill skips to the first novel token. Pages whose last
reference drops move to an LRU of retired-but-resident pages and are only
recycled under pool pressure.

On a tensor-parallel mesh the pool is one K and one V tensor per shard,
``[n_layers, tokens / seq, n_kv_heads / model, head_dim]``
(``parallel/sharding.py::kv_pool_shard_shape``); page ids stay global, so
the allocator, the page tables and the prefix cache do not change (page
shard s owns global pages ``[s, s + 1) * num_pages / seq``, and the null
page 0 lives on shard 0).

The host side (allocator, hashing, prefix index) is a copy of the JAX
package's pure-Python backend.
"""

from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any, Optional, Sequence

import numpy as np
import torch

from runbookai_tpu_torch.parallel.mesh import Mesh
from runbookai_tpu_torch.parallel.sharding import kv_pool_shard_shape


@dataclass
class PagePool:
    """Device tensors for the paged KV cache."""

    kv_k: Any  # a tensor, an int8 pool's (values, scales), or one per shard
    kv_v: Any
    page_size: int
    num_pages: int

    @staticmethod
    def create(
        n_layers: int,
        num_pages: int,
        page_size: int,
        n_kv_heads: int,
        head_dim: int,
        dtype: torch.dtype = torch.bfloat16,
        device="cuda",
        mesh: Optional[Mesh] = None,
    ) -> "PagePool":
        """The pools on ``device`` or, with a ``mesh``, a list of each
        shard's pools on its own device."""
        shape = (n_layers, num_pages * page_size, n_kv_heads, head_dim)
        if mesh is not None:
            shape = kv_pool_shard_shape(n_layers, num_pages, page_size, n_kv_heads,
                                        head_dim, mesh)

        def alloc(dev):
            vals = torch.zeros(shape, dtype=dtype, device=dev)
            if dtype == torch.int8:
                return vals, torch.zeros(shape[:3], dtype=torch.float32, device=dev)
            return vals

        if mesh is None:
            kv_k, kv_v = alloc(device), alloc(device)
        else:
            kv_k = [alloc(dev) for dev in mesh.devices]
            kv_v = [alloc(dev) for dev in mesh.devices]
        return PagePool(kv_k=kv_k, kv_v=kv_v, page_size=page_size,
                        num_pages=num_pages)


def hash_blocks(token_ids: Sequence[int], page_size: int,
                max_blocks: Optional[int] = None, seed: int = 0) -> list[int]:
    """FNV-1a hash chain over full pages of ``token_ids``.

    Block i's hash folds in block i-1's, so equal hashes imply equal full
    prefixes (up to hash collisions), never equal pages at different depths.
    ``seed`` partitions the cache namespace.
    """
    n_full = len(token_ids) // page_size
    if max_blocks is not None:
        n_full = min(n_full, max_blocks)
    out: list[int] = []
    h = 0xCBF29CE484222325 ^ ((seed * 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF)
    for b in range(n_full):
        for t in token_ids[b * page_size : (b + 1) * page_size]:
            h ^= (t + 1) & 0xFFFFFFFFFFFFFFFF
            h = (h * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
        out.append(h)
    return out


class PageAllocator:
    """Host-side allocator over physical page ids with a prefix-cache index.

    Page 0 is reserved as the "null" page that padding/unused page-table slots
    point at, so garbage gathers stay in-bounds and get masked downstream.

    Page lifecycle::

        free ──alloc──▶ referenced (ref ≥ 1, owned by live sequences)
          ▲                │ decref→0, has content hash
          │                ▼
          └──evict──── retired LRU (resident, matchable, recyclable)

    ``alloc`` prefers the free list and falls back to evicting the
    least-recently-retired cached page (its hash entry is invalidated).
    """

    NULL_PAGE = 0

    def __init__(self, num_pages: int):
        if num_pages < 2:
            raise ValueError("need at least 2 pages (one reserved null page)")
        self.num_pages = num_pages
        self._free: list[int] = list(range(num_pages - 1, 0, -1))  # stack; 0 reserved
        self._ref: dict[int, int] = {}
        self._retired: OrderedDict[int, None] = OrderedDict()  # LRU, ref == 0
        self._hash_to_page: dict[int, int] = {}
        self._page_to_hash: dict[int, int] = {}

    @property
    def free_pages(self) -> int:
        """Pages allocatable right now (free + evictable retired)."""
        return len(self._free) + len(self._retired)

    @property
    def cached_pages(self) -> int:
        return len(self._retired)

    def alloc(self, n: int) -> list[int]:
        if n > self.free_pages:
            raise MemoryError(
                f"KV page pool exhausted: want {n}, have {self.free_pages}")
        out: list[int] = []
        for _ in range(n):
            if self._free:
                p = self._free.pop()
            else:
                p, _ = self._retired.popitem(last=False)  # oldest retired
                self._invalidate(p)
            self._ref[p] = 1
            out.append(p)
        return out

    def free(self, pages: Sequence[int]) -> None:
        """Decref each page; unreferenced pages retire (if hashed) or free."""
        for p in pages:
            if p == self.NULL_PAGE:
                continue
            r = self._ref.get(p, 0) - 1
            if r > 0:
                self._ref[p] = r
                continue
            self._ref.pop(p, None)
            if p in self._page_to_hash:
                self._retired[p] = None
                self._retired.move_to_end(p)
            else:
                self._free.append(p)

    # ------------------------------------------------------------ prefix cache

    def register(self, page: int, block_hash: int) -> None:
        """Publish a full page's content hash so future prompts can match it."""
        if page == self.NULL_PAGE or block_hash in self._hash_to_page:
            return  # first writer wins; duplicates keep their private copy
        old = self._page_to_hash.get(page)
        if old is not None:
            self._hash_to_page.pop(old, None)
        self._page_to_hash[page] = block_hash
        self._hash_to_page[block_hash] = page

    def lookup(self, block_hash: int) -> Optional[int]:
        return self._hash_to_page.get(block_hash)

    def acquire(self, page: int) -> None:
        """Take a reference on a matched page (reviving it if retired)."""
        if page in self._retired:
            del self._retired[page]
            self._ref[page] = 1
        else:
            self._ref[page] = self._ref.get(page, 0) + 1

    def is_retired(self, page: int) -> bool:
        """True when the page is resident but unreferenced (counts toward
        ``free_pages``; acquiring it consumes allocatable capacity)."""
        return page in self._retired

    def _invalidate(self, page: int) -> None:
        h = self._page_to_hash.pop(page, None)
        if h is not None and self._hash_to_page.get(h) == page:
            del self._hash_to_page[h]


@dataclass
class SequenceAllocation:
    """Pages owned by one live sequence."""

    pages: list[int] = field(default_factory=list)
    ctx_len: int = 0  # tokens currently cached
    registered_blocks: int = 0  # full pages whose hashes are published
    hash_seed: int = 0  # prefix-cache namespace (LoRA adapter_idx)

    def pages_needed(self, new_len: int, page_size: int) -> int:
        have = len(self.pages)
        need = (new_len + page_size - 1) // page_size
        return max(0, need - have)


class KVCacheManager:
    """Pairs the device pool with the allocator and builds page tables."""

    def __init__(
        self,
        n_layers: int,
        num_pages: int,
        page_size: int,
        n_kv_heads: int,
        head_dim: int,
        max_seq_len: int,
        dtype: torch.dtype = torch.bfloat16,
        device="cuda",
        mesh: Optional[Mesh] = None,
    ):
        self.pool = PagePool.create(n_layers, num_pages, page_size, n_kv_heads,
                                    head_dim, dtype, device=device, mesh=mesh)
        self.allocator = PageAllocator(num_pages)
        self.page_size = page_size
        self.max_pages_per_seq = (max_seq_len + page_size - 1) // page_size
        self.seqs: dict[str, SequenceAllocation] = {}
        # Token ids actually stored in each published page — matches are
        # verified against these so a 64-bit hash collision can never serve
        # another request's KV. Bounded by num_pages.
        self._page_tokens: dict[int, tuple[int, ...]] = {}

    # ----------------------------------------------------------- prefix reuse

    def _prompt_hashes(self, prompt_ids: Sequence[int],
                       hashes: Optional[list[int]],
                       hash_seed: int = 0) -> list[int]:
        """Hash chain for matching: capped below ``len(prompt_ids)`` so at
        least one prompt token is always prefilled (the engine needs its
        logits to sample from). ``hashes`` may be a memoized full chain."""
        max_blocks = (len(prompt_ids) - 1) // self.page_size
        if hashes is not None:
            return hashes[:max_blocks]
        return hash_blocks(prompt_ids, self.page_size, max_blocks,
                           seed=hash_seed)

    def _match_pages(self, prompt_ids: Sequence[int],
                     hashes: Optional[list[int]],
                     hash_seed: int = 0) -> list[int]:
        """Resident pages holding the prompt's leading full blocks, verified
        token-by-token (a bare hash hit is never trusted)."""
        matched: list[int] = []
        for b, h in enumerate(self._prompt_hashes(prompt_ids, hashes,
                                                  hash_seed)):
            page = self.allocator.lookup(h)
            if page is None:
                break
            blk = tuple(prompt_ids[b * self.page_size : (b + 1) * self.page_size])
            if self._page_tokens.get(page) != blk:
                break  # hash collision or stale publish — treat as a miss
            matched.append(page)
        return matched

    def probe_admit(self, prompt_ids: Sequence[int], headroom_tokens: int = 0,
                    hashes: Optional[list[int]] = None,
                    hash_seed: int = 0,
                    ) -> tuple[bool, list[int]]:
        """Admission check honoring prefix reuse: ``(fits, matched_pages)``.

        Matched *retired* pages are about to be revived by ``add_sequence`` —
        they both reduce the pages to allocate and consume allocatable
        capacity, so they must be subtracted from ``free_pages`` too. The matched
        pages are returned so ``add_sequence(matched=...)`` needn't re-walk
        the chain (valid only until the next alloc/release).
        """
        matched = self._match_pages(prompt_ids, hashes, hash_seed)
        cached = len(matched) * self.page_size
        reserved = sum(1 for p in matched if self.allocator.is_retired(p))
        need = self.add_pages_needed(len(prompt_ids), cached, headroom_tokens)
        return need <= self.allocator.free_pages - reserved, matched

    def add_sequence(self, seq_id: str, prompt_ids: Optional[Sequence[int]] = None,
                     hashes: Optional[list[int]] = None,
                     matched: Optional[list[int]] = None,
                     hash_seed: int = 0) -> int:
        """Register a sequence, reusing cached prefix pages. Returns the
        number of prompt tokens whose KV is already resident. ``matched``
        short-circuits the chain walk with pages a just-run ``probe_admit``
        already verified. ``hash_seed`` (the LoRA adapter row) is REMEMBERED
        on the allocation, so later publishes release into the same cache
        namespace the pages were matched from."""
        alloc = SequenceAllocation(hash_seed=hash_seed)
        cached = 0
        if prompt_ids:
            pages = (matched if matched is not None
                     else self._match_pages(prompt_ids, hashes, hash_seed))
            for page in pages:
                self.allocator.acquire(page)
                alloc.pages.append(page)
                cached += self.page_size
            alloc.ctx_len = cached
            alloc.registered_blocks = len(alloc.pages)
        self.seqs[seq_id] = alloc
        return cached

    def register_prefix(self, seq_id: str, token_ids: Sequence[int],
                        hashes: Optional[list[int]] = None) -> None:
        """Publish hashes for this sequence's newly completed full pages.

        ``token_ids`` must be the tokens whose KV the pages actually hold
        (prompt plus any generated tokens already fed back).
        """
        alloc = self.seqs.get(seq_id)
        if alloc is None:
            return
        max_blocks = min(len(token_ids) // self.page_size, len(alloc.pages))
        if hashes is None or len(hashes) < max_blocks:
            hashes = hash_blocks(token_ids, self.page_size, max_blocks,
                                 seed=alloc.hash_seed)
        for b in range(alloc.registered_blocks, max_blocks):
            page = alloc.pages[b]
            self.allocator.register(page, hashes[b])
            if self.allocator.lookup(hashes[b]) == page:  # publish took effect
                self._page_tokens[page] = tuple(
                    token_ids[b * self.page_size : (b + 1) * self.page_size])
        alloc.registered_blocks = max(alloc.registered_blocks, max_blocks)

    # -------------------------------------------------------------- lifecycle

    def add_pages_needed(self, prompt_len: int, cached_len: int = 0,
                         headroom_tokens: int = 0) -> int:
        total = (prompt_len + headroom_tokens + self.page_size - 1) // self.page_size
        return max(0, total - cached_len // self.page_size)

    def extend(self, seq_id: str, new_ctx_len: int) -> None:
        """Ensure pages exist to hold ``new_ctx_len`` tokens."""
        alloc = self.seqs[seq_id]
        if new_ctx_len > self.max_pages_per_seq * self.page_size:
            raise MemoryError(f"sequence {seq_id} exceeds max_seq_len")
        need = alloc.pages_needed(new_ctx_len, self.page_size)
        if need:
            alloc.pages.extend(self.allocator.alloc(need))
        alloc.ctx_len = new_ctx_len

    def can_extend(self, seq_id: str, new_ctx_len: int) -> bool:
        alloc = self.seqs.get(seq_id)
        if alloc is None:
            return False
        return alloc.pages_needed(new_ctx_len, self.page_size) <= self.allocator.free_pages

    def release(self, seq_id: str, token_ids: Optional[Sequence[int]] = None) -> None:
        """Drop a sequence's references. When ``token_ids`` is given, full
        pages are published to the prefix cache first so the next request
        with the same prefix rides them."""
        alloc = self.seqs.get(seq_id)
        if alloc is None:
            return
        if token_ids is not None:
            self.register_prefix(seq_id, token_ids)
        del self.seqs[seq_id]
        self.allocator.free(alloc.pages)

    # ------------------------------------------------------------ page tables

    def page_table_row(self, seq_id: str) -> np.ndarray:
        """Padded int32 row of physical page ids for one sequence."""
        row = np.full(self.max_pages_per_seq, PageAllocator.NULL_PAGE, dtype=np.int32)
        pages = self.seqs[seq_id].pages
        row[: len(pages)] = pages
        return row

    def page_tables(self, seq_ids: list[str]) -> np.ndarray:
        """[len(seq_ids), max_pages_per_seq] int32; unknown ids -> null rows."""
        rows = []
        for sid in seq_ids:
            if sid in self.seqs:
                rows.append(self.page_table_row(sid))
            else:
                rows.append(np.zeros(self.max_pages_per_seq, dtype=np.int32))
        return np.stack(rows) if rows else np.zeros((0, self.max_pages_per_seq), np.int32)
