"""Paged KV cache: device slot pool + host-side page allocator.

Device side: two pools per model, [num_layers, num_pages*page_size,
kv_heads, head_dim] for K and V, allocated once at engine start: plain
tensors, or QuantKV pools (int8 payload plus f32 [L, S, Hk] scales) when
kv_dtype="int8". Host side: a free-list allocator of page indices. Page
0 is RESERVED as the trash page: page-table rows are padded with it, and
padding tokens write their K/V there.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ollamamq_tpu_torch.config import EngineConfig, ModelConfig
from ollamamq_tpu_torch.ops.quant import QuantKV

TRASH_PAGE = 0


class PageAllocator:
    """Free-list allocator over page indices [1, num_pages).

    With the prefix cache on (engine/prefix_cache.py) every page is
    exactly one of FREE (on the free list), USED (private to a slot) or
    CACHED (owned by the radix tree, possibly pinned by live requests);
    `cached_pages` counts the third, so free + used + cached ==
    num_pages - 1 always holds.
    """

    def __init__(self, num_pages: int, page_size: int, max_pages_per_seq: int):
        self.num_pages = num_pages
        self.page_size = page_size
        self.max_pages_per_seq = max_pages_per_seq
        self._free: List[int] = list(range(num_pages - 1, 0, -1))  # page 0 reserved
        self.cached_pages = 0  # tree-owned

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def used_pages(self) -> int:
        return (self.num_pages - 1) - len(self._free) - self.cached_pages

    def pages_needed(self, num_tokens: int) -> int:
        return max(1, -(-num_tokens // self.page_size))

    def alloc(self, num_tokens: int) -> Optional[List[int]]:
        """Pages to hold num_tokens; None if the pool is exhausted or the
        request exceeds the per-sequence page cap."""
        return self.alloc_n(self.pages_needed(num_tokens))

    def alloc_n(self, n: int, held: int = 0) -> Optional[List[int]]:
        """Exactly n pages for a sequence already holding `held` (a
        prefix-cache hit: its shared pages count against the per-sequence
        cap but come from the tree, not the free list)."""
        if n > len(self._free) or held + n > self.max_pages_per_seq:
            return None
        return [self._free.pop() for _ in range(n)]

    def adopt_cached(self, n: int = 1) -> None:
        """A slot's page(s) moved into the prefix-cache tree."""
        self.cached_pages += n

    def reclaim_cached(self, page: int) -> None:
        """An evicted tree page returns to the free list."""
        self.cached_pages -= 1
        if page != TRASH_PAGE:
            self._free.append(page)

    def extend(self, pages: List[int], new_total_tokens: int) -> bool:
        """Grow an allocation (in place) to cover new_total_tokens. False
        if the pool is exhausted or the per-sequence cap is reached."""
        need = self.pages_needed(new_total_tokens)
        while len(pages) < need:
            if not self._free or len(pages) >= self.max_pages_per_seq:
                return False
            pages.append(self._free.pop())
        return True

    def rollback_to(self, pages: List[int], kv_len: int, keep: int = 0) -> int:
        """Speculative rollback: shrink an allocation (in place) to the
        pages `kv_len` written tokens need, returning the rejected tail's
        pages to the free list; never below `keep`, the sequence's shared
        prefix-tree pages (they lead the list and belong to the tree).
        Returns the number of pages freed. Rejected positions on the
        device need no un-write: they sit past the rolled-back kv_len and
        the next real step overwrites them."""
        target = max(self.pages_needed(max(1, kv_len)), keep)
        freed = 0
        while len(pages) > target:
            p = pages.pop()
            if p != TRASH_PAGE:
                self._free.append(p)
                freed += 1
        return freed

    def free(self, pages: List[int]) -> None:
        for p in pages:
            if p != TRASH_PAGE:
                self._free.append(p)
        pages.clear()


def make_page_table_row(pages: List[int], max_pages: int) -> np.ndarray:
    """Pad a page list with the trash page to the static table width."""
    row = np.full((max_pages,), TRASH_PAGE, dtype=np.int32)
    row[: len(pages)] = pages
    return row


def alloc_kv_pool(model_cfg: ModelConfig, engine_cfg: EngineConfig,
                  dtype=torch.bfloat16, device="cpu", kv_dtype: str = "bfloat16"):
    """Allocate the K/V slot pools on `device`: zeros in `dtype`, or, for
    kv_dtype="int8", QuantKV pools of an int8 zero payload and f32 scales
    of ONE per (layer, slot, kv head), as the JAX package allocates them."""
    S = engine_cfg.num_pages * engine_cfg.page_size
    shape = (model_cfg.num_layers, S, model_cfg.num_kv_heads,
             model_cfg.head_dim)
    if kv_dtype == "int8":
        return tuple(QuantKV(torch.zeros(shape, dtype=torch.int8, device=device),
                             torch.ones(shape[:-1], dtype=torch.float32,
                                        device=device))
                     for _ in range(2))
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))


def kv_page_bytes(model_cfg: ModelConfig, page_size: int,
                  bytes_per_el=2, kv_dtype: str = "bfloat16") -> int:
    """Bytes ONE page costs (K and V, all layers), the unit of equal-memory
    pool sizing: each (slot, kv head) row holds hd elements of
    bytes_per_el, or hd int8 bytes plus a 4-byte f32 scale."""
    per_row = (model_cfg.head_dim + 4 if kv_dtype == "int8"
               else model_cfg.head_dim * bytes_per_el)
    return 2 * model_cfg.num_layers * page_size * model_cfg.num_kv_heads * per_row


def kv_pool_bytes(model_cfg: ModelConfig, engine_cfg: EngineConfig,
                  bytes_per_el=2, kv_dtype: str = "bfloat16") -> int:
    """Planning-time size of both pools (K and V, all layers)."""
    return engine_cfg.num_pages * kv_page_bytes(model_cfg, engine_cfg.page_size,
                                                 bytes_per_el, kv_dtype)
