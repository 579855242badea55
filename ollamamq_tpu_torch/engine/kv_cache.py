"""Paged KV cache: device slot pool + host-side page allocator.

Device side: two tensors per model, [num_layers, num_pages*page_size,
kv_heads, head_dim] for K and V, allocated once at engine start. Host
side: a free-list allocator of page indices. Page 0 is RESERVED as the
trash page: page-table rows are padded with it, and padding tokens write
their K/V there.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ollamamq_tpu_torch.config import EngineConfig, ModelConfig

TRASH_PAGE = 0


class PageAllocator:
    """Free-list allocator over page indices [1, num_pages)."""

    def __init__(self, num_pages: int, page_size: int, max_pages_per_seq: int):
        self.num_pages = num_pages
        self.page_size = page_size
        self.max_pages_per_seq = max_pages_per_seq
        self._free: List[int] = list(range(num_pages - 1, 0, -1))  # page 0 reserved

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def used_pages(self) -> int:
        return (self.num_pages - 1) - len(self._free)

    def pages_needed(self, num_tokens: int) -> int:
        return max(1, -(-num_tokens // self.page_size))

    def alloc(self, num_tokens: int) -> Optional[List[int]]:
        """Pages to hold num_tokens; None if the pool is exhausted or the
        request exceeds the per-sequence page cap."""
        n = self.pages_needed(num_tokens)
        if n > len(self._free) or n > self.max_pages_per_seq:
            return None
        return [self._free.pop() for _ in range(n)]

    def extend(self, pages: List[int], new_total_tokens: int) -> bool:
        """Grow an allocation (in place) to cover new_total_tokens. False
        if the pool is exhausted or the per-sequence cap is reached."""
        need = self.pages_needed(new_total_tokens)
        while len(pages) < need:
            if not self._free or len(pages) >= self.max_pages_per_seq:
                return False
            pages.append(self._free.pop())
        return True

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
                  dtype=torch.bfloat16, device="cpu"):
    """Allocate the K/V slot pools (zeros) on `device`."""
    S = engine_cfg.num_pages * engine_cfg.page_size
    shape = (model_cfg.num_layers, S, model_cfg.num_kv_heads,
             model_cfg.head_dim)
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))
