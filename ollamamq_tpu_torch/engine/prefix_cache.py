"""Automatic prefix caching: radix-tree KV reuse over the paged allocator.

Two requests sharing a system prompt used to recompute identical KV
pages ("Ragged Paged Attention" shows the TPU paged kernels already
tolerate per-sequence ragged prefixes, so sharing is purely a host-side
bookkeeping problem). This module is that bookkeeping:

  - The tree is keyed on token-id BLOCKS of `page_size`: each node is one
    fully-populated prompt page, its key the page's token ids, its value
    the physical page index in the KV pool. A node's path from the root
    spells the full token prefix, so equal paths imply bit-identical KV
    content (causal models: K/V at position p depend only on tokens
    [0, p]).
  - Admission walks the tree (ModelRuntime._admit_ragged), pins the
    longest match (refcount++ on every node of the path — pinned sets
    are upward-closed), seeds the request's page table with the shared
    pages, and prefills only the uncached tail as a ragged span.
    The last partial prompt page is always private and decode writes
    start strictly after the full prompt pages, so shared pages are
    READ-ONLY on the hot path — no copy-on-write anywhere.
  - On completion (or post-install cancel) the request's full prompt
    pages are inserted: new blocks transfer page ownership to the tree,
    duplicate blocks (a concurrent identical prompt finished first) free
    the redundant page.
  - When the allocator runs dry, an LRU sweep evicts unreferenced leaf
    nodes back to the free list (leaves only: evicting an interior node
    would orphan descendants the walk could no longer reach).

Page accounting: every page is exactly one of free (allocator free
list), used (private to a slot), or cached (tree-owned) — the allocator
tracks the cached count so `free + used + cached == num_pages - 1` holds
at all times (tests/test_torch_prefix_cache.py fuzzes this invariant).

This is the JAX package's module (ollamamq_tpu/engine/prefix_cache.py)
carried over as is, apart from its metric gauges: the counters are plain
attributes that stats() returns.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from ollamamq_tpu_torch.engine.kv_cache import PageAllocator


class PrefixNode:
    """One fully-populated prompt page: `block` is its page_size token
    ids, `page` the physical page index owned by the tree."""

    __slots__ = ("block", "page", "refcount", "children", "parent",
                 "last_used")

    def __init__(self, block: Optional[tuple], page: Optional[int],
                 parent: Optional["PrefixNode"] = None):
        self.block = block
        self.page = page
        self.refcount = 0
        self.children: dict = {}
        self.parent = parent
        self.last_used = 0


class PrefixCache:
    """Per-runtime radix tree mapping token-block paths to refcounted
    physical KV pages. Single-threaded by design: every caller is the
    engine loop (admission, slot release, decode page growth), the same
    thread that owns the PageAllocator."""

    def __init__(self, page_size: int, alloc: PageAllocator, model: str = "",
                 min_pages: int = 1):
        self.page_size = page_size
        self.alloc = alloc
        self.min_pages = max(1, min_pages)
        self.root = PrefixNode(None, None)
        self._clock = 0  # logical LRU clock (no wall time on the hot path)
        self._nodes = 0
        self._pinned = 0  # nodes with refcount > 0
        self.model = model
        # Counters (stats() returns them).
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.tokens_saved = 0

    # -- bookkeeping -------------------------------------------------------
    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    @property
    def cached_pages(self) -> int:
        return self._nodes

    @property
    def evictable_pages(self) -> int:
        """Pages reclaimable by eviction. Pinned sets are upward-closed
        (pin() pins the whole path), so any unreferenced node's entire
        subtree is unreferenced too — every one of them is eventually
        evictable."""
        return self._nodes - self._pinned

    # -- lookup / pin ------------------------------------------------------
    def match(self, tokens: List[int],
              max_pages: Optional[int] = None) -> Tuple[list, List[int]]:
        """Longest cached prefix of `tokens` in full-page units. Returns
        (nodes, pages) root-to-leaf. Capped so at least one prompt token
        stays uncached (the tail forward must produce the first-token
        logits) and the request stays under the per-sequence page cap."""
        ps = self.page_size
        cap = (len(tokens) - 1) // ps
        cap = min(cap, self.alloc.max_pages_per_seq - 1)
        if max_pages is not None:
            cap = min(cap, max_pages)
        node = self.root
        nodes: list = []
        pages: List[int] = []
        for i in range(cap):
            child = node.children.get(tuple(tokens[i * ps:(i + 1) * ps]))
            if child is None:
                break
            nodes.append(child)
            pages.append(child.page)
            node = child
        return nodes, pages

    def pin(self, nodes: list) -> None:
        t = self._tick()
        for nd in nodes:
            if nd.refcount == 0:
                self._pinned += 1
            nd.refcount += 1
            nd.last_used = t

    def release(self, nodes: list) -> None:
        for nd in nodes:
            nd.refcount -= 1
            assert nd.refcount >= 0, "prefix-cache refcount underflow"
            if nd.refcount == 0:
                self._pinned -= 1

    def note_hit(self, tokens_saved: int) -> None:
        self.hits += 1
        self.tokens_saved += tokens_saved

    def note_miss(self) -> None:
        self.misses += 1

    # -- insert / evict ----------------------------------------------------
    def insert(self, tokens: List[int], pages: List[int]) -> int:
        """Merge a finished request's full prompt pages into the tree.
        `pages[i]` holds the KV of token block i. New blocks ADOPT their
        page (ownership moves from the slot to the tree); existing blocks
        keep the tree's copy and the caller's duplicate page is freed.
        Returns the number of pages adopted."""
        ps = self.page_size
        node = self.root
        t = self._tick()
        adopted = 0
        for i, page in enumerate(pages):
            block = tuple(tokens[i * ps:(i + 1) * ps])
            child = node.children.get(block)
            if child is None:
                child = PrefixNode(block, page, parent=node)
                node.children[block] = child
                self.alloc.adopt_cached()
                self._nodes += 1
                adopted += 1
            elif child.page != page:
                # A concurrent identical prompt finished first: its page
                # already holds this block's KV — ours is redundant.
                self.alloc.free([page])
            child.last_used = t
            node = child
        return adopted

    def evict(self, n_pages: int) -> int:
        """Reclaim up to n_pages from unreferenced LEAF nodes, oldest
        last_used first, back into the allocator free list. Returns pages
        actually freed (0 when everything is pinned)."""
        freed = 0
        while freed < n_pages:
            victim = self._lru_leaf()
            if victim is None:
                break
            del victim.parent.children[victim.block]
            self.alloc.reclaim_cached(victim.page)
            self._nodes -= 1
            freed += 1
            self.evictions += 1
        return freed

    def _lru_leaf(self) -> Optional[PrefixNode]:
        best = None
        stack = [self.root]
        while stack:
            nd = stack.pop()
            if nd is not self.root and not nd.children and nd.refcount == 0:
                if best is None or nd.last_used < best.last_used:
                    best = nd
            stack.extend(nd.children.values())
        return best

    def flush(self) -> int:
        """Evict every unreferenced node (POST /debug/prefix_cache).
        Pinned paths — prefixes live requests are decoding against —
        survive."""
        return self.evict(self._nodes)

    # -- introspection -----------------------------------------------------
    def stats(self) -> dict:
        total = self.hits + self.misses
        return {
            "hits": self.hits,
            "misses": self.misses,
            "hit_ratio": round(self.hits / total, 4) if total else 0.0,
            "evictions": self.evictions,
            "tokens_saved": self.tokens_saved,
            "cached_pages": self._nodes,
            "evictable_pages": self.evictable_pages,
            "pinned_pages": self._pinned,
        }

    def pages(self) -> set:
        """Every physical page the tree owns (tests/invariants)."""
        out = set()
        stack = [self.root]
        while stack:
            nd = stack.pop()
            if nd is not self.root:
                out.add(nd.page)
            stack.extend(nd.children.values())
        return out

    def check(self) -> None:
        """Structural invariants (tests + fuzzing): refcounts ≥ 0,
        pinned sets upward-closed, node/page counts consistent with the
        allocator's cached accounting, no page owned twice."""
        seen = set()
        count = 0
        pinned = 0
        stack = [(self.root, True)]
        while stack:
            nd, parent_ok = stack.pop()
            if nd is not self.root:
                count += 1
                assert nd.refcount >= 0
                if nd.refcount > 0:
                    pinned += 1
                    # upward closure: a pinned node's parent is pinned
                    # (or the root).
                    assert parent_ok, "pinned node under unpinned parent"
                assert nd.page not in seen, "page owned by two nodes"
                seen.add(nd.page)
                assert nd.page not in self.alloc._free, \
                    "page both free and cached"
            ok = nd is self.root or nd.refcount > 0
            stack.extend((c, ok) for c in nd.children.values())
        assert count == self._nodes == self.alloc.cached_pages
        assert pinned == self._pinned
