"""Paged KV cache: device slot pool + host-side page allocator.

Device side: two pools per model, [num_layers, num_pages*page_size,
kv_heads, head_dim] for K and V, allocated once at engine start: plain
tensors, or QuantKV pools (int8 payload plus f32 [L, S, Hk] scales) when
kv_dtype="int8". Host side: a free-list allocator of page indices. Page
0 is RESERVED as the trash page: page-table rows are padded with it, and
padding tokens write their K/V there.

KV page migration (the fleet's drain and failover) copies a sequence's
page run out of one pool and into another, in process or through the
JAX package's wire format (pack_migration_blob / unpack_migration_blob).
"""

from __future__ import annotations

import io
import json
import struct
import zipfile
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


def local_kv_heads(model_cfg: ModelConfig, tp: int = 1) -> int:
    """KV heads one rank of a tp-way tensor-parallel mesh holds: its
    share of the heads, or one replicated head when tp > kv heads
    (parallel/sharding.py cuts the pool on kv_heads)."""
    return max(1, model_cfg.num_kv_heads // tp)


def alloc_kv_pool(model_cfg: ModelConfig, engine_cfg: EngineConfig,
                  dtype=torch.bfloat16, device="cpu", kv_dtype: str = "bfloat16",
                  tp: int = 1, layers: Optional[int] = None):
    """Allocate the K/V slot pools on `device`: zeros in `dtype`, or, for
    kv_dtype="int8", QuantKV pools of an int8 zero payload and f32 scales
    of ONE per (layer, slot, kv head), as the JAX package allocates them.
    With tp > 1, this rank's pools: local_kv_heads of them; `layers`
    (default all) is a pipeline stage's share of the layers."""
    S = engine_cfg.num_pages * engine_cfg.page_size
    shape = (model_cfg.num_layers if layers is None else layers, S,
             local_kv_heads(model_cfg, tp), model_cfg.head_dim)
    if kv_dtype == "int8":
        return tuple(QuantKV(torch.zeros(shape, dtype=torch.int8, device=device),
                             torch.ones(shape[:-1], dtype=torch.float32,
                                        device=device))
                     for _ in range(2))
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))


def kv_page_bytes(model_cfg: ModelConfig, page_size: int,
                  bytes_per_el=2, kv_dtype: str = "bfloat16", tp: int = 1) -> int:
    """Bytes ONE page costs (K and V, all layers), the unit of equal-memory
    pool sizing: each (slot, kv head) row holds hd elements of
    bytes_per_el, or hd int8 bytes plus a 4-byte f32 scale. With tp > 1,
    one rank's share."""
    per_row = (model_cfg.head_dim + 4 if kv_dtype == "int8"
               else model_cfg.head_dim * bytes_per_el)
    return (2 * model_cfg.num_layers * page_size
            * local_kv_heads(model_cfg, tp) * per_row)


def kv_pool_bytes(model_cfg: ModelConfig, engine_cfg: EngineConfig,
                  bytes_per_el=2, kv_dtype: str = "bfloat16") -> int:
    """Planning-time size of both pools (K and V, all layers)."""
    return engine_cfg.num_pages * kv_page_bytes(model_cfg, engine_cfg.page_size,
                                                 bytes_per_el, kv_dtype)


# ---------------------------------------------------------------------------
# KV page migration: a sequence's page run copied out of the pool into a
# host-side blob (and written back at new page indices), plus the JAX
# package's self-describing wire format, so a blob crosses a process
# boundary (the fleet's HttpMember, /admin/migrate) and either package's
# blob lands in the other. int8 pools move the int8 payload and the f32
# scale rows.
# ---------------------------------------------------------------------------

_WIRE_MAGIC = b"OMQMIG1\n"

# Wire names of dtypes numpy cannot hold: they ship as a uint8 view of
# the last axis, with the name in the header's "wire_dtypes".
_EXOTIC = {torch.bfloat16: "bfloat16"}
_EXOTIC_BY_NAME = {name: dt for dt, name in _EXOTIC.items()}


def _page_index(pages: List[int], page_size: int) -> np.ndarray:
    """Slot-pool row indices covering `pages` in run order."""
    idx = np.empty((len(pages) * page_size,), np.int32)
    for i, p in enumerate(pages):
        idx[i * page_size:(i + 1) * page_size] = np.arange(
            p * page_size, (p + 1) * page_size, dtype=np.int32)
    return idx


def gather_page_run(kc, vc, pages: List[int], page_size: int) -> dict:
    """Copy a page run's K/V rows to host tensors: {"k_pages", "v_pages"}
    of [L, n_pages*page_size, Hk, hd] (the pool's slot axis, axis 1),
    plus {"k_scale", "v_scale"} of [L, n, Hk] for int8 pools. Read-only
    with respect to the pool."""
    dev = (kc.q if isinstance(kc, QuantKV) else kc).device
    idx = torch.from_numpy(_page_index(pages, page_size)).to(
        dev, torch.long)

    def take(t):
        return t.index_select(1, idx).cpu()

    if isinstance(kc, QuantKV):
        return {"k_pages": take(kc.q), "v_pages": take(vc.q),
                "k_scale": take(kc.s), "v_scale": take(vc.s)}
    return {"k_pages": take(kc), "v_pages": take(vc)}


def _as_tensor(x, dtype, device) -> torch.Tensor:
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))
    return t.to(device=device, dtype=dtype)


def scatter_page_run(kc, vc, pages: List[int], page_size: int,
                     data: dict) -> None:
    """Write a gathered page run into a (possibly different) pool at
    `pages`, in place (index_copy_ on the slot axis): the runtimes keep
    their pools as live tensors. `data` holds tensors or numpy arrays."""
    if isinstance(kc, QuantKV):
        dev = kc.q.device
        idx = torch.from_numpy(_page_index(pages, page_size)).to(
            dev, torch.long)
        for pool, pk, sk in ((kc, "k_pages", "k_scale"),
                             (vc, "v_pages", "v_scale")):
            pool.q.index_copy_(1, idx, _as_tensor(data[pk], pool.q.dtype, dev))
            pool.s.index_copy_(1, idx, _as_tensor(data[sk], pool.s.dtype, dev))
        return
    idx = torch.from_numpy(_page_index(pages, page_size)).to(
        kc.device, torch.long)
    kc.index_copy_(1, idx, _as_tensor(data["k_pages"], kc.dtype, kc.device))
    vc.index_copy_(1, idx, _as_tensor(data["v_pages"], vc.dtype, vc.device))


def migration_blob_bytes(blob: dict) -> int:
    """Approximate wire size of a blob, the JAX package's definition: the
    bytes of every array in it (host tensors or numpy alike), which the
    page payload dominates: kv_page_bytes per page shipped, plus a
    stream's penalty-ring row. The ollamamq_fleet_migrate_bytes_total
    accounting unit."""
    n = 0
    for v in blob.values():
        if isinstance(v, np.ndarray):
            n += v.nbytes
        elif isinstance(v, torch.Tensor):
            n += v.numel() * v.element_size()
    return n


def pack_migration_blob(blob: dict) -> bytes:
    """Serialize a migration blob for the wire: magic, a length-prefixed
    JSON header (the scalars and lists), then an npz of the arrays. Keys
    starting with "_" are in-process state (a live incremental
    detokenizer) and are dropped; the unpacker rebuilds them. bf16 ships
    as a uint8 view of its last axis with the dtype name in the header,
    as the JAX package writes it."""
    header, arrays, exotic = {}, {}, {}
    for key, val in blob.items():
        if key.startswith("_"):
            continue
        if isinstance(val, torch.Tensor):
            val = val.detach().cpu().contiguous()
            if val.dtype in _EXOTIC:
                exotic[key] = _EXOTIC[val.dtype]
                val = val.view(torch.uint8)
            arrays[key] = val.numpy()
        elif isinstance(val, np.ndarray):
            if val.dtype.kind not in "biufc":
                raise ValueError(f"cannot ship {key} of dtype {val.dtype}")
            arrays[key] = val
        else:
            header[key] = val
    if exotic:
        header["wire_dtypes"] = exotic
    hdr = json.dumps(header).encode()
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return _WIRE_MAGIC + struct.pack(">I", len(hdr)) + hdr + buf.getvalue()


def unpack_migration_blob(raw: bytes) -> dict:
    """Inverse of pack_migration_blob: numpy arrays, and host tensors for
    the dtypes numpy lacks (bf16). Raises ValueError on a foreign or
    truncated payload (the import route answers 400)."""
    if not raw.startswith(_WIRE_MAGIC):
        raise ValueError("not a migration blob (bad magic)")
    off = len(_WIRE_MAGIC)
    if len(raw) < off + 4:
        raise ValueError("truncated migration blob header")
    (hlen,) = struct.unpack(">I", raw[off:off + 4])
    off += 4
    try:
        blob = json.loads(raw[off:off + hlen])
    except json.JSONDecodeError as e:
        raise ValueError(f"corrupt migration blob header: {e}")
    try:
        with np.load(io.BytesIO(raw[off + hlen:]), allow_pickle=False) as npz:
            for key in npz.files:
                blob[key] = npz[key]
    except (OSError, ValueError, zipfile.BadZipFile) as e:
        raise ValueError(f"corrupt migration blob arrays: {e}")
    for key, name in (blob.pop("wire_dtypes", None) or {}).items():
        dt = _EXOTIC_BY_NAME.get(name)
        if dt is None:
            raise ValueError(f"unknown wire dtype {name!r}")
        if key in blob:
            blob[key] = torch.from_numpy(
                np.ascontiguousarray(blob[key], np.uint8)).view(dt)
    return blob
