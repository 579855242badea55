"""ctypes binding to the native fair-share serving core (cpp/mqcore.cpp).

The same C++ library the JAX package uses: per-user fair-share queues,
VIP/boost, blocklists and smart model matching all live in C++; this
module marshals strings. The admin verbs (VIP, boost, block, unblock)
act on the same core the native admin TUI (cpp/tui.cpp) drives. cpp/libmqcore.so is built with `make -C cpp` the
first time it is needed (not at import).
"""

from __future__ import annotations

import ctypes
import enum
import json
import os
import subprocess
import threading
import time
from typing import Iterable, Optional, Tuple

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_CPP_DIR = os.path.join(_REPO_ROOT, "cpp")
_LIB_PATH = os.path.join(_CPP_DIR, "libmqcore.so")
_BUILD_LOCK = threading.Lock()


class Family(enum.IntEnum):
    UNKNOWN = 0
    OLLAMA = 1
    OPENAI = 2


class Fairness(enum.IntEnum):
    REQUESTS = 0
    TOKENS = 1


def _ensure_built() -> str:
    """cpp/libmqcore.so, built first if missing or older than its
    sources. Processes build it one at a time (a lock file beside it)
    and into a file of their own that then replaces the library in one
    rename, so no process ever opens a library another is writing."""
    import fcntl

    with _BUILD_LOCK:
        if not os.path.isdir(_CPP_DIR):
            raise RuntimeError(
                f"native scheduler core sources not found at {_CPP_DIR}: "
                "run from a checkout of the repository")
        with open(os.path.join(_CPP_DIR, ".libmqcore.lock"), "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            sources = [os.path.join(_CPP_DIR, f) for f in os.listdir(_CPP_DIR)
                       if f.endswith((".cpp", ".h"))]
            stale = not os.path.exists(_LIB_PATH) or any(
                os.path.getmtime(s) > os.path.getmtime(_LIB_PATH)
                for s in sources)
            if stale:
                tmp = f"libmqcore.so.{os.getpid()}.tmp"
                try:
                    subprocess.run(["make", "-C", _CPP_DIR, f"TARGET={tmp}"],
                                   check=True, capture_output=True, text=True)
                    os.replace(os.path.join(_CPP_DIR, tmp), _LIB_PATH)
                finally:
                    if os.path.exists(os.path.join(_CPP_DIR, tmp)):
                        os.remove(os.path.join(_CPP_DIR, tmp))
    return _LIB_PATH


def _load() -> ctypes.CDLL:
    # The JAX package's binding builds the same library in place: a
    # library that is still being written there fails to open, and opens
    # once its build is done.
    for attempt in range(40):
        try:
            lib = ctypes.CDLL(_ensure_built())
            break
        except OSError:
            if attempt == 39:
                raise
            time.sleep(0.25)
    P, S, I, L = ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_int64
    sigs = {
        "mq_new": (P, [S]),
        "mq_destroy": (None, [P]),
        "mq_enqueue_kind": (L, [P, S, S, S, I, I]),
        "mq_requeue_front": (L, [P, S, S, S, I, I]),
        "mq_next2": (L, [P, S, S, S, I, S, I]),
        "mq_cancel": (I, [P, L]),
        "mq_mark_started": (None, [P, S]),
        "mq_mark_done": (None, [P, S, L]),
        "mq_mark_dropped": (None, [P, S, I]),
        "mq_is_user_blocked": (I, [P, S]),
        "mq_is_ip_blocked": (I, [P, S]),
        "mq_is_user_or_ip_blocked": (I, [P, S]),
        "mq_block_version": (L, [P]),
        "mq_total_queued": (L, [P]),
        "mq_queued_matching": (L, [P, S]),
        "mq_snapshot_json": (L, [P, S, L]),
        "mq_reserve_req_ids": (None, [P, L]),
        "mq_block_user": (None, [P, S]),
        "mq_unblock_user": (None, [P, S]),
        "mq_block_ip": (None, [P, S]),
        "mq_unblock_ip": (None, [P, S]),
        "mq_unblock_item": (I, [P, S]),
        "mq_set_vip": (None, [P, S]),
        "mq_set_boost": (None, [P, S]),
        "mq_set_fairness_mode": (None, [P, I]),
        "mq_queue_len": (L, [P, S]),
    }
    for name, (restype, argtypes) in sigs.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    return lib


_lib: Optional[ctypes.CDLL] = None


def _get_lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        _lib = _load()
    return _lib


EMPTY = 0
STUCK = -1
BLOCKED_USER = -1
BLOCKED_IP = -2


class BlockedError(Exception):
    def __init__(self, kind: str, item: str):
        self.kind = kind
        self.item = item
        super().__init__(f"blocked {kind}: {item}")


class StuckQueue(Exception):
    """The policy-selected user's front request can't be served now."""


def _opt(s: Optional[str]):
    return s.encode() if s else None


class MQCore:
    """Per-user fair-share queue core (native)."""

    def __init__(self, blocklist_path: Optional[str] = None):
        self._lib = _get_lib()
        self._h = ctypes.c_void_p(self._lib.mq_new(_opt(blocklist_path)))

    def close(self) -> None:
        if self._h:
            self._lib.mq_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 — interpreter teardown
            pass

    def _check_rid(self, rid: int, user: str, ip: str) -> int:
        if rid == BLOCKED_USER:
            raise BlockedError("user", user)
        if rid == BLOCKED_IP:
            raise BlockedError("ip", ip)
        return rid

    def enqueue(self, user: str, ip: str = "", model: Optional[str] = None,
                family: Family = Family.UNKNOWN, kind: str = "generate") -> int:
        """Returns req_id > 0, or raises BlockedError. `kind` ("generate"
        or "embed") selects the capacity list next_window gates it on."""
        rid = self._lib.mq_enqueue_kind(self._h, user.encode(), ip.encode(),
                                        _opt(model), int(family),
                                        1 if kind == "embed" else 0)
        return self._check_rid(rid, user, ip)

    def requeue_front(self, user: str, ip: str = "", model: Optional[str] = None,
                      family: Family = Family.UNKNOWN,
                      kind: str = "generate") -> int:
        """Return a popped task to the FRONT of its user's queue (a
        preempted or retried request keeps its place in the user's FIFO).
        Returns the fresh req_id, or raises BlockedError."""
        rid = self._lib.mq_requeue_front(self._h, user.encode(), ip.encode(),
                                         _opt(model), int(family),
                                         1 if kind == "embed" else 0)
        return self._check_rid(rid, user, ip)

    def next(self, eligible_models: Optional[Iterable[str]] = None,
             eligible_embed: Optional[Iterable[str]] = None
             ) -> Optional[Tuple[int, str, str]]:
        """Pop per policy: (req_id, user, model), or None when empty.
        Raises StuckQueue if the pick's model isn't servable now.
        `eligible_embed` gates embed-kind tasks apart from generate ones
        (None: one list for both)."""
        return self._next2(eligible_models, eligible_embed)

    def _next2(self, eligible_models, eligible_embed):
        ubuf = ctypes.create_string_buffer(512)
        mbuf = ctypes.create_string_buffer(512)
        em = None if eligible_models is None else "\n".join(eligible_models).encode()
        ee = None if eligible_embed is None else "\n".join(eligible_embed).encode()
        rid = self._lib.mq_next2(self._h, em, ee, ubuf, len(ubuf), mbuf,
                                 len(mbuf))
        if rid == EMPTY:
            return None
        if rid == STUCK:
            raise StuckQueue()
        return rid, ubuf.value.decode(), mbuf.value.decode()

    def next_window(self, k: int,
                    eligible_models: Optional[Iterable[str]] = None,
                    eligible_embed: Optional[Iterable[str]] = None
                    ) -> Tuple[list, bool]:
        """Pop up to k tasks in fair-share order: the candidate window a
        scheduler policy (engine/scheduler.py) may reorder before
        placement. The core still decides WHICH tasks are released; k=1
        is the plain pop-and-place flow. Returns (items, stuck): items
        are (req_id, user, model) tuples; stuck=True means a later pop
        hit an unservable policy pick AFTER the returned items, which
        are dequeued and must still be placed. `eligible_embed` gates
        embed-kind tasks apart from generate ones (None: one list)."""
        models = list(eligible_models) if eligible_models is not None else None
        embed = list(eligible_embed) if eligible_embed is not None else None
        items: list = []
        stuck = False
        for _ in range(max(1, int(k))):
            try:
                item = self._next2(models, embed)
            except StuckQueue:
                stuck = True
                break
            if item is None:
                break
            items.append(item)
        return items, stuck

    def cancel(self, req_id: int) -> bool:
        return bool(self._lib.mq_cancel(self._h, req_id))

    def reserve_req_ids(self, min_next: int) -> None:
        """Advance the request-id counter to at least `min_next`."""
        self._lib.mq_reserve_req_ids(self._h, int(min_next))

    def mark_started(self, user: str) -> None:
        self._lib.mq_mark_started(self._h, user.encode())

    def mark_done(self, user: str, tokens: int = 0) -> None:
        self._lib.mq_mark_done(self._h, user.encode(), tokens)

    def mark_dropped(self, user: str, started: bool = True) -> None:
        self._lib.mq_mark_dropped(self._h, user.encode(), int(started))

    # -- admin -------------------------------------------------------------
    def block_user(self, user: str) -> None:
        self._lib.mq_block_user(self._h, user.encode())

    def unblock_user(self, user: str) -> None:
        self._lib.mq_unblock_user(self._h, user.encode())

    def block_ip(self, ip: str) -> None:
        self._lib.mq_block_ip(self._h, ip.encode())

    def unblock_ip(self, ip: str) -> None:
        self._lib.mq_unblock_ip(self._h, ip.encode())

    def unblock_item(self, item: str) -> bool:
        """Unblock a user or an IP by name; True if it was blocked."""
        return bool(self._lib.mq_unblock_item(self._h, item.encode()))

    def set_vip(self, user: Optional[str]) -> None:
        self._lib.mq_set_vip(self._h, _opt(user))

    def set_boost(self, user: Optional[str]) -> None:
        self._lib.mq_set_boost(self._h, _opt(user))

    def set_fairness(self, mode: Fairness) -> None:
        self._lib.mq_set_fairness_mode(self._h, int(mode))

    def is_user_blocked(self, user: str) -> bool:
        return bool(self._lib.mq_is_user_blocked(self._h, user.encode()))

    def is_ip_blocked(self, ip: str) -> bool:
        return bool(self._lib.mq_is_ip_blocked(self._h, ip.encode()))

    def is_user_or_ip_blocked(self, user: str) -> bool:
        """Blocked directly or via the user's last recorded IP."""
        return bool(self._lib.mq_is_user_or_ip_blocked(self._h, user.encode()))

    def block_version(self) -> int:
        return int(self._lib.mq_block_version(self._h))

    def queue_len(self, user: str) -> int:
        return int(self._lib.mq_queue_len(self._h, user.encode()))

    def total_queued(self) -> int:
        return int(self._lib.mq_total_queued(self._h))

    def queued_matching(self, model: str) -> int:
        """Queued tasks `model` could serve (empty-model tasks count)."""
        return int(self._lib.mq_queued_matching(self._h, model.encode()))

    def snapshot(self) -> dict:
        """The core's state as a dict. The JSON can grow between the size
        query and the copy (another thread enqueues for a new user), and
        the core then copies nothing: retry at the size it reports."""
        need = self._lib.mq_snapshot_json(self._h, None, 0)
        while True:
            buf = ctypes.create_string_buffer(need + 16)
            need = self._lib.mq_snapshot_json(self._h, buf, len(buf))
            if need < len(buf):
                return json.loads(buf.value.decode())
