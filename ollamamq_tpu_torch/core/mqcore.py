"""ctypes binding to the native fair-share serving core (cpp/mqcore.cpp).

The same C++ library the JAX package uses: per-user fair-share queues,
VIP/boost, blocklists and smart model matching all live in C++; this
module marshals strings. cpp/libmqcore.so is built with `make -C cpp` the
first time it is needed (not at import).
"""

from __future__ import annotations

import ctypes
import enum
import json
import os
import subprocess
import threading
from typing import Iterable, Optional, Tuple

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_CPP_DIR = os.path.join(_REPO_ROOT, "cpp")
_LIB_PATH = os.path.join(_CPP_DIR, "libmqcore.so")
_BUILD_LOCK = threading.Lock()


class Family(enum.IntEnum):
    UNKNOWN = 0
    OLLAMA = 1
    OPENAI = 2


def _ensure_built() -> str:
    with _BUILD_LOCK:
        if not os.path.isdir(_CPP_DIR):
            raise RuntimeError(
                f"native scheduler core sources not found at {_CPP_DIR}: "
                "run from a checkout of the repository")
        sources = [os.path.join(_CPP_DIR, f) for f in os.listdir(_CPP_DIR)
                   if f.endswith((".cpp", ".h"))]
        stale = not os.path.exists(_LIB_PATH) or any(
            os.path.getmtime(s) > os.path.getmtime(_LIB_PATH) for s in sources)
        if stale:
            subprocess.run(["make", "-C", _CPP_DIR], check=True,
                           capture_output=True, text=True)
    return _LIB_PATH


def _load() -> ctypes.CDLL:
    lib = ctypes.CDLL(_ensure_built())
    P, S, I, L = ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_int64
    sigs = {
        "mq_new": (P, [S]),
        "mq_destroy": (None, [P]),
        "mq_enqueue_kind": (L, [P, S, S, S, I, I]),
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
                family: Family = Family.UNKNOWN) -> int:
        """Returns req_id > 0, or raises BlockedError."""
        rid = self._lib.mq_enqueue_kind(self._h, user.encode(), ip.encode(),
                                        _opt(model), int(family), 0)
        return self._check_rid(rid, user, ip)

    def next(self, eligible_models: Optional[Iterable[str]] = None
             ) -> Optional[Tuple[int, str, str]]:
        """Pop per policy: (req_id, user, model), or None when empty.
        Raises StuckQueue if the pick's model isn't servable now."""
        ubuf = ctypes.create_string_buffer(512)
        mbuf = ctypes.create_string_buffer(512)
        em = None if eligible_models is None else "\n".join(eligible_models).encode()
        rid = self._lib.mq_next2(self._h, em, None, ubuf, len(ubuf), mbuf,
                                 len(mbuf))
        if rid == EMPTY:
            return None
        if rid == STUCK:
            raise StuckQueue()
        return rid, ubuf.value.decode(), mbuf.value.decode()

    def cancel(self, req_id: int) -> bool:
        return bool(self._lib.mq_cancel(self._h, req_id))

    def mark_started(self, user: str) -> None:
        self._lib.mq_mark_started(self._h, user.encode())

    def mark_done(self, user: str, tokens: int = 0) -> None:
        self._lib.mq_mark_done(self._h, user.encode(), tokens)

    def mark_dropped(self, user: str, started: bool = True) -> None:
        self._lib.mq_mark_dropped(self._h, user.encode(), int(started))

    def is_user_blocked(self, user: str) -> bool:
        return bool(self._lib.mq_is_user_blocked(self._h, user.encode()))

    def is_ip_blocked(self, ip: str) -> bool:
        return bool(self._lib.mq_is_ip_blocked(self._h, ip.encode()))

    def is_user_or_ip_blocked(self, user: str) -> bool:
        """Blocked directly or via the user's last recorded IP."""
        return bool(self._lib.mq_is_user_or_ip_blocked(self._h, user.encode()))

    def block_version(self) -> int:
        return int(self._lib.mq_block_version(self._h))

    def total_queued(self) -> int:
        return int(self._lib.mq_total_queued(self._h))

    def queued_matching(self, model: str) -> int:
        """Queued tasks `model` could serve (empty-model tasks count)."""
        return int(self._lib.mq_queued_matching(self._h, model.encode()))

    def snapshot(self) -> dict:
        need = self._lib.mq_snapshot_json(self._h, None, 0)
        buf = ctypes.create_string_buffer(need + 16)
        self._lib.mq_snapshot_json(self._h, buf, len(buf))
        return json.loads(buf.value.decode())
