"""Request objects and token streams.

A Request is the engine-side unit of work: tokenized prompt, sampling
options, and a thread-safe TokenStream the engine thread pushes into and
the HTTP handler thread reads from.
"""

from __future__ import annotations

import dataclasses
import enum
import queue
import threading
import time
from typing import List, Optional, Sequence

from ollamamq_tpu_torch.ops.sampling import SamplingParams


class FinishReason(str, enum.Enum):
    STOP = "stop"          # EOS token or stop string
    LENGTH = "length"      # max_tokens or context budget hit
    CANCELLED = "cancelled"  # client disconnected / admin drop
    ERROR = "error"
    KV_EXHAUSTED = "kv_exhausted"  # decode-time page-pool exhaustion
    DEADLINE = "deadline"          # per-request deadline expired


# Terminal reasons delivered to the client as an "error" stream item.
ERROR_REASONS = (FinishReason.ERROR, FinishReason.KV_EXHAUSTED,
                 FinishReason.DEADLINE)


@dataclasses.dataclass
class StreamItem:
    kind: str  # "token" | "done" | "error"
    text: str = ""
    token_id: int = -1
    finish_reason: Optional[FinishReason] = None
    error: str = ""


class TokenStream:
    """Thread-safe bounded token channel, engine thread -> consumer.

    The engine thread never blocks on a slow consumer: a full queue marks
    the stream overflowed, which the engine treats as a disconnect;
    terminal items always get through (one token is shed for them).
    """

    def __init__(self, maxsize: int = 1024):
        self._q: "queue.Queue[StreamItem]" = queue.Queue(maxsize=maxsize)
        self._closed = False
        self.overflowed = False

    def push(self, item: StreamItem) -> None:
        if self._closed:
            return
        terminal = item.kind in ("done", "error")
        try:
            self._q.put_nowait(item)
        except queue.Full:
            if not terminal:
                self.overflowed = True
                return
            try:
                self._q.get_nowait()
            except queue.Empty:
                pass
            try:
                self._q.put_nowait(item)
            except queue.Full:
                pass
        if terminal:
            self._closed = True

    def get(self, timeout: Optional[float] = None) -> Optional[StreamItem]:
        try:
            return self._q.get(timeout=timeout)
        except queue.Empty:
            return None


@dataclasses.dataclass
class RequestStats:
    enqueued_at: float = dataclasses.field(default_factory=time.monotonic)
    first_token_at: float = 0.0
    finished_at: float = 0.0
    prompt_tokens: int = 0
    completion_tokens: int = 0

    @property
    def total_duration_s(self) -> float:
        end = self.finished_at or time.monotonic()
        return end - self.enqueued_at


class Request:
    """One generation request flowing through the engine."""

    def __init__(
        self,
        req_id: int,
        user: str,
        model: str,
        prompt_tokens: Sequence[int],
        sampling: Optional[SamplingParams] = None,
    ):
        self.req_id = req_id
        self.user = user
        self.model = model
        self.prompt_tokens = list(prompt_tokens)
        self.sampling = sampling or SamplingParams()
        self.stream = TokenStream()
        self.stats = RequestStats(prompt_tokens=len(self.prompt_tokens))
        self.cancelled = threading.Event()
        dm = float(getattr(self.sampling, "deadline_ms", 0.0) or 0.0)
        self.deadline = (self.stats.enqueued_at + dm / 1e3) if dm > 0 else None
        # True once the fair-share core counted this request as started.
        self.started = False
        # Incremental detokenizer, attached at runtime submit.
        self._inc_decode = None
        # Generation state (engine-owned):
        self.generated_ids: List[int] = []
        self.emitted_len = 0  # chars of detok text already pushed
        self._detok_text = ""

    def emit_text(self, new_text: str) -> Optional[str]:
        """Accumulate detokenized text, honoring stop strings with
        hold-back. Returns the safe-to-emit chunk (may be ""), or None if
        a stop string fired (the caller finishes with reason=STOP)."""
        self._detok_text += new_text
        stops = self.sampling.stop
        if stops:
            for s in stops:
                idx = self._detok_text.find(s)
                if idx != -1:
                    chunk = self._detok_text[self.emitted_len:idx]
                    self.emitted_len = idx
                    if chunk:
                        self.stream.push(StreamItem("token", text=chunk))
                    return None
            holdback = max(len(s) for s in stops) - 1
        else:
            holdback = 0
        safe_end = len(self._detok_text) - holdback
        if safe_end > self.emitted_len:
            chunk = self._detok_text[self.emitted_len:safe_end]
            self.emitted_len = safe_end
            return chunk
        return ""

    def flush_text(self) -> str:
        """Emit any held-back text (at finish, when no stop matched)."""
        chunk = self._detok_text[self.emitted_len:]
        self.emitted_len = len(self._detok_text)
        return chunk

    def expired(self, now: Optional[float] = None) -> bool:
        """True when the request's deadline has passed."""
        if self.deadline is None:
            return False
        return (now if now is not None else time.monotonic()) >= self.deadline

    def finish(self, reason: FinishReason, error: str = "") -> None:
        self.stats.finished_at = time.monotonic()
        kind = "error" if reason in ERROR_REASONS else "done"
        self.stream.push(StreamItem(kind, finish_reason=reason, error=error))
