"""Crash-safe serving: durable admission WAL + cold-restart recovery.

`--wal-dir` layers a write-ahead request log on the serving front-end:
every accepted generation request is
durably recorded — prompt token ids, user, sampling params, request id —
with batched fsync BEFORE the enqueue is ACKed to the client, and every
emitted token is appended behind it, so a `kill -9` of the serving
process loses at most one fsync window of progress and NO admitted
request. On the next start a recovery pass replays the WAL: unfinished
requests are re-admitted token-exact (the Ollama `context` re-prefill
path with generated_ids pre-filled), journaled as `recover_replay`, and
disconnected clients reattach with `GET /api/stream/{req_id}?from=N` to
receive the remainder byte- and token-identical to an uninterrupted run.

The fallback ladder only ever extends: migration -> recompute replay ->
WAL recovery -> explicit error. Never a silent drop.
"""

from ollamamq_tpu_torch.durability.manager import DurabilityManager, StreamEntry
from ollamamq_tpu_torch.durability.wal import RequestWAL, load_wal_records

__all__ = ["DurabilityManager", "RequestWAL", "StreamEntry",
           "load_wal_records"]
