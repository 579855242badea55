"""Tensor- and pipeline-parallel serving over ranks: one engine, many
processes.

The JAX package runs one SPMD program: params and KV pools are sharded
over a mesh and each jitted step runs on every host's shard. Here each
rank of the mesh (parallel/mesh.py) is a process holding its slice of
the weights and KV pool (its heads, and under pp its stage's layers),
and each forward calls its collectives and hand-offs itself
(models/llama.py, parallel/pipeline.py). Rank 0 owns the scheduler, the HTTP front and every
admission decision. Before every device step it ships a "step plan" —
a fixed-shape header (opcode + static dims + routing ordinals) plus the
op payload (token ids, page tables, sampling params and the raw state
of the engine generator the step's unseeded draws consume) — over the
coordinator's TCPStore as a monotonic key stream (`_Wire`). Workers sit
in `run_worker`, long-poll the stream, and issue the SAME dispatch with
their own shards. Every value feeding the computation travels on the
wire, never recomputed locally, so all ranks run identical steps and
sample identical ids from identical full logits. The control plane is
deliberately the store, not a device collective: a broadcast would share
the transport with the model's collectives, and any reordering between
the two corrupts it; store traffic cannot.

Opcode header (int32[5]: [op, a, b, model_ordinal, replica_ordinal]),
the JAX package's numbers:
    OP_SHUTDOWN = 0              -> workers report and exit (no payload)
    OP_PREFILL  = 1, a=bucket, b=B (bucketed prefill of the pp > 1 path)
    OP_CHUNK    = 2, a=chunk     (one chunk of a long prompt, pp > 1)
    OP_DECODE   = 3, a=k_steps   (fused decode steps of every slot)
    OP_ENCODE   = 4, a=B, b=bucket (embedding batch forward, stateless)
    OP_PREFILL_SP = 5, a=T       (one long prompt's sequence-parallel
                                    prefill: every rank of the replica
                                    runs its shard of the ring)
    OP_RELOAD   = 6              -> rebuild runtime [mi][ri] from pristine
                                    config (failure recovery)
    OP_LOAD     = 7, a=n_replicas; payload carries (name, ckpt) strings
                                    (runtime /api/pull on every rank)
    OP_EVICT    = 8; payload carries name (runtime /api/delete)
    OP_EMBED    = 9, a=B, b=bucket (embed batch on a GENERATIVE runtime)
    OP_RAGGED   = 10, a=T_pad      (ragged mixed batch: prefill spans +
                                    decode rows in one flattened stream)
    OP_SPEC     = 11, a=T_pad, b=k_cap (the ragged payload plus the
                                    per-row is_spec flag)

Data parallelism over ranks: on a mesh with a data axis each replica is
its own (pipe x tensor) sub-grid of ranks (parallel/mesh.py
replica_submesh), and the header's replica_ordinal routes each data op
to one replica. In the JAX package every process takes part in every
replica; here the ranks of replica r > 0 do not include rank 0. Rank 0
keeps the host state of every replica (slots, pages, prefix cache and
the generator whose state the plan carries) and computes replica 0
only. For r > 0 it ships the plan, the replica's ranks replay it, and
the replica's first rank posts the output, its status and the
generator's state after the op under `ollamamq/res/<wire seq>`, where
rank 0's collect reads them (SPMDRemoteRuntime). A worker replays only
its own replica's data ops and applies every control op (LOAD, EVICT,
RELOAD, SHUTDOWN), so the ordinal tables stay aligned on every rank.

Desync detection: after every replayed op, the ranks that ran it
exchange a status flag OUT-OF-BAND via the store (`_Plane.status_sync`), a
host-side barrier that cannot deadlock behind the very computation
whose failure it reports; control ops sync every rank. A worker whose
replay failed has diverged KV state, so the primary fails the runtime
LOUDLY (its requests end with an error) and the recovery path
broadcasts OP_RELOAD, rebuilding it on every rank of its replica. The
sync is one small store round-trip per dispatch;
OLLAMAMQ_SPMD_STATUS_EVERY=N syncs every Nth data op instead.
Liveness: every rank bumps a heartbeat key (`_Plane.start_heartbeat`); a rank
whose heartbeat stops changing for OLLAMAMQ_SPMD_HB_STALE seconds is
presumed dead, so a sync or a result wait on it raises PeerDeadError
within that bound (only the waits of its own replica: a dead rank of
replica 1 fails replica 1's requests and leaves replica 0 serving), and
a collective waiting on it fails at the process group's timeout at the
latest.

Worlds and sessions: the wire, the sync buses, the replicas' ranks, the
op trace and the heartbeat are one world's (`_Plane`). A worker rank and
a lone engine use the process's plane, over its default world; a fleet
router leads one plane per member wider than one rank
(fleet/wide.py), picked by the runtime's mesh (`_plane_for`). An engine
and its workers' run_worker each start a session of their world's wire
(`_Plane.reset`), whose keys are its own, so one world can serve one
engine after another.

Metrics: every rank but rank 0 posts its registry's snapshot under
`ollamamq/metrics/<rank>` on every heartbeat, and once more when its op
stream goes idle (`_recv_op`). Rank 0's /metrics merges the other ranks'
snapshots (`SPMDEngine.worker_metric_snapshots`), so one scrape covers
the world. A worker records no steps of its own: the leader's step
profiler counts each step of the world once.
"""

from __future__ import annotations

import datetime
import hashlib
import io
import json
import logging
import os
import threading
import time
import weakref
from typing import Optional

import numpy as np
import torch

from ollamamq_tpu_torch.config import EngineConfig
from ollamamq_tpu_torch.engine import kv_cache as kvc
from ollamamq_tpu_torch.engine.engine import (EncoderRuntime, ModelRuntime,
                                              PeerDeadError, ReplicaSet,
                                              TorchEngine, WorkerDesyncError,
                                              chip_stats)
from ollamamq_tpu_torch.models import weights
from ollamamq_tpu_torch.ops.quant import nbytes
from ollamamq_tpu_torch.parallel import distributed
from ollamamq_tpu_torch.parallel.mesh import replica_of, replica_ranks
from ollamamq_tpu_torch.telemetry.metrics import REGISTRY

log = logging.getLogger("ollamamq.torch.spmd")

OP_SHUTDOWN = 0
OP_PREFILL = 1  # a=bucket, b=B: bucketed prefill (the pp > 1 path)
OP_CHUNK = 2  # a=chunk: one chunk of a long prompt (the pp > 1 path)
OP_DECODE = 3
OP_ENCODE = 4
OP_PREFILL_SP = 5  # a=T: one long prompt's sequence-parallel prefill
OP_RELOAD = 6
OP_LOAD = 7
OP_EVICT = 8
OP_EMBED = 9  # a=B, b=bucket: embed batch on a GENERATIVE runtime
OP_RAGGED = 10  # a=T_pad: ragged mixed batch (prefill spans + decode rows)
OP_SPEC = 11  # a=T_pad, b=k_cap: ragged mixed batch + speculative spans

# A worker posts its metrics once its op stream has been quiet this long.
IDLE_PUBLISH_S = 0.2

NAME_LEN = 128  # utf-8 bytes, zero-padded, for OP_LOAD/OP_EVICT names
PATH_LEN = 256  # utf-8 bytes for checkpoint paths ("" = None)
DATA_OPS = (OP_PREFILL, OP_CHUNK, OP_DECODE, OP_PREFILL_SP, OP_ENCODE, OP_EMBED,
            OP_RAGGED, OP_SPEC)


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except ValueError:
        return default


def _status_every() -> int:
    # Clamped to bound the failure-detection delay.
    return min(256, max(1, int(_env_float("OLLAMAMQ_SPMD_STATUS_EVERY", 1))))


def _status_timeout_s() -> float:
    return _env_float("OLLAMAMQ_SPMD_STATUS_TIMEOUT", 900.0)


def _hb_every() -> float:
    return _env_float("OLLAMAMQ_SPMD_HB_EVERY", 3.0)


def _hb_stale() -> float:
    return _env_float("OLLAMAMQ_SPMD_HB_STALE", 10.0)


def _client():
    return distributed.store()


def _is_deadline(e: Exception) -> bool:
    return (isinstance(e, torch.distributed.DistStoreError)
            and "timeout" in str(e).lower())


def _try_get(client, key: str) -> Optional[str]:
    return client.get(key).decode() if client.check([key]) else None


def _wait_get(client, key: str, seconds: float) -> bytes:
    """The value of `key` once it exists; DistStoreError on a timeout."""
    client.wait([key], datetime.timedelta(seconds=seconds))
    return client.get(key)


class _HeartbeatMonitor:
    """Peer liveness from the store, clock-skew-free: a peer is stale
    when ITS heartbeat value has not changed for > _hb_stale() seconds of
    OUR monotonic clock (never compares cross-host timestamps). A peer
    that has never written a heartbeat is treated as alive: liveness is
    opt-in per rank, so a starting deployment can't false-positive."""

    def __init__(self, plane: Optional["_Plane"] = None):
        self._seen = {}  # rank -> (value, first observed at, our clock)
        self.plane = plane  # whose store it reads (None: this process's)

    def observe(self, pid: int, value: Optional[str], now: float) -> bool:
        """Record one reading; returns True if the peer is stale."""
        if value is None:
            return False
        prev = self._seen.get(pid)
        if prev is None or prev[0] != value:
            self._seen[pid] = (value, now)
            return False
        return (now - prev[1]) > _hb_stale()

    def stale_peers(self, pids) -> list:
        client = (self.plane or _plane).client()
        now = time.monotonic()
        out = []
        for pid in pids:
            try:
                v = _try_get(client, f"ollamamq/hb/{pid}")
            except Exception:  # noqa: BLE001 — unreadable: never written
                v = None
            if self.observe(pid, v, now):
                out.append(pid)
        return out


def _encode_str(s: Optional[str], n: int) -> np.ndarray:
    raw = (s or "").encode("utf-8")
    if len(raw) > n:
        raise ValueError(f"string too long for SPMD wire field ({len(raw)} > {n})")
    out = np.zeros((n,), np.int32)
    out[: len(raw)] = np.frombuffer(raw, np.uint8)
    return out


def _decode_str(arr) -> str:
    b = bytes(int(x) for x in np.asarray(arr).tolist() if int(x) != 0)
    return b.decode("utf-8")


def payload_spec(op, a, b, S, MP, W, K):
    """[(shape, dtype), ...] for an opcode's payload — the ONE place the
    wire order lives. Senders cast their positional values to this spec;
    workers decode with it. `W` is the repeat-penalty window (a first
    span's ring seed row), `K` the byte length of the engine generator's
    state (the step's `key`: what its unseeded draws consume)."""

    def samp(n):  # temp, top_k, top_p, repeat, presence, frequency, seed
        return [((n,), np.float32), ((n,), np.int32), ((n,), np.float32),
                ((n,), np.float32), ((n,), np.float32), ((n,), np.float32),
                ((n,), np.int32)]

    key = [((K,), np.uint8)]
    if op == OP_PREFILL:
        bucket, B = a, b
        # tokens, lens, slot_ids, page tables
        return [((B, bucket), np.int32), ((B,), np.int32), ((B,), np.int32),
                ((B, MP), np.int32)] + samp(B) + key
    if op == OP_CHUNK:
        # tokens, start, chunk_len, slot, is_final, is_first, seed_row, pt
        return [((1, a), np.int32), ((1,), np.int32), ((1,), np.int32),
                ((1,), np.int32), ((1,), np.int32), ((1,), np.int32),
                ((1, W), np.int32),
                ((1, MP), np.int32)] + samp(1) + key
    if op == OP_DECODE:
        # last tokens, positions, active mask, page table
        return [((S,), np.int32), ((S,), np.int32), ((S,), np.int32),
                ((S, MP), np.int32)] + samp(S) + key
    if op == OP_PREFILL_SP:
        # tokens padded to T, lens, slot id, page-table row
        return [((1, a), np.int32), ((1,), np.int32), ((1,), np.int32),
                ((1, MP), np.int32)] + samp(1) + key
    if op == OP_RAGGED:
        T = a
        # tokens, tok_seq, tok_pos, write_slots; then per-sequence
        # q_start, q_len, kv_len, ring_len, is_first, append, slot_ids,
        # seed_rows, page tables, sampling, key.
        return ([((T,), np.int32)] * 4
                + [((S,), np.int32)] * 7
                + [((S, W), np.int32), ((S, MP), np.int32)]
                + samp(S) + key)
    if op == OP_SPEC:
        # The RAGGED payload plus the per-row is_spec flag (the seventh
        # [S] vector, after append / before slot_ids); k_cap rides the
        # header's b.
        T = a
        return ([((T,), np.int32)] * 4
                + [((S,), np.int32)] * 8
                + [((S, W), np.int32), ((S, MP), np.int32)]
                + samp(S) + key)
    if op in (OP_ENCODE, OP_EMBED):
        B, bucket = a, b
        return [((B, bucket), np.int32), ((B,), np.int32)]
    if op in (OP_RELOAD, OP_SHUTDOWN):
        return []
    if op == OP_LOAD:
        return [((NAME_LEN,), np.int32), ((PATH_LEN,), np.int32)]
    if op == OP_EVICT:
        return [((NAME_LEN,), np.int32)]
    raise ValueError(f"no payload spec for opcode {op}")


class _Wire:
    """Primary→worker op stream over the coordinator's store.

    Keys are `ollamamq/op/<seq>`: the primary writes them monotonically;
    each worker long-polls its own cursor. Cleanup horizon: workers
    process the stream serially and every completed status barrier of
    every rank sits at a deterministic position in it, so when such a
    barrier completes on the primary, every worker has consumed ALL ops
    sent before it — keys below that barrier's send-seq are safe to
    delete. With data-parallel replicas most barriers cover one replica,
    so workers also post their cursor (`ollamamq/cursor/<rank>`) every
    CURSOR_EVERY ops and the primary takes the least of them."""

    def __init__(self):
        self.seq = 0
        # All keys < consumed have been read by every worker (set at each
        # completed barrier); keys < deleted are already removed.
        self.consumed = 0
        self.deleted = 0


_HDR = 5 * 4  # int32[5] header bytes
CURSOR_EVERY = 32  # ops between a worker's cursor posts (dp > 1)


def _pack_payload(cast) -> bytes:
    if not cast:
        return b""
    return b"".join(np.ascontiguousarray(v).tobytes() for v in cast)


def _unpack_payload(raw: bytes, spec):
    out = []
    off = 0
    for shape, dt in spec:
        nb = int(np.prod(shape)) * np.dtype(dt).itemsize
        out.append(np.frombuffer(raw[off:off + nb], dt).reshape(shape))
        off += nb
    if off != len(raw):
        raise ValueError(f"payload of {len(raw)} bytes, spec wants {off}")
    return tuple(out)


class _Plane:
    """One rank world's control plane as this process drives it: the
    world's store, its op stream (`_Wire`), its status-sync buses, the
    ranks of each replica of its mesh (`layout`: [[every rank]] at dp 1),
    this rank's op trace and its heartbeat. Worker ranks and a lone
    engine use the process's plane (`_plane`, over distributed's default
    world); a fleet router leads one plane per member wider than one
    rank (`_plane_for` its mesh's world), so the members' step plans,
    syncs and liveness never mix."""

    def __init__(self, world=None):
        self.world = world  # None: this process's default world
        self.hb = _HeartbeatMonitor(self)
        self._hb_stop = threading.Event()
        self._publish_lock = threading.Lock()
        self.session = 0
        self._sessions = 0  # resets so far in the world `_counted`
        self._counted = None
        self._fresh(None)

    def reset(self, mesh=None) -> None:
        """A fresh op stream and barrier ordinals for the next session of
        this world (an engine and its workers' run_worker, which reset
        once each, in step): its wire starts at 0 on every rank, under
        keys of its own (`key`), so a world that serves one engine after
        another never reads an earlier session's ops or syncs. `mesh`
        gives the replicas' ranks (none: one replica of every rank)."""
        world = self.world or distributed.default_world()
        if world is not self._counted:  # a new world counts from 0
            self._counted, self._sessions = world, 0
        self.session = self._sessions
        self._sessions += 1
        self._fresh(mesh)

    def _fresh(self, mesh) -> None:
        self.wire = _Wire()
        self.bus = _SyncBus(plane=self)
        self.layout = ([replica_ranks(mesh, r) for r in range(mesh.dp)]
                       if mesh is not None and mesh.dp > 1 else [None])
        self.buses: dict = {}
        self.trace = _OpTrace(self)

    def key(self, name: str) -> str:
        """The store key of `name` (op/<seq>, st/..., res/<seq>, ...) in
        this session; liveness keys (hb, chips, dev) have no session."""
        return (f"ollamamq/{name}" if self.session == 0
                else f"ollamamq/s{self.session}/{name}")

    def client(self):
        """This thread's client of the world's store."""
        return self.world.store() if self.world is not None else _client()

    @property
    def rank(self) -> int:
        return self.world.rank if self.world is not None else distributed.rank()

    @property
    def size(self) -> int:
        return (self.world.size if self.world is not None
                else distributed.world_size())

    @property
    def device(self):
        return (self.world.device if self.world is not None
                else distributed.device())

    def data_bus(self, replica: int) -> "_SyncBus":
        """The sync bus of replica `replica`'s data ops: the control bus
        at dp 1 (every rank runs every op), else the replica's own."""
        if len(self.layout) == 1:
            return self.bus
        if replica not in self.buses:
            self.buses[replica] = _SyncBus(f"r{replica}", self.layout[replica],
                                           plane=self)
        return self.buses[replica]

    def start_heartbeat(self) -> None:
        """Advertise this rank's liveness (`ollamamq/hb/<rank>`, bumped
        every _hb_every() seconds), its device rows
        (`ollamamq/chips/<rank>`) and, on ranks other than 0, its
        metrics (`publish_metrics`), so peers stop waiting on us within
        ~_hb_stale() s of our death instead of the full status-sync
        timeout."""
        pid, stop = self.rank, self._hb_stop
        stop.clear()

        def run():
            client = self.client()  # this thread's own connection
            n = 0
            while not stop.is_set():
                try:
                    client.set(f"ollamamq/hb/{pid}", str(n))
                    dev = self.device
                    rows = chip_stats(dev) if dev is not None else []
                    for row in rows:
                        row["process"] = pid
                    client.set(f"ollamamq/chips/{pid}", json.dumps(rows))
                    if pid != 0:  # rank 0's registry is the one scraped
                        self.publish_metrics(client)
                except Exception:  # noqa: BLE001 — coordinator gone: exiting
                    return
                n += 1
                stop.wait(_hb_every())

        threading.Thread(target=run, daemon=True, name="spmd-heartbeat").start()

    def publish_metrics(self, client=None) -> None:
        """Post this process's registry snapshot under
        `ollamamq/metrics/<rank>` for rank 0's /metrics. One post at a
        time, so a later post never carries an older snapshot."""
        client = client or self.client()
        with self._publish_lock:
            client.set(f"ollamamq/metrics/{self.rank}", REGISTRY.snapshot_json())

    def stop_heartbeat(self) -> None:
        self._hb_stop.set()

    def wait_polled(self, client, key: str, ranks, what: str) -> bytes:
        """The value of `key` once it exists, waiting in short polls
        between which the heartbeats of `ranks` (other than this one) are
        checked: a rank that died surfaces as PeerDeadError in
        ~_hb_stale() s instead of blocking for
        OLLAMAMQ_SPMD_STATUS_TIMEOUT."""
        pid = self.rank
        deadline = time.monotonic() + _status_timeout_s()
        poll = min(2.0, max(0.2, _hb_stale() / 4))
        while True:
            try:
                return _wait_get(client, key, poll)
            except Exception as e:
                if not _is_deadline(e):
                    raise
                dead = self.hb.stale_peers([p for p in ranks if p != pid])
                if dead:
                    raise PeerDeadError(
                        f"rank(s) {dead} heartbeat went stale at {what}: "
                        "presumed dead; failing in-flight work loudly") from None
                if time.monotonic() > deadline:
                    raise

    def status_sync(self, ok: bool, seq: int, domain: str = "all",
                    ranks=None) -> np.ndarray:
        """Exchange one ok/fail flag per rank of `ranks` (default: every
        rank) via the store; returns int32[world] (1 = that rank's op
        failed; 0 for ranks outside the sync). Host-side only: the
        failure being reported may be a computation one side issued and
        the other didn't, so the report must never be a device
        collective. Every rank of the sync calls this at the same point
        in the op stream (`seq` is the shared ordinal of the sync's
        `domain`: every rank for control ops, a replica's ranks for its
        data ops). A POLLED barrier (wait_polled): a dead rank of the
        sync raises PeerDeadError."""
        client = self.client()
        n, pid = self.size, self.rank
        ranks = list(range(n)) if ranks is None else list(ranks)
        client.set(self.key(f"st/{domain}/{seq}/{pid}"), "ok" if ok else "fail")
        flags = np.zeros(n, np.int32)
        for i in ranks:
            v = self.wait_polled(client, self.key(f"st/{domain}/{seq}/{i}"),
                                 ranks, f"sync {domain}/{seq}").decode()
            flags[i] = 0 if v == "ok" else 1
        # Everyone passed the PREVIOUS sync before writing this sync's
        # key, so our previous-sync key has been read by all: safe to
        # clean up.
        if seq > 0:
            try:
                client.delete_key(self.key(f"st/{domain}/{seq - 1}/{pid}"))
            except Exception:  # noqa: BLE001
                pass
        return flags

    def send(self, op, a, b, index, replica, values, S, MP, W, K) -> None:
        """Post one op (header + payload) on the wire."""
        spec = payload_spec(op, a, b, S, MP, W, K)
        assert len(values) == len(spec)
        cast = []
        for v, (shape, dt) in zip(values, spec):
            v = np.asarray(v, dt)
            # Shape drift would desync the wire decode on workers with an
            # opaque error; fail at the send site instead.
            assert v.shape == shape, (op, v.shape, shape)
            cast.append(v)
        header = np.asarray([op, a, b, index, replica], np.int32).tobytes()
        wire = self.wire
        client = self.client()
        client.set(self.key(f"op/{wire.seq}"), header + _pack_payload(cast))
        wire.seq += 1
        if len(self.layout) > 1 and wire.seq % (2 * CURSOR_EVERY) == 0:
            wire.consumed = max(wire.consumed, self.workers_cursor(client))
        # Reclaim keys every worker has provably consumed (barrier horizon).
        while wire.deleted < wire.consumed:
            try:
                client.delete_key(self.key(f"op/{wire.deleted}"))
            except Exception:  # noqa: BLE001
                pass
            wire.deleted += 1

    def workers_cursor(self, client) -> int:
        """The least op cursor the workers posted (0 until each has). The
        ranks of a replica with a rank whose heartbeat went stale are left
        out: a rank presumed dead replays nothing more (its replica's live
        ranks fail their next sync on it and exit), and their frozen
        cursors would keep every later op key in the store for as long as
        the other replicas serve."""
        world = self.size
        dead = set(self.hb.stale_peers(range(1, world)))
        gone = {p for ranks in self.layout if dead & set(ranks) for p in ranks}
        live = [p for p in range(1, world) if p not in gone]
        if not live:
            return self.wire.seq
        keys = [self.key(f"cursor/{p}") for p in live]
        try:
            if not client.check(keys):
                return 0
            return min(int(v) for v in client.multi_get(keys))
        except Exception:  # noqa: BLE001 — the horizon only waits
            return 0

    def broadcast_shutdown(self) -> None:
        """Release the worker ranks. Sent exactly ONCE per deployment (the
        worker loop exits on the first shutdown header)."""
        if self.size > 1:
            self.send(OP_SHUTDOWN, 0, 0, 0, 0, (), 0, 0, 0, 0)


def _send(op, a, b, index, replica, values, S, MP, W, K):
    _plane.send(op, a, b, index, replica, values, S, MP, W, K)


def _recv_op(seq: int, timeout_s: float = 10.0):
    """Worker side: block for op `seq`; returns (header int32[5], raw
    payload bytes). Retries on poll timeout (an idle engine sends nothing
    for arbitrarily long), but a primary whose heartbeat went stale will
    never send again: exit loudly instead of idling forever. A store
    that is gone (the primary exited) raises at once. When the op has
    not come within IDLE_PUBLISH_S, this rank's metrics are posted once
    (`publish_metrics`), so a scrape of an idle world is current."""
    client = _plane.client()
    wait_s = min(IDLE_PUBLISH_S, timeout_s)
    while True:
        try:
            blob = _wait_get(client, _plane.key(f"op/{seq}"), wait_s)
            break
        except Exception as e:
            if not _is_deadline(e):
                raise
            if wait_s < timeout_s:  # the stream went idle
                _plane.publish_metrics(client)
                wait_s = timeout_s
                continue
            if _plane.hb.stale_peers([0]):
                raise PeerDeadError(
                    "primary rank heartbeat went stale; worker "
                    "exiting") from None
    header = np.frombuffer(blob[:_HDR], np.int32)
    return header, blob[_HDR:]


class _SyncBus:
    """Barrier ordinal of one sync domain: every rank (control ops, and
    data ops at dp 1) or one replica's ranks (its data ops). Sync points
    derive deterministically from the shared op stream, so every rank of
    the domain executes the same syncs in the same order and `seq` stays
    aligned without any extra wire traffic; barrier ids are never
    reused."""

    def __init__(self, domain: str = "all", ranks=None,
                 plane: Optional[_Plane] = None):
        self.seq = 0
        self.domain = domain
        self.ranks = ranks  # None: every rank
        self.plane = plane

    def sync(self, ok: bool) -> np.ndarray:
        plane = self.plane or _plane
        flags = plane.status_sync(ok, self.seq, self.domain, self.ranks)
        self.seq += 1
        if self.ranks is None:
            # Barrier of every rank complete: on the primary, every op
            # sent so far has been consumed by every worker — advance the
            # wire-key cleanup horizon. On workers the wire's seq is 0.
            plane.wire.consumed = plane.wire.seq
        return flags


def _reset_wire(mesh=None) -> None:
    """Reset this process's plane (_Plane.reset); `_wire` is its op
    stream."""
    global _wire
    _plane.reset(mesh)
    _wire = _plane.wire


def _plane_for(mesh) -> _Plane:
    """The plane of `mesh`'s world: this process's own for its default
    world (or no world), else the one plane of that world."""
    world = getattr(mesh, "world", None)
    if world is None or world is distributed.default_world():
        return _plane
    plane = _planes.get(world)
    if plane is None:
        plane = _planes[world] = _Plane(world)
    return plane


class _OpCadence:
    """Per-RUNTIME data-op counter for the status-sync cadence, so a
    carried-forward off-cadence failure is always reported at a sync
    belonging to the SAME runtime. Replays mirror dispatches per runtime,
    so both sides' counts agree; a reload builds a fresh runtime and
    therefore a fresh zeroed cadence on every rank."""

    def __init__(self):
        self.count = 0
        self._pending_fail = False  # off-cadence failure carried forward

    def after_op(self, ok: bool, bus: "_SyncBus") -> Optional[np.ndarray]:
        self.count += 1
        if self.count % _status_every() != 0:
            self._pending_fail = self._pending_fail or not ok
            return None
        flags = bus.sync(ok and not self._pending_fail)
        self._pending_fail = False
        return flags


class _OpTrace:
    """What this rank ran on the wire: data ops by kind and a digest of
    every data op's output in order. Ranks that replayed the same plans
    and produced the same ids hold the same digest."""

    def __init__(self, plane: Optional[_Plane] = None):
        self.plane = plane
        self.reset()

    def reset(self) -> None:
        self.ops = {"ragged": 0, "spec": 0, "prefill": 0, "chunk": 0,
                    "sp_prefill": 0, "decode": 0, "decode_steps": 0,
                    "embed": 0, "encode": 0}
        self._h = hashlib.sha256()

    def record(self, op: int, a: int, out) -> None:
        kind = _OP_SITE[op] if op != OP_SPEC else "spec"
        self.ops[kind] += 1
        if op == OP_DECODE:
            self.ops["decode_steps"] += a
        # Sampled ids (int32) and embeddings (float32).
        self._h.update(out.detach().to("cpu").contiguous().numpy().tobytes())

    def report(self) -> dict:
        from ollamamq_tpu_torch.ops.cuda import launch_counts

        return {"rank": (self.plane or _plane).rank, "ops": dict(self.ops),
                "digest": self._h.hexdigest(), "launches": launch_counts()}


# This process's plane (worker ranks, a lone engine) and the planes of
# the other worlds it leads (a fleet router's wide members).
_plane = _Plane()
_wire = _plane.wire
_planes: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _raise_on_worker_failure(flags: Optional[np.ndarray], name: str) -> None:
    if flags is not None and flags.any():
        bad = np.nonzero(flags)[0].tolist()
        raise WorkerDesyncError(
            f"rank(s) {bad} failed replaying a dispatch for "
            f"{name}; KV state diverged — failing runtime for reload")


_OP_SITE = {OP_PREFILL: "prefill", OP_CHUNK: "chunk", OP_DECODE: "decode",
            OP_PREFILL_SP: "sp_prefill", OP_RAGGED: "ragged", OP_SPEC: "spec_verify", OP_EMBED: "embed",
            OP_ENCODE: "encode"}


def _ship(rt, op, a, b, values) -> int:
    """Ship one step plan for rt (its model and replica ordinals in the
    header); returns the plan's wire seq."""
    if rt.fault_plan is not None:
        # Fault-injection seam, BEFORE the broadcast: an injected failure
        # fires while no worker has replayed anything, so the containment
        # path sees a recoverable fault (after the broadcast it would be
        # real divergence, the desync path's job).
        rt.fault_plan.check(_OP_SITE.get(op, "decode"))
    if rt.journal is not None:
        # Workers replay this exact wire sequence: a desync postmortem
        # lines the journal's wire_seq up against each rank's position.
        rt.journal.record("broadcast", model=rt.name,
                          op=_OP_SITE.get(op, str(op)),
                          wire_seq=rt._plane.wire.seq)
    seq = rt._plane.wire.seq
    rt._plane.send(op, a, b, rt.spmd_index, rt.spmd_replica, values,
                   rt.ecfg.max_slots, rt.ecfg.max_pages_per_seq,
                   rt.ecfg.repeat_last_n, rt.key_bytes)
    return seq


def _mirrored_dispatch(rt, op, a, b, values, dispatch):
    """Ship the plan, run the local dispatch, then join this runtime's
    status sync. The status sync runs even when the local dispatch raised
    (skipping it would strand the other ranks at the barrier). Shared by
    the generative and encoder runtimes so the sync protocol can't drift
    between them."""
    _ship(rt, op, a, b, values)
    ok = False
    try:
        out = dispatch()
        rt._plane.trace.record(op, a, out)
        ok = True
        return out
    finally:
        flags = rt._cadence.after_op(ok, rt._plane.data_bus(rt.spmd_replica))
        if ok:
            _raise_on_worker_failure(flags, rt.name)


def _post_result(seq: int, ok: bool, rt, out) -> None:
    """(a replica's first rank) Op `seq`'s outcome for rank 0: the status
    its replica's ranks agreed on, the generator's state after the op
    (the next plan starts from it) and the output."""
    buf = io.BytesIO()
    key = _key_of(rt) if ok else np.zeros(0, np.uint8)
    buf.write(np.asarray([1 if ok else 0, key.size], np.int32).tobytes())
    buf.write(key.tobytes())
    if ok:
        np.save(buf, out.detach().to("cpu").contiguous().numpy(),
                allow_pickle=False)
    _client().set(_plane.key(f"res/{seq}"), buf.getvalue())


class _RemoteResult:
    """The output of op `seq` on a replica whose ranks this process does
    not hold: `cpu()` waits for the replica's first rank to post it (the
    collect; the dispatch only shipped the plan), restores the runtime's
    generator to the state after the op and returns the output on the
    host. Raises WorkerDesyncError when a rank of the replica failed the
    replay and PeerDeadError when one died. `ready()` asks without
    waiting, so the engine loop can collect it on a later tick and keep
    its other replicas stepping meanwhile."""

    HB_CHECK_S = 0.25  # between ready()'s heartbeat reads
    WAIT_SLICE_S = 0.005  # one store wait of wait()

    def __init__(self, rt, seq: int):
        self.rt = rt
        self.seq = seq
        self._out = None
        self._since = self._checked = time.monotonic()

    def ready(self) -> bool:
        plane = self.rt._plane
        if self._out is not None or plane.client().check(
                [plane.key(f"res/{self.seq}")]):
            return True
        now = time.monotonic()
        if now - self._checked >= self.HB_CHECK_S:
            self._checked = now
            dead = plane.hb.stale_peers(plane.layout[self.rt.spmd_replica])
            if dead:
                raise PeerDeadError(
                    f"rank(s) {dead} heartbeat went stale at replica "
                    f"{self.rt.spmd_replica}'s op {self.seq}: presumed dead; "
                    "failing in-flight work loudly")
            if now - self._since > _status_timeout_s():
                raise WorkerDesyncError(
                    f"replica {self.rt.spmd_replica}'s op {self.seq} posted "
                    f"no result in {_status_timeout_s():.0f}s")
        return False

    def wait(self, seconds: float, stop) -> None:
        """Block until the result is posted, `stop()` turns true or
        `seconds` pass, in store waits of WAIT_SLICE_S (the store answers
        a wait the moment its key lands) with `stop()` read between them.
        Errors are left to ready() and cpu()."""
        plane = self.rt._plane
        client = plane.client()
        key = [plane.key(f"res/{self.seq}")]
        deadline = time.monotonic() + seconds
        while not stop() and time.monotonic() < deadline:
            try:
                client.wait(key, datetime.timedelta(seconds=self.WAIT_SLICE_S))
                return
            except Exception as e:  # noqa: BLE001
                if not _is_deadline(e):
                    return

    def cpu(self) -> torch.Tensor:
        if self._out is None:
            rt, plane = self.rt, self.rt._plane
            key = plane.key(f"res/{self.seq}")
            client = plane.client()
            raw = plane.wait_polled(client, key, plane.layout[rt.spmd_replica],
                                    f"replica {rt.spmd_replica}'s op {self.seq}")
            try:
                client.delete_key(key)
            except Exception:  # noqa: BLE001
                pass
            ok, n = (int(x) for x in np.frombuffer(raw[:8], np.int32))
            if not ok:
                raise WorkerDesyncError(
                    f"replica {rt.spmd_replica}'s ranks "
                    f"{plane.layout[rt.spmd_replica]} failed replaying a dispatch "
                    f"for {rt.name}; KV state diverged — failing runtime for "
                    "reload")
            rt.gen.set_state(torch.from_numpy(
                np.frombuffer(raw[8:8 + n], np.uint8).copy()))
            self._out = torch.from_numpy(
                np.load(io.BytesIO(raw[8 + n:]), allow_pickle=False))
        return self._out


def _remote_dispatch(rt, op, a, b, values, lazy: bool):
    """Ship a plan to the ranks of rt's replica (none of them this one);
    the output comes back on the store (_RemoteResult). A decode chunk
    returns at once (the loop collects it after dispatching every
    replica); the other ops are read back here."""
    out = _RemoteResult(rt, _ship(rt, op, a, b, values))
    return out if lazy else out.cpu()


def _key_of(rt) -> np.ndarray:
    """The engine generator's state the next dispatch starts from."""
    return rt.gen.get_state().numpy().copy() if rt.gen is not None else \
        np.zeros(0, np.uint8)


class _SPMDMixin:
    """The rank bookkeeping both SPMD runtime kinds carry."""

    def _spmd_init(self) -> None:
        # The control plane of this runtime's world (a fleet router leads
        # one world per wide member).
        self._plane = _plane_for(getattr(self, "mesh", None))
        self._spmd = self._plane.size > 1
        # Ordinals agreed with workers via the shared --models ordering,
        # carried in the opcode header so multi-model pods stay in step.
        self.spmd_index = 0
        self.spmd_replica = 0
        self._cadence = _OpCadence()
        gen = getattr(self, "gen", None)
        self.key_bytes = int(gen.get_state().numel()) if gen is not None else 0


class SPMDModelRuntime(_SPMDMixin, ModelRuntime):
    """ModelRuntime whose device dispatches are mirrored on every rank.
    A one-rank world behaves exactly like ModelRuntime."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self._spmd_init()

    def _mirrored(self, op, a, b, values, dispatch):
        return _mirrored_dispatch(self, op, a, b, values, dispatch)

    def _fault(self, site):
        # Multi-rank: the check already ran pre-broadcast in
        # _mirrored_dispatch; firing again would double-count the plan's
        # per-site call stream.
        if not self._spmd:
            super()._fault(site)

    # KV migration is a fleet-member feature; on a multi-rank runtime the
    # pool gather/scatter would run on rank 0 alone and desync the
    # workers' replay state, so it refuses: a stream moving onto or off a
    # fleet member wider than one rank replays by recompute instead (this
    # guards /admin/migrate too).
    def export_request(self, rid):
        return None if self._spmd else super().export_request(rid)

    def import_request(self, blob, req):
        return False if self._spmd else super().import_request(blob, req)

    def export_prefix(self, tokens):
        return None if self._spmd else super().export_prefix(tokens)

    def import_prefix(self, blob):
        return 0 if self._spmd else super().import_prefix(blob)

    def _ragged_dispatch(self, T_pad, k_cap, tokens, tok_seq, tok_pos,
                         write_slots, q_start, q_len, kv_len, ring_len,
                         is_first, append, is_spec, seed_rows, slot_ids,
                         pt_rows, temp, top_k, top_p, pen, pres, freq, seeds):
        args = (T_pad, k_cap, tokens, tok_seq, tok_pos, write_slots, q_start,
                q_len, kv_len, ring_len, is_first, append, is_spec, seed_rows,
                slot_ids, pt_rows, temp, top_k, top_p, pen, pres, freq, seeds)
        if not self._spmd:
            return super()._ragged_dispatch(*args)
        key = _key_of(self)
        # Plain mixed batches keep the OP_RAGGED wire shape; only
        # dispatches carrying verify spans ship is_spec (OP_SPEC, b=k_cap).
        head = (tokens, tok_seq, tok_pos, write_slots, q_start, q_len,
                kv_len, ring_len, is_first, append)
        tail = (slot_ids, seed_rows, pt_rows, temp, top_k, top_p, pen, pres,
                freq, seeds, key)
        op, payload = ((OP_SPEC, head + (is_spec,) + tail) if k_cap
                       else (OP_RAGGED, head + tail))
        return self._mirrored(op, T_pad, k_cap, payload,
                              lambda: ModelRuntime._ragged_dispatch(self, *args))

    def _dispatch_prefill(self, bucket, B, tokens, lens, slot_ids, pt_rows,
                          temp, top_k, top_p, pen, pres, freq, seeds):
        args = (bucket, B, tokens, lens, slot_ids, pt_rows, temp, top_k,
                top_p, pen, pres, freq, seeds)
        if not self._spmd:
            return super()._dispatch_prefill(*args)
        return self._mirrored(
            OP_PREFILL, bucket, B, args[2:] + (_key_of(self),),
            lambda: ModelRuntime._dispatch_prefill(self, *args))

    def _dispatch_chunk(self, chunk, tokens, start, cl, slot_id, is_final,
                        is_first, seed_row, pt_row, temp, top_k, top_p, pen,
                        pres, freq, seeds):
        args = (chunk, tokens, start, cl, slot_id, is_final, is_first,
                seed_row, pt_row, temp, top_k, top_p, pen, pres, freq, seeds)
        if not self._spmd:
            return super()._dispatch_chunk(*args)
        return self._mirrored(
            OP_CHUNK, chunk, 0, args[1:] + (_key_of(self),),
            lambda: ModelRuntime._dispatch_chunk(self, *args))

    def _dispatch_prefill_sp(self, T, tokens, lens, slot_ids, pt_rows, temp,
                             top_k, top_p, pen, pres, freq, seeds):
        args = (T, tokens, lens, slot_ids, pt_rows, temp, top_k, top_p, pen,
                pres, freq, seeds)
        if not self._spmd:
            return super()._dispatch_prefill_sp(*args)
        return self._mirrored(
            OP_PREFILL_SP, T, 0, args[1:] + (_key_of(self),),
            lambda: ModelRuntime._dispatch_prefill_sp(self, *args))

    def _dispatch_decode(self, k_steps, last_tokens, seq_lens, active_mask,
                         page_table, temp, top_k, top_p, pen, pres, freq,
                         seeds):
        args = (k_steps, last_tokens, seq_lens, active_mask, page_table, temp,
                top_k, top_p, pen, pres, freq, seeds)
        if not self._spmd:
            return super()._dispatch_decode(*args)
        return self._mirrored(
            OP_DECODE, k_steps, 0, args[1:] + (_key_of(self),),
            lambda: ModelRuntime._dispatch_decode(self, *args))

    def _dispatch_embed(self, B, bucket, tokens, lens):
        if not self._spmd:
            return super()._dispatch_embed(B, bucket, tokens, lens)
        return self._mirrored(
            OP_EMBED, B, bucket, (tokens, lens),
            lambda: ModelRuntime._dispatch_embed(self, B, bucket, tokens, lens))


class SPMDRemoteRuntime(SPMDModelRuntime):
    """Rank 0's runtime for a data-parallel replica none of whose ranks
    it holds: the host state of the replica (slots, pages, prefix cache,
    the generator the plans carry) and no weights or pool. Its
    dispatches ship the plan to the replica's ranks and read the output
    back from the store, so the engine's host logic runs unchanged."""

    def _home_device(self, mesh, device):
        return device  # rank 0's: the generator the plans carry lives here

    def _device_state(self, params, checkpoint_path, tp_size, pp, stage):
        """No weights, pool or ring here: the replica's ranks hold them.
        Their bytes are those of the replica's first rank (the slice rank
        0 holds of replica 0), from meta tensors of the config's shapes:
        nothing is drawn, read or allocated."""
        meta = torch.device("meta")
        shapes = weights.load_params(self._orig_cfg, None, self.ecfg.seed,
                                     self.dtype, self.weights_dtype, meta,
                                     tp=tp_size, rank=0, pp=pp, stage=0,
                                     ep=self._ep)
        kc, vc = kvc.alloc_kv_pool(self.cfg, self.ecfg, self.dtype, meta,
                                   kv_dtype=self.kv_dtype, tp=tp_size,
                                   layers=self.cfg.num_layers // pp)
        self.params = self.kc = self.vc = self.recent = None
        self.param_bytes = sum(nbytes(t) for t in weights.leaves(shapes))
        self.kv_bytes = nbytes(kc) + nbytes(vc)

    def _mirrored(self, op, a, b, values, dispatch):
        return _remote_dispatch(self, op, a, b, values, lazy=op == OP_DECODE)


class SPMDEncoderRuntime(_SPMDMixin, EncoderRuntime):
    """EncoderRuntime whose batch-encode dispatches are mirrored on every
    rank (OP_ENCODE), so embedding models serve under tensor parallelism
    too."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self._spmd_init()

    def _dispatch_encode(self, B, bucket, tokens, lens):
        if not self._spmd:
            return super()._dispatch_encode(B, bucket, tokens, lens)
        return _mirrored_dispatch(
            self, OP_ENCODE, B, bucket, (tokens, lens),
            lambda: EncoderRuntime._dispatch_encode(self, B, bucket, tokens,
                                                    lens))


def _build_row(name, ckpt, engine_cfg, mesh, dtype, replica=None) -> dict:
    """Worker side: {replica ordinal: runtime} of one model, holding only
    this rank's replica (an encoder: replica 0's ranks only), built by
    the SAME construction path as the primary's load_model, with the
    SPMD runtime classes; `replica` rebuilds that one."""
    from ollamamq_tpu_torch.config import get_model_config
    from ollamamq_tpu_torch.engine.engine import build_model_runtimes

    cfg = get_model_config(name)
    if cfg is None:
        raise ValueError(f"model {name} not replayable under SPMD")
    reps = build_model_runtimes(name, cfg, engine_cfg, mesh.device, dtype,
                                ckpt, None, mesh, SPMDModelRuntime,
                                SPMDEncoderRuntime, replica=replica)
    return {getattr(rt, "replica", 0): rt for rt in reps}


class SPMDEngine(TorchEngine):
    """The primary rank's engine: a TorchEngine whose runtimes broadcast
    their dispatches, whose model load/evict/reload control operations
    broadcast as opcodes serialized on the engine thread, and which
    releases the workers on stop (collecting each worker's report)."""

    runtime_class = SPMDModelRuntime
    encoder_runtime_class = SPMDEncoderRuntime
    remote_runtime_class = SPMDRemoteRuntime

    def __init__(self, engine_cfg: EngineConfig, mesh=None, **kw):
        self._plane = _plane_for(mesh)
        if self._plane.size > 1 and self._plane.rank != 0:
            raise RuntimeError("SPMDEngine runs on rank 0; workers run "
                               "run_worker")
        if self._plane is _plane:
            _reset_wire(mesh)
        else:
            self._plane.reset(mesh)
        self.worker_reports: list = []
        self._released = False
        # Decode chunks out on another replica's ranks, not collected yet:
        # id(rt) -> (rt, handle). Set on every notify (an arrival, a loop
        # call), cleared as a tick admits: it ends an idle wait.
        self._deferred: dict = {}
        self._nudged = False
        super().__init__(engine_cfg, mesh=mesh, **kw)
        self._renumber()
        if self._multi():
            self._plane.start_heartbeat()

    def _multi(self) -> bool:
        return self._plane.size > 1

    @property
    def restartable(self) -> bool:
        """Whether start() may follow stop(): not for an engine leading a
        world, whose stop releases its ranks (fleet/members.py rebuilds
        such a member instead)."""
        return not self._multi()

    @property
    def released(self) -> bool:
        """Whether stop() released this engine's ranks."""
        return self._released

    def _renumber(self) -> None:
        """Re-derive (model ordinal, replica ordinal) of every runtime
        from the dict order and the set's order, the same order the
        worker keeps its mirrored table in."""
        for mi, rt in enumerate(self.runtimes.values()):
            for rep in (rt.replicas if isinstance(rt, ReplicaSet) else (rt,)):
                rep.spmd_index = mi
                rep.spmd_replica = getattr(rep, "replica", 0)

    def notify(self) -> None:
        self._nudged = True
        super().notify()

    def _admit(self) -> int:
        self._nudged = False  # a notify from here on ends this tick's wait
        return super()._admit()

    def _tick_targets(self) -> list:
        """Phase 1's runtimes: replicas whose ranks this one does not hold
        first (their decode dispatch is a store write, so their ranks
        compute while this rank runs its own replica's dispatch and status
        sync), less those whose decode is still out on their ranks."""
        targets = [rt for rt in super()._tick_targets()
                   if id(rt) not in self._deferred]
        return ([rt for rt in targets if isinstance(rt, SPMDRemoteRuntime)]
                + [rt for rt in targets
                   if not isinstance(rt, SPMDRemoteRuntime)])

    def _collect(self, handles) -> None:
        """Phase 2. A decode out on another replica's ranks is collected
        on the first tick after its result is posted; until then the loop
        steps the other runtimes."""
        own = []
        for rt, h in handles:
            if isinstance(h[0], _RemoteResult):
                self._deferred[id(rt)] = (rt, h)
            else:
                own.append((rt, h))
        super()._collect(own)
        ready = []
        for key, (rt, h) in list(self._deferred.items()):
            try:
                if not (rt._failed or h[0].ready()):
                    continue
            except Exception as e:  # noqa: BLE001 — contain to this runtime
                del self._deferred[key]
                self._kill_runtime(rt, e)
                continue
            del self._deferred[key]
            ready.append((rt, h))
        super()._collect(ready)

    def _idle(self) -> None:
        """With a decode out on another replica's ranks, wait for its
        result on the store rather than nap: the result, a notify or 50
        ms ends the wait."""
        if not self._deferred:
            return super()._idle()
        _rt, h = next(iter(self._deferred.values()))
        h[0].wait(0.05, lambda: self._nudged)

    def _send_control(self, op, a, index, values, replica: int = 0) -> None:
        e = self.ecfg
        self._plane.send(op, a, 0, index, replica, values, e.max_slots,
                         e.max_pages_per_seq, e.repeat_last_n, 0)

    def load_model(self, name, checkpoint_path=None, params=None):
        if name in self.runtimes:
            return
        if not (self._running and self._multi()):
            super().load_model(name, checkpoint_path, params)
            self._renumber()
            return
        from ollamamq_tpu_torch.config import get_model_config

        if get_model_config(name) is None:
            # Validate BEFORE broadcasting: a post-broadcast failure would
            # leave worker ordinal lists with an entry the primary lacks.
            raise KeyError(f"unknown model architecture: {name}")
        if params is not None:
            raise NotImplementedError(
                "weights passed in cannot reach the worker ranks; load a "
                "checkpoint or the seeded weights")

        def _do():
            if name in self.runtimes:
                # A concurrent pull of the same model won the race; a
                # second OP_LOAD would desync worker ordinals for good.
                return
            cfg = get_model_config(name)
            n_reps = (self.mesh.dp if self.mesh is not None
                      and not cfg.is_encoder else 1)
            self._send_control(OP_LOAD, n_reps, len(self.runtimes),
                               (_encode_str(name, NAME_LEN),
                                _encode_str(checkpoint_path, PATH_LEN)))
            ok = False
            try:
                TorchEngine.load_model(self, name, checkpoint_path)
                self._renumber()
                ok = True
            finally:
                flags = self._plane.bus.sync(ok)
                if ok and flags.any():
                    # The worker holds a dead placeholder at this ordinal;
                    # the first dispatch fails loudly and the reload path
                    # rebuilds it.
                    raise RuntimeError(
                        f"worker rank(s) {np.nonzero(flags)[0].tolist()} "
                        f"failed loading {name}; serving deferred to reload "
                        "recovery")

        return self.call_on_loop(_do)

    def evict_model(self, name):
        if not (name in self.runtimes and self._running and self._multi()):
            out = super().evict_model(name)
            self._renumber()
            return out

        def _do():
            rt = self.runtimes.get(name)
            if rt is None:
                return False
            if rt.has_work():
                # Validate BEFORE broadcasting so no worker evicts what
                # the primary kept.
                raise RuntimeError(f"model {name} has in-flight work")
            mi = list(self.runtimes).index(name)
            self._send_control(OP_EVICT, 0, mi, (_encode_str(name, NAME_LEN),))
            ok = False
            try:
                out = TorchEngine.evict_model(self, name)
                self._renumber()
                ok = True
                return out
            finally:
                flags = self._plane.bus.sync(ok)
                if ok and flags.any():
                    log.critical(
                        "worker rank(s) %s refused evicting %s: ordinal "
                        "tables diverged BEFORE this op; restart the "
                        "deployment", np.nonzero(flags)[0].tolist(), name)

        return self.call_on_loop(_do)

    def _start_rebuild(self, rt):
        if not self._multi():
            return super()._start_rebuild(rt)
        dead = self.stale_worker_hosts()
        if dead:
            # No reload can succeed without every rank: keep the runtime
            # failed (worker_stale says why) and look again next interval.
            log.error("worker rank(s) %s dead: %s stays failed", dead, rt.name)
            self._recovering.discard(id(rt))
            return
        # Engine thread: broadcast the reload and rebuild INLINE so the
        # weight reload and the pool allocation happen at the same point
        # of the op stream on every rank. Serving pauses for the reload.
        log.warning("SPMD reload of %s (model %d, replica %d) on its ranks",
                    rt.name, rt.spmd_index, rt.spmd_replica)
        self._send_control(OP_RELOAD, 0, rt.spmd_index, (),
                           replica=rt.spmd_replica)
        ok = False
        try:
            ok = self._rebuild_runtime(rt)
        finally:
            try:
                flags = self._plane.bus.sync(ok)
            except PeerDeadError:
                flags = np.ones(1, np.int32)
                log.error("a worker rank is dead: %s stays failed", rt.name)
            if ok and flags.any():
                log.error("worker rank(s) failed the reload of %s; the next "
                          "attempt retries", rt.name)
                with self._rebuilt_lock:
                    self._rebuilt = [(d, f) for d, f in self._rebuilt
                                     if d is not rt]
                self._recovering.discard(id(rt))
        self._swap_rebuilt()
        self._renumber()

    def chip_stats(self):
        chips = super().chip_stats()
        if self._multi():
            client = self._plane.client()
            for p in range(1, self._plane.size):
                try:
                    v = _try_get(client, f"ollamamq/chips/{p}")
                    if v:
                        chips.extend(json.loads(v))
                except Exception:  # noqa: BLE001 — not publishing yet (or dead)
                    pass
        return chips

    def worker_metric_snapshots(self):
        """The registry snapshot of every other rank of this engine's
        world (`ollamamq/metrics/<rank>`), the ranks of remote replicas
        included, for /metrics to merge: each rank keeps its own
        registry in its own process. A rank not publishing yet (or dead) is
        skipped; none once the ranks are released."""
        if not self._multi() or self._released:
            return []
        client = self._plane.client()
        out = []
        for p in range(1, self._plane.size):
            try:
                v = _try_get(client, f"ollamamq/metrics/{p}")
                if v:
                    out.append(json.loads(v))
            except Exception:  # noqa: BLE001 — not publishing yet (or dead)
                pass
        return out

    def stale_worker_hosts(self):
        """Worker ranks whose heartbeat value stopped advancing (the same
        staleness rule the status sync uses: one module-level monitor, so
        the watchdog and the sync can never disagree)."""
        if not self._multi():
            return []
        try:
            return self._plane.hb.stale_peers(range(1, self._plane.size))
        except Exception:  # noqa: BLE001 — the sync path surfaces it
            return []

    def _worker_report(self, p: int, deadline: float) -> Optional[dict]:
        """Rank p's shutdown report, or None once it is past `deadline`
        or its heartbeat is stale (a dead worker files none)."""
        client = self._plane.client()
        while time.monotonic() < deadline:
            try:
                return json.loads(_wait_get(
                    client, self._plane.key(f"report/{p}"), 1.0))
            except Exception as e:
                if not _is_deadline(e):
                    raise
                if self._plane.hb.stale_peers([p]):
                    break
        log.error("worker rank %d filed no report", p)
        return None

    def spmd_report(self) -> dict:
        """This rank's wire trace: data ops by kind, the digest of their
        outputs, the kernel launch counts."""
        return self._plane.trace.report()

    # Worker processes this process started (cli --tp): reaped on stop.
    worker_procs: list = []

    def stop(self, report_timeout_s: float = 30.0) -> None:
        super().stop()
        if not self._multi() or self._released:
            return
        self._released = True
        try:
            self._plane.broadcast_shutdown()  # once, after dispatches ended
            self.worker_reports = []
            deadline = time.monotonic() + report_timeout_s
            for p in range(1, self._plane.size):
                report = self._worker_report(p, deadline)
                if report is not None:
                    self.worker_reports.append(report)
        except Exception:  # noqa: BLE001 — the store is gone
            log.exception("worker reports incomplete")
        finally:
            self._plane.stop_heartbeat()
            distributed.reap(self.worker_procs)
            if self._plane is not _plane:
                self._plane.world.close()  # a member's world ends with it


class _DeadReplica:
    """Placeholder for a replica of this rank whose runtime failed to
    build: keeps the slot's status-sync cadence alive (the primary's
    runtime still dispatches and syncs on ITS cadence until the reload
    lands) and makes any routed replay fail loudly."""

    def __init__(self, name: str):
        self.name = name
        self._cadence = _OpCadence()


def _slot(rows, specs, mi, ri):
    """This rank's holder at (mi, ri), growing the mirrored table with
    dead placeholders when the primary references an ordinal we never
    built (a protocol bug: kept loud but sync-aligned)."""
    while len(rows) <= mi:
        rows.append({})
        specs.append(("?", None))
    row = rows[mi]
    if ri not in row:
        row[ri] = _DeadReplica(specs[mi][0])
    return row[ri]


def run_worker(models, engine_cfg: EngineConfig, mesh, dtype=None,
               max_steps: Optional[int] = None) -> int:
    """Worker-rank loop (rank != 0): replay the primary's dispatches.

    `models`: {name: checkpoint_path_or_None} in the SAME order as the
    primary's --models list; the opcode header routes by that ordinal
    and, on a mesh with a data axis, by the replica ordinal: this rank
    replays its own replica's data ops only (the first rank of a replica
    r > 0 posts each op's result for rank 0) and applies every control
    op. Returns the number of ops received. `max_steps` bounds the loop
    for tests; production workers run until OP_SHUTDOWN, when they file
    their report (`ollamamq/report/<rank>`: ops, output digest, kernel
    launches, its replica, the (model, replica) ordinals it reloaded,
    each runtime's weight and KV bytes and its pipeline and ring
    hand-off times, peak device memory) for the primary.

    A replay failure is answered over the status sync: the primary fails
    that runtime loudly and sends OP_RELOAD, which rebuilds it here from
    pristine config — no silently-diverged serving."""
    from ollamamq_tpu_torch.config import get_model_config, validate_quant_config

    err = validate_quant_config(engine_cfg.weights_dtype, engine_cfg.kv_dtype,
                                pp=mesh.pp, sp=mesh.sp,
                                model_names=list(models))
    if err is not None:
        raise ValueError(err)
    _reset_wire(mesh)
    _plane.start_heartbeat()
    me = replica_of(mesh)
    ranks = _plane.layout[me]
    posts = mesh.dp > 1 and me > 0 and distributed.rank() == ranks[0]
    rows = []  # [model ordinal] -> {replica ordinal: runtime | _DeadReplica}
    specs = []  # [model ordinal] -> (name, ckpt)
    for name, ckpt in models.items():
        rows.append(_build_row(name, ckpt, engine_cfg, mesh, dtype))
        specs.append((name, ckpt))
    steps = 0
    reloads = []  # [model ordinal, replica ordinal] of each reload here
    S = engine_cfg.max_slots
    MP = engine_cfg.max_pages_per_seq
    W = engine_cfg.repeat_last_n
    wire_seq = 0
    client = _client()
    try:
        while max_steps is None or steps < max_steps:
            header, raw = _recv_op(wire_seq)
            seq = wire_seq
            wire_seq += 1
            if mesh.dp > 1 and wire_seq % CURSOR_EVERY == 0:
                client.set(_plane.key(f"cursor/{distributed.rank()}"),
                           str(wire_seq - 1))
            op, a, b, mi, ri = (int(x) for x in header)
            if op == OP_SHUTDOWN:
                report = _plane.trace.report()
                report["replica"] = me
                report["reloads"] = reloads
                report["runtimes"] = {
                    rt.name: {"param_bytes": rt.param_bytes,
                              "kv_bytes": rt.kv_bytes,
                              "pipe": (dict(rt.pipe.stats)
                                       if getattr(rt, "pipe", None) else None),
                              "seq": (dict(rt.seq.stats)
                                      if getattr(rt, "seq", None) else None)}
                    for row in rows for rt in row.values()
                    if not isinstance(rt, _DeadReplica)}
                if mesh.device.type == "cuda":
                    report["max_memory_allocated"] = \
                        torch.cuda.max_memory_allocated(mesh.device)
                client.set(_plane.key(f"report/{distributed.rank()}"),
                           json.dumps(report))
                break
            if op in DATA_OPS and ri != me:
                steps += 1  # another replica's op: its ranks replay it
                continue
            ok = True
            payload = out = rt = None
            try:
                if op in DATA_OPS:
                    rt = _slot(rows, specs, mi, ri)
                    if isinstance(rt, _DeadReplica):
                        raise RuntimeError(
                            f"no live runtime at ordinal {mi}/{ri} for op {op}")
                    payload = _unpack_payload(
                        raw, payload_spec(op, a, b, S, MP, W, rt.key_bytes))
                    out = _replay(rt, op, a, b, payload)
                    _plane.trace.record(op, a, out)
                elif op == OP_RELOAD:
                    name, ckpt = specs[mi]
                    if ri == me:
                        old = _slot(rows, specs, mi, ri)
                        # Free the old device memory before the reload; the
                        # dead placeholder holds the slot (and a fresh
                        # cadence, mirroring the primary's fresh runtime)
                        # if the rebuild below raises.
                        rows[mi][ri] = _DeadReplica(name)
                        del old
                        rows[mi].update(_build_row(name, ckpt, engine_cfg,
                                                   mesh, dtype, replica=ri))
                        reloads.append([mi, ri])
                        log.warning("worker reloaded %s (model %d, replica "
                                    "%d)", name, mi, ri)
                elif op == OP_LOAD:
                    payload = _unpack_payload(
                        raw, payload_spec(op, a, b, S, MP, W, 0))
                    name = _decode_str(payload[0])
                    ckpt = _decode_str(payload[1]) or None
                    specs.append((name, ckpt))
                    rows.append({})
                    cfg = get_model_config(name)
                    want = 1 if cfg is None or cfg.is_encoder else mesh.dp
                    if a != want:
                        raise RuntimeError(
                            f"OP_LOAD of {name} for {a} replica(s); this "
                            f"rank's mesh serves {want}")
                    rows[-1] = _build_row(name, ckpt, engine_cfg, mesh, dtype)
                elif op == OP_EVICT:
                    payload = _unpack_payload(
                        raw, payload_spec(op, a, b, S, MP, W, 0))
                    name = _decode_str(payload[0])
                    if mi >= len(specs) or specs[mi][0] != name:
                        raise RuntimeError(
                            f"evict ordinal {mi} names "
                            f"{specs[mi][0] if mi < len(specs) else '<none>'}"
                            f", primary said {name}")
                    # Deletion is DEFERRED to after the status sync: if the
                    # primary's own evict fails post-broadcast it keeps its
                    # runtime, and deleting ours here would desync every
                    # ordinal > mi.
                else:
                    log.error("unknown opcode %d; shutting down", op)
                    break
            except Exception:
                ok = False
                log.exception("worker op failed (op=%d mi=%d ri=%d); "
                              "reporting desync", op, mi, ri)
                if op == OP_LOAD and rows and not rows[-1]:
                    # Keep ordinals aligned; OP_RELOAD rebuilds holes.
                    rows[-1] = {me: _DeadReplica(specs[-1][0])}
            # Status sync: data ops ride the TARGET RUNTIME's cadence on its
            # replica's bus (matching the primary's per-runtime cadence);
            # control ops always sync every rank (the primary waits on the
            # result).
            if op in DATA_OPS:
                flags = _slot(rows, specs, mi, ri)._cadence.after_op(
                    ok, _plane.data_bus(ri))
                if posts:
                    _post_result(seq, ok and not (flags is not None
                                                  and flags.any()), rt, out)
            else:
                flags = _plane.bus.sync(ok)
                if op == OP_LOAD and flags[0]:
                    # The primary's own load failed AFTER broadcasting: it
                    # never added the model, so drop ours to realign.
                    rows.pop()
                    specs.pop()
                elif op == OP_EVICT and ok:
                    if flags[0]:
                        log.error("primary failed evicting %s; keeping our "
                                  "runtime to stay aligned",
                                  _decode_str(payload[0]))
                    else:
                        del rows[mi]
                        del specs[mi]
            steps += 1
    finally:
        _plane.stop_heartbeat()
    return steps


def _replay(rt, op, a, b, payload):
    """Execute one data op against a worker runtime, mirroring the
    primary's dispatch exactly (same call, same inputs, the generator
    state the primary's draws started from). Returns the output, read
    back so the op has finished on this rank's device."""
    if op in (OP_RAGGED, OP_SPEC):
        T_pad, k_cap = a, (b if op == OP_SPEC else 0)
        if op == OP_SPEC:
            (tokens, tok_seq, tok_pos, write_slots, q_start, q_len, kv_len,
             ring_len, is_first, append, is_spec, slot_ids, seed_rows, pt,
             temp, tk, tp, pen, pres, freq, seeds, key) = payload
        else:
            (tokens, tok_seq, tok_pos, write_slots, q_start, q_len, kv_len,
             ring_len, is_first, append, slot_ids, seed_rows, pt, temp, tk,
             tp, pen, pres, freq, seeds, key) = payload
            # No verify spans on this wire shape.
            is_spec = np.zeros_like(q_start)
        rt.gen.set_state(torch.from_numpy(key.copy()))
        out = ModelRuntime._ragged_dispatch(
            rt, T_pad, k_cap, tokens, tok_seq, tok_pos, write_slots, q_start,
            q_len, kv_len, ring_len, is_first, append, is_spec, seed_rows,
            slot_ids, pt, temp, tk, tp, pen, pres, freq, seeds)
    elif op == OP_PREFILL:
        (tokens, lens, slot_ids, pt, temp, tk, tp, pen, pres, freq, seeds,
         key) = payload
        rt.gen.set_state(torch.from_numpy(key.copy()))
        out = ModelRuntime._dispatch_prefill(
            rt, a, b, tokens, lens, slot_ids, pt, temp, tk, tp, pen, pres,
            freq, np.array(seeds))
    elif op == OP_CHUNK:
        (tokens, start, cl, slot_id, is_final, is_first, seed_row, pt, temp,
         tk, tp, pen, pres, freq, seeds, key) = payload
        rt.gen.set_state(torch.from_numpy(key.copy()))
        out = ModelRuntime._dispatch_chunk(
            rt, a, tokens, start, cl, slot_id, is_final, is_first, seed_row,
            pt, temp, tk, tp, pen, pres, freq, np.array(seeds))
    elif op == OP_PREFILL_SP:
        (tokens, lens, slot_ids, pt, temp, tk, tp, pen, pres, freq, seeds,
         key) = payload
        rt.gen.set_state(torch.from_numpy(key.copy()))
        out = ModelRuntime._dispatch_prefill_sp(
            rt, a, tokens, lens, slot_ids, pt, temp, tk, tp, pen, pres, freq,
            np.array(seeds))
    elif op == OP_DECODE:
        (tokens, positions, active, pt, temp, tk, tp, pen, pres, freq,
         seeds, key) = payload
        rt.gen.set_state(torch.from_numpy(key.copy()))
        out = ModelRuntime._dispatch_decode(
            rt, a, tokens, positions, active, pt, temp, tk, tp, pen, pres,
            freq, np.array(seeds))
    elif op == OP_ENCODE:
        tokens, lens = payload
        out = EncoderRuntime._dispatch_encode(rt, a, b, np.array(tokens),
                                              np.array(lens))
    elif op == OP_EMBED:
        tokens, lens = payload
        out = ModelRuntime._dispatch_embed(rt, a, b, tokens, lens)
    else:  # pragma: no cover — guarded by the caller's DATA_OPS check
        raise ValueError(f"not a data op: {op}")
    if rt.device.type == "cuda":
        torch.cuda.synchronize(rt.device)
    return out
