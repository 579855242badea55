"""The rank mesh: the JAX package's device mesh as a grid of processes.

The JAX package runs tensor parallelism in one process: a
jax.sharding.Mesh names five axes over the chips and GSPMD inserts the
collectives. PyTorch has no single controller, so here each rank is a
process (torch.distributed), the mesh is a grid of ranks with the same
five axes in the same order,

  - "data":   replicas: each data index is a whole (pipe, seq, tensor)
              sub-grid of ranks serving its own requests with its own
              weights and KV pool (replica_submesh); the engine places
              each request on its least-loaded replica
  - "pipe":   pipeline stages: each stage holds a contiguous slice of
              the layers and their KV pages and hands its activations to
              the next stage point to point (PipeGroup,
              parallel/pipeline.py)
  - "seq":    sequence shards: a long prompt's one-shot prefill cuts
              the sequence in contiguous chunks over the axis and runs
              ring attention, each shard handing its K/V chunk to the
              next point to point (SeqGroup,
              parallel/ring_attention.py); weights and the KV pool are
              replicated over it, so every other op runs alike on
              every shard
  - "expert": expert shards: each rank holds E / ep of every MoE
              layer's experts (and their F / tp slice); everything else
              (router, attention, embedding, KV pool) is replicated over
              the axis, so every expert rank routes the same tokens alike
              and its partial FFN output is summed over the (expert,
              tensor) plane in one all_reduce (ExpertGroup); no
              all-to-all moves tokens. A dense model on the axis runs
              alike on every expert rank
  - "tensor": tensor parallelism within a stage: attention heads, FFN
              hidden dims and the vocabulary sharded; the forwards call
              the collectives themselves (TensorGroup)

Ranks are numbered in that order (the tensor index varies fastest, the
expert index next), so replica r holds the ranks [r * pp * sp * ep * tp,
(r + 1) * pp * sp * ep * tp). The tensor axis carries one process group
per (replica, stage, seq index, expert index), the pipe axis one per
(replica, seq index, expert index, tensor index), the seq axis one per
(replica, stage, expert index, tensor index) and the (expert, tensor)
plane one per (replica, stage, seq index), each built by its own ranks
on the world's store (distributed.World.group), so several worlds can
live in one process (a fleet router leads one per wide member). Several
ranks may share one device (two ranks on one card over gloo);
`n_devices` counts the distinct devices, which is what MFU divides by.

Without a world the mesh is this one process: `make_mesh(dp=N,
devices=[...])` gives N in-process replicas, replica r on devices[r]
(several may share a card).

The JAX package's multi-host rule for dp (each data slice takes chips
from every process, so that every process takes part in every
replica's jit) has no counterpart here: a rank owns one device and
runs its own program, so a replica is simply a set of ranks, and the
ranks of replica r > 0 need not include rank 0 (engine/spmd.py ships
their plans and reads their results over the store).
"""

from __future__ import annotations

import time
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

AXIS_DATA = "data"
AXIS_TENSOR = "tensor"
AXIS_SEQ = "seq"
AXIS_PIPE = "pipe"
AXIS_EXPERT = "expert"
AXES = (AXIS_DATA, AXIS_PIPE, AXIS_SEQ, AXIS_EXPERT, AXIS_TENSOR)


def _sum(group, x: torch.Tensor) -> torch.Tensor:
    """All-reduce (sum) of x over `group`, in place; returns x."""
    import torch.distributed as dist

    opts = dist.AllreduceOptions()
    opts.reduceOp = dist.ReduceOp.SUM
    group.allreduce([x], opts).wait()
    return x


def shard_range(n: int, size: int, rank: int) -> Tuple[int, int]:
    """Rank `rank`'s [lo, hi) of an axis of n entries cut in `size`
    shards of ceil(n / size) (the last one shorter when size does not
    divide n; head and FFN axes always divide)."""
    per = -(-n // size)
    lo = min(n, rank * per)
    return lo, min(n, lo + per)


class TensorGroup:
    """The tensor axis as the forwards see it: this rank's index, the
    axis size and its process group. The collectives run in place on
    the tensors the forwards hand over; every rank gets bit-identical
    results (a sum over the same values, the same vocabulary gather)."""

    def __init__(self, size: int, rank: int, group=None):
        self.size = size
        self.rank = rank
        self.group = group

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """Sum of x over the tensor axis (row-parallel projections, the
        vocab-parallel embedding), in place; returns x. A one-rank axis
        with no process group is a no-op."""
        return x if self.group is None else _sum(self.group, x)

    def vocab_range(self, vocab: int) -> Tuple[int, int]:
        return shard_range(vocab, self.size, self.rank)

    def gather_vocab(self, local: torch.Tensor, vocab: int) -> torch.Tensor:
        """Full [..., vocab] logits on every rank from each rank's
        [..., hi - lo] shard. Written as an all_reduce into a zeroed
        buffer (each rank fills its own columns): gloo has no all_gather
        for CUDA tensors, and a sum with zeros is exact."""
        if self.size == 1:
            return local
        lo, hi = self.vocab_range(vocab)
        full = torch.zeros(*local.shape[:-1], vocab, dtype=local.dtype,
                           device=local.device)
        full[..., lo:hi] = local
        return self.all_reduce(full)


class ExpertGroup:
    """The expert axis as an MoE layer sees it: this rank's expert index,
    the axis size, and the process group of its (expert, tensor) plane
    (the ep x tp ranks of its replica, stage and seq index). The rank
    holds experts [e0, e1) = expert_range(E) of every MoE layer; its
    FFN output is a partial sum over those experts (and over its F / tp
    slice), and `all_reduce` adds every partial of the plane at once."""

    def __init__(self, size: int, index: int, group=None):
        self.size = size
        self.index = index
        self.group = group

    def expert_range(self, num_experts: int) -> Tuple[int, int]:
        return shard_range(num_experts, self.size, self.index)

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """Sum of x over the (expert, tensor) plane, in place; returns x."""
        return x if self.group is None else _sum(self.group, x)


class _PointToPoint:
    """Point-to-point hand-offs over one process group, shared by the
    pipe and seq axes. A CUDA tensor crosses a gloo group through pinned
    host buffers, staged here explicitly (gloo moves host memory; a raw
    send of device memory aborts the sender); an NCCL group sends device
    memory directly. Buffers are keyed by the caller's slot and reused
    once the hand-off that used them completed. `stats` sums the bytes
    sent and, in seconds, the host staging copies (staging_s), posting
    sends and completing them (send_s) and posting and completing
    receives (recv_s: this includes the wait for the peer's compute)."""

    def __init__(self, ranks: Sequence[int], group=None,
                 backend: Optional[str] = None):
        self.ranks = [int(r) for r in ranks]
        self.group = group
        self.backend = backend
        self._bufs: dict = {}
        self.stats = {"bytes": 0, "staging_s": 0.0, "send_s": 0.0,
                      "recv_s": 0.0}

    def _staged(self, device: torch.device) -> bool:
        return device.type == "cuda" and self.backend != "nccl"

    def _host(self, key, shape, dtype) -> torch.Tensor:
        buf = self._bufs.get(key)
        if buf is None or buf.shape != shape or buf.dtype != dtype:
            buf = torch.empty(shape, dtype=dtype,
                              pin_memory=torch.cuda.is_available())
            self._bufs[key] = buf
        return buf

    def _post_send(self, x: torch.Tensor, peer: int, slot):
        """Post x to group rank `peer`; returns (work, the tensor sent),
        which must stay alive until the work completed."""
        payload = x.contiguous()
        if self._staged(x.device):
            # The copy would wait for the producer's compute anyway;
            # waiting first keeps that wait out of the staging time.
            torch.cuda.current_stream(x.device).synchronize()
            t1 = time.perf_counter()
            buf = self._host(("send", slot), payload.shape, payload.dtype)
            buf.copy_(payload)
            self.stats["staging_s"] += time.perf_counter() - t1
            payload = buf
        t0 = time.perf_counter()
        work = self.group.send([payload], peer, 0)
        self.stats["bytes"] += payload.numel() * payload.element_size()
        self.stats["send_s"] += time.perf_counter() - t0
        return work, payload

    def _post_recv(self, shape, dtype, peer: int, device: torch.device,
                   slot):
        """Post a receive from group rank `peer`; returns (work, buffer)
        for `_landed`."""
        t0 = time.perf_counter()
        if self._staged(device):
            buf = self._host(("recv", slot), tuple(shape), dtype)
        else:
            buf = torch.empty(shape, dtype=dtype, device=device)
        work = self.group.recv([buf], peer, 0)
        self.stats["recv_s"] += time.perf_counter() - t0
        return work, buf

    def _landed(self, work, buf: torch.Tensor,
                device: torch.device) -> torch.Tensor:
        """Wait for a posted receive; its tensor on `device`."""
        t0 = time.perf_counter()
        work.wait()
        t1 = time.perf_counter()
        self.stats["recv_s"] += t1 - t0
        if buf.device == device:
            return buf
        out = buf.to(device)
        self.stats["staging_s"] += time.perf_counter() - t1
        return out


class PipeGroup(_PointToPoint):
    """The pipe axis as a stage sees it: this rank's stage, the stage
    count, the global rank of every stage of its pipeline and their
    process group. Hand-offs are point to point: a stage sends its
    activations to a later stage and receives from an earlier one, in
    the same order on both sides.

    Sends are asynchronous and `flush` waits for them (the end of each
    forward), so a send buffer is reused only after its send completed.
    Beside the hand-offs' stats (_PointToPoint), `stats` counts sends
    and receives and sums the wall time of whole forwards (forward_s,
    parallel/pipeline.py); recv_s is the pipeline's bubble as this
    stage sees it."""

    def __init__(self, size: int, stage: int, ranks: Sequence[int],
                 group=None, backend: Optional[str] = None):
        super().__init__(ranks, group, backend)
        self.size = size
        self.stage = stage
        self._pending: list = []
        self._n = 0  # hand-offs since the last flush: a buffer each
        self.stats.update(forwards=0, forward_s=0.0, sends=0, recvs=0)

    @property
    def first(self) -> bool:
        return self.stage == 0

    @property
    def last(self) -> bool:
        return self.stage == self.size - 1

    def send(self, x: torch.Tensor, stage: int) -> None:
        """Post x to `stage` (asynchronous; flush() completes it)."""
        # The group's ranks are this pipeline's stages, in stage order.
        self._pending.append(self._post_send(x, stage, self._n))
        self._n += 1
        self.stats["sends"] += 1

    def recv(self, shape, dtype, stage: int, device) -> torch.Tensor:
        """Receive the next tensor `stage` sent to this one (blocks)."""
        device = torch.device(device)
        work, buf = self._post_recv(shape, dtype, stage, device, self._n)
        self._n += 1
        self.stats["recvs"] += 1
        return self._landed(work, buf, device)

    def flush(self) -> None:
        """Wait for every posted send (their buffers are then free)."""
        t0 = time.perf_counter()
        pending, self._pending = self._pending, []
        for work, _ in pending:
            work.wait()
        self._n = 0
        self.stats["send_s"] += time.perf_counter() - t0


class SeqGroup(_PointToPoint):
    """The seq axis as a sequence shard sees it: this rank's shard index,
    the shard count, the global rank of every shard of its ring (in seq
    order) and their process group. `rotate` is the ring's hand-off: a
    shard sends its tensor to the next shard and receives the previous
    shard's, the send and the receive posted together (at sp 2 next and
    previous are one peer; the even shards send first and the odd ones
    receive first, the order NCCL needs), then waits for both. Beside
    the hand-offs' stats (_PointToPoint), `stats` counts the hand-offs
    and sums the wall time of whole prefills (prefill_s,
    models/llama.py)."""

    def __init__(self, size: int, index: int, ranks: Sequence[int],
                 group=None, backend: Optional[str] = None):
        super().__init__(ranks, group, backend)
        self.size = size
        self.index = index
        self.stats.update(prefills=0, prefill_s=0.0, handoffs=0)

    @property
    def next(self) -> int:
        return (self.index + 1) % self.size

    @property
    def prev(self) -> int:
        return (self.index - 1) % self.size

    def rotate(self, x: torch.Tensor) -> torch.Tensor:
        """Send x to the next shard; return the previous shard's tensor
        of the same shape and dtype, on x's device (blocks until both
        halves completed)."""
        # The group's ranks are the ring's shards, in seq order.
        def send():
            return self._post_send(x, self.next, 0)

        def recv():
            return self._post_recv(x.shape, x.dtype, self.prev, x.device, 0)

        if self.index % 2 == 0:
            (sent, _), (got, buf) = send(), recv()
        else:
            (got, buf), (sent, _) = recv(), send()
        t0 = time.perf_counter()
        sent.wait()
        self.stats["send_s"] += time.perf_counter() - t0
        self.stats["handoffs"] += 1
        return self._landed(got, buf, x.device)

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """Sum of x over the seq axis, in place; returns x."""
        return _sum(self.group, x)


class RankMesh:
    """A (data, pipe, seq, expert, tensor) grid of ranks. `ranks` holds
    the global rank of every grid point (a replica's submesh starts at
    `first`), `rank` is this process's global rank, or None when the
    process holds no rank of this grid (rank 0's view of a replica
    r > 0), and `devices[i]` is the device of rank first + i; `tensor`
    is the TensorGroup the forwards take (None at tp 1), `pipe` the
    PipeGroup of this rank's pipeline (None at pp 1), `seq` the
    SeqGroup of its ring (None at sp 1) and `expert` the ExpertGroup of
    its (expert, tensor) plane (None at ep 1). `world` is the
    rank world (parallel/distributed.World) the grid spans, None for
    this one process."""

    def __init__(self, shape: dict, rank: Optional[int], devices: Sequence,
                 group=None, backend: Optional[str] = None,
                 labels: Optional[Sequence[str]] = None, pipe_group=None,
                 first: int = 0, world=None, seq_group=None,
                 expert_group=None):
        self.world = world
        self.shape = {a: int(shape.get(a, 1)) for a in AXES}
        self.axis_names = AXES
        self.rank = rank
        self.first = first
        self.devices = [torch.device(d) for d in devices]
        self.ranks = first + np.arange(len(self.devices)).reshape(
            tuple(self.shape[a] for a in AXES))
        self.backend = backend
        # "host|device" per rank: devices of different hosts are distinct.
        self.labels = list(labels) if labels is not None else [
            str(d) for d in self.devices]
        self.coord = self.tensor = self.pipe = self.seq = self.expert = None
        if rank is None:
            return
        coord = dict(zip(AXES, (int(i) for i in
                                np.argwhere(self.ranks == rank)[0])))
        self.coord = coord
        tp, pp = self.shape[AXIS_TENSOR], self.shape[AXIS_PIPE]
        self.tensor = (TensorGroup(tp, coord[AXIS_TENSOR], group)
                       if tp > 1 else None)
        line = self.ranks[coord[AXIS_DATA], :, coord[AXIS_SEQ],
                          coord[AXIS_EXPERT], coord[AXIS_TENSOR]]
        self.pipe = (PipeGroup(pp, coord[AXIS_PIPE], line.tolist(),
                               pipe_group, backend) if pp > 1 else None)
        sp = self.shape[AXIS_SEQ]
        ring = self.ranks[coord[AXIS_DATA], coord[AXIS_PIPE], :,
                          coord[AXIS_EXPERT], coord[AXIS_TENSOR]]
        self.seq = (SeqGroup(sp, coord[AXIS_SEQ], ring.tolist(), seq_group,
                             backend) if sp > 1 else None)
        ep = self.shape[AXIS_EXPERT]
        self.expert = (ExpertGroup(ep, coord[AXIS_EXPERT], expert_group)
                       if ep > 1 else None)

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def tp(self) -> int:
        return self.shape[AXIS_TENSOR]

    @property
    def pp(self) -> int:
        return self.shape[AXIS_PIPE]

    @property
    def dp(self) -> int:
        return self.shape[AXIS_DATA]

    @property
    def sp(self) -> int:
        return self.shape[AXIS_SEQ]

    @property
    def ep(self) -> int:
        return self.shape[AXIS_EXPERT]

    @property
    def device(self) -> torch.device:
        """This rank's device (a grid this process holds no rank of: its
        first rank's)."""
        return self.devices[(self.rank if self.rank is not None
                             else self.first) - self.first]

    @property
    def n_devices(self) -> int:
        """Distinct devices under the mesh (two ranks on one card: 1)."""
        return len(set(self.labels))

    def __repr__(self) -> str:
        return (f"RankMesh({self.shape}, rank={self.rank}, "
                f"devices={[str(d) for d in self.devices]})")


def make_mesh(dp: int = 1, tp: int = -1, sp: int = 1, pp: int = 1,
              ep: int = 1, devices: Optional[Sequence] = None,
              rank: Optional[int] = None, world=None) -> RankMesh:
    """Build a (data, pipe, seq, expert, tensor) mesh of ranks.

    `tp=-1` means "all ranks not consumed by dp*pp*sp*ep". The ranks are
    those of `world` (parallel/distributed.World; default the world
    distributed.initialize brought up, if any): `devices` then lists
    each rank's device, default the one each rank published. Without a
    world, `devices` (default one CPU rank per replica) are this
    process's dp in-process replicas, replica r on devices[r]. This rank
    builds the tensor group of its (replica, stage, seq index, expert
    index), then the pipe group of its (replica, seq index, expert
    index, tensor index), then the seq group of its (replica, stage,
    expert index, tensor index), then the (expert, tensor) plane of its
    (replica, stage, seq index), on the world's store; every rank
    builds its groups in that order."""
    from ollamamq_tpu_torch.parallel import distributed

    if pp < 1 or dp < 1 or sp < 1 or ep < 1:
        raise ValueError(f"dp, pp, sp and ep must be >= 1, got dp={dp} "
                         f"pp={pp} sp={sp} ep={ep}")
    if world is None:
        world = distributed.default_world()
    n = world.size if world is not None else len(devices or ["cpu"] * dp)
    labels = ([world.device_label(r) for r in range(n)]
              if world is not None else None)
    if devices is None:
        devices = ([lb.split("|", 1)[1] for lb in labels] if labels
                   else ["cpu"] * n)
    if len(devices) != n:
        raise ValueError(f"{len(devices)} devices for a world of {n} ranks")
    outer = dp * pp * sp * ep
    if tp == -1:
        tp = n // outer if n % outer == 0 else -1
    if outer * tp != n:
        raise ValueError(f"dp*pp*sp*ep*tp={outer * tp} over {n} ranks: "
                         "the mesh must span every rank of the world")
    if rank is None:
        rank = world.rank if world is not None else 0
    shape = {AXIS_DATA: dp, AXIS_PIPE: pp, AXIS_SEQ: sp, AXIS_EXPERT: ep,
             AXIS_TENSOR: tp}
    group = pipe_group = seq_group = expert_group = None
    if world is not None:
        grid = np.arange(n).reshape(dp, pp, sp, ep, tp)
        r, s, q, e, t = (int(i) for i in np.argwhere(grid == rank)[0])
        if tp > 1:
            group = world.group(grid[r, s, q, e].tolist())
        if pp > 1:
            pipe_group = world.group(grid[r, :, q, e, t].tolist())
        if sp > 1:
            seq_group = world.group(grid[r, s, :, e, t].tolist())
        if ep > 1:
            expert_group = world.group(grid[r, s, q].reshape(-1).tolist())
    return RankMesh(shape, rank, devices,
                    group=group, pipe_group=pipe_group, seq_group=seq_group,
                    expert_group=expert_group,
                    backend=world.backend if world is not None else None,
                    labels=labels, world=world)


def replica_ranks(mesh: RankMesh, r: int) -> list:
    """The global ranks of replica r, its first rank first."""
    return mesh.ranks[r].reshape(-1).tolist()


def replica_submesh(mesh: RankMesh, r: int) -> RankMesh:
    """Replica r's slice of the data axis (a [1, pp, sp, ep, tp] grid of its
    ranks): THE derivation, shared by the engine's replica construction
    and the SPMD worker's replay and reload, which must agree on every
    rank. Its rank is this process's when it holds one of replica r's
    ranks, else None; its groups are this rank's (the groups of its own
    replica). An in-process mesh's replica r is one rank on
    devices[r]."""
    if mesh.dp == 1:
        return mesh
    per = mesh.pp * mesh.sp * mesh.ep * mesh.tp
    lo = r * per
    if mesh.backend is None and per == 1:  # in-process replicas
        return RankMesh({}, 0, [mesh.devices[r]])
    mine = mesh.rank is not None and lo <= mesh.rank < lo + per
    return RankMesh({AXIS_PIPE: mesh.pp, AXIS_SEQ: mesh.sp,
                     AXIS_EXPERT: mesh.ep, AXIS_TENSOR: mesh.tp},
                    mesh.rank if mine else None, mesh.devices[lo:lo + per],
                    group=mesh.tensor.group if mine and mesh.tensor else None,
                    pipe_group=mesh.pipe.group if mine and mesh.pipe else None,
                    seq_group=mesh.seq.group if mine and mesh.seq else None,
                    expert_group=(mesh.expert.group if mine and mesh.expert
                                  else None),
                    backend=mesh.backend, labels=mesh.labels[lo:lo + per],
                    first=lo, world=mesh.world)


def replica_of(mesh: RankMesh) -> int:
    """The replica this process's rank serves (0 without a data axis)."""
    return mesh.coord[AXIS_DATA] if mesh.coord is not None else 0


def validate_tp_for_model(tp: int, num_kv_heads: int, num_heads: int) -> None:
    """TP must divide the head counts so shards stay aligned.

    tp > num_kv_heads is allowed when tp % num_kv_heads == 0: the runtime
    duplicates each KV head tp/num_kv_heads times at load
    (weights.replicate_kv_heads) so every shard owns one copy — the
    replicated-group sharding, at the cost of that factor in KV-cache
    memory (e.g. qwen2.5's 4 KV heads on tp=8 cost 2x KV memory)."""
    if num_heads % tp != 0:
        raise ValueError(f"num_heads={num_heads} not divisible by tp={tp}")
    if num_kv_heads % tp != 0 and tp % num_kv_heads != 0:
        raise ValueError(
            f"num_kv_heads={num_kv_heads} incompatible with tp={tp}: "
            "needs kv_heads % tp == 0 (sharded) or tp % kv_heads == 0 "
            "(replicated groups)"
        )

