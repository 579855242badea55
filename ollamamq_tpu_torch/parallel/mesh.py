"""The rank mesh: the JAX package's device mesh as a grid of processes.

The JAX package runs tensor parallelism in one process: a
jax.sharding.Mesh names five axes over the chips and GSPMD inserts the
collectives. PyTorch has no single controller, so here each rank is a
process (torch.distributed), the mesh is a grid of ranks with the same
five axes in the same order,

  - "data":   replicas (not ported yet)
  - "pipe":   pipeline stages (not ported yet)
  - "seq":    sequence shards (not ported yet)
  - "expert": expert shards (not ported yet)
  - "tensor": tensor parallelism within a replica: attention heads, FFN
              hidden dims and the vocabulary sharded; the forwards call
              the collectives themselves (TensorGroup)

and the tensor axis carries a process group. Several ranks may share one
device (two ranks on one card over gloo); `n_devices` counts the distinct
devices, which is what MFU divides by.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

AXIS_DATA = "data"
AXIS_TENSOR = "tensor"
AXIS_SEQ = "seq"
AXIS_PIPE = "pipe"
AXIS_EXPERT = "expert"
AXES = (AXIS_DATA, AXIS_PIPE, AXIS_SEQ, AXIS_EXPERT, AXIS_TENSOR)


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
        vocab-parallel embedding), in place; returns x. A one-rank group
        with no process group is a no-op."""
        if self.size > 1 or self.group is not None:
            import torch.distributed as dist

            dist.all_reduce(x, op=dist.ReduceOp.SUM, group=self.group)
        return x

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


class RankMesh:
    """A (data, pipe, seq, expert, tensor) grid of ranks. `rank` is this
    process's place in it and `devices[r]` rank r's device; `tensor` is
    the TensorGroup the forwards take (None at tp 1)."""

    def __init__(self, shape: dict, rank: int, devices: Sequence,
                 group=None, backend: Optional[str] = None,
                 labels: Optional[Sequence[str]] = None):
        self.shape = {a: int(shape.get(a, 1)) for a in AXES}
        self.axis_names = AXES
        self.rank = rank
        self.devices = [torch.device(d) for d in devices]
        self.ranks = np.arange(len(self.devices)).reshape(
            tuple(self.shape[a] for a in AXES))
        self.backend = backend
        # "host|device" per rank: devices of different hosts are distinct.
        self.labels = list(labels) if labels is not None else [
            str(d) for d in self.devices]
        tp = self.shape[AXIS_TENSOR]
        self.tensor = TensorGroup(tp, rank % tp, group) if tp > 1 else None

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def tp(self) -> int:
        return self.shape[AXIS_TENSOR]

    @property
    def device(self) -> torch.device:
        return self.devices[self.rank]

    @property
    def n_devices(self) -> int:
        """Distinct devices under the mesh (two ranks on one card: 1)."""
        return len(set(self.labels))

    def __repr__(self) -> str:
        return (f"RankMesh({self.shape}, rank={self.rank}, "
                f"devices={[str(d) for d in self.devices]})")


def make_mesh(dp: int = 1, tp: int = -1, sp: int = 1, pp: int = 1,
              ep: int = 1, devices: Optional[Sequence] = None,
              rank: Optional[int] = None) -> RankMesh:
    """Build a (data, pipe, seq, expert, tensor) mesh of ranks.

    `tp=-1` means "all ranks not consumed by dp*pp*sp*ep". The ranks are
    the torch.distributed world when one is up (`devices` then lists
    each rank's device, default the one distributed.initialize gave this
    process for every rank), else `devices` (default one CPU rank). The
    tensor axis' process group is the world's. An axis other than
    "tensor" larger than 1 is not ported yet."""
    import torch.distributed as dist

    from ollamamq_tpu_torch.parallel import distributed

    for axis, n in ((AXIS_DATA, dp), (AXIS_PIPE, pp), (AXIS_SEQ, sp),
                    (AXIS_EXPERT, ep)):
        if n != 1:
            raise NotImplementedError(
                f"mesh axis {axis!r} = {n}: only the tensor axis is ported "
                "yet (data, pipe, seq and expert parallelism are not)")
    up = dist.is_available() and dist.is_initialized()
    n = dist.get_world_size() if up else len(devices or ["cpu"])
    labels = ([distributed.device_label(r) for r in range(n)]
              if up and distributed.initialized() else None)
    if devices is None:
        devices = ([lb.split("|", 1)[1] for lb in labels] if labels
                   else ["cpu"] * n)
    if len(devices) != n:
        raise ValueError(f"{len(devices)} devices for a world of {n} ranks")
    if tp == -1:
        tp = n
    if tp != n:
        raise ValueError(f"dp*pp*sp*ep*tp={tp} over {n} ranks: the mesh must "
                         "span every rank of the world")
    if rank is None:
        rank = dist.get_rank() if up else 0
    return RankMesh({AXIS_TENSOR: tp}, rank, devices,
                    backend=dist.get_backend() if up else None,
                    labels=labels)


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
