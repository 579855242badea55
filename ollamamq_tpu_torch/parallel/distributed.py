"""Multi-process control plane: torch.distributed and its TCPStore.

The JAX package's deployment is one SPMD program across hosts wired by
`jax.distributed.initialize`. Here every rank is a process: rank 0 hosts
a `TCPStore` (the key-value store the step wire, the status syncs and
the heartbeats of engine/spmd.py ride on) and every rank joins one
process group over it for the model's collectives. Rank 0 additionally
runs the HTTP front and the scheduler.

The backend is an explicit choice: `nccl` for CUDA ranks and `gloo` for
CPU ranks by default, never switched because a device is missing (two
ranks sharing one card must ask for gloo, since NCCL refuses two ranks
on one GPU). Collectives time out after `timeout_s` seconds, so a dead
peer surfaces as an error instead of a hang.
"""

from __future__ import annotations

import datetime
import logging
import os
import socket
import threading
from typing import Optional, Sequence

import torch

log = logging.getLogger("ollamamq.torch.distributed")

DEFAULT_TIMEOUT_S = 120.0

_state: dict = {}
_local = threading.local()


def _env_int(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return int(v) if v else None


def multiprocess_configured() -> bool:
    """True when the env opts into a multi-process runtime (MASTER_ADDR,
    or a WORLD_SIZE other than 1): the SAME condition initialize() uses
    to decide whether to bring one up."""
    n = _env_int("WORLD_SIZE")
    return bool(os.environ.get("MASTER_ADDR")) or n not in (None, 1)


def _rank_device(rank: int, devices: Optional[Sequence]) -> torch.device:
    """Rank `rank`'s device: devices[rank] when given, else
    cuda:{LOCAL_RANK or rank}, which must exist (no fallback)."""
    if devices is not None:
        return torch.device(devices[rank])
    local = _env_int("LOCAL_RANK")
    idx = local if local is not None else rank
    if not torch.cuda.is_available() or idx >= torch.cuda.device_count():
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        raise RuntimeError(
            f"rank {rank} needs cuda:{idx}, but this host has {have} CUDA "
            "device(s); pass --device cpu (gloo) or run fewer ranks per host")
    return torch.device(f"cuda:{idx}")


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None,
               devices: Optional[Sequence] = None,
               timeout_s: float = DEFAULT_TIMEOUT_S,
               on_store=None) -> bool:
    """Bring up the store and the process group. No-op for one process.

    Args fall back to torch.distributed's env names: MASTER_ADDR and
    MASTER_PORT (the coordinator, rank 0's store), WORLD_SIZE and RANK.
    Multi-process is OPT-IN via those (or explicit args). `devices` lists
    every rank's device (default cuda:{LOCAL_RANK or rank}); `backend`
    defaults to nccl for a CUDA device and gloo otherwise. Port 0 lets
    rank 0 pick a free port: `on_store(port)` runs once rank 0's store is
    up and before the group forms (it starts the other ranks).
    Returns True if a process group was initialized."""
    import torch.distributed as dist

    if not coordinator_address and os.environ.get("MASTER_ADDR"):
        coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                               f"{os.environ.get('MASTER_PORT', '29500')}")
    num_processes = (num_processes if num_processes is not None
                     else _env_int("WORLD_SIZE"))
    process_id = process_id if process_id is not None else _env_int("RANK")
    if not coordinator_address and num_processes in (None, 1):
        return False
    if not coordinator_address:
        raise ValueError("a multi-process run needs a coordinator address "
                         "(MASTER_ADDR / MASTER_PORT)")
    rank = int(process_id or 0)
    world = int(num_processes or 1)
    device = _rank_device(rank, devices)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    host, _, port = coordinator_address.rpartition(":")
    timeout = datetime.timedelta(seconds=timeout_s)
    store = dist.TCPStore(host or "127.0.0.1", int(port), world,
                          is_master=rank == 0, timeout=timeout,
                          wait_for_workers=False)
    if on_store is not None:
        on_store(store.port)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, store=dist.PrefixStore("pg", store),
                            rank=rank, world_size=world, timeout=timeout)
    _state.update(store=store, host=host or "127.0.0.1", port=store.port,
                  rank=rank, world=world, device=device,
                  timeout=timeout, gen=_state.get("gen", 0) + 1)
    _local.store, _local.gen = store, _state["gen"]
    # Every rank publishes where it runs: the mesh's device list, and
    # the distinct devices MFU divides by (two ranks may share a card).
    store.set(f"ollamamq/dev/{rank}", f"{socket.gethostname()}|{device}")
    log.info("distributed runtime up: rank %d/%d on %s (%s, store %s:%d)",
             rank, world, device, backend, _state["host"], store.port)
    return True


def initialized() -> bool:
    return "store" in _state


def rank() -> int:
    return _state.get("rank", 0)


def world_size() -> int:
    return _state.get("world", 1)


def device() -> Optional[torch.device]:
    return _state.get("device")


def device_label(r: int) -> str:
    """"host|device" of rank r, as that rank published it."""
    return store().get(f"ollamamq/dev/{r}").decode()


def store():
    """This thread's client of the coordinator's store (the engine
    thread, the heartbeat and the health monitor each get their own
    connection, so no two threads share a socket)."""
    st = getattr(_local, "store", None)
    if st is None or getattr(_local, "gen", None) != _state.get("gen"):
        import torch.distributed as dist

        st = dist.TCPStore(_state["host"], _state["port"], is_master=False,
                           timeout=_state["timeout"], wait_for_workers=False)
        _local.store, _local.gen = st, _state["gen"]
    return st


def is_primary() -> bool:
    """The process that runs the HTTP front and the scheduler (rank 0)."""
    return rank() == 0


def die_with_parent() -> None:
    """(child, before exec) Linux: SIGKILL this process when its parent
    dies, so a worker rank never outlives a leader killed with -9."""
    try:
        import ctypes
        import signal

        ctypes.CDLL("libc.so.6", use_errno=True).prctl(1, signal.SIGKILL)
    except (OSError, AttributeError):
        pass


def reap(procs, timeout_s: float = 15.0) -> None:
    """Wait for worker rank processes to exit (they do after the
    leader's shutdown op); kill those still running after `timeout_s`."""
    import subprocess
    import time

    deadline = time.monotonic() + timeout_s
    for p in procs:
        try:
            p.wait(timeout=max(0.1, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait(timeout=10)


def shutdown() -> None:
    """Leave the process group and drop the store clients (a process may
    bring up another world afterwards)."""
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()
    gen = _state.get("gen", 0)
    _state.clear()
    _state["gen"] = gen  # clients of the old store are never reused
    _local.store = None
