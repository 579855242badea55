"""Multi-process control plane: torch.distributed and its TCPStore.

The JAX package's deployment is one SPMD program across hosts wired by
`jax.distributed.initialize`. Here every rank is a process: rank 0 hosts
a `TCPStore` (the key-value store the step wire, the status syncs and
the heartbeats of engine/spmd.py ride on), and the mesh's process
groups for the model's collectives are built on that store (`World`).
Rank 0 additionally runs the HTTP front and the scheduler. A process
runs in one world (`initialize`), except a fleet router, which is rank
0 of one world per member wider than one rank (`open_world`).

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

_default: Optional["World"] = None


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


class World:
    """One rank world as this process sees it: the coordinator's store
    (rank 0 hosts it), this process's rank, the world's size, every
    rank's device as it published it, and the process groups its meshes
    run their collectives over. A process is a rank of one world, except
    that rank 0 may lead several: a fleet router is rank 0 of the world
    of every member wider than one rank (fleet/wide.py).

    The groups are backends built on this world's own store (gloo, or
    NCCL for CUDA ranks), never torch.distributed's process-global
    default group, so several worlds live side by side in one process.
    Each thread gets its own store client (the engine thread, the
    heartbeat and the health monitor never share a socket)."""

    def __init__(self, host: str, port: int, rank: int, size: int,
                 device: torch.device, backend: str,
                 timeout: datetime.timedelta, server=None):
        self.host, self.port = host, port
        self.rank, self.size = rank, size
        self.device, self.backend, self.timeout = device, backend, timeout
        self._server = server  # rank 0's store: the world lives while it does
        self._local = threading.local()
        self._groups: dict = {}
        self._group_store = None

    def store(self):
        """This thread's client of the world's store."""
        import torch.distributed as dist

        st = getattr(self._local, "store", None)
        if st is None:
            st = dist.TCPStore(self.host, self.port, is_master=False,
                               timeout=self.timeout, wait_for_workers=False)
            self._local.store = st
        return st

    def device_label(self, r: int) -> str:
        """"host|device" of rank r, as that rank published it."""
        return self.store().get(f"ollamamq/dev/{r}").decode()

    def group(self, ranks: Sequence[int]):
        """The process group of `ranks` (global ranks, in group-rank
        order), built once per world; only a rank of the group may ask.
        Every rank of the group must ask for it in the same order as the
        others (gloo connects at construction)."""
        import torch.distributed as dist

        ranks = [int(r) for r in ranks]
        key = "-".join(map(str, ranks))
        pg = self._groups.get(key)
        if pg is not None:
            return pg
        if self.rank not in ranks:
            raise ValueError(f"rank {self.rank} is not in group {ranks}")
        if self._group_store is None:
            self._group_store = dist.TCPStore(
                self.host, self.port, is_master=False, timeout=self.timeout,
                wait_for_workers=False)
        prefix = dist.PrefixStore(f"pg/{key}/", self._group_store)
        me, n = ranks.index(self.rank), len(ranks)
        if self.backend == "nccl":
            opts = dist.ProcessGroupNCCL.Options()
            opts._timeout = self.timeout
            pg = dist.ProcessGroupNCCL(prefix, me, n, opts)
        else:
            pg = dist.ProcessGroupGloo(prefix, me, n, self.timeout)
        self._groups[key] = pg
        return pg

    def close(self) -> None:
        """Drop the groups and the store clients (rank 0: the store)."""
        self._groups.clear()
        self._group_store = None
        self._local = threading.local()
        self._server = None


def open_world(coordinator_address: str, num_processes: int, process_id: int,
               backend: Optional[str] = None,
               devices: Optional[Sequence] = None,
               timeout_s: float = DEFAULT_TIMEOUT_S, on_store=None,
               set_device: bool = True) -> World:
    """Join (rank 0: host) the world whose store is at
    `coordinator_address` ("host:port"; port 0 lets rank 0 pick a free
    one). `devices` lists every rank's device (default cuda:{LOCAL_RANK
    or rank}); `backend` defaults to nccl for a CUDA device and gloo
    otherwise. `on_store(port)` runs once rank 0's store is up (it starts
    the other ranks). `set_device`: make this rank's card the process's
    current one (a router leading several worlds leaves its own as is).
    Every rank publishes where it runs: the mesh's device list, and the
    distinct devices MFU divides by (two ranks may share a card)."""
    import torch.distributed as dist

    rank, world = int(process_id or 0), int(num_processes or 1)
    device = _rank_device(rank, devices)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    host, _, port = coordinator_address.rpartition(":")
    host = host or "127.0.0.1"
    timeout = datetime.timedelta(seconds=timeout_s)
    server = dist.TCPStore(host, int(port), world, is_master=rank == 0,
                           timeout=timeout, wait_for_workers=False)
    if on_store is not None:
        on_store(server.port)
    if device.type == "cuda" and set_device:
        torch.cuda.set_device(device)
    w = World(host, server.port, rank, world, device, backend, timeout,
              server=server)
    w._local.store = server
    server.set(f"ollamamq/dev/{rank}", f"{socket.gethostname()}|{device}")
    log.info("rank world up: rank %d/%d on %s (%s, store %s:%d)",
             rank, world, device, backend, host, server.port)
    return w


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None,
               devices: Optional[Sequence] = None,
               timeout_s: float = DEFAULT_TIMEOUT_S,
               on_store=None) -> bool:
    """Bring up this process's world (open_world). No-op for one process.

    Args fall back to torch.distributed's env names: MASTER_ADDR and
    MASTER_PORT (the coordinator, rank 0's store), WORLD_SIZE and RANK.
    Multi-process is OPT-IN via those (or explicit args). Returns True if
    a world was brought up."""
    global _default
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
    _default = open_world(coordinator_address, num_processes or 1,
                          process_id or 0, backend=backend, devices=devices,
                          timeout_s=timeout_s, on_store=on_store)
    return True


def default_world() -> Optional[World]:
    """The world initialize() brought up (None: none)."""
    return _default


def initialized() -> bool:
    return _default is not None


def rank() -> int:
    return _default.rank if _default is not None else 0


def world_size() -> int:
    return _default.size if _default is not None else 1


def device() -> Optional[torch.device]:
    return _default.device if _default is not None else None


def device_label(r: int) -> str:
    """"host|device" of rank r, as that rank published it."""
    return _default.device_label(r)


def store():
    """This thread's client of the coordinator's store."""
    return _default.store()


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


def exit_process(code: int = 0) -> None:
    """End a rank's process once its world is done, past the
    interpreter's teardown: flush the logs and stdio, then os._exit.
    Torch's C++ teardown of a process's live gloo groups at exit can
    abort it after a clean run (std::terminate: "terminate called
    without an active exception", exit -6), about one rank process in a
    hundred of two-rank worlds on a loaded host."""
    import sys

    logging.shutdown()
    for f in (sys.stdout, sys.stderr):
        try:
            f.flush()
        except (OSError, ValueError):  # closed or gone: nothing to flush
            pass
    os._exit(code)


def shutdown() -> None:
    """Leave this process's world: drop its groups and store clients (a
    process may bring up another world afterwards)."""
    global _default
    if _default is not None:
        _default.close()
    _default = None
