"""Fleet members wider than one rank: each leads a rank world of its own.

A fleet member at tp x pp x sp x ep (x dp) > 1 ranks is an SPMDEngine
(engine/spmd.py) over a world that belongs to that member alone. The
router's process is rank 0 of every such world: it hosts the world's
store and its control plane, runs the member's scheduler on rank 0's
shard, and starts the member's other ranks as `python -m
ollamamq_tpu_torch.fleet.wide` processes, which replay its step plans
with their shards (spmd.run_worker) and die with the router
(PR_SET_PDEATHSIG). The world lives as long as the engine:
SPMDEngine.stop releases the ranks, reaps them and closes the world, so
a member rebuilt at another width (a tier regroup) or retired (a
scale-down) leaves no rank behind. The engine, its journal, its page
allocator and in-process migration stay in the router's process, as
for a one-rank member (fleet/members.py LocalMember). Rank 0 records
into the router's registry; the other ranks post their own snapshots
on the world's store, which the router's /metrics merges
(FleetRouter.worker_metric_snapshots), so each rank's steps count once.

Cards (`CardPlan`): on a host with cards, every member holds cards of
its own, disjoint from the other members' (a wide member one per rank,
a one-rank member one, a --dp member one per replica); a member that
cannot get them is refused, at start-up (the CLI exits 2 naming the
missing cuda:k) or at a regroup (the regroup aborts and the member
keeps its tier), and nothing falls back to a shared or smaller set. A
fleet with no member or tier wider than one rank keeps every member on
--device, as before. On the CPU every rank runs on the CPU.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import queue
import subprocess
import sys
import threading
import time
from concurrent.futures import Future
from typing import Dict, List, Optional, Sequence

log = logging.getLogger("ollamamq.torch.fleet.wide")

# The member's other ranks read their world from this env variable.
SPEC_ENV = "OLLAMAMQ_WIDE_MEMBER"
# The command of a member's rank r > 0 (a test may swap it for one that
# never joins, to exercise a world that cannot start).
WORKER_ARGV = [sys.executable, "-m", "ollamamq_tpu_torch.fleet.wide"]
# Seconds a world's ranks get to publish themselves before its start fails.
JOIN_TIMEOUT_S = 300.0


def member_ranks(cfg) -> int:
    """Processes of a member at `cfg`'s widths: tp x pp x sp x ep per
    replica times dp when tp x pp x sp x ep > 1 (a rank world), else 1
    (--dp alone keeps its replicas in one process)."""
    group = _group(cfg)
    return max(1, cfg.dp) * group if group > 1 else 1


def member_cards(cfg) -> int:
    """Cards a member at `cfg`'s widths holds: one per rank, or one per
    in-process replica."""
    return max(1, cfg.dp) * _group(cfg)


def _group(cfg) -> int:
    """Ranks of one replica at `cfg`'s widths."""
    return (max(1, cfg.tp) * max(1, cfg.pp) * max(1, cfg.sp)
            * max(1, cfg.ep))


class CardPlan:
    """Which cards each fleet member holds. `cards` lists the slots a
    plan hands out (slot i is device cards[i]): the host's cards, one
    slot each, or an explicit list in which one card may stand several
    times (ranks sharing a card, which needs the gloo `backend`: NCCL
    refuses two ranks on one GPU). A member takes the lowest free slots
    it needs (in a row for in-process replicas, which sit on consecutive
    cards), its own counting as free (a member regrouping frees its
    cards first), and gives them back when it leaves. `cards=None`
    hands out `device` for every rank without counting (the CPU, or a
    fleet with no member wider than one rank)."""

    def __init__(self, cards: Optional[Sequence[str]] = None,
                 device: str = "cpu", backend: Optional[str] = None):
        self.cards = list(cards) if cards is not None else None
        self.device = device
        self.backend = backend
        self._held: Dict[str, List[int]] = {}
        self._lock = threading.Lock()

    @property
    def accounted(self) -> bool:
        return self.cards is not None

    def holding(self, name: str) -> Optional[List[int]]:
        with self._lock:
            held = self._held.get(name)
            return list(held) if held is not None else None

    def take(self, name: str, n: int, in_a_row: bool = False) -> List[str]:
        """The devices of the lowest n free slots (`in_a_row`: the lowest
        run of n), now held by `name` instead of what it held.
        RuntimeError naming the missing cards when there are none such."""
        if self.cards is None:
            return [self.device] * n
        with self._lock:
            busy = {i for m, slots in self._held.items() if m != name
                    for i in slots}
            have = len(self.cards)
            free = [i for i in range(have) if i not in busy]
            runs = ([list(range(lo, lo + n)) for lo in range(have - n + 1)
                     if not busy & set(range(lo, lo + n))] if in_a_row
                    else [free[:n]] if len(free) >= n else [])
            if runs:
                self._held[name] = runs[0]
                return [self.cards[i] for i in runs[0]]
            free = len(free)
            missing = ", ".join(f"cuda:{have + i}"
                                for i in range(max(1, n - free)))
            held = {m: [self.cards[i] for i in s]
                    for m, s in sorted(self._held.items()) if m != name}
            raise RuntimeError(
                f"member {name} needs {n} card(s) of its own, but {missing} "
                f"is missing (this host has {have}; held: "
                f"{json.dumps(held)}); no member falls back to a shared or "
                "smaller set")

    def take_member(self, name: str, cfg) -> List[str]:
        """take() for a member at `cfg`'s widths: a card per rank, or per
        in-process replica (those in a row)."""
        return self.take(name, member_cards(cfg),
                         in_a_row=member_ranks(cfg) == 1)

    def assign(self, name: str, slots: Optional[List[int]]) -> None:
        """Set what `name` holds (None: nothing); a failed rebuild puts
        the member's old cards back with it."""
        with self._lock:
            if slots is None:
                self._held.pop(name, None)
            else:
                self._held[name] = list(slots)

    def release(self, name: str) -> None:
        self.assign(name, None)


class _Spawner:
    """Starts rank processes from one long-lived thread. Linux delivers
    PR_SET_PDEATHSIG when the THREAD that forked the child exits, not
    its process, so a rank forked from a short-lived thread (the
    autoscaler's spawn thread) would be killed as that thread ends."""

    def __init__(self):
        self._jobs: "queue.Queue" = queue.Queue()
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()

    def _run(self) -> None:
        while True:
            fut, argv, kw = self._jobs.get()
            try:
                fut.set_result(subprocess.Popen(argv, **kw))
            except BaseException as e:  # noqa: BLE001 — the caller raises it
                fut.set_exception(e)

    def popen(self, argv, **kw) -> subprocess.Popen:
        with self._lock:
            if self._thread is None:
                self._thread = threading.Thread(target=self._run, daemon=True,
                                                name="rank-spawner")
                self._thread.start()
        fut: Future = Future()
        self._jobs.put((fut, argv, kw))
        return fut.result()


_spawner = _Spawner()


def _child_env(rank: int, size: int, port: int, spec: dict) -> dict:
    """A member rank's environment: the router's, less its router-level
    settings (SubprocessProvisioner.ROUTER_ONLY_ENV), plus its world."""
    from ollamamq_tpu_torch.fleet.autoscaler import SubprocessProvisioner

    env = {k: v for k, v in os.environ.items()
           if k not in SubprocessProvisioner.ROUTER_ONLY_ENV}
    env.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(size),
               MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    env[SPEC_ENV] = json.dumps(spec)
    return env


def _await_ranks(world, procs, timeout_s: float) -> None:
    """Every rank published its device, or the start fails: a rank that
    exited first, or one still missing after `timeout_s`, raises (the
    caller kills the others)."""
    client = world.store()
    deadline = time.monotonic() + timeout_s
    for r, p in enumerate(procs, start=1):
        while not client.check([f"ollamamq/dev/{r}"]):
            if p.poll() is not None:
                raise RuntimeError(
                    f"rank {r} of the member's world (pid {p.pid}) exited "
                    f"with {p.returncode} before joining it")
            if time.monotonic() > deadline:
                raise RuntimeError(f"rank {r} of the member's world never "
                                   f"joined it in {timeout_s:.0f}s")
            time.sleep(0.02)


def _abandon(procs, world) -> None:
    """A world that will not serve: kill and reap its started ranks and
    close its store."""
    from ollamamq_tpu_torch.parallel import distributed

    for p in procs:
        p.kill()
    distributed.reap(procs)
    if world is not None:
        world.close()


def start_world(cfg, models: dict, devices: Sequence[str],
                backend: Optional[str] = None,
                timeout_s: float = JOIN_TIMEOUT_S):
    """Bring up a member's rank world: this process is rank 0 on
    devices[0] and starts ranks 1.. on devices[1..] (WORKER_ARGV, each
    dying with this process). Returns (mesh, worker processes); on any
    failure the started ranks are killed and reaped and the error
    propagates."""
    from ollamamq_tpu_torch.parallel import distributed
    from ollamamq_tpu_torch.parallel.mesh import make_mesh

    size = len(devices)
    spec = {"models": models, "ecfg": dataclasses.asdict(cfg),
            "devices": list(devices), "backend": backend,
            "mesh": {"dp": cfg.dp, "tp": max(1, cfg.tp), "pp": cfg.pp,
                     "sp": cfg.sp, "ep": cfg.ep}}
    procs: list = []

    def spawn(port: int) -> None:
        for r in range(1, size):
            procs.append(_spawner.popen(
                WORKER_ARGV, env=_child_env(r, size, port, spec),
                preexec_fn=distributed.die_with_parent))
        log.info("member world of %d ranks: started pids %s", size,
                 [p.pid for p in procs])

    world = None
    try:
        world = distributed.open_world("127.0.0.1:0", size, 0,
                                       backend=backend, devices=devices,
                                       on_store=spawn, set_device=False)
        _await_ranks(world, procs, timeout_s)
        mesh = make_mesh(dp=cfg.dp, tp=max(1, cfg.tp), pp=cfg.pp,
                         sp=cfg.sp, ep=cfg.ep, devices=devices, world=world)
        return mesh, procs
    except BaseException:
        _abandon(procs, world)
        raise


def wide_engine(cfg, models: dict, devices: Sequence[str], fairness=None,
                backend: Optional[str] = None):
    """An SPMDEngine at `cfg`'s widths leading a world of its own on
    `devices` (one per rank); its stop releases and reaps the ranks."""
    from ollamamq_tpu_torch.core.mqcore import Fairness
    from ollamamq_tpu_torch.engine.spmd import SPMDEngine

    mesh, procs = start_world(cfg, models, devices, backend)
    try:
        eng = SPMDEngine(cfg, mesh=mesh, blocklist_path=None,
                         fairness=fairness or Fairness.REQUESTS,
                         models=models)
    except BaseException:
        _abandon(procs, mesh.world)
        raise
    eng.worker_procs = procs
    return eng


class MemberFactory:
    """The engine factory of one fleet member: `factory(tp)` builds the
    member's engine at TP width tp (None: the fleet's) on cards of its
    own from `plan`; the drain's hot restart, a tier regroup and the
    autoscaler call it again. Wider than one rank it is an SPMDEngine
    leading a world of its own (wide_engine); one rank, `build_one(cfg)`
    (given `device=` when the plan counts cards). `worlds=False` (the
    fake engine, which runs no model) builds every width as one engine,
    as the reference's fake members do. A build that fails gives the
    member its old cards back and raises: nothing is built at another
    width or on other cards than asked."""

    def __init__(self, name: str, cfg, plan: CardPlan, build_one,
                 models: dict, fairness=None, worlds: bool = True):
        self.name = name
        self.worlds = worlds
        self.cfg = cfg
        self.plan = plan
        self.build_one = build_one
        self.models = dict(models)
        self.fairness = fairness

    def config(self, tp: Optional[int] = None):
        return (self.cfg if tp in (None, self.cfg.tp)
                else dataclasses.replace(self.cfg, tp=tp))

    def __call__(self, tp: Optional[int] = None):
        cfg = self.config(tp)
        prev = self.plan.holding(self.name)
        devices = self.plan.take_member(self.name, cfg)
        try:
            if self.worlds and member_ranks(cfg) > 1:
                return wide_engine(cfg, self.models, devices, self.fairness,
                                   self.plan.backend)
            if self.plan.accounted:
                return self.build_one(cfg, device=devices[0])
            return self.build_one(cfg)
        except BaseException:
            self.plan.assign(self.name, prev)
            raise


def _engine_config(d: dict):
    """An EngineConfig from its asdict() (JSON turns tuples into lists)."""
    from ollamamq_tpu_torch.config import EngineConfig

    base = EngineConfig()
    fields = {f.name for f in dataclasses.fields(EngineConfig)}
    return EngineConfig(**{k: (tuple(v) if isinstance(getattr(base, k), tuple)
                               and isinstance(v, list) else v)
                           for k, v in d.items() if k in fields})


def worker_main() -> int:
    """A wide member's rank r > 0: join the world in the env, build the
    same mesh and replay rank 0's step plans until it releases us."""
    logging.basicConfig(level=logging.INFO, format=(
        "%(asctime)s %(levelname)s %(name)s: %(message)s"), stream=sys.stdout)
    from ollamamq_tpu_torch.engine import spmd
    from ollamamq_tpu_torch.parallel import distributed
    from ollamamq_tpu_torch.parallel.mesh import make_mesh

    spec = json.loads(os.environ[SPEC_ENV])
    devices = spec["devices"]
    distributed.initialize(backend=spec["backend"], devices=devices)
    shape = spec["mesh"]
    mesh = make_mesh(dp=shape["dp"], tp=shape["tp"], pp=shape["pp"],
                     sp=shape["sp"], ep=shape["ep"], devices=devices)
    log.info("wide-member rank %d of %d on %s", distributed.rank(),
             len(devices), distributed.device())
    spmd.run_worker(spec["models"], _engine_config(spec["ecfg"]), mesh)
    return 0


if __name__ == "__main__":
    from ollamamq_tpu_torch.parallel import distributed

    distributed.exit_process(worker_main())
