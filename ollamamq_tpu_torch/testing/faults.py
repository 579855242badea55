"""Deterministic fault injection for the serving engine.

A copy of the JAX package's module (ollamamq_tpu/testing/faults.py) with
the same SITES, KINDS and plan schema, so one plan file drives either
engine. A FaultPlan is a seeded, schema-checked list of rules injected
into the engine's dispatch seams (ModelRuntime._fault at the top of the
ragged, spec_verify and decode dispatches, FakeRuntime.step), allocation
seams (page alloc / decode-time extend) and the durability WAL's flush
seam. Sites that the PyTorch engine has no seam for yet (prefill, chunk
and the fleet's) are accepted and never fire. Every degradation path — preemption-with-recompute, retry with
backoff, poisoning, load shedding under allocation pressure, watchdog
stalls — becomes testable and chaos-benchable without a flaky device:
the same plan file replays the same faults in the same order.

Plan file schema (JSON, validated loudly at startup — a malformed
`--fault-plan` must fail the process before it takes traffic):

    {
      "seed": 0,                      # optional; seeds probabilistic rules
      "faults": [
        {"site": "prefill", "kind": "exception", "at": [1, 2]},
        {"site": "extend",  "kind": "alloc_fail", "every": 5, "times": 2},
        {"site": "decode",  "kind": "slow", "p": 0.1, "delay_s": 0.25},
        {"site": "decode",  "kind": "device_loss", "at": [10],
         "heal_after_s": 3.0}
      ]
    }

Each rule names ONE site and ONE trigger:

  site     where the fault fires — a dispatch seam ("prefill", "chunk",
           "sp_prefill", "ragged" for the mixed-batch dispatch,
           "spec_verify" for a mixed dispatch carrying speculative
           verify spans, "decode", "embed", "encode", "step" for the
           fake runtime), an allocation seam ("alloc" = admission
           page alloc, "extend" = decode-time page growth), or the
           fleet router's member-probe seam ("replica": the router
           probes members in order each health sweep, so the per-site
           call counter indexes (sweep, member) — "exception" crashes
           the probed member, "slow" forces its heartbeat stale for
           delay_s, "device_loss" keeps it down until heal_after_s), or
           the router's KV-migration seam ("migrate", drawn once per
           attempted stream migration AFTER the source export:
           "exception" fails the transfer mid-flight (fallback to
           recompute), "slow" stalls the transfer delay_s — past the
           router's --migrate-timeout-s budget it aborts — and
           "device_loss" kills the SOURCE member right after export,
           exercising the orphaned-export half of the two-phase
           handoff), or the durability WAL's flush seam ("wal", checked
           before each batched write+fsync: "exception" simulates disk
           trouble and DEGRADES the WAL loudly — serving continues
           without crash durability, the wal_degraded alert fires —
           and "slow" stalls the fsync, stretching the admission-ACK
           latency the group commit is supposed to bound), or the
           elastic fleet's spot-reclamation seam ("preempt", drawn per
           member each health sweep like "replica": "exception" serves
           a preemptible member a termination notice with the default
           drain-timeout window, "slow" serves one with delay_s as the
           notice window; fires on non-preemptible members are
           ignored), or the warm standby's HA heartbeat seam ("router",
           drawn once per sync poll of the primary: "exception" makes
           the poll fail as if the primary crashed, "slow" stalls the
           observed heartbeat by delay_s — past the takeover grace the
           standby promotes — and "device_loss" keeps polls failing
           until heal_after_s, so a HEALED primary revives into a
           promoted fleet: the revive-and-fence chaos case), or the
           engine's jit-cache seam ("compile", drawn in every
           _get_*_jit getter when the key is already cached: ANY kind
           fired evicts the cached entry so the next fill re-traces
           and re-compiles — the injected recompile loop the
           compile_storm health alert and the exactly-once compile-
           event tests are driven by; the fault is the eviction
           itself, so no exception is raised and no dispatch fails).
  kind     "exception"  -> the dispatch raises FaultInjected (the
                           engine's retry/containment path handles it);
           "slow"       -> the dispatch sleeps delay_s first (stall
                           watchdog / SLO pressure);
           "alloc_fail" -> the allocation seam reports exhaustion
                           (drives preemption / shedding);
           "device_loss"-> the dispatch raises DeviceLostError and KEEPS
                           raising at every site until heal_after_s
                           elapses (simulated dead device; the engine's
                           kill+rebuild recovery path handles it).
  trigger  exactly one of:
           "at": [n, ...] -> fire on the n-th call to this site
                             (1-based, per-site counter);
           "every": n     -> fire on every n-th call;
           "p": x         -> fire with probability x per call, drawn
                             from the plan's seeded RNG (deterministic
                             given seed + call order).
  times    optional cap on total firings of this rule (default:
           unlimited for every/p; len(at) for at-rules).
  delay_s  required for kind "slow".
  error    optional message carried by the raised exception.

Counters are per-site and shared across a process's runtimes — exactly
one deterministic stream per plan instance.
"""

from __future__ import annotations

import json
import random
import threading
import time
from typing import Dict, List, Optional

SITES = ("prefill", "chunk", "sp_prefill", "ragged", "spec_verify",
         "decode", "embed", "encode", "step", "alloc", "extend", "replica",
         "migrate", "wal", "preempt", "router", "compile")
KINDS = ("exception", "slow", "alloc_fail", "device_loss")

_RULE_KEYS = {"site", "kind", "at", "every", "p", "times", "delay_s",
              "error", "heal_after_s"}


class FaultInjected(RuntimeError):
    """An injected dispatch fault (kind "exception")."""


class DeviceLostError(FaultInjected):
    """An injected persistent device loss: every later dispatch fails
    until the plan's heal deadline passes."""


class FaultPlanError(ValueError):
    """Malformed fault-plan file/dict: the message names the bad rule."""


class _Rule:
    __slots__ = ("site", "kind", "at", "every", "p", "times", "delay_s",
                 "error", "heal_after_s", "fired")

    def __init__(self, idx: int, d: dict):
        where = f"faults[{idx}]"
        if not isinstance(d, dict):
            raise FaultPlanError(f"{where}: rule must be an object")
        unknown = set(d) - _RULE_KEYS
        if unknown:
            raise FaultPlanError(
                f"{where}: unknown key(s) {sorted(unknown)} "
                f"(allowed: {sorted(_RULE_KEYS)})")
        self.site = d.get("site")
        if self.site not in SITES:
            raise FaultPlanError(
                f"{where}: 'site' must be one of {SITES}, got {self.site!r}")
        self.kind = d.get("kind")
        if self.kind not in KINDS:
            raise FaultPlanError(
                f"{where}: 'kind' must be one of {KINDS}, got {self.kind!r}")
        triggers = [k for k in ("at", "every", "p") if k in d]
        if len(triggers) != 1:
            raise FaultPlanError(
                f"{where}: exactly one trigger of 'at'/'every'/'p' "
                f"required, got {triggers or 'none'}")
        self.at = self.every = self.p = None
        if "at" in d:
            at = d["at"]
            if (not isinstance(at, list) or not at
                    or not all(isinstance(n, int) and n >= 1 for n in at)):
                raise FaultPlanError(
                    f"{where}: 'at' must be a non-empty list of call "
                    "indices >= 1")
            self.at = frozenset(at)
        if "every" in d:
            if not isinstance(d["every"], int) or d["every"] < 1:
                raise FaultPlanError(f"{where}: 'every' must be an int >= 1")
            self.every = d["every"]
        if "p" in d:
            p = d["p"]
            if not isinstance(p, (int, float)) or not 0.0 <= p <= 1.0:
                raise FaultPlanError(f"{where}: 'p' must be in [0, 1]")
            self.p = float(p)
        times = d.get("times")
        if times is not None and (not isinstance(times, int) or times < 0):
            raise FaultPlanError(f"{where}: 'times' must be an int >= 0")
        self.times = times if times is not None else (
            len(self.at) if self.at is not None else None)
        self.delay_s = d.get("delay_s")
        if self.kind == "slow":
            if not isinstance(self.delay_s, (int, float)) or self.delay_s < 0:
                raise FaultPlanError(
                    f"{where}: kind 'slow' requires 'delay_s' >= 0")
        elif self.delay_s is not None:
            raise FaultPlanError(
                f"{where}: 'delay_s' only applies to kind 'slow'")
        self.heal_after_s = d.get("heal_after_s")
        if self.heal_after_s is not None:
            if self.kind != "device_loss":
                raise FaultPlanError(
                    f"{where}: 'heal_after_s' only applies to "
                    "kind 'device_loss'")
            if (not isinstance(self.heal_after_s, (int, float))
                    or self.heal_after_s <= 0):
                raise FaultPlanError(
                    f"{where}: 'heal_after_s' must be a number > 0")
        self.error = d.get("error") or f"injected {self.kind} at {self.site}"
        if not isinstance(self.error, str):
            raise FaultPlanError(f"{where}: 'error' must be a string")
        self.fired = 0

    def triggers(self, n_call: int, rng: random.Random) -> bool:
        if self.times is not None and self.fired >= self.times:
            return False
        if self.at is not None:
            hit = n_call in self.at
        elif self.every is not None:
            hit = n_call % self.every == 0
        else:
            # The draw happens on EVERY call so the stream stays aligned
            # with call order regardless of earlier rules' outcomes.
            hit = rng.random() < self.p
        if hit:
            self.fired += 1
        return hit


class FaultPlan:
    """Seeded fault schedule, shared across a process's runtimes.

    Engine call surface:
      check(site)    raise/sleep per the matching rules (dispatch seams);
      blocked(site)  True when an alloc_fail rule fires (alloc seams —
                     non-raising, the caller reports exhaustion).
    """

    def __init__(self, rules: List[dict], seed: int = 0):
        self._rules = [_Rule(i, r) for i, r in enumerate(rules)]
        self._rng = random.Random(seed)
        self._calls: Dict[str, int] = {}
        self._lock = threading.Lock()
        self._dead_until: Optional[float] = None  # None=healthy, inf=forever
        self.injected = 0  # total firings, all rules

    # -- construction ------------------------------------------------------
    @classmethod
    def from_dict(cls, d: dict) -> "FaultPlan":
        if not isinstance(d, dict):
            raise FaultPlanError("fault plan must be a JSON object")
        unknown = set(d) - {"seed", "faults"}
        if unknown:
            raise FaultPlanError(
                f"unknown top-level key(s) {sorted(unknown)} "
                "(allowed: 'seed', 'faults')")
        seed = d.get("seed", 0)
        if not isinstance(seed, int):
            raise FaultPlanError("'seed' must be an integer")
        faults = d.get("faults")
        if not isinstance(faults, list) or not faults:
            raise FaultPlanError("'faults' must be a non-empty list of rules")
        return cls(faults, seed=seed)

    @classmethod
    def load(cls, path: str) -> "FaultPlan":
        """Parse + validate a plan file; raises FaultPlanError with the
        offending rule named — startup must fail fast, not at the first
        fault firing mid-traffic."""
        try:
            with open(path, encoding="utf-8") as f:
                raw = json.load(f)
        except OSError as e:
            raise FaultPlanError(f"cannot read fault plan {path}: {e}")
        except json.JSONDecodeError as e:
            raise FaultPlanError(f"fault plan {path} is not valid JSON: {e}")
        return cls.from_dict(raw)

    # -- injection points --------------------------------------------------
    def _matching(self, site: str) -> List[_Rule]:
        with self._lock:
            n = self._calls.get(site, 0) + 1
            self._calls[site] = n
            fired = [r for r in self._rules
                     if r.site == site and r.triggers(n, self._rng)]
            self.injected += len(fired)
        return fired

    def _check_dead(self) -> None:
        dead = self._dead_until
        if dead is None:
            return
        if time.monotonic() < dead:
            raise DeviceLostError("injected device loss (still down)")
        self._dead_until = None  # healed

    def check(self, site: str) -> None:
        """Dispatch-seam hook: may sleep (slow), raise FaultInjected
        (exception), or raise DeviceLostError (device_loss, persistent
        until healed)."""
        self._check_dead()
        for r in self._matching(site):
            if r.kind == "slow":
                time.sleep(r.delay_s)
            elif r.kind == "device_loss":
                self._dead_until = (
                    time.monotonic() + r.heal_after_s
                    if r.heal_after_s is not None else float("inf"))
                raise DeviceLostError(r.error)
            elif r.kind == "exception":
                raise FaultInjected(r.error)
            # alloc_fail rules on a dispatch site are inert by design.

    def draw(self, site: str) -> List[tuple]:
        """Observer-style hook for sites whose faults the CALLER enacts
        (the fleet router's "replica" site: it turns "exception" into a
        member crash and "slow" into a stale-heartbeat window instead of
        raising/sleeping in its own probe loop). Returns the fired
        (kind, rule) pairs for this call; device_loss persistence is
        honored — while a previously drawn device_loss is unhealed, every
        draw reports a synthetic ("device_loss", None) marker."""
        dead = self._dead_until
        if dead is not None:
            if time.monotonic() < dead:
                return [("device_loss", None)]
            self._dead_until = None  # healed
        out = []
        for r in self._matching(site):
            if r.kind == "device_loss":
                self._dead_until = (
                    time.monotonic() + r.heal_after_s
                    if r.heal_after_s is not None else float("inf"))
            out.append((r.kind, r))
        return out

    def blocked(self, site: str) -> bool:
        """Allocation-seam hook: True when an alloc_fail rule fires (the
        caller reports pool exhaustion). Never raises."""
        if self._dead_until is not None and \
                time.monotonic() < self._dead_until:
            return True  # a lost device can't grow allocations either
        return any(r.kind == "alloc_fail" for r in self._matching(site))

    def stats(self) -> dict:
        with self._lock:
            return {
                "injected": self.injected,
                "calls": dict(self._calls),
                "rules": [{"site": r.site, "kind": r.kind, "fired": r.fired}
                          for r in self._rules],
            }
