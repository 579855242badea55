"""Tiered fleet: SLO-aware replica tiers with adaptive TP regrouping.

The JAX package's fleet/tiering.py over this package's FleetRouter.

Nitsum's observation ("Serving Tiered LLM Requests with Adaptive Tensor
Parallelism", PAPERS.md): a fleet that places latency-sensitive requests
on wide-TP low-latency replicas and bulk traffic on narrow-TP
high-throughput ones beats any homogeneous fleet on BOTH p99 TTFT and
aggregate tok/s — and the win compounds when the fleet REGROUPS as the
class mix shifts. This module is that policy layer over FleetRouter:

  Tier model     members carry a tier label (`interactive` / `bulk`,
                 --tiers spec, config.assign_tiers). Placement reads the
                 request class — VIP/boost users and deadlined requests
                 are `interactive`, everything else `bulk` — and routes
                 to the matching tier, with affinity and least-loaded
                 preserved WITHIN the tier. Cross-tier placement happens
                 only with explicit journaling (tier_overflow).

  SLO headroom   each tier owns a TTFT Objective (the burn-rate
                 machinery of telemetry/slo.py) fed from the router at
                 first-token time. When a tier's fast-burn window fires,
                 the OTHER tier's members become eligible overflow
                 targets for its traffic — interactive load sheds onto
                 bulk under an interactive burn, bulk backlog (which
                 shows up as bulk TTFT burn) spills into interactive
                 headroom — each cross-tier placement journaled with the
                 burn that justified it. Overflow targets keep
                 `overflow_headroom` slots free for their own tier, so
                 spill never starves native traffic.

  Regrouping     TierBalancer watches the interactive-share EMA of
                 classified placements. Past the hysteresis deadband
                 (and a cooldown, and a minimum sample count — an
                 oscillating mix must NOT flap members back and forth)
                 it retiers one member toward the observed mix:
                 drain, live streams migrate off by KV page migration,
                 hot-restart at the target tier's TP width
                 (LocalMember with an engine factory; one device per
                 engine here, so every width is 1) or re-label
                 (HttpMember), rejoin the other tier — journaled
                 tier_regroup start/done/aborted. A crash mid-retier
                 aborts the regroup and the member rejoins its ORIGINAL
                 tier after healing; its streams already migrated off
                 during the drain, so the fallback ladder (migrate ->
                 recompute replay -> never drop) holds throughout.

Stdlib-only (telemetry + config imports): the router constructs one when
engine_cfg.tiers (or its own `tiers` kwarg) names a spec.
"""

from __future__ import annotations

import collections
import time
from typing import Dict, List, Optional, Tuple

from ollamamq_tpu_torch.config import TIER_NAMES, assign_tiers
from ollamamq_tpu_torch.telemetry import schema as tm
from ollamamq_tpu_torch.telemetry.slo import DEFAULT_WINDOWS, Objective

# Default per-tier TTFT objectives (ms) when the operator configured no
# --slo-ttft-ms: interactive traffic is the latency-sensitive class; the
# bulk threshold is deliberately lax — its burn firing means BACKLOG
# (queued bulk work aging past any reasonable first-token wait), the
# signal that justifies spilling bulk into interactive headroom.
INTERACTIVE_TTFT_MS = 500.0
BULK_TTFT_MS_FACTOR = 8.0

# Balancer defaults (constructor-overridable; tests and bench shrink
# them). The deadband + cooldown + sample floor are the hysteresis that
# keeps an oscillating class mix from flapping members between tiers.
EMA_ALPHA = 0.05
BALANCE_DEADBAND = 0.18
BALANCE_COOLDOWN_S = 30.0
BALANCE_MIN_SAMPLES = 32

# Overflow targets must keep this many slots free for their OWN tier's
# traffic, so a spill never turns the other tier homogeneous again.
OVERFLOW_HEADROOM = 1

# Overflow burn evaluation cache TTL: placement is per-request, burn
# windows move at 1s-bucket granularity — recomputing per placement
# would be wasted work.
_BURN_TTL_S = 0.2
# vip/boost live in the native core; snapshot() builds JSON — cache it.
_CLASS_TTL_S = 0.5


def other_tier(tier: str) -> str:
    return "bulk" if tier == "interactive" else "interactive"


class TierManager:
    """Tier assignment + class-aware placement filter + per-tier SLO
    burn + the TierBalancer. Owned by FleetRouter; all methods are
    called from the router loop except status()/counts() (HTTP/TUI
    readers) — state that crosses that boundary sits behind a lock."""

    def __init__(self, members: List[object], spec: str, core,
                 journal, ecfg=None,
                 interactive_ttft_ms: Optional[float] = None,
                 bulk_ttft_ms: Optional[float] = None,
                 slo_target: float = 0.99,
                 windows: Tuple[tuple, ...] = DEFAULT_WINDOWS,
                 overflow_headroom: int = OVERFLOW_HEADROOM,
                 balance: bool = True,
                 ema_alpha: float = EMA_ALPHA,
                 deadband: float = BALANCE_DEADBAND,
                 cooldown_s: float = BALANCE_COOLDOWN_S,
                 min_samples: int = BALANCE_MIN_SAMPLES):
        self.spec = spec
        self.core = core
        self.journal = journal
        roster = [(m.name, getattr(m, "tp", None)) for m in members]
        assignment, widths = assign_tiers(spec, roster)  # raises TiersError
        self.widths = widths  # tier -> declared target TP width (or None)
        self._members = list(members)
        for mem in members:
            mem.tier = assignment[mem.name]
        # Per-tier TTFT objectives off the burn-rate machinery.
        slo_ttft = getattr(ecfg, "slo_ttft_ms", None) if ecfg else None
        i_ms = (interactive_ttft_ms if interactive_ttft_ms is not None
                else (slo_ttft or INTERACTIVE_TTFT_MS))
        b_ms = (bulk_ttft_ms if bulk_ttft_ms is not None
                else i_ms * BULK_TTFT_MS_FACTOR)
        self.windows = windows
        horizon = max((w[1] for w in windows), default=3600.0)
        self.objectives: Dict[str, Objective] = {
            "interactive": Objective("tier_interactive", i_ms, slo_target,
                                     horizon_s=horizon),
            "bulk": Objective("tier_bulk", b_ms, slo_target,
                              horizon_s=horizon),
        }
        self.overflow_headroom = max(0, int(overflow_headroom))
        # Balancer state.
        self.balance = bool(balance)
        self.ema_alpha = float(ema_alpha)
        self.deadband = float(deadband)
        self.cooldown_s = float(cooldown_s)
        self.min_samples = max(1, int(min_samples))
        self.mix_ema: Optional[float] = None  # interactive share of placements
        self.samples_since_regroup = 0
        self.last_regroup_at = 0.0
        self.regroup_times: collections.deque = collections.deque(maxlen=64)
        self.regroup_counts = {"done": 0, "aborted": 0}
        self.overflow_count = 0
        # Elastic fleet (fleet/autoscaler.py): tiers the scaler has
        # DELIBERATELY emptied. A scaled-to-zero tier's traffic parks at
        # the router (tier isolation) instead of taking the empty-tier
        # cross-tier fallback — the parked backlog is the pending-work
        # signal that wakes the tier back up. Distinct from a tier whose
        # members all crashed: that one still spills cross-tier.
        self.scaled_to_zero: set = set()
        self._class_cache = (0.0, None, None)  # (ts, vip, boost)
        self._burn_cache: Dict[str, tuple] = {}  # tier -> (ts, active, burn)
        self._last_gauges = 0.0
        self.update_gauges()

    # ------------------------------------------------------- classification
    def _vip_boost(self) -> tuple:
        now = time.monotonic()
        ts, vip, boost = self._class_cache
        if now - ts > _CLASS_TTL_S:
            try:
                snap = self.core.snapshot()
                vip, boost = snap.get("vip"), snap.get("boost")
            except Exception:  # noqa: BLE001 — stale beats crashed
                pass
            self._class_cache = (now, vip, boost)
        return vip, boost

    def class_of(self, user: str, deadline) -> str:
        """Request class: vip / boost (the fair-share core's privileged
        users) / deadline (the request carries a latency contract) /
        default. The first three are the latency-sensitive classes the
        interactive tier exists for."""
        vip, boost = self._vip_boost()
        if vip is not None and user == vip:
            return "vip"
        if boost is not None and user == boost:
            return "boost"
        if deadline is not None:
            return "deadline"
        return "default"

    @staticmethod
    def tier_of_class(cls: str) -> str:
        return "bulk" if cls == "default" else "interactive"

    # ------------------------------------------------------------ overflow
    def record_ttft(self, tier: str, ttft_ms: float) -> None:
        """First-token latency observed at the router, recorded against
        the request's HOME tier (where it was classified, not where an
        overflow landed it — the home tier's SLO is what's burning)."""
        obj = self.objectives.get(tier)
        if obj is not None:
            obj.record(ttft_ms)

    def overflow_state(self, tier: str,
                       now: Optional[float] = None) -> Tuple[bool, float]:
        """(firing, burn) for `tier`'s fastest window pair — the
        multi-window rule: burning over BOTH the long and the short leg.
        Firing means the OTHER tier's members become eligible overflow
        targets for this tier's traffic."""
        now = time.monotonic() if now is None else now
        ts, active, burn = self._burn_cache.get(tier, (0.0, False, 0.0))
        if now - ts <= _BURN_TTL_S:
            return active, burn
        obj = self.objectives[tier]
        active, burn = False, 0.0
        for _label, long_w, short_w, factor, _sev in self.windows:
            burn_long = obj.burn_rate(long_w, now=now)
            burn_short = obj.burn_rate(short_w, now=now)
            if burn_long > factor and burn_short > factor:
                active, burn = True, max(burn, burn_long)
        self._burn_cache[tier] = (now, active, burn)
        return active, burn

    # ------------------------------------------------------------ placement
    def placement_filter(self, flight, elig: List[object],
                         load_of, slot_cap) -> Tuple[List[object], dict]:
        """Restrict an eligible-member list to the flight's home tier,
        widening to overflow targets when the tier's burn fires or the
        tier has no healthy members at all. Returns (members, info);
        info feeds journal_place once the router picks the winner. An
        empty return with a nonempty input means the home tier exists
        but is full: the stream WAITS (tier isolation is the point)
        rather than silently going cross-tier."""
        cls = self.class_of(flight.user, flight.req.deadline)
        tier = self.tier_of_class(cls)
        flight.cls, flight.tier = cls, tier
        self._note_mix(tier)
        info = {"tier": tier, "cls": cls, "overflow": False,
                "why": None, "burn": None}
        # Router-side slot bound: a local member's engine would happily
        # BUFFER placements past its slot count (its own queue), which
        # would let a bulk backlog bypass tier isolation before the
        # member's capacity view catches up. Tiered placement keeps the
        # backlog at the ROUTER, where burn-driven overflow (and drains,
        # and regroups) can actually act on it.
        elig = [m for m in elig if load_of(m) < slot_cap(m)]
        home = [m for m in elig if getattr(m, "tier", None) == tier]
        firing, burn = self.overflow_state(tier)
        if firing:
            # Burn overflow: widen to the other tier's members that keep
            # headroom for their own traffic; least-loaded picks among
            # the union, so in-tier capacity still wins when it exists.
            spill = [m for m in elig
                     if getattr(m, "tier", None) != tier
                     and load_of(m) + self.overflow_headroom < slot_cap(m)]
            if spill:
                info.update(why="burn", burn=round(burn, 2))
                return home + spill, info
        if home:
            return home, info
        # No ELIGIBLE home member. Empty tier (nothing healthy) falls
        # back cross-tier — explicitly journaled; a merely-full tier
        # waits in queue instead of leaking onto the other tier.
        home_alive = [m for m in self._members
                      if getattr(m, "tier", None) == tier
                      and m.state == "healthy"]
        if not home_alive and elig:
            if tier in self.scaled_to_zero:
                # Deliberately scaled to zero: PARK (the stream waits at
                # the router; its presence in the pending set is the
                # autoscaler's wake signal) instead of leaking onto the
                # other tier's members.
                info.update(why="parked")
                return [], info
            info.update(why="no_members")
            return list(elig), info
        return [], info

    def journal_place(self, flight, member, info) -> None:
        """One tier_place per tiered placement decision, plus a
        tier_overflow when the winner is cross-tier — the explicit
        journaling contract for every cross-tier fallback."""
        tier = info["tier"]
        crossed = getattr(member, "tier", None) not in (None, tier)
        self.journal.record(
            "tier_place", req_id=flight.rid0, user=flight.user,
            model=flight.model or None, tier=tier, cls=info["cls"],
            replica=member.name, overflow=True if crossed else None)
        if crossed:
            self.overflow_count += 1
            tm.FLEET_TIER_OVERFLOW_TOTAL.labels(
                **{"from": tier, "to": member.tier}).inc()
            self.journal.record(
                "tier_overflow", req_id=flight.rid0, user=flight.user,
                model=flight.model or None, from_tier=tier,
                to_tier=member.tier, why=info["why"] or "no_capacity",
                burn=info["burn"], replica=member.name,
                queued=self.core.total_queued())
            # Router-side span (tracing.ROUTER_EVENTS): the cross-tier
            # decision reads straight off the stitched client timeline.
            flight.req.trace_event("overflow", from_tier=tier,
                                   to_tier=member.tier,
                                   why=info["why"] or "no_capacity")

    def journal_failover_overflow(self, flight, member) -> None:
        """A failover/migration landed a stream cross-tier because its
        home tier had no capacity — same explicit journaling, different
        why."""
        tier = getattr(flight, "tier", None)
        if tier is None or getattr(member, "tier", None) in (None, tier):
            return
        self.overflow_count += 1
        tm.FLEET_TIER_OVERFLOW_TOTAL.labels(
            **{"from": tier, "to": member.tier}).inc()
        self.journal.record(
            "tier_overflow", req_id=flight.rid0, user=flight.user,
            model=flight.model or None, from_tier=tier,
            to_tier=member.tier, why="failover", replica=member.name)
        flight.req.trace_event("overflow", from_tier=tier,
                               to_tier=member.tier, why="failover")

    # ------------------------------------------------------------ balancing
    def _note_mix(self, tier: str) -> None:
        x = 1.0 if tier == "interactive" else 0.0
        self.mix_ema = (x if self.mix_ema is None
                        else self.ema_alpha * x
                        + (1.0 - self.ema_alpha) * self.mix_ema)
        self.samples_since_regroup += 1

    def _tier_members(self, tier: str) -> List[object]:
        return [m for m in self._members
                if getattr(m, "tier", None) == tier]

    def maybe_balance(self, router) -> None:
        """One balancer tick: regroup ONE member toward the observed
        class mix when the imbalance clears the hysteresis deadband, the
        cooldown elapsed, and enough placements were observed since the
        last regroup. Never empties a tier."""
        if not self.balance or self.mix_ema is None:
            return
        if self.samples_since_regroup < self.min_samples:
            return
        if time.monotonic() - self.last_regroup_at < self.cooldown_s:
            return
        if any(getattr(m, "retier_to", None) for m in self._members):
            return  # one regroup in flight at a time
        n = len(self._members)
        inter = len(self._tier_members("interactive"))
        frac = inter / n
        desired = min(n - 1, max(1, round(self.mix_ema * n)))
        if desired > inter and self.mix_ema > frac + self.deadband:
            donor_tier = "bulk"
        elif desired < inter and self.mix_ema < frac - self.deadband:
            donor_tier = "interactive"
        else:
            return
        if other_tier(donor_tier) in self.scaled_to_zero:
            return  # don't repopulate a tier the scaler emptied on purpose
        donors = [m for m in self._tier_members(donor_tier)
                  if m.state == "healthy"
                  and getattr(m, "retier_to", None) is None]
        if len(donors) < 1 or len(self._tier_members(donor_tier)) <= 1:
            return  # a tier never empties
        donor = min(donors, key=router._load_of)
        try:
            router.retier_replica(donor.name, other_tier(donor_tier),
                                  why="mix_shift")
        except (KeyError, ValueError, RuntimeError):
            pass  # raced with a drain/eject: retry a later tick

    def note_regroup(self, outcome: str) -> None:
        self.regroup_counts[outcome] = \
            self.regroup_counts.get(outcome, 0) + 1
        tm.FLEET_REGROUPS_TOTAL.labels(outcome=outcome).inc()
        self.regroup_times.append(time.monotonic())
        self.last_regroup_at = time.monotonic()
        self.samples_since_regroup = 0

    # ------------------------------------------------- elastic-fleet roster
    def note_member_added(self, mem, tier: str) -> None:
        """A scaler-provisioned member joined: label it, add it to the
        tier roster, and clear any scale-to-zero park on its tier (the
        wake)."""
        mem.tier = tier
        self._members.append(mem)
        self.scaled_to_zero.discard(tier)
        self.update_gauges()

    def note_member_removed(self, mem, to_zero: bool = False) -> None:
        """A member retired (scale-down / preemption). `to_zero` marks a
        DELIBERATE tier emptying: its traffic parks instead of spilling
        cross-tier until the scaler wakes the tier."""
        self._members = [m for m in self._members if m is not mem]
        tier = getattr(mem, "tier", None)
        if to_zero and tier is not None and not self._tier_members(tier):
            self.scaled_to_zero.add(tier)
        self.update_gauges()

    def regroup_rate_per_min(self, window_s: float = 60.0) -> float:
        """Regroups per minute over the trailing window — the health
        watchdog's regroup-storm signal (a flapping balancer burns every
        retier on drain+restart churn)."""
        cutoff = time.monotonic() - window_s
        n = sum(1 for t in self.regroup_times if t >= cutoff)
        return n * 60.0 / window_s

    # ------------------------------------------------------------- readouts
    def update_gauges(self) -> None:
        counts: Dict[tuple, int] = {}
        for tier in TIER_NAMES:
            for state in ("healthy", "ejected", "draining"):
                counts[(tier, state)] = 0
        for m in self._members:
            tier = getattr(m, "tier", None)
            if tier is not None:
                counts[(tier, m.state)] = counts.get((tier, m.state), 0) + 1
        for (tier, state), nn in counts.items():
            tm.FLEET_TIER_MEMBERS.labels(tier=tier, state=state).set(nn)

    def counts(self) -> dict:
        """{tier: {"healthy": n, "total": n}} for the TUI tiers line."""
        out: dict = {}
        for tier in TIER_NAMES:
            mems = self._tier_members(tier)
            out[tier] = {
                "healthy": sum(1 for m in mems if m.state == "healthy"),
                "total": len(mems),
            }
        return out

    def status(self) -> dict:
        """GET /admin/tiers payload: per-tier membership, burn, overflow
        state, and the balancer's live inputs."""
        now = time.monotonic()
        tiers: dict = {}
        for tier in TIER_NAMES:
            obj = self.objectives[tier]
            firing, burn = self.overflow_state(tier, now=now)
            tiers[tier] = {
                "members": [{"name": m.name, "state": m.state,
                             "tp": getattr(m, "tp", None),
                             "retiering_to": getattr(m, "retier_to", None)}
                            for m in self._tier_members(tier)],
                "target_tp": self.widths.get(tier),
                "ttft_threshold_ms": obj.threshold_ms,
                "burn_rate": round(burn, 3),
                "overflow_active": firing,
            }
        return {
            "spec": self.spec,
            "tiers": tiers,
            "mix_ema_interactive": (round(self.mix_ema, 4)
                                    if self.mix_ema is not None else None),
            "balance": self.balance,
            "deadband": self.deadband,
            "cooldown_s": self.cooldown_s,
            "overflows": self.overflow_count,
            "regroups": dict(self.regroup_counts),
        }
