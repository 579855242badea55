"""The port's replica tiers against the JAX package's tiering tests.

The mirror of tests/test_tiering.py, case for case, over the port's
FleetRouter and TierManager (fleet/tiering.py): members are the port's
FakeEngine and TorchEngine on the CPU (test-tiny, float32, plain
attention), the admin routes go through the port's stdlib server on a
real socket. The contract: request classes map to replica tiers
(VIP/boost/deadline -> interactive, default -> bulk) with
affinity/least-loaded preserved within a tier; cross-tier placement
happens only under journaled overflow (per-tier SLO burn, an empty
tier, or a failover with no in-tier capacity); a regroup drains a
member, migrates its live streams off in-tier, restarts it and rejoins
it to the other tier, with hysteresis so an oscillating mix never
flaps.

Beyond the mirror: the regroup's greedy ids are held against the same
streams served by a JAX TPUEngine fleet, the spec parser against the
JAX package's, and the CLI's member factory rebuilds a member at a tier's
declared width (a regroup to tp2 leads a rank world of two ranks; the
rest of the wide members' cases are in tests/test_torch_wide_members.py).

Waits poll journal records and member states with budgets, never fixed
sleeps, so the chaos case holds under a loaded test run.
"""

import dataclasses
import json
import time
import types
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ollamamq_tpu.config import EngineConfig as JaxEngineConfig
from ollamamq_tpu.config import TiersError as JaxTiersError
from ollamamq_tpu.config import assign_tiers as jax_assign_tiers
from ollamamq_tpu.engine.engine import TPUEngine
from ollamamq_tpu.fleet import FleetRouter as JaxFleetRouter
from ollamamq_tpu.fleet import LocalMember as JaxLocalMember
from ollamamq_tpu.ops.sampling import SamplingParams as JaxSampling
from ollamamq_tpu_torch.config import (MODEL_CONFIGS, EngineConfig,
                                       TiersError, assign_tiers)
from ollamamq_tpu_torch.engine.engine import TorchEngine
from ollamamq_tpu_torch.engine.fake import FakeEngine
from ollamamq_tpu_torch.engine.tokenizer import ByteTokenizer
from ollamamq_tpu_torch.fleet import FleetRouter, LocalMember
from ollamamq_tpu_torch.models.weights import from_jax_numpy
from ollamamq_tpu_torch.ops.sampling import SamplingParams
from ollamamq_tpu_torch.server.app import serve_in_thread, stop_server
from ollamamq_tpu_torch.telemetry import schema as tm
from ollamamq_tpu_torch.testing.faults import FaultPlan
from ollamamq_tpu_torch.tools.journal import (check_no_dropped_streams,
                                              check_regroup_pairing)
from testutil import collect

TINY = dict(model="test-tiny", max_slots=4, num_pages=64, page_size=8,
            max_pages_per_seq=8, decode_steps_per_iter=2)

FAST = dict(probe_period_s=0.05, eject_heartbeat_s=5.0,
            reprobe_backoff_s=0.1, evac_grace_s=1.0)


def _tiered_fake_fleet(tiers, n=2, token_latency_s=0.0, plan=None,
                       router_kw=None, tiering_kw=None, factories=False,
                       widths=None, **ecfg_over):
    """FakeEngine members; with `factories`, each member's factory builds
    at the width it is asked for and records it in `widths`."""
    cfg = dict(TINY)
    cfg.update(ecfg_over)
    ecfg = EngineConfig(fault_plan=plan, **cfg)
    member_cfg = dataclasses.replace(ecfg, fault_plan=None, max_queued=0,
                                     max_queued_per_user=0, tiers=None)

    def mkfactory():
        def build(tp=None):
            if widths is not None:
                widths.append(tp)
            mcfg = (member_cfg if tp in (None, member_cfg.tp)
                    else dataclasses.replace(member_cfg, tp=tp))
            return FakeEngine(mcfg, blocklist_path=None,
                              token_latency_s=token_latency_s)
        return build

    members = []
    for i in range(n):
        f = mkfactory()
        members.append(LocalMember(f"r{i}", f(),
                                   engine_factory=f if factories else None))
    kw = dict(FAST)
    kw.update(router_kw or {})
    tkw = dict(balance=False)
    tkw.update(tiering_kw or {})
    router = FleetRouter(members, ecfg, blocklist_path=None, tiers=tiers,
                         tiering_kw=tkw, **kw)
    router.start()
    return router


def _run(router, user, prompt="the quick brown fox jumps over",
         max_tokens=8, deadline_ms=None):
    rt = router.resolve_runtime("test-tiny")
    tok = rt.tokenizer if rt is not None else ByteTokenizer()
    sp = SamplingParams(max_tokens=max_tokens)
    if deadline_ms is not None:
        sp.deadline_ms = deadline_ms
    return router.enqueue_request(user, "", "test-tiny",
                                  prompt_tokens=tok.encode(prompt),
                                  sampling=sp, raw_prompt=prompt)


def _text(items):
    return "".join(i.text for i in items if i.kind == "token")


def _ids(items):
    return [i.token_id for i in items if i.kind == "token"
            and i.token_id >= 0]


def _member(router, name):
    return next(m for m in router.members if m.name == name)


def _wait(pred, budget=30.0, period=0.01):
    deadline = time.monotonic() + budget
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(period)
    return False


def _has_record(router, kind, **fields):
    return any(all(r.get(k) == v for k, v in fields.items())
               for r in router.journal.tail(None, kind=kind))


# ------------------------------------------------------------- assignment
def test_assign_tiers_spec_resolution_and_errors():
    members = [("r0", 2), ("r1", 1), ("r2", 1), ("h0", None)]
    # By name; unmatched members default to bulk.
    assignment, widths = assign_tiers("interactive=r0", members)
    assert assignment == {"r0": "interactive", "r1": "bulk",
                          "r2": "bulk", "h0": "bulk"}
    assert widths == {"interactive": None, "bulk": None}
    # By TP width, with declared target widths.
    assignment, widths = assign_tiers(
        "interactive@tp2=tp2;bulk@tp1=tp1,h0", members)
    assert assignment["r0"] == "interactive"
    assert assignment["r1"] == assignment["r2"] == assignment["h0"] == \
        "bulk"
    assert widths == {"interactive": 2, "bulk": 1}
    bad = ["gold=r0",                     # unknown tier name
           "interactive=zz",              # selector, no member
           "interactive=r0;bulk=r0",      # double assign
           "interactive=r0,r1,r2,h0",     # bulk would be empty
           "interactive@tpx=r0"]          # bad width token
    for spec in bad:
        with pytest.raises(TiersError) as port_err:
            assign_tiers(spec, members)
        with pytest.raises(JaxTiersError) as jax_err:
            jax_assign_tiers(spec, members)
        assert str(port_err.value) == str(jax_err.value), spec
    # The same resolution as the JAX package's parser.
    for spec in ("interactive=r0", "interactive@tp2=tp2;bulk@tp1=tp1,h0",
                 "bulk=r1;interactive=r0,r2"):
        assert assign_tiers(spec, members) == jax_assign_tiers(spec, members)


# -------------------------------------------------------------- placement
def test_class_aware_placement_routes_to_matching_tier():
    router = _tiered_fake_fleet("interactive=r0;bulk=r1")
    try:
        router.core.set_vip("alice")
        router.core.set_boost("bob")
        cases = [
            ("alice", None, "vip", "interactive", "r0"),
            ("bob", None, "boost", "interactive", "r0"),
            ("carol", 60_000.0, "deadline", "interactive", "r0"),
            ("dave", None, "default", "bulk", "r1"),
        ]
        for user, dl, cls, tier, replica in cases:
            req = _run(router, user, max_tokens=4, deadline_ms=dl)
            items = collect(req)
            assert items[-1].kind == "done"
            rec = router.journal.tail(None, kind="tier_place")[-1]
            assert (rec["cls"], rec["tier"], rec["replica"]) == \
                (cls, tier, replica), (user, rec)
            place = router.journal.tail(None, kind="place")[-1]
            assert place["runtime"] == replica
        # In-tier placement never journals an overflow.
        assert router.journal.tail(None, kind="tier_overflow") == []
        assert router.tiers.overflow_count == 0
        # Gauges carry the per-tier membership.
        snap = {lv: c.value for lv, c in tm.FLEET_TIER_MEMBERS.series()}
        assert snap[("interactive", "healthy")] == 1
        assert snap[("bulk", "healthy")] == 1
    finally:
        router.stop()


def test_full_home_tier_waits_instead_of_leaking_cross_tier():
    """Tier isolation: bulk traffic beyond the bulk tier's slots WAITS
    at the router (no burn firing) — it must not spill onto the
    interactive member — and the interactive queue keeps flowing past
    the parked bulk backlog."""
    router = _tiered_fake_fleet("interactive=r0;bulk=r1",
                                token_latency_s=0.05, max_slots=2)
    try:
        bulk = [_run(router, f"b{i}", max_tokens=12) for i in range(6)]
        # The bulk tier (2 slots) is saturated.
        assert _wait(lambda: router._load_of(_member(router, "r1")) >= 2)
        fast = _run(router, "vipish", max_tokens=2, deadline_ms=60_000.0)
        items = collect(fast)
        assert items[-1].kind == "done"
        # The interactive stream flowed while bulk was parked, in-tier.
        rec = [r for r in router.journal.tail(None, kind="tier_place")
               if r.get("cls") == "deadline"][-1]
        assert rec["replica"] == "r0"
        for r in bulk:
            assert collect(r)[-1].kind == "done"
        # Every bulk placement stayed on the bulk member.
        for rec in router.journal.tail(None, kind="tier_place"):
            if rec["cls"] == "default":
                assert rec["replica"] == "r1", rec
        assert router.tiers.overflow_count == 0
    finally:
        router.stop()


# --------------------------------------------------------------- overflow
def test_burn_overflow_fires_and_resolves():
    """Per-tier burn-rate feedback: bad interactive TTFTs fire the fast
    multi-window burn -> bulk members become eligible overflow targets
    for interactive traffic (tier_overflow why=burn journaled with the
    burn); good observations age the window out -> resolve."""
    # Short window >= 2s: WindowedCounts buckets at 1s granularity, so
    # a sub-second short leg can truncate just-recorded observations
    # out of its own window.
    router = _tiered_fake_fleet(
        "interactive=r0;bulk=r1", token_latency_s=0.05, max_slots=1,
        tiering_kw=dict(windows=(("fast", 4.0, 2.0, 1.0, "warn"),),
                        interactive_ttft_ms=10.0, overflow_headroom=0))
    try:
        tiers = router.tiers
        now = time.monotonic()
        assert tiers.overflow_state("interactive", now=now) == (False, 0.0)
        # Saturate the interactive member FIRST (while placement is
        # still strictly in-tier), then induce the burn.
        parked = _run(router, "park", max_tokens=64,
                      deadline_ms=60_000.0)
        assert _wait(lambda: router._load_of(_member(router, "r0")) >= 1)
        for _ in range(4):
            tiers.record_ttft("interactive", 500.0)  # way over 10ms
        # Past the burn-evaluation cache TTL the state recomputes hot.
        firing, burn = tiers.overflow_state("interactive",
                                            now=now + 0.3)
        assert firing and burn > 1.0
        spilled = _run(router, "spill", max_tokens=4,
                       deadline_ms=60_000.0)
        items = collect(spilled)
        assert items[-1].kind == "done"
        recs = [r for r in router.journal.tail(None, kind="tier_overflow")
                if r.get("user") == "spill"]
        assert recs and recs[-1]["from_tier"] == "interactive" \
            and recs[-1]["to_tier"] == "bulk" \
            and recs[-1]["why"] == "burn" and recs[-1]["burn"] > 1.0
        assert router.tiers.overflow_count >= 1
        assert tm.FLEET_TIER_OVERFLOW_TOTAL.labels(
            **{"from": "interactive", "to": "bulk"}).value >= 1
        router.cancel(parked.req_id)
        collect(parked)
        # Resolution: the bad observations age past the fast window.
        assert _wait(lambda: tiers.overflow_state("interactive")[0]
                     is False, budget=10.0, period=0.1)
        req = _run(router, "home", max_tokens=2, deadline_ms=60_000.0)
        assert collect(req)[-1].kind == "done"
        rec = [r for r in router.journal.tail(None, kind="tier_place")
               if r.get("user") == "home"][-1]
        assert rec["replica"] == "r0" and not rec.get("overflow")
    finally:
        router.stop()


def test_empty_tier_falls_back_cross_tier_with_journaling():
    router = _tiered_fake_fleet("interactive=r0;bulk=r1",
                                token_latency_s=0.02)
    try:
        _member(router, "r0").crash()
        assert _wait(lambda: router.fleet_counts()["ejected"] == 1)
        req = _run(router, "vipish", max_tokens=4, deadline_ms=60_000.0)
        items = collect(req)
        assert items[-1].kind == "done"
        recs = [r for r in router.journal.tail(None, kind="tier_overflow")
                if r.get("user") == "vipish"]
        assert recs and recs[-1]["why"] == "no_members" \
            and recs[-1]["to_tier"] == "bulk"
    finally:
        router.stop()


# ------------------------------------------------------------- regrouping
PROMPTS = [
    "the cat sat on the mat the cat sat on the",
    "pack my box with five dozen jugs",
    "the cat sat on the mat the cat sat on my",
    "pack my box with five dozen mugs",
]


def _jax_golden(prompts, max_tokens):
    """The streams served by a one-member JAX fleet (TPUEngine, f32):
    their greedy ids and text, and the engine's weights."""
    ecfg = JaxEngineConfig(prefill_buckets=(16, 32), **TINY)
    member_cfg = dataclasses.replace(ecfg, max_queued=0,
                                     max_queued_per_user=0, tiers=None)
    eng = TPUEngine(member_cfg, models={"test-tiny": None},
                    blocklist_path=None, dtype=jnp.float32)
    router = JaxFleetRouter([JaxLocalMember("r0", eng)], ecfg,
                            blocklist_path=None, **FAST)
    router.start()
    try:
        tok = eng.runtimes["test-tiny"].tokenizer
        out = []
        for i, p in enumerate(prompts):
            req = router.enqueue_request(
                f"tg{i % 2}", "", "test-tiny", prompt_tokens=tok.encode(p),
                sampling=JaxSampling(max_tokens=max_tokens), raw_prompt=p)
            items = collect(req, timeout=240)
            assert items[-1].kind == "done"
            out.append((_ids(items), _text(items)))
        params = jax.tree_util.tree_map(np.asarray,
                                        eng.runtimes["test-tiny"].params)
    finally:
        router.stop()
    return out, params


def test_regroup_end_to_end_byte_identity_and_page_conservation():
    """The e2e on REAL engines: live greedy streams mid-decode on a bulk
    member, retier it -> drain, streams MIGRATE off (in-tier, KV pages
    shipped), restart, rejoin as interactive — every stream's ids and
    text equal to the same stream served by a JAX TPUEngine fleet, and
    free+used+cached==pool on every member after the dust settles."""
    from ollamamq_tpu_torch.telemetry.journal import check_invariants

    golden, pnp = _jax_golden(PROMPTS, 48)
    params = from_jax_numpy(pnp, MODEL_CONFIGS["test-tiny"])
    ecfg = EngineConfig(dtype="float32", **TINY)
    member_cfg = dataclasses.replace(ecfg, max_queued=0,
                                     max_queued_per_user=0)
    members = [LocalMember(f"r{i}", TorchEngine(
        member_cfg, device="cpu", models={"test-tiny": None},
        blocklist_path=None, dtype=torch.float32, params=params))
        for i in range(3)]
    router = FleetRouter(members, ecfg, blocklist_path=None,
                         tiers="interactive=r0;bulk=r1,r2",
                         tiering_kw=dict(balance=False), **FAST)
    router.start()
    try:
        reqs = [_run(router, f"tg{i % 2}", p, max_tokens=48)
                for i, p in enumerate(PROMPTS)]
        assert _wait(lambda: any(
            f.member is not None and f.member.name == "r1"
            and f.attempt is not None and f.attempt.req.generated_ids
            for f in list(router.flights)), budget=120.0), \
            "no stream mid-decode on r1"
        out = router.retier_replica("r1", "interactive", why="test")
        assert out["to_tier"] == "interactive"
        results = [collect(r, timeout=240) for r in reqs]
        assert all(items[-1].kind == "done" for items in results)
        assert [(_ids(items), _text(items)) for items in results] == golden
        assert _wait(lambda: _member(router, "r1").tier == "interactive"
                     and _member(router, "r1").state == "healthy",
                     budget=60.0)
        recs = router.journal.tail(None)
        phases = [r["phase"] for r in recs if r["kind"] == "tier_regroup"]
        assert phases == ["start", "done"]
        # The drained member's streams migrated (not recomputed), and
        # they landed IN-TIER (the other bulk member).
        migrated = [r for r in recs if r["kind"] == "migrate_import"
                    and r.get("what") != "prefix"]
        assert migrated and all(r["to_replica"] == "r2"
                                for r in migrated)
        joins = [r for r in recs if r["kind"] == "replica_join"]
        assert joins[-1]["why"] == "retier"
        assert check_invariants(recs) == []
        assert check_no_dropped_streams(recs) == []
        assert check_regroup_pairing(recs) == []
        assert tm.FLEET_REGROUPS_TOTAL.labels(outcome="done").value >= 1
        # Page conservation on every member.
        for mem in router.local_members:
            for rt in mem.engine.runtimes.values():
                alloc = getattr(rt, "alloc", None)
                if alloc is None:
                    continue
                assert (alloc.free_pages + alloc.used_pages
                        + alloc.cached_pages == alloc.num_pages - 1), \
                    mem.name
    finally:
        router.stop()


def test_retier_restarts_local_member_at_tier_width():
    """A tier that declares @tpN restarts a retiered LocalMember at
    that width through its engine factory (here a factory that records
    the width it was asked for); the factory-less HttpMember path is a
    re-label."""
    widths = []
    router = _tiered_fake_fleet("interactive@tp2=r0;bulk=r1,r2", n=3,
                                factories=True, widths=widths)
    try:
        assert _member(router, "r1").tp == 1
        router.retier_replica("r1", "interactive", why="test")
        assert _wait(lambda: _member(router, "r1").tier == "interactive"
                     and _member(router, "r1").state == "healthy")
        assert _member(router, "r1").tp == 2  # rebuilt at the tier width
        assert widths[-1] == 2
        rec = router.journal.tail(None, kind="tier_regroup")[-1]
        assert rec["phase"] == "done" and rec["tp_to"] == 2
        # Refusals: same tier, unknown tier, last member of a tier.
        with pytest.raises(RuntimeError):
            router.retier_replica("r1", "interactive")
        with pytest.raises(ValueError):
            router.retier_replica("r2", "gold")
        with pytest.raises(RuntimeError):
            router.retier_replica("r2", "interactive")  # empties bulk
        with pytest.raises(KeyError):
            router.retier_replica("nope", "bulk")
    finally:
        router.stop()


def test_mid_regroup_crash_aborts_and_rejoins_original_tier():
    """Chaos (faults.py site "replica" drawn during the regroup): the
    member crashes mid-retier. The fallback ladder holds — its live
    streams already migrated off during the drain (in-tier), nothing
    drops — the regroup ABORTS, and the member rejoins its ORIGINAL
    tier after healing."""
    # No health sweep runs until the test lowers the probe period (the
    # first sweep waits for time.monotonic() to pass it), so draw 1 of
    # the "replica" site is the one _complete_retier makes right before
    # the restart. (The JAX test's period of 9999 s lets one sweep run
    # only on a host up for longer than that: its draw 4 then lands on
    # the restart, and on a freshly booted host the regroup completes.)
    plan = FaultPlan([{"site": "replica", "kind": "exception",
                       "at": [1]}])
    router = _tiered_fake_fleet("interactive=r0;bulk=r1,r2", n=3,
                                token_latency_s=0.05, plan=plan,
                                router_kw=dict(probe_period_s=1e12))
    try:
        reqs = [_run(router, f"mc{i}", max_tokens=16) for i in range(4)]
        assert _wait(lambda: any(
            f.member is not None and f.member.name == "r1"
            and f.attempt is not None and f.attempt.req.generated_ids
            for f in list(router.flights)), budget=60.0)
        router.retier_replica("r1", "interactive", why="test")
        for r in reqs:
            items = collect(r)
            assert items[-1].kind == "done"
            words = _text(items).split()
            assert words == [f"word{i}" for i in range(len(words))]
        assert _wait(lambda: _has_record(router, "tier_regroup",
                                         phase="aborted"), budget=60.0)
        assert _wait(lambda: _member(router, "r1").state == "ejected",
                     budget=60.0)
        mem = _member(router, "r1")
        assert mem.tier == "bulk" and mem.retier_to is None
        recs = router.journal.tail(None)
        phases = [r["phase"] for r in recs if r["kind"] == "tier_regroup"]
        assert phases == ["start", "aborted"]
        aborted = [r for r in recs if r["kind"] == "tier_regroup"
                   and r["phase"] == "aborted"][-1]
        assert "crash_mid_retier" in aborted["why"]
        assert check_no_dropped_streams(recs) == []
        assert check_regroup_pairing(recs) == []
        assert tm.FLEET_REGROUPS_TOTAL.labels(
            outcome="aborted").value >= 1
        # Heal: resume probing; the member rejoins its ORIGINAL tier.
        router.probe_period_s = 0.05
        assert _wait(lambda: _has_record(router, "replica_join",
                                         replica="r1", why="heal"),
                     budget=60.0)
        assert _wait(lambda: _member(router, "r1").state == "healthy",
                     budget=60.0)
        assert _member(router, "r1").tier == "bulk"
        joins = router.journal.tail(None, kind="replica_join")
        assert joins[-1]["why"] == "heal"
    finally:
        router.stop()


def test_hysteresis_prevents_regroup_flapping():
    """An oscillating class mix hovers inside the deadband: ZERO
    regroups. A decisive sustained shift clears it: exactly one member
    moves (then the balanced state holds)."""
    router = _tiered_fake_fleet(
        "interactive=r0,r1;bulk=r2,r3", n=4,
        tiering_kw=dict(balance=True, ema_alpha=0.2, deadband=0.18,
                        cooldown_s=0.1, min_samples=8))
    try:
        # Phase 1: strict alternation — mix EMA hovers around 0.5,
        # matching the 2/2 split; the balancer must not move anyone.
        for i in range(40):
            dl = 60_000.0 if i % 2 == 0 else None
            assert collect(_run(router, f"os{i % 4}", max_tokens=2,
                                deadline_ms=dl))[-1].kind == "done"
        assert router.journal.tail(None, kind="tier_regroup") == []
        # Phase 2: the mix shifts hard to interactive — one bulk member
        # retiers (and only one: the balanced state then holds).
        deadline = time.monotonic() + 60.0
        i = 0
        while time.monotonic() < deadline:
            assert collect(_run(router, f"sh{i % 4}", max_tokens=2,
                                deadline_ms=60_000.0))[-1].kind == "done"
            i += 1
            done = [r for r in router.journal.tail(
                None, kind="tier_regroup") if r["phase"] == "done"]
            if done:
                break
        recs = router.journal.tail(None, kind="tier_regroup")
        assert [r["phase"] for r in recs] == ["start", "done"]
        assert recs[0]["why"] == "mix_shift" and recs[0]["mix"] > 0.7
        assert len(router.tiers._tier_members("interactive")) == 3
        # Keep shifting: the now-balanced fleet must not regroup again
        # (desired == current caps at n-1 members per tier).
        for j in range(30):
            assert collect(_run(router, f"st{j % 4}", max_tokens=2,
                                deadline_ms=60_000.0))[-1].kind == "done"
        recs = router.journal.tail(None, kind="tier_regroup")
        assert len([r for r in recs if r["phase"] == "start"]) == 1
        assert check_regroup_pairing(router.journal.tail(None)) == []
    finally:
        router.stop()


# -------------------------------------------------------- in-tier evacuation
def test_failover_lands_victims_back_in_tier():
    """A dying bulk member's streams must land on the OTHER bulk member
    — not the idle (least-loaded fleet-wide) interactive members."""
    router = _tiered_fake_fleet("interactive=r0,r1;bulk=r2,r3", n=4,
                                token_latency_s=0.05)
    try:
        reqs = [_run(router, f"ev{i}", max_tokens=16) for i in range(3)]
        assert _wait(lambda: len(router.flights) == 3 and all(
            f.member is not None and f.attempt is not None
            and f.attempt.req.generated_ids
            for f in list(router.flights)))
        victims = {f.member.name for f in router.flights}
        assert victims <= {"r2", "r3"}  # bulk class placed in-tier
        # Kill whichever bulk member serves a stream; its victims must
        # recover on the OTHER bulk member despite r0/r1 being idle.
        dying = sorted(victims)[0]
        survivor = ({"r2", "r3"} - {dying}).pop()
        _member(router, dying).crash()
        for r in reqs:
            items = collect(r)
            assert items[-1].kind == "done"
            words = _text(items).split()
            assert words == [f"word{i}" for i in range(len(words))]
        recs = router.journal.tail(None)
        landed = [r["to_replica"] for r in recs
                  if r["kind"] == "migrate_import"
                  and r.get("what") != "prefix"]
        landed += [r["to_replica"] for r in recs
                   if r["kind"] == "replica_failover"]
        assert landed and set(landed) == {survivor}, recs
        assert check_no_dropped_streams(recs) == []
    finally:
        router.stop()


# -------------------------------------------------------- journal contract
def test_tier_journal_kinds_schema_explanations_and_invariants():
    from ollamamq_tpu_torch.telemetry.journal import (Journal, JournalError,
                                                      check_invariants,
                                                      explain)

    j = Journal(capacity=64)
    j.record("tier_place", req_id=7, user="u", tier="interactive",
             cls="vip", replica="r0")
    j.record("tier_overflow", req_id=8, user="u",
             from_tier="interactive", to_tier="bulk", why="burn",
             burn=14.5, replica="r1", queued=3)
    j.record("tier_regroup", replica="r1", phase="start",
             from_tier="bulk", to_tier="interactive", why="mix_shift",
             mix=0.82, tp_from=1, tp_to=4)
    j.record("tier_regroup", replica="r1", phase="aborted",
             from_tier="bulk", to_tier="interactive",
             why="crash_mid_retier")
    texts = [explain(r) for r in j.tail(None)]
    assert "class vip" in texts[0] and "tier interactive" in texts[0]
    assert "interactive -> bulk" in texts[1] and "burn 14.5x" in texts[1]
    assert "regroup bulk -> interactive start" in texts[2]
    assert "mix EMA 0.82" in texts[2] and "tp 1 -> 4" in texts[2]
    assert "ORIGINAL tier" in texts[3]
    with pytest.raises(JournalError):
        j.record("tier_place", tier="interactive")  # missing cls
    with pytest.raises(JournalError):
        j.record("tier_overflow", from_tier="a", to_tier="b")  # no why
    with pytest.raises(JournalError):
        j.record("tier_regroup", replica="r1")  # missing phase
    with pytest.raises(JournalError):
        j.record("tier_place", tier="interactive", cls="vip", bogus=1)
    # Invariants: an overflow that never crossed tiers lied; a regroup
    # phase outside the vocabulary is an instrumentation bug.
    bad = check_invariants([
        {"seq": 1, "kind": "tier_overflow", "req_id": 9,
         "from_tier": "bulk", "to_tier": "bulk", "why": "burn"},
        {"seq": 2, "kind": "tier_regroup", "replica": "r1",
         "phase": "maybe"},
    ])
    assert len(bad) == 2
    assert "same tier" in bad[0] and "phase" in bad[1]
    # Regroup pairing (tools/journal check): a hanging start flags.
    hanging = [{"seq": 1, "kind": "tier_regroup", "replica": "r1",
                "phase": "start"}]
    assert any("UNRESOLVED" in v for v in check_regroup_pairing(hanging))
    paired = hanging + [{"seq": 2, "kind": "tier_regroup",
                         "replica": "r1", "phase": "done"}]
    assert check_regroup_pairing(paired) == []


# ------------------------------------------------------- surfaces & deploy
def _http(method, url, body=None):
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(url, data=data, method=method,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_admin_tiers_and_retier_endpoints():
    router = _tiered_fake_fleet("interactive=r0;bulk=r1,r2", n=3)
    srv = serve_in_thread(router, timeout_s=30)
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        status, body = _http("GET", base + "/admin/tiers")
        assert status == 200
        assert body["spec"] == "interactive=r0;bulk=r1,r2"
        assert {m["name"] for m in
                body["tiers"]["bulk"]["members"]} == {"r1", "r2"}
        assert body["tiers"]["interactive"]["overflow_active"] is False
        # /admin/fleet rows carry the tier label too.
        _, fl = _http("GET", base + "/admin/fleet")
        assert {r["name"]: r["tier"] for r in fl["replicas"]} == \
            {"r0": "interactive", "r1": "bulk", "r2": "bulk"}
        # Bad requests fail loudly.
        assert _http("POST", base + "/admin/retier/r1", {})[0] == 400
        assert _http("POST", base + "/admin/retier/r1",
                     {"tier": "gold"})[0] == 400
        assert _http("POST", base + "/admin/retier/nope",
                     {"tier": "bulk"})[0] == 404
        assert _http("POST",  # would empty the interactive tier
                     base + "/admin/retier/r0", {"tier": "bulk"})[0] == 409
        # A real retier commits; poll /admin/tiers until it lands.
        status, _ = _http("POST", base + "/admin/retier/r1",
                          {"tier": "interactive"})
        assert status == 200

        def landed():
            body = _http("GET", base + "/admin/tiers")[1]
            names = {m["name"] for m in
                     body["tiers"]["interactive"]["members"]}
            return "r1" in names and body["regroups"].get("done")

        assert _wait(landed, budget=30.0, period=0.05)
    finally:
        stop_server(srv)
    # Untiered fleets 404 the tier surfaces.
    plain = _tiered_fake_fleet(None)
    srv = serve_in_thread(plain, timeout_s=30)
    try:
        assert _http("GET", f"http://127.0.0.1:{srv.server_address[1]}"
                     "/admin/tiers")[0] == 404
    finally:
        stop_server(srv)


def test_tui_brief_and_regroup_storm_alert():
    from ollamamq_tpu_torch.admin.tui import _engine_stats_brief
    from ollamamq_tpu_torch.engine.health import HealthMonitor
    from ollamamq_tpu_torch.telemetry.slo import AlertManager

    router = _tiered_fake_fleet("interactive=r0;bulk=r1")
    try:
        brief = _engine_stats_brief(router)
        assert brief["tiers"] == {
            "interactive": {"healthy": 1, "total": 1},
            "bulk": {"healthy": 1, "total": 1}}
    finally:
        router.stop()
    plain = _tiered_fake_fleet(None)
    try:
        assert "tiers" not in _engine_stats_brief(plain)
    finally:
        plain.stop()
    # Regroup-storm watchdog: a flapping balancer fires the alert;
    # a quiet one resolves it.
    eng = types.SimpleNamespace(
        alerts=AlertManager(),
        tiers=types.SimpleNamespace(regroup_rate_per_min=lambda: 10.0))
    hm = HealthMonitor(eng)
    hm._check_regroup_storm()
    assert any(a.name == "regroup_storm" for a in eng.alerts.active())
    eng.tiers.regroup_rate_per_min = lambda: 0.0
    hm._check_regroup_storm()
    assert not any(a.name == "regroup_storm"
                   for a in eng.alerts.active())


def test_cli_tiers_validation_fails_fast():
    from ollamamq_tpu_torch.cli import main

    # Tiers need a fleet.
    assert main(["--tiers", "interactive=r0", "--no-tui"]) == 2
    # Unknown tier name / unknown member / empty tier all die pre-device.
    assert main(["--replicas", "2", "--tiers", "gold=r0",
                 "--no-tui"]) == 2
    assert main(["--replicas", "2", "--tiers", "interactive=zz",
                 "--no-tui"]) == 2
    assert main(["--replicas", "2", "--tiers", "interactive=r0,r1",
                 "--no-tui"]) == 2


# ------------------------------------------------- members wider than one rank
@pytest.mark.parametrize("argv,widths", [
    (["--replicas", "2", "--tiers", "interactive@tp2=r0;bulk=r1"],
     {"r0": 2, "r1": 1}),
    (["--replicas", "2", "--tiers", "interactive=r0;bulk@tp4=r1"],
     {"r0": 1, "r1": 4}),
    (["--replicas", "2", "--tp", "2"], {"r0": 2, "r1": 2}),
], ids=["interactive-tp2", "bulk-tp4", "tp-flag"])
def test_cli_refuses_tier_widths_above_one(argv, widths):
    """Tier widths above one and --tp other than 1 with a fleet are no
    longer refused (fleet members wider than one rank are ported): the
    flags validate on the CPU and every member starts at its tier's
    declared width, else at --tp, as the JAX CLI's roster does."""
    from ollamamq_tpu_torch import cli

    args = cli.build_parser().parse_args(argv + ["--no-tui", "--device", "cpu"])
    assert cli.validate(args) == ""
    assert cli.member_widths(args) == widths


def test_cli_member_factory_raises_for_tp2_and_regroup_aborts():
    """The CLI's member factory builds at the width a regroup asks for: a
    regroup whose target tier declares tp2 completes (tier_regroup start
    then done, tp_from 1 / tp_to 2), the member then leads a rank world
    of two ranks (an SPMDEngine, not a one-rank engine under a wider
    label) and serves; the abort of a world that cannot start is covered
    in tests/test_torch_wide_members.py."""
    from ollamamq_tpu_torch import cli

    args = cli.build_parser().parse_args(
        ["--model", "test-tiny", "--device", "cpu", "--replicas", "3",
         "--tiers", "interactive=r0;bulk=r1,r2", "--max-slots", "4",
         "--num-pages", "64", "--page-size", "8",
         "--max-pages-per-seq", "8", "--blocklist", ""])
    assert cli.validate(args) == ""
    ecfg = cli.engine_config(args)
    built = []

    def make(cfg):
        eng = TorchEngine(cfg, device="cpu", blocklist_path=None,
                          models={"test-tiny": None})
        built.append(cfg)
        return eng

    router = cli.build_fleet(args, ecfg, make)
    router.start()
    try:
        mem = _member(router, "r1")
        n_built = len(built)
        # A tier declaring tp2 (as --tiers "interactive@tp2=..." does).
        router.tiers.widths["interactive"] = 2
        router.retier_replica("r1", "interactive", why="test")
        assert _wait(lambda: _has_record(router, "tier_regroup",
                                         phase="done"), budget=120.0)
        start, done = router.journal.tail(None, kind="tier_regroup")
        assert (start["phase"], start["tp_from"], start["tp_to"]) == \
            ("start", 1, 2)
        assert (done["phase"], done["tp_to"]) == ("done", 2)
        assert _wait(lambda: mem.state == "healthy" and mem.alive(),
                     budget=30.0)
        assert mem.tier == "interactive" and mem.retier_to is None
        assert mem.tp == 2 and len(mem.engine.worker_procs) == 1
        assert len(built) == n_built and all(c.tp == 1 for c in built)
        assert check_regroup_pairing(router.journal.tail(None)) == []
        # The regrouped member serves an interactive stream.
        router.core.set_vip("after")
        items = collect(_run(router, "after", max_tokens=4))
        assert items[-1].kind == "done"
        assert router.journal.tail(None, kind="tier_place")[-1]["tier"] == \
            "interactive"
    finally:
        router.stop()
