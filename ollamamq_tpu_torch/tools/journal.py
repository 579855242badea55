"""Offline decision-journal analyzer + deterministic replay harness.

    python -m ollamamq_tpu_torch.tools.journal <command> [args]

Commands over a spilled journal (--journal-file JSONL, or a file written
by `record`):

    tail FILE      raw records (filters: --n/--req-id/--user/--kind)
    explain FILE   per-decision human explanations (same filters)
    stats FILE     batch occupancy + padding-waste + fair-share audit
    merge FILE...  interleave multiple fleet spills (router + members)
                   into ONE arrival-normalized timeline (--out FILE,
                   default stdout): records sort on their shared
                   monotonic clock, re-sequence, carry src/src_seq/
                   src_tick provenance, and get a rebased virtual tick
                   (the gap-capped arrival normalization) — so tail/
                   explain/stats run FLEET-WIDE over the merged file,
                   the live-journal roll-up next to `check`'s audit
    check FILE...  invariant checker (exit 1 on any violation); fleet
                   journals additionally pin zero-drop: every stream a
                   replica_eject/replica_failover touched must reach a
                   terminal record (check_no_dropped_streams), and each
                   recovered/migrated stream exactly ONE terminal
                   (check_stream_attribution). Multiple files run the
                   audit across the union — the fleet roll-up: pass the
                   router's spill AND every member's. Sampled spills
                   (--journal-sample < 1) are detected off the journal
                   meta; the batch-ordinal starvation check is skipped
                   for them (batch records are sampled), everything
                   else — page conservation, slot assignment, zero-drop
                   — reads self-contained records and stays binding.

Record/replay (the determinism acceptance loop):

    record FILE [--seed N] [--requests N]
        drive a seeded chaos run — bursty arrivals over a bounded queue
        against a FakeRuntime engine with a seeded fault plan (injected
        step faults => retries and poisons; admission caps => sheds) —
        SYNCHRONOUSLY (one virtual tick at a time, no engine thread), and
        spill the journal to FILE. Synchronous driving is what makes the
        decision stream a pure function of (seed, arrival sequence).

    replay FILE
        re-drive a `record`-ed run from the journal's own arrival
        sequence (enqueue + admission-shed records) under the same fault
        plan, and assert the replayed decision sequence is IDENTICAL
        (telemetry/journal.py decision_signature). Exit 0 on a perfect
        match, 1 with the first divergence printed otherwise.

    simulate FILE --scheduler X
        the offline policy evaluator: re-drive a recorded run's arrival
        sequence under an ALTERNATIVE scheduling policy (fcfs/srpt/edf)
        and report counterfactual p50/p99 TTFT/TPOT and queue-wait (in
        virtual ticks) against the recorded run, plus the simulated
        run's invariant check and decision-signature digest. Running the
        same simulate twice is deterministic (identical signature), and
        `simulate --scheduler fcfs` of an fcfs recording IS a replay —
        so the promotion story is: record a trace, simulate every
        policy, ship the winner behind --scheduler. Accepts LIVE
        --journal-file spills too (not just `record` traces): arrivals
        are tick-normalized relative to the first one (idle gaps capped)
        and the engine shape is read off the spill's journal_meta, so
        the counterfactual runs over production traffic.

The JAX package's tool (ollamamq_tpu/tools/journal.py), command for
command, over this package's journal and FakeEngine: a trace recorded by
either package's `record` replays under the other's `replay`, and the
two `simulate` runs of one trace give the same signature digest.

Stdlib + engine imports only on demand: tail/explain/stats/check need no
torch and no engine.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional, Tuple

from ollamamq_tpu_torch.config import SCHEDULERS
from ollamamq_tpu_torch.telemetry.journal import (EVENTS, STARVATION_BATCHES,
                                                  Journal, batch_stats,
                                                  check_invariants,
                                                  decision_signature, explain,
                                                  fair_share_audit, load_jsonl)

# The chaos scenario's engine shape: small on purpose (4 slots, bounded
# queue) so a couple dozen arrivals saturate it and every degradation
# decision — shed, retry, poison — shows up in the journal.
_SCENARIO_ENGINE = {"max_slots": 4, "max_queued": 6,
                    "max_queued_per_user": 3, "step_retries": 1}
# Injected step faults: the whole fake step raises, driving the engine's
# retry-then-poison containment path deterministically (call-count
# triggered, so wall-clock never enters the decision stream).
_SCENARIO_FAULTS = {"seed": 0, "faults": [
    {"site": "step", "kind": "exception", "every": 7, "times": 4},
]}

# The bimodal scenario: many short interactive requests + a few long
# batch ones over a tiny slot pool and an UNBOUNDED queue — the regime
# where SRPT-style shortest-predicted-remaining-first beats FIFO on p99
# TTFT (a long output parked in a slot makes the shorts behind it wait).
# No injected faults: the counterfactual readout is pure ordering.
_BIMODAL_ENGINE = {"max_slots": 4, "max_queued": 0,
                   "max_queued_per_user": 0, "step_retries": 1}
_BIMODAL_FAULTS = {"seed": 0, "faults": []}


def check_no_dropped_streams(records: List[dict]) -> List[str]:
    """Fleet zero-drop invariant (end-of-run semantics): every stream a
    replica failure OR a KV migration touched must reach a terminal
    record. The fleet router journals under each stream's ORIGINAL
    router request id — stable across failovers, requeues, and
    migrations — so the audit is a straight pairing:

      - a `replica_failover` / `migrate_export` / `migrate_import` /
        `recover_replay` (outcome "replayed") whose req never reaches
        finish / shed / deadline_drop / poison by the end of the journal
        is a dropped stream;
      - a `migrate_export` resolved by NEITHER `migrate_import` nor
        `migrate_abort` nor a terminal for its req is an orphaned
        two-phase handoff (source state parked forever).

    Run this on COMPLETE journals (a finished bench/chaos run, a drained
    spill) — a live ring mid-failover would report in-flight streams as
    violations, which is why this lives here and not in the health
    monitor's live invariant sweep. A journal cut short by a process
    crash legitimately leaves touched streams pending — the multi-file
    `check` roll-up resolves those against the RESTARTED process's
    spill (a `recover_replay` whose wal_rid names the cut stream)."""
    pending, open_handoff = _dropped_streams(records)
    bad = [
        f"req {rid} stream DROPPED: replica_failover/migration at seq {seq}"
        " with no terminal record (finish/shed/deadline_drop/poison) by "
        "journal end"
        for rid, seq in sorted(pending.items())
    ]
    bad += [
        f"req {rid} migration ORPHANED: migrate_export at seq {seq} never "
        "resolved by migrate_import/migrate_abort or a terminal record"
        for rid, seq in sorted(open_handoff.items())
    ]
    return bad


def _dropped_streams(records: List[dict]) -> Tuple[dict, dict]:
    """(pending, open_handoff) rid->seq maps behind the zero-drop audit."""
    pending: dict = {}  # rid -> seq of the last failover/migration touch
    open_handoff: dict = {}  # rid -> seq of an unresolved migrate_export
    terminal = ("finish", "shed", "deadline_drop", "poison")
    for r in records:
        kind = r.get("kind")
        rid = r.get("req_id")
        if rid is None:
            continue
        if kind == "replica_failover":
            pending[rid] = r.get("seq", "?")
        elif kind == "recover_replay" and r.get("outcome") == "replayed":
            # The WAL zero-drop contract: a recovered stream must reach
            # its terminal like any other (outcome "finished"/"failed"
            # records ARE the terminal story for their streams).
            pending[rid] = r.get("seq", "?")
        elif kind == "migrate_export":
            pending[rid] = r.get("seq", "?")
            open_handoff[rid] = r.get("seq", "?")
        elif kind == "migrate_import":
            pending[rid] = r.get("seq", "?")
            open_handoff.pop(rid, None)
        elif kind == "migrate_abort":
            open_handoff.pop(rid, None)
        elif kind in terminal:
            pending.pop(rid, None)
            open_handoff.pop(rid, None)
    return pending, open_handoff


def check_regroup_pairing(records: List[dict]) -> List[str]:
    """Tiered-fleet regroup audit (end-of-run semantics, like the
    zero-drop checker): every `tier_regroup` phase="start" must resolve
    to a "done" or an "aborted" for the same replica by journal end — a
    start left hanging is a member parked in `draining` with its tier
    move never committed nor rolled back. A done/aborted with no start
    in the window is tolerated (the start may have rotated out of a
    ring tail); the pairing only binds on full spills."""
    open_regroups: dict = {}  # replica -> seq of the unresolved start
    bad: List[str] = []
    for r in records:
        if r.get("kind") != "tier_regroup":
            continue
        rep = r.get("replica")
        phase = r.get("phase")
        if phase == "start":
            prev = open_regroups.get(rep)
            if prev is not None:
                bad.append(
                    f"replica {rep} regroup started at seq "
                    f"{r.get('seq', '?')} while the start at seq {prev} "
                    "was never resolved (one regroup at a time)")
            open_regroups[rep] = r.get("seq", "?")
        elif phase in ("done", "aborted"):
            open_regroups.pop(rep, None)
    bad += [
        f"replica {rep} regroup UNRESOLVED: tier_regroup start at seq "
        f"{seq} never reached done/aborted by journal end"
        for rep, seq in sorted(open_regroups.items())
    ]
    return bad


def check_scale_pairing(records: List[dict]) -> List[str]:
    """Elastic-fleet scale audit (end-of-run semantics, like the
    regroup pairing): every `scale_up` / `scale_down` phase="start"
    must resolve to a "done" or an "aborted" for the same replica by
    journal end — a scale_up left hanging is a spawn that never joined
    (nor journaled its failure); a scale_down left hanging is a member
    parked in `draining` that never left the fleet. A `preempt_notice`
    must be followed by a scale_down start for the same replica — a
    notice with no retire means the reclamation window lapsed with the
    member still serving. Resolutions with no start in the window are
    tolerated (ring tails); the pairing binds on full spills."""
    open_scales: dict = {}   # (direction, replica) -> seq of the start
    notices: dict = {}       # replica -> seq of an unresolved notice
    bad: List[str] = []
    for r in records:
        kind = r.get("kind")
        rep = r.get("replica")
        if kind == "preempt_notice":
            notices[rep] = r.get("seq", "?")
            continue
        if kind not in ("scale_up", "scale_down"):
            continue
        phase = r.get("phase")
        key = (kind, rep)
        if phase == "start":
            prev = open_scales.get(key)
            if prev is not None:
                bad.append(
                    f"replica {rep} {kind} started at seq "
                    f"{r.get('seq', '?')} while the start at seq {prev} "
                    "was never resolved (one scale op at a time)")
            open_scales[key] = r.get("seq", "?")
            if kind == "scale_down":
                notices.pop(rep, None)
        elif phase in ("done", "aborted"):
            open_scales.pop(key, None)
    bad += [
        f"replica {rep} {kind} UNRESOLVED: start at seq {seq} never "
        "reached done/aborted by journal end"
        for (kind, rep), seq in sorted(open_scales.items(),
                                       key=lambda kv: str(kv[0]))
    ]
    bad += [
        f"replica {rep} preemption UNRESOLVED: preempt_notice at seq "
        f"{seq} never followed by a scale_down (the termination notice "
        "lapsed with the member still in the fleet)"
        for rep, seq in sorted(notices.items())
    ]
    return bad


def check_takeover_pairing(records: List[dict]) -> List[str]:
    """Router-HA takeover audit (end-of-run semantics, like the regroup
    pairing): every `router_takeover` phase="begin" must resolve to a
    "done" or an "aborted" by journal end — a begin left hanging is a
    promotion that crashed mid-ladder, which means the fleet may have
    members re-registered to an epoch no live router serves. Takeovers
    are serial per process (a standby promotes at most once, a chained
    standby journals into its own spill), so a begin while another is
    open is a bug outright. Resolutions with no begin are tolerated
    (ring tails); the pairing binds on full spills."""
    open_seq = None
    bad: List[str] = []
    for r in records:
        if r.get("kind") != "router_takeover":
            continue
        phase = r.get("phase")
        if phase == "begin":
            if open_seq is not None:
                bad.append(
                    f"router takeover began at seq {r.get('seq', '?')} "
                    f"while the begin at seq {open_seq} was never "
                    "resolved (one promotion at a time)")
            open_seq = r.get("seq", "?")
        elif phase in ("done", "aborted"):
            open_seq = None
    if open_seq is not None:
        bad.append(
            f"router takeover UNRESOLVED: begin at seq {open_seq} never "
            "reached done/aborted by journal end (promotion crashed "
            "mid-ladder; members may be fenced to an unserved epoch)")
    return bad


def check_epoch_monotonicity(records: List[dict]) -> List[str]:
    """Fencing-epoch audit: the epoch is the fleet's split-brain guard,
    so a takeover "done" must carry an epoch strictly above the epoch
    it took over from, successive takeovers in one spill must strictly
    increase, and a member may only fence callers STRICTLY older than
    the epoch it holds (`stale_epoch < epoch` on every `epoch_fence`)
    — a fence at equal epochs would reject the live router itself.
    Runs per spill; `check_files` adds the cross-spill duplicate check
    (the same epoch completed by two different routers)."""
    bad: List[str] = []
    last_done = None
    for r in records:
        kind = r.get("kind")
        seq = r.get("seq", "?")
        if kind == "router_takeover" and r.get("phase") == "done":
            epoch = r.get("epoch")
            if epoch is None:
                bad.append(
                    f"router_takeover done at seq {seq} carries no "
                    "epoch (fencing unverifiable)")
                continue
            frm = r.get("from_epoch")
            if frm is not None and epoch <= frm:
                bad.append(
                    f"router_takeover done at seq {seq} did not advance "
                    f"the epoch ({frm} -> {epoch}): a promoted standby "
                    "serving an old epoch cannot fence the zombie "
                    "primary")
            if last_done is not None and epoch <= last_done:
                bad.append(
                    f"router_takeover done at seq {seq} epoch {epoch} "
                    f"not above the previous takeover's epoch "
                    f"{last_done} (epochs must be strictly monotonic)")
            last_done = epoch if last_done is None else max(last_done,
                                                            epoch)
        elif kind == "epoch_fence":
            epoch = r.get("epoch")
            stale = r.get("stale_epoch")
            if epoch is not None and stale is not None and stale >= epoch:
                bad.append(
                    f"epoch_fence at seq {seq} rejected epoch {stale} "
                    f"while holding {epoch}: a member may only fence "
                    "strictly older epochs")
    return bad


def check_stream_attribution(records: List[dict]) -> List[str]:
    """Every stream a recovery touched must reach exactly ONE terminal:
    a failed-over/migrated/WAL-recovered stream with two `finish`
    records was served twice (a zombie attempt survived its handoff),
    one with zero is a drop (check_no_dropped_streams reports those).
    Keyed per journal: request-id spaces are process-local, so callers
    merging multiple spills run this per file, not on the raw union."""
    touched = set()
    finishes: dict = {}
    for r in records:
        rid = r.get("req_id")
        if rid is None:
            continue
        kind = r.get("kind")
        if kind in ("replica_failover", "migrate_export") \
                or (kind == "recover_replay"
                    and r.get("outcome") == "replayed") \
                or (kind == "migrate_import" and r.get("what") != "prefix"):
            touched.add(rid)
        elif kind == "finish":
            finishes[rid] = finishes.get(rid, 0) + 1
    return [
        f"req {rid} has {finishes[rid]} terminal finish records: a "
        "recovered/migrated stream must be attributed to exactly one "
        "terminal"
        for rid in sorted(touched)
        if finishes.get(rid, 0) > 1
    ]


def _gen_arrivals(seed: int, n: int) -> List[dict]:
    import random

    rng = random.Random(seed)
    out, tick = [], 0
    for _ in range(n):
        # Bursty: several arrivals share a tick, then a small gap.
        if rng.random() < 0.4:
            tick += rng.randrange(1, 4)
        out.append({"tick": tick, "user": f"u{rng.randrange(4)}",
                    "n_prompt": rng.randrange(3, 40),
                    "max_tokens": rng.choice((2, 4, 8, 12))})
    return out


def _gen_bimodal(seed: int, n: int) -> List[dict]:
    """Bimodal arrivals: ~1 in 5 is a long batch request (the fake
    runtime's 16-token ceiling, long prompt), the rest short interactive
    ones (2 tokens, short prompt). Longs bias EARLY so FIFO parks them
    in the tiny slot pool ahead of the short burst — exactly the regime
    the SRPT counterfactual is supposed to win."""
    import random

    rng = random.Random(seed)
    out, tick = [], 0
    for i in range(n):
        if rng.random() < 0.5:
            tick += 1
        # Front-loaded longs: the first arrivals of each burst are the
        # batch jobs, mirroring "one long request parked ahead of a
        # burst of short interactive ones".
        long = rng.random() < (0.5 if i < n // 6 else 0.12)
        if long:
            out.append({"tick": tick, "user": f"batch{rng.randrange(2)}",
                        "n_prompt": rng.randrange(24, 60),
                        "max_tokens": 16})
        else:
            out.append({"tick": tick, "user": f"chat{rng.randrange(6)}",
                        "n_prompt": rng.randrange(3, 10),
                        "max_tokens": 2})
    return out


def _arrivals_from_records(records: List[dict]) -> List[dict]:
    """The recorded arrival sequence: every accepted enqueue AND every
    admission-shed attempt (a shed arrival never became a Request, but
    replay must re-attempt it to reproduce the shed decision)."""
    out = []
    for r in records:
        if r["kind"] == "enqueue" or (
                r["kind"] == "shed"
                and r.get("reason") in ("queue_full", "user_queue_full")):
            out.append({"tick": r.get("tick", 0), "user": r.get("user", "?"),
                        "n_prompt": int(r.get("n_prompt") or 4),
                        "max_tokens": int(r.get("max_tokens") or 8)})
    return out


# A live engine's tick is its loop-iteration counter: it starts wherever
# the process happens to be and idles forward between arrivals, so a raw
# spill's tick axis is offset and full of dead gaps. Normalization caps
# each inter-arrival gap here — wide enough that the engine drains
# between genuinely separated bursts, bounded so a quiet hour in a spill
# doesn't cost a million empty virtual ticks.
MAX_ARRIVAL_GAP_TICKS = 16


def normalize_arrival_ticks(arrivals: List[dict]) -> List[dict]:
    """Arrival-RELATIVE tick normalization for live spilled journals:
    rebase the first arrival to tick 0 and clamp every inter-arrival gap
    to MAX_ARRIVAL_GAP_TICKS, preserving order and coincidence (arrivals
    sharing a recorded tick still share a virtual one). Synthetic
    `record` traces are already compact and are replayed verbatim — this
    only runs when a journal carries no scenario meta."""
    out = []
    vtick = 0
    prev = None
    for a in arrivals:
        t = int(a.get("tick", 0))
        if prev is not None:
            vtick += min(max(0, t - prev), MAX_ARRIVAL_GAP_TICKS)
        prev = t
        out.append({**a, "tick": vtick})
    return out


# One merged virtual tick per this many seconds of wall-clock gap when
# interleaving fleet spills: per-process `tick` counters advance at
# each process's own loop rate, so the merged axis derives from the
# shared monotonic clock instead (≈ the router's 20ms idle wait per
# tick), with idle gaps capped like the arrival normalization.
MERGE_TICK_S = 0.02


def merge_journals(paths: List[str]) -> Tuple[dict, List[dict]]:
    """Interleave several spilled journals (one fleet run's router +
    member files) into ONE timeline: records sort on their recorded
    monotonic `t` (CLOCK_MONOTONIC is system-wide on Linux, so spills
    from co-located processes share the axis; cross-host skew shows as
    interleave error, never record loss), re-sequence from 0, keep
    provenance (`src` = source file, `src_seq`/`src_tick` = original
    coordinates), and rebase `tick` onto one arrival-normalized virtual
    axis (gaps capped at MAX_ARRIVAL_GAP_TICKS). The result loads like
    any spill: tail/explain/stats consume it fleet-wide."""
    import os as _os

    rows = []
    sources = []
    for path in paths:
        meta, records = load_jsonl(path)
        src = _os.path.basename(path)
        src_meta = {"file": src, "records": len(records)}
        if meta.get("sample") is not None:
            src_meta["sample"] = meta["sample"]
        sources.append(src_meta)
        for r in records:
            rows.append((float(r.get("t") or 0.0), src, r))
    rows.sort(key=lambda x: x[0])  # stable: equal t keeps per-file order
    merged: List[dict] = []
    vtick = 0
    prev_t: Optional[float] = None
    for seq, (t, src, r) in enumerate(rows):
        if prev_t is not None and t > prev_t:
            vtick += min(MAX_ARRIVAL_GAP_TICKS,
                         int((t - prev_t) / MERGE_TICK_S))
        prev_t = t
        rec = dict(r)
        rec["src"] = src
        rec["src_seq"] = r.get("seq")
        rec["src_tick"] = r.get("tick")
        rec["seq"] = seq
        rec["tick"] = vtick
        merged.append(rec)
    return {"version": 1, "merged_from": sources}, merged


def drive_chaos(arrivals: List[dict], fault_plan: dict, engine: dict,
                journal: Journal):
    """Synchronously drive a FakeRuntime engine through the arrival
    sequence, journaling every decision into `journal`. Deterministic by
    construction: virtual ticks, zero retry backoff, call-count-triggered
    faults — wall-clock never reaches a decision site."""
    from ollamamq_tpu_torch.config import EngineConfig
    from ollamamq_tpu_torch.engine.engine import QueueFullError
    from ollamamq_tpu_torch.engine.fake import FakeEngine
    from ollamamq_tpu_torch.ops.sampling import SamplingParams
    from ollamamq_tpu_torch.testing.faults import FaultPlan

    # A fault-free scenario (the bimodal scheduling trace) passes an
    # empty rule list; FaultPlan requires >= 1 rule, so that means "no
    # plan" rather than an empty one.
    plan = (FaultPlan.from_dict(fault_plan)
            if (fault_plan or {}).get("faults") else None)
    ecfg = EngineConfig(model="test-tiny", retry_backoff_s=0.0,
                        fault_plan=plan, **engine)
    eng = FakeEngine(ecfg, blocklist_path=None)
    eng.journal = journal  # the caller's journal (file spill, meta)
    runtimes = list(eng.runtimes.values())
    for rt in runtimes:
        rt.journal = journal
    by_tick: dict = {}
    for a in arrivals:
        by_tick.setdefault(int(a["tick"]), []).append(a)
    last = max(by_tick) if by_tick else 0
    tick, guard = 0, 0
    while True:
        journal.tick = tick
        for a in by_tick.get(tick, ()):
            try:
                eng.enqueue_request(
                    a["user"], "", "test-tiny",
                    prompt_tokens=[1] * int(a["n_prompt"]),
                    sampling=SamplingParams(max_tokens=int(a["max_tokens"])))
            except QueueFullError:
                pass  # the shed decision is already journaled
        eng._admit()
        for rt in runtimes:
            rt.check_cancellations(eng.core)
            if rt.has_work():
                try:
                    rt.step(eng.core)
                except Exception:
                    # Same containment contract as FakeEngine._loop.
                    eng._fail_runtime(rt, "engine step failed")
        busy = (eng.core.total_queued() > 0
                or any(rt.has_work() for rt in runtimes))
        if tick >= last and not busy:
            break
        tick += 1
        guard += 1
        if guard > 100_000:
            raise RuntimeError("chaos drive did not converge")
    journal.close()
    return eng


def record_chaos(path: str, seed: int = 0, requests: int = 24,
                 trace: str = "chaos", scheduler: str = "fcfs") -> Journal:
    """Record one seeded run to `path` (JSONL + scenario meta); returns
    the in-memory journal. trace="chaos" is the degradation storm
    (bounded queue + injected step faults); trace="bimodal" is the
    scheduling workload (short interactive + long batch arrivals, no
    faults) the `simulate` counterfactual evaluator feeds on. The
    scheduler lands in the scenario meta so replay re-drives under the
    SAME policy."""
    if trace == "bimodal":
        arrivals = _gen_bimodal(seed, requests)
        engine, faults = dict(_BIMODAL_ENGINE), dict(_BIMODAL_FAULTS)
    else:
        arrivals = _gen_arrivals(seed, requests)
        engine, faults = dict(_SCENARIO_ENGINE), dict(_SCENARIO_FAULTS)
    engine["scheduler"] = scheduler
    meta = {"scenario": {"seed": seed, "requests": requests,
                         "trace": trace, "engine": engine,
                         "fault_plan": faults}}
    journal = Journal(capacity=max(4096, requests * 64), path=path,
                      meta=meta)
    drive_chaos(arrivals, faults, engine, journal)
    return journal


def simulate_journal(path: str, scheduler: str):
    """Counterfactually re-drive a recorded run's arrival sequence under
    `scheduler` (the offline policy evaluator behind the promotion
    workflow). Returns (recorded_records, simulated_records). Same
    machinery as replay — synchronous virtual-tick driving — so the
    simulated decision stream is a pure function of (recording, policy):
    the same simulate twice yields an identical decision_signature.

    Works on BOTH journal shapes: a `record`-ed trace replays its
    scenario verbatim (engine shape + fault plan from the meta), and a
    LIVE engine's spill is re-driven over its normalized arrival
    sequence (arrival-relative ticks, the engine shape read off the
    spill's own journal_meta, no faults) — so the promotion workflow
    runs over production traffic, not just synthetic traces."""
    meta, records = load_jsonl(path)
    scenario = meta.get("scenario")
    if scenario:
        arrivals = _arrivals_from_records(records)
        engine = dict(scenario["engine"])
        faults = scenario["fault_plan"]
    else:
        # Live spill: no scenario meta. Arrival-relative ticks + the
        # journal header's engine shape make it re-drivable; injected
        # faults are not (wall-clock device failures don't replay).
        arrivals = normalize_arrival_ticks(_arrivals_from_records(records))
        if not arrivals:
            raise SystemExit(
                f"{path} holds no enqueue records: nothing to simulate")
        engine = {"max_slots": int(meta.get("max_slots") or 4),
                  "max_queued": 0, "max_queued_per_user": 0,
                  "step_retries": 1}
        faults = {}
    engine["scheduler"] = scheduler
    fresh = Journal(capacity=max(4096, len(records) * 4 + 64))
    drive_chaos(arrivals, faults, engine, fresh)
    return records, fresh.tail(None)


def counterfactual_stats(records: List[dict]) -> dict:
    """Per-request latency stats in VIRTUAL TICKS off a synchronously
    driven journal: TTFT = enqueue -> install tick (the fake runtime
    emits the first token in its install tick), queue wait = enqueue ->
    admission pop, TPOT = decode ticks per emitted token. Tick deltas,
    not wall-clock — the whole point of the synchronous harness is that
    wall-clock never reaches a decision."""
    enq: dict = {}
    adm: dict = {}
    inst: dict = {}
    fin: dict = {}
    toks: dict = {}
    for r in records:
        rid = r.get("req_id")
        if rid is None:
            continue
        t = int(r.get("tick", 0))
        kind = r.get("kind")
        if kind == "enqueue":
            enq.setdefault(rid, t)
        elif kind == "admit":
            adm.setdefault(rid, t)
        elif kind == "install":
            inst.setdefault(rid, t)
        elif kind == "finish":
            fin.setdefault(rid, t)
            toks.setdefault(rid, int(r.get("tokens") or 0))

    def pctl(xs, q):
        if not xs:
            return None
        xs = sorted(xs)
        return xs[min(len(xs) - 1, int(q * len(xs)))]

    ttfts = [inst[r] - enq[r] for r in inst if r in enq]
    waits = [adm[r] - enq[r] for r in adm if r in enq]
    tpots = [(fin[r] - inst[r]) / max(1, toks.get(r, 1))
             for r in fin if r in inst]
    return {
        "served": len(ttfts),
        "ttft_p50": pctl(ttfts, 0.5),
        "ttft_p99": pctl(ttfts, 0.99),
        "ttft_mean": (round(sum(ttfts) / len(ttfts), 2) if ttfts else None),
        "tpot_p50": (round(pctl(tpots, 0.5), 3) if tpots else None),
        "tpot_p99": (round(pctl(tpots, 0.99), 3) if tpots else None),
        "queue_wait_mean": (round(sum(waits) / len(waits), 2)
                            if waits else None),
    }


def replay_journal(path: str):
    """Re-drive the recorded run; returns (ok, recorded_sig, replayed_sig,
    first_divergence_index_or_None)."""
    meta, records = load_jsonl(path)
    scenario = meta.get("scenario")
    if not scenario:
        raise SystemExit(
            f"{path} carries no scenario meta: replay needs a journal "
            "written by `tools/journal record` (a live engine's spill "
            "lacks the engine shape + fault plan to re-drive)")
    arrivals = _arrivals_from_records(records)
    fresh = Journal(capacity=max(4096, len(records) + 64))
    drive_chaos(arrivals, scenario["fault_plan"], scenario["engine"], fresh)
    rec_sig = decision_signature(records)
    rep_sig = decision_signature(fresh.tail(None))
    if rec_sig == rep_sig:
        return True, rec_sig, rep_sig, None
    div = next((i for i, (a, b) in enumerate(zip(rec_sig, rep_sig))
                if a != b), min(len(rec_sig), len(rep_sig)))
    return False, rec_sig, rep_sig, div


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def _filtered(records: List[dict], args) -> List[dict]:
    if args.req_id is not None:
        records = [r for r in records if r.get("req_id") == args.req_id]
    if args.user:
        records = [r for r in records if r.get("user") == args.user]
    if args.kind:
        records = [r for r in records if r.get("kind") == args.kind]
    if args.n and args.n > 0:
        records = records[-args.n:]
    return records


def _cmd_tail(args) -> int:
    _meta, records = load_jsonl(args.file)
    for r in _filtered(records, args):
        print(json.dumps(r))
    return 0


def _cmd_explain(args) -> int:
    _meta, records = load_jsonl(args.file)
    for r in _filtered(records, args):
        src = f" {r['src']}" if r.get("src") else ""  # merged spills
        print(f"[{r.get('seq', '?'):>6} t{r.get('tick', '?')}{src}] "
              f"{explain(r)}")
    return 0


def _cmd_merge(args) -> int:
    meta, merged = merge_journals(args.file)
    lines = [json.dumps({"journal_meta": meta})]
    lines += [json.dumps(r, default=str) for r in merged]
    if args.out and args.out != "-":
        with open(args.out, "w", encoding="utf-8") as f:
            f.write("\n".join(lines) + "\n")
        srcs = ", ".join(s["file"] for s in meta["merged_from"])
        print(f"merged {len(merged)} records from {len(args.file)} "
              f"spill(s) ({srcs}) -> {args.out}")
    else:
        for line in lines:
            print(line)
    return 0


def _cmd_stats(args) -> int:
    _meta, records = load_jsonl(args.file)
    bs = batch_stats(records)
    print("batch stats:")
    for k, v in bs.items():
        print(f"  {k}: {v}")
    print("fair-share audit (per user):")
    audit = fair_share_audit(records)
    for user in sorted(audit):
        row = audit[user]
        cells = "  ".join(f"{k}={v}" for k, v in row.items())
        print(f"  {user}: {cells}")
    kinds: dict = {}
    for r in records:
        kinds[r["kind"]] = kinds.get(r["kind"], 0) + 1
    print("events by kind:")
    for k in sorted(kinds, key=kinds.get, reverse=True):
        print(f"  {k}: {kinds[k]}")
    return 0


def check_files(paths: List[str]) -> Tuple[List[str], int]:
    """The fleet-wide audit roll-up over one or more spills (router +
    member journals of one run). Per-spill: the invariant checker
    (starvation skipped on sampled traces — batch records are sampled;
    everything else reads self-contained records and stays binding),
    the zero-drop audit, and the exactly-one-terminal attribution.
    Across the union: a stream left pending by a spill that ends in a
    process crash is resolved by the RESTARTED process's spill when a
    `recover_replay` names it via wal_rid — that is the WAL zero-drop
    contract spanning the crash. Returns (violations, total_records)."""
    loaded = []
    notes: List[str] = []
    per_file_recovered: List[set] = []
    for path in paths:
        meta, records = load_jsonl(path)
        sampled = float(meta.get("sample") or 1.0) < 1.0
        loaded.append((path, records, sampled, meta))
        per_file_recovered.append({
            int(r["wal_rid"]) for r in records
            if r.get("kind") == "recover_replay"
            and r.get("wal_rid") is not None
            and r.get("outcome") in ("replayed", "finished")})
    bad: List[str] = []
    total = 0
    for idx, (path, records, sampled, _meta) in enumerate(loaded):
        tag = f"{path}: " if len(paths) > 1 else ""
        total += len(records)
        # Cross-crash resolution set: wal_rids recovered by OTHER spills
        # (a restarted process's journal resolves the crashed one's cut
        # streams — never its own: rid counters restart at 1, so a
        # spill's own wal_rids can collide with its fresh rids).
        recovered_wal_rids = set().union(
            *(s for j, s in enumerate(per_file_recovered) if j != idx),
            set())
        if sampled:
            notes.append(f"{tag}sampled trace (journal meta): "
                         "batch-ordinal starvation check skipped, all "
                         "other invariants binding")
        bad += [tag + v for v in check_invariants(
            records, starve_after=None if sampled else STARVATION_BATCHES)]
        if any(r.get("kind") == "tier_regroup" for r in records):
            bad += [tag + v for v in check_regroup_pairing(records)]
        if any(r.get("kind") in ("scale_up", "scale_down",
                                 "preempt_notice") for r in records):
            bad += [tag + v for v in check_scale_pairing(records)]
        if any(r.get("kind") == "router_takeover" for r in records):
            bad += [tag + v for v in check_takeover_pairing(records)]
        if any(r.get("kind") in ("router_takeover", "epoch_fence")
               for r in records):
            bad += [tag + v for v in check_epoch_monotonicity(records)]
        if not any(r.get("kind", "").startswith(("replica_", "migrate_",
                                                 "recover_"))
                   for r in records):
            continue
        pending, open_handoff = _dropped_streams(records)
        for rid, seq in sorted(pending.items()):
            if rid in recovered_wal_rids:
                continue  # resolved across the crash by WAL recovery
            bad.append(
                f"{tag}req {rid} stream DROPPED: replica_failover/"
                f"migration/recovery at seq {seq} with no terminal "
                "record by journal end and no recover_replay for it in "
                "any companion spill")
        bad += [
            f"{tag}req {rid} migration ORPHANED: migrate_export at seq "
            f"{seq} never resolved by migrate_import/migrate_abort or a "
            "terminal record"
            for rid, seq in sorted(open_handoff.items())
        ]
        bad += [tag + v for v in check_stream_attribution(records)]
    # Cross-spill epoch audit: the same epoch completed ("done") by two
    # different spills is split brain — two routers both believe they
    # own the fleet at that epoch. Standby replica files (journal_meta
    # carries replica_of) are byte copies of another spill and would
    # duplicate every record, so they are excluded here; the per-file
    # checks above still bind on them.
    done_epochs: dict = {}  # epoch -> path of the spill that did it
    for path, records, _sampled, meta in loaded:
        if meta.get("replica_of"):
            continue
        for r in records:
            if (r.get("kind") == "router_takeover"
                    and r.get("phase") == "done"
                    and r.get("epoch") is not None):
                ep = r["epoch"]
                prev = done_epochs.get(ep)
                if prev is not None and prev != path:
                    bad.append(
                        f"epoch {ep} taken over TWICE: router_takeover "
                        f"done in {prev} and {path} (split brain — two "
                        "routers promoted into the same epoch)")
                else:
                    done_epochs.setdefault(ep, path)
    for n in notes:
        print(n)
    return bad, total


def _cmd_check(args) -> int:
    files = args.file if isinstance(args.file, list) else [args.file]
    bad, total = check_files(files)
    if bad:
        print(f"{len(bad)} invariant violation(s):", file=sys.stderr)
        for b in bad:
            print(f"  - {b}", file=sys.stderr)
        return 1
    scope = (f"{len(files)} journal(s), " if len(files) > 1 else "")
    print(f"ok: {scope}{total} records, all invariants hold "
          "(pages conserved, no slot double-assignment, victim never VIP, "
          "sheds only over bounds, no starvation, no dropped streams, "
          "every recovered stream attributed to exactly one terminal)")
    return 0


def _cmd_simulate(args) -> int:
    import hashlib

    recorded, simulated = simulate_journal(args.file, args.scheduler)
    base = counterfactual_stats(recorded)
    cf = counterfactual_stats(simulated)
    sig = decision_signature(simulated)
    digest = hashlib.sha256(repr(sig).encode()).hexdigest()[:16]
    print(f"simulate --scheduler {args.scheduler}: {len(simulated)} "
          f"records, {len(sig)} decisions, "
          f"decision_signature {digest}")
    print("counterfactual vs recorded (virtual ticks):")
    print(f"  {'metric':<16} {'recorded':>10} {'simulated':>10} "
          f"{'delta':>10}")
    for k in ("served", "ttft_p50", "ttft_p99", "ttft_mean",
              "tpot_p50", "tpot_p99", "queue_wait_mean"):
        a, b = base.get(k), cf.get(k)
        delta = (round(b - a, 3)
                 if isinstance(a, (int, float)) and isinstance(b, (int, float))
                 else "-")
        print(f"  {k:<16} {str(a):>10} {str(b):>10} {str(delta):>10}")
    bad = check_invariants(simulated)
    if bad:
        print(f"{len(bad)} invariant violation(s) in the simulated run:",
              file=sys.stderr)
        for b in bad:
            print(f"  - {b}", file=sys.stderr)
        return 1
    print("simulated run invariant-clean")
    return 0


def _cmd_record(args) -> int:
    journal = record_chaos(args.file, seed=args.seed,
                           requests=args.requests, trace=args.trace,
                           scheduler=args.scheduler)
    recs = journal.tail(None)
    kinds: dict = {}
    for r in recs:
        kinds[r["kind"]] = kinds.get(r["kind"], 0) + 1
    print(f"recorded {journal.seq} decision records to {args.file} "
          f"(seed={args.seed}, {args.requests} arrivals)")
    print("  " + "  ".join(f"{k}={kinds[k]}" for k in sorted(kinds)))
    bad = check_invariants(recs)
    if bad:
        print(f"WARNING: {len(bad)} invariant violation(s) in the recorded "
              "run", file=sys.stderr)
        return 1
    return 0


def _cmd_replay(args) -> int:
    ok, rec_sig, rep_sig, div = replay_journal(args.file)
    if ok:
        print(f"replay deterministic: {len(rep_sig)} decisions identical")
        return 0
    print(f"REPLAY DIVERGED at decision {div} "
          f"(recorded {len(rec_sig)}, replayed {len(rep_sig)}):",
          file=sys.stderr)
    lo, hi = max(0, div - 2), div + 3
    for i in range(lo, hi):
        a = rec_sig[i] if i < len(rec_sig) else "<end>"
        b = rep_sig[i] if i < len(rep_sig) else "<end>"
        mark = " " if a == b else "!"
        print(f" {mark} [{i}] recorded={a}  replayed={b}", file=sys.stderr)
    return 1


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m ollamamq_tpu_torch.tools.journal",
        description="decision-journal analyzer + deterministic replay")
    sub = p.add_subparsers(dest="cmd", required=True)

    def add_filters(sp):
        sp.add_argument("file")
        sp.add_argument("--n", type=int, default=0,
                        help="tail length (0 = all)")
        sp.add_argument("--req-id", type=int, default=None)
        sp.add_argument("--user", default="")
        sp.add_argument("--kind", default="", choices=("",) + EVENTS)

    for name, fn in (("tail", _cmd_tail), ("explain", _cmd_explain)):
        sp = sub.add_parser(name)
        add_filters(sp)
        sp.set_defaults(fn=fn)
    for name, fn in (("stats", _cmd_stats), ("replay", _cmd_replay)):
        sp = sub.add_parser(name)
        sp.add_argument("file")
        sp.set_defaults(fn=fn)
    sp = sub.add_parser("check")
    sp.add_argument("file", nargs="+",
                    help="one or more spilled journals; several run the "
                         "fleet-wide roll-up (router + member spills "
                         "audited as one run)")
    sp.set_defaults(fn=_cmd_check)
    sp = sub.add_parser("merge")
    sp.add_argument("file", nargs="+",
                    help="two or more spilled journals of ONE fleet run "
                         "(router + members) to interleave into a "
                         "single arrival-normalized timeline")
    sp.add_argument("--out", default="-",
                    help="merged JSONL destination ('-' = stdout); "
                         "tail/explain/stats then run fleet-wide over "
                         "it")
    sp.set_defaults(fn=_cmd_merge)
    sp = sub.add_parser("record")
    sp.add_argument("file")
    sp.add_argument("--seed", type=int, default=0)
    sp.add_argument("--requests", type=int, default=24)
    sp.add_argument("--trace", choices=("chaos", "bimodal"),
                    default="chaos",
                    help="arrival workload: 'chaos' (degradation storm, "
                         "injected faults) or 'bimodal' (short "
                         "interactive + long batch requests, no faults "
                         "— the scheduling counterfactual's input)")
    sp.add_argument("--scheduler", choices=SCHEDULERS, default="fcfs",
                    help="policy the RECORDED run schedules under "
                         "(lands in the scenario meta so replay "
                         "re-drives it identically)")
    sp.set_defaults(fn=_cmd_record)
    sp = sub.add_parser("simulate")
    sp.add_argument("file")
    sp.add_argument("--scheduler", choices=SCHEDULERS, default="srpt",
                    help="counterfactual policy to re-drive the "
                         "recorded arrival sequence under; reports "
                         "p50/p99 TTFT/TPOT + queue-wait deltas vs the "
                         "recorded run")
    sp.set_defaults(fn=_cmd_simulate)
    return p


def main(argv: Optional[list] = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
