"""THE declaration site for every ollamamq_* metric.

Everything the process exports lives here, so the engine/server grab
handles instead of re-declaring names inline. The set is exactly the
JAX package's (same names, types, labels, help text and buckets), so
the README's Observability table covers both packages; a series whose
module this package lacks (journal, fleet, WAL) stays registered and
is never set, as in a JAX-package process without that module.

Naming: `ollamamq_` prefix; latencies in milliseconds carry an `_ms`
suffix; counters carry `_total`. Per-model series are labeled
{model=...}; per-user queue depth {user=...}; per-chip HBM {chip=,host=}.
"""

from __future__ import annotations

from ollamamq_tpu_torch.telemetry.metrics import (DEFAULT_LATENCY_BUCKETS_MS,
                                            REGISTRY)

# -- request latency histograms (re-bucketable via --metrics-buckets) ------
TTFT_MS = REGISTRY.histogram(
    "ollamamq_ttft_ms",
    "Time to first token per request, enqueue to first sampled token (ms)",
    buckets=DEFAULT_LATENCY_BUCKETS_MS, labels=("model",))
TPOT_MS = REGISTRY.histogram(
    "ollamamq_tpot_ms",
    "Time per output token: decode step latency per emitted token (ms)",
    buckets=DEFAULT_LATENCY_BUCKETS_MS, labels=("model",))
STEP_LATENCY_MS = REGISTRY.histogram(
    "ollamamq_step_latency_ms",
    "Decode step device latency, blocked-collect time per fused step (ms)",
    buckets=DEFAULT_LATENCY_BUCKETS_MS, labels=("model",))
PREFILL_LATENCY_MS = REGISTRY.histogram(
    "ollamamq_prefill_latency_ms",
    "Prefill forward latency per dispatched batch or chunk (ms)",
    buckets=DEFAULT_LATENCY_BUCKETS_MS, labels=("model",))

# -- engine occupancy / utilization gauges ---------------------------------
BATCH_OCCUPANCY = REGISTRY.gauge(
    "ollamamq_batch_occupancy",
    "Active decode slots / max_slots (0..1), sampled per decode step",
    labels=("model",))
BATCH_PADDING_WASTE = REGISTRY.gauge(
    "ollamamq_batch_padding_waste",
    "Fraction of the last dispatched batch's token positions that were "
    "padding (0..1): bucket rows minus real tokens on the bucketed path, "
    "the granule tail on the ragged path — the compute burned for shape "
    "stability", labels=("model",))
KV_PAGES_USED = REGISTRY.gauge(
    "ollamamq_kv_pages_used",
    "KV cache pages currently allocated", labels=("model",))
KV_PAGE_UTILIZATION = REGISTRY.gauge(
    "ollamamq_kv_page_utilization",
    "KV cache pages allocated / pool size (0..1)", labels=("model",))
MFU = REGISTRY.gauge(
    "ollamamq_mfu",
    "Model FLOPs utilization (0..1): analytic FLOPs/token x tokens per "
    "decode step over per-chip peak FLOPs x chips (0 when the peak for "
    "this accelerator is unknown; override with OLLAMAMQ_PEAK_FLOPS)",
    labels=("model",))
FLOPS_PER_TOKEN = REGISTRY.gauge(
    "ollamamq_model_flops_per_token",
    "Analytic forward FLOPs per generated token at zero context "
    "(2 x active params; attention adds ~4 x layers x ctx x q_dim)",
    labels=("model",))

# -- queue / request flow --------------------------------------------------
QUEUE_DEPTH = REGISTRY.gauge(
    "ollamamq_queue_depth",
    "Requests waiting in the fair-share queue, per user",
    labels=("user",))
REQUESTS_INFLIGHT = REGISTRY.gauge(
    "ollamamq_requests_inflight",
    "Requests accepted and not yet finished (any kind)")
REQUESTS_TOTAL = REGISTRY.counter(
    "ollamamq_requests_total",
    "Finished requests by outcome (stop/length/cancelled/error)",
    labels=("model", "outcome"))
TOKENS_GENERATED_TOTAL = REGISTRY.counter(
    "ollamamq_tokens_generated_total",
    "Tokens sampled across all requests", labels=("model",))
PROMPT_TOKENS_TOTAL = REGISTRY.counter(
    "ollamamq_prompt_tokens_total",
    "Prompt tokens prefilled across all requests", labels=("model",))

# -- prefix cache (engine/prefix_cache.py; series exist only when
# --prefix-cache is on) ----------------------------------------------------
PREFIX_CACHE_HITS_TOTAL = REGISTRY.counter(
    "ollamamq_prefix_cache_hits_total",
    "Admissions that reused a cached prompt prefix (≥ min-pages match)",
    labels=("model",))
PREFIX_CACHE_MISSES_TOTAL = REGISTRY.counter(
    "ollamamq_prefix_cache_misses_total",
    "Admissions with no (or below-threshold) cached prefix",
    labels=("model",))
PREFIX_CACHE_EVICTIONS_TOTAL = REGISTRY.counter(
    "ollamamq_prefix_cache_evictions_total",
    "Cached KV pages evicted back to the free list (LRU, on allocator "
    "pressure or flush)", labels=("model",))
PREFIX_CACHE_HIT_RATIO = REGISTRY.gauge(
    "ollamamq_prefix_cache_hit_ratio",
    "Prefix-cache hits / lookups since start (0..1)", labels=("model",))
PREFIX_CACHE_TOKENS_SAVED = REGISTRY.gauge(
    "ollamamq_prefix_cache_tokens_saved",
    "Cumulative prompt tokens served from cached KV pages instead of "
    "recomputed", labels=("model",))
PREFIX_CACHE_PAGES = REGISTRY.gauge(
    "ollamamq_prefix_cache_pages",
    "KV pages currently owned by the prefix-cache radix tree",
    labels=("model",))

# -- graceful degradation under load (engine preemption / bounded
# admission / deadlines / retry containment) -------------------------------
# Closed vocabulary for ollamamq_shed_total{reason}; the doc gate
# (scripts/check_metrics_docs.py) pins the README table to this tuple.
SHED_REASONS = ("queue_full", "user_queue_full", "deadline", "kv_exhausted")
PREEMPTIONS_TOTAL = REGISTRY.counter(
    "ollamamq_preemptions_total",
    "Decode slots preempted under KV-pool pressure (victim requeued to "
    "the front of its user's queue for recompute)", labels=("model",))
SHED_TOTAL = REGISTRY.counter(
    "ollamamq_shed_total",
    "Requests shed instead of served, by reason (queue_full / "
    "user_queue_full / deadline / kv_exhausted)", labels=("reason",))
RETRIES_TOTAL = REGISTRY.counter(
    "ollamamq_retries_total",
    "Requests re-dispatched after a contained runtime-step failure "
    "(once each with backoff; repeat offenders are poisoned and errored)",
    labels=("model",))
DEADLINE_DROPS_TOTAL = REGISTRY.counter(
    "ollamamq_deadline_drops_total",
    "Requests dropped because their per-request deadline expired "
    "(at admission, before prefill dispatch, before composing a "
    "speculative verify span, or at preemption re-admission)",
    labels=("model",))

# -- speculative decoding (--spec; n-gram draft + ragged verify) -----------
SPEC_TOKENS_TOTAL = REGISTRY.counter(
    "ollamamq_spec_tokens_total",
    "Speculative draft tokens by outcome: proposed (composed into a "
    "verify span), accepted (matched the model's greedy argmax and "
    "emitted), rejected (KV pages rolled back)",
    labels=("model", "outcome"))
SPEC_ACCEPT_RATE = REGISTRY.gauge(
    "ollamamq_spec_accept_rate",
    "Accepted / proposed speculative draft tokens since start (0..1); "
    "the per-user auto-throttle (--spec-min-accept) keys off the same "
    "accounting", labels=("model",))


# -- size-aware scheduling (engine/scheduler.py; --scheduler) --------------
SCHED_PRED_ERR = REGISTRY.histogram(
    "ollamamq_sched_pred_err",
    "Output-length predictor absolute error in tokens (|predicted - "
    "actual|), observed at request finish — the srpt/edf scheduling "
    "policies order by these predictions, so this histogram is the "
    "promotion guardrail's live twin",
    buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256, 512), labels=("model",))
SCHED_DECISIONS_TOTAL = REGISTRY.counter(
    "ollamamq_sched_decisions_total",
    "Scheduling-policy reorder decisions applied (admission windows, "
    "pending-queue reorders), by policy; fcfs never reorders so its "
    "series stays 0", labels=("policy",))


def total_shed() -> float:
    """Sum of ollamamq_shed_total over all reasons (TUI chip)."""
    return sum(child.value for _, child in SHED_TOTAL.series())


# -- latency attribution / SLO / alerting (telemetry/attribution.py,
# telemetry/slo.py, engine/health.py watchdog) ------------------------------
REQUEST_PHASE_MS = REGISTRY.histogram(
    "ollamamq_request_phase_ms",
    "Per-request latency attribution: milliseconds spent in each lifecycle "
    "phase (queue/admission/prefix_cache/prefill/decode/stream), observed "
    "at request finish; phases sum to end-to-end latency",
    buckets=DEFAULT_LATENCY_BUCKETS_MS, labels=("model", "phase"))
SLO_VIOLATIONS_TOTAL = REGISTRY.counter(
    "ollamamq_slo_violations_total",
    "Observations over the configured SLO threshold (--slo-ttft-ms / "
    "--slo-tpot-ms), by objective; series exist only with SLOs configured",
    labels=("objective",))
SLO_BURN_RATE = REGISTRY.gauge(
    "ollamamq_slo_burn_rate",
    "Error-budget burn rate over each alerting window's long leg "
    "(bad/total over window / (1 - target)); 1.0 = spending exactly the "
    "budget, above the window's factor = alert", labels=("objective",
                                                         "window"))
SLO_ALERTS_FIRING = REGISTRY.gauge(
    "ollamamq_slo_alerts_firing",
    "Active alerts (SLO burn, watchdog stalls, device loss): 1 per "
    "firing alert, rebuilt each scrape so resolved alerts disappear",
    labels=("alert", "severity"))
WATCHDOG_STALLS_TOTAL = REGISTRY.counter(
    "ollamamq_watchdog_stalls_total",
    "Stall watchdog firings by kind (engine_step, request_phase, "
    "worker_host, device, replica, scale, standby, takeover)",
    labels=("kind",))

# -- decision journal (telemetry/journal.py; GET /debug/journal) -----------
JOURNAL_EVENTS_TOTAL = REGISTRY.counter(
    "ollamamq_journal_events_total",
    "Scheduler decision-journal records appended, by event kind (the "
    "flight recorder's write rate; tail the ring at /debug/journal)",
    labels=("kind",))

# -- int8 quantization (serving density; --weights-dtype / --kv-dtype) -----
HBM_WEIGHT_BYTES = REGISTRY.gauge(
    "ollamamq_hbm_weight_bytes",
    "Bytes the loaded weights occupy per model runtime (int8 payloads + "
    "fp32 scales when --weights-dtype=int8 — the density lever's "
    "before/after)", labels=("model",))
HBM_KV_BYTES = REGISTRY.gauge(
    "ollamamq_hbm_kv_bytes",
    "Bytes the KV page pool occupies per model runtime (int8 pages + "
    "fp32 scale rows when --kv-dtype=int8; ~2x more concurrent requests "
    "fit the same budget)", labels=("model",))
QUANT_LOGIT_ERR = REGISTRY.gauge(
    "ollamamq_quant_logit_err",
    "Max absolute logit error of the int8-quantized weights vs their "
    "bf16 source on the guardrail probe (teacher-forced greedy rollout; "
    "set when the guardrail runs — tests, bench density scenario)",
    labels=("model",))

# -- fleet router (fleet/router.py; dispatcher-over-engines) ---------------
# Closed site vocabulary for ollamamq_router_overhead_ms{site}: every
# always-on nanosecond timer around the router hot path. "place" is the
# bounded one (the bench fleet-chaos gate fails when its p99 exceeds
# --router-overhead-budget-ms); the rest attribute where the router's
# own time goes per decision.
ROUTER_OVERHEAD_SITES = ("place", "journal", "wal_fsync",
                         "migrate_export", "migrate_ship",
                         "migrate_import")
ROUTER_OVERHEAD_MS = REGISTRY.histogram(
    "ollamamq_router_overhead_ms",
    "Router hot-path self-profiling: milliseconds the router itself "
    "spent per decision, by site (place = the placement decision, "
    "journal = one flight-recorder append, wal_fsync = the durable-"
    "admission gate, migrate_export/_ship/_import = the three legs of "
    "a KV handoff) — always-on perf_counter_ns timers, the measured "
    "and bounded 'router overhead' of the fleet-scale story",
    buckets=(0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
             25.0, 50.0, 100.0, 250.0, 1000.0),
    labels=("site",))
FLEET_REPLICAS = REGISTRY.gauge(
    "ollamamq_fleet_replicas",
    "Engine replicas under the fleet router by state (healthy / ejected "
    "/ draining); absent when serving single-engine", labels=("state",))
FLEET_FAILOVERS_TOTAL = REGISTRY.counter(
    "ollamamq_fleet_failovers_total",
    "In-flight streams re-dispatched to another replica after their "
    "replica died or was ejected (each replays prompt + already-emitted "
    "tokens so the client sees one seamless stream)")
FLEET_AFFINITY_HITS_TOTAL = REGISTRY.counter(
    "ollamamq_fleet_placement_affinity_hits_total",
    "Placements routed to the replica whose prefix-cache radix tree "
    "already held the prompt's prefix (--placement=affinity); misses "
    "fall back to least-loaded")
FLEET_TIER_MEMBERS = REGISTRY.gauge(
    "ollamamq_fleet_tier_members",
    "Fleet members per replica tier by state (healthy / ejected / "
    "draining) under --tiers; a tier whose healthy count hits 0 is "
    "serving its traffic cross-tier (journaled tier_overflow) until a "
    "member heals or regroups in", labels=("tier", "state"))
FLEET_TIER_OVERFLOW_TOTAL = REGISTRY.counter(
    "ollamamq_fleet_tier_overflow_total",
    "Streams placed cross-tier, by (from, to) tier: per-tier SLO "
    "burn-rate overflow, an empty home tier, or a failover with no "
    "in-tier capacity — every one journaled as tier_overflow with its "
    "inputs", labels=("from", "to"))
FLEET_REGROUPS_TOTAL = REGISTRY.counter(
    "ollamamq_fleet_regroups_total",
    "Tier regroups (a member drained, live streams migrated off, "
    "hot-restarted at the target tier's TP width, rejoined the other "
    "tier) by outcome: 'done' or 'aborted' (crash/restart failure "
    "mid-retier; the member keeps its original tier)",
    labels=("outcome",))
FLEET_MIGRATIONS_TOTAL = REGISTRY.counter(
    "ollamamq_fleet_migrations_total",
    "KV page migrations between fleet members by outcome: 'migrated' "
    "(stream resumed from shipped state on the target), 'aborted' "
    "(transfer failed; the stream fell back to recompute replay), "
    "'prefix' (an affinity-miss shipped cached prefix pages to the "
    "chosen member)", labels=("outcome",))
FLEET_MIGRATE_BYTES_TOTAL = REGISTRY.counter(
    "ollamamq_fleet_migrate_bytes_total",
    "KV page payload bytes shipped between fleet members (migrations "
    "and prefix shipping; int8 pools move ~2x fewer bytes than bf16)")

# -- elastic fleet (fleet/autoscaler.py; --autoscale) ----------------------
FLEET_SCALE_EVENTS_TOTAL = REGISTRY.counter(
    "ollamamq_fleet_scale_events_total",
    "Autoscaler fleet-size changes by direction ('up' = member "
    "provisioned and joined, 'down' = member drained, migrated off, and "
    "retired) and outcome ('done' or 'aborted': a failed spawn, or an "
    "eject mid-retire) — every one journaled as scale_up/scale_down "
    "with the burn + backlog inputs that justified it",
    labels=("direction", "outcome"))
FLEET_MEMBER_HOURS_TOTAL = REGISTRY.counter(
    "ollamamq_fleet_member_hours_total",
    "Cumulative member-serving hours (fractional; accrued each scaler "
    "tick over every non-ejected member) — the resource-cost side of "
    "the elastic-fleet ledger the diurnal bench gates on")
FLEET_PREEMPTIONS_TOTAL = REGISTRY.counter(
    "ollamamq_fleet_preemptions_total",
    "Termination notices served to preemptible members (POST "
    "/admin/preempt/{replica} or the fault plan's preempt_notice site); "
    "each triggers migrate-off-then-retire within the notice window — "
    "spot reclamation with zero dropped streams")

# -- router HA (fleet/ha.py; --ha / --standby-of) --------------------------
HA_SYNC_LAG_RECORDS = REGISTRY.gauge(
    "ollamamq_ha_sync_lag_records",
    "Replication records the warm standby has not yet applied (primary "
    "head seq minus last acked seq); primary-side it tracks the "
    "connected standby's ack, standby-side its own apply position — "
    "what a takeover would have to recover without")
HA_SYNC_RECORDS_TOTAL = REGISTRY.counter(
    "ollamamq_ha_sync_records_total",
    "Replication records shipped over /admin/ha/sync by kind ('wal' = "
    "admission-WAL records into the standby's WAL replica, 'journal' = "
    "decision events into the standby's journal spill)",
    labels=("kind",))
HA_TAKEOVERS_TOTAL = REGISTRY.counter(
    "ollamamq_ha_takeovers_total",
    "Standby promotions to primary by why ('primary_dead' = heartbeat "
    "loss past the takeover grace, 'handover' = graceful SIGTERM on the "
    "primary handed the fleet over)", labels=("why",))
HA_TAKEOVER_DURATION_MS = REGISTRY.histogram(
    "ollamamq_ha_takeover_duration_ms",
    "Promotion wall time (ms): primary declared dead to the standby "
    "serving with every unfinished WAL stream re-admitted — the EMA of "
    "this feeds promotion-window Retry-After hints",
    buckets=(10, 25, 50, 100, 250, 500, 1000, 2500, 5000, 10000, 30000))
HA_FENCED_CALLS_TOTAL = REGISTRY.counter(
    "ollamamq_ha_fenced_calls_total",
    "Stale-epoch router calls a member rejected after a takeover, by "
    "kind (placement / migrate / register) — each one is a zombie "
    "primary's write the epoch fence turned away, journaled epoch_fence",
    labels=("kind",))

# -- crash durability (durability/; --wal-dir) -----------------------------
WAL_FSYNC_MS = REGISTRY.histogram(
    "ollamamq_wal_fsync_ms",
    "Admission-WAL fsync latency (ms): how long the group-commit window "
    "plus the fsync itself held each durable write — the durability tax "
    "every ACKed enqueue pays under --wal-dir",
    buckets=(0.1, 0.5, 1, 2, 5, 10, 20, 50, 100, 250, 1000))
RECOVERED_STREAMS_TOTAL = REGISTRY.counter(
    "ollamamq_recovered_streams_total",
    "WAL'd requests handled by the cold-restart recovery pass, by "
    "outcome: 'replayed' (re-admitted token-exact with generated_ids "
    "pre-filled), 'finished' (budget already spent — only the terminal "
    "was surfaced), 'failed' (re-admission errored; the stream ends "
    "with an explicit error, never a silent drop)",
    labels=("outcome",))

# -- engine performance plane (telemetry/stepprof.py) ----------------------
# Closed site vocabulary for ollamamq_compile_total{site}: one per jit
# cache the engine fills (the compile ladder's rungs live in these).
COMPILE_SITES = ("ragged", "prefill", "chunk", "sp_prefill", "decode",
                 "embed")
STEP_PHASE_MS = REGISTRY.histogram(
    "ollamamq_step_phase_ms",
    "Engine dispatch self-profiling: milliseconds each step spent per "
    "phase (host_prep = python batch composition, dispatch = issuing "
    "the jit'd computation — XLA compile on a fresh cache key, "
    "collect = device wait + D2H materialization, detok = the host "
    "emit loop), by step mode (ragged / spec_verify / decode / embed "
    "/ fake) — the always-on stepprof ring's metric face",
    buckets=(0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
             25.0, 50.0, 100.0, 250.0, 1000.0),
    labels=("phase", "mode"))
COMPILE_TOTAL = REGISTRY.counter(
    "ollamamq_compile_total",
    "XLA compiles the engine paid, by jit-cache site (ragged / prefill "
    "/ chunk / sp_prefill / decode / embed) — exactly one per compile-"
    "ladder rung in steady state; a climbing rate past warmup is a "
    "ladder bug (compile_storm alert)", labels=("site",))
COMPILE_MS = REGISTRY.histogram(
    "ollamamq_compile_ms",
    "Wall milliseconds one XLA compile held the dispatch path (the "
    "first call of a fresh jit cache entry traces + compiles "
    "synchronously; that call's wall IS the compile cost the step paid)",
    buckets=(1, 5, 10, 25, 50, 100, 250, 500, 1000, 2500, 5000, 10000,
             30000, 60000, 120000))

# -- host / device ---------------------------------------------------------
HBM_USED_BYTES = REGISTRY.gauge(
    "ollamamq_hbm_used_bytes",
    "Per-chip HBM in use (chips without memory_stats are omitted, "
    "never reported as 0)", labels=("chip", "host"))
HBM_TOTAL_BYTES = REGISTRY.gauge(
    "ollamamq_hbm_total_bytes",
    "Per-chip HBM capacity", labels=("chip", "host"))
UPTIME_SECONDS = REGISTRY.gauge(
    "ollamamq_uptime_seconds", "Engine uptime")

_LATENCY_HISTOGRAMS = (TTFT_MS, TPOT_MS, STEP_LATENCY_MS, PREFILL_LATENCY_MS)


def configure_latency_buckets(bounds) -> None:
    """Apply the --metrics-buckets ladder to every latency histogram.
    Resets prior observations (boundaries don't translate); call at
    startup, before serving."""
    for h in _LATENCY_HISTOGRAMS:
        h.set_buckets(bounds)
