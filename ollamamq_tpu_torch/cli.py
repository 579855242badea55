"""Command-line entry point: serve one or several models over HTTP.

    python -m ollamamq_tpu_torch.cli --model llama3.2:1b --port 11434
    python -m ollamamq_tpu_torch.cli --model test-tiny --device cpu
    python -m ollamamq_tpu_torch.cli --models llama3.2:1b,nomic-embed-text \
        --checkpoints llama3.2:1b=/path/to/hf-dir
    python -m ollamamq_tpu_torch.cli --weights-dtype int8 --kv-dtype int8
    python -m ollamamq_tpu_torch.cli --prefix-cache --spec --spec-k 4
    python -m ollamamq_tpu_torch.cli --scheduler srpt --token-fairness \
        --max-queued 64 --max-queued-per-user 8 --slo-ttft-ms 500
    python -m ollamamq_tpu_torch.cli --wal-dir /var/lib/ollamamq/wal \
        --journal-file /var/log/ollamamq/journal.jsonl
    python -m ollamamq_tpu_torch.cli --fake-engine --model test-tiny
    python -m ollamamq_tpu_torch.cli --replicas 2 --placement affinity \
        --prefix-cache --replica-urls http://127.0.0.1:11500
    python -m ollamamq_tpu_torch.cli --replicas 3 \
        --tiers "interactive=r0;bulk=r1,r2"
    python -m ollamamq_tpu_torch.cli --replicas 1 --autoscale \
        --min-replicas 1 --max-replicas 2 --scale-cooldown-s 10
    python -m ollamamq_tpu_torch.cli --replicas 0 --replica-urls URL,URL \
        --ha --wal-dir /var/lib/ollamamq/primary
    python -m ollamamq_tpu_torch.cli --replicas 0 --replica-urls URL,URL \
        --standby-of http://primary:11434 --wal-dir /var/lib/ollamamq/standby

Runs on the CUDA device unless --device cpu is given, and refuses to
start when no CUDA device is found. Weights are seeded random (--seed)
unless --checkpoints names an HF safetensors directory for a model (its
tokenizer.json, when present, replaces the byte-level tokenizer). More
models load and unload at run time through /api/pull and /api/delete.
The admin TUI owns the terminal when stdout is a TTY (--no-tui: never);
quitting it ends the process. Without the TUI, SIGTERM or SIGINT stop
admission (later requests get 503), let in-flight streams finish for up
to --stop-grace-s, flush the journal and the WAL and exit 0; a second
signal exits at once, and unfinished streams stay in the WAL for the
next start. --fake-engine serves deterministic words without a model
(FAKE_TOKEN_LATENCY_S slows each token). --log-file writes JSON lines
(rotated at --log-rotate-mb); --fault-plan injects the faults of a
testing/faults.py plan, checked before any device work.

--replicas N (N > 1) and --replica-urls serve a fleet: a router over N
in-process engines (r0, r1, ...) and the HTTP engines at the URLs (h0,
h1, ...), with health-driven ejection, KV page migration on drain and
failover (recompute replay when a transfer cannot land), and the
/admin/fleet, /admin/drain and /admin/preempt routes. The router owns
the caps, the WAL and the journal spill; its members run without them.
--tiers splits the members into an interactive and a bulk tier
(/admin/tiers, /admin/retier/{replica}). Members serve at --tp, --pp
and --dp (a tier declaring @tpN starts its members at TP width N, and a
regroup rebuilds the member at its target tier's width): a member wider
than one rank leads a rank world of its own, whose ranks this process
starts and reaps (fleet/wide.py). On a host with cards, when any member
or tier is wider than one rank, every member holds cards of its own,
disjoint from the others' (a host short of them exits 2 naming the
missing cuda:k; a regroup toward a width whose cards are not free
aborts); otherwise every member runs on --device. --autoscale grows
and shrinks the fleet between --min-replicas and --max-replicas
(in-process members from the same factory; --fake-engine members as
`python -m ollamamq_tpu_torch.cli` subprocesses), and implies a fleet
even with --replicas 1.

--ha runs a fleet router as the HA primary: it replicates its WAL and
its decision journal over GET /admin/ha/sync, stamps every member call
with its epoch, and on SIGTERM hands the fleet to a caught-up standby
instead of draining. --standby-of URL runs a warm standby of that
primary over the same members: it tails the sync stream into replicas
in its own --wal-dir, sheds clients (503 + Retry-After), and after
--takeover-grace-s without a heartbeat promotes at a higher epoch that
fences the old primary out of the members. --replicas 0 with
--replica-urls is a router that builds no engine and touches no device.

--tp N (N > 1) serves one engine over N ranks on this host, one process
per device: this process is rank 0 (scheduler, HTTP front) on cuda:0 and
starts N - 1 worker processes, rank r on cuda:r (all on the CPU with
--device cpu), which replay its step plans (engine/spmd.py) with their
slice of the weights and KV pool, and are reaped when it exits, whatever
the cause. Ranks talk over gloo on the CPU and NCCL on CUDA. --spmd
spreads the ranks over hosts instead: every host runs the same command
with MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK (and LOCAL_RANK) set;
rank 0 serves, the others replay, and with no --tp every rank joins the
tensor axis. A tp that does not divide the model's heads, or a --tp
whose devices this host lacks, exits 2 before any device work.

--pp N (N > 1) splits the model's layers over N pipeline stages
(parallel/pipeline.py), one rank each, times --tp ranks per stage: the
ranks start as for --tp (one per device, cuda:0.. on this host, or all
on the CPU with --device cpu), stage 0 holds rank 0. The runtime serves
generate only, through the bucketed prefill, the chunked long-prompt
path and the pipelined decode, in --pp-microbatches GPipe microbatches
(default one per stage). A pp that does not divide a model's layers, pp
with a mixture-of-experts model and --kv-dtype int8 with pp exit 2.

--sp N (N > 1) cuts a long prompt's prefill over N sequence shards,
one rank each, times --tp ranks per shard: the ranks start as for --tp
(one per device, or all on the CPU with --device cpu), and a prompt
past the largest prefill bucket prefills in one forward with ring
attention over the shards (parallel/ring_attention.py); weights and the
KV pool are replicated over them, so every other step runs alike on
each. --kv-dtype int8 with sp and sp with pp exit 2.

--ep N (N > 1) cuts every mixture-of-experts layer's experts over N
expert shards, one rank each, times --tp ranks per shard: the ranks
start as for --tp, each holds E / N of every MoE layer's experts (and
its --tp slice of them) and everything else whole, routes every token
alike and sums its experts' partial output over the (expert, tensor)
plane. A dense model serves on the same ranks, replicated over them.
--ep < 1, an --ep that does not divide an MoE model's expert count, and
--pp with an MoE model exit 2. In a fleet every member starts at the
fleet's --tp / --pp / --sp / --ep (fleet/wide.py).

--dp N serves every generative model as N data-parallel replicas, each
with its own weights, KV pool and slots; a request goes to the
least-loaded replica. Alone, this one process holds the N replicas, on
cuda:0..cuda:N-1 (all on the CPU with --device cpu). With --tp, --pp,
--sp or --ep each replica is its own pp x sp x ep x tp group of ranks,
started as for --tp (N x pp x sp x ep x tp ranks, one per device;
replica r holds ranks r*pp*sp*ep*tp ..);
with --spmd the world in the env is cut the same way. A host with fewer
cards than the replicas need exits 2 naming the missing ones: no replica
falls back to another device or to the CPU.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys

from ollamamq_tpu_torch.config import (QUANT_DTYPES, EngineConfig,
                                       assign_tiers, get_model_config,
                                       validate_autoscale, validate_ha,
                                       validate_quant_config,
                                       validate_scheduler, validate_tiers)


def build_parser() -> argparse.ArgumentParser:
    d = EngineConfig()
    p = argparse.ArgumentParser(prog="ollamamq_tpu_torch.cli", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model", default="llama3.2:1b",
                   help="the model to serve when --models is not given")
    p.add_argument("--models", default=os.environ.get("MODELS", ""),
                   help="comma-separated models to load at start-up "
                        "(generative and embedding models); the first is "
                        "the engine's default. Empty: --model alone")
    p.add_argument("--checkpoints", default=os.environ.get("CHECKPOINTS", ""),
                   help="comma-separated name=path pairs: an HF safetensors "
                        "directory per model (scripts/orbax_to_safetensors.py "
                        "converts the JAX package's orbax checkpoints); the "
                        "others use seeded weights")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=11434)
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the plain attention on the CPU")
    p.add_argument("--dtype", default=d.dtype, choices=("bfloat16", "float32"))
    p.add_argument("--weights-dtype", default=d.weights_dtype, choices=QUANT_DTYPES,
                   help="'int8' quantizes the weights per channel at start-up "
                        "(f32 scales); norms and biases stay in --dtype")
    p.add_argument("--kv-dtype", default=d.kv_dtype, choices=QUANT_DTYPES,
                   help="'int8' stores KV pages as int8 with one f32 scale "
                        "per (slot, kv head): pages shrink by (hd+4)/(2*hd)")
    p.add_argument("--max-slots", type=int, default=d.max_slots)
    p.add_argument("--num-pages", type=int, default=d.num_pages)
    p.add_argument("--page-size", type=int, default=d.page_size)
    p.add_argument("--max-pages-per-seq", type=int, default=d.max_pages_per_seq)
    p.add_argument("--max-batch-tokens", type=int, default=d.max_batch_tokens)
    p.add_argument("--token-granule", type=int, default=d.token_granule)
    p.add_argument("--decode-steps", type=int, default=d.decode_steps_per_iter)
    p.add_argument("--spec", action="store_true", default=d.spec,
                   help="speculative decoding on the ragged path: n-gram "
                        "prompt-lookup drafts (up to --spec-k per greedy "
                        "decode slot) verified in one dispatch; rejected "
                        "drafts' pages roll back. Greedy streams stay "
                        "identical to --no-spec")
    p.add_argument("--no-spec", dest="spec", action="store_false",
                   help="disable speculative decoding (the default)")
    p.add_argument("--spec-k", type=int, default=d.spec_k,
                   help="max draft tokens per decode slot per dispatch")
    p.add_argument("--spec-min-accept", type=float, default=d.spec_min_accept,
                   help="a user whose draft accept rate falls below this "
                        "(after a warm-up sample) stops speculating; 0 "
                        "never throttles")
    p.add_argument("--prefix-cache", action="store_true", default=d.prefix_cache,
                   help="share finished prompts' full KV pages across "
                        "requests (page-granular radix tree); a hit "
                        "prefills only the uncached tail")
    p.add_argument("--prefix-cache-min-pages", type=int,
                   default=d.prefix_cache_min_pages,
                   help="minimum matched full pages before a cached "
                        "prefix is reused")
    p.add_argument("--no-preempt", dest="preempt", action="store_false",
                   default=d.preempt,
                   help="disable preemption with recompute: decode-time "
                        "pool exhaustion then ends the request with an "
                        "explicit kv_exhausted error")
    p.add_argument("--preempt-max", type=int, default=d.preempt_max,
                   help="preemptions allowed per request before it holds "
                        "its reservation and is never a victim again")
    p.add_argument("--scheduler", default=os.environ.get("SCHEDULER", "fcfs"),
                   help="scheduling policy: 'fcfs' (default; FIFO within fair "
                        "share), 'srpt' (shortest-predicted-remaining-first "
                        "off an online output-length predictor, with "
                        "anti-starvation aging) or 'edf' (earliest-deadline-"
                        "first; srpt order for deadline-less requests). "
                        "Policies reorder only within what fair share allows")
    p.add_argument("--token-fairness", action="store_true",
                   help="fair-share by served tokens instead of request count")
    p.add_argument("--max-queued", type=int, default=0,
                   help="global queued-request cap: past it, enqueues are "
                        "shed with 503 + Retry-After (derived from the "
                        "observed completion rate); 0 = unbounded")
    p.add_argument("--max-queued-per-user", type=int, default=0,
                   help="per-user queued-request cap: past it, that user's "
                        "enqueues are shed with 429 + Retry-After; 0 = "
                        "unbounded")
    p.add_argument("--slo-ttft-ms", type=float, default=0.0,
                   help="TTFT latency objective in ms (enqueue to first "
                        "token); 0 = no TTFT SLO. Multi-window burn-rate "
                        "alerts surface in /health, /metrics and the TUI")
    p.add_argument("--slo-tpot-ms", type=float, default=0.0,
                   help="per-token decode latency objective in ms; 0 = no "
                        "TPOT SLO")
    p.add_argument("--slo-target", type=float, default=0.99,
                   help="good-fraction target for both SLOs (0.99 = 1%% "
                        "error budget)")
    p.add_argument("--trace-ring", type=int, default=512,
                   help="finished request traces kept for /debug/trace "
                        "(Chrome trace-event export)")
    p.add_argument("--journal-ring", type=int, default=d.journal_ring,
                   help="decision-journal records kept for GET "
                        "/debug/journal (the engine flight recorder)")
    p.add_argument("--journal-file", default=os.environ.get(
                       "OLLAMAMQ_JOURNAL_FILE", ""),
                   help="spill every decision-journal record to this JSONL "
                        "file (analyze and replay offline with `python -m "
                        "ollamamq_tpu_torch.tools.journal`)")
    p.add_argument("--journal-rotate-mb", type=float, default=d.journal_rotate_mb,
                   help="rotate --journal-file at this size (MB); 0 never")
    p.add_argument("--journal-keep", type=int, default=d.journal_keep,
                   help="rotated --journal-file generations kept")
    p.add_argument("--journal-sample", type=float,
                   default=float(os.environ.get("JOURNAL_SAMPLE", 1.0)),
                   help="sampling rate in (0, 1] of the high-rate journal "
                        "kinds (batch/chunk/page_*); decision kinds are "
                        "always kept. 1.0 records everything")
    p.add_argument("--wal-dir", default=os.environ.get("WAL_DIR", ""),
                   help="write-ahead request log directory: every accepted "
                        "generation request is fsynced before the enqueue "
                        "returns, emitted tokens are logged behind it, and "
                        "a restart replays unfinished requests; clients "
                        "reattach with GET /api/stream/{req_id}?from=N. "
                        "Empty = no WAL")
    p.add_argument("--wal-fsync-ms", type=float,
                   default=float(os.environ.get("WAL_FSYNC_MS", d.wal_fsync_ms)),
                   help="WAL group-commit window in ms: an admission waits "
                        "at most this long for its fsync; a crash loses at "
                        "most this much token progress (regenerated on "
                        "recovery). 0 = fsync every admission inline")
    p.add_argument("--no-wal", action="store_true",
                   help="no WAL even when WAL_DIR is set in the environment")
    p.add_argument("--stop-grace-s", type=float,
                   default=float(os.environ.get("STOP_GRACE_S", 30.0)),
                   help="graceful-shutdown budget: on SIGTERM/SIGINT "
                        "admission stops, in-flight streams drain for up to "
                        "this long, the journal and WAL are flushed, and "
                        "the process exits 0")
    # The fleet router (fleet/router.py).
    p.add_argument("--replicas", type=int,
                   default=int(os.environ.get("REPLICAS", 1)),
                   help="in-process engine replicas behind the fleet router "
                        "(1 = one engine, no router): health-driven "
                        "ejection with backoff re-probe, mid-stream "
                        "migration or failover, POST /admin/drain/{replica} "
                        "rolling restarts")
    p.add_argument("--replica-urls", default=os.environ.get("REPLICA_URLS", ""),
                   help="comma-separated base URLs of engines speaking this "
                        "HTTP API, joined to the fleet as members h0, h1, "
                        "...; combines with --replicas local members")
    p.add_argument("--placement", choices=("affinity", "least_loaded"),
                   default=os.environ.get("PLACEMENT", d.placement),
                   help="'affinity' routes to the replica whose prefix-cache "
                        "radix tree holds the prompt's prefix, else "
                        "least-loaded; 'least_loaded' skips the probe")
    p.add_argument("--drain-timeout-s", type=float,
                   default=float(os.environ.get("DRAIN_TIMEOUT_S",
                                                d.drain_timeout_s)),
                   help="drain budget: a draining replica's streams that "
                        "neither migrated nor finished by then fail over")
    p.add_argument("--no-migrate", action="store_true",
                   default=os.environ.get("MIGRATE", "").lower()
                   in ("0", "false", "no"),
                   help="no KV page migration: failover and drain replay "
                        "prompt + emitted tokens instead of shipping KV "
                        "pages, and affinity misses ship no prefix")
    p.add_argument("--migrate-timeout-s", type=float,
                   default=float(os.environ.get("MIGRATE_TIMEOUT_S",
                                                d.migrate_timeout_s)),
                   help="a transfer (export, ship, import ack) past this "
                        "aborts and the stream replays by recompute")
    p.add_argument("--preemptible", default=os.environ.get("PREEMPTIBLE", ""),
                   help="comma-separated member names (r0, h1, ...) that "
                        "accept a termination notice (POST "
                        "/admin/preempt/{replica}): their streams migrate "
                        "off within the notice window, then they retire")
    p.add_argument("--router-overhead-budget-ms", type=float,
                   default=float(os.environ.get("ROUTER_OVERHEAD_BUDGET_MS",
                                                d.router_overhead_budget_ms)),
                   help="bound on the placement decision's windowed p99; "
                        "above it the router_overhead alert fires. 0 "
                        "disables the alert (the timers stay on)")
    p.add_argument("--no-federate-metrics", action="store_true",
                   default=os.environ.get("FEDERATE_METRICS", "").lower()
                   in ("0", "false", "no"),
                   help="the router's /metrics stops re-exporting the HTTP "
                        "members' series under a replica label")
    p.add_argument("--dp", type=int, default=d.dp, help="data-parallel axis size")
    p.add_argument("--tp", type=int, default=d.tp,
                   help="tensor-parallel width: ranks (processes, one per "
                        "device) one engine, or each fleet member, spreads "
                        "over")
    p.add_argument("--pp", type=int, default=d.pp,
                   help="pipeline-parallel stages (layers split across "
                        "chip groups; for models beyond one group's HBM)")
    p.add_argument("--sp", type=int, default=d.sp,
                   help="sequence-parallel shards: ranks a long prompt's "
                        "one-shot prefill is cut over (ring attention)")
    p.add_argument("--ep", type=int, default=d.ep,
                   help="expert-parallel axis size (MoE models)")
    p.add_argument("--pp-microbatches", type=int, default=0,
                   help="GPipe microbatches per pp dispatch (0 = one per "
                        "stage; sweep on hardware — prefill wants more, "
                        "weight-bound decode may want fewer)")
    p.add_argument("--spmd", action="store_true",
                   default=os.environ.get("SPMD", "").lower() in ("1", "true"),
                   help="multi-host tensor parallelism: rank 0 runs the "
                        "scheduler+HTTP and broadcasts step plans; the "
                        "other ranks replay them (MASTER_ADDR, MASTER_PORT, "
                        "WORLD_SIZE, RANK env)")
    p.add_argument("--tiers", default=os.environ.get("TIERS", ""),
                   help="SLO-aware replica tiers for the fleet router "
                        "(needs --replicas/--replica-urls): "
                        "'interactive=r0;bulk=r1,r2' maps members to "
                        "tiers by name (or tpN for every member at that "
                        "TP width; an @tpN suffix declares the width the "
                        "tier's members start at and a retiered member "
                        "restarts at). "
                        "VIP/boost users and deadlined requests place on "
                        "the interactive tier, everything else on bulk; "
                        "cross-tier placement only under journaled SLO "
                        "burn-rate overflow or an empty tier, and a "
                        "balancer retiers members (drain -> migrate -> "
                        "restart -> rejoin) as the class mix shifts")
    p.add_argument("--autoscale", action="store_true",
                   default=os.environ.get("AUTOSCALE", "").lower()
                   in ("1", "true", "yes"),
                   help="elastic fleet sizing: a per-tier control loop "
                        "watches sustained SLO burn + queue backlog and "
                        "scales the fleet one member at a time (scale-down "
                        "is always drain -> migrate -> retire). The bulk "
                        "tier may scale to zero: its queued work parks at "
                        "the router and wakes the tier. Implies a fleet "
                        "even with --replicas 1")
    p.add_argument("--min-replicas", type=int,
                   default=int(os.environ.get("MIN_REPLICAS", d.min_replicas)),
                   help="scale-down floor for the interactive tier (and "
                        "an untiered elastic fleet); the bulk tier's is 0")
    p.add_argument("--max-replicas", type=int,
                   default=int(os.environ.get("MAX_REPLICAS", d.max_replicas)),
                   help="fleet-wide scale-up ceiling")
    p.add_argument("--scale-cooldown-s", type=float,
                   default=float(os.environ.get("SCALE_COOLDOWN_S",
                                                d.scale_cooldown_s)),
                   help="anti-flap cooldown between scale events; pressure "
                        "must hold a third of it before a scale-up, "
                        "idleness all of it before a scale-down. Waking a "
                        "scaled-to-zero tier bypasses it")
    # Router HA (fleet/ha.py): a warm-standby router with epoch fencing.
    p.add_argument("--ha", action="store_true",
                   default=os.environ.get("HA", "").lower()
                   in ("1", "true", "yes"),
                   help="run this fleet router as the HA primary: expose "
                        "the replication stream (GET /admin/ha/sync: WAL "
                        "records, decision-journal events and the shadow "
                        "placement state) a --standby-of router tails, "
                        "stamp every member-facing call with the router "
                        "epoch, and on SIGTERM hand the fleet to the "
                        "caught-up standby instead of draining. Requires "
                        "--wal-dir and a fleet")
    p.add_argument("--standby-of", default=os.environ.get("STANDBY_OF", ""),
                   help="run as the warm standby of the primary router at "
                        "this base URL: tail its replication stream into "
                        "local WAL and journal replicas, shed clients with "
                        "503 + Retry-After meanwhile, and after "
                        "--takeover-grace-s of heartbeat loss promote: "
                        "bump the epoch (fencing the old primary if it "
                        "revives), re-register the members, replay every "
                        "unfinished stream through recovery, then serve. "
                        "Requires --wal-dir and --replica-urls naming the "
                        "same members the primary serves")
    p.add_argument("--takeover-grace-s", type=float,
                   default=float(os.environ.get("TAKEOVER_GRACE_S", 3.0)),
                   help="standby heartbeat-loss grace before promotion; "
                        "sync polls run at grace/4 (floored at 50ms)")
    p.add_argument("--fake-engine", action="store_true",
                   help="serve deterministic fake tokens (no model, no "
                        "device; for tests)")
    p.add_argument("--max-new-tokens", type=int, default=d.max_new_tokens)
    p.add_argument("--seed", type=int, default=d.seed)
    p.add_argument("--blocklist", default="blocked_items.json",
                   help="blocklist persistence path")
    p.add_argument("--no-tui", action="store_true", help="disable the admin TUI")
    p.add_argument("--allow-all-routes", action="store_true",
                   help="answer unhandled paths with 501 (there is no "
                        "backend to proxy them to) instead of 404")
    p.add_argument("--timeout", "--timeout-s", dest="timeout", type=float,
                   default=float(os.environ.get("TIMEOUT", 300)),
                   help="per-request timeout in seconds (default 300)")
    p.add_argument("--fault-plan", default="",
                   help="deterministic fault-injection plan (a JSON file; "
                        "see ollamamq_tpu_torch/testing/faults.py) wired "
                        "into the dispatch and allocation seams; a "
                        "malformed plan fails start-up")
    p.add_argument("--metrics-buckets", default="",
                   help="comma-separated upper bounds (ms) of the latency "
                        "histograms on /metrics (ttft/tpot/step/prefill); "
                        "default is a 1 ms..30 s ladder")
    p.add_argument("--log-file", default=os.environ.get("OLLAMAMQ_LOG_FILE", ""),
                   help="write logs to this file as JSON lines (one object "
                        "per line; request-scoped lines carry req_id). "
                        "Default: ollamamq.log when the TUI owns the "
                        "terminal, stdout otherwise")
    p.add_argument("--log-rotate-mb", type=float, default=64.0,
                   help="rotate --log-file at this size (MB); 0 never")
    p.add_argument("--log-keep", type=int, default=3,
                   help="rotated --log-file generations kept")
    p.add_argument("--log-level", default="INFO")
    return p


class JsonLineFormatter(logging.Formatter):
    """Structured log lines: one JSON object per line. Request-scoped
    records (logged with extra={"req_id": N}) carry the id, so a log line
    correlates directly with GET /debug/requests/{id}."""

    def format(self, record: logging.LogRecord) -> str:
        out = {
            "ts": self.formatTime(record, "%Y-%m-%dT%H:%M:%S")
            + f".{int(record.msecs):03d}Z",
            "level": record.levelname,
            "logger": record.name,
            "msg": record.getMessage(),
        }
        rid = getattr(record, "req_id", None)
        if rid is not None:
            out["req_id"] = rid
        if record.exc_info:
            out["exc"] = self.formatException(record.exc_info)
        return json.dumps(out, ensure_ascii=False)


def setup_logging(use_tui: bool, log_file: str = "", rotate_mb: float = 64.0,
                  keep: int = 3, level: str = "INFO") -> None:
    """JSON lines to `log_file` (rotated at `rotate_mb`, `keep`
    generations), or to ollamamq.log when the TUI owns the terminal and
    no file was named; human-readable stdout otherwise."""
    if not log_file and use_tui:
        log_file = "ollamamq.log"
    if log_file:
        if rotate_mb and rotate_mb > 0:
            from logging.handlers import RotatingFileHandler

            handler: logging.Handler = RotatingFileHandler(
                log_file, maxBytes=int(rotate_mb * 1e6),
                backupCount=max(1, keep))
        else:
            handler = logging.FileHandler(log_file)
        handler.setFormatter(JsonLineFormatter())
    else:
        handler = logging.StreamHandler(sys.stdout)
        handler.setFormatter(logging.Formatter(
            "%(asctime)s %(levelname)s %(name)s: %(message)s"))
    logging.basicConfig(level=getattr(logging, level.upper(), logging.INFO),
                        handlers=[handler])


def latency_buckets(spec: str) -> tuple:
    """The --metrics-buckets bounds; ValueError for a malformed list."""
    try:
        bounds = tuple(float(b) for b in spec.split(",") if b.strip())
    except ValueError:
        raise ValueError(f"invalid --metrics-buckets {spec!r} (want "
                         "comma-separated numbers)")
    if not bounds:
        raise ValueError("--metrics-buckets must name at least one bound")
    return bounds


def fleet_roster(args) -> list:
    """(name, TP width) of the fleet's starting members: r0.. in process
    at --tp, then h0.. at the --replica-urls (width unknown)."""
    return ([(f"r{i}", args.tp) for i in range(max(0, args.replicas))]
            + [(f"h{j}", None) for j in range(len(replica_urls(args)))])


def is_fleet(args) -> bool:
    return args.replicas > 1 or bool(replica_urls(args)) or args.autoscale


def model_table(args) -> dict:
    """{model: checkpoint directory or None} of --models / --checkpoints
    (--model alone when --models is empty)."""
    names = [m.strip() for m in args.models.split(",") if m.strip()] or [args.model]
    checkpoints = {}
    for pair in args.checkpoints.split(","):
        if "=" in pair:
            name, path = pair.split("=", 1)
            checkpoints[name.strip()] = path.strip()
    return {name: checkpoints.get(name) for name in names}


def validate(args, cards=None) -> str:
    """The flags' errors, checked before any device work ("" = valid).
    `cards`: a fleet's explicit card plan (fleet/wide.py CardPlan), whose
    slots stand for the host's cards."""
    for name in model_table(args):
        if get_model_config(name) is None:
            return f"unknown model architecture: {name}"
    err = (validate_quant_config(args.weights_dtype, args.kv_dtype,
                                 pp=args.pp, sp=args.sp,
                                 model_names=list(model_table(args)))
           or validate_scheduler(args.scheduler))
    if err:
        return err
    if not 0.0 < args.slo_target < 1.0:
        return f"--slo-target must be in (0, 1), got {args.slo_target}"
    if args.max_queued < 0 or args.max_queued_per_user < 0 or args.preempt_max < 0:
        return "--max-queued / --max-queued-per-user / --preempt-max must be >= 0"
    if args.trace_ring < 1:
        return "--trace-ring must be >= 1"
    if args.journal_ring < 1 or args.journal_keep < 1 or args.log_keep < 1:
        return "--journal-ring / --journal-keep / --log-keep must be >= 1"
    if args.journal_rotate_mb < 0 or args.log_rotate_mb < 0:
        return ("--journal-rotate-mb / --log-rotate-mb must be >= 0 "
                "(0 disables rotation)")
    if not 0.0 < args.journal_sample <= 1.0:
        return f"--journal-sample must be in (0, 1], got {args.journal_sample}"
    if args.wal_fsync_ms < 0 or args.stop_grace_s < 0:
        return "--wal-fsync-ms / --stop-grace-s must be >= 0"
    err = validate_ha(args.ha, args.standby_of or None, args.takeover_grace_s,
                      None if args.no_wal else (args.wal_dir or None),
                      args.replica_urls or None)
    if err:
        return err
    if args.ha and not is_fleet(args):
        return ("--ha needs a fleet (--replicas > 1, --replica-urls, or "
                "--autoscale): the standby re-registers those members at "
                "takeover")
    urls = replica_urls(args)
    if args.spmd and args.fake_engine:
        return "--spmd and --fake-engine are mutually exclusive"
    if args.spmd and (args.replicas > 1 or urls or args.autoscale):
        return ("--replicas/--replica-urls/--autoscale and --spmd are "
                "mutually exclusive (the SPMD engine already owns its worker "
                "ranks; run the fleet router over separate SPMD services via "
                "--replica-urls from a non-SPMD front-end instead)")
    if args.dp < 1:
        return f"--dp must be >= 1, got {args.dp}"
    if args.tp != 1 or args.pp != 1 or args.sp != 1 or args.ep != 1 \
            or args.spmd:
        err = validate_tp(args)
        if err:
            return err
    elif args.dp > 1 and not args.fake_engine:
        err = validate_devices(args)
        if err:
            return err
    if args.replicas < 0 or (args.replicas == 0 and not urls):
        return "--replicas must be >= 1 (0 only with --replica-urls)"
    if args.drain_timeout_s <= 0:
        return "--drain-timeout-s must be > 0"
    if args.migrate_timeout_s <= 0:
        return "--migrate-timeout-s must be > 0"
    if args.router_overhead_budget_ms < 0:
        return ("--router-overhead-budget-ms must be >= 0 "
                "(0 disables the alert)")
    if args.autoscale:
        err = validate_autoscale(args.min_replicas, args.max_replicas,
                                 args.scale_cooldown_s,
                                 replicas=args.replicas + len(urls))
        if err:
            return err
    roster = [name for name, _ in fleet_roster(args)]
    if args.preemptible:
        if not is_fleet(args):
            return ("--preemptible needs a fleet (--replicas > 1, "
                    "--replica-urls or --autoscale)")
        unknown = sorted({s.strip() for s in args.preemptible.split(",")
                          if s.strip()} - set(roster))
        if unknown:
            return (f"--preemptible names unknown members: "
                    f"{', '.join(unknown)} (fleet: {', '.join(roster)})")
    if args.tiers:
        if args.replicas <= 1 and not urls:
            return "--tiers needs a fleet (--replicas > 1 and/or --replica-urls)"
        err = validate_tiers(args.tiers, fleet_roster(args))
        if err:
            return f"invalid --tiers: {err}"
        for tier, width in sorted(tier_widths(args).items()):
            err = validate_width(args, width or 1, args.pp, args.ep)
            if err:
                return f"invalid --tiers: tier {tier!r} @tp{width}: {err}"
    if is_fleet(args):
        err = validate_fleet_cards(args, cards)
        if err:
            return err
    if args.metrics_buckets:
        try:
            latency_buckets(args.metrics_buckets)
        except ValueError as e:
            return str(e)
    if args.fault_plan:
        from ollamamq_tpu_torch.testing.faults import FaultPlan, FaultPlanError

        try:
            FaultPlan.load(args.fault_plan)
        except FaultPlanError as e:
            return f"invalid --fault-plan: {e}"
    return ""


def validate_tp(args) -> str:
    """--tp / --pp / --sp / --ep / --spmd errors that need no device
    work: the widths against every model's heads, layers and experts,
    and the devices of a local world (pp x sp x ep x tp ranks) on this
    host."""
    from ollamamq_tpu_torch.parallel.distributed import multiprocess_configured

    if args.spmd and not os.environ.get("OLLAMAMQ_TP_WORKER") \
            and not multiprocess_configured():
        return ("--spmd needs the world in the env: MASTER_ADDR, "
                "MASTER_PORT, WORLD_SIZE and RANK")
    if args.tp < 1 and not (args.spmd and args.tp == -1):
        return f"--tp must be >= 1, got {args.tp}"
    if args.pp < 1:
        return f"--pp must be >= 1, got {args.pp}"
    if args.pp_microbatches < 0:
        return f"--pp-microbatches must be >= 0, got {args.pp_microbatches}"
    if args.sp < 1:
        return f"--sp must be >= 1, got {args.sp}"
    if args.ep < 1:
        return f"--ep must be >= 1, got {args.ep}"
    if args.fake_engine:
        return ("--tp / --pp / --sp / --ep need a model engine; "
                "--fake-engine runs none")
    if args.sp > 1 and args.pp > 1:
        return ("pp and sp cannot combine on one runtime: pipeline stages "
                "and sequence shards contend for the same activation layout "
                "(use pp x tp, or sp x tp)")
    err = validate_width(args, args.tp, args.pp, args.ep)
    if err or is_fleet(args):  # a fleet's cards: validate_fleet_cards
        return err
    return validate_devices(args)


def validate_width(args, tp: int, pp: int, ep: int = 1) -> str:
    """tp, pp and ep against every model's heads, layers and experts (a
    dense model is replicated over the expert axis)."""
    from ollamamq_tpu_torch.parallel.mesh import validate_tp_for_model

    for name in model_table(args):
        cfg = get_model_config(name)
        if pp > 1:
            if cfg.num_layers % pp:
                return f"pp={pp} must divide num_layers={cfg.num_layers} ({name})"
            if cfg.num_experts:
                return ("pp with an MoE model is not supported: the pipeline "
                        f"stage body runs the dense FFN ({name})")
        if ep > 1 and cfg.num_experts and cfg.num_experts % ep:
            return (f"ep={ep} must divide num_experts={cfg.num_experts} "
                    f"({name})")
        if tp > 1:
            try:
                validate_tp_for_model(tp, cfg.num_kv_heads, cfg.num_heads)
            except ValueError as e:
                return f"--tp {tp} for {name}: {e}"
    return ""


def tier_widths(args) -> dict:
    """{tier: declared TP width} of --tiers (None: the member's own)."""
    if not args.tiers:
        return {}
    return assign_tiers(args.tiers, fleet_roster(args))[1]


def member_widths(args) -> dict:
    """{member: TP width it starts at} of the in-process members: its
    tier's declared width, else --tp."""
    assignment, widths = (assign_tiers(args.tiers, fleet_roster(args))
                          if args.tiers else ({}, {}))
    return {f"r{i}": widths.get(assignment.get(f"r{i}")) or args.tp
            for i in range(max(0, args.replicas))}


def fleet_has_wide(args) -> bool:
    """A member, a tier or the autoscaler's members wider than one rank
    (the card plan then gives every member cards of its own)."""
    widths = list(member_widths(args).values()) + [
        w for w in tier_widths(args).values() if w]
    return args.pp > 1 or args.sp > 1 or args.ep > 1 or any(
        max(1, w) > 1 for w in widths + [args.tp])


def validate_fleet_cards(args, cards=None) -> str:
    """The cards the fleet's starting members need of their own, planned
    as build_fleet hands them out: on `cards` (fleet/wide.py CardPlan),
    else card_plan(args). Nothing to check for a plan that counts no
    cards (the CPU, or no member or tier wider than one rank: every
    member runs on --device)."""
    from ollamamq_tpu_torch.fleet.wide import CardPlan

    plan = cards if cards is not None else card_plan(args)
    if not plan.accounted:
        return ""
    trial = CardPlan(plan.cards, backend=plan.backend)
    for name, width in member_widths(args).items():
        try:
            trial.take_member(name, argparse.Namespace(
                dp=args.dp, tp=width, pp=args.pp, sp=args.sp, ep=args.ep))
        except RuntimeError as e:
            return str(e)
    return ""


def validate_devices(args) -> str:
    """The cards this host must have: one per rank of a local --tp / --pp
    / --sp / --ep world (--dp x --pp x --sp x --ep x --tp ranks), or one
    per replica of --dp alone
    (in-process replicas on cuda:0..). None is missing on the CPU or
    under --spmd (each host brings its own)."""
    world = local_world(args)
    need = world if world > 1 else args.dp
    if need == 1 or args.spmd or args.device == "cpu":
        return ""
    import torch

    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have >= need:
        return ""
    flags = " ".join(f"{f} {n}" for f, n in (("--dp", args.dp), ("--tp", args.tp),
                                            ("--pp", args.pp), ("--sp", args.sp),
                                            ("--ep", args.ep))
                     if n != 1)
    unit = "rank" if world > 1 else "replica"
    missing = ", ".join(f"cuda:{i}" for i in range(have, need))
    return (f"{flags} runs one {unit} per device, cuda:0..cuda:{need - 1}, "
            f"but {missing} is missing (this host has {have} CUDA "
            f"device(s)); no {unit} falls back to another device")


def local_world(args) -> int:
    """Ranks of a one-host --tp / --pp / --sp / --ep world: tp per stage
    times pp times sp times ep, times --dp replicas of that group (1: no
    rank world; --dp alone runs its replicas in this process)."""
    group = max(1, args.tp) * args.pp * args.sp * args.ep
    return args.dp * group if group > 1 else 1


def replica_urls(args) -> list:
    return [u.strip() for u in args.replica_urls.split(",") if u.strip()]


def engine_config(args) -> EngineConfig:
    return EngineConfig(
        model=next(iter(model_table(args))), max_slots=args.max_slots,
        num_pages=args.num_pages,
        page_size=args.page_size, max_pages_per_seq=args.max_pages_per_seq,
        max_batch_tokens=args.max_batch_tokens, token_granule=args.token_granule,
        decode_steps_per_iter=args.decode_steps, spec=args.spec,
        spec_k=args.spec_k, spec_min_accept=args.spec_min_accept,
        prefix_cache=args.prefix_cache,
        prefix_cache_min_pages=args.prefix_cache_min_pages,
        preempt=args.preempt, preempt_max=args.preempt_max,
        max_new_tokens=args.max_new_tokens, dtype=args.dtype,
        weights_dtype=args.weights_dtype, kv_dtype=args.kv_dtype, seed=args.seed,
        scheduler=args.scheduler, max_queued=args.max_queued,
        max_queued_per_user=args.max_queued_per_user,
        slo_ttft_ms=args.slo_ttft_ms or None, slo_tpot_ms=args.slo_tpot_ms or None,
        slo_target=args.slo_target, trace_ring=args.trace_ring,
        journal_ring=args.journal_ring, journal_file=args.journal_file or None,
        journal_rotate_mb=args.journal_rotate_mb, journal_keep=args.journal_keep,
        journal_sample=args.journal_sample,
        wal_dir=None if args.no_wal else (args.wal_dir or None),
        wal_fsync_ms=args.wal_fsync_ms, ha=args.ha,
        standby_of=args.standby_of or None,
        takeover_grace_s=args.takeover_grace_s, replicas=args.replicas,
        placement=args.placement, drain_timeout_s=args.drain_timeout_s,
        migrate=not args.no_migrate, migrate_timeout_s=args.migrate_timeout_s,
        router_overhead_budget_ms=args.router_overhead_budget_ms,
        federate_metrics=not args.no_federate_metrics,
        preemptible=args.preemptible or None, tp=args.tp, pp=args.pp,
        dp=args.dp, sp=args.sp, ep=args.ep,
        pp_microbatches=args.pp_microbatches or None,
        tiers=args.tiers or None, autoscale=args.autoscale,
        min_replicas=args.min_replicas, max_replicas=args.max_replicas,
        scale_cooldown_s=args.scale_cooldown_s,
        fault_plan=args.fault_plan or None)


def _fake_latency() -> float:
    """Per-token delay of --fake-engine (env FAKE_TOKEN_LATENCY_S): crash
    and drain tests need streams that stay in flight."""
    try:
        return max(0.0, float(os.environ.get("FAKE_TOKEN_LATENCY_S", 0.0)))
    except ValueError:
        return 0.0


def install_graceful_shutdown(engine, grace_s: float) -> None:
    """SIGTERM/SIGINT: stop admission (later enqueues shed with 503), let
    in-flight streams drain for up to `grace_s`, flush and fsync the
    journal and the WAL (engine.stop), exit 0. A second signal exits at
    once. Streams still running past the grace stay in the WAL and are
    recovered on the next start."""
    import signal
    import threading
    import time

    log = logging.getLogger("ollamamq.torch")
    fired = threading.Event()

    def run(signum: int) -> None:
        # HA primary: hand the fleet to the caught-up standby (it
        # promotes with why="handover") instead of draining the world.
        # ha_handover quiesces first either way and returns only once
        # the standby's confirm reply is on its socket; False (no
        # standby, or it never confirmed) falls through to the drain.
        handover = getattr(engine, "ha_handover", None)
        if handover is not None:
            try:
                if handover(timeout_s=min(10.0, max(1.0, grace_s))):
                    log.warning("signal %d: fleet handed over to the "
                                "standby; exiting 0", signum)
                    engine.stop()
                    os._exit(0)
            except Exception:  # noqa: BLE001
                log.exception("HA handover failed; draining instead")
        # An unpromoted standby stops tailing before it stops: it must
        # not promote while this process shuts down.
        standby_stop = getattr(getattr(engine, "ha", None), "stop", None)
        if standby_stop is not None:
            standby_stop()
        log.warning("signal %d: graceful shutdown; admission stopped, "
                    "draining in-flight work (grace %.0fs)", signum, grace_s)
        engine.quiesce()
        deadline = time.monotonic() + grace_s
        while time.monotonic() < deadline and engine.inflight_count():
            time.sleep(0.1)
        # The engine finishing a stream and the handler thread writing
        # its last frames are asynchronous: let the sockets drain.
        time.sleep(min(1.0, max(0.0, deadline - time.monotonic())))
        left = engine.inflight_count()
        if left:
            log.warning("grace expired with %d request(s) in flight; they "
                        "stay in the WAL and recover on the next start", left)
        engine.stop()  # joins the loop, fsyncs the journal and the WAL
        from ollamamq_tpu_torch.ops.cuda import launch_counts

        # The process's whole count of kernel launches, drain included
        # (/health's kernel_launches can no longer be read after this).
        log.warning("graceful shutdown complete; kernel launches %s; "
                    "exiting 0", json.dumps(launch_counts(), sort_keys=True))
        os._exit(0)

    def handler(signum, frame):  # noqa: ARG001
        if fired.is_set():
            os._exit(0)  # a second signal: now
        fired.set()
        threading.Thread(target=run, args=(signum,), daemon=True,
                         name="graceful-shutdown").start()

    signal.signal(signal.SIGTERM, handler)
    signal.signal(signal.SIGINT, handler)


def start_ranks(args, argv, log):
    """Bring up the rank world of --tp / --pp / --sp / --ep / --spmd.
    Returns (mesh, worker processes this process started). --tp N --pp P
    --sp Q --ep X on one host (N x P x Q x X ranks): this process is rank
    0 and starts the others as
    `python -m ollamamq_tpu_torch.cli`
    with the same flags (env OLLAMAMQ_TP_WORKER=1, RANK, WORLD_SIZE,
    MASTER_ADDR/PORT of the store this process hosts), each dying with
    it. --spmd, or a started worker: the env describes the world."""
    import subprocess

    from ollamamq_tpu_torch.parallel import distributed
    from ollamamq_tpu_torch.parallel.mesh import make_mesh

    cpu = args.device == "cpu"
    procs = []
    if args.spmd or os.environ.get("OLLAMAMQ_TP_WORKER"):
        world = int(os.environ.get("WORLD_SIZE", "1"))
        distributed.initialize(devices=["cpu"] * world if cpu else None)
        tp = args.tp if args.tp not in (1, -1) or not args.spmd else -1
        return make_mesh(dp=args.dp, tp=tp, pp=args.pp, sp=args.sp,
                         ep=args.ep), procs

    world = local_world(args)

    def spawn(port: int) -> None:
        for r in range(1, world):
            env = dict(os.environ, RANK=str(r), LOCAL_RANK=str(r),
                       WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1",
                       MASTER_PORT=str(port), OLLAMAMQ_TP_WORKER="1")
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "ollamamq_tpu_torch.cli", *argv],
                env=env, preexec_fn=distributed.die_with_parent))
        log.info("started %d worker rank(s): pids %s", len(procs),
                 [p.pid for p in procs])

    devices = (["cpu"] * world if cpu
               else [f"cuda:{r}" for r in range(world)])
    try:
        distributed.initialize("127.0.0.1:0", world, 0, devices=devices,
                               on_store=spawn)
        return make_mesh(dp=args.dp, tp=max(1, args.tp), pp=args.pp,
                         sp=args.sp, ep=args.ep, devices=devices), procs
    except BaseException:
        for p in procs:
            p.kill()
        distributed.reap(procs)
        raise


def card_plan(args):
    """The fleet's card plan (fleet/wide.py CardPlan): the host's cards,
    one member each, when a member or tier is wider than one rank on
    cards; else every member on --device (the CPU, or a fleet of
    one-rank members sharing its card)."""
    from ollamamq_tpu_torch.fleet.wide import CardPlan

    if args.device == "cpu" or args.fake_engine or not fleet_has_wide(args):
        return CardPlan(device=args.device)
    import torch

    return CardPlan([f"cuda:{i}" for i in range(torch.cuda.device_count())])


def build_fleet(args, ecfg: EngineConfig, engine_factory, fairness=None,
                cards=None):
    """The FleetRouter that `main` serves for --replicas N > 1,
    --replica-urls or --autoscale: in-process members r0..r{N-1}, each
    built by its own fleet/wide.py MemberFactory, which the drain's hot
    restart, a tier regroup and the autoscaler's LocalProvisioner call
    again, then HTTP members h0, h1, ... at the URLs. A member starts at
    its tier's declared @tpN width, else at --tp; wider than one rank it
    is an SPMDEngine leading a rank world of its own, else
    `engine_factory(member_cfg)` (with `device=` its own card when
    `cards`, the CardPlan, counts cards; default card_plan(args)).
    Members serve uncapped what the router placed (the router owns the
    caps), keep no blocklist (the router blocks at ingress) and leave
    the journal spill, the WAL and the policy layers to the router (a
    member WAL would record and recover every stream twice). Under
    --autoscale with --fake-engine, scale-ups spawn `python -m
    ollamamq_tpu_torch.cli --fake-engine` subprocesses joined as HTTP
    members instead."""
    import dataclasses

    from ollamamq_tpu_torch.core.mqcore import Fairness
    from ollamamq_tpu_torch.fleet import FleetRouter, HttpMember, LocalMember
    from ollamamq_tpu_torch.fleet.wide import MemberFactory

    fairness = fairness or Fairness.REQUESTS
    plan = cards if cards is not None else card_plan(args)
    member_cfg = dataclasses.replace(
        ecfg, max_queued=0, max_queued_per_user=0, journal_file=None,
        wal_dir=None, tiers=None, autoscale=False, ha=False,
        standby_of=None)

    def member_factory(name: str) -> MemberFactory:
        return MemberFactory(name, member_cfg, plan, engine_factory,
                             model_table(args), fairness,
                             worlds=not args.fake_engine)

    members = []
    try:
        for name, width in member_widths(args).items():
            factory = member_factory(name)
            members.append(LocalMember(name, factory(width),
                                       engine_factory=factory))
    except BaseException:
        for m in members:  # a fleet that cannot start reaps what it began
            m.stop()
        raise
    members += [HttpMember(f"h{j}", url, timeout_s=args.timeout)
                for j, url in enumerate(replica_urls(args))]
    provisioner = None
    if args.autoscale:
        from ollamamq_tpu_torch.fleet.autoscaler import (LocalProvisioner,
                                                         SubprocessProvisioner)

        if args.fake_engine:
            # The member config rides as argv; the router-owned caps, WAL
            # and journal spill stay off member-side.
            provisioner = SubprocessProvisioner([
                "--fake-engine", "--models", ",".join(model_table(args)),
                "--scheduler", args.scheduler,
                "--max-slots", str(args.max_slots),
                "--max-new-tokens", str(args.max_new_tokens)])
        else:
            provisioner = LocalProvisioner(member_factory, release=plan.release)
    # A standby's router attaches no primary-side coordinator at
    # construction: it becomes one only at promotion.
    router = FleetRouter(
        members, dataclasses.replace(ecfg, ha=False) if args.standby_of else ecfg,
        blocklist_path=args.blocklist, fairness=fairness,
        placement=args.placement, drain_timeout_s=args.drain_timeout_s,
        provisioner=provisioner)
    if args.standby_of:
        from ollamamq_tpu_torch.fleet.ha import HAStandby

        router.ha = HAStandby(router, args.standby_of)
        router.accepting = False  # shed until promotion opens the gate
    return router


def main(argv=None) -> int:
    # An unknown --weights-dtype / --kv-dtype fails in argparse, and the
    # other invalid values in validate(), before any device work.
    argv = list(sys.argv[1:] if argv is None else argv)
    args = build_parser().parse_args(argv)
    use_tui = not args.no_tui and sys.stdout.isatty()
    setup_logging(use_tui, args.log_file, args.log_rotate_mb, args.log_keep,
                  args.log_level)
    log = logging.getLogger("ollamamq.torch")
    err = validate(args)
    if err:
        log.error("%s", err)
        return 2
    if args.metrics_buckets:
        from ollamamq_tpu_torch.telemetry import schema as tm

        tm.configure_latency_buckets(latency_buckets(args.metrics_buckets))
    import threading

    from ollamamq_tpu_torch.core.mqcore import Fairness
    from ollamamq_tpu_torch.engine.engine import TorchEngine
    from ollamamq_tpu_torch.server.app import OllamaServer

    fairness = Fairness.TOKENS if args.token_fairness else Fairness.REQUESTS
    ecfg = engine_config(args)
    workers = []
    # A fleet's members lead their own rank worlds (build_fleet); this
    # process is a rank of a world only as one engine.
    if not is_fleet(args) and (args.tp != 1 or args.pp != 1 or args.sp != 1
                               or args.ep != 1 or args.spmd):
        from ollamamq_tpu_torch.engine import spmd
        from ollamamq_tpu_torch.parallel import distributed

        mesh, workers = start_ranks(args, argv, log)
        if not distributed.is_primary():
            # Worker rank: replay rank 0's step plans until shutdown.
            log.info("%s worker rank %d starting for %s",
                     "pipeline-parallel" if args.pp > 1 else
                     "sequence-parallel" if args.sp > 1 else
                     "expert-parallel" if args.ep > 1 else "tensor-parallel",
                     distributed.rank(), ",".join(model_table(args)))
            spmd.run_worker(model_table(args), ecfg, mesh)
            distributed.exit_process(0)  # past torch's teardown of the groups

    def build_engine(cfg, blocklist, device=None):
        if args.fake_engine:
            from ollamamq_tpu_torch.engine.fake import FakeEngine

            return FakeEngine(cfg, models=model_table(args),
                              blocklist_path=blocklist, fairness=fairness,
                              token_latency_s=_fake_latency())
        if workers or args.spmd:
            eng = spmd.SPMDEngine(cfg, mesh=mesh, blocklist_path=blocklist,
                                  fairness=fairness, models=model_table(args))
            eng.worker_procs = workers
            return eng
        return TorchEngine(cfg, device=device or args.device,
                           blocklist_path=blocklist, fairness=fairness,
                           models=model_table(args))

    try:
        if is_fleet(args):
            engine = build_fleet(
                args, ecfg,
                lambda cfg, device=None: build_engine(cfg, None, device),
                fairness)
        else:
            engine = build_engine(ecfg, args.blocklist)
    except BaseException:
        from ollamamq_tpu_torch.parallel import distributed

        for p in workers:  # a leader that cannot serve takes its ranks down
            p.kill()
        distributed.reap(workers)
        raise
    if args.standby_of:
        # The standby's router stays unstarted until promotion (no member
        # probes, no placements, just the replication tail); clients shed
        # with 503 + Retry-After meanwhile.
        engine.ha.start()
        log.warning("warm standby: tailing primary %s (takeover grace "
                    "%.1fs)", args.standby_of, args.takeover_grace_s)
    else:
        engine.start()  # a WAL's recovery pass runs here, before serving
    server = OllamaServer(engine, args.host, args.port, args.timeout,
                          args.allow_all_routes)
    log.info("serving %s on %s:%d (device %s, tui=%s)",
             ",".join(engine.loaded_models()), args.host,
             server.server_address[1], engine.device, use_tui)
    try:
        if use_tui:
            from ollamamq_tpu_torch.admin.tui import run_tui

            # The server on a background thread; the TUI owns the terminal
            # and quitting it ends the process.
            threading.Thread(target=server.serve_forever, name="http",
                             daemon=True).start()
            run_tui(engine, None)
            server.shutdown()
        else:
            install_graceful_shutdown(engine, args.stop_grace_s)
            server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        engine.quiesce()
        server.server_close()
        engine.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
