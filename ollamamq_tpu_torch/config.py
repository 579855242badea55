"""Model and engine configuration for the PyTorch/CUDA serving path.

The dense decoder architectures (Llama 3.x, Qwen2.5 with attention bias,
Qwen3 with per-head q/k norm), a bidirectional encoder for embedding
models (nomic-embed-text class), and the engine fields the single-device
serving path reads, with the JAX package's defaults, and the
mixture-of-experts family (Mixtral: routed SwiGLU experts, models/moe.py)
on one device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Decoder-only transformer architecture description (Llama/Qwen family)."""

    name: str
    vocab_size: int
    hidden_size: int
    intermediate_size: int
    num_layers: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    rope_theta: float = 500_000.0
    rms_norm_eps: float = 1e-5
    max_seq_len: int = 8192
    tie_embeddings: bool = False
    # Qwen2-style attention projections carry a bias term; Llama's do not.
    attn_bias: bool = False
    # Qwen3-style per-head RMSNorm on q and k after projection (pre-RoPE).
    qk_norm: bool = False
    # Bidirectional attention + mean pooling => embedding encoder, not a LM.
    is_encoder: bool = False
    # Mixture-of-experts (Mixtral family): 0 = dense FFN. When > 0, each
    # layer's FFN becomes num_experts independent SwiGLU experts with
    # top-(num_experts_per_tok) routing (models/moe.py).
    num_experts: int = 0
    num_experts_per_tok: int = 2
    # Static per-expert token capacity = ceil(tokens * k / E) * factor;
    # overflow tokens fall through to the residual (their FFN delta is 0).
    moe_capacity_factor: float = 2.0

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    def param_count(self) -> int:
        """Approximate parameter count (for device-memory budgeting)."""
        d, f, v = self.hidden_size, self.intermediate_size, self.vocab_size
        mlp = 3 * d * f
        if self.num_experts:
            mlp = self.num_experts * 3 * d * f + d * self.num_experts
        per_layer = (d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
                     + mlp + 2 * d)
        embed = v * d * (1 if self.tie_embeddings else 2)
        return self.num_layers * per_layer + embed + d


# Sizes follow the public architecture descriptions of each family; the
# "test" configs are tiny and used by the unit tests.
MODEL_CONFIGS = {
    "test-tiny": ModelConfig(
        name="test-tiny", vocab_size=512, hidden_size=64, intermediate_size=128,
        num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16,
        rope_theta=10_000.0, max_seq_len=512,
    ),
    "test-tiny-gqa": ModelConfig(
        name="test-tiny-gqa", vocab_size=512, hidden_size=128,
        intermediate_size=256, num_layers=2, num_heads=8, num_kv_heads=4,
        head_dim=16, rope_theta=10_000.0, max_seq_len=512,
    ),
    "test-tiny-qwen": ModelConfig(
        name="test-tiny-qwen", vocab_size=512, hidden_size=64, intermediate_size=128,
        num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16,
        rope_theta=10_000.0, max_seq_len=512, attn_bias=True,
    ),
    "test-tiny-qwen3": ModelConfig(
        name="test-tiny-qwen3", vocab_size=512, hidden_size=64,
        intermediate_size=128, num_layers=2, num_heads=4, num_kv_heads=2,
        head_dim=16, rope_theta=10_000.0, max_seq_len=512, qk_norm=True,
    ),
    "llama3.2:1b": ModelConfig(
        name="llama3.2:1b", vocab_size=128_256, hidden_size=2048,
        intermediate_size=8192, num_layers=16, num_heads=32, num_kv_heads=8,
        head_dim=64, rope_theta=500_000.0, max_seq_len=131_072,
        tie_embeddings=True,
    ),
    "llama3.2:3b": ModelConfig(
        name="llama3.2:3b", vocab_size=128_256, hidden_size=3072,
        intermediate_size=8192, num_layers=28, num_heads=24, num_kv_heads=8,
        head_dim=128, rope_theta=500_000.0, max_seq_len=131_072,
        tie_embeddings=True,
    ),
    "llama3:8b": ModelConfig(
        name="llama3:8b", vocab_size=128_256, hidden_size=4096,
        intermediate_size=14_336, num_layers=32, num_heads=32, num_kv_heads=8,
        head_dim=128, rope_theta=500_000.0, max_seq_len=8192,
    ),
    "qwen2.5:7b": ModelConfig(
        name="qwen2.5:7b", vocab_size=152_064, hidden_size=3584,
        intermediate_size=18_944, num_layers=28, num_heads=28, num_kv_heads=4,
        head_dim=128, rope_theta=1_000_000.0, max_seq_len=32_768,
        attn_bias=True,
    ),
    "qwen2.5-7b-instruct": ModelConfig(
        name="qwen2.5-7b-instruct",
        vocab_size=152_064, hidden_size=3584, intermediate_size=18_944,
        num_layers=28, num_heads=28, num_kv_heads=4, head_dim=128,
        rope_theta=1_000_000.0, max_seq_len=32_768, attn_bias=True,
    ),
    # Embedding encoder (nomic-embed-text class: 768-d encoder).
    "nomic-embed-text": ModelConfig(
        name="nomic-embed-text", vocab_size=30_528, hidden_size=768,
        intermediate_size=3072, num_layers=12, num_heads=12, num_kv_heads=12,
        head_dim=64, rope_theta=1000.0, max_seq_len=8192, tie_embeddings=True,
        is_encoder=True,
    ),
    "test-tiny-embed": ModelConfig(
        name="test-tiny-embed", vocab_size=512, hidden_size=64,
        intermediate_size=128, num_layers=2, num_heads=4, num_kv_heads=4,
        head_dim=16, rope_theta=1000.0, max_seq_len=512, tie_embeddings=True,
        is_encoder=True,
    ),
    "qwen3:8b": ModelConfig(
        name="qwen3:8b", vocab_size=151_936, hidden_size=4096,
        intermediate_size=12_288, num_layers=36, num_heads=32,
        num_kv_heads=8, head_dim=128, rope_theta=1_000_000.0,
        max_seq_len=32_768, qk_norm=True,
    ),
    # Mixture-of-experts family (Mixtral 8x7b architecture description).
    "mixtral:8x7b": ModelConfig(
        name="mixtral:8x7b", vocab_size=32_000, hidden_size=4096,
        intermediate_size=14_336, num_layers=32, num_heads=32,
        num_kv_heads=8, head_dim=128, rope_theta=1_000_000.0,
        max_seq_len=32_768, num_experts=8, num_experts_per_tok=2,
    ),
    "test-tiny-moe": ModelConfig(
        name="test-tiny-moe", vocab_size=512, hidden_size=64,
        intermediate_size=96, num_layers=2, num_heads=4, num_kv_heads=2,
        head_dim=16, rope_theta=10_000.0, max_seq_len=512,
        num_experts=4, num_experts_per_tok=2,
    ),
}


def smart_match(name: str, candidates) -> Optional[str]:
    """Model-name matching: exact, then lowercase, then tag-stripped
    (`llama3` matches `llama3:8b`). The native scheduler core
    (cpp/mqcore.cpp) applies the same rule in its eligibility gate."""
    candidates = list(candidates)
    if name in candidates:
        return name
    low = name.lower()
    by_lower = {c.lower(): c for c in candidates}
    if low in by_lower:
        return by_lower[low]
    base = low.split(":", 1)[0]
    for c in candidates:
        if c.lower().split(":", 1)[0] == base:
            return c
    return None


def get_model_config(name: str) -> Optional[ModelConfig]:
    """Resolve a requested model name to an architecture via smart_match."""
    key = smart_match(name, MODEL_CONFIGS.keys())
    return MODEL_CONFIGS[key] if key is not None else None


@dataclasses.dataclass
class EngineConfig:
    """Continuous-batching engine configuration (single device)."""

    model: str = "test-tiny"
    # Decode slots = max sequences generating concurrently in one batch.
    max_slots: int = 64
    # Paged KV cache: total pages in the pool (page 0 is the trash page)
    # and tokens per page.
    num_pages: int = 256
    page_size: int = 32
    # Max pages a single sequence may hold (=> max context length).
    max_pages_per_seq: int = 16
    # Prefill length buckets of the pipeline-parallel (pp > 1) path: a
    # prompt prefills padded to the smallest bucket that holds it, and a
    # prompt past the largest one streams through chunks of it.
    prefill_buckets: tuple = (32, 64, 128, 256, 512, 1024, 2048)
    # Token budget of one ragged dispatch: one token per live decode slot
    # plus as many prefill-span tokens as fit. Clamped up to
    # max_slots + token_granule so a full decode batch always fits.
    max_batch_tokens: int = 512
    # The stream's total token count rounds to rungs of a power-of-two
    # ladder over this granule.
    token_granule: int = 16
    # Speculative decoding on the ragged path: up to spec_k n-gram draft
    # tokens per greedy, penalty-free decode slot, verified in one
    # dispatch as a (1 + k)-token span; rejected drafts' pages roll back.
    spec: bool = False
    spec_k: int = 4
    # A user whose drafts' accept rate falls below this (after a warm-up
    # sample) stops speculating. 0 = never throttle.
    spec_min_accept: float = 0.1
    # Prefix cache: finished prompts' full KV pages merge into a radix
    # tree (engine/prefix_cache.py); admissions sharing a prefix pin
    # those pages and prefill only the uncached tail.
    prefix_cache: bool = False
    # Minimum matched full pages before a hit is taken.
    prefix_cache_min_pages: int = 1
    # Preemption with recompute: decode-time pool exhaustion sends a
    # victim back to the front of its user's queue instead of failing.
    # Off => an explicit kv_exhausted error, never a silent LENGTH.
    preempt: bool = True
    # After this many preemptions a request holds its slot and pages
    # (a stalled reservation) and is never picked as a victim.
    preempt_max: int = 3
    # Requests implicated in a failed step are retried this many times
    # (exponential backoff from retry_backoff_s) before an explicit error.
    step_retries: int = 1
    retry_backoff_s: float = 0.2
    # Deterministic fault injection (testing/faults.py): a plan file path
    # or a FaultPlan instance. None = no injection.
    fault_plan: Optional[object] = None
    # Max new tokens default when the request doesn't specify.
    max_new_tokens: int = 256
    # Decode steps run per dispatch when no admission could land between
    # steps (one Python loop of forward_decode + sampling per step).
    decode_steps_per_iter: int = 8
    # Bucketed prefill forwards admitted per engine tick (pp > 1): TTFT
    # first, but bounded so an arrival storm cannot starve the decode
    # streams. Chunked prefills run one chunk per tick besides.
    prefill_batches_per_tick: int = 2
    # Repeat-penalty window (llama.cpp repeat_last_n).
    repeat_last_n: int = 64
    # Data-parallel replicas of every generative model (engine.py
    # ReplicaSet): each holds its own weights, KV pool and slots, in this
    # process one per device or, over the rank world, one per (pp x tp)
    # sub-grid of ranks; requests place on the least-loaded replica.
    dp: int = 1
    # Pipeline-parallel stages of one engine (layers and their KV pages
    # split over ranks; parallel/pipeline.py) and the GPipe microbatches
    # of one pp dispatch (None: one per stage; rounded down to a divisor
    # of the batch).
    pp: int = 1
    pp_microbatches: Optional[int] = None
    # Sequence-parallel shards of one engine: a prompt past the largest
    # prefill bucket prefills in one forward cut over sp ranks (ring
    # attention, parallel/ring_attention.py); weights and the KV pool
    # are replicated over them.
    sp: int = 1
    # Expert-parallel shards of one engine (the JAX package's mesh axis
    # sizes build the same (data, pipe, seq, expert, tensor) mesh): each
    # rank holds E / ep of every MoE layer's experts and their FFN output
    # is summed over the (expert, tensor) plane; everything else, and a
    # dense model whole, is replicated over the axis. ep must divide an
    # MoE model's expert count.
    ep: int = 1
    dtype: str = "bfloat16"
    # "int8": per-channel symmetric int8 weights, quantized when the
    # runtime builds them (f32 scales; norms and biases stay in `dtype`).
    weights_dtype: str = "bfloat16"
    # "int8": int8 KV pages with one f32 scale per (slot, kv head) stored
    # beside the pool; pages shrink by (hd + 4) / (2 * hd).
    kv_dtype: str = "bfloat16"
    seed: int = 0
    # Telemetry: finished request traces kept for GET /debug/trace
    # (Chrome trace-event export); in-flight traces are always exported.
    trace_ring: int = 512
    # Latency SLOs (telemetry/slo.py): 0/None = objective not configured.
    # slo_ttft_ms bounds enqueue -> first token; slo_tpot_ms bounds the
    # per-token decode step. slo_target is the good-fraction objective
    # (0.99 = 1% error budget); burn-rate alerts fire against it.
    slo_ttft_ms: Optional[float] = None
    slo_tpot_ms: Optional[float] = None
    slo_target: float = 0.99
    # Bounded admission: total / per-user queued-request caps (0 = off).
    # Over-cap enqueues are shed with 503 / 429 + Retry-After instead of
    # growing the queue without bound.
    max_queued: int = 0
    max_queued_per_user: int = 0
    # Scheduling policy (engine/scheduler.py): "fcfs" (the default: the
    # fair-share core's pop order), "srpt" (shortest predicted remaining
    # first off the online output-length predictor, with anti-starvation
    # aging) or "edf" (earliest deadline first; srpt order for requests
    # without a deadline). Policies reorder only within what the
    # fair-share core released.
    scheduler: str = "fcfs"
    # Flight recorder (telemetry/journal.py): ring capacity (records kept
    # for /debug/journal and the health monitor's invariant sweep), an
    # optional JSONL spill rotated at journal_rotate_mb keeping
    # journal_keep files, and the sampling rate of the high-rate kinds
    # (batch/chunk/page_*; decision kinds are always kept).
    journal_ring: int = 2048
    journal_file: Optional[str] = None
    journal_rotate_mb: float = 64.0
    journal_keep: int = 3
    journal_sample: float = 1.0
    # Crash durability (durability/): the write-ahead request log's
    # directory (None = no WAL) and its group-commit fsync window in ms
    # (0 = fsync inline on every admission). An admission returns once
    # its record is on disk; a restart replays unfinished requests.
    wal_dir: Optional[str] = None
    wal_fsync_ms: float = 20.0
    # -- router HA (fleet/ha.py) ---------------------------------------------
    # Primary role: replicate WAL records + journal decision events to a
    # connected warm standby over GET /admin/ha/sync (batched, sequence-
    # numbered; the standby's poll position is the ack). Requires a WAL
    # (--wal-dir): the replicated WAL is what a takeover recovers from.
    ha: bool = False
    # Standby role: the primary router's base URL to tail. The process
    # builds the full fleet (same member URLs) but serves nothing until
    # the primary's heartbeat is lost past the takeover grace — then it
    # PROMOTES: epoch bump, member re-registration (stale-epoch callers
    # fenced), WAL-replica recovery re-admission. Mutually exclusive
    # with --ha.
    standby_of: Optional[str] = None
    # Heartbeat-loss window before the standby declares the primary dead
    # and promotes; also the sync poll cadence's upper bound (the
    # standby polls at grace/4, floor 50ms).
    takeover_grace_s: float = 3.0
    # -- fleet router (fleet/router.py) --------------------------------------
    # Engine replicas behind the router (1 = one engine, no router). The
    # router owns the fair-share queues and the bounded-admission caps;
    # members serve uncapped what the router placed.
    replicas: int = 1
    # "affinity": route to the replica whose prefix-cache radix tree
    # holds the prompt's prefix, else least-loaded; "least_loaded" skips
    # the affinity probe.
    placement: str = "affinity"
    # POST /admin/drain/{replica}: in-flight streams get this long before
    # the stragglers fail over to healthy replicas.
    drain_timeout_s: float = 30.0
    # KV page migration: failover and drain first SHIP a stream's KV
    # pages and request state to a healthy member (zero recomputed
    # tokens), and fall back to recompute replay when the source cannot
    # export or the transfer fails; an affinity miss may ship the cached
    # prefix to the chosen member. Off: recompute replay only.
    migrate: bool = True
    # A transfer (export, ship, import ack) past this budget aborts and
    # falls back to recompute.
    migrate_timeout_s: float = 10.0
    # The router times every placement decision
    # (ollamamq_router_overhead_ms{site="place"}); a windowed p99 above
    # this budget fires the router_overhead alert. 0 disables the alert
    # (the timers stay on).
    router_overhead_budget_ms: float = 50.0
    # Re-export every HTTP member's series from the router's /metrics
    # with a `replica` label (scraped on the member health heartbeat).
    # In-process members share the router's registry regardless.
    federate_metrics: bool = True
    # Comma-separated member names flagged preemptible (spot-style
    # capacity): POST /admin/preempt/{replica}, or the fault plan's
    # "preempt" site, serves them a termination notice: migrate off,
    # then retire, within the notice window.
    preemptible: Optional[str] = None
    # Tensor-parallel width of one engine. This package serves one
    # device per engine, so 1 is the only width it builds; tier specs
    # select and declare widths with it (tpN).
    tp: int = 1
    # -- tiered fleet (fleet/tiering.py) -------------------------------------
    # Replica-tier spec: latency-sensitive traffic (VIP/boost users,
    # deadlined requests) places on the `interactive` tier, everything
    # else on `bulk`, with affinity/least-loaded preserved WITHIN a
    # tier and cross-tier placement only under journaled overflow
    # (per-tier SLO burn) or an empty tier. Syntax:
    #   "interactive=r0;bulk=r1,r2"          by member name
    #   "interactive@tp1=tp1;bulk=r2"        by TP width (tpN matches
    #                                        every member at width N);
    # the optional @tpN suffix declares the tier's TARGET width — the
    # TierBalancer hot-restarts a retiered LocalMember at it. Members no
    # selector matches default to bulk. None = untiered fleet.
    tiers: Optional[str] = None
    # -- elastic fleet (fleet/autoscaler.py) ---------------------------------
    # SLO-burn-driven autoscaler: a per-tier control loop that watches
    # sustained burn + queue backlog and resizes the fleet one member at
    # a time through a MemberProvisioner. Scale-down is always drain ->
    # migrate-off -> retire (never a kill); the bulk tier may scale to
    # zero (queued bulk work parks at the router and wakes it), while
    # `interactive` keeps the min_replicas floor. Off = fixed fleet.
    autoscale: bool = False
    # Fleet-size bounds for the scaler: min_replicas is the floor for
    # the interactive tier (and untiered fleets); max_replicas caps the
    # whole fleet.
    min_replicas: int = 1
    max_replicas: int = 4
    # Hysteresis: after any scale event the scaler holds its fire this
    # long (the burn/idle signal must also be SUSTAINED, with sustain
    # windows derived from this knob). Waking a scaled-to-zero tier with
    # parked work bypasses the cooldown.
    scale_cooldown_s: float = 30.0

    @property
    def max_context(self) -> int:
        return self.max_pages_per_seq * self.page_size


QUANT_DTYPES = ("bfloat16", "int8")

# Closed scheduling-policy vocabulary (engine/scheduler.py maps each
# name to its implementation and asserts the two stay in sync).
SCHEDULERS = ("fcfs", "srpt", "edf")


def validate_scheduler(name: str) -> Optional[str]:
    """--scheduler validation before any device work: an error string,
    or None when valid."""
    if name not in SCHEDULERS:
        return f"--scheduler must be one of {SCHEDULERS}, got {name!r}"
    return None


def validate_quant_config(weights_dtype: str, kv_dtype: str,
                          pp: int = 1, sp: int = 1,
                          model_names=()) -> Optional[str]:
    """Check the quantization flags before any device work: an error
    string, or None when valid. The CLI calls it with every model it
    serves and ModelRuntime at build with its own (argparse choices
    already restrict the flags to QUANT_DTYPES). int8 KV needs the ragged
    path, which pp > 1 runtimes leave; int8 weights serve at any pp."""
    if weights_dtype not in QUANT_DTYPES:
        return (f"--weights-dtype must be one of {QUANT_DTYPES}, "
                f"got {weights_dtype!r}")
    if kv_dtype not in QUANT_DTYPES:
        return f"--kv-dtype must be one of {QUANT_DTYPES}, got {kv_dtype!r}"
    if kv_dtype == "int8" and pp > 1:
        return ("--kv-dtype=int8 needs the ragged attention path; pp > 1 "
                "runtimes serve the stage-scheduled bucketed prefill whose "
                "pipeline forwards read bf16 pages")
    if kv_dtype == "int8" and sp > 1:
        return ("--kv-dtype=int8 is unsupported with sequence-parallel "
                "prefill (its all-layer KV scatter bypasses the quantized "
                "page writer)")
    if weights_dtype == "int8":
        for name in model_names:
            cfg = get_model_config(name)
            if cfg is not None and cfg.num_experts:
                return (f"--weights-dtype=int8 does not cover MoE expert "
                        f"stacks (model {name}); load it in bfloat16")
    return None


def validate_autoscale(min_replicas: int, max_replicas: int,
                       scale_cooldown_s: float,
                       replicas: int) -> Optional[str]:
    """--autoscale validation before any device work: an error string,
    or None when valid."""
    if min_replicas < 1:
        return (f"--min-replicas must be >= 1 (the interactive floor), "
                f"got {min_replicas}")
    if max_replicas < min_replicas:
        return (f"--max-replicas ({max_replicas}) must be >= "
                f"--min-replicas ({min_replicas})")
    if scale_cooldown_s <= 0:
        return (f"--scale-cooldown-s must be > 0, got {scale_cooldown_s}")
    if replicas > max_replicas:
        return (f"starting fleet size --replicas {replicas} exceeds "
                f"--max-replicas {max_replicas}")
    return None


def validate_ha(ha: bool, standby_of: Optional[str],
                takeover_grace_s: float, wal_dir: Optional[str],
                fleet: Optional[str]) -> Optional[str]:
    """--ha/--standby-of validation before any device work: an error
    string, or None when valid."""
    if not ha and not standby_of:
        return None
    if ha and standby_of:
        return ("--ha and --standby-of are mutually exclusive: a process "
                "is the primary or the standby, never both")
    if takeover_grace_s <= 0:
        return (f"--takeover-grace-s must be > 0, got {takeover_grace_s}")
    if not wal_dir:
        flag = "--ha" if ha else "--standby-of"
        return (f"{flag} requires --wal-dir: the replicated WAL is what "
                "a takeover recovers unfinished streams from")
    if standby_of:
        if not (standby_of.startswith("http://")
                or standby_of.startswith("https://")):
            return (f"--standby-of must be the primary router's http(s) "
                    f"base URL, got {standby_of!r}")
        if not fleet:
            return ("--standby-of requires --replica-urls with the SAME "
                    "member URLs the primary serves: promotion "
                    "re-registers those members under the new epoch")
    return None


# Closed tier vocabulary (fleet/tiering.py): `interactive` serves the
# latency-sensitive classes (VIP/boost users, deadlined requests), `bulk`
# everything else. The journal schema, metrics labels, and the TUI tiers
# line all read this tuple.
TIER_NAMES = ("interactive", "bulk")


class TiersError(ValueError):
    """Malformed --tiers spec / unresolvable tier assignment."""


def parse_tiers(spec: str) -> dict:
    """Parse a --tiers spec: `tier[@tpW]=sel[,sel...];tier=...` where a
    selector is a member name (`r0`, `h1`) or `tpN` (every member whose
    TP width is N). Returns {tier: {"tp": Optional[int],
    "selectors": [str, ...]}}; raises TiersError on syntax/vocabulary
    problems (assignment problems surface in assign_tiers, which knows
    the members)."""
    out: dict = {}
    for part in (spec or "").split(";"):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise TiersError(
                f"tier entry {part!r} is not of the form "
                "tier[@tpN]=member[,member...]")
        head, sels = part.split("=", 1)
        head = head.strip()
        tp = None
        if "@" in head:
            head, width = head.split("@", 1)
            head = head.strip()
            width = width.strip()
            if not width.startswith("tp") or not width[2:].isdigit() \
                    or int(width[2:]) < 1:
                raise TiersError(
                    f"tier width {width!r} must be tpN with N >= 1")
            tp = int(width[2:])
        if head not in TIER_NAMES:
            raise TiersError(
                f"unknown tier name {head!r} (tiers: {TIER_NAMES})")
        if head in out:
            raise TiersError(f"tier {head!r} specified twice")
        selectors = [s.strip() for s in sels.split(",") if s.strip()]
        if not selectors:
            raise TiersError(f"tier {head!r} names no members")
        out[head] = {"tp": tp, "selectors": selectors}
    if not out:
        raise TiersError("--tiers spec is empty")
    return out


def assign_tiers(spec: str, members) -> tuple:
    """Resolve a --tiers spec against the fleet roster. `members` is a
    list of (name, tp_width_or_None) pairs. Returns (assignment, widths):
    assignment maps member name -> tier, widths maps tier -> declared
    target TP width (None = re-label only on regroup). Members no
    selector matches default to `bulk`. Raises TiersError when a
    selector names no member, a member lands in two tiers, or a tier
    ends up with no members — the fail-fast contract the CLI and the
    router share."""
    parsed = parse_tiers(spec)
    by_name = {name: tp for name, tp in members}
    assignment: dict = {}
    for tier, entry in parsed.items():
        for sel in entry["selectors"]:
            if sel.startswith("tp") and sel[2:].isdigit():
                width = int(sel[2:])
                matched = [n for n, tp in members if tp == width]
                if not matched:
                    raise TiersError(
                        f"tier {tier!r} selector {sel!r} matches no "
                        f"member (members: {sorted(by_name)})")
            elif sel in by_name:
                matched = [sel]
            else:
                raise TiersError(
                    f"tier {tier!r} selector {sel!r} names no member "
                    f"(members: {sorted(by_name)})")
            for name in matched:
                prev = assignment.get(name)
                if prev is not None and prev != tier:
                    raise TiersError(
                        f"member {name!r} assigned to both {prev!r} "
                        f"and {tier!r}")
                assignment[name] = tier
    for name in by_name:
        assignment.setdefault(name, "bulk")
    widths = {tier: entry["tp"] for tier, entry in parsed.items()}
    for tier in TIER_NAMES:
        widths.setdefault(tier, None)
        if not any(t == tier for t in assignment.values()):
            raise TiersError(
                f"tier {tier!r} has no members — a tiered fleet needs "
                f"at least one member per tier (assignment: {assignment})")
    return assignment, widths


def validate_tiers(spec: Optional[str], members) -> Optional[str]:
    """--tiers validation before any device work: an error string, or
    None when valid. Shared by the CLI and the fleet router."""
    if not spec:
        return None
    try:
        assign_tiers(spec, members)
    except TiersError as e:
        return str(e)
    return None
