#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (ollamamq_tpu_torch) on one GPU.

    python3 chip_smoke.py            # one card, about 15 to 20 minutes
    python3 chip_smoke.py --profile  # also torch.profiler windows of serving
    python3 chip_smoke.py --only serve-dp  # the build and one phase (a
                                           # partial run: no ok line)

Phases, each printing JSON lines; any failure exits non-zero:

  build    nvcc builds both CUDA sources from ollamamq_tpu_torch/csrc, in
           parallel, and all four entry points load: ragged and decode
           attention over a pool in q's dtype and over an int8 pool.
           Then the Python this process imported is compiled into a
           bytecode cache under ollamamq_tpu_torch/_build/pycache that
           every process the script starts reads (share_bytecode).
  decode-plan
           each decode entry point, called directly with q in bf16,
           refuses a launch plan that differs from decode_launch_plan in
           any one number.
  kernels  each kernel against its plain PyTorch version on the card, q in
           bf16 (atol = rtol = 2e-2) and float32 (1e-4), at the
           llama3.2:1b and llama3:8b attention shapes, one
           microbatch of a pipeline stage's llama3:8b decode (decode
           only: 4 rows, 24 pages a sequence), a 512-token
           llama3.2:1b prefill (ragged only), a serving decode step of
           llama3.2:1b (8 sequences of 20 to 140 tokens; decode only),
           the one-rank shapes of tensor parallelism at tp 2 (llama3:8b
           and llama3.2:1b with 16 query heads over 4 KV heads), the
           CPU tests' edge cases (GQA, MQA, group 1, empty rows,
           contexts past max_pages), the ragged kernel's query-tiling
           edges (a span starting mid-page, spans of QT, QT + 1 and
           2 QT + 3 rows, groups 3 and 7, long tail padding, a prefill
           past max_pages) and the decode kernel's split edges (contexts
           of SPLIT - 1, SPLIT, SPLIT + 1 and 2 SPLIT + 3 at page sizes 8
           and 16, one 512-token sequence alone, a context past
           max_pages beside empty and negative ones, groups 3 and 7 at
           head dim 128, MQA and group 1 over several splits), and the
           span shapes of the page lifecycle at the llama3.2:1b shape:
           speculative verify spans (1 + 4 rows across page boundaries,
           1 + d beside decode rows and a prefill), prefix-hit spans from
           page boundaries 128 and 256 over pages that other rows of the
           call read too, and a decode call after a rollback. Every pool
           slot a kernel must not read holds NaN; in an int8 pool (built
           by the port's kv_quantize) it holds payload 127 and a NaN
           scale. Times with CUDA events: kernel_ms and sdpa_dense_ms as
           50 calls captured in a CUDA graph and replayed (device time;
           SDPA over dense K/V, dequantized to q's dtype for an int8 pool,
           a yardstick only), *_eager_ms as 50 eager calls back to back
           (host launch cost included), decode's kernel_cold_l2_ms with
           the L2 flushed before each replayed call, plain_ms eager;
           bound_ms is the bytes the call must move over 3.35 TB/s, or
           its FLOPs over the dtype's peak, whichever is larger. Ragged lines count the K/V
           positions loaded per kv head per row, per query tile and
           distinct; bf16 decode lines give the launch plan's split
           count and the split blocks that have work.
  serve    the port's HTTP server in-process with llama3.2:1b at full
           width (16 layers, bf16, seeded random weights): requests from
           3 users over /api/generate, /api/chat, /v1/chat/completions,
           one sampled; greedy determinism; both bf16-pool kernels' launch
           counters must rise and the int8 ones stay 0; one prompt's
           prefill and decode logits through the kernels against the plain
           attention path on the same card (serve-logits).
  serve-int8
           the same engine, jobs and checks with int8 weights and int8 KV
           pages, after the bf16 engine is freed: both int8 kernels'
           counters must rise and the bf16 ones stay 0, and the KV pool
           must shrink to at most (hd + 4) / (2 hd) + 0.01 of bf16's
           (serve-int8-logits: the same logits check on the int8 path).
  quant-guardrail
           greedy token-match rate and logit error of the int8 llama3.2:1b
           tree against its bf16 source at full width; printed, not gated.
  serve-moe
           the mixture-of-experts family: mixtral:8x7b at full width (d
           4096, f 14336, 32 heads over 8 KV heads, hd 128, 8 experts,
           top-2, vocab 32,000, untied), depth cut from 32 to 16 layers
           (registered in this process as mixtral:8x7b-16l; 46.96 GB of
           seeded bf16 weights; 32 layers would not fit in 80 GB and the
           reference refuses int8 weights for MoE), 8 slots, 136 pages,
           page 32, token budget 512, k_steps 8, through TorchEngine and
           the HTTP server: 4 greedy /api/chat streams of 64 tokens from 3
           users (prompts of 100 to 300 tokens), then one prompt twice
           alone. Gates: every reply stop/length; the repeated prompt's
           ids identical; the window launched exactly 16 bf16 ragged
           kernels per dispatch and 16 decode kernels per step, no int8;
           every attention call of one prefill and one decode step
           through the kernels within 2e-2 of the plain version on the
           same q and pools (the end-to-end logits are printed with the
           router decisions that differ between the two paths: a bf16
           rounding difference can flip a near-tie of the top-k, so they
           are not gated); layer 0's moe_mlp in float32 at full width
           over 64 tokens with capacity factor E / K (no drops) within
           1e-4 relative of a per-token loop; param_bytes
           46,964,940,800; `python -m ollamamq_tpu_torch.cli --model
           mixtral:8x7b --weights-dtype int8` exits 2 with the
           reference's message; memory_allocated back to its level
           before the phase (128 MiB of cuBLAS workspaces allowed).
           Records tokens/s, TTFT p50/p99, phase seconds, peak memory,
           one decode step's time between CUDA events against its byte
           bound (every weight but the embedding table over 3.35 TB/s),
           and with --profile its device time and a profiled burst.
  serve-runtime
           llama3.2:1b in bf16 through the HTTP server with the prefix
           cache, speculation (k 4), default preemption on a 44-page pool
           that the traffic overflows, and one injected ragged fault: a
           warm request, then 6 users sharing a 4-page system prefix, a
           repeated pattern and a sampled request at once. Gates: every
           reply stop/length, preemptions, prefix hits and accepted drafts
           >= 1, exactly one retry, the sampled request never speculates,
           no page used afterwards and the tree's invariants hold, the
           decision journal of the whole phase (the ring holds it all) is
           clean under check_invariants (pages conserved through
           preemption, eviction and rollback; no slot held twice; no
           starvation; one terminal per request), only the two bf16
           kernels launched. Prints tokens/s, the journal's records by
           kind and, per reply, the first token that differs from the
           request served alone (not gated).
  serve-runtime-f32
           byte identity at full width in float32 (TF32 off): a lone
           greedy request with and without a forced self-preemption
           (cache off and on), and a repeated pattern with spec off and
           on; token ids must be identical.
  serve-sched
           the fair-share front's scheduling and observability: llama3.2:1b
           in bf16 through the HTTP server under --scheduler srpt, token
           fairness, max_queued_per_user 3 and max_queued 6. With the
           engine loop not started, one user's fourth request gets 429,
           a second user's three are queued (6 in all) and a third
           user's request gets 503, each with a Retry-After >= 1, and the
           journal holds exactly one shed record per 429 and 503; the
           loop then serves the 6. Then one user sends 4 long requests
           (160 tokens) and four users 2 short ones (16), paced by the
           client under the caps. Gates: every reply stop/length; the
           /metrics scrape parses, its TTFT count grew by the replies
           served and its generated-token counter by their eval_count;
           the MFU gauge in (0, 1] with the card's peak from the table
           (a card missing from it fails); /debug/stepprof samples in the
           ragged and decode modes with all four phases; /debug/hbm
           allocated bytes >= weights + KV pool; /health online after a
           watchdog probe on cuda with no alert firing; only the two
           bf16 kernels launched. Prints the step-phase medians per mode,
           TTFT p50/p99 and TPOT p50 (from the histograms' growth in this
           phase), per-user generated tokens and the MFU.
  serve-models
           the model lifecycle and the rest of the API surface: an engine
           holding llama3.2:1b (bf16, seeded, serve's shape with 4 slots)
           behind the HTTP server. (a) a streamed /api/pull of
           nomic-embed-text (768-d encoder, 12 layers, seeded bf16):
           progress lines then success; /api/tags and /api/ps list both
           models, each with its runtime's weight bytes. (b) 4 greedy
           streams of 160 tokens saturate the 4 decode slots while
           /api/embed sends 8 inputs of 16 to 300 tokens to each model,
           plus one /v1/embeddings and one /api/embeddings: dimensions
           2048 and 768, every norm within 1e-3 of 1, every embed reply
           before the last stream ends, the window launched only the two
           bf16 attention kernels, and an embed-only sub-window (which
           times one batch of 8 per model) none. (c) the first input
           embedded alone against inside the batch: cosine >= 0.999; the
           encoder's card embeddings of the batch against the port's
           plain float32 forward on the CPU with the card's weights:
           cosine >= 0.995. (d) with the loop stopped, an embed placed on
           the encoder: /api/delete answers 409, then the loop restarts
           and serves it. (e) /api/delete of the idle encoder: 200,
           torch.cuda.memory_allocated falls by >= 0.95 of its weight
           bytes, /api/embed on it answers 404; a re-pull gives
           bit-identical lone embeddings. (g) /, /api/show, /api/version,
           /v1/models, /v1/models/{model} and /v1/completions (JSON and
           SSE) answer in the reference's shapes; /api/create, /api/push
           and /api/blobs/x answer 501. (f) save_safetensors writes
           llama3.2:1b's weights in HF layout to a temporary directory; a
           second engine built from it streams greedy ids identical to
           the seeded engine's for 2 prompts x 32 tokens; the directory
           is deleted. Prints embed ms per batch per model, pull seconds,
           bytes freed by the delete and checkpoint write/load seconds.
  serve-durable
           crash durability: llama3.2:1b at full width (seeded) served by
           `python -m ollamamq_tpu_torch.cli --wal-dir` in a subprocess on
           the card, 4 users each sending one greedy /api/generate stream
           of 96 tokens. Each client follows its stream by the req_id the
           journal gives it through GET /api/stream/{rid} (one frame per
           token); once each has read 16 token frames the clients stop
           reading, and 0.1 s later the server gets SIGKILL. A restart on
           the same WAL dir must report 4 recovered streams, and each
           client resumes with ?from=N. float32 (TF32 off): every
           stream's ids and text, before plus after the crash, identical
           to the same requests served uninterrupted in-process from a
           fresh WAL dir, and the recovered process's /health shows the
           two float32-q kernels launched and the int8 ones not. bfloat16:
           every stream reaches done, and the frames replayed from the
           recovered registry equal the frames read before the crash (the
           first differing token against the uninterrupted run printed,
           not gated). SIGTERM (bf16): 4 streams, the signal once each has
           8 tokens, a request 0.2 s later gets 503, every in-flight
           stream completes, the process exits 0, and an engine restarted
           on that WAL dir recovers 0 streams. No WAL may degrade.
           Recorded, not gated: tokens/s and TTFT p50 of the same traffic
           in-process with and without a WAL (after a warm-up run: off,
           on, on, off, twice), the WAL
           fsync p50/p99, ollamamq_recovered_streams_total, seconds from
           restart to the first resumed frame, journal records per
           request. Server logs and WAL dirs under chiprun_out/chip_smoke.
  serve-fleet
           the fleet router and KV page migration: llama3.2:1b at full
           width (seeded), members of 4 slots and 72 pages built as the
           CLI builds them (an engine_factory each, no caps, WAL or
           journal spill), page size 32, 16 pages a sequence, k_steps 8,
           the prefix cache on, placement affinity. (a) two bf16 members
           r0, r1 behind the port's FleetRouter and HTTP server: two
           warm-ups (the second, a 2-page system prompt, lands on r0 and
           caches there), then 6 users' greedy 160-token streams in two
           waves, 2 plain ones and, once they hold 64 tokens, 2 plain and
           the 2 users sharing the system prompt; once every stream holds
           32 tokens, POST /admin/drain/r0. Gates: every reply stop or
           length; ollamamq_fleet_migrations_total{outcome="migrated"}
           grew by r0's in-flight streams at the drain (>= 1); no
           replica_failover; ollamamq_fleet_migrate_bytes_total grew by
           kv_page_bytes x the pages of every migrate_export and prefix
           shipment; check_no_dropped_streams clean on the router's and
           both members' journals; 0 pages used on both members; r0
           healthy again in GET /admin/fleet; both bf16 kernels launched.
           Then one stream alone, unmigrated and migrated at 16 tokens
           (bf16: the first differing index printed, not gated). (b)
           float32, TF32 off: one stream migrated at 16 and at 64 tokens
           gives the unmigrated run's ids. (c) int8 KV: one stream
           migrated between two int8-KV members; the target's page run,
           read right after the import, equals the shipped int8 payload
           and f32 scale planes bit for bit, the stream completes and the
           int8 decode kernel runs on the target. (d) a member
           subprocess (`python -m ollamamq_tpu_torch.cli --device cuda`)
           joined as h0 beside a local r0, drained while it streams: the
           stream migrates over /admin/migrate/export, /import, /commit
           into r0, the bytes as in (a), and the subprocess's exit line
           shows both bf16 kernels launched. Records the handoff ms per
           migrated stream (export to commit) in process and over the
           wire, the placement overhead p50/p99, TTFT p50 through the
           router (its enqueue to the member's first token) and (a)'s
           tokens/s. The member's log is under chiprun_out/chip_smoke.
  serve-tiers
           SLO-aware replica tiers, first with every member one rank wide,
           then with a member two ranks wide. The one-rank window: the
           CLI's fleet of three bf16 members with --tiers
           "interactive=r0;bulk=r1,r2" at the CLI's TTFT objective (500
           ms) and eject bound (3 s), the same warm-ups, waves and regroup
           of r2 as below (a re-label at its width); gated the same way
           where the widths do not differ, every interactive-class
           tier_place naming r0 or r2 with no overflow, and the two bounds
           checked in effect. The wide window: the CLI's
           fleet (cli.build_fleet) of three bf16 members as serve-fleet
           builds them, with --tiers "interactive@tp2=r0;bulk=r1,r2", a
           whole-phase journal ring and a card plan of five slots on
           cuda:0 (fleet/wide.py CardPlan, the explicit device list; its
           ranks share the card over gloo): r0 starts at tp 2, an
           SPMDEngine leading a world of its own (rank 0 in this process,
           rank 1 a `python -m ollamamq_tpu_torch.fleet.wide` process),
           r1 and r2 at tp 1, behind the HTTP server. A warm-up per tier,
           then 7 greedy 256-token streams in two waves 32 tokens apart: a
           VIP user, a boosted user and a request with deadline_ms
           (interactive), and 4 plain users (bulk); once every stream
           holds 16 tokens, POST /admin/retier/r2 {"tier": "interactive"}
           while bulk streams are live on r2: r2 is rebuilt at tp 2, a
           world of its own; then two deadlined streams at once. The
           router's eject bound is 60 s and the TTFT objective 60 s in
           this window and the f32 one: r0's ranks time-slice the card
           with the other members' process, so its loop iterations run
           past the CLI's 3 s (recorded: each member's longest heartbeat
           age). Launches count from the fleet's build, so rank 0's and
           each rank 1's cover one span. Gates: every
           reply stop or length; r0 at tp 2 and r1, r2 at tp 1, then r2 at
           tp 2; every interactive-class tier_place of the waves names r0
           (no overflow), every bulk one r1 or r2, the two late
           streams r0 and r2; tier_regroup start then done with tp_from 1
           and tp_to 2, paired, and GET /admin/tiers lists r0 and r2 as
           interactive; every stream live on r2 migrated to r1 (no
           failover, no aborted handoff, no eject); check_no_dropped_streams and
           check_invariants clean on the router's and every member's
           journal (r2's tp-1 engine's too); 0 pages used on every member;
           the window's in-process launches equal the layers times the
           dispatches of every rank 0 (r0, r1, r2 before and after the
           regroup), each made ragged dispatches and decode steps, no
           int8 launch; each wide member's rank 1 exactly 16 ragged
           launches per ragged dispatch and 16 decode per decode step
           over its run, as many of each as its rank 0, with the same
           output digest; each
           rank's param_bytes and kv_bytes those of one tp-2 rank from the
           config's shapes (1,235,881,984 and 37,748,736); r2's old engine
           garbage once regrouped, and memory_allocated back within 128
           MiB of the phase's start once the fleet is gone (cuBLAS's
           per-thread workspaces dropped from both readings). Then float32
           (TF32 off) through the same tiered fleet: one bulk stream on a
           tp-1 member, the same prompt from a VIP user on r0 (tp 2): ids
           equal; then the bulk stream again with its member retiered to
           interactive@tp2 once it holds 16 tokens (the stream migrates
           in-tier): the ids must not change. Records the regroup seconds
           (start to done in the journal: drain, migration and the tp-2
           world's start), TTFT p50 per tier (the router's enqueue to the
           member's first token, from the journals) and tokens/s.
  serve-autoscale
           the autoscaler: the CLI's fleet of one bf16 member of 2 slots
           with --autoscale --min-replicas 1 --max-replicas 2
           --scale-cooldown-s 1.5 --slo-ttft-ms 60000, behind the HTTP
           server. A warm-up, then 6 users' greedy 96-token streams
           arriving 0.15 s apart: the router's backlog (more than one
           member's slots, held 0.5 s) makes the LocalProvisioner build
           a0 on the card from the CLI's member factory (the same
           weights). The router times TTFT to a stream's first text,
           which the seeded model's ids rarely decode to, so the TTFT
           objective is set far above this traffic: on that noise a low
           one fires and its 5-minute window holds the scale-down off.
           The idle fleet then retires a0 (drain, migrate off, retire).
           Gates: every reply stop or length; scale_up start then done
           for a0; a0 served a stream of the burst and launched both
           bf16 kernels while it served; scale_down done for a0 with why
           "idle"; the fleet back to 1; check_scale_pairing and
           check_no_dropped_streams clean; 0 pages used; no scale_storm
           alert; the window's launches equal r0's and a0's dispatches.
           Records seconds from the scale-up decision to a0's join, the
           scaler's wake_wait_s, and torch.cuda.memory_allocated before
           a0's provision against after its retire.
  serve-ha router HA: two `python -m ollamamq_tpu_torch.cli` members on
           the card (llama3.2:1b, float32, seeded, started in parallel)
           behind an --ha primary router (--replicas 0 --replica-urls,
           --wal-fsync-ms 2, --takeover-grace-s 1.0: no engine, no
           device). One greedy 160-token stream through the primary is
           the reference; then a standby (--standby-of) catches up
           through the snapshot and sheds a request; 4 users' greedy
           160-token streams (one repeats the reference's prompt) run
           through the primary, observed through GET /api/stream/{rid};
           once each is 16 tokens in (as its member generated them: the
           router's frames carry ids only where a member wrote text,
           which the seeded model's ids rarely decode to) and the
           standby's replica holds every admission, kill -9 of the
           primary; each client resumes on the promoted standby from
           where it stopped reading, then replays from 0. The old primary revives on its WAL dir until the
           members fence it; a second standby of the promoted router
           then takes over on a SIGTERM handover and serves a 32-token
           stream. Gates: catch-up (standby, epoch 1, lag 0, the
           reference finished in the replica), a 429/503 shed with
           Retry-After, promotion to epoch 2 with router_takeover done
           (why primary_dead, takeover_ms), 4 of 4 streams resumed to
           stop/length, the repeated prompt's ids equal the reference's,
           every replay equal to what was read before and after, at
           least one fenced call while the promoted router serves on,
           the handover (exit 0, done why handover at epoch 3),
           check_files and check_invariants clean over every spill of
           the surviving run, no WAL degraded, 0 pages used, and on
           each member both float32-pool kernels launched over the
           phase, the ragged one after the kill (the promotion's replay
           prefill) and the decode one after the orphaned member
           requests ended (the resumed decode). Records kill to standby
           serving, takeover_ms, kill to the first resumed token, the
           sync lag at the kill, SIGTERM to the second standby serving,
           the 4-stream window's tokens/s (the members' generated-token
           counters) and the fenced calls.
  serve-tp tensor parallelism: two ranks (processes of this script,
           --tp-rank) share cuda:0 over gloo (NCCL refuses two ranks on
           one GPU); rank 0 runs SPMDEngine and the HTTP server, rank 1
           run_worker, each holding half the heads, FFN columns and
           vocabulary rows and half the KV pool. Four windows in one
           world of the two processes, each window a session of its
           wire (its own engine on rank 0, its own run_worker on rank 1),
           the kill last: (1) llama3:8b at full width (16 of 32 layers,
           d 4096, 32 heads over 8 KV heads, hd 128, f 14,336, vocab
           128,256, untied; seeded bf16 weights, 8 slots, 136 pages of
           32): 4 greedy /api/chat streams of 64 tokens from 3 users
           (prompts of 100 to 300 tokens), then one prompt twice alone;
           gates: every reply stop/length, the repeat identical, both
           ranks' digests of every dispatch output equal, each rank
           exactly 16 ragged launches per ragged dispatch and 16 decode
           launches per decode step and no int8 launch, param_bytes
           4,540,604,416 and kv_bytes 142,606,336 on each rank, every
           attention call of rank 0 (its slice alone, 16 heads over 4)
           within 2e-2 x max |plain|; records tokens/s, TTFT, init
           seconds, each rank's peak memory, rank 0's all_reduce ms per
           forward and the wire's ms per dispatch over one more burst,
           and with --profile a profiled burst; metrics_federated: rank
           0's /metrics, scraped once rank 1's posted snapshot settled,
           equals the registry's render with that snapshot merged and
           counts rank 1's probe series once. (2) llama3.2:1b in
           float32 (TF32 off): 4 greedy 32-token streams at tp 2 and at
           tp 1 on the same seed, queued before the loop starts: ids
           identical, the first forward's logits within 1e-4 x max
           |logit|, both f32 kernels launched on each rank. (3)
           llama3.2:1b with int8 weights and int8 KV: 2 greedy streams
           of 32 tokens; both int8 kernels exactly per dispatch on each
           rank, per-call agreement as in (1), each rank's kv_bytes half
           serve-int8's. (4) kill -9 of the worker while 4 streams
           decode: every request ends with an error within 18 s (3 s of
           heartbeat staleness plus slack), /health answers 200 with
           worker_stale firing and the runtime failed. Besides: a world
           of one NCCL rank runs the TP all-reduce helper on the card,
           and `python -m ollamamq_tpu_torch.cli --model llama3.2:1b
           --tp 2` exits 2 naming cuda:1. Rank logs go to
           chiprun_out/chip_smoke/serve_tp_*.log.
  serve-pp pipeline parallelism: ranks (processes of this script,
           --tp-rank, as serve-tp's) share cuda:0 over gloo, one
           pipeline stage each (times tp ranks a stage). First a probe:
           does gloo's raw send/recv take a CUDA tensor (recorded, not
           gated; the pipe group stages through pinned host buffers).
           Then five windows, four of them in one world of two ranks
           (sessions of its wire, the kill last) and the pp 2 x tp 2 one
           in a world of four: (1) llama3:8b at full width and depth
           over 2 stages (16 layers each, the embedding, head and final
           norm on both; seeded bf16 weights, 8 slots, 136 pages of 32,
           24 pages a sequence, buckets 32/64/128/256, k_steps 8, 2
           decode microbatches of 4): serve-tp's 4 greedy /api/chat
           streams of 64 tokens plus a 600-token prompt from a fourth
           user (the chunked path), then one prompt twice alone; gates:
           every reply stop/length, the repeat identical, both ranks'
           output digests equal, a bucketed prefill and >= 3 chunks
           ran, each rank exactly 16 x 2 decode launches per decode
           step and no ragged or int8 launch, param_bytes 9,080,938,496
           and kv_bytes 285,212,672 on each rank (from the config's
           shapes), every attention call of stage 0 within 2e-2 x max
           |plain|; records tokens/s, TTFT, each rank's peak memory,
           the hand-off ms per forward (staging, sends, receives) and
           each stage's receive share against the schedule's bubble.
           (2) llama3.2:1b in float32 at pp 2 and (3) at pp 2 x tp 2
           (four ranks) against one rank: ids identical, request 0's
           first logits within 1e-4 x max, only the f32 decode kernel
           on every rank. (4) llama3.2:1b with int8 weights and bf16
           pages at pp 2: replies stop/length, exactly 8 x 2 bf16
           decode launches a step on each rank, no int8 kernel. (5)
           kill -9 of the last stage while 4 streams decode: every
           request errors within 18 s, /health 200 with worker_stale
           and the runtime failed. Besides: `python -m
           ollamamq_tpu_torch.cli --pp 2 --kv-dtype int8` exits 2 with
           the reference's message. Rank logs go to
           chiprun_out/chip_smoke/serve_pp_*.log.

  serve-dp data parallelism: llama3.2:1b at full width and depth
           (seeded), 8 slots and 136 pages of 32 a replica, 16 pages a
           sequence, token budget 512, k_steps 8. In one process, two
           replicas on cuda:0 (an in-process mesh, dp 2) and, in the same
           phase, one replica: serve's traffic doubled, 8 greedy
           /api/generate requests of 48 tokens from 5 users at once,
           after one warm-up. Gates (bf16, dp 2): every reply stop or
           length; each replica's kernel launches (the counters' deltas
           around its own dispatches) exactly 16 ragged per ragged
           dispatch and 16 decode per decode step, both > 0, no int8, and
           the replicas' launches sum to the window's; every placement
           the least-loaded eligible replica, ties rotating after the
           last pick, and both replicas placed on; the set's param_bytes
           and kv_bytes exactly twice one replica's and twice the dp-1
           engine's; a tick with both replicas decoding, and in every
           tick both decode dispatches before the first collect. float32
           (TF32 off): two prompts queued before the loop starts, one a
           replica, give each prompt's ids served alone by one replica;
           the decision journals hold no invariant violation (each slot
           record names its replica).
           Records tokens/s at dp 2 against dp 1 (not gated: both
           replicas share one card and one host thread). Then dp 2 x tp
           2 over four ranks (processes of this script, --tp-rank)
           sharing the card over gloo, float32: the two prompts, one a
           replica, give the one-replica ids; every rank launched both
           f32 kernels (each worker posts its counts after a replay);
           metrics_federated: rank 0's /metrics, scraped once the three
           other ranks' posted snapshots settled, equals the registry's
           render with them merged and counts their probe series 3; then
           4 streams of 96 tokens, 2 a replica, and kill -9 of rank
           3 (replica 1) once each holds 16 tokens: replica 1's requests
           error within 18 s, replica 0's finish, only replica 1 is
           failed, worker_stale fires. Rank logs go to
           chiprun_out/chip_smoke/serve_dp_*.log.
  serve-sp sequence parallelism: llama3.2:1b at full width and depth
           (seeded) over two sequence shards, ranks (processes of this
           script, --tp-rank) sharing cuda:0 over gloo; 8 slots, 640
           pages of 32, 272 pages a sequence, buckets 32/64/128/256,
           token budget 512, k_steps 8. One world of two ranks serves
           three windows (sessions of its wire, the kill last), a world
           of four one more: (1) bf16: two prompts of 8,000 token ids
           (/api/generate `context`; T 8,192, C 4,096 a shard) and two
           short chats from 3 users at once, 32 new tokens each; gates:
           every reply stop/length, rank 0 ran exactly 2 sp prefills in
           the burst and both ranks the same 3 over the window (one more
           8K prompt times TTFT), the short prompts on the ragged path,
           exactly 16 ragged launches per ragged dispatch and 16 decode
           per decode step on each rank and no int8 launch, both ranks'
           output digests equal, each rank's K and V at every real
           position of each long prompt, every layer, hashed bit-equal
           to rank 0's, every decode-kernel call on rank 0 (over those
           pages) within 2e-2 x max |plain| of the plain version on the
           same tensors. Records the 8K prompt's TTFT at sp 2 against
           one rank's chunked ragged prefill in the same process, the
           ring's hand-off ms and bytes per prefill, each rank's peak
           memory and tokens/s. (2) float32 (TF32 off): a ~5,000-id
           prompt with 32 greedy tokens at sp 2 and (3) at sp 2 x tp 2
           (four ranks) against one rank (the ragged path): ids
           identical, the sp prefill's logits within 1e-4 x max of the
           one rank's. (4) kill -9 of rank 1 after its first ring
           hand-off of an 8K prompt while two streams decode: every
           request errors within 18 s, /health 200 with worker_stale
           and the runtime failed. Besides: `python -m
           ollamamq_tpu_torch.cli --sp 2 --kv-dtype int8` exits 2 with
           the reference's message. Rank logs go to
           chiprun_out/chip_smoke/serve_sp_*.log.
  serve-ep expert parallelism: mixtral:8x7b at full width over two
           expert shards (four experts of every layer a rank, the rest
           replicated), ranks (processes of this script, --tp-rank)
           sharing cuda:0 over gloo, each registering the cut configs
           itself. One world of two ranks serves three windows, a world
           of four one more: (1) bf16, cut to 8 of 32 layers, seeded
           weights at ep 2 through the HTTP server, serve-moe's traffic
           (4 greedy /api/chat streams of 64 tokens from 3 users, then
           one prompt twice alone); gates: every reply stop/length, the
           repeat's ids identical, both ranks' output digests equal, both
           ranks' digests of layer 0's capacity-slot tensor over every
           forward equal, exactly 8 ragged launches per ragged dispatch
           and 8 decode per decode step on each rank and no int8
           launch, 12,470,329,344 weight bytes a rank (from the config's
           shapes), both ranks' whole K and V pools sha256-equal, every
           attention call of one prefill and one decode step on rank 0's
           shard within 2e-2 x max |plain|. Records tokens/s, TTFT p50,
           rank 0's FFN all_reduce ms a forward and its share (a burst
           of its own), each rank's decode step (its own experts, no
           collective) against its byte bound, each rank's peak memory.
           (2) float32 (TF32 off), cut to 2 layers: 4 greedy streams at
           ep 2 and (3) at ep 2 x tp 2 (four ranks) against one rank:
           ids identical, first logits within 1e-4 x max, the ep 2 x tp
           2 rank's bytes from the shapes. (4) kill -9 of rank 1 while 4
           streams decode (2 layers, bf16): every request errors within
           18 s, /health 200 with worker_stale. Besides: `python -m
           ollamamq_tpu_torch.cli` exits 2 before any device work for
           --ep 3, --ep 2 --pp 2 and --ep 2 --weights-dtype int8 on
           mixtral:8x7b. Rank logs go to
           chiprun_out/chip_smoke/serve_ep_*.log.

Then a timings line (each phase's seconds, and the run's since the
build began), the card as nvidia-smi names it, the kernels line (launches: the
serve window of the row's pool format plus serve-moe's, serve-durable's,
serve-fleet's, serve-tiers' (both windows, and the wide members'
worker ranks over their runs), serve-autoscale's, serve-ha's,
serve-tp's, serve-pp's, serve-dp's, serve-sp's and serve-ep's (every
rank of each window),
counted in
this process and in each server subprocess: a killed server's from its
/health read just before the SIGKILL, so the launches of those last few
ms go uncounted; the others' whole windows from the counts they log at
the end of their graceful exit), and the
last line {"ok": true, "device": {...}}. Without CUDA, or outside a checkout
of the repository, it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import dataclasses
import datetime
import gc
import gzip
import http.client
import json
import math
import os
import shutil
import signal
import subprocess
import sys
import threading
import time
import weakref

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12}
TOL = {"bfloat16": 2e-2, "float32": 1e-4}
# Kernel shapes timed with q in bf16 (the rest are checked, not timed).
TIMED_SHAPES = ("llama3.2:1b", "llama3:8b-attn", "llama3.2:1b-prefill512",
                "llama3.2:1b-serve8", "llama3:8b-tp2", "llama3.2:1b-tp2",
                "llama3:8b-pp2")
OUT_DIR = os.path.join("chiprun_out", "chip_smoke")
# Kernel -> (source, the TPU kernel it replaces, the serve phase whose
# window counts its launches).
KERNEL_ROWS = {
    "ragged_paged_attention": (
        "ollamamq_tpu_torch/csrc/ragged_paged_attention.cu",
        "ollamamq_tpu/ops/pallas/ragged_attention.py:259", "serve"),
    "paged_decode_attention": (
        "ollamamq_tpu_torch/csrc/paged_decode_attention.cu",
        "ollamamq_tpu/ops/pallas/paged_attention.py:229", "serve"),
    "ragged_paged_attention_int8": (
        "ollamamq_tpu_torch/csrc/ragged_paged_attention.cu",
        "ollamamq_tpu/ops/pallas/ragged_attention.py:259", "serve_int8"),
    "paged_decode_attention_int8": (
        "ollamamq_tpu_torch/csrc/paged_decode_attention.cu",
        "ollamamq_tpu/ops/pallas/paged_attention.py:229", "serve_int8"),
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device milliseconds of fn() over `iters` back-to-back calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int) -> float:
    """Mean device milliseconds of fn() over `iters` calls captured in one
    CUDA graph and replayed back to back: the calls' device time without
    the host's launch cost between them (which cuda_ms includes once a
    call takes less device time than its wrapper takes on the host)."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capture, as PyTorch asks
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / iters
    del graph
    return ms


def cold_l2_ms(fn, iters: int) -> float:
    """Mean device milliseconds of fn() with a cold L2: graph_ms of a
    read of 100 MB (twice the H100's 50 MB L2) followed by fn(), less
    graph_ms of the read alone. graph_ms replays the same call with its
    inputs left in L2; a serving step meets them after the weights'
    reads have passed through it."""
    import torch

    buf = torch.zeros(100 * 2**20 // 4, dtype=torch.float32, device="cuda")
    sink = torch.zeros((), dtype=torch.float32, device="cuda")

    def flush():
        torch.sum(buf, dim=0, out=sink)

    def flushed():
        flush()
        return fn()

    ms = graph_ms(flushed, iters) - graph_ms(flush, iters)
    del buf, sink
    return ms


# -- kernel cases ------------------------------------------------------------
def _pool(seed, contexts, Hk, hd, ps, MP, dtype, int8=False):
    """A paged pool holding `contexts[b]` written positions for sequence b
    (capped at MP * ps), pages shuffled across the pool. Every other slot,
    the trash page included, holds NaN; in an int8 pool (rows quantized
    by the port's kv_quantize) it holds payload 127 and a NaN scale.
    Returns (k, v, page_table) on the card, k and v tensors in `dtype` or
    QuantKV pools."""
    import torch

    from ollamamq_tpu_torch.ops.quant import QuantKV, kv_quantize

    g = torch.Generator().manual_seed(seed)
    cap = MP * ps
    contexts = [max(0, min(c, cap)) for c in contexts]  # positions written
    need = [-(-c // ps) for c in contexts]
    n_pages = sum(need) + 2
    perm = (torch.randperm(n_pages - 1, generator=g) + 1).tolist()
    k = torch.full((n_pages * ps, Hk, hd), float("nan"))
    v = torch.full_like(k, float("nan"))
    written = torch.zeros(n_pages * ps, dtype=torch.bool)
    pt = torch.zeros((len(contexts), MP), dtype=torch.int32)
    for b, (c, n) in enumerate(zip(contexts, need)):
        pages = [perm.pop() for _ in range(n)]
        pt[b, :n] = torch.tensor(pages, dtype=torch.int32)
        pos = torch.arange(c)
        slots = pt[b].long()[pos // ps] * ps + pos % ps
        k[slots] = torch.randn((len(pos), Hk, hd), generator=g)
        v[slots] = torch.randn((len(pos), Hk, hd), generator=g)
        written[slots] = True
    if not int8:
        return k.to("cuda", dtype), v.to("cuda", dtype), pt.cuda()
    pools = []
    for rows in (k, v):
        q, s = kv_quantize(torch.nan_to_num(rows))
        q[~written] = 127
        s[~written] = float("nan")
        pools.append(QuantKV(q.cuda(), s.cuda()))
    return pools[0], pools[1], pt.cuda()


def decode_case(name, seed, B, H, Hk, hd, ps, MP, seq_lens, dtype, int8=False):
    import torch

    k, v, pt = _pool(seed, seq_lens, Hk, hd, ps, MP, dtype, int8)
    g = torch.Generator().manual_seed(seed + 1)
    q = torch.randn((B, H, hd), generator=g).to("cuda", dtype)
    sl = torch.tensor(seq_lens, dtype=torch.int32, device="cuda")
    return dict(name=name, q=q, k=k, v=v, pt=pt, seq_lens=sl, ps=ps)


def ragged_case(name, seed, spans, B, T, H, Hk, hd, ps, MP, dtype, int8=False,
                pool=None):
    """spans: [(q_len, kv_len)] contiguous in stream order; sequences past
    the spans are padding rows, stream rows past them are covered by no
    span. `pool` (k, v, page_table) replaces the default pool."""
    import torch

    contexts = [kv for _, kv in spans] + [0] * (B - len(spans))
    k, v, pt = pool or _pool(seed, contexts, Hk, hd, ps, MP, dtype, int8)
    g = torch.Generator().manual_seed(seed + 1)
    q = torch.randn((T, H, hd), generator=g).to("cuda", dtype)
    q_start = torch.full((B,), T, dtype=torch.int32)
    q_len = torch.zeros(B, dtype=torch.int32)
    kv_len = torch.zeros(B, dtype=torch.int32)
    off = 0
    for i, (ql, kv) in enumerate(spans):
        q_start[i], q_len[i], kv_len[i] = off, ql, kv
        off += ql
    assert off <= T, name
    return dict(name=name, q=q, k=k, v=v, pt=pt, q_start=q_start.cuda(),
                q_len=q_len.cuda(), kv_len=kv_len.cuda(), ps=ps, T_real=off)


def prefix_hit_case(name, seed, dtype, int8=False):
    """Prefix-cache hit spans at the llama3.2:1b attention shape: row 0
    decodes at context 300 over its own 10 pages; rows 1 and 2 are spans
    starting at the page boundaries 128 and 256 whose first 4 and 8 pages
    ARE row 0's (shared, read by three rows of one call) and whose tails
    are private; row 3 is a 1 + 4 verify span over the same shared pages."""
    import torch

    ps, MP = 32, 16
    k, v, pt = _pool(seed, [300, 40, 70, 13, 0, 0], 8, 64, ps, MP, dtype, int8)
    shared = pt.clone()
    for row, n_shared, n_tail in ((1, 4, 2), (2, 8, 3), (3, 4, 1)):
        own = pt[row, :n_tail].clone()
        shared[row] = 0
        shared[row, :n_shared] = pt[0, :n_shared]
        shared[row, n_shared:n_shared + n_tail] = own
    spans = [(1, 300), (40, 168), (70, 326), (5, 141)]
    return ragged_case(name, seed, spans, 6, 128, 32, 8, 64, ps, MP, dtype, int8,
                       pool=(k, v, shared))


def _is_int8(c) -> bool:
    from ollamamq_tpu_torch.ops.quant import QuantKV

    return isinstance(c["k"], QuantKV)


def _decode_calls(c):
    from ollamamq_tpu_torch.ops.attention import paged_decode_attention
    from ollamamq_tpu_torch.ops.cuda import paged_attention as pa

    kern = (pa.paged_decode_attention_int8_cuda if _is_int8(c)
            else pa.paged_decode_attention_cuda)
    args = (c["q"], c["k"], c["v"], c["pt"], c["seq_lens"], c["ps"])
    return (lambda: kern(*args), lambda: paged_decode_attention(*args))


def _ragged_calls(c):
    from ollamamq_tpu_torch.ops.attention import ragged_paged_attention, ragged_tokens
    from ollamamq_tpu_torch.ops.cuda import ragged_attention as ra

    kern = (ra.ragged_paged_attention_int8_cuda if _is_int8(c)
            else ra.ragged_paged_attention_cuda)
    tok_seq, tok_pos = ragged_tokens(c["q_start"], c["q_len"], c["kv_len"],
                                     c["q"].shape[0])
    c["tok_pos"] = tok_pos
    return (lambda: kern(c["q"], c["k"], c["v"], c["pt"], c["q_start"],
                         c["q_len"], c["kv_len"], c["ps"]),
            lambda: ragged_paged_attention(
                c["q"], c["k"], c["v"], c["pt"], tok_seq, tok_pos,
                c["kv_len"], c["ps"]))


def _visible(c, kind):
    """Per query row, how many context positions it attends (capped)."""
    import torch

    cap = c["pt"].shape[1] * c["ps"]
    if kind == "decode":
        return c["seq_lens"].clamp(0, cap)
    n = torch.where(c["tok_pos"] >= 0, c["tok_pos"] + 1, torch.zeros_like(c["tok_pos"]))
    return n.clamp(0, cap)


def bound(c, kind, dtype_name):
    """(bound_ms, bound_by): the larger of the bytes the call must move
    (q, out and metadata once; each sequence's visible K/V rows once: hd
    elements of the pool's own size per (row, kv head), plus a 4-byte f32
    scale in an int8 pool) over HBM bandwidth and its attention FLOPs (QK
    and PV, 4 per head-dim element per visible position) over q's
    dtype's peak (an int8 pool is dequantized to q's dtype before the
    math)."""
    q, k = c["q"], c["k"]
    isz = q.element_size()
    N, H, hd = q.shape
    Hk = k.shape[1]
    row_head_bytes = hd + 4 if _is_int8(c) else hd * k.element_size()
    cap = c["pt"].shape[1] * c["ps"]
    if kind == "decode":
        kv_rows = int(c["seq_lens"].clamp(0, cap).sum())
        meta = c["pt"].numel() * 4 + c["seq_lens"].numel() * 4
    else:
        kv_rows = int(c["kv_len"].clamp(0, cap).sum())
        meta = c["pt"].numel() * 4 + 3 * c["kv_len"].numel() * 4
    nbytes = 2 * q.numel() * isz + 2 * kv_rows * Hk * row_head_bytes + meta
    flops = 4.0 * float(_visible(c, kind).sum()) * H * hd
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def kv_positions(c):
    """K/V positions loaded per kv head at this ragged case: by a kernel
    that reads each row's visible prefix per stream row (the float32-q
    kernel), by the bf16-q kernel that reads each query tile's deepest
    frontier once (its launch plan's QT), and the distinct positions."""
    from ollamamq_tpu_torch.ops.cuda.ragged_attention import launch_plan

    T, H, hd = c["q"].shape
    qt = launch_plan(H, c["k"].shape[1], hd, _is_int8(c)).q_tile
    cap = c["pt"].shape[1] * c["ps"]
    per_tile = 0
    for ql, kv in zip(c["q_len"].tolist(), c["kv_len"].tolist()):
        for first in range(0, ql, qt):
            last = min(first + qt, ql) - 1
            per_tile += max(0, min(kv - ql + last + 1, kv, cap))
    return {"kv_positions_per_row": int(_visible(c, "ragged").sum()),
            "kv_positions_per_tile": per_tile,
            "kv_positions_distinct": int(c["kv_len"].clamp(0, cap).sum())}


def decode_blocks(c):
    """The bf16 decode kernel's split count and the split blocks that
    have work at this decode case (its launch plan)."""
    from ollamamq_tpu_torch.ops.cuda.paged_attention import decode_launch_plan

    B, H, hd = c["q"].shape
    Hk, MP = c["k"].shape[1], c["pt"].shape[1]
    plan = decode_launch_plan(H, Hk, hd, c["ps"], MP, _is_int8(c))
    n = c["seq_lens"].clamp(0, MP * c["ps"]).tolist()
    return {"split": plan.split, "n_splits": plan.n_splits,
            "grid_blocks": plan.n_splits * Hk * B,
            "blocks_with_work": Hk * sum(plan.splits_with_work(x) for x in n)}


def sdpa_dense(c, kind):
    """F.scaled_dot_product_attention over K/V pre-gathered into dense
    per-sequence tensors in q's dtype (GQA heads expanded; an int8 pool
    dequantized first): a yardstick only, the gather is not timed and the
    port never calls it."""
    import torch
    import torch.nn.functional as F

    from ollamamq_tpu_torch.ops.quant import kv_gather

    q, k, v, pt, ps = c["q"], c["k"], c["v"], c["pt"], c["ps"]
    H, hd = q.shape[1], q.shape[2]
    G = H // k.shape[1]
    cap = pt.shape[1] * ps
    pos = torch.arange(cap, device="cuda")
    slots = pt.long()[:, pos // ps] * ps + pos % ps  # [B, cap]

    def dense(pool):
        rows = torch.nan_to_num(kv_gather(pool, slots)).to(q.dtype)
        return rows.transpose(1, 2).repeat_interleave(G, dim=1)

    kd, vd = dense(k), dense(v)
    if kind == "decode":
        qd = q[:, :, None, :]
        mask = (pos[None, :] < c["seq_lens"][:, None])[:, None, None, :]
    else:
        live = (c["q_len"] > 0).nonzero().flatten()
        maxq = int(c["q_len"].max())
        qs, ql, kl = c["q_start"][live], c["q_len"][live], c["kv_len"][live]
        rows = (qs[:, None] + torch.arange(maxq, device="cuda")[None, :]).clamp_max(q.shape[0] - 1)
        qd = q[rows.long()].transpose(1, 2)  # [n, H, maxq, hd]
        kd, vd = kd[live], vd[live]
        qpos = (kl - ql)[:, None] + torch.arange(maxq, device="cuda")[None, :]
        mask = (pos[None, None, :] <= qpos[:, :, None]) & (pos[None, None, :] < kl[:, None, None])
        mask = mask | (pos[None, None, :] == 0)  # keep padded query rows finite
        mask = mask[:, None]
    return lambda: F.scaled_dot_product_attention(qd, kd, vd, attn_mask=mask)


def timed_cases(dtype, int8):
    """(kind, case) pairs at the timed shapes (TIMED_SHAPES)."""
    import random

    rnd = random.Random(0)
    ctx64 = [rnd.randint(1, 512) for _ in range(64)]
    decode_spans = [(1, rnd.randint(1, 512)) for _ in range(48)]
    mixed = decode_spans + [(128, 128), (96, 352), (32, 32)]  # 304 rows
    ctx8 = [rnd.randint(20, 140) for _ in range(8)]  # a serving decode step
    ctx_pp = [rnd.randint(100, 360) for _ in range(4)]
    d = dict(dtype=dtype, int8=int8)
    return [
        ("decode", decode_case("llama3.2:1b", 1, 64, 32, 8, 64, 32, 16, ctx64, **d)),
        ("decode", decode_case("llama3:8b-attn", 3, 64, 32, 8, 128, 32, 16, ctx64, **d)),
        ("ragged", ragged_case("llama3.2:1b", 2, mixed, 64, 320, 32, 8, 64, 32, 16, **d)),
        ("ragged", ragged_case("llama3:8b-attn", 4, mixed, 64, 320, 32, 8, 128, 32, 16, **d)),
        ("ragged", ragged_case("llama3.2:1b-prefill512", 22, [(512, 512)], 8, 512, 32, 8, 64, 32, 16, **d)),
        ("decode", decode_case("llama3.2:1b-serve8", 31, 8, 32, 8, 64, 32, 16, ctx8, **d)),
        # One rank's heads at tensor-parallel width 2 (serve-tp): 16 query
        # heads over 4 KV heads, group 4 as at tp 1.
        ("decode", decode_case("llama3:8b-tp2", 36, 64, 16, 4, 128, 32, 16, ctx64, **d)),
        ("ragged", ragged_case("llama3:8b-tp2", 37, mixed, 64, 320, 16, 4, 128, 32, 16, **d)),
        ("decode", decode_case("llama3.2:1b-tp2", 38, 64, 16, 4, 64, 32, 16, ctx64, **d)),
        ("ragged", ragged_case("llama3.2:1b-tp2", 39, mixed, 64, 320, 16, 4, 64, 32, 16, **d)),
        # One microbatch of a pipeline stage's decode call (serve-pp:
        # llama3:8b, 8 slots in 2 microbatches of 4 rows, 24 pages a
        # sequence), contexts of a serving step.
        ("decode", decode_case("llama3:8b-pp2", 40, 4, 32, 8, 128, 32, 24, ctx_pp, **d)),
    ]


def kernel_cases(dtype, int8):
    """(kind, case) pairs: the timed shapes first, then edge cases."""
    from ollamamq_tpu_torch.ops.cuda.paged_attention import decode_launch_plan

    d = dict(dtype=dtype, int8=int8)
    S = decode_launch_plan(32, 8, 64, 8, 40, int8).split  # the decode kernel's split
    edges = [S - 1, S, S + 1, 2 * S + 3]
    two = (2 * S + 64) // 16  # pages of 16 past two splits
    return timed_cases(dtype, int8) + [
        ("decode", decode_case("gqa-a", 5, 3, 8, 4, 32, 8, 6, [20, 9, 37], **d)),
        ("decode", decode_case("gqa-b", 6, 3, 8, 4, 32, 8, 6, [1, 48, 16], **d)),
        ("decode", decode_case("mqa", 7, 2, 4, 1, 16, 8, 4, [8, 25], **d)),
        ("decode", decode_case("group1", 8, 2, 4, 4, 64, 8, 4, [5, 30], **d)),
        ("decode", decode_case("past-cap+empty", 9, 3, 8, 2, 32, 8, 4, [40, 0, 33], **d)),
        ("ragged", ragged_case("mixed", 10, [(11, 11), (1, 20), (5, 29), (1, 1)], 10, 40, 4, 2, 16, 8, 8, **d)),
        ("ragged", ragged_case("decode-tile", 11, [(1, 5 + 3 * i) for i in range(9)], 10, 40, 4, 2, 16, 8, 8, **d)),
        ("ragged", ragged_case("long-prefill", 12, [(21, 21), (1, 9), (1, 17), (3, 30)], 10, 40, 4, 2, 16, 8, 8, **d)),
        ("ragged", ragged_case("mqa", 13, [(6, 6), (1, 12)], 3, 8, 4, 1, 16, 8, 8, **d)),
        ("ragged", ragged_case("group1", 14, [(6, 6), (1, 12)], 3, 8, 4, 4, 16, 8, 8, **d)),
        ("ragged", ragged_case("past-cap", 15, [(3, 40), (1, 33)], 4, 6, 8, 2, 32, 8, 4, **d)),
        # Edges of the query tiling (QT = 16 at group 4, 21 at group 3,
        # 9 at group 7): a span starting mid-page after prior context,
        # spans of QT, QT + 1 and 2 QT + 3 rows, long tail padding with
        # padding sequences, a prefill whose frontier passes the cap.
        ("ragged", ragged_case("mid-page", 16, [(37, 82), (1, 30), (5, 13)], 4, 48, 32, 8, 64, 8, 12, **d)),
        ("ragged", ragged_case("qt-edges", 17, [(16, 16), (17, 50), (35, 90), (1, 7)], 6, 72, 32, 8, 64, 16, 8, **d)),
        ("ragged", ragged_case("group3", 18, [(21, 21), (22, 60), (45, 100), (1, 33)], 6, 96, 24, 8, 128, 16, 8, **d)),
        ("ragged", ragged_case("group7", 19, [(9, 9), (10, 40), (21, 70), (1, 12)], 6, 48, 28, 4, 128, 16, 8, **d)),
        ("ragged", ragged_case("tail-pad", 20, [(5, 20), (1, 9), (12, 12)], 8, 64, 8, 2, 32, 8, 4, **d)),
        ("ragged", ragged_case("prefill-past-cap", 21, [(24, 40), (12, 60), (1, 70)], 4, 40, 8, 2, 32, 8, 4, **d)),
        # Edges of the decode kernel's split over the context: contexts
        # around one and two splits, one sequence alone, a context past
        # max_pages beside empty and negative ones, the GQA groups of
        # llama3.2:3b and qwen2.5:7b, MQA and group 1 over several splits.
        ("decode", decode_case("split-edges-ps8", 23, 4, 32, 8, 64, 8, -(-edges[-1] // 8) + 1, edges, **d)),
        ("decode", decode_case("split-edges-ps16", 24, 4, 32, 8, 64, 16, -(-edges[-1] // 16) + 1, edges, **d)),
        ("decode", decode_case("alone-512", 25, 1, 32, 8, 64, 32, 16, [512], **d)),
        ("decode", decode_case("past-cap+zero", 26, 4, 32, 8, 64, 16, (S + 64) // 16, [S + 200, 0, -3, S // 2 + 20], **d)),
        ("decode", decode_case("group3-hd128", 27, 3, 24, 8, 128, 16, two, [5, S + 72, 2 * S + 44], **d)),
        ("decode", decode_case("group7-hd128", 28, 3, 28, 4, 128, 16, two, [S + 2, 1, 2 * S], **d)),
        ("decode", decode_case("mqa-split", 29, 3, 8, 1, 64, 16, two, [77, 2 * S + 4, S + 1], **d)),
        ("decode", decode_case("group1-split", 30, 3, 8, 8, 128, 16, two, [2 * S, 3, S + 72], **d)),
        # Span shapes the page lifecycle brings to the serve path, at the
        # llama3.2:1b attention shape: speculative verify spans (1 + 4
        # rows whose positions cross a page boundary, then 1 + d beside
        # decode rows and a prefill span), prefix-hit spans over pages
        # other rows of the call read too, and a decode call after a
        # rollback (contexts at and one past page multiples, their
        # freed tail entries the trash page, whose slots hold NaN).
        ("ragged", ragged_case("verify-spans", 32, [(5, kv) for kv in (36, 100, 130, 194, 260, 322, 418, 484)],
                               8, 40, 32, 8, 64, 32, 16, **d)),
        ("ragged", ragged_case("verify-mixed", 33, [(1, 77), (2, 64), (3, 97), (4, 250), (5, 33), (1, 5), (48, 48)],
                               8, 80, 32, 8, 64, 32, 16, **d)),
        ("ragged", prefix_hit_case("prefix-hit", 34, **d)),
        ("decode", decode_case("post-rollback", 35, 8, 32, 8, 64, 32, 16, [32, 33, 64, 65, 96, 97, 128, 129], **d)),
    ]


def decode_plan_phase(report) -> None:
    """Each bf16-q decode entry point refuses a launch plan that differs
    from decode_launch_plan in any one of its five numbers
    (cudaErrorInvalidValue, 1), called directly at the llama3.2:1b shape;
    a refused call launches nothing, and no wrapper counts it."""
    import torch

    from ollamamq_tpu_torch.ops.cuda import DTYPE_CODES, build
    from ollamamq_tpu_torch.ops.cuda.paged_attention import decode_launch_plan

    for int8 in (False, True):
        kind, c = timed_cases(torch.bfloat16, int8)[0]
        assert kind == "decode" and c["name"] == "llama3.2:1b"
        B, H, hd = c["q"].shape
        Hk, MP = c["k"].shape[1], c["pt"].shape[1]
        plan = decode_launch_plan(H, Hk, hd, c["ps"], MP, int8)
        good = [plan.split, plan.kv_tile, plan.threads, plan.smem_bytes, plan.n_splits]
        scratch = torch.empty(plan.scratch_shape(B), dtype=torch.float32, device="cuda")
        out = torch.empty_like(c["q"])
        pools = (c["k"].q, c["v"].q, c["k"].s, c["v"].s) if int8 else (c["k"], c["v"])
        name = "paged_decode_attention" + ("_int8" if int8 else "")
        fn = build.kernel_fn(name)
        refused = {}
        for i, field in enumerate(("split", "kv_tile", "threads", "smem_bytes", "n_splits")):
            bad = list(good)
            bad[i] += 1 if field == "n_splits" else 64
            refused[field] = fn(c["q"].data_ptr(), *(t.data_ptr() for t in pools),
                                c["pt"].data_ptr(), c["seq_lens"].data_ptr(), out.data_ptr(),
                                scratch.data_ptr(), B, H, Hk, hd, c["ps"], MP, *bad,
                                DTYPE_CODES[torch.bfloat16],
                                torch.cuda.current_stream().cuda_stream)
        torch.cuda.synchronize()
        line = {"phase": "decode-plan", "kernel": name, "plan": good, "rc": refused,
                "ok": all(rc == 1 for rc in refused.values())}
        emit(line)
        report["decode_plan"].append(line)
        if not line["ok"]:
            raise SystemExit(f"a decode entry point took a plan not its own: {line}")


def kernel_phase(report) -> None:
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    bf16, f32 = torch.bfloat16, torch.float32

    summary = {name: {} for name in KERNEL_ROWS}
    for int8 in (False, True):
        for dtype in (bf16, f32):
            dname = str(dtype).replace("torch.", "")
            tol = TOL[dname]
            flat = kernel_cases(dtype, int8)
            for kind, c in flat:
                shape_name = c["name"]
                kern, plain = (_decode_calls if kind == "decode" else _ragged_calls)(c)
                out = kern()
                ref = plain()
                torch.cuda.synchronize()
                err = float((out.float() - ref.float()).abs().max())
                ok = bool(torch.isfinite(out).all()) and torch.allclose(
                    out.float(), ref.float(), rtol=tol, atol=tol)
                if kind == "ragged":
                    pad = c["tok_pos"] < 0
                    ok = ok and bool((out[pad] == 0).all())
                else:  # nothing visible: exact zeros
                    ok = ok and bool((out[c["seq_lens"] <= 0] == 0).all())
                name = ("paged_decode_attention" if kind == "decode"
                        else "ragged_paged_attention") + ("_int8" if int8 else "")
                line = {"phase": "kernels", "kernel": name, "case": shape_name,
                        "dtype": dname, "pool": "int8" if int8 else dname,
                        "tol": tol, "max_abs_err": err, "ok": ok}
                if kind == "decode" and dtype == bf16:
                    line.update(decode_blocks(c))
                if shape_name in TIMED_SHAPES and dtype == bf16:
                    sdpa = sdpa_dense(c, kind)
                    line["kernel_ms"] = graph_ms(kern, 50)
                    line["kernel_eager_ms"] = cuda_ms(kern, 50)
                    if kind == "decode":
                        line["kernel_cold_l2_ms"] = cold_l2_ms(kern, 20)
                    line["plain_ms"] = cuda_ms(plain, 5, warmup=1)
                    line["sdpa_dense_ms"] = graph_ms(sdpa, 50)
                    line["sdpa_dense_eager_ms"] = cuda_ms(sdpa, 50)
                    line["bound_ms"], line["bound_by"] = bound(c, kind, dname)
                    if kind == "ragged":
                        line["rows"] = int(c["q"].shape[0])
                        line["rows_in_spans"] = c["T_real"]
                        line.update(kv_positions(c))
                    summary[name][shape_name] = line
                emit(line)
                report["kernels"].append(line)
                if not ok:
                    raise SystemExit(f"kernel mismatch: {line}")
                del out, ref
            del flat
            torch.cuda.empty_cache()
    report["kernel_summary"] = summary


# -- serving -----------------------------------------------------------------
def _post(port, path, body, user, timeout=600):
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    c.request("POST", path, json.dumps(body), {"X-User-ID": user,
                                               "Content-Type": "application/json"})
    r = c.getresponse()
    data = r.read()
    c.close()
    if r.status != 200:
        raise RuntimeError(f"{path} as {user}: HTTP {r.status} {data[:300]!r}")
    return r.getheader("Content-Type"), data


def _ollama_result(ctype, data):
    """(token ids, done_reason) from an Ollama JSON or NDJSON reply."""
    if ctype == "application/x-ndjson":
        frames = [json.loads(x) for x in data.decode().splitlines()]
        ids = [t for f in frames for t in f.get("token_ids", [])]
        last = frames[-1]
    else:
        last = json.loads(data)
        ids = last["token_ids"]
    if not last.get("done") or "error" in last:
        raise RuntimeError(f"stream did not finish cleanly: {last}")
    return ids, last["done_reason"]


def serve_phase(report, profile: bool, int8: bool = False) -> None:
    """Serve llama3.2:1b at full width through the HTTP server and check
    replies, greedy determinism, which kernels the window launched and
    the kernel path's logits. int8=True serves int8 weights and int8 KV
    pages and runs after the bf16 phase, whose engine must be gone."""
    import torch

    from ollamamq_tpu_torch.config import EngineConfig
    from ollamamq_tpu_torch.engine.engine import TorchEngine
    from ollamamq_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from ollamamq_tpu_torch.server.app import serve_in_thread, stop_server

    model = "llama3.2:1b"
    quant = "int8" if int8 else "bfloat16"
    phase = "serve-int8" if int8 else "serve"
    suffix = "_int8" if int8 else ""
    ecfg = EngineConfig(model=model, max_slots=8, num_pages=8 * 16 + 8,
                        page_size=32, max_pages_per_seq=16,
                        max_batch_tokens=512, token_granule=16,
                        max_new_tokens=48, decode_steps_per_iter=8,
                        dtype="bfloat16", weights_dtype=quant, kv_dtype=quant,
                        seed=0)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    engine = TorchEngine(ecfg)  # the CUDA device: the entry point's default
    torch.cuda.synchronize()
    init_s = time.monotonic() - t0
    init_peak = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    rt = engine.runtimes[model]
    srv = serve_in_thread(engine, port=0, timeout_s=600)
    port = srv.server_address[1]
    text = ("The quick brown fox jumps over the lazy dog while the scheduler "
            "keeps every user's queue fair. ")
    greedy = {"temperature": 0, "num_predict": 32}
    jobs = {
        "alice/generate": ("/api/generate", "alice",
                           {"model": model, "prompt": text * 2, "stream": False,
                            "options": greedy}),
        "bob/chat-stream": ("/api/chat", "bob",
                            {"model": model, "options": greedy, "messages": [
                                {"role": "user", "content": text}]}),
        "carol/openai": ("/v1/chat/completions", "carol",
                         {"model": model, "max_tokens": 32, "temperature": 0,
                          "messages": [{"role": "user", "content": text[:60]}]}),
        "carol/sampled": ("/api/generate", "carol",
                          {"model": model, "prompt": text * 3, "stream": False,
                           "options": {"temperature": 0.8, "top_k": 40,
                                       "top_p": 0.9, "seed": 7,
                                       "repeat_penalty": 1.1,
                                       "num_predict": 32}}),
    }
    results, errors = {}, []

    def run(name):
        path, user, body = jobs[name]
        try:
            results[name] = _post(port, path, body, user)
        except Exception as e:  # noqa: BLE001 — reported, then fails the phase
            errors.append(f"{name}: {e}")

    before = dict(rt.stats())
    reset_launch_counts()
    t_serve = time.monotonic()
    threads = [threading.Thread(target=run, args=(n,)) for n in jobs]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    # The same greedy prompt twice more, each alone: identical tokens.
    repeat = []
    for _ in range(2):
        ctype, data = _post(port, "/api/generate", jobs["alice/generate"][2], "alice")
        repeat.append(_ollama_result(ctype, data)[0])
    counts = launch_counts()
    serve_s = time.monotonic() - t_serve
    after = dict(rt.stats())
    window_peak = torch.cuda.max_memory_allocated()
    prof = None
    if profile:
        prof = profile_window(port, model, text, rt)
    stop_server(srv)
    if errors or len(results) != len(jobs):
        raise SystemExit(f"serve requests failed: {errors}")

    replies = {}
    for name, (ctype, data) in results.items():
        if name == "carol/openai":
            body = json.loads(data)
            n = body["usage"]["completion_tokens"]
            replies[name] = {"tokens": n, "done_reason": body["choices"][0]["finish_reason"]}
        else:
            ids, reason = _ollama_result(ctype, data)
            n = len(ids)
            replies[name] = {"tokens": n, "done_reason": reason}
        if n <= 0 or replies[name]["done_reason"] not in ("stop", "length"):
            raise SystemExit(f"{name}: no tokens or no done reason: {replies[name]}")
    deterministic = repeat[0] == repeat[1] and len(repeat[0]) > 0
    ragged = after["ragged_dispatches"] - before["ragged_dispatches"]
    steps = after["decode_steps"] - before["decode_steps"]
    tokens = after["tokens_generated"] - before["tokens_generated"]
    own = ("ragged_paged_attention" + suffix, "paged_decode_attention" + suffix)
    line = {"phase": phase, "model": model, "layers": rt.cfg.num_layers,
            "dtype": "bfloat16", "weights_dtype": rt.weights_dtype,
            "kv_dtype": rt.kv_dtype, "init_s": init_s, "serve_s": serve_s,
            "requests": len(jobs) + 2, "users": 3, "tokens": tokens,
            "tokens_per_s": tokens / serve_s, "replies": replies,
            "greedy_repeat_identical": deterministic,
            "ragged_dispatches": ragged, "decode_steps": steps,
            "decode_dispatches": after["decode_dispatches"] - before["decode_dispatches"],
            "launches": counts,
            "launches_per_ragged_dispatch": counts[own[0]] / max(1, ragged),
            "launches_per_decode_step": counts[own[1]] / max(1, steps),
            "param_bytes": rt.param_bytes, "kv_bytes": rt.kv_bytes,
            "init_max_memory_allocated": init_peak,
            "max_memory_allocated": window_peak}
    if int8:
        hd = rt.cfg.head_dim
        line["kv_bytes_vs_bf16"] = rt.kv_bytes / report["serve"]["kv_bytes"]
        line["kv_bytes_vs_bf16_limit"] = (hd + 4) / (2 * hd) + 0.01
        line["param_bytes_vs_bf16"] = rt.param_bytes / report["serve"]["param_bytes"]
        line["tokens_per_s_vs_bf16"] = line["tokens_per_s"] / report["serve"]["tokens_per_s"]
    if prof is not None:
        line["profile"] = prof
    emit(line)
    report[phase.replace("-", "_")] = line
    if not deterministic:
        raise SystemExit(f"greedy repeat differs: {repeat}")
    # The window ran this phase's two kernels and none of the others.
    if any(counts[k] <= 0 for k in own) or any(
            counts[k] != 0 for k in counts if k not in own):
        raise SystemExit(f"{phase}: the window did not launch exactly {own}: {counts}")
    if int8 and line["kv_bytes_vs_bf16"] > line["kv_bytes_vs_bf16_limit"]:
        raise SystemExit(f"int8 KV pool did not shrink enough: {line}")

    kernel_vs_plain_logits(report, phase, rt, text, quant)


def kernel_vs_plain_logits(report, phase, rt, text, quant, per_call=False,
                           tp=1, ep=None) -> None:
    """One prompt's prefill and first decode step through the kernels vs
    the plain attention path, on the serving weights (outside the counted
    window): logits within TOL["bfloat16"] of the plain path's max.

    per_call=True (an MoE model) gates each attention call of the kernel
    run instead, against the plain version on the same q and pools: the
    end-to-end logits are recorded, not gated, because a bf16 rounding
    difference can flip a near-tie of the router's top-k in some layer
    and then that token's FFN output differs by a whole expert. The
    routing decisions that differ between the two runs are counted.

    tp > 1: `rt` holds rank 0's slice of a tp-way mesh; the forwards run
    on that slice alone (no collectives, pools of its own KV heads), so
    each attention call sees the rank's own q and pools at the TP-local
    head counts. Only the per-call check means anything there; so too for
    a pipeline stage's `rt`, whose layers are the stage's own (one call
    per layer it holds), and for an expert rank's (`ep`: its
    ExpertGroup with no process group, so its MoE layers run its own
    experts)."""
    import torch

    from ollamamq_tpu_torch.config import EngineConfig
    from ollamamq_tpu_torch.engine import kv_cache as kvc
    from ollamamq_tpu_torch.models import llama, moe

    model, ecfg = rt.name, rt.ecfg
    cfg, ps = rt.cfg, ecfg.page_size
    n = 77
    prompt = torch.tensor(rt.tokenizer.encode(text)[:n], dtype=torch.int32, device="cuda")
    T = 80
    small = EngineConfig(model=model, num_pages=5, page_size=ps, max_pages_per_seq=4)
    pt = torch.tensor([[1, 2, 3, 4]], dtype=torch.int32, device="cuda")
    tokens = torch.zeros(T, dtype=torch.int32, device="cuda")
    tokens[:n] = prompt
    tok_pos = torch.full((T,), -1, dtype=torch.int32, device="cuda")
    tok_pos[:n] = torch.arange(n, dtype=torch.int32, device="cuda")
    tok_seq = torch.zeros(T, dtype=torch.int32, device="cuda")
    ws = torch.where(tok_pos >= 0, pt[0, (tok_pos.clamp_min(0) // ps).long()] * ps
                     + tok_pos.clamp_min(0) % ps, torch.zeros_like(tok_pos))
    meta = [torch.tensor([v], dtype=torch.int32, device="cuda") for v in (0, n, n)]
    logits, calls, routes = {}, {"ragged": [], "decode": []}, {}
    dispatch = (llama.ragged_attention_any, llama.paged_decode_attention_any)

    def beside_plain(orig, kind):
        def attend(impl, *args):
            out = orig(impl, *args)
            ref = orig("plain", *args)
            scale = float(ref.float().abs().max())
            err = float((out.float() - ref.float()).abs().max())
            calls[kind].append((err, scale, bool(torch.isfinite(out).all())))
            return out
        return attend

    route = moe.route
    for impl in ("kernel", "plain"):
        routes[impl] = []

        def recorded(*args, log=routes[impl]):
            out = route(*args)
            log.append(out[1].reshape(-1, out[1].shape[-1]))
            return out

        if per_call:
            moe.route = recorded
        if per_call and impl == "kernel":
            llama.ragged_attention_any = beside_plain(dispatch[0], "ragged")
            llama.paged_decode_attention_any = beside_plain(dispatch[1], "decode")
        try:
            kc, vc = kvc.alloc_kv_pool(cfg, small, torch.bfloat16, "cuda", kv_dtype=quant,
                                       tp=tp)
            pre, _, _ = llama.forward_ragged(
                rt.params, cfg, tokens, tok_seq, tok_pos, ws,
                torch.tensor([n - 1], device="cuda"), kc, vc, pt, *meta, ps,
                attn_impl=impl, ep=ep)
            nxt = pre.argmax(-1).to(torch.int32)
            dec, _, _ = llama.forward_decode(
                rt.params, cfg, nxt, torch.tensor([n], dtype=torch.int32, device="cuda"),
                kc, vc, pt, ps, attn_impl=impl, ep=ep)
        finally:
            moe.route = route
            llama.ragged_attention_any, llama.paged_decode_attention_any = dispatch
        logits[impl] = (pre, dec)
        del kc, vc
    torch.cuda.synchronize()
    checks = {}
    for i, what in enumerate(("prefill", "decode")):
        got, ref = logits["kernel"][i], logits["plain"][i]
        scale = float(ref.abs().max())
        err = float((got - ref).abs().max())
        checks[what] = {"max_abs_err": err, "ref_max_abs": scale,
                        "rel_err": err / scale,
                        "top1_equal": bool((got.argmax(-1) == ref.argmax(-1)).all()),
                        "ok": bool(torch.isfinite(got).all()) and err <= TOL["bfloat16"] * scale}
    line = {"phase": phase + "-logits", "model": model, "tokens": n,
            "weights_dtype": quant, "kv_dtype": quant,
            "tol": f"max |kernel - plain| <= {TOL['bfloat16']} * max |plain|",
            **checks}
    gated = [] if per_call else list(checks.values())
    if per_call:
        for kind, got in calls.items():
            c = {"calls": len(got),
                 "max_rel_err": max((e / s for e, s, _ in got), default=None),
                 "ok": len(got) == len(rt.params["layers"]) and all(
                     fin and e <= TOL["bfloat16"] * s for e, s, fin in got)}
            line[f"{kind}_per_call"] = c
            gated.append(c)
        # Real rows only: the prompt's n rows at each prefill layer, row 0
        # at each decode layer.
        L = len(rt.params["layers"])
        line["routing_rows_differing"] = [
            int((a[:n if j < L else 1] != b[:n if j < L else 1])
                .any(-1).sum())
            for j, (a, b) in enumerate(zip(routes["kernel"], routes["plain"]))]
        line["gated"] = "per_call"
    emit(line)
    report[phase.replace("-", "_") + "_logits"] = line
    if not all(c["ok"] for c in gated):
        raise SystemExit(f"kernel path disagrees with the plain path: {line}")


def _first_diff(a, b):
    """Index of the first token where two id streams differ, else None."""
    for i, (x, y) in enumerate(zip(a, b)):
        if x != y:
            return i
    return None if len(a) == len(b) else min(len(a), len(b))


def serve_runtime_phase(report) -> None:
    """llama3.2:1b at full width in bf16 through the HTTP server with the
    prefix cache, speculation (k 4) and default preemption on a pool too
    small for the traffic, and one injected ragged fault. A warm request
    (system prefix + tail) runs first and takes the fault: it is retried
    once and its finished prompt pages seed the tree. Then 8 requests at
    once: 6 users sharing the 4-page system prefix, a repeated pattern
    (drafts verify) and a sampled request (never speculates). Gates: every
    reply ends stop/length; preemptions >= 1, prefix hits >= 1, accepted
    drafts >= 1, exactly one retry; afterwards no page is used and the
    tree's invariants hold; the window launched both bf16 kernels and no
    int8 entry point. Each reply's first token differing from the same
    request served alone (cache, spec and pressure off) is printed, not
    gated: bf16 rounding differs between batch shapes."""
    import torch

    from ollamamq_tpu_torch.config import EngineConfig
    from ollamamq_tpu_torch.engine.engine import TorchEngine
    from ollamamq_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from ollamamq_tpu_torch.server.app import serve_in_thread, stop_server
    from ollamamq_tpu_torch.telemetry.journal import check_invariants
    from ollamamq_tpu_torch.testing.faults import FaultPlan

    model, ps, usable, max_new = "llama3.2:1b", 32, 44, 160
    gc.collect()
    torch.cuda.empty_cache()
    # 127 bytes + BOS: the system prefix is exactly 4 pages.
    system = ("System: you are the assistant of a shared serving front; every "
              "user's queue is fair and each answer is short and exact.\n")[:127]
    system = system + "." * (127 - len(system))
    tails = ["Q: what is a page table?", "Q: why preempt a victim?",
             "Q: how does a radix tree share prompts?", "Q: when is a draft accepted?",
             "Q: what does fair share mean for me?", "Q: how long is one page?"]
    # Greedy and penalty-free (Ollama's default repeat_penalty is 1.1):
    # the rows that speculate.
    greedy = {"temperature": 0, "repeat_penalty": 1.0, "num_predict": max_new}
    jobs = {f"user{i}/prefix": (f"user{i}", {"prompt": system + t, "options": greedy})
            for i, t in enumerate(tails)}
    jobs["copy/pattern"] = ("copy", {"prompt": "red green blue " * 10, "options": greedy})
    jobs["sampled/seeded"] = ("sampled", {"prompt": system + "Q: tell me anything.",
                                          "options": {"temperature": 0.8, "top_k": 40,
                                                      "top_p": 0.9, "seed": 11,
                                                      "num_predict": max_new}})
    warm = ("warm", {"prompt": system + "Q: warm the cache.", "options": greedy})
    # Pages: each request needs ceil((prompt + 1 + max_new) / 32) <= 10;
    # the 8 concurrent ones need about 56 pages (the 4 shared ones once)
    # against 44 usable (a request that finishes early, as the drafted one
    # does, frees 10), so decode growth must preempt.
    plan = FaultPlan([{"site": "ragged", "kind": "exception", "at": [1]}])
    ecfg = EngineConfig(model=model, max_slots=8, num_pages=usable + 1, page_size=ps,
                        max_pages_per_seq=16, max_batch_tokens=512, token_granule=16,
                        max_new_tokens=max_new, decode_steps_per_iter=8,
                        dtype="bfloat16", prefix_cache=True, spec=True, spec_k=4,
                        fault_plan=plan, seed=0, journal_ring=1_000_000)
    engine = TorchEngine(ecfg)
    rt = engine.runtimes[model]
    srv = serve_in_thread(engine, port=0, timeout_s=600)
    port = srv.server_address[1]

    def gen(user, body):
        return _ollama_result(*_post(port, "/api/generate",
                                     {"model": model, "stream": False, **body}, user))

    results, errors = {}, []

    def run(name):
        user, body = jobs[name]
        try:
            results[name] = gen(user, body)
        except Exception as e:  # noqa: BLE001 — reported, then fails the phase
            errors.append(f"{name}: {e}")

    reset_launch_counts()
    t0 = time.monotonic()
    results["warm"] = gen(*warm)
    threads = [threading.Thread(target=run, args=(n,)) for n in jobs]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    torch.cuda.synchronize()
    serve_s = time.monotonic() - t0
    counts = launch_counts()
    stats, sampled_speculated = engine.call_on_loop(
        lambda: (rt.prefix_cache.check(), rt.stats(), "sampled" in rt._spec_user)[1:])
    stop_server(srv)
    # The whole phase's journal, every record kept (the ring holds it).
    records = engine.journal.tail(None)
    journal_kinds = {}
    for r in records:
        journal_kinds[r["kind"]] = journal_kinds.get(r["kind"], 0) + 1
    violations = check_invariants(records)
    if errors or len(results) != len(jobs) + 1:
        raise SystemExit(f"serve-runtime requests failed: {errors}")

    # Each request alone on a plain engine (same weights): cache, spec and
    # pressure off.
    plain = TorchEngine(EngineConfig(model=model, max_slots=8, num_pages=8 * 16 + 8,
                                     page_size=ps, max_pages_per_seq=16,
                                     max_batch_tokens=512, token_granule=16,
                                     max_new_tokens=max_new, decode_steps_per_iter=8,
                                     dtype="bfloat16", seed=0), params=rt.params)
    srv = serve_in_thread(plain, port=0, timeout_s=600)
    port = srv.server_address[1]
    alone = {name: gen(*job) for name, job in [("warm", warm), *jobs.items()]}
    stop_server(srv)

    tokens = sum(len(ids) for ids, _ in results.values())
    pc = stats["prefix_cache"]
    line = {"phase": "serve-runtime", "model": model, "layers": rt.cfg.num_layers,
            "dtype": "bfloat16", "max_slots": ecfg.max_slots,
            "num_pages": ecfg.num_pages, "usable_pages": usable, "max_new_tokens": max_new,
            "pages_per_request": {n: -(-(len(body["prompt"]) + 1 + max_new) // ps)
                                  for n, (_, body) in [("warm", warm), *jobs.items()]},
            "requests": len(results), "serve_s": serve_s, "tokens": tokens,
            "tokens_per_s": tokens / serve_s,
            "replies": {n: {"tokens": len(ids), "done_reason": why,
                            "first_diff_vs_alone": _first_diff(ids, alone[n][0])}
                        for n, (ids, why) in results.items()},
            "preempt_count": stats["preemptions"], "retry_count": engine.retry_count(),
            "spec_proposed": stats["spec"]["proposed"],
            "spec_accepted": stats["spec"]["accepted"],
            "spec_rollbacks": stats["spec"]["rollbacks"], "prefix_cache": pc,
            "sampled_speculated": sampled_speculated,
            "used_pages_after": stats["pages_used"],
            "cached_pages_after": stats["kv_pages_cached"],
            "ragged_dispatches": stats["ragged_dispatches"],
            "decode_steps": stats["decode_steps"], "launches": counts,
            "fault_plan": plan.stats(), "journal_records": len(records),
            "journal_evicted": engine.journal.seq - len(records),
            "journal_by_kind": journal_kinds, "journal_violations": violations[:5]}
    emit(line)
    report["serve_runtime"] = line
    del plain, engine, rt
    bad = [n for n, r in line["replies"].items() if r["done_reason"] not in ("stop", "length")
           or r["tokens"] <= 0]
    own = ("ragged_paged_attention", "paged_decode_attention")
    gates = {"replies": not bad, "preempt": line["preempt_count"] >= 1,
             "prefix_hits": pc["hits"] >= 1, "spec_accepted": line["spec_accepted"] >= 1,
             "one_retry": line["retry_count"] == 1, "sampled_no_spec": not sampled_speculated,
             "no_used_pages": line["used_pages_after"] == 0,
             "journal_clean": not violations and line["journal_evicted"] == 0,
             "kernels": all(counts[k] > 0 for k in own)
             and all(counts[k] == 0 for k in counts if k not in own)}
    if not all(gates.values()):
        raise SystemExit(f"serve-runtime gates failed: {gates} {bad}")


def _collect(req, timeout=600):
    deadline = time.monotonic() + timeout
    items = []
    while time.monotonic() < deadline:
        item = req.stream.get(timeout=0.5)
        if item is not None:
            items.append(item)
            if item.kind in ("done", "error"):
                return items
    raise SystemExit(f"request {req.req_id} did not finish: {items[-3:]}")


def serve_runtime_f32_phase(report) -> None:
    """Byte identity on the card: llama3.2:1b at full width with float32
    weights and KV (TF32 off), so argmax flips from rounding are
    vanishingly rare, through the float32-q bodies of both kernels. One
    greedy request served plainly, then with the third decode-time page
    growth failing (it preempts itself and replays), cache off and on;
    a repeated-pattern prompt with spec off and on. Token ids must be
    identical, with a preemption and with accepted drafts."""
    import dataclasses

    import torch

    from ollamamq_tpu_torch.config import EngineConfig, get_model_config
    from ollamamq_tpu_torch.engine.engine import TorchEngine
    from ollamamq_tpu_torch.models import weights
    from ollamamq_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from ollamamq_tpu_torch.ops.sampling import SamplingParams
    from ollamamq_tpu_torch.testing.faults import FaultPlan

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = "llama3.2:1b"
    gc.collect()
    torch.cuda.empty_cache()
    params = weights.init_random(get_model_config(model), 0, torch.float32, "cuda")
    base = EngineConfig(model=model, max_slots=4, num_pages=4 * 16 + 4, page_size=32,
                        max_pages_per_seq=16, max_batch_tokens=512, token_granule=16,
                        max_new_tokens=96, decode_steps_per_iter=8, dtype="float32",
                        seed=0)

    def serve(prompt, max_tokens, **over):
        eng = TorchEngine(dataclasses.replace(base, **over), params=params)
        eng.start()
        try:
            rt = eng.runtimes[model]
            ids = rt.tokenizer.encode(prompt)
            req = eng.enqueue_request("solo", "", model, prompt_tokens=ids,
                                      sampling=SamplingParams(max_tokens=max_tokens))
            items = _collect(req)
            if items[-1].kind != "done":
                raise SystemExit(f"serve-runtime-f32 {over}: {items[-1]}")
            return list(req.generated_ids), {
                "preemptions": req.preemptions, "spec_accepted": rt.spec_accepted,
                "spec_proposed": rt.spec_proposed, "used_pages": rt.alloc.used_pages,
                "prefix_hits": (rt.prefix_cache.hits if rt.prefix_cache else None)}
        finally:
            eng.stop()

    lone = "The quick brown fox jumps over the lazy dog; the scheduler keeps queues fair."
    copy = "red green blue " * 10
    reset_launch_counts()
    t0 = time.monotonic()
    runs = {"plain": serve(lone, 64)}
    for cache in (False, True):
        runs[f"preempted-cache-{'on' if cache else 'off'}"] = serve(
            lone, 64, prefix_cache=cache,
            fault_plan=FaultPlan([{"site": "extend", "kind": "alloc_fail", "at": [3]}]))
    runs["copy-spec-off"] = serve(copy, 96)
    runs["copy-spec-on"] = serve(copy, 96, spec=True, spec_k=4, spec_min_accept=0.0)
    seconds = time.monotonic() - t0
    counts = launch_counts()
    checks = {
        "preempt_identical": all(runs[k][0] == runs["plain"][0]
                                 for k in ("preempted-cache-off", "preempted-cache-on")),
        "preempted": all(runs[k][1]["preemptions"] >= 1
                         for k in ("preempted-cache-off", "preempted-cache-on")),
        "spec_identical": runs["copy-spec-on"][0] == runs["copy-spec-off"][0],
        "spec_accepted": runs["copy-spec-on"][1]["spec_accepted"] >= 1,
        "no_used_pages": all(r[1]["used_pages"] == 0 for r in runs.values()),
        "kernels": counts["ragged_paged_attention"] > 0
        and counts["paged_decode_attention"] > 0,
    }
    line = {"phase": "serve-runtime-f32", "model": model, "dtype": "float32",
            "tf32": False, "seconds": seconds,
            "runs": {k: {"tokens": len(ids), "first_diff_vs_plain": _first_diff(
                ids, runs["copy-spec-off" if k.startswith("copy") else "plain"][0]), **st}
                     for k, (ids, st) in runs.items()},
            "launches": counts, "checks": checks}
    emit(line)
    report["serve_runtime_f32"] = line
    del params
    if not all(checks.values()):
        raise SystemExit(f"serve-runtime-f32 checks failed: {checks}")


def _get(port, path, user="smoke"):
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    c.request("GET", path, headers={"X-User-ID": user})
    r = c.getresponse()
    data = r.read()
    c.close()
    if r.status != 200:
        raise RuntimeError(f"GET {path}: HTTP {r.status} {data[:300]!r}")
    return data


def _post_status(port, body, user):
    """(status, Retry-After, body) of one /api/generate, any status."""
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    c.request("POST", "/api/generate", json.dumps(body),
              {"X-User-ID": user, "Content-Type": "application/json"})
    r = c.getresponse()
    data = r.read()
    c.close()
    return r.status, r.getheader("Retry-After"), data


def _parse_prometheus(text):
    """{(name, labels): value} of every sample line; raises on a line that
    does not parse."""
    import re

    pat = re.compile(r'^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{(.*)\})? (\S+)$')
    out = {}
    for ln in text.splitlines():
        if not ln or ln.startswith("#"):
            continue
        m = pat.match(ln)
        if m is None:
            raise SystemExit(f"serve-sched: /metrics line does not parse: {ln!r}")
        out[(m.group(1), m.group(3) or "")] = float(m.group(4))
    return out


# Each worker rank of a serve-* world counts itself once under this
# journal kind before it serves (tp_rank_main): a worker's own series
# repeat rank 0's gauges and count nothing else, so without it the merge
# would not show in rank 0's scrape.
FEDERATION_PROBE = "federation_probe"


def _federated_scrape(eng, port, every_s=0.5, budget_s=60.0) -> dict:
    """metrics_federated: rank 0's /metrics once every other rank's
    posted snapshot (`ollamamq/metrics/<rank>`, read off the world's
    store, not through the engine) is there and two reads `every_s`
    apart agree, against the registry's render of exactly those
    snapshots (rendered again if a gauge moved between the two). ok: one
    snapshot a worker rank and none of rank 0's, the scrape equal to
    that render, and the probe counted once a worker rank. The workers'
    step-phase samples are recorded beside: a worker records no steps
    (the leader's profiler counts each step of the world once)."""
    from ollamamq_tpu_torch.engine import spmd
    from ollamamq_tpu_torch.telemetry.metrics import REGISTRY

    client, size = eng._plane.client(), eng._plane.size

    def read():
        return [spmd._try_get(client, f"ollamamq/metrics/{p}") for p in range(size)]

    deadline = time.monotonic() + budget_s
    posts = read()
    while time.monotonic() < deadline:
        time.sleep(every_s)
        again = read()
        if again == posts and all(again[1:]):
            break
        posts = again
    snaps = [json.loads(v) for v in posts[1:] if v]
    for renders in range(1, 4):
        text = _get(port, "/metrics").decode()
        want = REGISTRY.render(extra_snapshots=snaps)
        if text == want:
            break
    probe = _parse_prometheus(text).get(
        ("ollamamq_journal_events_total", f'kind="{FEDERATION_PROBE}"'), 0)
    worker_steps = sum(v[2] for snap in snaps
                       for _, v in snap["ollamamq_step_phase_ms"]["series"])
    line = {"worker_ranks": size - 1, "snapshots": len(snaps),
            "rank0_posted": posts[0] is not None, "scrape_equals_merge": text == want,
            "renders": renders, "probe": probe, "worker_step_samples": worker_steps,
            "scrape_lines": len(text.splitlines())}
    line["ok"] = (line["snapshots"] == size - 1 and not line["rank0_posted"]
                  and line["scrape_equals_merge"] and probe == size - 1)
    return line


def _delta_quantiles(child, before, qs):
    """Quantiles of what a histogram child observed since `before` (its
    bucket counts then), by the registry's own interpolation."""
    from ollamamq_tpu_torch.telemetry.metrics import HistogramChild

    delta = HistogramChild(child.buckets)
    delta.counts = [a - b for a, b in zip(child.counts, before)]
    delta.count = sum(delta.counts)
    return {f"p{int(q * 100)}": delta.quantile(q) for q in qs}


def serve_sched_phase(report) -> None:
    """Scheduling and observability of the fair-share front on the card
    (module docstring, serve-sched). The 503 goes to a third user's
    request: with max_queued 6 and the first user's 3 queued, the second
    user's third request is the sixth and is queued."""
    import torch

    from ollamamq_tpu_torch.config import EngineConfig
    from ollamamq_tpu_torch.core.mqcore import Fairness
    from ollamamq_tpu_torch.engine.engine import TorchEngine
    from ollamamq_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from ollamamq_tpu_torch.server.app import OllamaServer
    from ollamamq_tpu_torch.telemetry import mfu, stepprof
    from ollamamq_tpu_torch.telemetry import schema as tm

    model = "llama3.2:1b"
    kind = torch.cuda.get_device_name(0)
    peak = next((p for sub, p in mfu.PEAK_FLOPS_BY_KIND if sub in kind.lower()), None)
    if peak is None:
        raise SystemExit(f"serve-sched: no bf16 peak in the MFU table for {kind!r}")
    gc.collect()
    torch.cuda.empty_cache()
    ecfg = EngineConfig(model=model, max_slots=8, num_pages=8 * 16 + 8, page_size=32,
                        max_pages_per_seq=16, max_batch_tokens=512, token_granule=16,
                        max_new_tokens=160, decode_steps_per_iter=8, dtype="bfloat16",
                        scheduler="srpt", max_queued=6, max_queued_per_user=3, seed=0)
    engine = TorchEngine(ecfg, fairness=Fairness.TOKENS)
    rt = engine.runtimes[model]
    srv = OllamaServer(engine, port=0, timeout_s=600)
    threading.Thread(target=srv.serve_forever, name="http", daemon=True).start()
    port = srv.server_address[1]
    text = "Tell me about fair queues, pages and kernels on a shared card. "
    greedy = {"temperature": 0, "repeat_penalty": 1.0}
    replies, errors, threads = [], [], []

    def run(user, body):
        try:
            ids, why = _ollama_result(*_post(port, "/api/generate", body, user))
            replies.append((user, len(ids), why))
        except Exception as e:  # noqa: BLE001 — reported, then fails the phase
            errors.append(f"{user}: {e}")

    def send(user, max_tokens, prompt):
        """Start one request on its own thread once the caps admit it (the
        client paces itself: nothing else enqueues meanwhile), and return
        when the engine has traced it."""
        body = {"model": model, "prompt": prompt, "stream": False,
                "options": {**greedy, "num_predict": max_tokens}}
        deadline = time.monotonic() + 600
        while (engine.core.total_queued() >= ecfg.max_queued
               or engine.core.queue_len(user) >= ecfg.max_queued_per_user):
            if time.monotonic() > deadline:
                raise SystemExit("serve-sched: the queue never drained")
            time.sleep(0.002)
        n = len(engine.tracer.traces())
        threads.append(threading.Thread(target=run, args=(user, body)))
        threads[-1].start()
        while len(engine.tracer.traces()) == n and not errors:
            time.sleep(0.001)

    # Shedding, with the loop not started: nothing is admitted.
    stepprof.PROFILER.reset()
    ttft = tm.TTFT_MS.labels(model=model)
    tpot = tm.TPOT_MS.labels(model=model)
    ttft0, tpot0 = list(ttft.counts), list(tpot.counts)
    before = _parse_prometheus(_get(port, "/metrics").decode())
    sheds = {}
    for i in range(3):
        send("shed-a", 16, f"{text} (a{i})")
    sheds["user_queue_full"] = _post_status(
        port, {"model": model, "prompt": text, "stream": False}, "shed-a")
    for i in range(3):
        send("shed-b", 16, f"{text} (b{i})")
    queued = engine.core.total_queued()
    sheds["queue_full"] = _post_status(
        port, {"model": model, "prompt": text, "stream": False}, "shed-c")
    reset_launch_counts()
    t0 = time.monotonic()
    engine.start()
    for t in threads:
        t.join(timeout=600)
    # The mix: one user's long requests against four users' short ones.
    threads.clear()
    for i in range(4):
        send("long", 160, f"{text * 3} (long {i})")
        for u in range(4):
            if i < 2:
                send(f"short{u}", 16, f"{text} (short{u} {i})")
    for t in threads:
        t.join(timeout=600)
    torch.cuda.synchronize()
    serve_s = time.monotonic() - t0
    counts = launch_counts()
    engine.health.check_once()  # a watchdog probe on the engine's card
    probe = (str(engine.health.probe_device), engine.health.probes)
    after_text = _get(port, "/metrics").decode()
    after = _parse_prometheus(after_text)
    health = json.loads(_get(port, "/health"))
    prof = json.loads(_get(port, "/debug/stepprof?n=8"))
    hbm = json.loads(_get(port, "/debug/hbm"))
    srv.shutdown()
    srv.server_close()
    engine.stop()
    if errors:
        raise SystemExit(f"serve-sched requests failed: {errors}")

    lab = f'model="{model}"'
    served = len(replies)
    evals = sum(n for _, n, _ in replies)
    per_user = {}
    for user, n, _ in replies:
        per_user[user] = per_user.get(user, 0) + n
    mfu_gauge = after[("ollamamq_mfu", lab)]
    modes = prof["summary"]["modes"]
    phase_ms = {m: {ph: modes[m][ph]["p50_ms"] for ph in stepprof.PHASES}
                for m in ("ragged", "decode") if m in modes}
    last_hbm = next((s for s in reversed(hbm["timeline"]) if "device" in s), None)
    shed_records = {}
    for r in engine.journal.tail(None, kind="shed"):
        shed_records[r["reason"]] = shed_records.get(r["reason"], 0) + 1
    answered = {}
    for status, _, _ in sheds.values():
        answered[status] = answered.get(status, 0) + 1
    line = {"phase": "serve-sched", "model": model, "layers": rt.cfg.num_layers,
            "scheduler": "srpt", "fairness": "tokens", "max_queued": ecfg.max_queued,
            "max_queued_per_user": ecfg.max_queued_per_user, "queued_before_loop": queued,
            "sheds": {k: {"status": v[0], "retry_after": v[1],
                          "body": json.loads(v[2])} for k, v in sheds.items()},
            "shed_counts": engine.shed_counts, "shed_records": shed_records,
            "replies": served,
            "done_reasons": sorted({why for _, _, why in replies}),
            "serve_s": serve_s, "eval_count": evals, "per_user_tokens": per_user,
            "ttft_count_delta": (after[("ollamamq_ttft_ms_count", lab)]
                                 - before.get(("ollamamq_ttft_ms_count", lab), 0.0)),
            "tokens_total_delta": (after[("ollamamq_tokens_generated_total", lab)]
                                   - before.get(("ollamamq_tokens_generated_total", lab), 0.0)),
            "ttft_ms": _delta_quantiles(ttft, ttft0, (0.5, 0.99)),
            "tpot_ms": _delta_quantiles(tpot, tpot0, (0.5,)),
            "mfu": mfu_gauge, "peak_flops": peak, "runtime_peak_flops": rt.peak_flops,
            "step_phase_p50_ms": phase_ms,
            "step_samples": {m: modes[m]["step"]["n"] for m in modes},
            "step_p50_ms": {m: modes[m]["step"]["p50_ms"] for m in modes},
            "hbm_device": last_hbm and last_hbm["device"],
            "param_bytes": rt.param_bytes, "kv_bytes": rt.kv_bytes,
            "health": health["health"], "alerts": health["alerts"],
            "probe_device": probe[0], "probes": probe[1],
            "scheduler_stats": health["scheduler"], "launches": counts}
    emit(line)
    report["serve_sched"] = line
    own = ("ragged_paged_attention", "paged_decode_attention")
    retry_ok = all(v[1] is not None and int(v[1]) >= 1 for v in sheds.values())
    gates = {
        "replies": served == 18 and set(line["done_reasons"]) <= {"stop", "length"},
        "shedding": (sheds["user_queue_full"][0] == 429 and sheds["queue_full"][0] == 503
                     and retry_ok and queued == 6
                     and engine.shed_counts == {"user_queue_full": 1, "queue_full": 1}),
        "shed_journal": (sum(shed_records.values()) == answered.get(429, 0)
                         + answered.get(503, 0) == 2
                         and shed_records == {"user_queue_full": 1, "queue_full": 1}),
        "ttft_count": line["ttft_count_delta"] == served,
        "tokens_total": line["tokens_total_delta"] == evals,
        "mfu": 0.0 < mfu_gauge <= 1.0 and rt.peak_flops == peak,
        "stepprof": all(m in phase_ms and all(v > 0 for v in phase_ms[m].values())
                        for m in ("ragged", "decode")),
        "hbm": (last_hbm is not None and last_hbm["device"]["allocated_bytes"]
                >= rt.param_bytes + rt.kv_bytes),
        "health": (health["health"]["device_online"] and health["alerts"] == []
                   and health["status"] == "ok" and probe[0].startswith("cuda")
                   and probe[1] >= 1),
        "kernels": all(counts[k] > 0 for k in own)
        and all(counts[k] == 0 for k in counts if k not in own),
    }
    line["gates"] = gates
    if not all(gates.values()):
        raise SystemExit(f"serve-sched gates failed: {gates}")


def _request(port, method, path, body=None, user="smoke", timeout=600):
    """(status, content type, body bytes) of one request, any status."""
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    c.request(method, path, json.dumps(body) if body is not None else None,
              {"X-User-ID": user, "Content-Type": "application/json"})
    r = c.getresponse()
    data = r.read()
    c.close()
    return r.status, r.getheader("Content-Type"), data


def _cosine(a, b) -> float:
    a, b = [float(x) for x in a], [float(x) for x in b]
    dot = sum(x * y for x, y in zip(a, b))
    return dot / max(1e-30, math.sqrt(sum(x * x for x in a) * sum(y * y for y in b)))


def _params_cpu_f32(params):
    """A params dict's tensors copied to the CPU in float32."""
    return {k: ([{n: t.float().cpu() for n, t in lp.items()} for lp in v]
                if k == "layers" else v.float().cpu()) for k, v in params.items()}


def serve_models_phase(report) -> None:
    """The model lifecycle and the rest of the API surface on the card
    (module docstring, serve-models)."""
    import shutil
    import tempfile

    import torch

    from ollamamq_tpu_torch.config import EngineConfig
    from ollamamq_tpu_torch.engine.engine import TorchEngine
    from ollamamq_tpu_torch.models import llama, weights
    from ollamamq_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from ollamamq_tpu_torch.ops.sampling import SamplingParams
    from ollamamq_tpu_torch.server.app import OllamaServer
    from ollamamq_tpu_torch.telemetry import stepprof

    gen, enc = "llama3.2:1b", "nomic-embed-text"
    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.monotonic()
    ecfg = EngineConfig(model=gen, max_slots=4, num_pages=8 * 16 + 8, page_size=32,
                        max_pages_per_seq=16, max_batch_tokens=512, token_granule=16,
                        max_new_tokens=160, decode_steps_per_iter=8, dtype="bfloat16",
                        seed=0)
    engine = TorchEngine(ecfg)
    srv = OllamaServer(engine, port=0, timeout_s=600)
    threading.Thread(target=srv.serve_forever, name="http", daemon=True).start()
    engine.start()
    port = srv.server_address[1]
    gates, line = {}, {"phase": "serve-models", "models": [gen, enc]}

    def ok(path, body=None, method="POST", user="smoke"):
        status, ctype, data = _request(port, method, path, body, user)
        if status != 200:
            raise SystemExit(f"serve-models: {method} {path}: HTTP {status} {data[:300]!r}")
        return json.loads(data) if ctype == "application/json" else data

    try:
        # (a) a streamed pull of the encoder.
        t0 = time.monotonic()
        pulled = [json.loads(x) for x in ok("/api/pull", {"model": enc}).decode().splitlines()]
        line["pull_s"] = time.monotonic() - t0
        line["pull_lines"] = pulled
        rt_gen, rt_enc = engine.runtimes[gen], engine.runtimes[enc]
        tags = {m["name"]: m["size"] for m in ok("/api/tags", method="GET")["models"]}
        ps = {m["name"]: m["size_vram"] for m in ok("/api/ps", method="GET")["models"]}
        sizes = {gen: rt_gen.param_bytes, enc: rt_enc.param_bytes}
        line.update(tags=tags, ps=ps, param_bytes=sizes)
        gates["pull"] = ([x.get("status") for x in pulled][0] == "pulling manifest"
                         and len(pulled) >= 3 and pulled[-1] == {"status": "success"}
                         and tags == sizes and ps == sizes)

        # (b) embeddings while 4 greedy streams saturate the decode slots.
        sentence = "Retrieval indexes embed documents while chat users keep decoding. "
        texts = [(sentence * 5)[:n] for n in (15, 40, 63, 100, 150, 200, 250, 299)]
        replies, errors, stream_end = {}, [], []

        def stream(i):
            try:
                t = time.monotonic()
                data = ok("/api/generate", {"model": gen, "prompt": f"{sentence} ({i})",
                                             "options": {"temperature": 0, "num_predict": 160}},
                          user=f"chat{i}")
                ids, _ = _ollama_result("application/x-ndjson", data)
                stream_end.append((time.monotonic(), t, len(ids)))
            except Exception as e:  # noqa: BLE001 — reported, then fails the phase
                errors.append(f"stream {i}: {e}")

        def embed(name, path, body):
            try:
                out = ok(path, body, user=f"rag-{name}")
                replies[name] = (time.monotonic(), out, engine.runtimes[gen].active_count())
            except Exception as e:  # noqa: BLE001
                errors.append(f"{name}: {e}")

        reset_launch_counts()
        streams = [threading.Thread(target=stream, args=(i,)) for i in range(4)]
        for t in streams:
            t.start()
        deadline = time.monotonic() + 120
        while rt_gen.active_count() < 4 and not errors:
            if time.monotonic() > deadline:
                raise SystemExit("serve-models: the 4 streams never filled the slots")
            time.sleep(0.001)
        saturated = rt_gen.active_count() == 4 and not rt_gen.has_capacity("generate")
        jobs = {f"{gen}/api/embed": ("/api/embed", {"model": gen, "input": texts}),
                f"{enc}/api/embed": ("/api/embed", {"model": enc, "input": texts}),
                f"{enc}/v1/embeddings": ("/v1/embeddings", {"model": enc, "input": texts[3]}),
                f"{gen}/api/embeddings": ("/api/embeddings", {"model": gen, "prompt": texts[5]})}
        workers = [threading.Thread(target=embed, args=(n, *j)) for n, j in jobs.items()]
        for t in workers:
            t.start()
        for t in workers + streams:
            t.join(timeout=600)
        torch.cuda.synchronize()
        window = launch_counts()
        if errors:
            raise SystemExit(f"serve-models requests failed: {errors}")
        vectors = {f"{gen}/api/embed": replies[f"{gen}/api/embed"][1]["embeddings"],
                   f"{enc}/api/embed": replies[f"{enc}/api/embed"][1]["embeddings"],
                   f"{enc}/v1/embeddings": [d["embedding"] for d in
                                            replies[f"{enc}/v1/embeddings"][1]["data"]],
                   f"{gen}/api/embeddings": [replies[f"{gen}/api/embeddings"][1]["embedding"]]}
        dims = {k: sorted({len(v) for v in vs}) for k, vs in vectors.items()}
        norms = [math.sqrt(sum(x * x for x in v)) for vs in vectors.values() for v in vs]
        last_end = max(e for e, _, _ in stream_end)
        own = ("ragged_paged_attention", "paged_decode_attention")
        line.update(decode_saturated=saturated, embed_dims=dims,
                    max_norm_err=max(abs(n - 1) for n in norms),
                    stream_tokens=[n for _, _, n in stream_end],
                    embed_reply_before_last_stream_end_s={
                        k: last_end - t for k, (t, _, _) in replies.items()},
                    active_slots_at_reply={k: a for k, (_, _, a) in replies.items()},
                    launches=window)
        gates["saturated"] = saturated
        gates["dims"] = all(d == [2048 if k.startswith(gen) else 768] for k, d in dims.items())
        gates["norms"] = line["max_norm_err"] <= 1e-3
        gates["during_decode"] = all(t < last_end for t, _, _ in replies.values())
        gates["window_kernels"] = (all(window[k] > 0 for k in own)
                                   and all(window[k] == 0 for k in window if k not in own))

        # The embed-only sub-window: the 8 inputs per model, 3 times; the
        # step profiler's embed samples of 8 padded rows at length 512
        # time one batch (a request set may split across dispatches).
        reset_launch_counts()
        embed_ms, embed_http_ms = {}, {}
        for name in (gen, enc):
            w0, http_runs = time.time(), []
            for _ in range(3):
                t0 = time.monotonic()
                ok("/api/embed", {"model": name, "input": texts})
                http_runs.append((time.monotonic() - t0) * 1e3)
            full = sorted(x["total_ms"] for x in stepprof.PROFILER.window(w0, time.time())
                          if x["mode"] == "embed" and x["padded_tokens"] == 8 * 512)
            embed_ms[name] = full[len(full) // 2] if full else None
            embed_http_ms[name] = sorted(http_runs)[1]
        torch.cuda.synchronize()
        sub = launch_counts()
        line.update(embed_ms_per_batch=embed_ms, embed_http_ms_per_batch=embed_http_ms,
                    embed_only_launches=sub)
        gates["embed_only_kernels"] = all(v == 0 for v in sub.values())

        # (c) alone vs in the batch; the card's encoder vs the CPU's.
        lone = {name: ok("/api/embed", {"model": name, "input": texts[0]})["embeddings"][0]
                for name in (gen, enc)}
        cos_lone = {name: _cosine(lone[name], vectors[f"{name}/api/embed"][0])
                    for name in (gen, enc)}
        cpu_params = _params_cpu_f32(rt_enc.params)
        toks = [rt_enc.tokenizer.encode(t) for t in texts]
        T = 32
        while T < max(map(len, toks)):
            T *= 2
        tok_cpu = torch.zeros((len(toks), T), dtype=torch.int32)
        for i, t in enumerate(toks):
            tok_cpu[i, :len(t)] = torch.tensor(t, dtype=torch.int32)
        t0 = time.monotonic()
        with torch.no_grad():
            ref = llama.forward_encoder(cpu_params, rt_enc.cfg, tok_cpu,
                                        torch.tensor([len(t) for t in toks]))
        cpu_s = time.monotonic() - t0
        del cpu_params
        cos_cpu = [_cosine(v, r.tolist()) for v, r in zip(vectors[f"{enc}/api/embed"], ref)]
        line.update(cosine_lone_vs_batch=cos_lone, cosine_card_vs_cpu_f32_min=min(cos_cpu),
                    cpu_reference_s=cpu_s)
        gates["lone_vs_batch"] = all(c >= 0.999 for c in cos_lone.values())
        gates["card_vs_cpu"] = min(cos_cpu) >= 0.995

        # (d) deleting a busy model: with the loop stopped, an embed is
        # placed on the encoder's queue by one admission pass.
        engine.stop()
        busy = {}
        waiter = threading.Thread(target=lambda: busy.update(
            reply=_request(port, "POST", "/api/embed", {"model": enc, "input": texts[1]},
                           "busy")))
        waiter.start()
        deadline = time.monotonic() + 60
        while engine.core.total_queued() == 0:
            if time.monotonic() > deadline:
                raise SystemExit("serve-models: the busy embed was never queued")
            time.sleep(0.001)
        engine._admit()
        held = rt_enc.has_work()
        busy_delete = _request(port, "POST", "/api/delete", {"model": enc})
        engine.start()
        waiter.join(timeout=120)
        line.update(busy_delete={"status": busy_delete[0],
                                 "body": json.loads(busy_delete[2])},
                    busy_embed_status=busy.get("reply", (None,))[0])
        gates["busy_409"] = (held and busy_delete[0] == 409
                             and busy.get("reply", (None,))[0] == 200)

        # (e) deleting the idle encoder frees its weights; a re-pull
        # brings back bit-identical embeddings.
        enc_bytes = rt_enc.param_bytes
        del rt_enc
        gc.collect()
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        deleted = _request(port, "POST", "/api/delete", {"model": enc})
        gc.collect()
        torch.cuda.synchronize()
        freed = before - torch.cuda.memory_allocated()
        gone = _request(port, "POST", "/api/embed", {"model": enc, "input": texts[0]})
        t0 = time.monotonic()
        ok("/api/pull", {"model": enc, "stream": False})
        repull_s = time.monotonic() - t0
        again = ok("/api/embed", {"model": enc, "input": texts[0]})["embeddings"][0]
        line.update(delete_status=deleted[0], freed_bytes=freed, encoder_param_bytes=enc_bytes,
                    embed_after_delete_status=gone[0], repull_s=repull_s,
                    repull_bit_identical=again == lone[enc])
        gates["delete"] = deleted[0] == 200 and gone[0] == 404
        gates["freed"] = freed >= 0.95 * enc_bytes
        gates["repull_identical"] = again == lone[enc]

        # (g) the other routes.
        root = _request(port, "GET", "/")
        show = ok("/api/show", {"model": gen})
        version = ok("/api/version", method="GET")
        models = ok("/v1/models", method="GET")
        one = ok("/v1/models/" + gen, method="GET")
        cmpl = ok("/v1/completions", {"model": gen, "prompt": sentence, "max_tokens": 8,
                                      "temperature": 0})
        sse = ok("/v1/completions", {"model": gen, "prompt": sentence, "max_tokens": 8,
                                     "temperature": 0, "stream": True}).decode()
        events = [x[len("data: "):] for x in sse.split("\n\n") if x.startswith("data: ")]
        chunks = [json.loads(x) for x in events[:-1]]
        honest = {p: _request(port, "POST", p, {})[0]
                  for p in ("/api/create", "/api/push", "/api/blobs/x")}
        routes = {
            "root": root[0] == 200 and root[2] == b"Ollama is running",
            "show": ({"modelfile", "parameters", "template", "details", "model_info"}
                     <= set(show) and show["model_info"]["llama.embedding_length"] == 2048),
            "version": isinstance(version.get("version"), str),
            "v1_models": (models["object"] == "list"
                          and {m["id"] for m in models["data"]} == {gen, enc}),
            "v1_model": one["id"] == gen and one["object"] == "model",
            "completions": (cmpl["object"] == "text_completion"
                            and cmpl["choices"][0]["finish_reason"] in ("stop", "length")
                            and cmpl["usage"]["completion_tokens"] > 0),
            # Random weights mostly pick ids outside the byte tokenizer's
            # range, which stream no text: the finish chunk may stand alone.
            "completions_sse": (events[-1] == "[DONE]" and len(chunks) >= 1
                                and all(c["object"] == "text_completion"
                                        and "text" in c["choices"][0] for c in chunks)
                                and chunks[-1]["choices"][0]["finish_reason"]
                                in ("stop", "length")),
            "honest_501": set(honest.values()) == {501},
        }
        line["routes"] = routes
        gates["routes"] = all(routes.values())

        # (f) a safetensors checkpoint of the generative model.
        prompts = [f"{sentence} (checkpoint {i})" for i in range(2)]

        def greedy_ids(eng):
            out = []
            for prompt in prompts:
                rt = eng.runtimes[gen]
                req = eng.enqueue_request("ckpt", "", gen, prompt_tokens=rt.tokenizer.encode(prompt),
                                          sampling=SamplingParams(max_tokens=32))
                items = _collect(req)
                if items[-1].kind != "done":
                    raise SystemExit(f"serve-models checkpoint stream: {items[-1]}")
                out.append(list(req.generated_ids))
            return out

        seeded = greedy_ids(engine)
        tmp = tempfile.mkdtemp(prefix="ollamamq-ckpt-")
        try:
            t0 = time.monotonic()
            path = weights.save_safetensors(rt_gen.params, rt_gen.cfg, tmp)
            write_s = time.monotonic() - t0
            file_bytes = os.path.getsize(path)
            t0 = time.monotonic()
            eng2 = TorchEngine(ecfg, models={gen: tmp})
            torch.cuda.synchronize()
            load_s = time.monotonic() - t0
            eng2.start()
            try:
                loaded = greedy_ids(eng2)
            finally:
                eng2.stop()
                del eng2
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        line.update(checkpoint_write_s=write_s, checkpoint_load_s=load_s,
                    checkpoint_bytes=file_bytes, checkpoint_tokens=[len(x) for x in loaded],
                    checkpoint_ids_identical=loaded == seeded, checkpoint_dir_removed=not
                    os.path.exists(tmp))
        gates["checkpoint"] = (loaded == seeded and all(len(x) > 0 for x in loaded)
                               and not os.path.exists(tmp))
    finally:
        srv.shutdown()
        srv.server_close()
        engine.stop()
    line["seconds"] = time.monotonic() - t_phase
    line["gates"] = gates
    emit(line)
    report["serve_models"] = line
    emit({"phase": "serve-models-numbers",
          "embed_ms_per_batch": line["embed_ms_per_batch"], "pull_s": line["pull_s"],
          "freed_bytes": line["freed_bytes"],
          "checkpoint_write_s": line["checkpoint_write_s"],
          "checkpoint_load_s": line["checkpoint_load_s"]})
    if not all(gates.values()):
        raise SystemExit(f"serve-models gates failed: {gates}")


# -- serve-durable: crash durability through the CLI on the card ------------
DURABLE_MODEL = "llama3.2:1b"
DURABLE_ARGS = ["--no-tui", "--max-slots", "4",
                "--num-pages", str(4 * 16 + 4), "--page-size", "32",
                "--max-pages-per-seq", "16", "--max-batch-tokens", "512",
                "--token-granule", "16", "--max-new-tokens", "96",
                "--decode-steps", "8", "--seed", "0", "--wal-fsync-ms", "2",
                "--stop-grace-s", "120", "--timeout-s", "600"]
DURABLE_USERS = ("ada", "bob", "cyd", "dee")
DURABLE_NEW = 96


def _free_port() -> int:
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def share_bytecode(here: str) -> dict:
    """Compile every Python module this process has imported (torch's,
    numpy's, the port's) into a bytecode cache inside the checkout and
    point every process the script starts at it (PYTHONPYCACHEPREFIX).
    Where the environment sets PYTHONDONTWRITEBYTECODE and the installed
    packages ship no bytecode, each new process otherwise compiles all
    of torch's Python again: ~6-10 s of every rank's and server's
    start-up on the card's host. A cached file is used only while its
    source's size and mtime match."""
    import importlib.util
    import py_compile

    t0 = time.monotonic()
    # What the rank and server processes import besides torch itself.
    import torch.distributed  # noqa: F401
    import ollamamq_tpu_torch.cli  # noqa: F401
    import ollamamq_tpu_torch.engine.spmd  # noqa: F401
    import ollamamq_tpu_torch.fleet.wide  # noqa: F401
    import ollamamq_tpu_torch.server.app  # noqa: F401

    prefix = os.path.join(here, "ollamamq_tpu_torch", "_build", "pycache")
    sys.pycache_prefix = prefix
    done = failed = 0
    for mod in list(sys.modules.values()):
        src = getattr(mod, "__file__", None)
        if not src or not src.endswith(".py"):
            continue
        try:
            py_compile.compile(src, cfile=importlib.util.cache_from_source(src),
                               doraise=True,
                               invalidation_mode=py_compile.PycInvalidationMode.TIMESTAMP)
            done += 1
        except (OSError, py_compile.PyCompileError, ValueError):
            failed += 1
    os.environ["PYTHONPYCACHEPREFIX"] = prefix
    return {"modules": done, "failed": failed, "seconds": time.monotonic() - t0}


def _log_tail(path: str, n: int = 2000) -> str:
    with open(path, "rb") as f:
        f.seek(max(0, os.path.getsize(path) - n))
        return f.read().decode(errors="replace")


def _bound_port(proc, log_path: str, start: int, who: str,
                budget: float = 300.0) -> int:
    """The port a CLI process started with `--port 0` bound, read off the
    "serving ... on HOST:PORT" line it logs past byte `start` of its log.
    A port picked here and bound by the process seconds later can be
    taken meanwhile: this script's own client connections leave their
    ports in TIME_WAIT, and a listener's bind to such a port fails."""
    import re

    pat = re.compile(rb"serving .* on \S+:(\d+) \(device")
    deadline = time.monotonic() + budget
    while True:
        done = proc.poll() is not None
        with open(log_path, "rb") as f:
            f.seek(start)
            m = pat.search(f.read())
        if m:
            return int(m.group(1))
        if done:
            raise SystemExit(f"{who} exited {proc.returncode} before serving "
                             f"(log {log_path}):\n{_log_tail(log_path)}")
        if time.monotonic() > deadline:
            raise SystemExit(f"{who} never logged its port (log {log_path})")
        time.sleep(0.05)


def _durable_prompt(user: str) -> str:
    return (f"{user}: a long answer about fair queues, KV pages and crash "
            f"recovery on a shared card, please.")


def _durable_body(user: str, stream: bool) -> dict:
    return {"model": DURABLE_MODEL, "prompt": _durable_prompt(user), "stream": stream,
            "options": {"temperature": 0, "repeat_penalty": 1.0,
                        "num_predict": DURABLE_NEW}}


def _durable_config(dtype: str, wal_dir=None):
    """The EngineConfig the CLI builds from DURABLE_ARGS, so an in-process
    engine serves exactly what the subprocess serves."""
    from ollamamq_tpu_torch import cli

    argv = DURABLE_ARGS + ["--model", DURABLE_MODEL, "--dtype", dtype]
    if wal_dir:
        argv += ["--wal-dir", wal_dir]
    return cli.engine_config(cli.build_parser().parse_args(argv))


def _ndjson(port, method, path, body=None, user="smoke", timeout=600):
    """Open a streamed request; returns the HTTPResponse (iterate lines)."""
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    c.request(method, path, json.dumps(body) if body is not None else None,
              {"X-User-ID": user, "Content-Type": "application/json"})
    r = c.getresponse()
    if r.status != 200:
        raise RuntimeError(f"{method} {path}: HTTP {r.status} {r.read()[:300]!r}")
    return r


class _Server:
    """python -m ollamamq_tpu_torch.cli in a subprocess on the card, its
    output in the phase's log file."""

    def __init__(self, name: str, dtype: str, wal_dir: str):
        path = os.path.join(OUT_DIR, f"serve-durable-{name}.log")
        self._start = os.path.getsize(path) if os.path.exists(path) else 0
        self._port = None
        self.log = open(path, "ab")
        self.t_spawn = time.monotonic()
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "ollamamq_tpu_torch.cli", *DURABLE_ARGS,
             "--model", DURABLE_MODEL, "--dtype", dtype, "--port", "0",
             "--wal-dir", wal_dir, "--blocklist", os.path.join(OUT_DIR, f"blocked-{name}.json")],
            cwd=os.path.dirname(os.path.abspath(__file__)), stdout=self.log,
            stderr=subprocess.STDOUT)

    @property
    def port(self) -> int:
        if self._port is None:
            self._port = _bound_port(self.proc, self.log.name, self._start,
                                     "serve-durable: server")
        return self._port

    def health(self, budget=300.0) -> dict:
        """/health once the server answers and its recovery pass is done."""
        deadline = time.monotonic() + budget
        while time.monotonic() < deadline:
            if self.proc.poll() is not None:
                raise SystemExit(f"serve-durable: server exited {self.proc.returncode}"
                                 f" (log {self.log.name}):\n{_log_tail(self.log.name)}")
            try:
                h = json.loads(_get(self.port, "/health"))
                if h.get("status") != "recovering":
                    return h
            except (OSError, RuntimeError):
                pass
            time.sleep(0.2)
        raise SystemExit(f"serve-durable: server on :{self.port} never became healthy")

    def close(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(timeout=60)
        self.log.close()


class _Client:
    """One user's stream: the /api/generate connection (kept open, as a
    client waiting for its reply) and an observer of its frames through
    GET /api/stream/{rid}: random-weight ids are mostly outside the byte
    tokenizer's range, so generate frames (one per text chunk) are rare,
    while the resume route carries one frame per token."""

    def __init__(self, port: int, user: str):
        self.user, self.port = user, port
        self.frames = []  # (token id, text) as the observer read them
        self.gen_done = None  # the generate stream's done_reason, or an error
        self.rid = None
        self.reading = True
        self._gen = threading.Thread(target=self._generate, daemon=True)
        self._gen.start()
        deadline = time.monotonic() + 120
        while self.rid is None:
            evs = json.loads(_get(port, f"/debug/journal?user={user}&kind=enqueue"))
            if evs["events"]:
                self.rid = evs["events"][-1]["req_id"]
            elif time.monotonic() > deadline:
                raise SystemExit(f"serve-durable: {user}'s request never enqueued")
            else:
                time.sleep(0.01)
        self._obs = threading.Thread(target=self._observe, daemon=True)
        self._obs.start()

    def _generate(self) -> None:
        try:
            for raw in _ndjson(self.port, "POST", "/api/generate",
                               _durable_body(self.user, True), self.user):
                f = json.loads(raw)
                if f.get("done"):
                    self.gen_done = f.get("error") or f["done_reason"]
                    return
            self.gen_done = "closed without a done frame"
        except Exception as e:  # noqa: BLE001 — the server may be killed
            self.gen_done = f"connection: {type(e).__name__}"

    def _observe(self) -> None:
        try:
            for raw in _ndjson(self.port, "GET", f"/api/stream/{self.rid}?from=0",
                               user=self.user):
                if not self.reading:
                    return
                f = json.loads(raw)
                if f.get("done"):
                    return
                self.frames.append((f["token_ids"][0] if f.get("token_ids") else -1,
                                    f["response"]))
        except Exception:  # noqa: BLE001 — killed under it
            return

    def ids(self):
        return [t for t, _ in self.frames if t >= 0]

    def stop_reading(self):
        """The client stops here: what it read so far is all it has."""
        self.reading = False
        return list(self.frames)


def _resume(port, user, rid, from_n):
    """(frames, done_reason, monotonic time of the first frame) of GET
    /api/stream/{rid}?from=N read to its terminal."""
    first, frames, done = None, [], None
    for raw in _ndjson(port, "GET", f"/api/stream/{rid}?from={from_n}", user=user):
        f = json.loads(raw)
        if first is None:
            first = time.monotonic()
        if f.get("done"):
            done = f.get("error") or f["done_reason"]
            break
        frames.append((f["token_ids"][0] if f.get("token_ids") else -1, f["response"]))
    return frames, done, first


def _serve_four(port):
    """The phase's traffic: one greedy /api/generate per user at once, not
    streamed; {user: (ids, text, done_reason, ttft_ms)} and the seconds."""
    out, errors = {}, []

    def run(user):
        try:
            _, data = _post(port, "/api/generate", _durable_body(user, False), user)
            r = json.loads(data)
            out[user] = (r["token_ids"], r["response"], r["done_reason"],
                         r["prompt_eval_duration"] / 1e6)
        except Exception as e:  # noqa: BLE001 — reported, then fails the phase
            errors.append(f"{user}: {e}")

    t0 = time.monotonic()
    threads = [threading.Thread(target=run, args=(u,)) for u in DURABLE_USERS]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    if errors or len(out) != len(DURABLE_USERS):
        raise SystemExit(f"serve-durable requests failed: {errors}")
    return out, time.monotonic() - t0


def _serve_in_process(ecfg, params=None):
    """(replies, seconds, {journal counts, WAL status, dispatch counts and
    step-phase medians}, the engine's params) of the phase's traffic on an
    in-process engine, which is stopped after."""
    from ollamamq_tpu_torch.engine.engine import TorchEngine
    from ollamamq_tpu_torch.server.app import serve_in_thread, stop_server
    from ollamamq_tpu_torch.telemetry import stepprof

    srv = serve_in_thread(TorchEngine(ecfg, params=params), port=0, timeout_s=600)
    try:
        stepprof.PROFILER.reset()
        replies, seconds = _serve_four(srv.server_address[1])
        modes = stepprof.PROFILER.summary()["modes"]
        eng = srv.engine
        kinds = {}
        for r in eng.journal.tail(None):
            kinds[r["kind"]] = kinds.get(r["kind"], 0) + 1
        wal = eng.durability.status() if eng.durability is not None else None
        rt = eng.runtimes[DURABLE_MODEL]
        params, rst = rt.params, rt.stats()
    finally:
        stop_server(srv)
    ticks = {k: rst[k] for k in ("ragged_dispatches", "decode_dispatches",
                                 "decode_steps")}
    # Median ms per phase of each step mode (the step profiler's split).
    ticks["step_p50_ms"] = {m: {ph: v["p50_ms"] for ph, v in modes[m].items()
                                if isinstance(v, dict) and "p50_ms" in v}
                            for m in modes}
    return replies, seconds, {"journal_seq": eng.journal.seq, "kinds": kinds,
                              "wal": wal, "ticks": ticks}, params


def _kill9_run(name, dtype, wal_dir):
    """Start the CLI on a fresh WAL dir, stream to the 4 users, and once
    each has read at least 16 token frames stop reading and SIGKILL it
    (0.1 s later: the WAL's 2 ms group commit has made every frame read
    durable). Restart it on the WAL dir and resume every stream from where
    its client stopped. Returns what the gates and the line need."""
    a = _Server(f"{name}-a", dtype, wal_dir)
    b = None
    try:
        a.health()
        clients = [_Client(a.port, u) for u in DURABLE_USERS]
        deadline = time.monotonic() + 300
        while min(len(c.ids()) for c in clients) < 16:
            if time.monotonic() > deadline:
                raise SystemExit(f"serve-durable {name}: streams never reached 16 tokens: "
                                 f"{[len(c.ids()) for c in clients]}")
            time.sleep(0.005)
        pre = {c.user: c.stop_reading() for c in clients}
        time.sleep(0.1)
        # The last read of this process's launch counts, right before the
        # kill: the launches of the few ms between it and the SIGKILL are
        # the only ones of the phase that go uncounted.
        health_a = json.loads(_get(a.port, "/health"))
        a.proc.kill()  # SIGKILL: no flush, no goodbye
        a.proc.wait(timeout=60)
        for c in clients:  # their generate connections break with it
            c._gen.join(timeout=30)
        b = _Server(f"{name}-b", dtype, wal_dir)
        health_b = b.health()
        resumed, firsts = {}, []
        for c in clients:
            n = sum(1 for t, _ in pre[c.user] if t >= 0)
            frames, done, first = _resume(b.port, c.user, c.rid, n)
            resumed[c.user] = (frames, done)
            firsts.append(first)
        replay = {c.user: _resume(b.port, c.user, c.rid, 0)[0] for c in clients}
        health_end = json.loads(_get(b.port, "/health"))
        metrics = _parse_prometheus(_get(b.port, "/metrics").decode())
        b.proc.send_signal(signal.SIGTERM)
        b_rc = b.proc.wait(timeout=180)
        return {"clients": {c.user: c.rid for c in clients}, "pre": pre,
                "resumed": resumed, "replay": replay, "health_a": health_a,
                "health_b": health_b, "health_end": health_end, "metrics": metrics,
                "exit_launches": _exit_launches(b.log.name),
                "recovered_rc": b_rc, "gen_done": {c.user: c.gen_done for c in clients},
                "restart_to_first_resumed_s": min(firsts) - b.t_spawn}
    finally:
        a.close()
        if b is not None:
            b.close()


def _exit_launches(log_path: str) -> dict:
    """The kernel launch counts a CLI process logged at the end of its
    graceful shutdown: its whole window, the drain included."""
    tag = "kernel launches "
    with open(log_path) as f:
        lines = [ln for ln in f if "graceful shutdown complete" in ln]
    if not lines:
        raise SystemExit(f"serve-durable: no shutdown line in {log_path}")
    text = lines[-1].split(tag, 1)[1]
    return json.loads(text[:text.rindex("}") + 1])


def _sigterm_run(wal_dir):
    """Start the CLI (bf16) on a fresh WAL dir, stream to the 4 users, and
    once each has 8 tokens send SIGTERM; 0.2 s later a fifth request
    (answered while the others drain). Returns what the gates need."""
    e = _Server("sigterm", "bfloat16", wal_dir)
    try:
        e.health()
        clients = [_Client(e.port, u) for u in DURABLE_USERS]
        deadline = time.monotonic() + 300
        while min(len(c.ids()) for c in clients) < 8:
            if time.monotonic() > deadline:
                raise SystemExit("serve-durable sigterm: streams never started")
            time.sleep(0.005)
        health = json.loads(_get(e.port, "/health"))
        e.proc.send_signal(signal.SIGTERM)
        at_signal = {c.user: len(c.ids()) for c in clients}
        time.sleep(0.2)
        late = _post_status(e.port, _durable_body("late", False), "late")
        for c in clients:
            c._gen.join(timeout=300)
        rc = e.proc.wait(timeout=300)
        return {"health": health, "exit_launches": _exit_launches(e.log.name),
                "late_status": late[0],
                "late_body": late[2][:200].decode(errors="replace"),
                "gen_done": {c.user: c.gen_done for c in clients},
                "tokens_at_signal": at_signal,
                "exit_code": rc}
    finally:
        e.close()


def serve_durable_phase(report) -> None:
    """Crash durability on the card (module docstring, serve-durable)."""
    import torch

    from ollamamq_tpu_torch.durability import load_wal_records
    from ollamamq_tpu_torch.engine.engine import TorchEngine
    from ollamamq_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from ollamamq_tpu_torch.telemetry import schema as tm

    t_phase = time.monotonic()
    root = os.path.join(OUT_DIR, "wal")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gc.collect()
    torch.cuda.empty_cache()
    reset_launch_counts()

    # In process, bf16: a warm-up run (in no timed run; its launches are
    # counted), then the same traffic without and with a WAL (off, on,
    # on, off, twice); the first run with a WAL is the bf16 reference.
    _, _, _, params = _serve_in_process(_durable_config("bfloat16"))
    fsync = tm.WAL_FSYNC_MS._default()
    fsync0 = list(fsync.counts)
    runs = []
    for i, wal in enumerate((False, True, True, False) * 2):
        ecfg = _durable_config("bfloat16", os.path.join(root, f"inproc-{i}") if wal else None)
        replies, secs, st, params = _serve_in_process(ecfg, params)
        runs.append({"wal": wal, "replies": replies, "seconds": secs, **st})
    fsync_ms = _delta_quantiles(fsync, fsync0, (0.5, 0.99))
    bf16_ref = runs[1]["replies"]
    # The float32 reference: uninterrupted, from a fresh WAL dir.
    f32_ref, f32_secs, _, _ = _serve_in_process(
        _durable_config("float32", os.path.join(root, "ref-f32")))
    inproc_counts = launch_counts()
    gc.collect()
    torch.cuda.empty_cache()

    f32 = _kill9_run("f32", "float32", os.path.join(root, "f32"))
    bf16 = _kill9_run("bf16", "bfloat16", os.path.join(root, "bf16"))
    term_dir = os.path.join(root, "sigterm")
    term = _sigterm_run(term_dir)
    term_wal, _ = load_wal_records(os.path.join(term_dir, "wal.jsonl"))
    restart = TorchEngine(_durable_config("bfloat16", term_dir), params=params)
    restart.start()
    term_recovered = restart.durability.recovered_streams
    restart.stop()
    del restart, params
    gc.collect()
    torch.cuda.empty_cache()

    def tps(rs):
        return [sum(len(r[0]) for r in run["replies"].values()) / run["seconds"]
                for run in rs]

    def p50(xs):
        xs = sorted(xs)
        return xs[len(xs) // 2]

    on = [r for r in runs if r["wal"]]
    off = [r for r in runs if not r["wal"]]
    own = ("ragged_paged_attention", "paged_decode_attention")
    # Each subprocess's whole window: the killed ones up to their last
    # /health read just before SIGKILL; the recovered and the SIGTERMed
    # ones from the counts they log at the end of their graceful exit.
    sub_counts = [f32["health_a"]["kernel_launches"], f32["exit_launches"],
                  bf16["health_a"]["kernel_launches"], bf16["exit_launches"],
                  term["exit_launches"]]
    launches = {k: inproc_counts[k] + sum(c[k] for c in sub_counts)
                for k in inproc_counts}

    def wal_ok(run):
        hs = (run["health_a"], run["health_end"])
        return all(not h["wal"]["wal"]["dead"] and not any(
            a["name"] == "wal_degraded" for a in h["alerts"]) for h in hs)

    def joined(frames):
        return [t for t, _ in frames if t >= 0], "".join(x for _, x in frames)

    streams = {}
    for name, run, ref in (("float32", f32, f32_ref), ("bfloat16", bf16, bf16_ref)):
        rows = {}
        for u in DURABLE_USERS:
            pre_ids, pre_text = joined(run["pre"][u])
            post_ids, post_text = joined(run["resumed"][u][0])
            ref_ids, ref_text, ref_why, _ = ref[u]
            rows[u] = {"rid": run["clients"][u], "read_before_kill": len(pre_ids),
                       "resumed": len(post_ids), "done": run["resumed"][u][1],
                       "ref_done": ref_why,
                       "identical": pre_ids + post_ids == ref_ids
                       and pre_text + post_text == ref_text,
                       "first_diff_vs_uninterrupted": _first_diff(pre_ids + post_ids,
                                                                  ref_ids),
                       "replay_equal": run["replay"][u][:len(run["pre"][u])]
                       == run["pre"][u],
                       "generate_conn": run["gen_done"][u]}
        streams[name] = rows
    recovered_total = {n: run["metrics"].get(("ollamamq_recovered_streams_total",
                                              'outcome="replayed"'))
                       for n, run in (("float32", f32), ("bfloat16", bf16))}
    rec_counts = f32["health_end"]["kernel_launches"]
    line = {
        "phase": "serve-durable", "model": DURABLE_MODEL,
        "max_new_tokens": DURABLE_NEW, "users": len(DURABLE_USERS),
        "wal_fsync_ms_window": 2.0, "seconds": time.monotonic() - t_phase,
        "streams": streams,
        "recovered_streams": {"float32": f32["health_b"]["wal"]["recovered_streams"],
                              "bfloat16": bf16["health_b"]["wal"]["recovered_streams"]},
        "recovered_streams_total": recovered_total,
        "recovered_exit_codes": {"float32": f32["recovered_rc"],
                                 "bfloat16": bf16["recovered_rc"]},
        "restart_to_first_resumed_s": {"float32": f32["restart_to_first_resumed_s"],
                                       "bfloat16": bf16["restart_to_first_resumed_s"]},
        "recovered_kernel_launches_f32": rec_counts,
        "sigterm": {**{k: term[k] for k in ("late_status", "late_body", "gen_done",
                                            "tokens_at_signal", "exit_code")},
                    "wal_unfinished": sum(1 for e in term_wal.values()
                                          if e["finished"] is None),
                    "restart_recovered": term_recovered},
        "tokens_per_s": {"wal_off": tps(off), "wal_on": tps(on)},
        "runs": [{"wal": r["wal"], "seconds": r["seconds"], **r["ticks"],
                  "ttft_ms": sorted(x[3] for x in r["replies"].values())}
                 for r in runs],
        "ttft_p50_ms": {"wal_off": p50([r[3] for run in off
                                        for r in run["replies"].values()]),
                        "wal_on": p50([r[3] for run in on
                                       for r in run["replies"].values()])},
        "wal_fsync_ms": fsync_ms, "fsyncs": [r["wal"]["wal"]["fsyncs"] for r in on],
        "journal_records_per_request": runs[1]["journal_seq"] / len(DURABLE_USERS),
        "journal_records_by_kind": runs[1]["kinds"],
        "f32_reference_s": f32_secs, "launches": launches, "card": card_line()}
    emit(line)
    report["serve_durable"] = line
    gates = {
        "f32_recovered_4": line["recovered_streams"]["float32"] == 4,
        "f32_identical": all(r["identical"] for r in streams["float32"].values()),
        "f32_kernels": all(rec_counts[k] > 0 for k in own)
        and all(rec_counts[k] == 0 for k in rec_counts if k not in own),
        "bf16_recovered_4": line["recovered_streams"]["bfloat16"] == 4,
        "bf16_done": all(r["done"] in ("stop", "length")
                         for r in streams["bfloat16"].values()),
        "bf16_replay_equal": all(r["replay_equal"] for r in streams["bfloat16"].values()),
        "wal_healthy": wal_ok(f32) and wal_ok(bf16)
        and all(not r["wal"]["wal"]["dead"] for r in on),
        "sigterm_503": term["late_status"] == 503,
        "sigterm_streams_complete": all(v in ("stop", "length")
                                        for v in term["gen_done"].values())
        and any(n < DURABLE_NEW for n in term["tokens_at_signal"].values()),
        "sigterm_exit_0": term["exit_code"] == 0,
        "sigterm_restart_recovers_0": term_recovered == 0
        and line["sigterm"]["wal_unfinished"] == 0,
        "inproc_replies": all(r[2] in ("stop", "length") for run in runs
                              for r in run["replies"].values())
        and all(r[2] in ("stop", "length") for r in f32_ref.values()),
    }
    line["gates"] = gates
    if not all(gates.values()):
        raise SystemExit(f"serve-durable gates failed: {gates}")


# -- serve-fleet: the fleet router, its members and KV page migration -------
FLEET_MODEL = "llama3.2:1b"
FLEET_NEW = 160
FLEET_ARGS = ["--max-slots", "4", "--num-pages", str(4 * 16 + 8), "--page-size", "32",
              "--max-pages-per-seq", "16", "--max-batch-tokens", "512",
              "--token-granule", "16", "--decode-steps", "8", "--seed", "0",
              "--max-new-tokens", str(FLEET_NEW), "--prefix-cache",
              "--placement", "affinity"]
# The device flag of the member subprocess (the CLI's default is cuda).
FLEET_DEVICE_ARGS = ["--device", "cuda"]
# 75 bytes plus BOS: two full 32-token pages of shared system prompt.
FLEET_SYSTEM = ("System: you are the careful assistant of a shared GPU cluster; "
                "answer briefly. ")
# A second tenant's system prompt (70 bytes plus BOS: two full pages),
# seen by one member only before the prefix-ship wave.
FLEET_SYSTEM_2 = "System: you speak for the second tenant; cite the manual, be terse. "
FLEET_USERS = {"ada": "Tell me about fair queues. ", "bob": "Why page the KV cache? ",
               "cyd": "Explain the decode kernel. ", "dee": "What is a drain? ",
               "sys-a": FLEET_SYSTEM + "Who goes first?",
               "sys-b": FLEET_SYSTEM + "What does a drain do?"}


def _fleet_router(dtype="bfloat16", kv_dtype="bfloat16", params=None,
                  n_local=2, urls=(), extra=(), cards=None):
    """The CLI's own fleet (cli.build_fleet) from FLEET_ARGS and `extra`
    flags: `n_local` TorchEngine members r0, ... and HTTP members h0, ...
    at `urls`, at the CLI's defaults (the router's 3 s heartbeat eject
    bound among them). Only the engine factory differs from the CLI's:
    the one-rank members (and any the autoscaler provisions) share one
    seeded weight tree; members wider than one rank (a tier's @tpN) lead
    worlds of their own on `cards` (fleet/wide.py CardPlan, the explicit
    device list). Returns (router, its EngineConfig, params)."""
    from ollamamq_tpu_torch import cli
    from ollamamq_tpu_torch.engine.engine import TorchEngine

    os.makedirs(OUT_DIR, exist_ok=True)
    args = cli.build_parser().parse_args(
        FLEET_ARGS + ["--model", FLEET_MODEL, "--dtype", dtype, "--kv-dtype", kv_dtype,
                      "--replicas", str(n_local), "--replica-urls", ",".join(urls),
                      "--blocklist", os.path.join(OUT_DIR, "blocked-fleet-router.json"),
                      *extra])
    err = cli.validate(args, cards)
    if err:
        raise SystemExit(f"fleet flags refused: {err}")
    ecfg = cli.engine_config(args)
    held = {"params": params}

    def make(cfg, device=None):
        eng = TorchEngine(cfg, params=held["params"], device=device)
        held["params"] = eng.runtimes[FLEET_MODEL].params
        return eng

    router = cli.build_fleet(args, ecfg, make, cards=cards)
    return router, ecfg, held["params"]


class _HeartbeatWatch:
    """The longest heartbeat age each member showed while healthy, sampled
    every 5 ms over a window: its margin under the router's eject bound
    (a drained member's restart is not counted)."""

    def __init__(self, router):
        self.router, self.max_age = router, {}
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        while not self._stop.wait(0.005):
            for m in list(self.router.members):
                if m.state == "healthy":
                    age = m.heartbeat_age()
                    self.max_age[m.name] = max(age, self.max_age.get(m.name, 0.0))

    def stop(self) -> dict:
        self._stop.set()
        self._thread.join(timeout=5)
        return self.max_age


def _ejects(router):
    return [r for r in router.journal.tail(None) if r["kind"] == "replica_eject"]


def _flight(router, user, budget=300.0, placed=True):
    deadline = time.monotonic() + budget
    while time.monotonic() < deadline:
        for f in list(router.flights):
            if f.user == user and (f.member is not None or not placed):
                return f
        time.sleep(0.005)
    raise SystemExit(f"serve-fleet: {user}'s stream was never placed")


def _wait_tokens(router, users, n, budget=300.0):
    """Until each user's live attempt (an in-process member's) holds n
    generated ids."""
    deadline = time.monotonic() + budget
    while time.monotonic() < deadline:
        fl = {f.user: f for f in list(router.flights)}
        if all(u in fl and fl[u].attempt is not None
               and len(fl[u].attempt.req.generated_ids) >= n for u in users):
            return
        time.sleep(0.005)
    fl = {f.user: f for f in list(router.flights)}
    state = {u: ((fl[u].member.name if fl[u].member else None,
                  len(fl[u].attempt.req.generated_ids) if fl[u].attempt else None,
                  fl[u].done) if u in fl else
                 [{k: r.get(k) for k in ("kind", "replica", "reason", "tokens")}
                  for r in router.journal.tail(None)
                  if r.get("user") == u and r["kind"] in ("finish", "place",
                                                         "replica_failover")])
             for u in users}
    raise SystemExit(f"serve-fleet: {users} never reached {n} tokens: {state}")


def _fleet_metrics():
    from ollamamq_tpu_torch.telemetry import schema as tm

    out = {o: tm.FLEET_MIGRATIONS_TOTAL.labels(outcome=o).value
           for o in ("migrated", "aborted", "prefix")}
    out["bytes"] = tm.FLEET_MIGRATE_BYTES_TOTAL.value
    out["failovers"] = tm.FLEET_FAILOVERS_TOTAL.value
    return out


def _delta(after, before):
    return {k: after[k] - before[k] for k in after}


def _handoffs(recs):
    """Per migrated stream: ms from the export's start to the commit (the
    router journals migrate_import after the source's commit), pages."""
    exports = {}
    out = []
    for r in recs:
        if r["kind"] == "migrate_export":
            exports[r["req_id"]] = r
        elif r["kind"] == "migrate_import" and r.get("what") != "prefix":
            e = exports.get(r["req_id"])
            if e is not None:
                out.append({"req_id": r["req_id"], "from": r["replica"],
                            "to": r["to_replica"], "tokens": r["tokens"],
                            "pages": r["pages"], "bytes": r["bytes"],
                            "ms": (r["t"] - e["t"]) * 1e3 + e["overhead_ms"]})
    return out


def _shipped_pages(recs):
    """Pages the router shipped: every migrate_export's run plus every
    prefix shipment (the migrate-bytes counter counts both)."""
    return (sum(r["pages"] for r in recs if r["kind"] == "migrate_export")
            + sum(r["pages"] for r in recs
                  if r["kind"] == "migrate_import" and r.get("what") == "prefix"))


def _stream_ids(router, user, prompt, max_tokens, drain_at=None, budget=600.0):
    """One greedy stream through the router in process: its token ids and
    finish; with `drain_at`, its member is drained once it holds that many
    tokens (the stream migrates). Returns (ids, done item, migrated depth
    or None)."""
    from ollamamq_tpu_torch.ops.sampling import SamplingParams

    rt = router.resolve_runtime(FLEET_MODEL)
    req = router.enqueue_request(user, "", FLEET_MODEL,
                                 prompt_tokens=rt.tokenizer.encode(prompt),
                                 sampling=SamplingParams(max_tokens=max_tokens),
                                 raw_prompt=prompt)
    depth = None
    if drain_at is not None:
        f = _flight(router, user)
        _wait_tokens(router, [user], drain_at)
        src = f.member
        depth = len(f.attempt.req.generated_ids)
        router.drain_replica(src.name)
        deadline = time.monotonic() + budget
        while f.member is src and not f.done and time.monotonic() < deadline:
            time.sleep(0.002)
    items = _collect(req, timeout=budget)
    ids = [i.token_id for i in items if i.kind == "token" and i.token_id >= 0]
    deadline = time.monotonic() + 60
    while router.fleet_counts()["healthy"] < len(router.members) \
            and time.monotonic() < deadline:
        time.sleep(0.01)
    return ids, items[-1], depth


def _blob_bytes(rt, page_bytes, pages, streams):
    """What the migrate-bytes counter must show: every shipped page, plus
    each migrated stream's penalty-ring row (the blob's other array)."""
    return page_bytes * pages + streams * rt.recent.shape[1] * rt.recent.element_size()


def _fleet_in_process(card):
    """(a) two bf16 members behind the HTTP server, r0 drained mid-stream;
    then the holder of the system prompt filled so that one more system
    stream misses it and the prefix is shipped; then one stream alone,
    unmigrated and migrated (bf16, not gated)."""
    from ollamamq_tpu_torch.engine import kv_cache as kvc
    from ollamamq_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from ollamamq_tpu_torch.ops.sampling import SamplingParams
    from ollamamq_tpu_torch.server.app import serve_in_thread, stop_server
    from ollamamq_tpu_torch.tools.journal import check_no_dropped_streams

    router, ecfg, params = _fleet_router()
    srv = serve_in_thread(router, port=0, timeout_s=600)
    port = srv.server_address[1]
    try:
        # Warm-ups: the first placement of a fresh router goes to r1, the
        # second (a tie again) to r0, which then caches the system prompt.
        for user, prompt in (("warm", "Warm up the card."),
                             ("sys", FLEET_SYSTEM + "Hello.")):
            _post(port, "/api/generate", {"model": FLEET_MODEL, "prompt": prompt,
                                          "stream": False,
                                          "options": {"temperature": 0,
                                                      "num_predict": 8}}, user)
        holder = router.journal.tail(None, kind="place")[-1]["runtime"]
        sys_tokens = router.resolve_runtime(FLEET_MODEL).tokenizer.encode(FLEET_SYSTEM)
        cached = {m.name: m.affinity_pages(FLEET_MODEL, sys_tokens)
                  for m in router.members}
        m0 = _fleet_metrics()
        seq0 = router.journal.seq
        mseq0 = {m.name: m.engine.journal.seq for m in router.members}
        hits0 = {m.name: m.engine.prefix_cache_stats()["models"][FLEET_MODEL]["hits"]
                 for m in router.members}
        from ollamamq_tpu_torch.telemetry import schema as tm

        aff0 = tm.FLEET_AFFINITY_HITS_TOTAL.value
        reset_launch_counts()
        watch = _HeartbeatWatch(router)
        results, errors = {}, []

        def run(user):
            body = {"model": FLEET_MODEL, "prompt": FLEET_USERS[user],
                    "options": {"temperature": 0, "num_predict": FLEET_NEW}}
            try:
                frames = [json.loads(x) for x in
                          _ndjson(port, "POST", "/api/generate", body, user)]
                results[user] = ([t for f in frames for t in f.get("token_ids", [])],
                                 frames[-1])
            except Exception as e:  # noqa: BLE001 — reported, fails the phase
                errors.append(f"{user}: {e}")

        t0 = time.monotonic()
        # Wave A starts 64 tokens ahead of wave B: at the drain r1 has one
        # free slot for r0's oldest stream, and wave A finishing frees the
        # two r1 slots r0's last two streams then migrate into.
        threads = {u: threading.Thread(target=run, args=(u,)) for u in FLEET_USERS}
        for u in ("ada", "bob"):
            threads[u].start()
        for u in ("ada", "bob"):
            _flight(router, u)
        _wait_tokens(router, ["ada", "bob"], 64)
        for u in ("cyd", "dee", "sys-a", "sys-b"):
            threads[u].start()
        for u in FLEET_USERS:
            _flight(router, u)
        _wait_tokens(router, list(FLEET_USERS), 32)
        placed = {f.user: f.member.name for f in list(router.flights)}
        _, data = _post(port, "/admin/drain/r0", {}, "admin")
        drain = json.loads(data)
        for t in threads.values():
            t.join(timeout=600)
        seconds = time.monotonic() - t0
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            fleet = json.loads(_get(port, "/admin/fleet"))
            if fleet["counts"]["healthy"] == 2:
                break
            time.sleep(0.05)
        window_recs = [r for r in router.journal.tail(None) if r["seq"] >= seq0]
        hits = {m.name: m.engine.prefix_cache_stats()["models"][FLEET_MODEL]["hits"]
                - hits0[m.name] for m in router.members}

        # The prefix ship: both members now hold the first system prompt
        # (r0 from the warm-up, r1 from the streams that migrated there),
        # so a second tenant's prompt is cached on one member by a
        # warm-up; then max_slots of its streams fill the holder (affinity),
        # and one more, sent once every slot there is decoding, misses it:
        # the router ships the cached prefix to the other member, whose
        # admission then hits its cache.
        _post(port, "/api/generate", {"model": FLEET_MODEL, "stream": False,
                                      "prompt": FLEET_SYSTEM_2 + "Hello.",
                                      "options": {"temperature": 0,
                                                  "num_predict": 8}}, "sys2")
        tok = router.resolve_runtime(FLEET_MODEL).tokenizer
        holders = {m.name: m.affinity_pages(FLEET_MODEL, tok.encode(FLEET_SYSTEM_2))
                   for m in router.members}
        hits1 = {m.name: m.engine.prefix_cache_stats()["models"][FLEET_MODEL]["hits"]
                 for m in router.members}
        holder_rt = next(m for m in router.members
                         if holders[m.name]).engine.runtimes[FLEET_MODEL]

        def send(i, n):
            p = FLEET_SYSTEM_2 + f"Question {i}?"
            return router.enqueue_request(f"sys2-{i}", "", FLEET_MODEL,
                                          prompt_tokens=tok.encode(p),
                                          sampling=SamplingParams(max_tokens=n),
                                          raw_prompt=p)

        ship_reqs = [send(i, 48) for i in range(ecfg.max_slots)]
        deadline = time.monotonic() + 120
        while holder_rt.free_slots() and time.monotonic() < deadline:
            time.sleep(0.002)
        ship_reqs.append(send(ecfg.max_slots, 16))
        ship_ends = [_collect(r)[-1] for r in ship_reqs]
        ship_hits = {m.name: m.engine.prefix_cache_stats()["models"][FLEET_MODEL]["hits"]
                     - hits1[m.name] for m in router.members}
        max_age = watch.stop()
        counts = launch_counts()
        m1 = _delta(_fleet_metrics(), m0)
        recs = [r for r in router.journal.tail(None) if r["seq"] >= seq0]
        ships = [r for r in recs if r["kind"] == "migrate_import"
                 and r.get("what") == "prefix"]
        member_recs = {m.name: [r for r in m.engine.journal.tail(None)
                                if r["seq"] >= mseq0[m.name]] for m in router.members}
        rt0 = router.members[0].engine.runtimes[FLEET_MODEL]
        page_bytes = kvc.kv_page_bytes(rt0.cfg, ecfg.page_size, 2)
        shipped = _shipped_pages(recs)
        used = {m.name: m.engine.runtimes[FLEET_MODEL].alloc.used_pages
                for m in router.members}
        enq = {r["user"]: r["t"] for r in window_recs if r["kind"] == "enqueue"}
        installs = {}  # a stream's first install: its first token
        for rs in member_recs.values():
            for r in rs:
                if r["kind"] == "install" and r.get("user") in enq:
                    installs[r["user"]] = min(r["t"], installs.get(r["user"], r["t"]))
        ttft = sorted((installs[u] - enq[u]) * 1e3 for u in installs)
        overhead = router.router_overhead_stats()["sites"]
        tokens = sum(len(ids) for ids, _ in results.values())

        # The same prompt alone, unmigrated and then migrated at 16 tokens
        # (bf16: printed, not gated).
        lone = "A lone stream to migrate: tell me about pages. "
        ref_ids, _, _ = _stream_ids(router, "lone", lone, 96)
        mig_ids, mig_end, mig_depth = _stream_ids(router, "lone", lone, 96, drain_at=16)
    finally:
        stop_server(srv)
    gates = {
        "replies": not errors and len(results) == len(FLEET_USERS)
        and all(fr.get("done") and fr.get("done_reason") in ("stop", "length")
                and "error" not in fr for _, fr in results.values()),
        "migrated_all_of_r0": m1["migrated"] == drain["inflight"] >= 1,
        "no_failover": m1["failovers"] == 0
        and not any(r["kind"] == "replica_failover" for r in recs),
        "no_eject": not any(r["kind"] == "replica_eject" for r in recs),
        "bytes": m1["bytes"] == _blob_bytes(rt0, page_bytes, shipped, m1["migrated"])
        and shipped > 0,
        "prefix_shipped": m1["prefix"] >= 1 and len(ships) == m1["prefix"]
        and all(ship_hits[r["to_replica"]] >= 1 for r in ships)
        and all(e.kind == "done" for e in ship_ends),
        "no_dropped": check_no_dropped_streams(recs) == []
        and all(check_no_dropped_streams(rs) == [] for rs in member_recs.values()),
        "no_used_pages": all(v == 0 for v in used.values()),
        "r0_healthy": any(r["name"] == "r0" and r["state"] == "healthy"
                          for r in fleet["replicas"]),
        "kernels": counts["ragged_paged_attention"] > 0
        and counts["paged_decode_attention"] > 0,
    }
    handoffs = _handoffs(recs)
    line = {"phase": "serve-fleet", "part": "a-in-process-bf16", "model": FLEET_MODEL,
            "members": 2, "slots_per_member": ecfg.max_slots, "users": len(FLEET_USERS),
            "max_new_tokens": FLEET_NEW, "seconds": seconds,
            "tokens_per_s": tokens / seconds, "placed": placed,
            "system_prompt_holder": holder, "system_pages_cached": cached,
            "prefix_hits": hits, "affinity_hits": tm.FLEET_AFFINITY_HITS_TOTAL.value - aff0,
            "prefix_holders_before_ship": holders, "prefix_ships": ships,
            "prefix_hits_during_ship": ship_hits,
            "max_heartbeat_age_s": max_age, "eject_heartbeat_s": router.eject_heartbeat_s,
            "drain": drain, "metrics": m1, "page_bytes": page_bytes,
            "pages_shipped": shipped, "handoffs": handoffs,
            "handoff_ms": [h["ms"] for h in handoffs],
            "ttft_ms_router_enqueue_to_first_token": ttft,
            "ttft_p50_ms": ttft[len(ttft) // 2] if ttft else None,
            "router_overhead_ms": {s: {k: v[k] for k in ("count", "p50_ms", "p99_ms")}
                                   for s, v in overhead.items()},
            "journal_kinds": sorted({r["kind"] for r in recs}),
            "launches": counts, "used_pages": used,
            "bf16_lone": {"migrated_at": mig_depth, "tokens": len(mig_ids),
                          "done": mig_end.finish_reason.value if mig_end.finish_reason
                          else mig_end.kind,
                          "first_diff_vs_unmigrated": _first_diff(mig_ids, ref_ids)},
            "card": card, "gates": gates}
    emit(line)
    del router, srv
    return line, params


def _fleet_f32(card):
    """(b) float32, TF32 off: one stream migrated at 16 and then at 64
    tokens must give the unmigrated run's ids."""
    import torch

    from ollamamq_tpu_torch.ops.cuda import launch_counts, reset_launch_counts

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    router, _, params = _fleet_router(dtype="float32")
    router.start()
    reset_launch_counts()
    watch = _HeartbeatWatch(router)
    prompt = "The quick brown fox jumps over the lazy dog; migrate me, please."
    t0 = time.monotonic()
    try:
        ref, end, _ = _stream_ids(router, "f32", prompt, 96)
        runs = {}
        for at in (16, 64):
            ids, e, depth = _stream_ids(router, "f32", prompt, 96, drain_at=at)
            runs[at] = {"migrated_at": depth, "tokens": len(ids),
                        "identical": ids == ref,
                        "first_diff": _first_diff(ids, ref),
                        "done": e.finish_reason.value if e.finish_reason else e.kind}
        migrations = router.migration_count
        failovers = router.failover_count
        ejects = _ejects(router)
    finally:
        max_age = watch.stop()
        router.stop()
    del router, params
    gates = {"f32_identical": all(r["identical"] for r in runs.values()),
             "f32_migrated": migrations == 2 and failovers == 0 and not ejects,
             "f32_done": end.kind == "done"
             and all(r["done"] in ("stop", "length") for r in runs.values())}
    line = {"phase": "serve-fleet", "part": "b-f32", "tf32": False,
            "tokens": len(ref), "runs": runs, "seconds": time.monotonic() - t0,
            "max_heartbeat_age_s": max_age,
            "launches": launch_counts(), "card": card, "gates": gates}
    emit(line)
    return line


def _fleet_int8(card, params):
    """(c) int8 KV pages: one stream migrated between two int8-KV members;
    the target's page run right after the import equals the shipped
    payload and scale planes bit for bit, and the int8 decode kernel runs
    on the target."""
    import torch

    from ollamamq_tpu_torch.engine import kv_cache as kvc
    from ollamamq_tpu_torch.ops.cuda import launch_counts, reset_launch_counts

    router, _, _ = _fleet_router(kv_dtype="int8", params=params)
    captured = []
    for mem in router.members:
        rt = mem.engine.runtimes[FLEET_MODEL]

        def spy(blob, req, rt=rt, orig=rt.import_request):
            ok = orig(blob, req)  # on the loop thread, before any dispatch
            if ok:
                slot = next(i for i, r in enumerate(rt.slot_req) if r is req)
                captured.append((blob, kvc.gather_page_run(
                    rt.kc, rt.vc, rt.slot_pages[slot], rt.ecfg.page_size)))
            return ok

        rt.import_request = spy
    router.start()
    watch = _HeartbeatWatch(router)
    t0 = time.monotonic()
    try:
        from ollamamq_tpu_torch.ops.sampling import SamplingParams

        prompt = "Migrate an int8 page run between two members, please."
        rt = router.resolve_runtime(FLEET_MODEL)
        req = router.enqueue_request("i8", "", FLEET_MODEL,
                                     prompt_tokens=rt.tokenizer.encode(prompt),
                                     sampling=SamplingParams(max_tokens=96),
                                     raw_prompt=prompt)
        f = _flight(router, "i8")
        _wait_tokens(router, ["i8"], 16)
        src = f.member
        router.drain_replica(src.name)
        deadline = time.monotonic() + 120
        while f.member is src and not f.done and time.monotonic() < deadline:
            time.sleep(0.002)
        # From here the source is idle: every launch is the target's.
        reset_launch_counts()
        target = f.member.name
        items = _collect(req)
        counts = launch_counts()
        ejects = _ejects(router)
    finally:
        max_age = watch.stop()
        router.stop()
    del router

    def raw(t):
        return t.contiguous().view(torch.uint8)

    keys = ("k_pages", "v_pages", "k_scale", "v_scale")
    equal = bool(captured) and all(
        torch.equal(raw(got[k]), raw(blob[k])) for blob, got in captured for k in keys)
    gates = {"int8_pages_bit_equal": equal and len(captured) == 1,
             "int8_done": items[-1].kind == "done" and not ejects,
             "int8_decode_on_target": counts["paged_decode_attention_int8"] > 0
             and counts["paged_decode_attention"] == 0}
    line = {"phase": "serve-fleet", "part": "c-int8-kv", "source": src.name,
            "target": target, "pages": int(captured[0][0]["n_pages"]) if captured else 0,
            "payload_dtypes": ({k: str(captured[0][0][k].dtype) for k in keys}
                               if captured else None),
            "tokens": sum(1 for i in items if i.kind == "token"),
            "seconds": time.monotonic() - t0, "target_launches": counts,
            "max_heartbeat_age_s": max_age,
            "card": card, "gates": gates}
    emit(line)
    return line


def _fleet_wire(card, params):
    """(d) a member subprocess joined through --replica-urls as h0, drained
    while it streams: the stream migrates over /admin/migrate/export ->
    import -> commit into the local member r0."""
    from ollamamq_tpu_torch.engine import kv_cache as kvc
    from ollamamq_tpu_torch.ops.sampling import SamplingParams
    from ollamamq_tpu_torch.tools.journal import check_no_dropped_streams

    os.makedirs(OUT_DIR, exist_ok=True)
    log_path = os.path.join(OUT_DIR, "serve-fleet-h0.log")
    start = os.path.getsize(log_path) if os.path.exists(log_path) else 0
    log = open(log_path, "ab")
    proc = subprocess.Popen(
        [sys.executable, "-m", "ollamamq_tpu_torch.cli", *FLEET_ARGS,
         *FLEET_DEVICE_ARGS, "--model", FLEET_MODEL, "--port", "0",
         "--no-tui", "--timeout-s", "600", "--stop-grace-s", "60",
         "--blocklist", os.path.join(OUT_DIR, "blocked-fleet.json")],
        cwd=os.path.dirname(os.path.abspath(__file__)), stdout=log,
        stderr=subprocess.STDOUT)
    router = None
    t0 = time.monotonic()
    try:
        port = _bound_port(proc, log_path, start, "serve-fleet: member")
        deadline = time.monotonic() + 300
        while True:
            if proc.poll() is not None:
                raise SystemExit(f"serve-fleet: member exited {proc.returncode} "
                                 f"(log {log.name}):\n{_log_tail(log.name)}")
            try:
                _get(port, "/health")
                break
            except (OSError, RuntimeError):
                if time.monotonic() > deadline:
                    raise SystemExit("serve-fleet: the member never answered")
                time.sleep(0.2)
        spawn_s = time.monotonic() - t0
        # Members [r0, h0]: the first placement of a fresh router goes to
        # the second member, h0.
        router, ecfg, _ = _fleet_router(params=params, n_local=1,
                                        urls=[f"http://127.0.0.1:{port}"])
        router.start()
        watch = _HeartbeatWatch(router)
        m0 = _fleet_metrics()
        prompt = "Stream from the member process, then move to the router's."
        rt = router.resolve_runtime(FLEET_MODEL)
        req = router.enqueue_request("wire", "", FLEET_MODEL,
                                     prompt_tokens=rt.tokenizer.encode(prompt),
                                     sampling=SamplingParams(max_tokens=FLEET_NEW),
                                     raw_prompt=prompt)
        f = _flight(router, "wire")
        h0 = f.member
        # Decoding on h0: its journal holds the install, and its stream
        # id is known (the X-Request-ID header).
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline:
            evs = json.loads(_get(port, "/debug/journal?user=wire&kind=install"))
            if evs["events"] and f.attempt.member_rid is not None:
                break
            time.sleep(0.01)
        time.sleep(0.3)
        drain = router.drain_replica(h0.name)
        deadline = time.monotonic() + 120
        while f.member is h0 and not f.done and time.monotonic() < deadline:
            time.sleep(0.002)
        items = _collect(req)
        m1 = _delta(_fleet_metrics(), m0)
        recs = router.journal.tail(None)
        handoffs = _handoffs(recs)
        rt0 = router.members[0].engine.runtimes[FLEET_MODEL]
        page_bytes = kvc.kv_page_bytes(rt0.cfg, ecfg.page_size, 2)
        shipped = _shipped_pages(recs)
        r0_used = rt0.alloc.used_pages
        max_age = watch.stop()
    finally:
        if router is not None:
            router.stop()
        if proc.poll() is None:
            proc.send_signal(signal.SIGTERM)
        try:
            rc = proc.wait(timeout=120)
        except subprocess.TimeoutExpired:
            proc.kill()
            rc = proc.wait(timeout=60)
        log.close()
    exit_counts = _exit_launches(log.name)
    gates = {
        "wire_migrated": m1["migrated"] == drain["inflight"] == 1
        and any(h["from"] == "h0" and h["to"] == "r0" for h in handoffs),
        "wire_no_failover": m1["failovers"] == 0
        and not any(r["kind"] == "replica_eject" for r in recs),
        "wire_bytes": m1["bytes"] == _blob_bytes(rt0, page_bytes, shipped, m1["migrated"])
        and shipped > 0,
        "wire_done": items[-1].kind == "done"
        and check_no_dropped_streams(recs) == [] and r0_used == 0,
        "member_kernels": exit_counts["ragged_paged_attention"] > 0
        and exit_counts["paged_decode_attention"] > 0,
        "member_exit_0": rc == 0,
    }
    line = {"phase": "serve-fleet", "part": "d-over-the-wire", "member_spawn_s": spawn_s,
            "drain": drain, "metrics": m1, "pages_shipped": shipped,
            "page_bytes": page_bytes, "handoffs": handoffs,
            "handoff_ms": [h["ms"] for h in handoffs],
            "tokens": sum(1 for i in items if i.kind == "token"),
            "seconds": time.monotonic() - t0, "member_launches": exit_counts,
            "max_heartbeat_age_s": max_age,
            "card": card, "gates": gates}
    emit(line)
    return line


def serve_fleet_phase(report) -> None:
    """The fleet router, its members and KV page migration on the card
    (module docstring, serve-fleet)."""
    import torch

    from ollamamq_tpu_torch.ops.cuda import launch_counts, reset_launch_counts

    t_phase = time.monotonic()
    card = card_line()
    gc.collect()
    torch.cuda.empty_cache()
    a, params = _fleet_in_process(card)
    window = dict(a["launches"])
    b = _fleet_f32(card)
    c = _fleet_int8(card, params)
    reset_launch_counts()
    d = _fleet_wire(card, params)
    d_local = launch_counts()
    del params
    gc.collect()
    torch.cuda.empty_cache()
    # The phase's windows: (a)'s serving, (b) and (c) whole ((c) counted
    # from its target's first step after the import), (d)'s local member
    # and the member subprocess's whole run.
    launches = {k: window[k] + b["launches"][k] + c["target_launches"][k]
                + d_local[k] + d["member_launches"][k] for k in window}
    gates = {**a["gates"], **b["gates"], **c["gates"], **d["gates"]}
    line = {"phase": "serve-fleet", "seconds": time.monotonic() - t_phase,
            "handoff_ms_in_process": a["handoff_ms"], "handoff_ms_wire": d["handoff_ms"],
            "router_overhead_place_ms": a["router_overhead_ms"].get("place"),
            "ttft_p50_ms": a["ttft_p50_ms"], "tokens_per_s": a["tokens_per_s"],
            "prefix_ships": len(a["prefix_ships"]),
            "max_heartbeat_age_s": {p["part"]: p["max_heartbeat_age_s"] for p in (a, b, c, d)},
            "launches": launches, "card": card, "gates": gates}
    emit(line)
    report["serve_fleet"] = line
    if not all(gates.values()):
        raise SystemExit(f"serve-fleet gates failed: {gates}")


# The one-rank window: every member at tp 1, at the CLI's TTFT objective
# (500 ms) and eject bound (3 s), so tier isolation is gated at the
# objective the tiers default to.
TIERS_SPEC_TP1 = "interactive=r0;bulk=r1,r2"
TIERS_SPEC = "interactive@tp2=r0;bulk=r1,r2"
# Slots of the tiered fleets' card plan, all on cuda:0 (ranks share the
# card over gloo): r0's two ranks, r1, r2, and the one more r2 takes when
# it regroups to tp 2.
TIERS_CARDS = ["cuda:0"] * 5
# Tokens of each tiers stream, and the tokens wave a holds before wave b
# starts. Every stream must still be live when the waves' waits read it
# and when r2's regroup drains it; a wide member's ranks time-slicing the
# card start their streams late, and at 160 tokens and 64 the bulk
# streams often ended first (PERF.md §6).
TIERS_NEW = 256
TIERS_WAVE_A = 32
TIERS_USERS = {"vip-a": ("vip", "Tell me about fair queues. "),
               "vip-b": ("boost", "Why page the KV cache? "),
               "dl": ("deadline", "Explain the decode kernel. "),
               "b1": ("default", "What is a drain? "),
               "b2": ("default", "How does a regroup move a member? "),
               "b3": ("default", "Why two tiers of replicas? "),
               "b4": ("default", "What does the balancer watch? ")}
# The tiered fleets' eject bound. A wide member's ranks here time-slice
# the one card with the other members' process (two CUDA contexts, no
# MPS), and every layer's all_reduce waits on both: on an H100 its loop
# iterations ran past the CLI's 3 s bound and it was ejected as stale.
# A deployment gives each member's ranks cards of their own; the phase
# records the longest heartbeat age instead.
TIERS_EJECT_S = 60.0
# After the regroup, two interactive (deadlined) streams at once: one a
# member of the interactive tier.
TIERS_LATE = {"late-a": "What does a wide member start? ",
              "late-b": "Who reaps a member's ranks? "}


def _tiers_run(port, results, errors, user, prompt=None, cls=None):
    """One greedy TIERS_NEW-token /api/generate stream of a TIERS_USERS
    user (or `prompt` of class `cls`): its ids and last frame land in
    `results`, its error in `errors`."""
    cls, prompt = TIERS_USERS.get(user, (cls, prompt))
    opts = {"temperature": 0, "num_predict": TIERS_NEW}
    if cls == "deadline":
        opts["deadline_ms"] = 600000
    try:
        frames = [json.loads(x) for x in
                  _ndjson(port, "POST", "/api/generate",
                          {"model": FLEET_MODEL, "prompt": prompt,
                           "options": opts}, user) if x.strip()]
        results[user] = ([t for f in frames for t in f.get("token_ids", [])],
                         frames[-1])
    except Exception as e:  # noqa: BLE001 — reported, fails the phase
        errors.append(f"{user}: {e}")


def _tiers_warm(router, port):
    """VIP and boost users set, then one warm-up per tier (a deadline
    makes it interactive)."""
    router.core.set_vip("vip-a")
    router.core.set_boost("vip-b")
    for user, opts in (("warm-i", {"deadline_ms": 600000}), ("warm-b", {})):
        _post(port, "/api/generate", {"model": FLEET_MODEL, "prompt": "Warm up.",
                                      "stream": False,
                                      "options": {"temperature": 0,
                                                  "num_predict": 8, **opts}}, user)


def _tiers_waves(router, port, results, errors):
    """TIERS_USERS' streams in two waves TIERS_WAVE_A tokens apart;
    returns their threads once every stream holds 16 tokens (wave a's
    bulk streams on r2 are still live then: the regroup that follows
    drains them)."""
    threads = {u: threading.Thread(target=_tiers_run, args=(port, results, errors, u))
               for u in TIERS_USERS}
    wave_a, wave_b = ("vip-a", "b1", "b2"), ("vip-b", "dl", "b3", "b4")
    for u in wave_a:
        threads[u].start()
    for u in wave_a:
        _flight(router, u)
    _wait_tokens(router, list(wave_a), TIERS_WAVE_A)
    for u in wave_b:
        threads[u].start()
    for u in wave_b:
        _flight(router, u)
    _wait_tokens(router, list(TIERS_USERS), 16)
    return threads


def _tiers_wait_interactive(port, name, budget):
    """GET /admin/tiers until `name` serves in the interactive tier (or
    the budget ends); returns the last reading."""
    deadline = time.monotonic() + budget
    while True:
        tiers = json.loads(_get(port, "/admin/tiers"))
        if any(m["name"] == name and m["state"] == "healthy"
               for m in tiers["tiers"]["interactive"]["members"]) \
                or time.monotonic() > deadline:
            return tiers
        time.sleep(0.05)


def _tiers_ttft(recs, member_recs):
    """({user: TTFT ms}, {tier: p50 ms}): the router's enqueue to the
    member's first install (its first token), both journals on this
    process's clock."""
    enq = {r["user"]: r["t"] for r in recs if r["kind"] == "enqueue"}
    first = {}
    for rs in member_recs.values():
        for r in rs:
            if r["kind"] == "install" and r.get("user") in TIERS_USERS:
                first[r["user"]] = min(r["t"], first.get(r["user"], r["t"]))
    ttft = {u: (first[u] - enq[u]) * 1e3 for u in first if u in enq}
    by_tier = {t: sorted(ms for u, ms in ttft.items()
                         if (TIERS_USERS[u][0] == "default") == (t == "bulk"))
               for t in ("interactive", "bulk")}
    return ttft, {t: (v[len(v) // 2] if v else None) for t, v in by_tier.items()}


def _tiers_tp1(card):
    """serve-tiers' one-rank window (module docstring): every member at
    tp 1 under TIERS_SPEC_TP1, at the CLI's TTFT objective and eject
    bound; r2 regrouped to interactive under load (a re-label at its
    width, the same engine restarted)."""
    import torch

    from ollamamq_tpu_torch.fleet.router import EJECT_HEARTBEAT_S
    from ollamamq_tpu_torch.fleet.tiering import INTERACTIVE_TTFT_MS
    from ollamamq_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from ollamamq_tpu_torch.server.app import serve_in_thread, stop_server
    from ollamamq_tpu_torch.telemetry.journal import check_invariants
    from ollamamq_tpu_torch.tools.journal import (check_no_dropped_streams,
                                                  check_regroup_pairing)

    router, ecfg, params = _fleet_router(
        n_local=3, extra=["--tiers", TIERS_SPEC_TP1, "--journal-ring", "1000000"])
    bounds = {"interactive_ttft_ms": router.tiers.objectives["interactive"].threshold_ms,
              "eject_heartbeat_s": router.eject_heartbeat_s}
    before = _member_dispatches(router, FLEET_MODEL)
    reset_launch_counts()
    srv = serve_in_thread(router, port=0, timeout_s=600)
    port = srv.server_address[1]
    layers = router.resolve_runtime(FLEET_MODEL).cfg.num_layers
    r2 = next(m for m in router.members if m.name == "r2")
    try:
        _tiers_warm(router, port)
        seq0 = router.journal.seq
        mseq0 = {m.name: m.engine.journal.seq for m in router.members}
        results, errors = {}, []
        t0 = time.monotonic()
        threads = _tiers_waves(router, port, results, errors)
        placed = {f.user: f.member.name for f in list(router.flights)}
        on_r2 = sorted(f.user for f in list(router.flights)
                       if f.member is r2 and not f.done)
        _, data = _post(port, "/admin/retier/r2", {"tier": "interactive"}, "admin")
        retier = json.loads(data)
        for t in threads.values():
            t.join(timeout=600)
        seconds = time.monotonic() - t0
        tiers = _tiers_wait_interactive(port, "r2", 60)
        counts = launch_counts()
        after = _member_dispatches(router, FLEET_MODEL)
        recs = [r for r in router.journal.tail(None) if r["seq"] >= seq0]
        member_recs = {m.name: [r for r in m.engine.journal.tail(None)
                                if r["seq"] >= mseq0[m.name]] for m in router.members}
        used = {m.name: m.engine.runtimes[FLEET_MODEL].alloc.used_pages
                for m in router.members}
    finally:
        stop_server(srv)
    del router, srv, params, r2
    gc.collect()
    torch.cuda.empty_cache()

    places = [r for r in recs if r["kind"] == "tier_place"]
    regroup = [r for r in recs if r["kind"] == "tier_regroup"]
    imports = [r for r in recs if r["kind"] == "migrate_import"
               and r.get("what") != "prefix"]
    per_member, kernels_ok = _kernels_per_member(before, after, counts, layers,
                                                 ["r0", "r1", "r2"])
    ttft, ttft_p50 = _tiers_ttft(recs, member_recs)
    gates = {
        "default_bounds": bounds == {"interactive_ttft_ms": INTERACTIVE_TTFT_MS,
                                     "eject_heartbeat_s": EJECT_HEARTBEAT_S},
        "replies": not errors and len(results) == len(TIERS_USERS)
        and all(fr.get("done") and fr.get("done_reason") in ("stop", "length")
                and "error" not in fr for _, fr in results.values()),
        "interactive_in_tier": all(
            r["tier"] == "interactive" and r["replica"] in ("r0", "r2")
            and not r.get("overflow")
            for r in places if r["cls"] != "default" and r["user"] in TIERS_USERS)
        and {r["user"] for r in places if r["cls"] != "default"} >= {"vip-a", "vip-b", "dl"},
        "bulk_in_tier": all(r["tier"] == "bulk" and r["replica"] in ("r1", "r2")
                            for r in places if r["cls"] == "default"),
        "regroup_done": [r["phase"] for r in regroup] == ["start", "done"]
        and check_regroup_pairing(recs) == []
        and sorted(m["name"] for m in tiers["tiers"]["interactive"]["members"])
        == ["r0", "r2"],
        "r2_streams_migrated": len(on_r2) >= 1
        and sorted(r["user"] for r in imports if r["replica"] == "r2") == on_r2
        and all(r["to_replica"] == "r1" for r in imports)
        and not any(r["kind"] in ("replica_failover", "migrate_abort") for r in recs),
        "no_dropped": check_no_dropped_streams(recs) == []
        and all(check_no_dropped_streams(rs) == [] for rs in member_recs.values()),
        "invariants": check_invariants(recs) == []
        and all(check_invariants(rs) == [] for rs in member_recs.values()),
        "no_used_pages": all(v == 0 for v in used.values()),
        "kernels_every_member": kernels_ok,
    }
    tokens = sum(len(ids) for ids, _ in results.values())
    line = {"phase": "serve-tiers", "part": "tp1", "tiers": TIERS_SPEC_TP1,
            "slots_per_member": ecfg.max_slots, **bounds,
            "placed": placed, "live_on_r2": on_r2,
            "tier_places": [{k: r.get(k) for k in ("user", "cls", "tier", "replica",
                                                    "overflow")} for r in places],
            "retier": retier,
            "regroup_s": (regroup[-1]["t"] - regroup[0]["t"]
                          if len(regroup) == 2 else None),
            "ttft_ms": ttft, "ttft_p50_ms": ttft_p50, "tokens": tokens,
            "seconds": seconds, "tokens_per_s": tokens / seconds,
            "migrated": [{k: r[k] for k in ("user", "replica", "to_replica", "tokens",
                                             "pages", "bytes")} for r in imports],
            "launches": counts, "launches_per_member": per_member,
            "used_pages": used, "card": card, "gates": gates}
    emit(line)
    return line


def _tp_param_bytes(cfg, tp: int, nbytes: int = 2) -> int:
    """One tensor-parallel rank's weight bytes from the config's shapes:
    the attention and FFN matrices, their biases and the embedding and
    head cut tp ways (Megatron; the vocabulary by rows), the norms whole
    on every rank."""
    d, q, kv, f = cfg.hidden_size, cfg.q_dim, cfg.kv_dim, cfg.intermediate_size
    cut = d * q + 2 * d * kv + q * d + 3 * d * f + (q + 2 * kv) * cfg.attn_bias
    layer = cut // tp + 2 * d + 2 * cfg.head_dim * cfg.qk_norm
    top = cfg.vocab_size * d * (1 if cfg.tie_embeddings else 2) // tp + d
    return (layer * cfg.num_layers + top) * nbytes


def _tp_kv_bytes(cfg, tp: int, pages: int, page_size: int, nbytes: int = 2) -> int:
    """One tensor-parallel rank's K and V pools: every layer, its
    num_kv_heads / tp heads."""
    return (2 * cfg.num_layers * pages * page_size * (cfg.num_kv_heads // tp)
            * cfg.head_dim * nbytes)


def _member_dispatches(router, model):
    """{member: (ragged dispatches, decode steps)} of each local member's
    runtime (rank 0's, for a member leading a rank world): with the
    window's launch counts, the proof that every member launched both
    kernels (one launch per layer per ragged dispatch and per decode
    step)."""
    return {m.name: (m.engine.runtimes[model].ragged_dispatches,
                     m.engine.runtimes[model].decode_steps)
            for m in router.local_members}


def _kernels_per_member(before, after, counts, layers, names):
    """(per-member launches implied by its dispatches, the gate): each
    named member made at least one ragged dispatch and one decode step,
    and the window's bf16 launch counts equal layers x the members'
    dispatches summed (no launch from anywhere else, no int8 launch)."""
    per = {n: {"ragged_paged_attention": layers * (after[n][0] - before.get(n, (0, 0))[0]),
               "paged_decode_attention": layers * (after[n][1] - before.get(n, (0, 0))[1])}
           for n in names}
    ok = (all(v["ragged_paged_attention"] > 0 and v["paged_decode_attention"] > 0
              for v in per.values())
          and counts["ragged_paged_attention"]
          == sum(v["ragged_paged_attention"] for v in per.values())
          and counts["paged_decode_attention"]
          == sum(v["paged_decode_attention"] for v in per.values())
          and counts["ragged_paged_attention_int8"] == 0
          and counts["paged_decode_attention_int8"] == 0)
    return per, ok


def _tiers_f32(card):
    """float32 (TF32 off) through a tiered fleet with r0 at tp 2: one bulk
    stream, unmigrated, on a tp-1 member; the same prompt from a VIP user
    on r0 (two ranks): the ids must be equal; then the bulk stream again,
    its member retiered to interactive@tp2 once it holds 16 tokens (the
    stream migrates in-tier): the ids must not change."""
    import torch

    from ollamamq_tpu_torch.fleet.wide import CardPlan
    from ollamamq_tpu_torch.ops.sampling import SamplingParams

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    router, _, params = _fleet_router(
        dtype="float32", n_local=3,
        extra=["--tiers", TIERS_SPEC, "--slo-ttft-ms", str(AUTOSCALE_SLO_TTFT_MS)],
        cards=CardPlan(TIERS_CARDS, backend="gloo"))
    router.eject_heartbeat_s = TIERS_EJECT_S
    router.start()
    router.core.set_vip("f32-vip")  # the tiers read the core's VIP through a cache
    prompt = "The quick brown fox jumps over the lazy dog; regroup me, please."
    try:
        ref, end, _ = _stream_ids(router, "f32", prompt, 96)
        wide_ids, wide_end, _ = _stream_ids(router, "f32-vip", prompt, 96)
        wide_on = [r["replica"] for r in router.journal.tail(None, kind="tier_place")
                   if r["user"] == "f32-vip"]
        rt = router.resolve_runtime(FLEET_MODEL)
        req = router.enqueue_request("f32", "", FLEET_MODEL,
                                     prompt_tokens=rt.tokenizer.encode(prompt),
                                     sampling=SamplingParams(max_tokens=96),
                                     raw_prompt=prompt)
        f = _flight(router, "f32")
        _wait_tokens(router, ["f32"], 16)
        src = f.member
        depth = len(f.attempt.req.generated_ids)
        router.retier_replica(src.name, "interactive", why="smoke")
        items = _collect(req)
        ids = [i.token_id for i in items if i.kind == "token" and i.token_id >= 0]
        deadline = time.monotonic() + 120
        while src.tier != "interactive" and time.monotonic() < deadline:
            time.sleep(0.01)
        recs = router.journal.tail(None)
        src_tp = src.tp
    finally:
        router.stop()
    del router, params
    migrated = [r for r in recs if r["kind"] == "migrate_import"
                and r.get("what") != "prefix"]
    phases = [r["phase"] for r in recs if r["kind"] == "tier_regroup"]
    gates = {"f32_tp2_equals_tp1": (wide_on == ["r0"] and wide_ids == ref
                                   and wide_end.kind == "done" and end.kind == "done"),
             "f32_retier_identical": ids == ref and end.kind == "done"
             and items[-1].kind == "done",
             "f32_retier_migrated": len(migrated) == 1
             and migrated[0]["replica"] == src.name
             and migrated[0]["to_replica"] != src.name
             and phases == ["start", "done"] and src_tp == 2
             and not any(r["kind"] == "replica_failover" for r in recs)}
    line = {"phase": "serve-tiers", "part": "f32", "tf32": False,
            "wide_member": wide_on, "first_diff_tp2": _first_diff(wide_ids, ref),
            "member": src.name, "migrated_at": depth, "tokens": len(ref),
            "first_diff": _first_diff(ids, ref), "regrouped_tp": src_tp,
            "card": card, "gates": gates}
    emit(line)
    return line


def serve_tiers_phase(report) -> None:
    """SLO-aware replica tiers on the card: the one-rank window, then r0
    two ranks wide (module docstring, serve-tiers)."""
    import weakref

    import torch

    from ollamamq_tpu_torch.config import get_model_config
    from ollamamq_tpu_torch.fleet.wide import CardPlan
    from ollamamq_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from ollamamq_tpu_torch.server.app import serve_in_thread, stop_server
    from ollamamq_tpu_torch.telemetry.journal import check_invariants
    from ollamamq_tpu_torch.tools.journal import (check_no_dropped_streams,
                                                  check_regroup_pairing)

    t_phase = time.monotonic()
    card = card_line()
    tp1 = _tiers_tp1(card)
    gc.collect()
    torch.cuda.empty_cache()
    # PyTorch keeps a cuBLAS workspace per thread that ran a GEMM (every
    # member's loop): both readings drop them first.
    clear_ws = getattr(torch._C, "_cuda_clearCublasWorkspaces", lambda: None)
    clear_ws()
    mem0 = torch.cuda.memory_allocated()
    t0 = time.monotonic()
    # TTFT is timed to a stream's first text, which the seeded model's
    # ids rarely decode to: a 500 ms objective would burn on that noise
    # (r0's gloo all_reduces slow it most) and overflow the interactive
    # class onto bulk, so the objective sits far above this traffic.
    router, ecfg, params = _fleet_router(
        n_local=3, extra=["--tiers", TIERS_SPEC, "--journal-ring", "1000000",
                          "--slo-ttft-ms", str(AUTOSCALE_SLO_TTFT_MS)],
        cards=CardPlan(TIERS_CARDS, backend="gloo"))
    router.eject_heartbeat_s = TIERS_EJECT_S
    build_s = time.monotonic() - t0
    # Counted from here: rank 0's launches and each rank 1's (its whole
    # run) cover the same span, the warm-ups included.
    before = _member_dispatches(router, FLEET_MODEL)
    reset_launch_counts()
    srv = serve_in_thread(router, port=0, timeout_s=600)
    port = srv.server_address[1]
    cfg = get_model_config(FLEET_MODEL)
    layers = cfg.num_layers
    r0, r1, r2 = (next(m for m in router.members if m.name == n)
                  for n in ("r0", "r1", "r2"))
    widths0 = {m.name: m.tp for m in router.members}
    wide = {}
    try:
        _tiers_warm(router, port)
        seq0 = router.journal.seq
        mseq0 = {m.name: m.engine.journal.seq for m in router.members}
        watch = _HeartbeatWatch(router)
        results, errors = {}, []
        t0 = time.monotonic()
        threads = _tiers_waves(router, port, results, errors)
        placed = {f.user: f.member.name for f in list(router.flights)}
        on_r2 = sorted(f.user for f in list(router.flights)
                       if f.member is r2 and not f.done)
        # r2's engine before the regroup: its runtime's counters, its
        # journal, and a weak reference that must die with it.
        old_rt = r2.engine.runtimes[FLEET_MODEL]
        old_journal, old_seq = r2.engine.journal, mseq0["r2"]
        old_engine = weakref.ref(r2.engine)
        _, data = _post(port, "/admin/retier/r2", {"tier": "interactive"}, "admin")
        retier = json.loads(data)
        for t in threads.values():
            t.join(timeout=600)
        tiers = _tiers_wait_interactive(port, "r2", 300)
        # Two interactive streams at once after the regroup: the tier's
        # least-loaded placement puts one on r2's new world.
        late = {u: threading.Thread(target=_tiers_run,
                                    args=(port, results, errors, u, p, "deadline"))
                for u, p in TIERS_LATE.items()}
        for t in late.values():
            t.start()
        for t in late.values():
            t.join(timeout=600)
        seconds = time.monotonic() - t0
        max_age = watch.stop()
        del watch  # it holds the router
        counts = launch_counts()
        after = _member_dispatches(router, FLEET_MODEL)
        old_after = (old_rt.ragged_dispatches, old_rt.decode_steps)
        del old_rt
        recs = [r for r in router.journal.tail(None) if r["seq"] >= seq0]
        member_recs = {m.name: [r for r in m.engine.journal.tail(None)
                                if r["seq"] >= (0 if m is r2 else mseq0[m.name])]
                       for m in router.members}
        member_recs["r2-tp1"] = [r for r in old_journal.tail(None) if r["seq"] >= old_seq]
        del old_journal
        used = {m.name: m.engine.runtimes[FLEET_MODEL].alloc.used_pages
                for m in router.members}
        wide = {n: m.engine for n, m in (("r0", r0), ("r2", r2))}
        rank0 = {n: {"param_bytes": e.runtimes[FLEET_MODEL].param_bytes,
                     "kv_bytes": e.runtimes[FLEET_MODEL].kv_bytes,
                     "trace": e.spmd_report()} for n, e in wide.items()}
        widths1 = {m.name: m.tp for m in router.members}
        gc.collect()
        old_released = old_engine() is None
    finally:
        stop_server(srv)  # stops the router: each member world's ranks report
    workers = {n: e.worker_reports for n, e in wide.items()}
    del router, srv, params, wide, r0, r1, r2
    gc.collect()
    torch.cuda.empty_cache()
    mem_after_raw = torch.cuda.memory_allocated()
    clear_ws()
    mem_after = torch.cuda.memory_allocated()
    f32 = _tiers_f32(card)
    gc.collect()
    torch.cuda.empty_cache()

    places = [r for r in recs if r["kind"] == "tier_place"]
    regroup = [r for r in recs if r["kind"] == "tier_regroup"]
    imports = [r for r in recs if r["kind"] == "migrate_import"
               and r.get("what") != "prefix"]
    # rank 0 of each member runs in this process: the window's launches
    # are layers x every rank-0 runtime's dispatches, r2's engine before
    # and after its regroup included.
    before["r2-tp1"] = before.pop("r2")
    after["r2-tp1"] = old_after
    per_member, kernels_ok = _kernels_per_member(before, after, counts, layers,
                                                 ["r0", "r1", "r2", "r2-tp1"])
    per_bytes = {"param_bytes": _tp_param_bytes(cfg, 2),
                 "kv_bytes": _tp_kv_bytes(cfg, 2, ecfg.num_pages, ecfg.page_size)}
    ranks = {}
    for n in ("r0", "r2"):
        (w,) = workers[n] or [None]
        exact1 = w is not None and _tp_exact(w["launches"], w["ops"], layers, "")[0]
        # Rank 1 replays every dispatch of its rank 0 over the same span.
        same_span = w is not None and all(
            w["launches"].get(k, 0) == v for k, v in per_member[n].items())
        ranks[n] = {
            "rank0": {k: rank0[n][k] for k in per_bytes},
            "rank1": ({k: w["runtimes"][FLEET_MODEL][k] for k in per_bytes}
                      if w is not None else None),
            "rank1_launches": w["launches"] if w is not None else None,
            "rank1_ops": w["ops"] if w is not None else None,
            "rank1_exact": exact1,
            "rank1_same_span_as_rank0": same_span,
            "digests_equal": (w is not None
                              and w["digest"] == rank0[n]["trace"]["digest"])}
    ttft, ttft_p50 = _tiers_ttft(recs, member_recs)
    regroup_s = (regroup[-1]["t"] - regroup[0]["t"]
                 if len(regroup) == 2 else None)
    late_on = {r["user"]: r["replica"] for r in places if r["user"] in TIERS_LATE}
    gates = {
        "replies": not errors and len(results) == len(TIERS_USERS) + len(TIERS_LATE)
        and all(fr.get("done") and fr.get("done_reason") in ("stop", "length")
                and "error" not in fr for _, fr in results.values()),
        "widths": widths0 == {"r0": 2, "r1": 1, "r2": 1}
        and widths1 == {"r0": 2, "r1": 1, "r2": 2},
        "interactive_on_r0": all(
            r["tier"] == "interactive" and r["replica"] == "r0"
            and not r.get("overflow")
            for r in places if r["cls"] != "default" and r["user"] in TIERS_USERS)
        and {r["user"] for r in places if r["cls"] != "default"} >= {"vip-a", "vip-b", "dl"},
        "bulk_in_tier": all(r["tier"] == "bulk" and r["replica"] in ("r1", "r2")
                            for r in places if r["cls"] == "default"),
        "late_on_both_wide": sorted(late_on.values()) == ["r0", "r2"],
        "regroup_done": [r["phase"] for r in regroup] == ["start", "done"]
        and regroup[0].get("tp_from") == 1 and regroup[0].get("tp_to") == 2
        and regroup[1].get("tp_to") == 2
        and check_regroup_pairing(recs) == []
        and sorted(m["name"] for m in tiers["tiers"]["interactive"]["members"])
        == ["r0", "r2"],
        "r2_streams_migrated": len(on_r2) >= 1
        and sorted(r["user"] for r in imports if r["replica"] == "r2") == on_r2
        and all(r["to_replica"] == "r1" for r in imports)
        and not any(r["kind"] in ("replica_failover", "migrate_abort") for r in recs),
        "no_ejects": not any(r["kind"] == "replica_eject" for r in recs),
        "no_dropped": check_no_dropped_streams(recs) == []
        and all(check_no_dropped_streams(rs) == [] for rs in member_recs.values()),
        "invariants": check_invariants(recs) == []
        and all(check_invariants(rs) == [] for rs in member_recs.values()),
        "no_used_pages": all(v == 0 for v in used.values()),
        "kernels_every_member": kernels_ok,
        "wide_ranks_exact": all(v["rank1_exact"] and v["digests_equal"]
                                and v["rank1_same_span_as_rank0"]
                                for v in ranks.values()),
        "wide_rank_bytes": all(v["rank0"] == per_bytes and v["rank1"] == per_bytes
                               for v in ranks.values()),
        "r2_old_engine_released": old_released,
        "memory_back": mem_after - mem0 <= MOE_MEMORY_SLACK,
        **f32["gates"],
        **{f"tp1_{k}": v for k, v in tp1["gates"].items()},
    }
    tokens = sum(len(ids) for ids, _ in results.values())
    # The one-rank window's, then the wide window's in this process and
    # its worker ranks' (whose runs the window spans).
    launches = {k: n + counts[k] for k, n in tp1["launches"].items()}
    for v in ranks.values():
        for k, n in (v["rank1_launches"] or {}).items():
            launches[k] += n
    line = {"phase": "serve-tiers", "model": FLEET_MODEL, "members": 3,
            "slots_per_member": ecfg.max_slots, "tiers": TIERS_SPEC,
            "cards": "r0's two ranks, r1, r2 and r2's regroup on cuda:0 (gloo)",
            "users": {u: c for u, (c, _) in TIERS_USERS.items()},
            "max_new_tokens": TIERS_NEW, "placed": placed, "live_on_r2": on_r2,
            "late_placed": late_on, "retier": retier, "regroup_s": regroup_s,
            "fleet_build_s": build_s, "eject_heartbeat_s": TIERS_EJECT_S,
            "max_heartbeat_age_s": max_age,
            "interactive_ttft_ms_objective": AUTOSCALE_SLO_TTFT_MS,
            "ttft_ms": ttft, "ttft_p50_ms": ttft_p50,
            "tokens": tokens, "seconds": seconds, "tokens_per_s": tokens / seconds,
            "migrated": [{k: r[k] for k in ("user", "replica", "to_replica", "tokens",
                                             "pages", "bytes")} for r in imports],
            "launches": launches, "launches_in_process": counts,
            "tp1": {k: tp1[k] for k in ("regroup_s", "ttft_p50_ms", "tokens_per_s",
                                        "interactive_ttft_ms", "eject_heartbeat_s",
                                        "launches")},
            "launches_per_member": per_member, "wide_ranks": ranks,
            "rank_bytes_expected": per_bytes,
            "memory_allocated": {"before_fleet": mem0, "after_fleet": mem_after,
                                 "after_fleet_cublas_workspaces_kept": mem_after_raw},
            "used_pages": used, "f32": {k: f32[k] for k in (
                "wide_member", "first_diff_tp2", "member", "migrated_at", "tokens",
                "first_diff", "regrouped_tp")},
            "phase_seconds": time.monotonic() - t_phase, "card": card, "gates": gates}
    emit(line)
    report["serve_tiers"] = line
    if not all(gates.values()):
        raise SystemExit(f"serve-tiers gates failed: {gates}")


AUTOSCALE_USERS = ("au-1", "au-2", "au-3", "au-4", "au-5", "au-6")
AUTOSCALE_NEW = 96
# The router times TTFT to a stream's first text, and the seeded model's
# ids rarely decode to text under the byte tokenizer: a low objective
# fires on the few streams whose first text comes late, and its 5-minute
# window then holds the scale-down off. The phase's scale-up rides the
# router's backlog; the TTFT objective stays far above this traffic.
AUTOSCALE_SLO_TTFT_MS = 60000


def serve_autoscale_phase(report) -> None:
    """The autoscaler on the card (module docstring, serve-autoscale)."""
    import torch

    from ollamamq_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from ollamamq_tpu_torch.server.app import serve_in_thread, stop_server
    from ollamamq_tpu_torch.tools.journal import (check_no_dropped_streams,
                                                  check_scale_pairing)

    t_phase = time.monotonic()
    card = card_line()
    gc.collect()
    torch.cuda.empty_cache()
    router, ecfg, params = _fleet_router(
        n_local=1, extra=["--max-slots", "2", "--autoscale", "--min-replicas", "1",
                          "--max-replicas", "2", "--scale-cooldown-s", "1.5",
                          "--slo-ttft-ms", str(AUTOSCALE_SLO_TTFT_MS),
                          "--journal-ring", "1000000"])
    srv = serve_in_thread(router, port=0, timeout_s=600)
    port = srv.server_address[1]
    scaler = router.autoscaler
    layers = router.resolve_runtime(FLEET_MODEL).cfg.num_layers
    a0 = None
    try:
        _post(port, "/api/generate", {"model": FLEET_MODEL, "prompt": "Warm up.",
                                      "stream": False,
                                      "options": {"temperature": 0, "num_predict": 8}},
              "warm")
        torch.cuda.synchronize()
        mem_before = torch.cuda.memory_allocated()
        seq0 = router.journal.seq
        before = _member_dispatches(router, FLEET_MODEL)
        reset_launch_counts()
        results, errors = {}, []

        def run(user, n, prompt):
            body = {"model": FLEET_MODEL, "prompt": prompt,
                    "options": {"temperature": 0, "num_predict": n}}
            try:
                frames = [json.loads(x) for x in
                          _ndjson(port, "POST", "/api/generate", body, user)
                          if x.strip()]
                results[user] = frames[-1]
            except Exception as e:  # noqa: BLE001 — reported, fails the phase
                errors.append(f"{user}: {e}")

        t0 = time.monotonic()
        burst = [threading.Thread(target=run, args=(u, AUTOSCALE_NEW,
                                                     f"{u} asks: what scales a fleet? "))
                 for u in AUTOSCALE_USERS]
        # Six users arrive 0.15 s apart: r0's two slots fill, the rest
        # queue at the router (the backlog the scaler reads) until a slot
        # frees or a0 joins.
        for t in burst:
            t.start()
            time.sleep(0.15)
        deadline = time.monotonic() + 120
        while a0 is None and time.monotonic() < deadline:
            a0 = next((m for m in router.members if m.name == "a0"), None)
            time.sleep(0.01)
        if a0 is None:
            raise SystemExit("serve-autoscale: the burst provisioned no member")
        for t in burst:
            t.join(timeout=600)
        burst_s = time.monotonic() - t0
        a0_served = {r["user"] for r in router.journal.tail(None, kind="place")
                     if r["seq"] >= seq0 and r["runtime"] == "a0"}
        a0_disp = _member_dispatches(router, FLEET_MODEL).get("a0")
        fleet_peak = len(router.members)
        ttft_obs = scaler.objective.counts.totals(3600.0)
        burn_fired = scaler._burn_state(None)[0]
        wake_wait = scaler.wake_wait_s()
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline and not any(
                r["phase"] == "done" and r["replica"] == "a0"
                for r in router.journal.tail(None, kind="scale_down")):
            time.sleep(0.05)
        recs = [r for r in router.journal.tail(None) if r["seq"] >= seq0]
        counts = launch_counts()
        after = _member_dispatches(router, FLEET_MODEL)
        a0_rt = a0.engine.runtimes[FLEET_MODEL]
        after["a0"] = (a0_rt.ragged_dispatches, a0_rt.decode_steps)
        a0_kv_bytes = a0_rt.stats()["kv_bytes"]
        used = {m.name: m.engine.runtimes[FLEET_MODEL].alloc.used_pages
                for m in [*router.members, a0]}
        alerts = [a.name for a in router.alerts.active()]
        status = scaler.status()
        # The card's memory once the retired member is gone (r0 serving
        # on): its engine must be garbage, its KV pool and buffers freed,
        # the shared weights kept. What stays allocated is then read
        # again with the cuBLAS workspaces dropped (PyTorch keeps one per
        # thread that ran a GEMM: a0's loop, its spawn and its probe).
        a0_engine = weakref.ref(a0.engine)
        a0 = a0_rt = None
        gc.collect()
        a0_freed = a0_engine() is None
        torch.cuda.synchronize()
        mem_after = torch.cuda.memory_allocated()
        clear = getattr(torch._C, "_cuda_clearCublasWorkspaces", None)
        mem_after_ws = None
        if clear is not None:
            clear()
            mem_after_ws = torch.cuda.memory_allocated()
    finally:
        stop_server(srv)
    del router, srv, params, scaler
    gc.collect()
    torch.cuda.empty_cache()

    ups = [r for r in recs if r["kind"] == "scale_up"]
    downs = [r for r in recs if r["kind"] == "scale_down"]
    up_start = next((r for r in ups if r["phase"] == "start"), None)
    up_done = next((r for r in ups if r["phase"] == "done"), None)
    down_done = next((r for r in downs if r["phase"] == "done"), None)
    # a0's dispatches over its whole life: both bf16 kernels launched on
    # a0 while it served the burst (a0_disp, read before the scale-down),
    # and the window's counts hold nothing any other source launched.
    per_member, kernels_ok = _kernels_per_member(before, after, counts, layers,
                                                 ["r0", "a0"])
    gates = {
        "replies": not errors and len(results) == len(AUTOSCALE_USERS)
        and all(fr.get("done") and fr.get("done_reason") in ("stop", "length")
                and "error" not in fr for fr in results.values()),
        "scaled_up_a0": up_start is not None and up_done is not None
        and up_done["replica"] == "a0" and fleet_peak == 2,
        "a0_served_and_launched": bool(a0_served & set(AUTOSCALE_USERS))
        and a0_disp is not None and a0_disp[0] > 0 and a0_disp[1] > 0,
        "scaled_down_a0": down_done is not None and down_done["replica"] == "a0"
        and down_done["why"] == "idle",
        "fleet_back_to_1": status["fleet"] == 1,
        "scale_pairing": check_scale_pairing(recs) == [],
        "no_dropped": check_no_dropped_streams(recs) == [],
        "no_used_pages": all(v == 0 for v in used.values()),
        "no_scale_storm": "scale_storm" not in alerts,
        "a0_freed": a0_freed,
        "kernels_every_member": kernels_ok,
    }
    line = {"phase": "serve-autoscale", "model": FLEET_MODEL,
            "slots_per_member": ecfg.max_slots, "burst_users": len(AUTOSCALE_USERS),
            "max_new_tokens": AUTOSCALE_NEW, "slo_ttft_ms": ecfg.slo_ttft_ms,
            "scale_cooldown_s": ecfg.scale_cooldown_s,
            "scale_up_why": up_start["why"] if up_start else None,
            "decision_to_join_s": (up_done["t"] - up_start["t"]
                                   if up_start and up_done else None),
            "spawn_ms": up_done.get("spawn_ms") if up_done else None,
            "scale_down_s_after_join": (down_done["t"] - up_done["t"]
                                        if down_done and up_done else None),
            "a0_served": sorted(a0_served), "burst_s": burst_s,
            "ttft_good_bad_after_burst": ttft_obs, "burn_fired": burn_fired,
            "wake_wait_s": wake_wait,
            "memory_allocated_before_provision": mem_before,
            "memory_allocated_after_retire": mem_after,
            "memory_allocated_after_retire_cublas_workspaces_cleared": mem_after_ws,
            "a0_kv_bytes": a0_kv_bytes,
            "launches": counts, "launches_per_member": per_member,
            "scale_events": status["scale_events"], "alerts": alerts,
            "member_hours": status["member_hours"],
            "phase_seconds": time.monotonic() - t_phase, "card": card, "gates": gates}
    emit(line)
    report["serve_autoscale"] = line
    if not all(gates.values()):
        raise SystemExit(f"serve-autoscale gates failed: {gates}")


# -- serve-ha: router HA over CLI members on the card -----------------------
HA_NEW = FLEET_NEW
HA_USERS = {"ha-ada": "Tell me about fair queues. ",
            "ha-bob": "Why page the KV cache? ",
            "ha-cyd": "Explain the decode kernel. ",
            "ha-ref": "Who keeps the fleet up when the router dies? "}
HA_REF_USER = "ha-ref"  # the 4-stream window repeats the reference's prompt
HA_GRACE_S = "1.0"
OWN_F32 = ("ragged_paged_attention", "paged_decode_attention")


class _Proc:
    """`python -m ollamamq_tpu_torch.cli ARGS` in a subprocess on a port
    of its own choosing (`port` reads it off its log), its output in the
    phase's log file."""

    def __init__(self, name: str, args: list):
        self.name, self._port = name, None
        path = os.path.join(OUT_DIR, f"serve-ha-{name}.log")
        self._start = os.path.getsize(path) if os.path.exists(path) else 0
        self.log = open(path, "ab")
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "ollamamq_tpu_torch.cli", "--no-tui",
             "--port", "0", "--timeout-s", "600",
             "--blocklist", os.path.join(OUT_DIR, f"blocked-ha-{name}.json"), *args],
            cwd=os.path.dirname(os.path.abspath(__file__)), stdout=self.log,
            stderr=subprocess.STDOUT)

    @property
    def port(self) -> int:
        if self._port is None:
            self._port = _bound_port(self.proc, self.log.name, self._start,
                                     f"serve-ha: {self.name}")
        return self._port

    def health(self, ok=lambda h: h.get("status") != "recovering", budget=300.0):
        deadline = time.monotonic() + budget
        while time.monotonic() < deadline:
            if self.proc.poll() is not None:
                raise SystemExit(f"serve-ha: {self.name} exited {self.proc.returncode} "
                                 f"(log {self.log.name}):\n{_log_tail(self.log.name)}")
            try:
                h = json.loads(_get(self.port, "/health"))
                if ok(h):
                    return h
            except (OSError, RuntimeError, ValueError):
                pass
            time.sleep(0.05)
        raise SystemExit(f"serve-ha: {self.name} never reached the wanted state")

    def kill(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(timeout=60)

    def close(self) -> None:
        self.kill()
        self.log.close()


class _HaClient:
    """One user's greedy stream through a router: the /api/generate
    connection (its X-Request-ID header names the stream) and an observer
    of its frames through GET /api/stream/{rid}, one frame per token."""

    def __init__(self, port: int, user: str, prompt: str, n: int = HA_NEW):
        self.user, self.port = user, port
        self.body = {"model": FLEET_MODEL, "prompt": prompt, "stream": True,
                     "options": {"temperature": 0, "repeat_penalty": 1.0,
                                 "num_predict": n}}
        self.frames, self.done, self.rid, self.gen_done = [], None, None, None
        self.reading = True
        self._gen = threading.Thread(target=self._generate, daemon=True)
        self._gen.start()
        deadline = time.monotonic() + 300
        while self.rid is None:
            if time.monotonic() > deadline or self.gen_done is not None:
                raise SystemExit(f"serve-ha: {user}'s stream never started: "
                                 f"{self.gen_done}")
            time.sleep(0.002)
        self._obs = threading.Thread(target=self._observe, daemon=True)
        self._obs.start()

    def _generate(self) -> None:
        try:
            r = _ndjson(self.port, "POST", "/api/generate", self.body, self.user)
            self.rid = int(r.getheader("X-Request-ID"))
            for raw in r:
                f = json.loads(raw)
                if f.get("done"):
                    self.gen_done = f.get("error") or f["done_reason"]
                    return
            self.gen_done = "closed without a done frame"
        except Exception as e:  # noqa: BLE001 — the router may be killed
            self.gen_done = f"connection: {type(e).__name__}"

    def _observe(self) -> None:
        try:
            for raw in _ndjson(self.port, "GET", f"/api/stream/{self.rid}?from=0",
                               user=self.user):
                if not self.reading:
                    return
                f = json.loads(raw)
                if f.get("done"):
                    self.done = f.get("error") or f["done_reason"]
                    return
                self.frames.append((f["token_ids"][0] if f.get("token_ids") else -1,
                                    f["response"]))
        except Exception:  # noqa: BLE001 — killed under it
            return

    def ids(self):
        return [t for t, _ in self.frames if t >= 0]

    def wait_done(self, budget=600.0):
        self._obs.join(timeout=budget)
        return self.done


def _generated(members: dict, users) -> dict:
    """{user: tokens its live member-side request has generated}, from
    the members' request traces (a decode event every 16 tokens). The
    router's frames carry ids only where the member wrote text, so its
    clients read the seeded model's tokens in bursts; the members see
    every one."""
    out = {}
    for mp in members.values():
        for row in json.loads(_get(mp.port, "/debug/requests?recent=0"))["inflight"]:
            if row.get("user") not in users:
                continue
            tl = json.loads(_get(mp.port, f"/debug/requests/{row['req_id']}"))
            n = max([e.get("args", {}).get("tokens", 0) for e in tl.get("events", [])
                     if e["name"] == "decode"]
                    + [1 for e in tl.get("events", []) if e["name"] == "first_token"]
                    + [0])
            out[row["user"]] = max(out.get(row["user"], 0), n)
    return out


def _member_launches(port) -> dict:
    return json.loads(_get(port, "/health"))["kernel_launches"]


def _series_total(port, series: str) -> float:
    m = _parse_prometheus(_get(port, "/metrics").decode())
    return sum(v for (name, _), v in m.items() if name == series)


def _fenced(port) -> float:
    return _series_total(port, "ollamamq_ha_fenced_calls_total")


def _spill_records(path):
    from ollamamq_tpu_torch.telemetry.journal import load_jsonl

    return load_jsonl(path)[1]


def serve_ha_phase(report) -> None:
    """Router HA on the card (module docstring, serve-ha)."""
    from ollamamq_tpu_torch.durability import load_wal_records
    from ollamamq_tpu_torch.telemetry.journal import check_invariants
    from ollamamq_tpu_torch.tools.journal import check_files

    t_phase = time.monotonic()
    card = card_line()
    root = os.path.join(OUT_DIR, "ha")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)

    def path(name):
        return os.path.join(root, name)

    member_args = [*FLEET_ARGS, *FLEET_DEVICE_ARGS, "--model", FLEET_MODEL,
                   "--dtype", "float32", "--stop-grace-s", "60"]
    members = {m: _Proc(f"member-{m}", member_args + ["--journal-file", path(f"m{m}.jsonl")])
               for m in ("a", "b")}
    t0 = time.monotonic()
    procs = list(members.values())
    ports = {}  # router -> the port it bound
    try:
        urls = ",".join(f"http://127.0.0.1:{p.port}" for p in members.values())
        router_args = ["--model", FLEET_MODEL, "--replicas", "0", "--replica-urls", urls,
                       "--max-new-tokens", str(HA_NEW), "--wal-fsync-ms", "2",
                       "--takeover-grace-s", HA_GRACE_S, "--stop-grace-s", "60"]

        def primary(tag=""):
            return _Proc(f"primary{tag}", router_args + [
                "--ha", "--wal-dir", path("wal-p"),
                "--journal-file", path(f"primary{tag}.jsonl")])

        def standby(name, of):
            return _Proc(name, router_args + [
                "--standby-of", f"http://127.0.0.1:{ports[of]}",
                "--wal-dir", path(f"wal-{name}"), "--journal-file", path(f"{name}.jsonl")])

        for m in members.values():
            m.health()
        members_up_s = time.monotonic() - t0
        k0 = {m: _member_launches(p.port) for m, p in members.items()}
        p = primary()
        procs.append(p)
        ports["p"] = p.port
        p.health(lambda h: h.get("role") == "primary")
        # 1. The reference: one uninterrupted greedy stream, before the
        # standby exists (its catch-up then goes through the snapshot).
        ref = _HaClient(ports["p"], HA_REF_USER, HA_USERS[HA_REF_USER])
        ref_done = ref.wait_done()
        ref_ids = ref.ids()
        # 2. The standby: caught up through the snapshot, shedding.
        s1 = standby("s1", "p")
        procs.append(s1)
        t_s1 = time.monotonic()
        ports["s1"] = s1.port
        h_s1 = s1.health(lambda h: h.get("sync_lag_records") == 0)
        catchup_s = time.monotonic() - t_s1
        replica = load_wal_records(os.path.join(path("wal-s1"), "wal.jsonl"))[0]
        shed = _post_status(ports["s1"], {"model": FLEET_MODEL, "prompt": "hi",
                                          "stream": False}, "shed")
        # 3. Four users' greedy streams through the primary.
        gen0 = sum(_series_total(mp.port, "ollamamq_tokens_generated_total")
                   for mp in members.values())
        t_win = time.monotonic()
        clients = [_HaClient(ports["p"], u, prompt) for u, prompt in HA_USERS.items()]
        # 4. Kill -9 once every stream is 16 tokens in (as its member
        # generated them: the router's clients read the seeded model's
        # ids in bursts, where its member wrote text) and the standby's
        # replica holds every admission (replication is asynchronous: a
        # stream admitted inside the last poll window is the primary's
        # alone).
        deadline = time.monotonic() + 300
        while True:
            rep = load_wal_records(os.path.join(path("wal-s1"), "wal.jsonl"))[0]
            gen = _generated(members, HA_USERS)
            if (len(gen) == len(HA_USERS) and min(gen.values()) >= 16
                    and all(c.rid in rep for c in clients)):
                break
            if time.monotonic() > deadline:
                raise SystemExit("serve-ha: the streams never reached 16 replicated tokens")
            time.sleep(0.005)
        for c in clients:
            c.reading = False
        pre = {c.user: list(c.frames) for c in clients}
        window_s = time.monotonic() - t_win
        lag_standby = json.loads(_get(ports["s1"], "/health"))["sync_lag_records"]
        lag_primary = json.loads(_get(ports["p"], "/health"))["sync_lag_records"]
        orphans = {m: {r["req_id"] for r in json.loads(
            _get(mp.port, "/debug/requests"))["inflight"]} for m, mp in members.items()}
        gen_at_kill = gen
        t_kill = time.monotonic()
        p.kill()
        window_generated = sum(_series_total(mp.port, "ollamamq_tokens_generated_total")
                               for mp in members.values()) - gen0
        k_kill = {m: _member_launches(mp.port) for m, mp in members.items()}
        h_prom = s1.health(lambda h: h.get("role") == "primary"
                           and h.get("status") != "recovering", budget=120)
        kill_to_serving_s = time.monotonic() - t_kill
        resumed, firsts = {}, {}

        def resume(c):
            n = sum(1 for t, _ in pre[c.user] if t >= 0)
            resumed[c.user] = _resume(ports["s1"], c.user, c.rid, n)

        threads = [threading.Thread(target=resume, args=(c,)) for c in clients]
        for t in threads:
            t.start()
        # The members' pre-kill requests (orphans: their client died
        # with the primary) end once their server notices; from then on,
        # the promotion done, the members decode only what it
        # re-admitted (read at that point: k_clear).
        deadline = time.monotonic() + 300
        while True:
            live = {m: {r["req_id"] for r in json.loads(
                _get(mp.port, "/debug/requests"))["inflight"]} for m, mp in members.items()}
            if not any(live[m] & orphans[m] for m in members):
                break
            if time.monotonic() > deadline:
                raise SystemExit("serve-ha: the orphaned member requests never ended")
            time.sleep(0.01)
        k_clear = {m: _member_launches(mp.port) for m, mp in members.items()}
        resumed_live_at_clear = sum(len(v - orphans[m]) for m, v in live.items())
        for t in threads:
            t.join(timeout=600)
        k_resumed = {m: _member_launches(mp.port) for m, mp in members.items()}
        replay = {c.user: _resume(ports["s1"], c.user, c.rid, 0)[0] for c in clients}
        for c in clients:
            firsts[c.user] = resumed[c.user][2]
        # 5. The zombie: the old primary revived on its WAL dir until the
        # members fence one of its calls.
        z = primary("-zombie")
        procs.append(z)
        f0 = sum(_fenced(mp.port) for mp in members.values())
        deadline = time.monotonic() + 120
        while sum(_fenced(mp.port) for mp in members.values()) - f0 < 1:
            if time.monotonic() > deadline or z.proc.poll() is not None:
                break
            time.sleep(0.05)
        fenced = {m: _fenced(mp.port) for m, mp in members.items()}
        z.kill()
        after_zombie = _HaClient(ports["s1"], "ha-after-zombie", "Still serving? ", n=8)
        after_zombie_done = after_zombie.wait_done()
        # 6. Chained HA: a standby of the promoted router, then SIGTERM
        # the promoted router: it hands over and exits 0.
        s2 = standby("s2", "s1")
        procs.append(s2)
        ports["s2"] = s2.port
        s2.health(lambda h: h.get("sync_lag_records") == 0)
        health_s1_end = json.loads(_get(ports["s1"], "/health"))
        t_term = time.monotonic()
        s1.proc.send_signal(signal.SIGTERM)
        s1_rc = s1.proc.wait(timeout=120)
        h_s2 = s2.health(lambda h: h.get("role") == "primary"
                         and h.get("status") != "recovering", budget=120)
        term_to_serving_s = time.monotonic() - t_term
        last = _HaClient(ports["s2"], "ha-last", "And after the handover? ", n=32)
        last_done = last.wait_done()
        health_s2_end = json.loads(_get(ports["s2"], "/health"))
        s2.proc.send_signal(signal.SIGTERM)
        s2_rc = s2.proc.wait(timeout=120)
        deadline = time.monotonic() + 120
        while True:
            mh = {m: json.loads(_get(mp.port, "/health")) for m, mp in members.items()}
            used = {m: sum(r["pages_used"] for r in h["runtimes"]) for m, h in mh.items()}
            if not any(used.values()) or time.monotonic() > deadline:
                break
            time.sleep(0.05)
        k_end = {m: h["kernel_launches"] for m, h in mh.items()}
        member_rc = {}
        for m, mp in members.items():
            mp.proc.send_signal(signal.SIGTERM)
            member_rc[m] = mp.proc.wait(timeout=180)
        exit_launches = {m: _exit_launches(mp.log.name) for m, mp in members.items()}
    finally:
        for pr in procs:
            pr.close()

    def grew(a, b, keys=OWN_F32):
        return {k: b[k] - a[k] for k in keys}

    takeovers = {n: [r for r in _spill_records(path(f"{n}.jsonl"))
                     if r.get("kind") == "router_takeover"] for n in ("s1", "s2")}
    done1 = next((r for r in takeovers["s1"] if r.get("phase") == "done"), None)
    done2 = next((r for r in takeovers["s2"] if r.get("phase") == "done"), None)
    spills = [path(n) for n in ("primary.jsonl", "s1.jsonl", "s2.jsonl", "ma.jsonl", "mb.jsonl",
                                os.path.join("wal-s1", "primary-journal.jsonl"),
                                os.path.join("wal-s2", "primary-journal.jsonl"))]
    spills = [s for s in spills if os.path.exists(s)]
    audit_bad, audit_total = check_files(spills)
    invariants = {os.path.relpath(s, root): check_invariants(_spill_records(s)) for s in spills}

    def joined(frames):
        return [t for t, _ in frames if t >= 0], "".join(x for _, x in frames)

    streams = {}
    for c in clients:
        pre_ids, pre_text = joined(pre[c.user])
        post_ids, post_text = joined(resumed[c.user][0])
        rp_ids, rp_text = joined(replay[c.user])
        streams[c.user] = {"rid": c.rid, "read_before_kill": len(pre_ids),
                           "resumed": len(post_ids), "done": resumed[c.user][1],
                           "replay_equal": rp_ids == pre_ids + post_ids
                           and rp_text == pre_text + post_text,
                           "ids": pre_ids + post_ids}
    rs = streams[HA_REF_USER]
    ref_row = next((e for e in replica.values()
                    if e["finished"] is not None and e["admit"].get("user") == HA_REF_USER), None)
    window_tokens = sum(len(joined(v)[0]) for v in pre.values())
    per_member = {m: {"phase": grew(k0[m], k_end[m]), "after_kill": grew(k_kill[m], k_resumed[m]),
                      "after_orphans": grew(k_clear[m], k_resumed[m])} for m in members}
    launches = {k: sum(exit_launches[m][k] for m in members) for k in exit_launches["a"]}
    gates = {
        "catch_up": h_s1["status"] == "standby" and h_s1["epoch"] == 1
        and h_s1["sync_lag_records"] == 0 and ref_row is not None
        and ref_row["finished"] == ref_done,
        "reference": ref_done in ("stop", "length") and len(ref_ids) > 16,
        "shed": shed[0] in (429, 503) and shed[1] is not None,
        "promoted_epoch_2": h_prom["role"] == "primary" and h_prom["epoch"] == 2,
        "takeover_done": done1 is not None and done1["why"] == "primary_dead"
        and done1["epoch"] == 2 and done1.get("takeover_ms") is not None,
        "resumed_4_of_4": all(s["done"] in ("stop", "length") for s in streams.values())
        and all(s["resumed"] > 0 for s in streams.values())
        and all(n >= 16 for n in gen_at_kill.values()),
        "repeated_prompt_identical": rs["ids"] == ref_ids,
        "replays_equal": all(s["replay_equal"] for s in streams.values()),
        "zombie_fenced": sum(fenced.values()) - f0 >= 1
        and after_zombie_done in ("stop", "length"),
        "handover": s1_rc == 0 and done2 is not None and done2["why"] == "handover"
        and done2["epoch"] == 3 and h_s2["epoch"] == 3
        and last_done in ("stop", "length") and len(last.ids()) > 0,
        "audits": audit_bad == [] and audit_total > 0
        and all(v == [] for v in invariants.values()),
        "wal_healthy": all(not h["wal"]["wal"]["dead"] and not any(
            a["name"] == "wal_degraded" for a in h["alerts"])
            for h in (h_prom, health_s1_end, health_s2_end)),
        "no_used_pages": not any(used.values()),
        "kernels_every_member": all(v > 0 for m in members
                                    for v in per_member[m]["phase"].values()),
        # After the kill only the promotion's re-admitted streams
        # prefill (the orphans are past theirs), and once the orphans
        # ended (k_clear, read after the promotion) only they decode.
        "kernels_after_promotion": sum(per_member[m]["after_kill"]["ragged_paged_attention"]
                                       for m in members) > 0
        and sum(per_member[m]["after_orphans"]["paged_decode_attention"]
                for m in members) > 0,
        "exits_0": s2_rc == 0 and all(rc == 0 for rc in member_rc.values()),
    }
    line = {"phase": "serve-ha", "model": FLEET_MODEL, "dtype": "float32",
            "max_new_tokens": HA_NEW, "users": len(HA_USERS),
            "takeover_grace_s": float(HA_GRACE_S), "members_up_s": members_up_s,
            "standby_catchup_s": catchup_s,
            "kill_to_standby_serving_s": kill_to_serving_s,
            "takeover_ms": done1.get("takeover_ms") if done1 else None,
            "kill_to_first_resumed_token_s": (min(t for t in firsts.values() if t)
                                              - t_kill if any(firsts.values()) else None),
            "sync_lag_at_kill": {"standby": lag_standby, "primary": lag_primary},
            "sigterm_to_second_standby_serving_s": term_to_serving_s,
            "window_tokens_per_s_with_standby": window_generated / window_s,
            "window_s": window_s, "window_tokens_generated": window_generated,
            "window_tokens_read_by_clients": window_tokens,
            "fenced_calls": {m: fenced[m] for m in members},
            "generated_at_kill": gen_at_kill,
            "streams": {u: {k: v for k, v in s.items() if k != "ids"}
                        for u, s in streams.items()},
            "reference_tokens": len(ref_ids),
            "first_diff_vs_reference": _first_diff(rs["ids"], ref_ids),
            "takeovers": {n: [{k: r.get(k) for k in ("phase", "why", "epoch", "from_epoch",
                                                     "streams", "takeover_ms", "lag")}
                              for r in recs] for n, recs in takeovers.items()},
            "audit_records": audit_total, "audit_violations": audit_bad[:5],
            "resumed_live_when_orphans_ended": resumed_live_at_clear,
            "launches": launches, "launches_per_member": per_member,
            "seconds": time.monotonic() - t_phase, "card": card, "gates": gates}
    emit(line)
    report["serve_ha"] = line
    if not all(gates.values()):
        raise SystemExit(f"serve-ha gates failed: {gates}")


MOE_MODEL = "mixtral:8x7b-16l"
MOE_LAYERS = 16
MOE_PARAM_BYTES = 46_964_940_800  # 16 layers of mixtral:8x7b in bf16
MOE_NEW = 64
MOE_STREAMS = (("moe-ada", 100), ("moe-bob", 180), ("moe-cyd", 240),
               ("moe-ada", 300))  # (user, prompt tokens): 3 users, 4 streams
MOE_TEXT = ("Experts route each token to two of eight feed-forward blocks, "
            "and the router's capacity decides who waits. ")
# cuBLAS keeps a workspace per thread's handle (32 MiB each on this
# card), cached after the engine's threads end.
MOE_MEMORY_SLACK = 128 << 20


def _moe_reference(cfg, lp, h):
    """Per-token loop (the torch form of tests/test_moe.py:29-48): softmax
    over the experts, top-k, renormalise, sum of the chosen experts'
    SwiGLU outputs. No capacity limit."""
    import torch

    out = torch.zeros_like(h)
    probs = torch.softmax(h @ lp["w_router"], dim=-1)
    for n in range(h.shape[0]):
        p, top = torch.topk(probs[n], cfg.num_experts_per_tok)
        for g, e in zip((p / p.sum()).tolist(), top.tolist()):
            gate = h[n] @ lp["we_gate"][e]
            up = h[n] @ lp["we_up"][e]
            out[n] += g * ((torch.nn.functional.silu(gate) * up) @ lp["we_down"][e])
    return out


def _moe_layer_check(cfg, lp) -> dict:
    """Layer 0's moe_mlp in float32 (TF32 off) at full width over 64
    seeded tokens, with capacity factor E / K (no token can be dropped),
    against the per-token loop: max error <= TOL["float32"] x max |ref|."""
    import dataclasses

    import torch

    from ollamamq_tpu_torch.models.moe import moe_mlp

    torch.backends.cuda.matmul.allow_tf32 = False
    lp32 = {k: lp[k].float() for k in ("w_router", "we_gate", "we_up", "we_down")}
    gen = torch.Generator(device="cuda").manual_seed(13)
    h = torch.randn(64, cfg.hidden_size, generator=gen, device="cuda")
    roomy = dataclasses.replace(
        cfg, moe_capacity_factor=cfg.num_experts / cfg.num_experts_per_tok)
    got = moe_mlp(roomy, lp32, h)
    ref = _moe_reference(roomy, lp32, h)
    torch.cuda.synchronize()
    scale, err = float(ref.abs().max()), float((got - ref).abs().max())
    return {"tokens": 64, "capacity_factor": roomy.moe_capacity_factor,
            "max_abs_err": err, "ref_max_abs": scale, "rel_err": err / scale,
            "tol": f"max |moe_mlp - per-token loop| <= {TOL['float32']} * max |ref|",
            "ok": bool(torch.isfinite(got).all()) and err <= TOL["float32"] * scale}


def _decode_step_ms(rt, profile, B=8, ctx=200, iters=5, ep=None) -> dict:
    """One forward_decode over B live rows at context `ctx` on the
    serving weights (a private pool): its time between CUDA events
    (eager, so the host's launch gaps count), with `profile` its device
    time by torch.profiler, and the bound: the bytes the step must move
    over 3.35 TB/s, i.e. every weight but the embedding table (the dense
    dispatch reads each expert), B embedding rows, the K/V it reads and
    writes. `ep`: an expert rank's ExpertGroup with no process group
    (its own experts, no collective; the bound counts its own bytes)."""
    import torch
    from torch.profiler import ProfilerActivity

    from ollamamq_tpu_torch.config import EngineConfig
    from ollamamq_tpu_torch.engine import kv_cache as kvc
    from ollamamq_tpu_torch.models import llama

    cfg, ps = rt.cfg, rt.ecfg.page_size
    per_seq = -(-(ctx + iters + 3) // ps)
    small = EngineConfig(model=rt.name, num_pages=B * per_seq + 1, page_size=ps,
                         max_pages_per_seq=per_seq)
    kc, vc = kvc.alloc_kv_pool(cfg, small, torch.bfloat16, "cuda")
    pt = (1 + torch.arange(B * per_seq, dtype=torch.int32, device="cuda")).reshape(B, per_seq)
    gen = torch.Generator(device="cuda").manual_seed(5)
    tokens = torch.randint(3, cfg.vocab_size, (B,), generator=gen, device="cuda",
                           dtype=torch.int32)
    active = torch.ones(B, dtype=torch.int32, device="cuda")

    def step(i):
        pos = torch.full((B,), ctx + i, dtype=torch.int32, device="cuda")
        llama.forward_decode(rt.params, cfg, tokens, pos, kc, vc, pt, ps,
                             active=active, ep=ep)

    times = []
    for i in range(iters + 2):
        t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0.record()
        step(i)
        t1.record()
        torch.cuda.synchronize()
        if i >= 2:
            times.append(t0.elapsed_time(t1))
    out = {"decode_step_event_ms": sorted(times)[len(times) // 2],
           "decode_step_device_ms": None}
    if profile:
        with torch.profiler.profile(activities=[ProfilerActivity.CUDA]) as prof:
            for i in range(iters):
                step(i)
            torch.cuda.synchronize()
        dev_us = sum(getattr(ev, "device_time_total", 0) for ev in prof.key_averages()
                     if ev.device_type == torch.autograd.DeviceType.CUDA)
        out["decode_step_device_ms"] = dev_us / 1e3 / iters
    del kc, vc
    kv = 2 * B * (ctx + 1) * cfg.num_layers * cfg.kv_dim * 2
    embed = rt.params["embed"]
    bytes_ = (rt.param_bytes - embed.numel() * embed.element_size()
              + B * cfg.hidden_size * embed.element_size() + kv)
    out["decode_step_bound_ms"] = bytes_ / HBM_BYTES_PER_S * 1e3
    return out


def serve_moe_phase(report, profile: bool) -> None:
    """Mixtral 8x7b at full width (d 4096, f 14336, 32 heads over 8 KV
    heads, 8 experts, top-2), depth cut to 16 layers, seeded bf16 weights,
    through TorchEngine and the HTTP server; see the module docstring."""
    import dataclasses

    import torch

    from ollamamq_tpu_torch.config import MODEL_CONFIGS, EngineConfig
    from ollamamq_tpu_torch.engine.engine import TorchEngine
    from ollamamq_tpu_torch.server.app import serve_in_thread, stop_server

    t_phase = time.monotonic()
    # The CLI's int8 refusal runs beside the phase: it exits before any
    # device work.
    refusal = subprocess.Popen(
        [sys.executable, "-m", "ollamamq_tpu_torch.cli", "--model", "mixtral:8x7b",
         "--weights-dtype", "int8", "--no-tui"],
        cwd=os.path.dirname(os.path.abspath(__file__)), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    full = MODEL_CONFIGS["mixtral:8x7b"]
    MODEL_CONFIGS[MOE_MODEL] = dataclasses.replace(full, name=MOE_MODEL,
                                                   num_layers=MOE_LAYERS)
    try:
        gc.collect()
        torch.cuda.empty_cache()
        mem_before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ecfg = EngineConfig(model=MOE_MODEL, max_slots=8, num_pages=136,
                            page_size=32, max_pages_per_seq=16,
                            max_batch_tokens=512, token_granule=16,
                            max_new_tokens=MOE_NEW, decode_steps_per_iter=8,
                            dtype="bfloat16", seed=0)
        t0 = time.monotonic()
        engine = TorchEngine(ecfg)
        torch.cuda.synchronize()
        init_s = time.monotonic() - t0
        rt = engine.runtimes[MOE_MODEL]
        srv = serve_in_thread(engine, port=0, timeout_s=600)
        port = srv.server_address[1]
        line = _serve_moe_traffic(rt, port)
        line.update(init_s=init_s, param_bytes=rt.param_bytes, kv_bytes=rt.kv_bytes,
                    param_bytes_expected=MOE_PARAM_BYTES)
        if profile:
            line["profile"] = profile_window(port, MOE_MODEL, MOE_TEXT * 3, rt)
        stop_server(srv)
        line["max_memory_allocated"] = torch.cuda.max_memory_allocated()
        line.update(_decode_step_ms(rt, profile))
        kernel_vs_plain_logits(report, "serve-moe", rt, MOE_TEXT * 2, "bfloat16",
                               per_call=True)
        line["moe_layer0_f32"] = _moe_layer_check(rt.cfg, rt.params["layers"][0])
        del engine, rt, srv
        gc.collect()
        torch.cuda.empty_cache()
        line["memory_allocated_before"] = mem_before
        line["memory_allocated_after"] = torch.cuda.memory_allocated()
    finally:
        del MODEL_CONFIGS[MOE_MODEL]
    out, _ = refusal.communicate(timeout=120)
    line["cli_int8_exit"] = refusal.returncode
    line["cli_int8_message"] = next(
        (ln.split(": ", 1)[-1] for ln in out.splitlines() if "MoE" in ln), out[-300:])
    line["phase_s"] = time.monotonic() - t_phase
    emit(line)
    report["serve_moe"] = line
    gates = {
        "replies": all(r["done_reason"] in ("stop", "length")
                       for r in line["replies"].values()),
        "greedy_repeat_identical": line["greedy_repeat_identical"],
        "kernels": line["kernels_exact"],
        "moe_layer0_f32": line["moe_layer0_f32"]["ok"],
        "param_bytes": line["param_bytes"] == MOE_PARAM_BYTES,
        "cli_int8_exit_2": (line["cli_int8_exit"] == 2
                            and "does not cover MoE expert stacks" in out),
        "memory_back": (line["memory_allocated_after"]
                        <= line["memory_allocated_before"] + MOE_MEMORY_SLACK),
    }
    emit({"phase": "serve-moe-gates", **gates})
    if not all(gates.values()):
        raise SystemExit(f"serve-moe: gates failed: {gates}")


def _serve_moe_traffic(rt, port) -> dict:
    """serve-moe's window: 4 greedy /api/chat streams of 64 tokens from
    3 users (prompts of 100 to 300 tokens), then one prompt twice, alone.
    Returns the phase line's serving fields."""
    from ollamamq_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from ollamamq_tpu_torch.telemetry import schema as tm

    ttft = tm.TTFT_MS.labels(model=MOE_MODEL)
    ttft0 = list(ttft.counts)
    greedy = {"temperature": 0, "num_predict": MOE_NEW}

    def body(n_tokens, tag):
        # The byte tokenizer: one token per byte, plus the template's.
        text = (f"[{tag}] " + MOE_TEXT * 8)[:n_tokens - 16]
        return {"model": MOE_MODEL, "options": greedy,
                "messages": [{"role": "user", "content": text}]}

    results, errors = {}, []

    def run(key, user, b):
        try:
            results[key] = _ollama_result(*_post(port, "/api/chat", b, user))
        except Exception as e:  # noqa: BLE001 — reported, then fails the phase
            errors.append(f"{key}: {e}")

    before = dict(rt.stats())
    reset_launch_counts()
    t0 = time.monotonic()
    threads = [threading.Thread(target=run, args=(f"{u}/{n}", u, body(n, i)))
               for i, (u, n) in enumerate(MOE_STREAMS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    burst_s = time.monotonic() - t0
    mid = dict(rt.stats())
    repeat = []
    for i in range(2):
        run(f"repeat{i}", "moe-bob", body(160, "repeat"))
        repeat.append(results.get(f"repeat{i}", ([], None))[0])
    counts = launch_counts()
    serve_s = time.monotonic() - t0
    after = dict(rt.stats())
    if errors or len(results) != len(MOE_STREAMS) + 2:
        raise SystemExit(f"serve-moe requests failed: {errors}")
    ragged = after["ragged_dispatches"] - before["ragged_dispatches"]
    steps = after["decode_steps"] - before["decode_steps"]
    layers = rt.cfg.num_layers
    own = {"ragged_paged_attention": layers * ragged,
           "paged_decode_attention": layers * steps}
    exact = (ragged > 0 and steps > 0
             and all(counts[k] == own.get(k, 0) for k in counts))
    burst_tokens = mid["tokens_generated"] - before["tokens_generated"]
    return {"phase": "serve-moe", "model": MOE_MODEL, "layers": layers,
            "reduced": {"num_layers": [32, layers]},
            "width": {"hidden": rt.cfg.hidden_size,
                      "intermediate": rt.cfg.intermediate_size,
                      "heads": rt.cfg.num_heads, "kv_heads": rt.cfg.num_kv_heads,
                      "head_dim": rt.cfg.head_dim, "experts": rt.cfg.num_experts,
                      "top_k": rt.cfg.num_experts_per_tok,
                      "vocab": rt.cfg.vocab_size},
            "dtype": "bfloat16", "streams": len(MOE_STREAMS), "users": 3,
            "serve_s": serve_s, "burst_s": burst_s,
            "tokens": after["tokens_generated"] - before["tokens_generated"],
            "burst_tokens": burst_tokens,
            "burst_tokens_per_s": burst_tokens / burst_s,
            "ttft_ms": _delta_quantiles(ttft, ttft0, (0.5, 0.99)),
            "replies": {k: {"tokens": len(ids), "done_reason": why}
                        for k, (ids, why) in results.items()},
            "greedy_repeat_identical": repeat[0] == repeat[1] and len(repeat[0]) > 0,
            "ragged_dispatches": ragged, "decode_steps": steps,
            "launches": counts, "launches_expected": own, "kernels_exact": exact}


# -- serve-tp: tensor parallelism over two ranks --------------------------------
# The bf16 window's model: llama3:8b at full width, 16 of its 32 layers,
# so that the whole script stays well inside its time limit.
TP_MODEL = "llama3:8b-16l"
TP_LAYERS = 16
TP_SMALL = "llama3.2:1b"
TP_DEVICE = "cuda"
TP_PARAM_BYTES = 4_540_604_416  # each rank's bf16 slice of TP_MODEL
TP_KV_BYTES = 142_606_336  # each rank's pool: 16 layers x 4352 slots x 4 heads
TP_NEW = 64
TP_STREAMS = (("tp-ada", 100), ("tp-bob", 180), ("tp-cyd", 240), ("tp-ada", 300))
TP_TEXT = ("Tensor parallelism splits each layer's heads and feed-forward "
           "columns over ranks that sum their partial outputs. ")
TP_HB = {"OLLAMAMQ_SPMD_HB_EVERY": "0.5", "OLLAMAMQ_SPMD_HB_STALE": "3"}
TP_KILL_BOUND_S = 3.0 + 15.0  # heartbeat staleness + transport slack


def _tp_ecfg(spec):
    """A serve-tp or serve-pp window's engine: 8 slots, 136 pages of 32,
    token budget 512, k_steps 8; serve-pp's specs set pp, 24 pages a
    sequence (a 600-token prompt and its reply fit) and the KV dtype."""
    from ollamamq_tpu_torch.config import EngineConfig

    return EngineConfig(model=spec["model"], max_slots=8, num_pages=136,
                        page_size=32, max_pages_per_seq=spec.get("mp", 16),
                        dp=spec.get("dp", 1),
                        max_batch_tokens=512, token_granule=16,
                        prefill_buckets=PP_BUCKETS,
                        max_new_tokens=spec.get("new", TP_NEW),
                        decode_steps_per_iter=8, dtype=spec["dtype"],
                        weights_dtype=spec.get("quant", "bfloat16"),
                        kv_dtype=spec.get("kv", spec.get("quant", "bfloat16")),
                        pp=spec.get("pp", 1), ep=spec.get("ep", 1), seed=0)


def _tp_wait(req, budget=600.0):
    deadline = time.monotonic() + budget
    while time.monotonic() < deadline:
        item = req.stream.get(timeout=0.5)
        if item and item.kind in ("done", "error"):
            return item
    return None


def _tp_exact(counts, ops, layers, suffix):
    """One rank's kernel launches against its own dispatches: `layers`
    ragged launches per ragged (or verify) dispatch, `layers` decode
    launches per decode step, nothing of the other pool format."""
    own = {"ragged_paged_attention" + suffix: layers * (ops["ragged"] + ops["spec"]),
           "paged_decode_attention" + suffix: layers * ops["decode_steps"]}
    return (all(v > 0 for v in own.values())
            and all(counts[k] == own.get(k, 0) for k in counts)), own


def _tp_traffic(rt, port, model):
    """serve-tp's gated window: 4 greedy /api/chat streams of TP_NEW tokens
    from 3 users (prompts of 100 to 300 tokens), then one prompt twice,
    alone. Rank 0's launches are counted over the window."""
    from ollamamq_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from ollamamq_tpu_torch.telemetry import schema as tm

    ttft = tm.TTFT_MS.labels(model=model)
    ttft0 = list(ttft.counts)
    greedy = {"temperature": 0, "num_predict": TP_NEW}

    def body(n_tokens, tag):
        text = (f"[{tag}] " + TP_TEXT * 8)[:n_tokens - 16]  # byte tokenizer
        return {"model": model, "options": greedy,
                "messages": [{"role": "user", "content": text}]}

    results, errors = {}, []

    def run(key, user, b):
        try:
            results[key] = _ollama_result(*_post(port, "/api/chat", b, user))
        except Exception as e:  # noqa: BLE001 — reported, then fails the phase
            errors.append(f"{key}: {e}")

    before = dict(rt.stats())
    reset_launch_counts()
    t0 = time.monotonic()
    threads = [threading.Thread(target=run, args=(f"{u}/{n}", u, body(n, i)))
               for i, (u, n) in enumerate(TP_STREAMS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    burst_s = time.monotonic() - t0
    mid = dict(rt.stats())
    repeat = []
    for i in range(2):
        run(f"repeat{i}", "tp-bob", body(160, "repeat"))
        repeat.append(results.get(f"repeat{i}", ([], None))[0])
    counts = launch_counts()
    serve_s = time.monotonic() - t0
    after = dict(rt.stats())
    if errors or len(results) != len(TP_STREAMS) + 2:
        raise SystemExit(f"serve-tp requests failed: {errors}")
    ops = {"ragged": after["ragged_dispatches"] - before["ragged_dispatches"],
           "spec": 0, "decode_steps": after["decode_steps"] - before["decode_steps"]}
    exact, own = _tp_exact(counts, ops, rt.cfg.num_layers, "")
    burst_tokens = mid["tokens_generated"] - before["tokens_generated"]
    return {"serve_s": serve_s, "burst_s": burst_s,
            "tokens": after["tokens_generated"] - before["tokens_generated"],
            "burst_tokens": burst_tokens,
            "burst_tokens_per_s": burst_tokens / burst_s,
            "ttft_ms": _delta_quantiles(ttft, ttft0, (0.5, 0.99)),
            "replies": {k: {"tokens": len(ids), "done_reason": why}
                        for k, (ids, why) in results.items()},
            "greedy_repeat_identical": repeat[0] == repeat[1] and len(repeat[0]) > 0,
            "ragged_dispatches": ops["ragged"], "decode_steps": ops["decode_steps"],
            "launches": counts, "launches_expected": own, "kernels_exact": exact}


def _tp_layer_ms(rt, port, model, group=None) -> dict:
    """The TP layer's own costs over one more 2-stream burst: every
    all_reduce of rank 0 (the two row-parallel sums per layer, the
    embedding's and the logits' vocab gather) timed between device
    synchronizations, and the wire (the step plan's store write and the
    status sync) per dispatch. The synchronizations slow the burst; its
    wall time is not a serving number. `group`: another group's
    all_reduce to time (serve-ep: the (expert, tensor) plane's FFN
    sum)."""
    import torch

    def sync():
        if rt.device.type == "cuda":
            torch.cuda.synchronize()

    acc = {"allreduce_s": 0.0, "allreduce_calls": 0, "send_s": 0.0, "sync_s": 0.0}
    plane = rt._plane  # the world's control plane: its wire and sync bus
    group = group if group is not None else rt.tp
    send, bus_sync = plane.send, plane.bus.sync
    reduce = group.all_reduce

    def timed_reduce(x):
        sync()
        t = time.perf_counter()
        out = reduce(x)
        sync()
        acc["allreduce_s"] += time.perf_counter() - t
        acc["allreduce_calls"] += 1
        return out

    def timed_send(*a, **kw):
        t = time.perf_counter()
        send(*a, **kw)
        acc["send_s"] += time.perf_counter() - t

    def timed_sync(ok):
        t = time.perf_counter()
        out = bus_sync(ok)
        acc["sync_s"] += time.perf_counter() - t
        return out

    before = rt.stats()
    group.all_reduce, plane.send, plane.bus.sync = timed_reduce, timed_send, timed_sync
    try:
        body = {"model": model, "prompt": TP_TEXT * 2, "stream": False,
                "options": {"temperature": 0, "num_predict": 32}}
        threads = [threading.Thread(target=_post, args=(port, "/api/generate", body, u))
                   for u in ("tp-m1", "tp-m2")]
        t0 = time.monotonic()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        wall = time.monotonic() - t0
    finally:
        del group.all_reduce
        del plane.send
        del plane.bus.sync
    after = rt.stats()
    forwards = ((after["ragged_dispatches"] - before["ragged_dispatches"])
                + (after["decode_steps"] - before["decode_steps"]))
    dispatches = ((after["ragged_dispatches"] - before["ragged_dispatches"])
                  + (after["decode_dispatches"] - before["decode_dispatches"]))
    return {"forwards": forwards, "dispatches": dispatches, "wall_s": wall,
            "allreduce_calls_per_forward": acc["allreduce_calls"] / max(1, forwards),
            "allreduce_ms_per_forward": acc["allreduce_s"] * 1e3 / max(1, forwards),
            "wire_send_ms_per_dispatch": acc["send_s"] * 1e3 / max(1, dispatches),
            "status_sync_ms_per_dispatch": acc["sync_s"] * 1e3 / max(1, dispatches),
            "wall_ms_per_forward": wall * 1e3 / max(1, forwards)}


def _tp_leader_bf16(spec, mesh, profile):
    import torch

    from ollamamq_tpu_torch.engine.spmd import SPMDEngine
    from ollamamq_tpu_torch.server.app import serve_in_thread, stop_server

    model = spec["model"]
    ecfg = _tp_ecfg(spec)
    t0 = time.monotonic()
    eng = SPMDEngine(ecfg, mesh=mesh, blocklist_path=None)
    torch.cuda.synchronize()
    init_s = time.monotonic() - t0
    rt = eng.runtimes[model]
    srv = serve_in_thread(eng, port=0, timeout_s=600)
    port = srv.server_address[1]
    line = _tp_traffic(rt, port, model)
    line["tp_layer"] = _tp_layer_ms(rt, port, model)
    if profile:
        line["profile"] = profile_window(port, model, TP_TEXT * 3, rt)
    line["metrics_federated"] = _federated_scrape(eng, port)
    stop_server(srv)
    line.update(init_s=init_s, param_bytes=rt.param_bytes, kv_bytes=rt.kv_bytes,
                max_memory_allocated=torch.cuda.max_memory_allocated(),
                n_chips=rt.n_chips, trace=eng.spmd_report(),
                workers=eng.worker_reports)
    calls = {}
    kernel_vs_plain_logits(calls, "serve-tp", rt, TP_TEXT * 2, "bfloat16",
                           per_call=True, tp=2)
    line["per_call"] = calls["serve_tp_logits"]
    return line


def _tp_first_forward(capture):
    """Wrap llama.forward_ragged so the first call's logits land in
    `capture` (on the host)."""
    from ollamamq_tpu_torch.models import llama

    orig = llama.forward_ragged

    def wrapped(*a, **kw):
        out = orig(*a, **kw)
        if "logits" not in capture:
            capture["logits"] = out[0].float().cpu()
            capture["rows"] = int((a[11] > 0).sum())  # q_len > 0: real rows
        return out

    llama.forward_ragged = wrapped
    return orig


def _tp_leader_f32(spec, mesh, profile):
    """f32 identity: 4 greedy streams of 32 tokens at tp 2, then the same
    requests on a one-rank engine of the same seed; every request is
    queued before the loop starts, so both first dispatches hold the same
    4 prefill spans."""
    import torch

    from ollamamq_tpu_torch.engine.engine import TorchEngine
    from ollamamq_tpu_torch.engine.spmd import SPMDEngine
    from ollamamq_tpu_torch.models import llama
    from ollamamq_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from ollamamq_tpu_torch.ops.sampling import SamplingParams

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model, ecfg = spec["model"], _tp_ecfg(spec)
    prompts = [f"[{i}] " + TP_TEXT[:40 + 17 * i] for i in range(4)]

    def run(eng):
        capture = {}
        orig = _tp_first_forward(capture)
        try:
            tok = eng.runtimes[model].tokenizer
            reqs = [eng.enqueue_request(f"f32-{i}", "", model,
                                        prompt_tokens=tok.encode(p),
                                        sampling=SamplingParams(max_tokens=32,
                                                                temperature=0.0))
                    for i, p in enumerate(prompts)]
            eng.start()
            items = [_tp_wait(r) for r in reqs]
        finally:
            llama.forward_ragged = orig
        eng.stop()
        ok = all(it is not None and it.kind == "done" for it in items)
        return [r.generated_ids for r in reqs], capture, ok

    reset_launch_counts()
    tp_eng = SPMDEngine(ecfg, mesh=mesh, blocklist_path=None)
    param_bytes = tp_eng.runtimes[model].param_bytes
    ids2, cap2, ok2 = run(tp_eng)
    counts = launch_counts()
    worker = tp_eng.worker_reports
    del tp_eng
    one = TorchEngine(ecfg, device=mesh.device, blocklist_path=None)
    ids1, cap1, ok1 = run(one)
    n = cap2["rows"]
    a, b = cap2["logits"][:n], cap1["logits"][:n]
    scale = float(b.abs().max())
    err = float((a - b).abs().max())
    return {"ids_tp2": ids2, "ids_tp1": ids1, "done": ok1 and ok2,
            "ids_identical": ids1 == ids2 and all(len(x) > 0 for x in ids2),
            "first_forward": {"rows": n, "max_abs_err": err, "ref_max_abs": scale,
                              "rel_err": err / scale,
                              "tol": f"max |tp2 - tp1| <= {TOL['float32']} * max |tp1|",
                              "ok": err <= TOL["float32"] * scale},
            "param_bytes": param_bytes, "launches": counts, "workers": worker}


def _tp_leader_int8(spec, mesh, profile):
    import torch

    from ollamamq_tpu_torch.engine.spmd import SPMDEngine
    from ollamamq_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from ollamamq_tpu_torch.ops.sampling import SamplingParams

    model, ecfg = spec["model"], _tp_ecfg(spec)
    eng = SPMDEngine(ecfg, mesh=mesh, blocklist_path=None)
    rt = eng.runtimes[model]
    tok = rt.tokenizer
    before = rt.stats()
    reset_launch_counts()
    eng.start()
    reqs = [eng.enqueue_request(f"int8-{i}", "", model,
                                prompt_tokens=tok.encode(TP_TEXT * (i + 1)),
                                sampling=SamplingParams(max_tokens=32, temperature=0.0))
            for i in range(2)]
    items = [_tp_wait(r) for r in reqs]
    counts = launch_counts()
    eng.stop()
    after = rt.stats()
    ops = {"ragged": after["ragged_dispatches"] - before["ragged_dispatches"],
           "spec": 0, "decode_steps": after["decode_steps"] - before["decode_steps"]}
    exact, own = _tp_exact(counts, ops, rt.cfg.num_layers, "_int8")
    calls = {}
    kernel_vs_plain_logits(calls, "serve-tp-int8", rt, TP_TEXT * 2, "int8",
                           per_call=True, tp=2)
    torch.cuda.synchronize()
    return {"done": all(it is not None and it.kind == "done" for it in items),
            "tokens": [len(r.generated_ids) for r in reqs],
            "launches": counts, "launches_expected": own, "kernels_exact": exact,
            "param_bytes": rt.param_bytes, "kv_bytes": rt.kv_bytes,
            "per_call": calls["serve_tp_int8_logits"], "trace": eng.spmd_report(),
            "workers": eng.worker_reports}


def _tp_leader_kill(spec, mesh, profile):
    """kill -9 of the worker rank while 4 streams decode: every request
    must end with an error within the heartbeat bound, and /health keep
    answering (runtime failed, worker_stale firing)."""
    import urllib.request

    from ollamamq_tpu_torch.engine.spmd import SPMDEngine
    from ollamamq_tpu_torch.ops.sampling import SamplingParams
    from ollamamq_tpu_torch.parallel import distributed
    from ollamamq_tpu_torch.server.app import serve_in_thread, stop_server

    model, ecfg = spec["model"], _tp_ecfg(spec)
    eng = SPMDEngine(ecfg, mesh=mesh, blocklist_path=None)
    srv = serve_in_thread(eng, port=0, timeout_s=600)
    tok = eng.runtimes[model].tokenizer
    reqs = [eng.enqueue_request(f"kill-{i}", "", model,
                                prompt_tokens=tok.encode(TP_TEXT),
                                sampling=SamplingParams(max_tokens=400, temperature=0.0))
            for i in range(4)]
    deadline = time.monotonic() + 300
    while (min(len(r.generated_ids) for r in reqs) < 16
           and time.monotonic() < deadline):
        time.sleep(0.005)
    in_flight = [len(r.generated_ids) for r in reqs]
    pid = int(distributed.store().get("chip_smoke/pid/1"))
    os.kill(pid, signal.SIGKILL)
    t_kill = time.monotonic()
    items, ends = [], []
    for r in reqs:
        items.append(_tp_wait(r, budget=120))
        ends.append(time.monotonic() - t_kill)
    time.sleep(3.5)  # past the heartbeat's staleness
    eng.health.check_once()
    with urllib.request.urlopen(f"http://127.0.0.1:{srv.server_address[1]}/health",
                                timeout=30) as resp:
        status, health = resp.status, json.loads(resp.read())
    stop_server(srv)
    return {"tokens_at_kill": in_flight,
            "kinds": [it.kind if it else "timeout" for it in items],
            "errors": [(it.error or "")[:160] if it else "" for it in items],
            "seconds_to_error": ends, "bound_s": TP_KILL_BOUND_S,
            "health_http": status, "health_status": health["status"],
            "alerts": [a["name"] for a in health["alerts"]],
            "runtime_failed": [r["failed"] for r in health["runtimes"]]}


TP_WINDOWS = {"bf16": _tp_leader_bf16, "f32": _tp_leader_f32,
              "int8": _tp_leader_int8, "kill": _tp_leader_kill}


def _world(spec) -> int:
    """Ranks of a serve-tp / serve-pp / serve-dp / serve-sp / serve-ep
    window: tp per stage x pp stages x sp shards x ep shards x dp
    replicas."""
    return (spec.get("dp", 1) * spec.get("tp", 2) * spec.get("pp", 1)
            * spec.get("sp", 1) * spec.get("ep", 1))


def tp_rank_main(args) -> int:
    """One rank of a serve-tp, serve-pp, serve-dp, serve-sp or serve-ep
    world (`--tp-rank`):
    every rank shares the card over gloo, and the world runs the windows
    of `--tp-plan` ([[window, spec], ...], one world shape) in order:
    rank 0 builds each window's engine and prints its result line, the
    others replay it (one run_worker a window; each window is a session
    of the world's wire). A window that kills a rank comes last. Any
    rank exits non-zero on any failure."""
    import traceback

    plan = json.loads(args.tp_plan)
    rank = args.tp_rank
    try:
        import torch

        from ollamamq_tpu_torch.engine import spmd
        from ollamamq_tpu_torch.ops.cuda import build
        from ollamamq_tpu_torch.parallel import distributed
        from ollamamq_tpu_torch.parallel.mesh import make_mesh

        first = plan[0][1]
        device = "cuda:0" if first["device"] == "cuda" else "cpu"
        if device != "cpu":
            for name in build.KERNELS:  # the parent built them: load only
                build.kernel_fn(name)
        world = _world(first)
        if plan[0][0] == "pp-p2p":
            print("TP-RESULT " + json.dumps(_pp_p2p_probe(rank, args.tp_port, device)),
                  flush=True)
            os._exit(0)
        distributed.initialize(f"127.0.0.1:{args.tp_port}", world, rank,
                               backend="gloo", devices=[device] * world,
                               timeout_s=120)
        distributed.store().set(f"chip_smoke/pid/{rank}", str(os.getpid()))
        mesh = make_mesh(dp=first.get("dp", 1), tp=first.get("tp", 2),
                         pp=first.get("pp", 1), sp=first.get("sp", 1),
                         ep=first.get("ep", 1))
        _model_cuts()  # serve-tp's and serve-ep's cut models, on every rank
        if rank != 0:  # metrics_federated's probe (_federated_scrape)
            from ollamamq_tpu_torch.telemetry import schema as tm

            tm.JOURNAL_EVENTS_TOTAL.labels(kind=FEDERATION_PROBE).inc()
        if rank != 0 and first.get("dp", 1) > 1:
            # serve-dp reads every rank's launches before its kill -9.
            from ollamamq_tpu_torch.ops.cuda import launch_counts

            replay = spmd._replay

            def posted(*a, **kw):
                out = replay(*a, **kw)
                distributed.store().set(f"chip_smoke/launches/{rank}",
                                        json.dumps(launch_counts()))
                return out

            spmd._replay = posted
        from ollamamq_tpu_torch.ops.cuda import reset_launch_counts

        for window, spec in plan:
            # Each window counts its own launches and peak memory, as a
            # world of its own would.
            reset_launch_counts()
            if device != "cpu":
                torch.cuda.reset_peak_memory_stats()
            if spec.get("sp", 1) > 1:
                # serve-sp holds every rank's pages after each ring
                # prefill, and its kill waits for rank 1's first hand-off.
                _sp_page_digests(window, rank)
                if window == "sp-kill" and rank != 0:
                    _sp_ring_flag(rank)
            # serve-ep digests layer 0's routing on every rank.
            unroute = (_ep_route_digests(window, rank) if spec.get("ep_checks")
                       else None)
            t0 = time.monotonic()
            if rank != 0:
                rows = _ep_capture_rows() if spec.get("ep_checks") else None
                steps = spmd.run_worker({spec["model"]: None}, _window_ecfg(spec),
                                        mesh)
                out = {"rank": rank, "steps": steps}
                if rows is not None:
                    _ep_worker_checks(window, rank, rows, mesh)
            else:
                out = {**TP_WINDOWS, **PP_WINDOWS, **DP_WINDOWS, **SP_WINDOWS,
                       **EP_WINDOWS}[window](spec, mesh, spec.get("profile", False))
            if unroute is not None:
                unroute()
            out.update(window=window, window_s=time.monotonic() - t0)
            print("TP-RESULT " + json.dumps(out), flush=True)
            gc.collect()
            if device != "cpu":
                torch.cuda.empty_cache()
        sys.stdout.flush()
        os._exit(0)  # the gloo group of a killed peer must not block teardown
    except BaseException:  # noqa: BLE001 — every failure exits non-zero
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)


def _tp_world(name, plan, timeout_s=900.0, after_leader_s=None):
    """Run the windows of `plan` ([(window, spec), ...]) in one world of
    rank processes (logs under OUT_DIR as serve_<name>_rank<r>.log);
    returns ({window: rank 0's result}, the return codes, the log
    paths). `after_leader_s`: once rank 0 has exited, the other ranks get
    that long before they are killed (a window that kills a rank leaves
    its peers to fail on their own)."""
    here = os.path.dirname(os.path.abspath(__file__))
    os.makedirs(OUT_DIR, exist_ok=True)
    port = _free_port()
    env = dict(os.environ, **TP_HB)
    ranks = range(_world(plan[0][1]))
    paths = [os.path.join(OUT_DIR, f"serve_{name}_rank{r}.log") for r in ranks]
    logs = [open(p, "w") for p in paths]
    arg = json.dumps([list(w) for w in plan])
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(here, "chip_smoke.py"), "--tp-rank", str(r),
         "--tp-port", str(port), "--tp-plan", arg],
        cwd=here, env=env, stdout=logs[r], stderr=subprocess.STDOUT) for r in ranks]
    try:
        deadline = time.monotonic() + timeout_s
        for i, p in enumerate(procs):
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
            if i == 0 and after_leader_s is not None:
                deadline = min(deadline, time.monotonic() + after_leader_s)
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    text = open(paths[0]).read()
    outs = [json.loads(ln[10:]) for ln in text.splitlines()
            if ln.startswith("TP-RESULT ")]
    results = {o.get("window", plan[0][0]): o for o in outs}
    missing = [w for w, _ in plan if w not in results]
    if missing:
        raise SystemExit(f"serve {name}: rank 0 printed no result for {missing} "
                         f"(rc {[p.returncode for p in procs]}):\n{text[-4000:]}")
    return results, [p.returncode for p in procs], paths


def _tp_nccl_check() -> dict:
    """A world-size-1 NCCL group (the backend initialize() picks for a CUDA
    rank, built on the world's store as every mesh group is) runs the
    port's TP all-reduce helper on the card."""
    import torch

    from ollamamq_tpu_torch.parallel import distributed
    from ollamamq_tpu_torch.parallel.mesh import TensorGroup

    distributed.initialize("127.0.0.1:0", 1, 0, devices=["cuda:0"], timeout_s=60)
    try:
        world = distributed.default_world()
        backend = world.backend
        x = torch.arange(4096, dtype=torch.bfloat16, device="cuda")
        y = TensorGroup(1, 0, world.group([0])).all_reduce(x.clone())
        torch.cuda.synchronize()
        ok = backend == "nccl" and bool(torch.equal(x, y))
    finally:
        distributed.shutdown()
    return {"backend": backend, "ok": ok}


def serve_tp_phase(report, profile: bool) -> None:
    """Tensor parallelism over two ranks sharing the card (gloo; NCCL
    refuses two ranks on one GPU): llama3:8b at full width (16 of 32
    layers) in bf16, then
    llama3.2:1b in float32 against one rank, in int8, and under a kill -9
    of the worker; see the module docstring."""
    import torch

    t_phase = time.monotonic()
    gc.collect()
    torch.cuda.empty_cache()
    refusal = subprocess.run(
        [sys.executable, "-m", "ollamamq_tpu_torch.cli", "--model", TP_SMALL,
         "--tp", "2", "--no-tui"], cwd=os.path.dirname(os.path.abspath(__file__)),
        capture_output=True, text=True, timeout=120)
    refusal_text = refusal.stdout + refusal.stderr
    nccl = _tp_nccl_check()
    base = {"device": TP_DEVICE, "profile": profile}
    t_world = time.monotonic()
    # One world of two ranks serves the four windows, the kill last.
    windows, rcs, _ = _tp_world("tp", [
        (w, {**base, **spec}) for w, spec in (
            ("bf16", {"model": TP_MODEL, "dtype": "bfloat16"}),
            ("f32", {"model": TP_SMALL, "dtype": "float32"}),
            ("int8", {"model": TP_SMALL, "dtype": "bfloat16", "quant": "int8"}),
            ("kill", {"model": TP_SMALL, "dtype": "bfloat16"}))])
    world_s = time.monotonic() - t_world
    bf16, f32, int8, kill = (windows[w] for w in ("bf16", "f32", "int8", "kill"))
    (w_bf16,), (w_f32,), (w_int8,) = bf16["workers"], f32["workers"], int8["workers"]
    cfg_layers = {"bf16": TP_LAYERS, "small": 16}
    worker_exact = {
        "bf16": _tp_exact(w_bf16["launches"], w_bf16["ops"], cfg_layers["bf16"], "")[0],
        "int8": _tp_exact(w_int8["launches"], w_int8["ops"], cfg_layers["small"], "_int8")[0]}
    launches = {k: 0 for k in KERNEL_ROWS}
    for counts in (bf16["launches"], w_bf16["launches"], f32["launches"],
                   w_f32["launches"], int8["launches"], w_int8["launches"]):
        for k, v in counts.items():
            launches[k] += v
    line = {"phase": "serve-tp", "model": TP_MODEL, "tp": 2, "backend": "gloo",
            "ranks_on": "cuda:0 (both)", "layers": TP_LAYERS,
            "reduced": {"num_layers": [32, TP_LAYERS]},
            "width": {"hidden": 4096, "heads": 32, "kv_heads": 8, "head_dim": 128,
                      "intermediate": 14336, "vocab": 128256,
                      "per_rank": {"heads": 16, "kv_heads": 4}},
            "dtype": "bfloat16", "streams": len(TP_STREAMS), "users": 3,
            **{k: bf16[k] for k in ("serve_s", "burst_s", "tokens", "burst_tokens",
                                    "burst_tokens_per_s", "ttft_ms", "replies",
                                    "greedy_repeat_identical", "ragged_dispatches",
                                    "decode_steps", "launches_expected", "init_s",
                                    "n_chips", "tp_layer", "per_call")},
            "param_bytes": {"rank0": bf16["param_bytes"],
                            "rank1": w_bf16["runtimes"][TP_MODEL]["param_bytes"],
                            "expected": TP_PARAM_BYTES},
            "kv_bytes": {"rank0": bf16["kv_bytes"],
                         "rank1": w_bf16["runtimes"][TP_MODEL]["kv_bytes"],
                         "expected": TP_KV_BYTES},
            "max_memory_allocated": {"rank0": bf16["max_memory_allocated"],
                                     "rank1": w_bf16.get("max_memory_allocated")},
            "digests_equal": bf16["trace"]["digest"] == w_bf16["digest"],
            "ops": {"rank0": bf16["trace"]["ops"], "rank1": w_bf16["ops"]},
            "launches_rank0_window": bf16["launches"],
            "launches_rank1": w_bf16["launches"],
            "f32": {k: f32[k] for k in ("ids_identical", "first_forward", "done")},
            "f32_launches": {"rank0": f32["launches"], "rank1": w_f32["launches"]},
            "int8": {"model": TP_SMALL, "done": int8["done"], "tokens": int8["tokens"],
                     "launches": {"rank0": int8["launches"], "rank1": w_int8["launches"]},
                     "kernels_exact": {"rank0": int8["kernels_exact"],
                                       "rank1": worker_exact["int8"]},
                     "kv_bytes": {"rank0": int8["kv_bytes"],
                                  "rank1": w_int8["runtimes"][TP_SMALL]["kv_bytes"],
                                  "tp1_serve_int8": report["serve_int8"]["kv_bytes"]},
                     "digests_equal": int8["trace"]["digest"] == w_int8["digest"],
                     "per_call": int8["per_call"]},
            "metrics_federated": bf16["metrics_federated"],
            "kill": kill, "nccl_ws1": nccl,
            "cli_tp2_exit": refusal.returncode,
            "cli_tp2_message": next((ln.split(": ", 1)[-1] for ln in refusal_text.splitlines()
                                     if "cuda:1" in ln), refusal_text[-300:]),
            "return_codes": rcs, "launches": launches, "world": "one, 2 ranks",
            "world_s": world_s,
            "windows_s": {w: windows[w]["window_s"] for w in windows}}
    line["phase_s"] = time.monotonic() - t_phase
    emit(line)
    report["serve_tp"] = line
    f32_rank = lambda c: all(c[k] > 0 for k in ("ragged_paged_attention",  # noqa: E731
                                                "paged_decode_attention"))
    half = report["serve_int8"]["kv_bytes"] / 2
    gates = {
        "replies": all(r["done_reason"] in ("stop", "length")
                       for r in line["replies"].values()),
        "greedy_repeat_identical": line["greedy_repeat_identical"],
        "ranks_ids_equal": line["digests_equal"] and line["int8"]["digests_equal"],
        "kernels_bf16_exact": bf16["kernels_exact"] and worker_exact["bf16"],
        "param_bytes": (line["param_bytes"]["rank0"] == TP_PARAM_BYTES
                        and line["param_bytes"]["rank1"] == TP_PARAM_BYTES),
        "kv_bytes": line["kv_bytes"]["rank0"] == line["kv_bytes"]["rank1"] == TP_KV_BYTES,
        "per_call_bf16": all(line["per_call"][k]["ok"]
                             for k in ("ragged_per_call", "decode_per_call")),
        "f32_ids_identical": f32["done"] and f32["ids_identical"],
        "f32_first_forward": f32["first_forward"]["ok"],
        "f32_kernels_both_ranks": f32_rank(f32["launches"]) and f32_rank(w_f32["launches"]),
        "int8_done": int8["done"],
        "int8_kernels_exact": int8["kernels_exact"] and worker_exact["int8"],
        "int8_per_call": all(int8["per_call"][k]["ok"]
                             for k in ("ragged_per_call", "decode_per_call")),
        "int8_kv_half": (line["int8"]["kv_bytes"]["rank0"] == half
                         and line["int8"]["kv_bytes"]["rank1"] == half),
        "nccl_ws1": nccl["ok"],
        "metrics_federated": line["metrics_federated"]["ok"],
        "cli_tp2_exit_2": refusal.returncode == 2 and "cuda:1" in refusal_text,
        "kill_errors": kill["kinds"] == ["error"] * 4,
        "kill_within_bound": max(kill["seconds_to_error"]) <= TP_KILL_BOUND_S,
        "kill_health": (kill["health_http"] == 200 and "worker_stale" in kill["alerts"]
                        and kill["runtime_failed"] == [True]),
        "exit_codes": rcs == [0, -9],  # rank 1 killed in the last window
    }
    emit({"phase": "serve-tp-gates", **gates})
    if not all(gates.values()):
        raise SystemExit(f"serve-tp: gates failed: {gates}")


PP_MODEL = "llama3:8b"
PP_SMALL = "llama3.2:1b"
PP_BUCKETS = (32, 64, 128, 256)
PP_MP = 24  # pages a sequence: a 600-token prompt and its reply fit in 768
# serve-tp's 4 streams, then a prompt past the largest bucket: 3 chunks.
PP_STREAMS = TP_STREAMS + (("pp-dee", 600),)


def _pp_param_bytes(cfg, pp: int, nbytes: int = 2) -> int:
    """A stage's weight bytes from the config's shapes: its L/pp layers
    and, as in the JAX package's layout, the whole embedding, final norm
    and head."""
    d, q, kv, f = cfg.hidden_size, cfg.q_dim, cfg.kv_dim, cfg.intermediate_size
    layer = 2 * d + d * q + 2 * d * kv + q * d + 3 * d * f
    layer += (q + 2 * kv) * cfg.attn_bias + 2 * cfg.head_dim * cfg.qk_norm
    top = cfg.vocab_size * d * (1 if cfg.tie_embeddings else 2) + d
    return (layer * (cfg.num_layers // pp) + top) * nbytes


def _pp_kv_bytes(cfg, pp: int, nbytes: int = 2) -> int:
    """A stage's K and V pools: its L/pp layers of 136 pages of 32."""
    return 2 * (cfg.num_layers // pp) * 136 * 32 * cfg.num_kv_heads * cfg.head_dim * nbytes


def _pp_exact(counts, decode_steps, local_layers, micro):
    """One rank's launches on the pipeline path: the bf16 decode kernel
    once per layer the stage holds, per microbatch, per decode step; no
    other kernel (the bucketed prefill and the chunks attend in plain
    PyTorch)."""
    own = {"paged_decode_attention": local_layers * micro * decode_steps}
    return (own["paged_decode_attention"] > 0
            and all(counts[k] == own.get(k, 0) for k in counts)), own


def _pp_handoffs(stats, pp: int, micro: int) -> dict:
    """A rank's hand-off costs per forward from its PipeGroup stats."""
    n = max(1, stats["forwards"])
    return {"forwards": stats["forwards"],
            "handoff_ms_per_forward": (stats["send_s"] + stats["recv_s"]
                                       + stats["staging_s"]) * 1e3 / n,
            "staging_ms_per_forward": stats["staging_s"] * 1e3 / n,
            "recv_ms_per_forward": stats["recv_s"] * 1e3 / n,
            "forward_ms": stats["forward_s"] * 1e3 / n,
            "bytes_per_forward": stats["bytes"] / n,
            "recv_share": stats["recv_s"] / max(1e-9, stats["forward_s"]),
            "schedule_bubble_share": (pp - 1) / (micro + pp - 1)}


def _pp_traffic(rt, port, model):
    """serve-pp's gated window: PP_STREAMS' 5 greedy /api/chat streams
    of TP_NEW tokens from 4 users (the last one's 600-token prompt takes
    the chunked path), then one prompt twice, alone. Rank 0's launches
    and pipe hand-offs are counted over the window."""
    from ollamamq_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from ollamamq_tpu_torch.telemetry import schema as tm

    ttft = tm.TTFT_MS.labels(model=model)
    ttft0 = list(ttft.counts)
    greedy = {"temperature": 0, "num_predict": TP_NEW}

    def body(n_tokens, tag):
        text = (f"[{tag}] " + TP_TEXT * 8)[:n_tokens - 16]  # byte tokenizer
        return {"model": model, "options": greedy,
                "messages": [{"role": "user", "content": text}]}

    results, errors = {}, []

    def run(key, user, b):
        try:
            results[key] = _ollama_result(*_post(port, "/api/chat", b, user))
        except Exception as e:  # noqa: BLE001 — reported, then fails the phase
            errors.append(f"{key}: {e}")

    keys = ("prefill_dispatches", "chunk_dispatches", "ragged_dispatches",
            "decode_dispatches", "decode_steps", "tokens_generated")
    before = {k: rt.stats()[k] for k in keys}
    pipe0 = dict(rt.pipe.stats)
    reset_launch_counts()
    t0 = time.monotonic()
    threads = [threading.Thread(target=run, args=(f"{u}/{n}", u, body(n, i)))
               for i, (u, n) in enumerate(PP_STREAMS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    burst_s = time.monotonic() - t0
    mid = rt.stats()["tokens_generated"]
    repeat = []
    for i in range(2):
        run(f"repeat{i}", "tp-bob", body(160, "repeat"))
        repeat.append(results.get(f"repeat{i}", ([], None))[0])
    counts = launch_counts()
    serve_s = time.monotonic() - t0
    after = {k: rt.stats()[k] for k in keys}
    if errors or len(results) != len(PP_STREAMS) + 2:
        raise SystemExit(f"serve-pp requests failed: {errors}")
    ops = {k: after[k] - before[k] for k in keys}
    burst_tokens = mid - before["tokens_generated"]
    pipe = {k: v - pipe0[k] for k, v in rt.pipe.stats.items()}
    return {"serve_s": serve_s, "burst_s": burst_s, "tokens": ops["tokens_generated"],
            "burst_tokens": burst_tokens, "burst_tokens_per_s": burst_tokens / burst_s,
            "ttft_ms": _delta_quantiles(ttft, ttft0, (0.5, 0.99)),
            "replies": {k: {"tokens": len(ids), "done_reason": why}
                        for k, (ids, why) in results.items()},
            "greedy_repeat_identical": repeat[0] == repeat[1] and len(repeat[0]) > 0,
            "ops": ops, "launches": counts, "pipe_window": pipe}


def _pp_leader_bf16(spec, mesh, profile):
    import torch

    from ollamamq_tpu_torch.engine.spmd import SPMDEngine
    from ollamamq_tpu_torch.parallel.pipeline import n_microbatches
    from ollamamq_tpu_torch.server.app import serve_in_thread, stop_server

    model = spec["model"]
    ecfg = _tp_ecfg(spec)
    t0 = time.monotonic()
    eng = SPMDEngine(ecfg, mesh=mesh, blocklist_path=None)
    torch.cuda.synchronize()
    init_s = time.monotonic() - t0
    rt = eng.runtimes[model]
    srv = serve_in_thread(eng, port=0, timeout_s=600)
    line = _pp_traffic(rt, srv.server_address[1], model)
    if profile:
        line["profile"] = profile_window(srv.server_address[1], model, TP_TEXT * 3, rt)
    stop_server(srv)
    micro = n_microbatches(ecfg.max_slots, mesh.pp)
    line["kernels_exact"], line["launches_expected"] = _pp_exact(
        line["launches"], line["ops"]["decode_steps"], len(rt.params["layers"]), micro)
    line.update(init_s=init_s, param_bytes=rt.param_bytes, kv_bytes=rt.kv_bytes,
                max_memory_allocated=torch.cuda.max_memory_allocated(),
                n_chips=rt.n_chips, micro=micro, layers=len(rt.params["layers"]),
                handoffs=_pp_handoffs(line["pipe_window"], mesh.pp, micro),
                trace=eng.spmd_report(), workers=eng.worker_reports)
    calls = {}
    kernel_vs_plain_logits(calls, "serve-pp", rt, TP_TEXT * 2, "bfloat16",
                           per_call=True)
    line["per_call"] = calls["serve_pp_logits"]
    return line


def _pp_first_prefill(capture):
    """Wrap the pipelined prefill so its first call's logits land in
    `capture` (on the host)."""
    from ollamamq_tpu_torch.parallel import pipeline

    orig = pipeline.pp_forward_prefill

    def wrapped(*a, **kw):
        out = orig(*a, **kw)
        capture.setdefault("logits", out[0].float().cpu())
        return out

    pipeline.pp_forward_prefill = wrapped
    return orig


def _pp_leader_f32(spec, mesh, profile):
    """f32 identity (TF32 off): 4 greedy streams of 32 tokens on the
    pipelined engine (pp 2, or pp 2 x tp 2), then the same requests on a
    one-rank engine of the same seed, every request queued before the
    loop starts; request 0's first logits (row 0 of the first prefill,
    bucketed on one side and ragged on the other) compared."""
    import torch

    from ollamamq_tpu_torch.engine.engine import TorchEngine
    from ollamamq_tpu_torch.engine.spmd import SPMDEngine
    from ollamamq_tpu_torch.models import llama
    from ollamamq_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from ollamamq_tpu_torch.ops.sampling import SamplingParams
    from ollamamq_tpu_torch.parallel import pipeline

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model, ecfg = spec["model"], _tp_ecfg(spec)
    prompts = [f"[{i}] " + TP_TEXT[:40 + 17 * i] for i in range(4)]

    def run(eng, wrap):
        capture = {}
        orig = wrap(capture)
        try:
            tok = eng.runtimes[model].tokenizer
            reqs = [eng.enqueue_request(f"f32-{i}", "", model,
                                        prompt_tokens=tok.encode(p),
                                        sampling=SamplingParams(max_tokens=32,
                                                                temperature=0.0))
                    for i, p in enumerate(prompts)]
            eng.start()
            items = [_tp_wait(r) for r in reqs]
        finally:
            if wrap is _pp_first_prefill:
                pipeline.pp_forward_prefill = orig
            else:
                llama.forward_ragged = orig
        eng.stop()
        ok = all(it is not None and it.kind == "done" for it in items)
        return [r.generated_ids for r in reqs], capture, ok

    reset_launch_counts()
    pp_eng = SPMDEngine(ecfg, mesh=mesh, blocklist_path=None)
    idsp, capp, okp = run(pp_eng, _pp_first_prefill)
    counts = launch_counts()
    worker = pp_eng.worker_reports
    del pp_eng
    one = TorchEngine(dataclasses.replace(ecfg, pp=1), device=mesh.device,
                      blocklist_path=None)
    ids1, cap1, ok1 = run(one, _tp_first_forward)
    a, b = capp["logits"][0], cap1["logits"][0]
    scale = float(b.abs().max())
    err = float((a - b).abs().max())
    return {"ids_pp": idsp, "ids_one": ids1, "done": ok1 and okp,
            "ids_identical": ids1 == idsp and all(len(x) > 0 for x in idsp),
            "first_logits": {"max_abs_err": err, "ref_max_abs": scale,
                             "rel_err": err / scale,
                             "tol": f"max |pp - one| <= {TOL['float32']} * max |one|",
                             "ok": err <= TOL["float32"] * scale},
            "launches": counts, "workers": worker}


def _pp_leader_int8(spec, mesh, profile):
    """int8 weights over bf16 pages at pp 2: 2 greedy streams of 32
    tokens; the bf16 decode kernel exactly per stage layer, microbatch
    and step, nothing else."""
    from ollamamq_tpu_torch.engine.spmd import SPMDEngine
    from ollamamq_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from ollamamq_tpu_torch.ops.sampling import SamplingParams
    from ollamamq_tpu_torch.parallel.pipeline import n_microbatches

    model, ecfg = spec["model"], _tp_ecfg(spec)
    eng = SPMDEngine(ecfg, mesh=mesh, blocklist_path=None)
    rt = eng.runtimes[model]
    tok = rt.tokenizer
    before = rt.stats()
    reset_launch_counts()
    eng.start()
    reqs = [eng.enqueue_request(f"int8-{i}", "", model,
                                prompt_tokens=tok.encode(TP_TEXT * (i + 1)),
                                sampling=SamplingParams(max_tokens=32, temperature=0.0))
            for i in range(2)]
    items = [_tp_wait(r) for r in reqs]
    counts = launch_counts()
    eng.stop()
    micro = n_microbatches(ecfg.max_slots, mesh.pp)
    steps = rt.stats()["decode_steps"] - before["decode_steps"]
    exact, own = _pp_exact(counts, steps, len(rt.params["layers"]), micro)
    return {"done": all(it is not None and it.kind == "done" for it in items),
            "reasons": [it.finish_reason.value if it and it.finish_reason else None
                        for it in items],
            "tokens": [len(r.generated_ids) for r in reqs], "decode_steps": steps,
            "launches": counts, "launches_expected": own, "kernels_exact": exact,
            "param_bytes": rt.param_bytes, "micro": micro,
            "layers": len(rt.params["layers"]), "trace": eng.spmd_report(),
            "workers": eng.worker_reports}


def _pp_p2p_probe(rank: int, port: int, device: str) -> dict:
    """Does gloo's send/recv take CUDA tensors as they are? Two ranks
    on the card try it once (the pipe group stages through pinned host
    buffers instead; this records what the raw call does)."""
    import datetime

    import torch
    import torch.distributed as dist

    store = dist.TCPStore("127.0.0.1", port, 2, is_master=rank == 0,
                          timeout=datetime.timedelta(seconds=60),
                          wait_for_workers=False)
    dist.init_process_group("gloo", store=dist.PrefixStore("pg", store), rank=rank,
                            world_size=2, timeout=datetime.timedelta(seconds=60))
    x = torch.arange(4096, dtype=torch.float32, device=device)
    out = {"rank": rank}
    try:
        if rank == 0:
            dist.send(x, 1)
        else:
            y = torch.zeros_like(x)
            dist.recv(y, 0)
            out["equal"] = bool(torch.equal(x, y))
        out["ok"] = True
    except Exception as e:  # noqa: BLE001 — the probe's answer
        out.update(ok=False, error=f"{type(e).__name__}: {str(e)[:300]}")
    store.set(f"p2p/{rank}", json.dumps(out))
    if rank == 0:
        try:
            store.wait(["p2p/1"], datetime.timedelta(seconds=30))
            out["peer"] = json.loads(store.get("p2p/1"))
        except Exception as e:  # noqa: BLE001 — the peer died in the call
            out["peer"] = {"error": f"{type(e).__name__}: {str(e)[:200]}"}
    return out


PP_WINDOWS = {"pp-bf16": _pp_leader_bf16, "pp-f32": _pp_leader_f32,
              "pp-tp-f32": _pp_leader_f32, "pp-int8": _pp_leader_int8,
              "pp-kill": _tp_leader_kill}


def serve_pp_phase(report, profile: bool) -> None:
    """Pipeline parallelism over ranks sharing the card (gloo): llama3:8b
    at full width and depth over two stages in bf16, then llama3.2:1b at
    pp 2 and pp 2 x tp 2 in float32 against one rank, with int8 weights,
    and under a kill -9 of the last stage; see the module docstring."""
    import torch

    from ollamamq_tpu_torch.config import get_model_config

    t_phase = time.monotonic()
    gc.collect()
    torch.cuda.empty_cache()
    here = os.path.dirname(os.path.abspath(__file__))
    refusal = subprocess.run(
        [sys.executable, "-m", "ollamamq_tpu_torch.cli", "--model", PP_SMALL,
         "--pp", "2", "--kv-dtype", "int8", "--no-tui"], cwd=here,
        capture_output=True, text=True, timeout=120)
    refusal_text = refusal.stdout + refusal.stderr
    t0 = time.monotonic()
    try:  # recorded, not gated: a rank may die inside the raw call
        out, probe_rc, _ = _tp_world("pp_p2p", [("pp-p2p", {"device": TP_DEVICE,
                                                            "tp": 2})],
                                     timeout_s=120)
        probe = out["pp-p2p"]
    except SystemExit as e:
        probe, probe_rc = {"error": str(e)[-600:]}, None
    probe["window_s"] = time.monotonic() - t0
    base = {"device": TP_DEVICE, "profile": profile, "tp": 1, "pp": 2, "mp": PP_MP}
    # One world of two ranks serves the pp-2 windows, the kill last; the
    # pp 2 x tp 2 window needs four ranks, a world of its own.
    t0 = time.monotonic()
    windows, rc2, _ = _tp_world("pp", [
        (w, {**base, **spec}) for w, spec in (
            ("pp-bf16", {"model": PP_MODEL, "dtype": "bfloat16"}),
            ("pp-f32", {"model": PP_SMALL, "dtype": "float32", "new": 32}),
            ("pp-int8", {"model": PP_SMALL, "dtype": "bfloat16",
                         "quant": "int8", "kv": "bfloat16"}),
            ("pp-kill", {"model": PP_SMALL, "dtype": "bfloat16"}))])
    world_s = {"pp2": time.monotonic() - t0}
    t0 = time.monotonic()
    out, rc4, _ = _tp_world("pp_tp", [("pp-tp-f32", {
        **base, "model": PP_SMALL, "dtype": "float32", "new": 32, "tp": 2})])
    world_s["pp2_tp2"] = time.monotonic() - t0
    windows.update(out)
    rcs = {"pp2": rc2, "pp2_tp2": rc4}
    bf16, f32, f32tp, int8, kill = (windows[w] for w in
                                    ("pp-bf16", "pp-f32", "pp-tp-f32", "pp-int8", "pp-kill"))
    (w_bf16,), (w_int8,) = bf16["workers"], int8["workers"]
    cfg8, cfg1 = get_model_config(PP_MODEL), get_model_config(PP_SMALL)
    param_bytes = _pp_param_bytes(cfg8, 2)
    kv_bytes = _pp_kv_bytes(cfg8, 2)
    w_exact = {
        "bf16": _pp_exact(w_bf16["launches"], w_bf16["ops"]["decode_steps"],
                          bf16["layers"], bf16["micro"])[0],
        "int8": _pp_exact(w_int8["launches"], w_int8["ops"]["decode_steps"],
                          int8["layers"], int8["micro"])[0]}
    f32_ranks = [c for c in [f32["launches"], f32tp["launches"]]
                 + [w["launches"] for w in f32["workers"] + f32tp["workers"]]]
    launches = {k: 0 for k in KERNEL_ROWS}
    for counts in ([bf16["launches"], w_bf16["launches"], int8["launches"],
                    w_int8["launches"]] + f32_ranks):
        for k, v in counts.items():
            launches[k] += v
    w_pipe = w_bf16["runtimes"][PP_MODEL]["pipe"]
    line = {"phase": "serve-pp", "model": PP_MODEL, "pp": 2, "tp": 1, "backend": "gloo",
            "ranks_on": "cuda:0 (both)", "layers": 32, "layers_per_stage": bf16["layers"],
            "microbatches": bf16["micro"],
            "width": {"hidden": 4096, "heads": 32, "kv_heads": 8, "head_dim": 128,
                      "intermediate": 14336, "vocab": 128256},
            "dtype": "bfloat16", "streams": len(PP_STREAMS), "users": 4,
            "buckets": list(PP_BUCKETS), "pages_per_seq": PP_MP,
            **{k: bf16[k] for k in ("serve_s", "burst_s", "tokens", "burst_tokens",
                                    "burst_tokens_per_s", "ttft_ms", "replies",
                                    "greedy_repeat_identical", "ops", "init_s",
                                    "n_chips", "per_call", "launches_expected",
                                    "handoffs")},
            "param_bytes": {"rank0": bf16["param_bytes"],
                            "rank1": w_bf16["runtimes"][PP_MODEL]["param_bytes"],
                            "expected": param_bytes},
            "kv_bytes": {"rank0": bf16["kv_bytes"],
                         "rank1": w_bf16["runtimes"][PP_MODEL]["kv_bytes"],
                         "expected": kv_bytes},
            "max_memory_allocated": {"rank0": bf16["max_memory_allocated"],
                                     "rank1": w_bf16.get("max_memory_allocated")},
            "handoffs_rank1_whole_run": _pp_handoffs(w_pipe, 2, bf16["micro"]),
            "digests_equal": bf16["trace"]["digest"] == w_bf16["digest"],
            "ops_ranks": {"rank0": bf16["trace"]["ops"], "rank1": w_bf16["ops"]},
            "launches_rank0_window": bf16["launches"],
            "launches_rank1": w_bf16["launches"],
            "f32": {k: f32[k] for k in ("ids_identical", "first_logits", "done")},
            "f32_pp2_tp2": {k: f32tp[k] for k in ("ids_identical", "first_logits", "done")},
            "int8_weights": {k: int8[k] for k in ("done", "reasons", "tokens",
                                                  "decode_steps", "launches",
                                                  "launches_expected", "param_bytes")},
            "int8_workers_launches": w_int8["launches"],
            "kill": kill, "p2p_probe": {**probe, "rc": probe_rc},
            "cli_pp2_kv_int8_exit": refusal.returncode,
            "cli_pp2_kv_int8_message": next(
                (ln.split(": ", 1)[-1] for ln in refusal_text.splitlines()
                 if "--kv-dtype=int8" in ln), refusal_text[-300:]),
            "return_codes": rcs, "launches": launches,
            "worlds": {"pp2": "pp-bf16, pp-f32, pp-int8, pp-kill",
                       "pp2_tp2": "pp-tp-f32"}, "worlds_s": world_s,
            "windows_s": {w: windows[w]["window_s"] for w in windows}}
    line["phase_s"] = time.monotonic() - t_phase
    emit(line)
    report["serve_pp"] = line
    f32_rank = lambda c: c["paged_decode_attention"] > 0 and all(  # noqa: E731
        v == 0 for k, v in c.items() if k != "paged_decode_attention")
    gates = {
        "replies": all(r["done_reason"] in ("stop", "length")
                       for r in line["replies"].values()),
        "greedy_repeat_identical": line["greedy_repeat_identical"],
        "ranks_ids_equal": line["digests_equal"],
        "chunk_path_ran": line["ops"]["chunk_dispatches"] >= 3,
        "bucketed_prefill_ran": line["ops"]["prefill_dispatches"] >= 1,
        "kernels_bf16_exact": bf16["kernels_exact"] and w_exact["bf16"],
        "ragged_and_int8_zero": all(
            c[k] == 0 for c in (bf16["launches"], w_bf16["launches"])
            for k in c if k != "paged_decode_attention"),
        "param_bytes": (line["param_bytes"]["rank0"] == param_bytes
                        and line["param_bytes"]["rank1"] == param_bytes),
        "kv_bytes": line["kv_bytes"]["rank0"] == line["kv_bytes"]["rank1"] == kv_bytes,
        "per_call_bf16": all(line["per_call"][k]["ok"]
                             for k in ("ragged_per_call", "decode_per_call")),
        "f32_ids_identical": f32["done"] and f32["ids_identical"],
        "f32_first_logits": f32["first_logits"]["ok"],
        "f32_pp2_tp2_ids_identical": f32tp["done"] and f32tp["ids_identical"],
        "f32_kernels_every_rank": all(f32_rank(c) for c in f32_ranks),
        "int8_weights_done": int8["done"] and all(
            r in ("stop", "length") for r in int8["reasons"]),
        "int8_weights_exact": (int8["kernels_exact"] and w_exact["int8"]
                               and int8["param_bytes"] < _pp_param_bytes(cfg1, 2)),
        "cli_pp2_kv_int8_exit_2": (refusal.returncode == 2
                                   and "--kv-dtype=int8 needs the ragged" in refusal_text),
        "kill_errors": kill["kinds"] == ["error"] * 4,
        "kill_within_bound": max(kill["seconds_to_error"]) <= TP_KILL_BOUND_S,
        "kill_health": (kill["health_http"] == 200 and "worker_stale" in kill["alerts"]
                        and kill["runtime_failed"] == [True]),
        "exit_codes": rcs == {"pp2": [0, -9], "pp2_tp2": [0, 0, 0, 0]},
    }
    emit({"phase": "serve-pp-gates", **gates})
    if not all(gates.values()):
        raise SystemExit(f"serve-pp: gates failed: {gates}")


DP_MODEL = "llama3.2:1b"
DP_NEW = 48
DP_USERS = ("dp-ada", "dp-bob", "dp-cyd", "dp-dee", "dp-eve")
DP_TEXT = ("Data parallelism serves one model as replicas that each hold their "
           "own weights, pages and slots. ")
# Two prompts, one per replica, in float32 (TF32 off) against one replica.
DP_F32_PROMPTS = ("[0] " + DP_TEXT, "[1] " + DP_TEXT[:70])
DP_KILL_NEW = 96  # tokens of each stream of the world's kill -9


def _dp_ecfg(dtype: str, dp: int):
    """serve's shape: 8 slots and 136 pages of 32 a replica, 16 pages a
    sequence, token budget 512, k_steps 8."""
    from ollamamq_tpu_torch.config import EngineConfig

    return EngineConfig(model=DP_MODEL, max_slots=8, num_pages=8 * 16 + 8,
                        page_size=32, max_pages_per_seq=16, max_batch_tokens=512,
                        token_granule=16, max_new_tokens=DP_NEW,
                        decode_steps_per_iter=8, dtype=dtype, dp=dp, seed=0)


def _dp_engine(dtype: str, dp: int):
    """A TorchEngine of dp in-process replicas, all on cuda:0."""
    from ollamamq_tpu_torch.engine.engine import TorchEngine
    from ollamamq_tpu_torch.parallel.mesh import make_mesh

    device = "cuda:0" if TP_DEVICE == "cuda" else TP_DEVICE
    mesh = make_mesh(dp=dp, devices=[device] * dp) if dp > 1 else None
    return TorchEngine(_dp_ecfg(dtype, dp), device=device, mesh=mesh,
                       blocklist_path=None)


def _dp_replicas(eng):
    from ollamamq_tpu_torch.engine.engine import ReplicaSet

    rt = eng.runtimes[DP_MODEL]
    return list(rt.replicas) if isinstance(rt, ReplicaSet) else [rt]


def _dp_burst(port):
    """serve's traffic doubled: 8 greedy /api/generate requests of DP_NEW
    tokens from 5 users at once (prompts of 1 to 3 sentences)."""
    results, errors = {}, []

    def run(i):
        body = {"model": DP_MODEL, "prompt": f"[{i}] " + DP_TEXT * (1 + i % 3),
                "stream": False, "options": {"temperature": 0, "num_predict": DP_NEW}}
        try:
            results[i] = _ollama_result(*_post(port, "/api/generate", body,
                                               DP_USERS[i % len(DP_USERS)]))
        except Exception as e:  # noqa: BLE001 — reported, then fails the phase
            errors.append(f"{i}: {e}")

    t0 = time.monotonic()
    threads = [threading.Thread(target=run, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    seconds = time.monotonic() - t0
    if errors or len(results) != 8:
        raise SystemExit(f"serve-dp requests failed: {errors}")
    return results, seconds


def _dp_instrument(eng, reps):
    """Per-replica accounting over the window: each replica's kernel
    launches (the process-wide counters' deltas around its own ragged and
    decode dispatches; the loop thread issues them one at a time), the
    decode dispatch / collect events by engine tick, and every placement
    of the set with the loads it saw."""
    from ollamamq_tpu_torch.ops.cuda import launch_counts

    acct = {"launches": [dict.fromkeys(KERNEL_ROWS, 0) for _ in reps],
            "events": [], "placements": []}
    for i, rt in enumerate(reps):
        for attr in ("_ragged_dispatch", "_dispatch_decode"):
            orig = getattr(rt, attr)

            def counted(*a, _orig=orig, _i=i, **kw):
                before = launch_counts()
                out = _orig(*a, **kw)
                for k, v in launch_counts().items():
                    acct["launches"][_i][k] += v - before[k]
                return out

            setattr(rt, attr, counted)
        disp, coll = rt.step_decode_dispatch, rt.step_decode_collect

        def dispatch(core, k_steps=1, _orig=disp, _i=i):
            h = _orig(core, k_steps=k_steps)
            if h is not None:
                acct["events"].append((eng.journal.tick, "dispatch", _i))
            return h

        def collect(handle, core, _orig=coll, _i=i):
            acct["events"].append((eng.journal.tick, "collect", _i))
            return _orig(handle, core)

        rt.step_decode_dispatch, rt.step_decode_collect = dispatch, collect
    rs = eng.runtimes[DP_MODEL]
    submit = rs.submit

    def placed(req):
        loads = [rs._load(r) for r in rs.replicas]
        able = [r.has_capacity(req.kind) for r in rs.replicas]
        last = rs._last_idx
        ok = submit(req)
        acct["placements"].append({"loads": loads, "eligible": able, "last": last,
                                   "chosen": rs._last_idx if ok else None})
        return ok

    rs.submit = placed
    return acct


def _dp_least_loaded(p) -> bool:
    """The pick a least-loaded set must make: the eligible replica of the
    least load, ties rotating after the previous pick."""
    eligible = [i for i, ok in enumerate(p["eligible"]) if ok]
    if not eligible:
        return p["chosen"] is None
    best = min(p["loads"][i] for i in eligible)
    n = len(p["loads"])
    want = next(i for i in ((p["last"] + off) % n for off in range(1, n + 1))
                if i in eligible and p["loads"][i] == best)
    return p["chosen"] == want


def _dp_bf16(dp: int) -> dict:
    """The bf16 burst on a dp-replica engine (after one warm-up request);
    at dp 2 with per-replica launches, events and placements."""
    import torch

    from ollamamq_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from ollamamq_tpu_torch.server.app import serve_in_thread, stop_server

    gc.collect()
    torch.cuda.empty_cache()
    eng = _dp_engine("bfloat16", dp)
    reps = _dp_replicas(eng)
    srv = serve_in_thread(eng, port=0, timeout_s=600)
    port = srv.server_address[1]
    try:
        _post(port, "/api/generate", {"model": DP_MODEL, "prompt": "warm",
                                      "stream": False,
                                      "options": {"num_predict": 4}}, "dp-warm")
        acct = _dp_instrument(eng, reps) if dp > 1 else None
        before = [rt.stats() for rt in reps]
        reset_launch_counts()
        results, seconds = _dp_burst(port)
        counts = launch_counts()
        after = [rt.stats() for rt in reps]
    finally:
        stop_server(srv)
    from ollamamq_tpu_torch.telemetry.journal import check_invariants

    violations = check_invariants(eng.journal.tail(n=None))
    tokens = sum(a["tokens_generated"] - b["tokens_generated"]
                 for a, b in zip(after, before))
    out = {"dp": dp, "burst_s": seconds, "tokens": tokens,
           "tokens_per_s": tokens / seconds,
           "replies": {i: {"tokens": len(ids), "done_reason": why}
                       for i, (ids, why) in sorted(results.items())},
           "launches": counts, "journal_violations": violations[:3],
           "param_bytes": [rt.param_bytes for rt in reps],
           "kv_bytes": [rt.kv_bytes for rt in reps],
           "set_param_bytes": eng.runtimes[DP_MODEL].param_bytes,
           "set_kv_bytes": eng.runtimes[DP_MODEL].kv_bytes,
           "per_replica": [{k: a[k] - b[k] for k in ("tokens_generated",
                                                      "ragged_dispatches",
                                                      "decode_dispatches",
                                                      "decode_steps")}
                           for a, b in zip(after, before)]}
    if acct is not None:
        layers = reps[0].cfg.num_layers
        out["replica_launches"] = acct["launches"]
        out["replica_exact"] = [
            lc["ragged_paged_attention"] == layers * pr["ragged_dispatches"] > 0
            and lc["paged_decode_attention"] == layers * pr["decode_steps"] > 0
            and lc["ragged_paged_attention_int8"] == lc["paged_decode_attention_int8"] == 0
            for lc, pr in zip(acct["launches"], out["per_replica"])]
        out["launches_sum_equal"] = all(
            counts[k] == sum(lc[k] for lc in acct["launches"]) for k in counts)
        ticks = {}
        for tick, kind, i in acct["events"]:
            ticks.setdefault(tick, []).append((kind, i))
        both = [evs for evs in ticks.values()
                if {i for kind, i in evs if kind == "dispatch"} == {0, 1}]
        out["ticks_both_decoding"] = len(both)
        # Within every tick, no collect before a dispatch.
        out["dispatches_before_collects"] = all(
            [k for k, _ in evs] == sorted((k for k, _ in evs),
                                          key=lambda k: k == "collect")
            for evs in ticks.values())
        out["placements"] = acct["placements"]
        out["placements_least_loaded"] = all(_dp_least_loaded(p)
                                             for p in acct["placements"])
        out["placed_on"] = [sum(p["chosen"] == r for p in acct["placements"])
                            for r in range(dp)]
    del eng, reps
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _dp_f32_ids(dp: int) -> dict:
    """float32 (TF32 off): DP_F32_PROMPTS on a dp-replica engine. At dp 1
    each prompt alone; at dp 2 both queued before the loop starts, so the
    replicas take one each, alone in its batch as at dp 1."""
    import torch

    from ollamamq_tpu_torch.ops.sampling import SamplingParams

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gc.collect()
    torch.cuda.empty_cache()
    eng = _dp_engine("float32", dp)
    reps = _dp_replicas(eng)
    tok = reps[0].tokenizer

    def enqueue(i):
        return eng.enqueue_request(f"f32-{i}", "", DP_MODEL,
                                   prompt_tokens=tok.encode(DP_F32_PROMPTS[i]),
                                   sampling=SamplingParams(max_tokens=32,
                                                           temperature=0.0))

    ends = []
    try:
        if dp == 1:
            eng.start()
            reqs = []
            for i in range(len(DP_F32_PROMPTS)):
                reqs.append(enqueue(i))
                ends.append(_collect(reqs[-1])[-1].kind)
        else:
            reqs = [enqueue(i) for i in range(len(DP_F32_PROMPTS))]
            eng.start()
            ends = [_collect(r)[-1].kind for r in reqs]
    finally:
        eng.stop()
    out = {"ids": [list(r.generated_ids) for r in reqs],
           "done": ends == ["done"] * len(reqs),
           "per_replica_tokens": [rt.tokens_generated for rt in reps]}
    del eng, reps
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _dp_world_leader(spec, mesh, profile):
    """dp 2 x tp 2 over four ranks sharing the card (gloo), float32: the
    f32 prompts queued before the loop starts (one per replica), every
    rank's kernel launches, then 4 greedy streams (2 a replica) and kill
    -9 of rank 3 (replica 1) once each holds 16 tokens: replica 1's
    requests must error within the heartbeat bound while replica 0's
    finish."""
    import urllib.request

    import torch

    from ollamamq_tpu_torch.engine.spmd import SPMDEngine
    from ollamamq_tpu_torch.ops.cuda import launch_counts
    from ollamamq_tpu_torch.ops.sampling import SamplingParams
    from ollamamq_tpu_torch.parallel import distributed
    from ollamamq_tpu_torch.server.app import serve_in_thread, stop_server

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model, ecfg = spec["model"], _tp_ecfg(spec)
    eng = SPMDEngine(ecfg, mesh=mesh, blocklist_path=None)
    rs = eng.runtimes[model]
    tok = rs.tokenizer

    def enqueue(user, prompt, n):
        return eng.enqueue_request(user, "", model, prompt_tokens=tok.encode(prompt),
                                   sampling=SamplingParams(max_tokens=n, temperature=0.0))

    def where(reqs):
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline:
            got = {id(r): i for i, rt in enumerate(rs.replicas)
                   for r in rt.held_requests() if any(r is q for q in reqs)}
            if len(got) == len(reqs):
                return [got[id(r)] for r in reqs]
            time.sleep(0.002)
        raise SystemExit("serve-dp world: requests never placed")

    reqs = [enqueue(f"f32-{i}", p, 32) for i, p in enumerate(DP_F32_PROMPTS)]
    srv = serve_in_thread(eng, port=0, timeout_s=600)  # starts the loop
    placed = where(reqs)
    items = [_tp_wait(r) for r in reqs]
    f32 = {"ids": [list(r.generated_ids) for r in reqs], "replicas": placed,
           "done": all(it is not None and it.kind == "done" for it in items),
           "per_replica_tokens": [rt.tokens_generated for rt in rs.replicas]}
    port = srv.server_address[1]
    metrics = _federated_scrape(eng, port)
    client = distributed.store()
    launches = {0: launch_counts()}
    for r in range(1, mesh.size):  # each worker posts its own after a replay
        key = f"chip_smoke/launches/{r}"
        launches[r] = (json.loads(client.get(key)) if client.check([key])
                       else dict.fromkeys(KERNEL_ROWS, 0))
    kill_reqs = [enqueue(f"kill-{i}", DP_TEXT, DP_KILL_NEW) for i in range(4)]
    kill_on = where(kill_reqs)
    deadline = time.monotonic() + 300
    while (min(len(r.generated_ids) for r in kill_reqs) < 16
           and time.monotonic() < deadline):
        time.sleep(0.005)
    at_kill = [len(r.generated_ids) for r in kill_reqs]
    os.kill(int(client.get("chip_smoke/pid/3")), signal.SIGKILL)
    t_kill = time.monotonic()
    ends = [None] * len(kill_reqs)

    def end(i, r):  # each stream's own end, seconds after the kill
        it = _tp_wait(r, budget=180)
        ends[i] = [it.kind if it else "timeout", (it.error or "")[:160] if it else "",
                   time.monotonic() - t_kill, len(r.generated_ids)]

    waiters = [threading.Thread(target=end, args=(i, r))
               for i, r in enumerate(kill_reqs)]
    for t in waiters:
        t.start()
    for t in waiters:
        t.join(timeout=200)
    time.sleep(3.5)  # past the heartbeat's staleness
    eng.health.check_once()
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/health",
                                timeout=30) as resp:
        health = json.loads(resp.read())
    stop_server(srv)
    eng.stop(report_timeout_s=5)
    return {"f32": f32, "launches": launches,
            "metrics_federated": metrics,
            "kill": {"replicas": kill_on, "tokens_at_kill": at_kill, "ends": ends,
                     "bound_s": TP_KILL_BOUND_S,
                     "failed_replicas": [rt._failed for rt in rs.replicas],
                     "alerts": [a["name"] for a in health["alerts"]],
                     "health_status": health["status"]},
            "workers": eng.worker_reports}


DP_WINDOWS = {"dp-world": _dp_world_leader}


def serve_dp_phase(report) -> None:
    """Data parallelism: two replicas of llama3.2:1b at full width in one
    process on cuda:0 (bf16 gates, tokens/s against one replica, float32
    ids against one replica), then dp 2 x tp 2 over four ranks sharing
    the card; see the module docstring."""
    from ollamamq_tpu_torch.ops.cuda import launch_counts, reset_launch_counts

    t_phase = time.monotonic()
    card = card_line()
    one = _dp_bf16(1)
    two = _dp_bf16(2)
    reset_launch_counts()
    f32_one = _dp_f32_ids(1)
    f32_two = _dp_f32_ids(2)
    f32_counts = launch_counts()
    t0 = time.monotonic()
    out, rcs, _ = _tp_world("dp", [("dp-world", {"model": DP_MODEL,
                                                 "dtype": "float32", "dp": 2,
                                                 "tp": 2, "device": TP_DEVICE})],
                            after_leader_s=30.0)
    world = out["dp-world"]
    world_s = time.monotonic() - t0
    launches = {k: 0 for k in KERNEL_ROWS}
    for counts in ([two["launches"], f32_counts]
                   + list(world["launches"].values())):
        for k, v in counts.items():
            launches[k] += v
    kill = world["kill"]
    by_rep = {r: [e for e, on in zip(kill["ends"], kill["replicas"]) if on == r]
              for r in (0, 1)}
    f32_kernels = ("ragged_paged_attention", "paged_decode_attention")
    line = {"phase": "serve-dp", "card": card, "model": DP_MODEL, "layers": 16,
            "width": {"hidden": 2048, "heads": 32, "kv_heads": 8, "head_dim": 64,
                      "vocab": 128256},
            "in_process": {"devices": "cuda:0 (both replicas)", "slots": 8,
                           "pages": 136, "page_size": 32, "pages_per_seq": 16,
                           "k_steps": 8, "requests": 8, "users": len(DP_USERS),
                           "new_tokens": DP_NEW},
            "bf16_dp1": {k: one[k] for k in ("burst_s", "tokens", "tokens_per_s",
                                             "param_bytes", "kv_bytes")},
            "bf16_dp2": two, "dp2_vs_dp1_tokens_per_s": two["tokens_per_s"] / one["tokens_per_s"],
            "f32": {"dp1_ids": f32_one["ids"], "dp2_ids": f32_two["ids"],
                    "dp2_per_replica_tokens": f32_two["per_replica_tokens"]},
            "world": {"ranks": 4, "grid": "dp 2 x tp 2", "backend": "gloo",
                      "ranks_on": "cuda:0 (all)", "seconds": world_s,
                      "f32": world["f32"], "launches": world["launches"],
                      "metrics_federated": world["metrics_federated"],
                      "kill": kill, "return_codes": rcs},
            "launches": launches}
    line["phase_s"] = time.monotonic() - t_phase
    emit(line)
    report["serve_dp"] = line
    gates = {
        "replies": all(r["done_reason"] in ("stop", "length") and r["tokens"] > 0
                       for out in (one, two) for r in out["replies"].values()),
        "each_replica_both_bf16_kernels": all(two["replica_exact"]),
        "launches_per_replica_sum_to_window": two["launches_sum_equal"],
        "placements_least_loaded": (two["placements_least_loaded"]
                                    and all(n > 0 for n in two["placed_on"])),
        "param_bytes_2x": (two["set_param_bytes"] == 2 * two["param_bytes"][0]
                           == 2 * one["param_bytes"][0]),
        "kv_bytes_2x": (two["set_kv_bytes"] == 2 * two["kv_bytes"][0]
                        == 2 * one["kv_bytes"][0]),
        "dispatches_before_collects": (two["ticks_both_decoding"] > 0
                                       and two["dispatches_before_collects"]),
        "f32_ids_equal_dp1": (f32_one["done"] and f32_two["done"]
                              and f32_two["ids"] == f32_one["ids"]
                              and all(len(x) > 0 for x in f32_one["ids"])),
        "f32_both_replicas": all(n > 0 for n in f32_two["per_replica_tokens"]),
        "world_each_replica_served": (world["f32"]["done"]
                                      and sorted(world["f32"]["replicas"]) == [0, 1]
                                      and all(n > 0 for n in
                                              world["f32"]["per_replica_tokens"])),
        "world_ids_equal_one_rank": world["f32"]["ids"] == f32_one["ids"],
        "world_every_rank_kernels": all(c[k] > 0 for c in world["launches"].values()
                                        for k in f32_kernels),
        "metrics_federated": world["metrics_federated"]["ok"],
        "kill_replica1_errors": (len(by_rep[1]) == 2 and all(
            e[0] == "error" and e[2] <= TP_KILL_BOUND_S for e in by_rep[1])),
        "kill_replica0_finishes": (len(by_rep[0]) == 2 and all(
            e[0] == "done" and e[3] == DP_KILL_NEW for e in by_rep[0])),
        "kill_only_replica1_failed": kill["failed_replicas"] == [False, True],
        "kill_worker_stale": "worker_stale" in kill["alerts"],
        "journals_clean": (not one["journal_violations"] and not two["journal_violations"]
                           and "journal_invariant" not in kill["alerts"]),
        "world_exit_codes": rcs[0] == 0 and rcs[1] == 0 and rcs[3] == -9,
    }
    emit({"phase": "serve-dp-gates", **gates})
    if not all(gates.values()):
        raise SystemExit(f"serve-dp: gates failed: {gates}")


SP_MODEL = "llama3.2:1b"
SP_NEW = 32
SP_LONG = 8000  # token ids of each long prompt: T 8,192 and C 4,096 at sp 2
SP_F32_LONG = 5000
SP_PAGES, SP_PS, SP_MP = 640, 32, 272  # 8,704 tokens a sequence
# Two chats that stay under the largest bucket (the ragged path).
SP_SHORT = (("sp-cyd", "Why cut a long prompt over ranks? "),
            ("sp-cyd", "What does each shard of a ring hand on? "))
SP_PAGE_KEY = "chip_smoke/sp_pages/{window}/{rank}"
SP_RING_KEY = "chip_smoke/sp_ring/{rank}"


def _sp_ecfg(spec):
    """A serve-sp window's engine: 8 slots, 640 pages of 32 (two 8K
    prompts and their replies fit), 272 pages a sequence, token budget
    512, buckets 32/64/128/256 (a long prompt pads to a multiple of
    256), k_steps 8, sp shards."""
    from ollamamq_tpu_torch.config import EngineConfig

    return EngineConfig(model=spec["model"], max_slots=8, num_pages=SP_PAGES,
                        page_size=SP_PS, max_pages_per_seq=SP_MP,
                        max_batch_tokens=512, token_granule=16,
                        prefill_buckets=PP_BUCKETS, max_new_tokens=SP_NEW,
                        decode_steps_per_iter=8, dtype=spec["dtype"],
                        sp=spec.get("sp", 1), seed=0)


def _window_ecfg(spec):
    return (_sp_ecfg if spec.get("sp", 1) > 1 else _tp_ecfg)(spec)


def _sp_ids(n: int, seed: int) -> list:
    """n token ids drawn from `seed` (the seeded model's vocabulary)."""
    import numpy as np

    from ollamamq_tpu_torch.config import MODEL_CONFIGS

    rng = np.random.default_rng(seed)
    return rng.integers(3, MODEL_CONFIGS[SP_MODEL].vocab_size, size=n).tolist()


def _sp_page_digests(window: str, rank: int) -> None:
    """After every sequence-parallel prefill on this rank, hash its K and
    V pages at the prompt's real positions, every layer, and post the
    window's list under SP_PAGE_KEY: the ranks' pools must hold the same
    bytes (each wrote every chunk the ring passed it)."""
    import hashlib

    import numpy as np
    import torch

    from ollamamq_tpu_torch.engine.engine import ModelRuntime
    from ollamamq_tpu_torch.parallel import distributed

    orig = getattr(ModelRuntime._dispatch_prefill_sp, "__wrapped__",
                   ModelRuntime._dispatch_prefill_sp)
    record = []

    def hashed(self, T, tokens, lens, slot_ids, pt_rows, *rest):
        out = orig(self, T, tokens, lens, slot_ids, pt_rows, *rest)
        n, ps = int(lens[0]), self.ecfg.page_size
        t = np.arange(n)
        slots = np.asarray(pt_rows)[0][t // ps].astype(np.int64) * ps + t % ps
        idx = torch.from_numpy(slots).to(self.device)
        h = hashlib.sha256()
        for pool in (self.kc, self.vc):
            h.update(pool[:, idx].contiguous().view(torch.uint8).cpu().numpy().tobytes())
        record.append({"n": n, "T": int(T), "sha256": h.hexdigest()})
        distributed.store().set(SP_PAGE_KEY.format(window=window, rank=rank),
                                json.dumps(record))
        return out

    hashed.__wrapped__ = orig
    ModelRuntime._dispatch_prefill_sp = hashed


def _sp_ring_flag(rank: int) -> None:
    """Post the count of this rank's ring hand-offs after each one (the
    kill window waits for the first)."""
    from ollamamq_tpu_torch.parallel import distributed
    from ollamamq_tpu_torch.parallel.mesh import SeqGroup

    rotate = SeqGroup.rotate
    n = [0]

    def flagged(self, x):
        out = rotate(self, x)
        n[0] += 1
        distributed.store().set(SP_RING_KEY.format(rank=rank), str(n[0]))
        return out

    SeqGroup.rotate = flagged


def _sp_pages_of(window: str, ranks) -> dict:
    """Every rank's posted page digests of `window`, {rank: [...]}."""
    from ollamamq_tpu_torch.parallel import distributed

    client = distributed.store()
    out = {}
    for r in ranks:
        key = SP_PAGE_KEY.format(window=window, rank=r)
        out[r] = json.loads(client.get(key)) if client.check([key]) else []
    return out


def _sp_decode_checked(calls: list):
    """Wrap llama.paged_decode_attention_any so that each kernel call is
    held against the plain version on the same q and pools (relative
    error, the longest context); returns the original."""
    from ollamamq_tpu_torch.models import llama

    orig = llama.paged_decode_attention_any

    def checked(impl, *args):
        out = orig(impl, *args)
        if impl == "kernel":
            ref = orig("plain", *args)
            scale = float(ref.float().abs().max())
            err = float((out.float() - ref.float()).abs().max())
            calls.append((err, scale, bool(out.isfinite().all()), int(args[4].max())))
        return out

    llama.paged_decode_attention_any = checked
    return orig


def _sp_leader_bf16(spec, mesh, profile):
    """sp 2 in bf16: two 8,000-id prompts (/api/generate `context`) and
    two short chats from 3 users at once, 32 new tokens each; then the
    TTFT of one more 8K prompt at sp 2 and, in the same process, on one
    rank (the ragged path's spans)."""
    import torch

    from ollamamq_tpu_torch.engine.engine import TorchEngine
    from ollamamq_tpu_torch.engine.spmd import SPMDEngine
    from ollamamq_tpu_torch.models import llama
    from ollamamq_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from ollamamq_tpu_torch.ops.sampling import SamplingParams
    from ollamamq_tpu_torch.server.app import serve_in_thread, stop_server

    model, ecfg = spec["model"], _sp_ecfg(spec)
    t0 = time.monotonic()
    eng = SPMDEngine(ecfg, mesh=mesh, blocklist_path=None)
    torch.cuda.synchronize()
    init_s = time.monotonic() - t0
    rt = eng.runtimes[model]
    srv = serve_in_thread(eng, port=0, timeout_s=600)
    port = srv.server_address[1]
    greedy = {"temperature": 0, "num_predict": SP_NEW}
    bodies = [("sp-ada", "/api/generate",
               {"model": model, "prompt": "", "options": greedy,
                "context": _sp_ids(SP_LONG, 1)}),
              ("sp-bob", "/api/generate",
               {"model": model, "prompt": "", "options": greedy,
                "context": _sp_ids(SP_LONG, 2)})]
    bodies += [(u, "/api/chat", {"model": model, "options": greedy,
                                 "messages": [{"role": "user", "content": text * 2}]})
               for u, text in SP_SHORT]
    results, errors = {}, []

    def run(i, user, path, body):
        try:
            results[i] = _ollama_result(*_post(port, path, body, user))
        except Exception as e:  # noqa: BLE001 — reported, then fails the phase
            errors.append(f"{user}/{i}: {e}")

    calls = []
    orig_dec = _sp_decode_checked(calls)
    ring0 = dict(mesh.seq.stats)
    before = rt.stats()
    reset_launch_counts()
    t0 = time.monotonic()
    threads = [threading.Thread(target=run, args=(i, *b)) for i, b in enumerate(bodies)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
    finally:
        llama.paged_decode_attention_any = orig_dec
    burst_s = time.monotonic() - t0
    counts = launch_counts()
    after = rt.stats()
    ring = {k: mesh.seq.stats[k] - ring0[k] for k in ring0}
    peak = torch.cuda.max_memory_allocated()
    if errors or len(results) != len(bodies):
        raise SystemExit(f"serve-sp requests failed: {errors}")
    ops = {"ragged": after["ragged_dispatches"] - before["ragged_dispatches"],
           "spec": 0, "decode_steps": after["decode_steps"] - before["decode_steps"]}
    exact, own = _tp_exact(counts, ops, rt.cfg.num_layers, "")
    tokens = after["tokens_generated"] - before["tokens_generated"]

    def ttft(e, ids):
        req = e.enqueue_request("sp-ttft", "", model, prompt_tokens=ids,
                                sampling=SamplingParams(max_tokens=1, temperature=0.0))
        it = _tp_wait(req)
        return req.stats.ttft_ms if it is not None and it.kind == "done" else None

    ttft_sp = ttft(eng, _sp_ids(SP_LONG, 3))
    stop_server(srv)
    eng.stop()
    pages = _sp_pages_of("sp-bf16", range(mesh.size))
    one = TorchEngine(dataclasses.replace(ecfg, sp=1), device=mesh.device,
                      blocklist_path=None)
    one.start()
    ttft(one, _sp_ids(SP_LONG, 4))  # warm-up: the same path at the same length
    ttft_one = ttft(one, _sp_ids(SP_LONG, 3))
    one_stats = one.runtimes[model].stats()
    one.stop()
    del one
    checked = {"calls": len(calls),
               "calls_over_8k": sum(1 for c in calls if c[3] >= SP_LONG),
               "max_rel_err": max((e / s for e, s, _, _ in calls), default=None),
               "tol": f"max |kernel - plain| <= {TOL['bfloat16']} * max |plain|",
               "ok": bool(calls) and all(fin and e <= TOL["bfloat16"] * s
                                         for e, s, fin, _ in calls)}
    # The burst runs the plain decode after every kernel call on rank 0
    # (_sp_decode_checked): its rate is not the serving rate.
    return {"init_s": init_s, "burst_s": burst_s, "tokens": tokens,
            "tokens_per_s_with_call_checks": tokens / burst_s,
            "replies": {str(i): {"tokens": len(ids), "done_reason": why}
                        for i, (ids, why) in results.items()},
            "sp_prefills": after["sp_prefill_dispatches"] - before["sp_prefill_dispatches"],
            "ragged_dispatches": ops["ragged"], "decode_steps": ops["decode_steps"],
            "launches": counts, "launches_expected": own, "kernels_exact": exact,
            "decode_per_call": checked, "ring": ring,
            "ttft_ms": {"sp2": ttft_sp, "one_rank_ragged": ttft_one,
                        "one_rank_ragged_dispatches": one_stats["ragged_dispatches"]},
            "max_memory_allocated": peak, "pages": pages,
            "param_bytes": rt.param_bytes, "kv_bytes": rt.kv_bytes,
            "trace": eng.spmd_report(), "workers": eng.worker_reports}


def _sp_leader_f32(spec, mesh, profile):
    """float32 identity: one ~5,000-id prompt with 32 greedy tokens at sp
    (x tp), then on one rank of the same seed (the ragged path's spans):
    ids identical, the sp prefill's logits within 1e-4 x max of the
    logits the one rank's last span gave the same position."""
    import torch

    from ollamamq_tpu_torch.engine.engine import TorchEngine
    from ollamamq_tpu_torch.engine.spmd import SPMDEngine
    from ollamamq_tpu_torch.models import llama
    from ollamamq_tpu_torch.ops.cuda import launch_counts
    from ollamamq_tpu_torch.ops.sampling import SamplingParams

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model, ecfg = spec["model"], _sp_ecfg(spec)
    prompt = _sp_ids(SP_F32_LONG, 5)
    capture = {}

    def run(eng, fwd, key):
        orig = getattr(llama, fwd)

        def wrapped(*a, **kw):
            out = orig(*a, **kw)
            capture[key] = out[0][0].float().cpu()  # row 0: the only request
            return out

        setattr(llama, fwd, wrapped)
        try:
            req = eng.enqueue_request("sp-f32", "", model, prompt_tokens=prompt,
                                      sampling=SamplingParams(max_tokens=SP_NEW,
                                                              temperature=0.0))
            eng.start()
            item = _tp_wait(req)
        finally:
            setattr(llama, fwd, orig)
        eng.stop()
        return list(req.generated_ids), item is not None and item.kind == "done"

    sp_eng = SPMDEngine(ecfg, mesh=mesh, blocklist_path=None)
    ids_sp, ok_sp = run(sp_eng, "forward_prefill_sp", "sp")
    sp_prefills = sp_eng.runtimes[model].sp_prefill_dispatches
    counts = launch_counts()
    workers = sp_eng.worker_reports
    del sp_eng
    gc.collect()
    torch.cuda.empty_cache()
    one = TorchEngine(dataclasses.replace(ecfg, sp=1), device=mesh.device,
                      blocklist_path=None)
    # The one rank's last ragged call before decoding holds the prompt's
    # last span: its row 0 is the first token's logits.
    ids_one, ok_one = run(one, "forward_ragged", "one")
    del one
    a, b = capture["sp"], capture["one"]
    scale = float(b.abs().max())
    err = float((a - b).abs().max())
    return {"ids_sp": ids_sp, "ids_one": ids_one, "done": ok_sp and ok_one,
            "ids_identical": ids_sp == ids_one and len(ids_sp) > 0,
            "sp_prefills": sp_prefills, "prompt_tokens": len(prompt),
            "first_logits": {"max_abs_err": err, "ref_max_abs": scale,
                             "rel_err": err / scale,
                             "tol": f"max |sp - one rank| <= {TOL['float32']} * "
                                    "max |one rank|",
                             "ok": err <= TOL["float32"] * scale},
            "launches": counts, "workers": workers}


def _sp_leader_kill(spec, mesh, profile):
    """kill -9 of rank 1 in the middle of an 8K prompt's ring while two
    short streams decode: every request must end with an error within
    the heartbeat bound, and /health keep answering (runtime failed,
    worker_stale firing)."""
    import urllib.request

    from ollamamq_tpu_torch.engine.spmd import SPMDEngine
    from ollamamq_tpu_torch.ops.sampling import SamplingParams
    from ollamamq_tpu_torch.parallel import distributed
    from ollamamq_tpu_torch.server.app import serve_in_thread, stop_server

    model, ecfg = spec["model"], _sp_ecfg(spec)
    eng = SPMDEngine(ecfg, mesh=mesh, blocklist_path=None)
    srv = serve_in_thread(eng, port=0, timeout_s=600)
    tok = eng.runtimes[model].tokenizer
    greedy = dict(temperature=0.0)
    reqs = [eng.enqueue_request(f"kill-{i}", "", model,
                                prompt_tokens=tok.encode(text * 2),
                                sampling=SamplingParams(max_tokens=400, **greedy))
            for i, (_, text) in enumerate(SP_SHORT)]
    deadline = time.monotonic() + 300
    while (min(len(r.generated_ids) for r in reqs) < 16
           and time.monotonic() < deadline):
        time.sleep(0.005)
    in_flight = [len(r.generated_ids) for r in reqs]
    client = distributed.store()
    reqs.append(eng.enqueue_request("kill-long", "", model,
                                    prompt_tokens=_sp_ids(SP_LONG, 6),
                                    sampling=SamplingParams(max_tokens=SP_NEW, **greedy)))
    client.wait([SP_RING_KEY.format(rank=1)], datetime.timedelta(seconds=120))
    os.kill(int(client.get("chip_smoke/pid/1")), signal.SIGKILL)
    t_kill = time.monotonic()
    items, ends = [], []
    for r in reqs:
        items.append(_tp_wait(r, budget=120))
        ends.append(time.monotonic() - t_kill)
    time.sleep(3.5)  # past the heartbeat's staleness
    eng.health.check_once()
    with urllib.request.urlopen(f"http://127.0.0.1:{srv.server_address[1]}/health",
                                timeout=30) as resp:
        status, health = resp.status, json.loads(resp.read())
    stop_server(srv)
    return {"tokens_at_kill": in_flight,
            "kinds": [it.kind if it else "timeout" for it in items],
            "errors": [(it.error or "")[:160] if it else "" for it in items],
            "seconds_to_error": ends, "bound_s": TP_KILL_BOUND_S,
            "health_http": status, "health_status": health["status"],
            "alerts": [a["name"] for a in health["alerts"]],
            "runtime_failed": [r["failed"] for r in health["runtimes"]]}


SP_WINDOWS = {"sp-bf16": _sp_leader_bf16, "sp-f32": _sp_leader_f32,
              "sp-tp-f32": _sp_leader_f32, "sp-kill": _sp_leader_kill}


def serve_sp_phase(report) -> None:
    """Sequence parallelism: llama3.2:1b at full width and depth over two
    sequence shards sharing the card (gloo): 8K prompts through the ring
    prefill in bf16, float32 identity with one rank at sp 2 and at sp 2 x
    tp 2, and a kill -9 mid-ring; see the module docstring."""
    import torch

    t_phase = time.monotonic()
    gc.collect()
    torch.cuda.empty_cache()
    refusal = subprocess.run(
        [sys.executable, "-m", "ollamamq_tpu_torch.cli", "--model", SP_MODEL,
         "--sp", "2", "--kv-dtype", "int8", "--no-tui"],
        cwd=os.path.dirname(os.path.abspath(__file__)),
        capture_output=True, text=True, timeout=120)
    refusal_text = refusal.stdout + refusal.stderr
    base = {"device": TP_DEVICE, "model": SP_MODEL, "sp": 2, "tp": 1}
    t_world = time.monotonic()
    # One world of two ranks serves three windows, the kill last.
    windows, rcs, _ = _tp_world("sp", [
        ("sp-bf16", {**base, "dtype": "bfloat16"}),
        ("sp-f32", {**base, "dtype": "float32"}),
        ("sp-kill", {**base, "dtype": "bfloat16"})])
    world_s = time.monotonic() - t_world
    t_wide = time.monotonic()
    wide, rcs_wide, _ = _tp_world("sp_tp", [
        ("sp-tp-f32", {**base, "tp": 2, "dtype": "float32"})])
    wide_s = time.monotonic() - t_wide
    bf16, f32, kill, f32tp = (windows["sp-bf16"], windows["sp-f32"],
                              windows["sp-kill"], wide["sp-tp-f32"])
    (w_bf16,), (w_f32,) = bf16["workers"], f32["workers"]
    layers = 16
    w_exact, w_own = _tp_exact(w_bf16["launches"], w_bf16["ops"], layers, "")
    pages = {int(k): v for k, v in bf16["pages"].items()}  # JSON keys: str
    launches = {k: 0 for k in KERNEL_ROWS}
    for counts in ([bf16["launches"], w_bf16["launches"], f32["launches"],
                    w_f32["launches"], f32tp["launches"]]
                   + [w["launches"] for w in f32tp["workers"]]):
        for k, v in counts.items():
            launches[k] += v
    w_ring = w_bf16["runtimes"][SP_MODEL]["seq"]

    def per_prefill(ring):
        n = max(1, ring["prefills"])
        return {"prefills": ring["prefills"], "handoffs": ring["handoffs"],
                "bytes_per_prefill": ring["bytes"] / n,
                "handoff_ms_per_prefill": 1e3 * (ring["send_s"] + ring["recv_s"]
                                                 + ring["staging_s"]) / n,
                "staging_ms_per_prefill": 1e3 * ring["staging_s"] / n,
                "recv_ms_per_prefill": 1e3 * ring["recv_s"] / n,
                "prefill_ms": 1e3 * ring["prefill_s"] / n}

    line = {"phase": "serve-sp", "model": SP_MODEL, "sp": 2, "backend": "gloo",
            "ranks_on": "cuda:0 (both)", "layers": layers,
            "width": {"hidden": 2048, "heads": 32, "kv_heads": 8, "head_dim": 64,
                      "intermediate": 8192, "vocab": 128256},
            "dtype": "bfloat16", "long_prompt_ids": SP_LONG, "padded_T": 8192,
            "chunk_C": 4096, "streams": 4, "users": 3,
            **{k: bf16[k] for k in ("init_s", "burst_s", "tokens",
                                    "tokens_per_s_with_call_checks",
                                    "replies", "sp_prefills", "ragged_dispatches",
                                    "decode_steps", "launches_expected",
                                    "kernels_exact", "decode_per_call", "ttft_ms",
                                    "param_bytes", "kv_bytes")},
            "ring": {"rank0": per_prefill(bf16["ring"]), "rank1": per_prefill(w_ring)},
            "max_memory_allocated": {"rank0": bf16["max_memory_allocated"],
                                     "rank1": w_bf16.get("max_memory_allocated")},
            "ops": {"rank0": bf16["trace"]["ops"], "rank1": w_bf16["ops"]},
            "digests_equal": bf16["trace"]["digest"] == w_bf16["digest"],
            "launches_rank0_burst": bf16["launches"],
            "launches_rank1": w_bf16["launches"], "kernels_exact_rank1": w_exact,
            "page_digests": pages,
            "f32": {k: f32[k] for k in ("ids_identical", "first_logits", "done",
                                        "sp_prefills", "prompt_tokens")},
            "f32_tp2": {k: f32tp[k] for k in ("ids_identical", "first_logits",
                                              "done", "sp_prefills")},
            "f32_launches": {"rank0": f32["launches"], "rank1": w_f32["launches"]},
            "f32_tp2_ops": [w["ops"] for w in f32tp["workers"]],
            "kill": kill, "cli_sp2_int8_exit": refusal.returncode,
            "cli_sp2_int8_message": next((ln.split(": ", 1)[-1]
                                          for ln in refusal_text.splitlines()
                                          if "sequence-parallel" in ln),
                                         refusal_text[-300:]),
            "return_codes": {"sp": rcs, "sp_tp": rcs_wide}, "launches": launches,
            "worlds": {"sp": "one, 2 ranks", "sp_tp": "one, 4 ranks"},
            "world_s": {"sp": world_s, "sp_tp": wide_s},
            "windows_s": {w: r["window_s"] for w, r in {**windows, **wide}.items()}}
    line["phase_s"] = time.monotonic() - t_phase
    emit(line)
    report["serve_sp"] = line
    rank_pages = [[p["sha256"] for p in pages.get(r, [])] for r in (0, 1)]
    gates = {
        "replies": all(r["done_reason"] in ("stop", "length")
                       for r in line["replies"].values()),
        "sp_prefills": (bf16["sp_prefills"] == 2
                        and w_bf16["ops"]["sp_prefill"]
                        == bf16["trace"]["ops"]["sp_prefill"] == 3),
        "short_prompts_ragged": bf16["ragged_dispatches"] > 0
                                and w_bf16["ops"]["ragged"] > 0,
        "kernels_exact": bf16["kernels_exact"] and w_exact,
        "ranks_ids_equal": line["digests_equal"],
        "pages_bit_equal": (len(rank_pages[0]) == 3 and rank_pages[0] == rank_pages[1]
                            and sum(1 for p in pages.get(0, []) if p["n"] >= SP_LONG) == 3),
        "decode_per_call": bf16["decode_per_call"]["ok"]
                           and bf16["decode_per_call"]["calls_over_8k"] > 0,
        "f32_ids_identical": f32["done"] and f32["ids_identical"]
                             and f32["sp_prefills"] == 1,
        "f32_first_logits": f32["first_logits"]["ok"],
        "f32_decode_kernel_both_ranks": (f32["launches"]["paged_decode_attention"] > 0
                                         and w_f32["launches"]["paged_decode_attention"] > 0),
        "f32_tp2_ids_identical": f32tp["done"] and f32tp["ids_identical"]
                                 and f32tp["sp_prefills"] == 1,
        "f32_tp2_first_logits": f32tp["first_logits"]["ok"],
        "cli_sp2_int8_exit_2": (refusal.returncode == 2
                                and "sequence-parallel" in refusal_text),
        "kill_errors": kill["kinds"] == ["error"] * 3,
        "kill_within_bound": max(kill["seconds_to_error"]) <= TP_KILL_BOUND_S,
        "kill_health": (kill["health_http"] == 200 and "worker_stale" in kill["alerts"]
                        and kill["runtime_failed"] == [True]),
        "exit_codes": rcs == [0, -9] and rcs_wide == [0, 0, 0, 0],
    }
    emit({"phase": "serve-sp-gates", **gates})
    if not all(gates.values()):
        raise SystemExit(f"serve-sp: gates failed: {gates}")


# -- serve-ep: expert parallelism over two ranks --------------------------------
# The bf16 window's model: 8 of 32 layers, so that the whole script
# stays well inside its time limit on a slow host.
EP_MODEL = "mixtral:8x7b-8l"
EP_LAYERS = 8
EP_F32_MODEL = "mixtral:8x7b-2l"  # 2 of 32 layers: the f32 and kill windows
EP_PARAM_BYTES = 12_470_329_344  # each ep-2 rank's bf16 slice of EP_MODEL
EP_ROUTE_KEY = "chip_smoke/ep_route/{window}/{rank}"
EP_RANK_KEY = "chip_smoke/ep_rank/{window}/{rank}"
EP_GO_KEY = "chip_smoke/ep_go/{window}"


def _model_cuts() -> None:
    """Register the cut configs in this process's config table
    (idempotent): mixtral:8x7b at 16 layers (MOE_MODEL), 8 (EP_MODEL)
    and 2 (EP_F32_MODEL), llama3:8b at 16 (TP_MODEL). A rank of a
    serve-tp or serve-ep world builds them by name."""
    from ollamamq_tpu_torch.config import MODEL_CONFIGS

    for base, name, layers in (("mixtral:8x7b", MOE_MODEL, MOE_LAYERS),
                               ("mixtral:8x7b", EP_MODEL, EP_LAYERS),
                               ("mixtral:8x7b", EP_F32_MODEL, 2),
                               ("llama3:8b", TP_MODEL, TP_LAYERS)):
        MODEL_CONFIGS.setdefault(name, dataclasses.replace(
            MODEL_CONFIGS[base], name=name, num_layers=layers))


def _ep_param_bytes(cfg, layers: int, ep: int, tp: int, nbytes: int) -> int:
    """One (expert, tensor) rank's weight bytes from the config's shapes:
    its E / ep experts' F / tp slices, its heads' attention and V / tp
    vocabulary rows of the untied embedding and head; the router and the
    norms whole."""
    D, E = cfg.hidden_size, cfg.num_experts
    attn = 2 * D * cfg.q_dim // tp + 2 * D * cfg.kv_dim // tp
    experts = 3 * (E // ep) * D * (cfg.intermediate_size // tp)
    per_layer = attn + experts + D * E + 2 * D
    vocab = 2 * -(-cfg.vocab_size // tp) * D
    return (layers * per_layer + vocab + D) * nbytes


def _ep_route_digests(window: str, rank: int):
    """Hash layer 0's capacity-slot tensor (models/moe.py route: which
    (token, k-slot) won which place in which expert's queue, and which
    were dropped) at every forward on this rank, and post the running
    sha256 and count under EP_ROUTE_KEY: the expert ranks must route
    alike. Layer 0 is the router of the window's first route call.
    Returns the function that unhooks it."""
    import hashlib

    from ollamamq_tpu_torch.models import moe
    from ollamamq_tpu_torch.parallel import distributed

    orig = moe.route
    h, state = hashlib.sha256(), {"ptr": None, "n": 0}
    key = EP_ROUTE_KEY.format(window=window, rank=rank)

    def hashed(cfg, lp, x, valid=None):
        out = orig(cfg, lp, x, valid)
        ptr = lp["w_router"].data_ptr()
        if state["ptr"] is None:
            state["ptr"] = ptr
        if ptr == state["ptr"]:
            h.update(out[2].contiguous().cpu().numpy().tobytes())
            state["n"] += 1
            distributed.store().set(key, json.dumps({"n": state["n"],
                                                     "sha256": h.hexdigest()}))
        return out

    moe.route = hashed

    def unhook():
        moe.route = orig

    return unhook


def _ep_capture_rows() -> list:
    """The runtimes a worker rank's run_worker builds (spmd._build_row),
    kept for the checks after it returns."""
    from ollamamq_tpu_torch.engine import spmd

    rows, build = [], spmd._build_row

    def captured(*a, **kw):
        row = build(*a, **kw)
        rows.append(row)
        return row

    captured.__wrapped__ = build
    spmd._build_row = captured
    return rows


def _pool_sha256(rt) -> str:
    import hashlib

    import torch

    h = hashlib.sha256()
    for pool in (rt.kc, rt.vc):
        h.update(pool.contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()


def _ep_decode_step(rt, mesh) -> dict:
    """This expert rank's decode step on its own experts (no collective:
    an ExpertGroup with no process group) against its own byte bound."""
    from ollamamq_tpu_torch.parallel.mesh import ExpertGroup

    local = ExpertGroup(mesh.ep, mesh.coord["expert"], None)
    return _decode_step_ms(rt, True, ep=local)


def _ep_worker_checks(window: str, rank: int, rows: list, mesh) -> None:
    """A worker rank after its run_worker of the bf16 window: the sha256
    of its whole K and V pools, then (once rank 0 has measured its own,
    EP_GO_KEY) its decode step, posted under EP_RANK_KEY."""
    from ollamamq_tpu_torch.engine import spmd
    from ollamamq_tpu_torch.parallel import distributed

    spmd._build_row = getattr(spmd._build_row, "__wrapped__", spmd._build_row)
    (rt,) = [r for row in rows for r in row.values()]
    client = distributed.store()
    out = {"pool_sha256": _pool_sha256(rt), "param_bytes": rt.param_bytes}
    client.wait([EP_GO_KEY.format(window=window)], datetime.timedelta(seconds=300))
    out["decode_step"] = _ep_decode_step(rt, mesh)
    client.set(EP_RANK_KEY.format(window=window, rank=rank), json.dumps(out))
    rows.clear()


def _ep_leader_bf16(spec, mesh, profile):
    """ep 2 in bf16: serve-moe's traffic through the HTTP server, rank
    0's FFN all_reduce over a burst of its own, then (the engine
    stopped) the pools' and routing digests of both ranks, the per-call
    kernel check on rank 0's shard and each rank's decode step."""
    import torch

    from ollamamq_tpu_torch.engine.spmd import SPMDEngine
    from ollamamq_tpu_torch.parallel import distributed
    from ollamamq_tpu_torch.parallel.mesh import ExpertGroup
    from ollamamq_tpu_torch.server.app import serve_in_thread, stop_server

    model, ecfg = spec["model"], _tp_ecfg(spec)
    t0 = time.monotonic()
    eng = SPMDEngine(ecfg, mesh=mesh, blocklist_path=None)
    torch.cuda.synchronize()
    init_s = time.monotonic() - t0
    rt = eng.runtimes[model]
    srv = serve_in_thread(eng, port=0, timeout_s=600)
    port = srv.server_address[1]
    line = _serve_moe_traffic(rt, port)
    line["ffn_allreduce"] = _tp_layer_ms(rt, port, model, group=rt.ep)
    stop_server(srv)
    peak = torch.cuda.max_memory_allocated()
    eng.stop()
    window = "ep-bf16"
    client = distributed.store()
    ranks = range(mesh.size)
    routes = {}
    for r in ranks:
        key = EP_ROUTE_KEY.format(window=window, rank=r)
        routes[r] = json.loads(client.get(key)) if client.check([key]) else None
    calls = {}
    kernel_vs_plain_logits(calls, "serve-ep", rt, MOE_TEXT * 2, "bfloat16",
                           per_call=True, ep=ExpertGroup(mesh.ep, 0, None))
    step = {0: _ep_decode_step(rt, mesh)}
    pools = {0: _pool_sha256(rt)}
    rank_bytes = {0: rt.param_bytes}
    client.set(EP_GO_KEY.format(window=window), "1")
    for r in ranks[1:]:
        key = EP_RANK_KEY.format(window=window, rank=r)
        client.wait([key], datetime.timedelta(seconds=300))
        got = json.loads(client.get(key))
        step[r], pools[r] = got["decode_step"], got["pool_sha256"]
        rank_bytes[r] = got["param_bytes"]
    line.update(init_s=init_s, param_bytes=rt.param_bytes, kv_bytes=rt.kv_bytes,
                max_memory_allocated=peak, n_chips=rt.n_chips,
                experts=list(rt.ep.expert_range(rt.cfg.num_experts)),
                routes=routes, pools=pools, decode_step=step,
                rank_param_bytes=rank_bytes,
                per_call=calls["serve_ep_logits"], trace=eng.spmd_report(),
                workers=eng.worker_reports)
    return line


EP_WINDOWS = {"ep-bf16": _ep_leader_bf16, "ep-f32": _tp_leader_f32,
              "ep-tp-f32": _tp_leader_f32, "ep-kill": _tp_leader_kill}


def serve_ep_phase(report) -> None:
    """Expert parallelism: mixtral:8x7b at full width over two expert
    shards sharing the card (gloo): 8 layers in bf16 through the HTTP
    server, float32 identity with one rank at ep 2 and ep 2 x tp 2 (2
    layers), and a kill -9; see the module docstring."""
    import torch

    from ollamamq_tpu_torch.config import MODEL_CONFIGS

    t_phase = time.monotonic()
    gc.collect()
    torch.cuda.empty_cache()
    here = os.path.dirname(os.path.abspath(__file__))
    refusals = {name: subprocess.Popen(
        [sys.executable, "-m", "ollamamq_tpu_torch.cli", "--model", "mixtral:8x7b",
         *flags, "--no-tui"], cwd=here, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
        for name, flags in (("ep3", ["--ep", "3"]),
                            ("ep2_pp2", ["--ep", "2", "--pp", "2"]),
                            ("ep2_int8", ["--ep", "2", "--weights-dtype", "int8"]))}
    base = {"device": TP_DEVICE, "ep": 2, "tp": 1}
    t_world = time.monotonic()
    # One world of two ranks serves three windows, the kill last.
    windows, rcs, _ = _tp_world("ep", [
        ("ep-bf16", {**base, "model": EP_MODEL, "dtype": "bfloat16",
                     "ep_checks": True}),
        ("ep-f32", {**base, "model": EP_F32_MODEL, "dtype": "float32"}),
        ("ep-kill", {**base, "model": EP_F32_MODEL, "dtype": "bfloat16"})])
    world_s = time.monotonic() - t_world
    t_wide = time.monotonic()
    wide, rcs_wide, _ = _tp_world("ep_tp", [
        ("ep-tp-f32", {**base, "tp": 2, "model": EP_F32_MODEL,
                       "dtype": "float32"})])
    wide_s = time.monotonic() - t_wide
    bf16, f32, kill, f32tp = (windows["ep-bf16"], windows["ep-f32"],
                              windows["ep-kill"], wide["ep-tp-f32"])
    (w_bf16,), (w_f32,) = bf16["workers"], f32["workers"]
    layers = EP_LAYERS
    w_exact, w_own = _tp_exact(w_bf16["launches"], w_bf16["ops"], layers, "")
    launches = {k: 0 for k in KERNEL_ROWS}
    for counts in ([bf16["launches"], w_bf16["launches"], f32["launches"],
                    w_f32["launches"], f32tp["launches"]]
                   + [w["launches"] for w in f32tp["workers"]]):
        for k, v in counts.items():
            launches[k] += v
    full = MODEL_CONFIGS["mixtral:8x7b"]
    bytes_ep2 = _ep_param_bytes(full, layers, 2, 1, 2)
    bytes_f32_ep2_tp2 = _ep_param_bytes(full, 2, 2, 2, 4)
    outs = {}
    for name, proc in refusals.items():
        out, _ = proc.communicate(timeout=120)
        outs[name] = {"exit": proc.returncode,
                      "message": next((ln.split(": ", 1)[-1]
                                       for ln in out.splitlines()
                                       if "ep=" in ln or "MoE" in ln), out[-300:])}
    routes = {int(k): v for k, v in bf16["routes"].items()}  # JSON keys: str
    pools = {int(k): v for k, v in bf16["pools"].items()}
    step = {int(k): v for k, v in bf16["decode_step"].items()}
    rank_bytes = {int(k): v for k, v in bf16["rank_param_bytes"].items()}
    fa = bf16["ffn_allreduce"]
    line = {"phase": "serve-ep", "model": EP_MODEL, "ep": 2, "backend": "gloo",
            "ranks_on": "cuda:0 (both)", "layers": layers,
            "reduced": {"num_layers": [32, layers]},
            "width": {"hidden": full.hidden_size,
                      "intermediate": full.intermediate_size,
                      "heads": full.num_heads, "kv_heads": full.num_kv_heads,
                      "head_dim": full.head_dim, "experts": full.num_experts,
                      "top_k": full.num_experts_per_tok, "vocab": full.vocab_size},
            "experts_rank0": bf16["experts"], "dtype": "bfloat16",
            "streams": len(MOE_STREAMS), "users": 3,
            **{k: bf16[k] for k in ("init_s", "serve_s", "burst_s", "tokens",
                                    "burst_tokens", "burst_tokens_per_s",
                                    "ttft_ms", "replies", "greedy_repeat_identical",
                                    "ragged_dispatches", "decode_steps",
                                    "launches_expected", "kernels_exact",
                                    "param_bytes", "kv_bytes", "n_chips")},
            "param_bytes_expected": bytes_ep2, "rank_param_bytes": rank_bytes,
            "ffn_allreduce": {**fa, "share_of_forward": (fa["allreduce_ms_per_forward"]
                                                         / max(1e-9, fa["wall_ms_per_forward"]))},
            "decode_step": step,
            "max_memory_allocated": {"rank0": bf16["max_memory_allocated"],
                                     "rank1": w_bf16.get("max_memory_allocated")},
            "ops": {"rank0": bf16["trace"]["ops"], "rank1": w_bf16["ops"]},
            "digests_equal": bf16["trace"]["digest"] == w_bf16["digest"],
            "routes": routes, "pools": pools,
            "per_call": bf16["per_call"],
            "launches_rank0_burst": bf16["launches"],
            "launches_rank1": w_bf16["launches"], "kernels_exact_rank1": w_exact,
            "f32": {k: f32[k] for k in ("ids_identical", "first_forward", "done",
                                        "param_bytes")},
            "f32_tp2": {k: f32tp[k] for k in ("ids_identical", "first_forward",
                                              "done", "param_bytes")},
            "f32_tp2_param_bytes_expected": bytes_f32_ep2_tp2,
            "f32_launches": {"rank0": f32["launches"], "rank1": w_f32["launches"]},
            "kill": kill, "cli_refusals": outs,
            "return_codes": {"ep": rcs, "ep_tp": rcs_wide}, "launches": launches,
            "worlds": {"ep": "one, 2 ranks", "ep_tp": "one, 4 ranks"},
            "world_s": {"ep": world_s, "ep_tp": wide_s},
            "windows_s": {w: r["window_s"] for w, r in {**windows, **wide}.items()}}
    line["phase_s"] = time.monotonic() - t_phase
    emit(line)
    report["serve_ep"] = line
    gates = {
        "replies": all(r["done_reason"] in ("stop", "length")
                       for r in line["replies"].values()),
        "greedy_repeat_identical": bf16["greedy_repeat_identical"],
        "ranks_ids_equal": line["digests_equal"],
        "routing_equal": (routes.get(0) is not None and routes[0]["n"] > 0
                          and routes[0] == routes.get(1)),
        "kernels_exact": bf16["kernels_exact"] and w_exact,
        "param_bytes": (EP_PARAM_BYTES == bytes_ep2
                        and rank_bytes == {0: bytes_ep2, 1: bytes_ep2}),
        "pools_equal": pools.get(0) is not None and pools[0] == pools.get(1),
        "per_call": all(c["ok"] for k, c in bf16["per_call"].items()
                        if k.endswith("_per_call")),
        "f32_ids_identical": f32["done"] and f32["ids_identical"],
        "f32_first_logits": f32["first_forward"]["ok"],
        "f32_tp2_ids_identical": f32tp["done"] and f32tp["ids_identical"],
        "f32_tp2_first_logits": f32tp["first_forward"]["ok"],
        "f32_tp2_param_bytes": f32tp["param_bytes"] == bytes_f32_ep2_tp2,
        "f32_kernels_both_ranks": all(
            c["ragged_paged_attention"] > 0 and c["paged_decode_attention"] > 0
            for c in (f32["launches"], w_f32["launches"])),
        "cli_refusals_exit_2": (
            all(o["exit"] == 2 for o in outs.values())
            and "ep=3 must divide num_experts=8" in outs["ep3"]["message"]
            and "pp with an MoE model" in outs["ep2_pp2"]["message"]
            and "does not cover MoE expert stacks" in outs["ep2_int8"]["message"]),
        "kill_errors": kill["kinds"] == ["error"] * 4,
        "kill_within_bound": max(kill["seconds_to_error"]) <= TP_KILL_BOUND_S,
        "kill_health": (kill["health_http"] == 200 and "worker_stale" in kill["alerts"]
                        and kill["runtime_failed"] == [True]),
        "exit_codes": rcs == [0, -9] and rcs_wide == [0, 0, 0, 0],
    }
    emit({"phase": "serve-ep-gates", **gates})
    if not all(gates.values()):
        raise SystemExit(f"serve-ep: gates failed: {gates}")


def guardrail_phase(report) -> None:
    """quant_guardrail of the int8 llama3.2:1b tree against its bf16
    source (seeded random weights) at full width on the card. The bound on
    random weights is unknown: printed, not gated."""
    import torch

    from ollamamq_tpu_torch.config import get_model_config
    from ollamamq_tpu_torch.models import weights

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.monotonic()
    out = weights.quant_guardrail(get_model_config("llama3.2:1b"), seed=0,
                                  dtype=torch.bfloat16, device="cuda")
    line = {"phase": "quant-guardrail", "model": "llama3.2:1b", "gated": False,
            "seconds": time.monotonic() - t0, **out}
    emit(line)
    report["quant_guardrail"] = line
    if not all(math.isfinite(out[k]) for k in ("max_logit_err", "rel_logit_err")):
        raise SystemExit(f"guardrail logits are not finite: {line}")


def profile_window(port, model, text, rt):
    """torch.profiler over one more 4-user burst: device time by kernel
    name, the device-busy share of the window's wall time, and the
    engine dispatches the window ran. The same greedy burst runs twice on
    the warm engine: unprofiled for its wall time (the profiler slows the
    host several-fold), then profiled for device time, so the busy share
    is the profiled device time over the unprofiled wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    body = {"model": model, "prompt": text, "stream": False,
            "options": {"temperature": 0, "num_predict": 48}}
    keys = ("ragged_dispatches", "decode_dispatches", "decode_steps", "tokens_generated")

    def burst():
        errors = []

        def one(user):
            try:
                _post(port, "/api/generate", body, user)
            except Exception as e:  # noqa: BLE001 — reported, then fails the window
                errors.append(f"{user}: {e}")

        before = rt.stats()
        t0 = time.monotonic()
        threads = [threading.Thread(target=one, args=(f"p{i}",)) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        torch.cuda.synchronize()
        after = rt.stats()
        if errors or any(t.is_alive() for t in threads):
            raise SystemExit(f"profile burst failed: {errors}")
        return (time.monotonic() - t0) * 1e3, {k: after[k] - before[k] for k in keys}

    wall_ms, counts = burst()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        profiled_wall_ms, profiled_counts = burst()
    rows = []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "cuda_time_total", 0)
        if dev_us and ev.device_type == torch.autograd.DeviceType.CUDA:
            rows.append((dev_us, ev.key, ev.count))
    rows.sort(reverse=True)
    total_us = sum(r[0] for r in rows)
    os.makedirs(OUT_DIR, exist_ok=True)
    trace = os.path.join(OUT_DIR, f"serve_trace_{rt.weights_dtype}.json")
    prof.export_chrome_trace(trace)
    with open(trace, "rb") as src, gzip.open(trace + ".gz", "wb") as dst:
        shutil.copyfileobj(src, dst)
    os.remove(trace)
    groups = {"attention kernels": ("paged_decode_", "ragged_paged_kernel"),
              "gemm": ("gemm", "nvjet", "sm90_xmma", "cutlass"),
              "copy / cast": ("copy",)}
    by_group = {g: 0.0 for g in (*groups, "other")}
    for us, key, _n in rows:
        g = next((g for g, pats in groups.items() if any(p in key for p in pats)), "other")
        by_group[g] += us / 1e3
    # The serving path's own attention kernels must show up by name (a
    # renamed kernel would otherwise be counted under "other").
    expected = {"decode_steps": ("paged_decode_split_kernel", "paged_decode_combine_kernel"),
                "ragged_dispatches": ("ragged_paged_kernel_tc",)}
    attention = {name: {"ms": sum(us for us, k, _ in rows if name in k) / 1e3,
                        "calls": sum(n for _, k, n in rows if name in k)}
                 for names in expected.values() for name in names}
    missing = [name for key, names in expected.items() if profiled_counts[key] > 0
               for name in names if attention[name]["calls"] == 0]
    if missing:
        raise SystemExit(f"profile: the window ran {profiled_counts} but found no "
                         f"device time of {missing}")
    # A forward is one decode step or one ragged dispatch. Arrival timing
    # may split the two bursts' prefills differently, so each burst is
    # divided by its own count.
    wall_fwd = wall_ms / (counts["decode_steps"] + counts["ragged_dispatches"])
    dev_fwd = total_us / 1e3 / (profiled_counts["decode_steps"]
                                + profiled_counts["ragged_dispatches"])
    return {"wall_ms": wall_ms, **counts, "profiled_wall_ms": profiled_wall_ms,
            "profiled_counts": profiled_counts,
            "device_kernel_ms": total_us / 1e3,
            "wall_ms_per_forward": wall_fwd,
            "device_ms_per_forward": dev_fwd,
            "device_busy_share": dev_fwd / wall_fwd,
            "device_ms_by_group": by_group,
            "attention_kernels": attention,
            "top": [{"name": k[:90], "ms": us / 1e3, "calls": n}
                    for us, k, n in rows[:15]]}


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


# Every phase, in the order a run takes them (each takes the report and
# --profile); `--only NAME` runs one. serve runs its bf16 pass and then
# its int8 pass, which reads the bf16 one.
PHASES = {
    "kernels": lambda r, p: (decode_plan_phase(r), kernel_phase(r)),
    "serve": lambda r, p: (serve_phase(r, p), serve_phase(r, p, int8=True)),
    "guardrail": lambda r, p: guardrail_phase(r),
    "serve-moe": lambda r, p: serve_moe_phase(r, p),
    "serve-runtime": lambda r, p: serve_runtime_phase(r),
    "serve-runtime-f32": lambda r, p: serve_runtime_f32_phase(r),
    "serve-sched": lambda r, p: serve_sched_phase(r),
    "serve-models": lambda r, p: serve_models_phase(r),
    "serve-durable": lambda r, p: serve_durable_phase(r),
    "serve-fleet": lambda r, p: serve_fleet_phase(r),
    "serve-tiers": lambda r, p: serve_tiers_phase(r),
    "serve-autoscale": lambda r, p: serve_autoscale_phase(r),
    "serve-ha": lambda r, p: serve_ha_phase(r),
    "serve-tp": lambda r, p: serve_tp_phase(r, p),
    "serve-pp": lambda r, p: serve_pp_phase(r, p),
    "serve-dp": lambda r, p: serve_dp_phase(r),
    "serve-sp": lambda r, p: serve_sp_phase(r),
    "serve-ep": lambda r, p: serve_ep_phase(r),
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="also profile a serving burst of each serve phase "
                         "(chiprun_out/chip_smoke/)")
    ap.add_argument("--only", default="", choices=("", *PHASES),
                    help="build the kernels and run this one phase (a "
                         "partial run: no kernels line and no closing "
                         "ok line)")
    # One rank of a serve-tp/pp/dp world (the phases start these).
    ap.add_argument("--tp-rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--tp-port", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--tp-plan", default="[]", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "ollamamq_tpu_torch", "csrc")):
        print("chip_smoke: run it from a checkout of the repository",
              file=sys.stderr)
        return 2
    if args.tp_rank is not None:
        return tp_rank_main(args)
    from ollamamq_tpu_torch.ops.cuda import build

    report = {"torch": torch.__version__, "cuda": torch.version.cuda,
              "device": torch.cuda.get_device_name(0), "kernels": [],
              "decode_plan": []}
    t0 = time.monotonic()
    built = build.build()
    for name in build.KERNELS:  # every entry point loads from its library
        build.kernel_fn(name)
    bytecode = share_bytecode(here)
    line = {"phase": "build", "seconds": time.monotonic() - t0,
            "bytecode": bytecode, "entry_points": list(build.KERNELS),
            "sources": {src: {"seconds": b["seconds"], "cached": b["cached"],
                              "entry_points": b["entry_points"],
                              "ptxas": [ln.strip() for ln in b["log"].splitlines()
                                        if "registers" in ln]}
                        for src, b in built.items()}}
    emit(line)
    report["build"] = line
    phase_s = {}
    for name in [args.only] if args.only else PHASES:
        t = time.monotonic()
        PHASES[name](report, args.profile)
        phase_s[name] = time.monotonic() - t
    # Where the run's time went, phase by phase (the contract bounds the
    # whole script, the build included).
    report["phase_seconds"] = phase_s
    emit({"phase": "timings", "seconds": phase_s,
          "since_build_start_s": time.monotonic() - t0})
    if args.only:
        print(card_line(), flush=True)
        print(f"chip_smoke: ran phase {args.only} only; the full run "
              "prints the kernels line and the closing ok line", flush=True)
        return 0

    card = card_line()
    s = report["kernel_summary"]
    kernels = []
    for name, (source, replaces, serve) in KERNEL_ROWS.items():
        m = s[name]["llama3.2:1b"]
        row = {"name": name, "route": "cuda", "source": source,
               "replaces": replaces,
               "launches": (report[serve]["launches"][name]
                            + sum(report[p]["launches"][name]
                                  for p in ("serve_moe", "serve_durable",
                                            "serve_fleet", "serve_tiers",
                                            "serve_autoscale", "serve_ha",
                                            "serve_tp", "serve_pp",
                                            "serve_dp", "serve_sp",
                                            "serve_ep"))),
               "launches_serve_tp": report["serve_tp"]["launches"][name],
               "launches_serve_pp": report["serve_pp"]["launches"][name],
               "launches_serve_dp": report["serve_dp"]["launches"][name],
               "launches_serve_sp": report["serve_sp"]["launches"][name],
               "launches_serve_ep": report["serve_ep"]["launches"][name],
               "max_abs_err": m["max_abs_err"], "ms": m["kernel_ms"],
               "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
               "bound_by": m["bound_by"], "library_ms": m["sdpa_dense_ms"]}
        if name.endswith("_int8"):
            row["variant"] = "quantized=True"
        if name == "paged_decode_attention":
            # The call inside a pipeline stage (parallel/pipeline.py):
            # one microbatch of serve-pp's llama3:8b decode.
            pp = s[name]["llama3:8b-pp2"]
            row["pp_stage"] = {
                "replaces": "ollamamq_tpu/parallel/pipeline.py:343 (call :382)",
                "shape": "H 32, Hk 8, hd 128, B 4, page 32, 24 pages",
                **{k: pp[k] for k in ("max_abs_err", "bound_ms", "bound_by",
                                      "plain_ms")},
                "ms": pp["kernel_ms"], "library_ms": pp["sdpa_dense_ms"]}
        kernels.append(row)
    report["card"] = card
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "report.json"), "w") as f:
        json.dump(report, f, indent=1)
    print(card, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
