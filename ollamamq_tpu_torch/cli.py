"""Command-line entry point: serve one or several models over HTTP.

    python -m ollamamq_tpu_torch.cli --model llama3.2:1b --port 11434
    python -m ollamamq_tpu_torch.cli --model test-tiny --device cpu
    python -m ollamamq_tpu_torch.cli --models llama3.2:1b,nomic-embed-text \
        --checkpoints llama3.2:1b=/path/to/hf-dir
    python -m ollamamq_tpu_torch.cli --weights-dtype int8 --kv-dtype int8
    python -m ollamamq_tpu_torch.cli --prefix-cache --spec --spec-k 4
    python -m ollamamq_tpu_torch.cli --scheduler srpt --token-fairness \
        --max-queued 64 --max-queued-per-user 8 --slo-ttft-ms 500

Runs on the CUDA device unless --device cpu is given, and refuses to
start when no CUDA device is found. Weights are seeded random (--seed)
unless --checkpoints names an HF safetensors directory for a model (its
tokenizer.json, when present, replaces the byte-level tokenizer). More
models load and unload at run time through /api/pull and /api/delete.
The admin TUI owns the terminal when stdout is a TTY (--no-tui: never);
quitting it ends the process.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys

from ollamamq_tpu_torch.config import (QUANT_DTYPES, EngineConfig,
                                       get_model_config, validate_scheduler)


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
                        "directory per model; the others use seeded weights")
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
    p.add_argument("--max-new-tokens", type=int, default=d.max_new_tokens)
    p.add_argument("--seed", type=int, default=d.seed)
    p.add_argument("--blocklist", default="blocked_items.json",
                   help="blocklist persistence path")
    p.add_argument("--no-tui", action="store_true", help="disable the admin TUI")
    p.add_argument("--timeout-s", type=float, default=300.0)
    p.add_argument("--log-level", default="INFO")
    return p


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


def validate(args) -> str:
    """The flags' errors, checked before any device work ("" = valid)."""
    for name in model_table(args):
        if get_model_config(name) is None:
            return f"unknown model architecture: {name}"
    err = validate_scheduler(args.scheduler)
    if err:
        return err
    if not 0.0 < args.slo_target < 1.0:
        return f"--slo-target must be in (0, 1), got {args.slo_target}"
    if args.max_queued < 0 or args.max_queued_per_user < 0 or args.preempt_max < 0:
        return "--max-queued / --max-queued-per-user / --preempt-max must be >= 0"
    if args.trace_ring < 1:
        return "--trace-ring must be >= 1"
    return ""


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
        slo_target=args.slo_target, trace_ring=args.trace_ring)


def main(argv=None) -> int:
    # An unknown --weights-dtype / --kv-dtype fails in argparse, and the
    # other invalid values in validate(), before any device work.
    args = build_parser().parse_args(argv)
    use_tui = not args.no_tui and sys.stdout.isatty()
    logging.basicConfig(level=args.log_level.upper(),
                        filename="ollamamq.log" if use_tui else None,
                        format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    log = logging.getLogger("ollamamq.torch")
    err = validate(args)
    if err:
        log.error("%s", err)
        return 2
    import threading

    from ollamamq_tpu_torch.core.mqcore import Fairness
    from ollamamq_tpu_torch.engine.engine import TorchEngine
    from ollamamq_tpu_torch.server.app import OllamaServer

    engine = TorchEngine(engine_config(args), device=args.device,
                         blocklist_path=args.blocklist,
                         fairness=Fairness.TOKENS if args.token_fairness
                         else Fairness.REQUESTS, models=model_table(args))
    engine.start()
    server = OllamaServer(engine, args.host, args.port, args.timeout_s)
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
