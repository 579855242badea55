"""Command-line entry point: serve one model over HTTP.

    python -m ollamamq_tpu_torch.cli --model llama3.2:1b --port 11434
    python -m ollamamq_tpu_torch.cli --model test-tiny --device cpu
    python -m ollamamq_tpu_torch.cli --weights-dtype int8 --kv-dtype int8

Runs on the CUDA device unless --device cpu is given, and refuses to
start when no CUDA device is found. Weights are seeded random (--seed).
"""

from __future__ import annotations

import argparse
import logging

from ollamamq_tpu_torch.config import QUANT_DTYPES, EngineConfig


def build_parser() -> argparse.ArgumentParser:
    d = EngineConfig()
    p = argparse.ArgumentParser(prog="ollamamq_tpu_torch.cli", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model", default="llama3.2:1b")
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
    p.add_argument("--max-new-tokens", type=int, default=d.max_new_tokens)
    p.add_argument("--seed", type=int, default=d.seed)
    p.add_argument("--blocklist", default=None, help="blocklist JSON path")
    p.add_argument("--timeout-s", type=float, default=300.0)
    p.add_argument("--log-level", default="INFO")
    return p


def engine_config(args) -> EngineConfig:
    return EngineConfig(
        model=args.model, max_slots=args.max_slots, num_pages=args.num_pages,
        page_size=args.page_size, max_pages_per_seq=args.max_pages_per_seq,
        max_batch_tokens=args.max_batch_tokens, token_granule=args.token_granule,
        decode_steps_per_iter=args.decode_steps,
        max_new_tokens=args.max_new_tokens, dtype=args.dtype,
        weights_dtype=args.weights_dtype, kv_dtype=args.kv_dtype, seed=args.seed)


def main(argv=None) -> None:
    # An unknown --weights-dtype / --kv-dtype fails here, in argparse,
    # before any device work.
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=args.log_level.upper(),
                        format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    from ollamamq_tpu_torch.engine.engine import TorchEngine
    from ollamamq_tpu_torch.server.app import OllamaServer

    engine = TorchEngine(engine_config(args), device=args.device,
                         blocklist_path=args.blocklist)
    engine.start()
    server = OllamaServer(engine, args.host, args.port, args.timeout_s)
    logging.getLogger("ollamamq.torch").info(
        "serving %s on %s:%d (device %s)", args.model, args.host,
        server.server_address[1], engine.device)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        engine.stop()


if __name__ == "__main__":
    main()
