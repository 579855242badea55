"""Run one cell of the benchmark and print its result as the last line.

    python3 servebench/run.py --workload NAME --seed N --seconds S --trace 0|1

NAME is a workload of BENCHMARK.json. The run makes its weights and its
traffic from the seed, sets up and warms up the port's server on one
card, sends the cell's open-loop traffic for S seconds from a load
generator on a CPU of its own (the server keeps the others), checks a sample
of the finished requests against the plain reference, and prints one
JSON object: correct, attempted, failed, metrics (the cell's end-to-end
metrics, or with --trace 1 its per-layer metrics), device, with --trace 1
a breakdown, and last the numbers compared beside their limits (also the
last lines on standard error). It exits 2, printing no result, without
as many CUDA devices as the cell asks for, and 3 if JAX or the JAX
package was imported.
"""

from __future__ import annotations

import os
import time

T_ENTER = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CACHE = os.path.join(HERE, "_cache")

# The card's machine sets PYTHONDONTWRITEBYTECODE and its torch ships no
# bytecode: without a cache every run compiles torch's Python again. The
# cache lives at a fixed path inside the checkout.
sys.dont_write_bytecode = False
sys.pycache_prefix = os.path.join(CACHE, "pycache")
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = os.path.join(CACHE, sub)
os.environ["PYTHONPYCACHEPREFIX"] = sys.pycache_prefix
os.environ.setdefault("USE_FLAX", "0")
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

FORBIDDEN = ("jax", "jaxlib", "flax", "ollamamq_tpu")


def process_start() -> float:
    """This process's start on the monotonic clock: its age from
    /proc/self/stat, else the first line of this file."""
    try:
        with open("/proc/self/stat", encoding="ascii") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        age = (time.clock_gettime(time.CLOCK_BOOTTIME)
               - start_ticks / os.sysconf("SC_CLK_TCK"))
        return min(T_ENTER, time.monotonic() - age)
    except (OSError, ValueError, IndexError):
        return T_ENTER


def forbidden_modules() -> list:
    return sorted({m.split(".", 1)[0] for m in sys.modules} & set(FORBIDDEN))


def err(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def main(argv=None) -> int:
    t_process = process_start()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from servebench import loadgen, spec

    # The server and the load generator on CPUs of their own, set before
    # any thread starts, so that every thread of the server inherits it.
    server_cpus, gen_cpus = loadgen.split_cpus(list(os.sched_getaffinity(0)))
    os.sched_setaffinity(0, server_cpus)

    cell = spec.Cell(args.workload, spec.benchmark())
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        err(f"needs {cell.chips} CUDA device(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    from servebench import cell as cellrun

    result = cellrun.run(cell, args.seed, args.seconds, bool(args.trace), "cuda:0",
                         t_process, cell.limits,
                         log=lambda s: print(s, flush=True), gen_cpus=gen_cpus)
    bad = forbidden_modules()
    if bad:
        err(f"forbidden modules imported: {bad}")
        return 3
    err(f"correct {result['correct']}")
    for k, v in result["compared"].items():
        err(f"compared {k} {v['value']!r} limit {v['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
