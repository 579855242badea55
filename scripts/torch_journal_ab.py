#!/usr/bin/env python3
"""What the decision journal costs the serving path, on one GPU.

    python3 scripts/torch_journal_ab.py --rounds 6

Runs chip_smoke.py's serve-runtime phase (llama3.2:1b at full width,
bf16, seeded: prefix cache, speculation k 4, preemption on a 44-page
pool, one injected ragged fault; its journal is the busiest of the
script's phases) once per variant per round, the variants in a rotated
order each round after one warm-up run:

  journal     as served: every record site writes to the ring;
  nojournal   Journal.record a no-op: the record sites' own cost.

Each run prints one JSON line with the phase's tokens/s and journal
record count; the last line gives each variant's median and its
quartiles beside the card's name and power limit. The variant patches
the port's Journal class in this process only. Needs a GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

VARIANTS = ("journal", "nojournal")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=6)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("torch_journal_ab: no CUDA device visible", file=sys.stderr)
        return 2
    import chip_smoke as c
    from ollamamq_tpu_torch.ops.cuda import build
    from ollamamq_tpu_torch.telemetry.journal import Journal

    build.build()
    real = Journal.record
    c.serve_runtime_phase({})  # warm-up
    rows = {v: [] for v in VARIANTS}
    for r in range(args.rounds):
        order = VARIANTS[r % 2:] + VARIANTS[:r % 2]
        for v in order:
            if v == "nojournal":
                Journal.record = lambda self, kind, *a, **k: {}
            report = {}
            try:
                c.serve_runtime_phase(report)
            finally:
                Journal.record = real
            line = report["serve_runtime"]
            row = {"variant": v, "round": r, "tokens_per_s": line["tokens_per_s"],
                   "serve_s": line["serve_s"], "journal_records": line["journal_records"]}
            rows[v].append(row)
            print(json.dumps(row), flush=True)

    def spread(xs):
        q = statistics.quantiles(xs, n=4)
        return {"median": statistics.median(xs), "q1": q[0], "q3": q[2]}

    print(json.dumps({"card": c.card_line(), "rounds": args.rounds,
                      "tokens_per_s": {v: spread([x["tokens_per_s"] for x in rs])
                                       for v, rs in rows.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
