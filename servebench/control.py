"""The control of the served-token check: what the comparison reads when
the same work is computed one precision below the configuration's bf16.

    python3 servebench/control.py --workload NAME --seconds S --seeds N ...

- A dense configuration (qwen3-8b): the port's own int8 path serves the
  cell's traffic in the program's place and the cell's own check
  (cell.compare) judges it: --precision int8 quantizes the seeded bf16
  weights per channel (--weights-dtype int8) over an int8 KV pool
  (--kv-dtype int8), --precision int8w the weights alone over the bf16
  pool.
- An MoE configuration (mixtral-8x7b-16l), which the port refuses to
  serve with int8 weights: the cell runs as it is, then the reference
  with float8 (e4m3) weights (reference.py, quant="fp8"; the step an FP8
  expert path on Hopper would take) reads the same prompts and served
  tokens, and at each position the gap of the token it puts first is
  read under the float32 reference. The int8 reference's reading is
  printed beside it. No cell of BENCHMARK.json serves an MoE
  configuration yet: PERF.md says why, and what such a cell's check
  needs first.

Each seed prints the program's numbers and the control's. A control
whose numbers do not fail the cell's limits shows the check is too loose
to tell bf16 from int8. Never part of a benchmark run; tests of the
control's code at a tiny size are in tests/test_servebench_check.py.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

from servebench import cell as cellrun  # noqa: E402
from servebench import check, spec  # noqa: E402


def low_reference(cell, seed, sample, ref, device, quant: str) -> dict:
    """The `quant` reference's own greedy picks, read under `ref`."""
    low = check.reference_logits(cell.arch, seed, sample, cell.conf["chat"], device,
                                 quant=quant)
    picks = [lg.argmax(dim=-1) for lg in low]
    return check.gap_numbers(check.served_gaps(ref, None, picks))


def reference_controls(cell, seed, sample, ref, device) -> dict:
    return {q: low_reference(cell, seed, sample, ref, device, q) for q in ("fp8", "int8")}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--precision", choices=("int8", "int8w"), default="int8",
                    help="a dense configuration's control (default int8)")
    args = ap.parse_args()
    cell = spec.Cell(args.workload, spec.benchmark())
    moe = bool(cell.arch["E"])
    for seed in args.seeds:
        t = time.monotonic()
        res = cellrun.run(cell, seed, args.seconds, False, "cuda:0", t, cell.limits,
                          precision="bfloat16" if moe else args.precision,
                          log=lambda s: print(s, flush=True),
                          control=reference_controls if moe else None)
        print(json.dumps({"seed": seed, "control": "reference-fp8" if moe
                          else "program-" + args.precision, "correct": res["correct"],
                          "compared": res["compared"], "metrics": res["metrics"],
                          "seconds": time.monotonic() - t}), flush=True)


if __name__ == "__main__":
    main()
