#!/usr/bin/env python3
"""Run chip_smoke.py's `serve` (bf16) and `serve-runtime` phases of the
checkout under --root and print one JSON line of their tokens/s. It
compares the serving path of two checkouts of the port on one card:

    git archive <parent> | tar -x -C _archive/parent
    git archive $(git write-tree) | tar -x -C _archive/change
    for r in parent change change parent parent change change parent; do
        python3 ollamamq_tpu_torch/tools/serve_ab.py --root _archive/$r; done

Run it by path, not with -m: the package it runs is the one under
--root, imported after --root is put first on sys.path.
Each run builds that checkout's kernels and runs both phases with their
own gates (a failed gate exits non-zero). The line carries the cold
serve window's tokens/s and ragged dispatches and serve-runtime's
tokens/s and forwards (ragged dispatches plus decode steps). Needs a GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", required=True,
                    help="checkout whose chip_smoke.py and package are run")
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    os.chdir(root)
    sys.path.insert(0, root)
    import chip_smoke
    from ollamamq_tpu_torch.ops.cuda import build

    build.build()
    report = {}
    chip_smoke.serve_phase(report, False)
    chip_smoke.serve_runtime_phase(report)
    s, r = report["serve"], report["serve_runtime"]
    print(json.dumps({"root": args.root, "serve_tps": s["tokens_per_s"],
                      "serve_ragged": s["ragged_dispatches"],
                      "runtime_tps": r["tokens_per_s"],
                      "runtime_forwards": r["ragged_dispatches"] + r["decode_steps"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
