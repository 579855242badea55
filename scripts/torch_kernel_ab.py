#!/usr/bin/env python3
"""Time the PyTorch/CUDA port's attention kernels (ragged and decode), q
in bf16 over both pool formats, at chip_smoke.py's timed shapes, using the
ollamamq_tpu_torch package found under --root. It compares two
checkouts of the port on one card:

    git archive <parent> | tar -x -C _archive/parent
    for r in _archive/parent . . _archive/parent; do
        python3 scripts/torch_kernel_ab.py --root $r; done

Each run builds that checkout's kernels, checks each call against the
plain version (atol = rtol = 2e-2), and prints one JSON line per (kernel,
shape, pool) with kernel_ms (50 calls replayed from one CUDA graph),
kernel_eager_ms (50 eager calls) and, for decode, kernel_cold_l2_ms (the
L2 flushed before each replayed call), timed as chip_smoke.py times them.
The cases come from this checkout's chip_smoke.py, so both checkouts see
the same inputs. Needs a GPU.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", required=True,
                    help="checkout whose ollamamq_tpu_torch package is timed")
    ap.add_argument("--iters", type=int, default=50)
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("torch_kernel_ab: no CUDA device visible", file=sys.stderr)
        return 2
    spec = importlib.util.spec_from_file_location("chip_smoke_cases",
                                                  os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import ollamamq_tpu_torch

    pkg = os.path.dirname(os.path.abspath(ollamamq_tpu_torch.__file__))
    if os.path.dirname(pkg) != root:
        raise SystemExit(f"imported {pkg}, not the package under {root}")
    card = cs.card_line()
    for int8 in (False, True):
        for kind, c in cs.timed_cases(torch.bfloat16, int8):
            kern, plain = (cs._decode_calls if kind == "decode" else cs._ragged_calls)(c)
            out, ref = kern(), plain()
            torch.cuda.synchronize()
            ok = bool(torch.isfinite(out).all()) and torch.allclose(
                out.float(), ref.float(), rtol=2e-2, atol=2e-2)
            line = {"root": args.root, "package": pkg, "kernel": kind, "case": c["name"],
                    "pool": "int8" if int8 else "bfloat16", "dtype": "bfloat16",
                    "ok": ok, "kernel_ms": cs.graph_ms(kern, args.iters),
                    "kernel_eager_ms": cs.cuda_ms(kern, args.iters), "card": card}
            if kind == "decode":
                line["kernel_cold_l2_ms"] = cs.cold_l2_ms(kern, 20)
            print(json.dumps(line), flush=True)
            if not ok:
                raise SystemExit(f"kernel disagrees with its plain version: {line}")
            del out, ref
    return 0


if __name__ == "__main__":
    sys.exit(main())
