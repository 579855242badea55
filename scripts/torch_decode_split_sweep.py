#!/usr/bin/env python3
"""Time the bf16-q paged decode kernel (csrc/paged_decode_attention.cu)
at other values of its SPLIT (context positions per block) and STAGES
(ring depth of each warp), on one GPU:

    python3 scripts/torch_decode_split_sweep.py --splits 128 256 512 --stages 2 3

For each pair of values the script copies csrc/ to a temporary
directory, sets `constexpr int SPLIT` and `constexpr int STAGES` there,
builds that copy with the package's nvcc flags, points the wrapper's
launch plan at the same values, checks every call against the plain
version (atol = rtol = 2e-2) and prints one JSON line per (split,
stages, shape, pool) with kernel_ms (50 calls replayed from one
CUDA graph, as chip_smoke.py times them), the split count and the split
blocks that have work, at chip_smoke.py's timed decode shapes and at two
shapes where the split matters most (one llama3.2:1b sequence of 512
tokens alone; four llama3:8b sequences of 2,048 to 4,096 tokens), over
a bf16 and an int8 pool. The package's own source and plan are not
changed. Needs a GPU.
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import re
import shutil
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--splits", type=int, nargs="+", default=[64, 128, 256, 512])
    ap.add_argument("--stages", type=int, nargs="+", default=[2])
    ap.add_argument("--iters", type=int, default=50)
    args = ap.parse_args(argv)
    sys.path.insert(0, HERE)
    import torch

    if not torch.cuda.is_available():
        print("torch_decode_split_sweep: no CUDA device visible", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from ollamamq_tpu_torch.ops.cuda import build
    from ollamamq_tpu_torch.ops.cuda import paged_attention as pa

    card = cs.card_line()
    src = "paged_decode_attention.cu"
    orig_csrc = build.CSRC
    with tempfile.TemporaryDirectory() as tmp:
        for split, stages in itertools.product(args.splits, args.stages):
            if split % pa.KV_TILE:
                raise SystemExit(f"split {split} is not a multiple of {pa.KV_TILE}")
            variant = os.path.join(tmp, f"split{split}-stages{stages}")
            csrc = os.path.join(variant, "csrc")
            shutil.copytree(orig_csrc, csrc)
            path = os.path.join(csrc, src)
            with open(path) as f:
                text = f.read()
            for name, value in (("SPLIT", split), ("STAGES", stages)):
                text, n = re.subn(rf"constexpr int {name} = \d+;",
                                  f"constexpr int {name} = {value};", text)
                if n != 1:
                    raise SystemExit(f"{src}: no single `constexpr int {name}` to set")
            with open(path, "w") as f:
                f.write(text)
            build.CSRC = csrc
            os.environ["OLLAMAMQ_TORCH_BUILD_DIR"] = os.path.join(variant, "build")
            build._fns.clear()
            build._libs.clear()
            pa.SPLIT, pa.STAGES = split, stages
            for int8 in (False, True):
                d = dict(dtype=torch.bfloat16, int8=int8)
                cases = [c for kind, c in cs.timed_cases(torch.bfloat16, int8)
                         if kind == "decode"] + [
                    cs.decode_case("llama3.2:1b-alone512", 40, 1, 32, 8, 64, 32, 16, [512], **d),
                    cs.decode_case("llama3:8b-long4k", 41, 4, 32, 8, 128, 32, 128,
                                   [4096, 3000, 2048, 3500], **d)]
                for c in cases:
                    kern, plain = cs._decode_calls(c)
                    out, ref = kern(), plain()
                    torch.cuda.synchronize()
                    ok = bool(torch.isfinite(out).all()) and torch.allclose(
                        out.float(), ref.float(), rtol=2e-2, atol=2e-2)
                    line = {"split": split, "stages": stages, "case": c["name"],
                            "pool": "int8" if int8 else "bfloat16", "dtype": "bfloat16",
                            "ok": ok, "kernel_ms": cs.graph_ms(kern, args.iters),
                            **cs.decode_blocks(c), "card": card}
                    print(json.dumps(line), flush=True)
                    if not ok:
                        raise SystemExit(f"kernel disagrees with its plain version: {line}")
                    del out, ref
    return 0


if __name__ == "__main__":
    sys.exit(main())
