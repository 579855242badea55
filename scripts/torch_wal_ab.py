#!/usr/bin/env python3
"""Where the admission WAL's serving cost comes from, on one GPU.

    python3 scripts/torch_wal_ab.py --rounds 3

Serves chip_smoke.py's serve-durable traffic (llama3.2:1b at full width,
bf16, seeded; 4 users, one greedy 96-token request each, at once) through
the port's in-process HTTP server, once per variant per round, the
variants in a rotated order each round after one warm-up run:

  off       no WAL;
  wal       --wal-dir as served (2 ms group commit; the flusher sleeps
            until a record is buffered);
  poll      the WAL with the JAX package's flusher loop, which wakes
            every 2 ms whether or not anything was buffered: the cost of
            those wake-ups;
  nofsync   the WAL with os.fsync a no-op (writes still reach the page
            cache): the cost of the fsync system call itself;
  notap     the WAL with no stream tap: admissions are logged and
            fsynced, tokens are not (the per-token work of the engine
            thread);
  drain     the WAL with the JAX package's recovery drainer, a thread
            that wakes every 20 ms for the process's whole life even
            with no recovered stream to drain (the port starts it only
            while recovered streams lack a client): the cost of those
            wake-ups.

Each run prints one JSON line: tokens/s, the 8-step decode chunk's and
the ragged step's host phases (step profiler p50, ms) and TTFT p50.
The last line gives each variant's medians beside the card's name and
power limit. The variants patch the port's classes in this process
only; nothing of the serving code changes. Needs a GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

VARIANTS = ("off", "wal", "poll", "nofsync", "notap", "drain")


def _patched(variant):
    """(apply, undo) for a variant's patch of the port's WAL classes."""
    from ollamamq_tpu_torch.durability import manager, wal

    saved = {}

    def apply():
        if variant == "nofsync":
            saved["fsync"] = wal.os.fsync
            wal.os.fsync = lambda fd: None
        elif variant == "notap":
            saved["tap"] = manager.DurabilityManager._install_tap
            manager.DurabilityManager._install_tap = lambda self, req, entry, rid: None
        elif variant == "poll":
            saved["loop"] = wal.RequestWAL._flush_loop

            def poll_loop(self):
                period = max(0.001, self.fsync_ms / 1e3)
                while not self._stop.is_set():
                    with self._cond:
                        if not self._buf:
                            self._cond.wait(timeout=period)
                    self._flush()
                    if self._stop.wait(period):
                        return

            wal.RequestWAL._flush_loop = poll_loop
        elif variant == "drain":
            saved["drainer"] = manager.DurabilityManager._ensure_drainer
            saved["drain_loop"] = manager.DurabilityManager._drain_loop

            def ensure(self):
                if self._drainer is None or not self._drainer.is_alive():
                    self._stop.clear()
                    self._drainer = manager.threading.Thread(
                        target=self._drain_loop, name="wal-drainer", daemon=True)
                    self._drainer.start()

            def always(self):
                while not self._stop.wait(0.02):
                    with self._orphan_lock:
                        items = list(self._orphans.items())
                    for rid, req in items:
                        while req.stream.get_nowait() is not None:
                            pass

            manager.DurabilityManager._ensure_drainer = ensure
            manager.DurabilityManager._drain_loop = always

    def undo():
        if "fsync" in saved:
            wal.os.fsync = saved["fsync"]
        if "tap" in saved:
            manager.DurabilityManager._install_tap = saved["tap"]
        if "loop" in saved:
            wal.RequestWAL._flush_loop = saved["loop"]
        if "drainer" in saved:
            manager.DurabilityManager._ensure_drainer = saved["drainer"]
            manager.DurabilityManager._drain_loop = saved["drain_loop"]

    return apply, undo


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--variants", default=",".join(VARIANTS))
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("torch_wal_ab: no CUDA device visible", file=sys.stderr)
        return 2
    import chip_smoke as c

    variants = [v for v in args.variants.split(",") if v]
    tmp = tempfile.mkdtemp(prefix="wal-ab-")
    _, _, _, params = c._serve_in_process(c._durable_config("bfloat16"))
    rows = {v: [] for v in variants}
    for r in range(args.rounds):
        order = variants[r % len(variants):] + variants[:r % len(variants)]
        for v in order:
            wal_dir = None if v == "off" else os.path.join(tmp, f"{v}-{r}")
            apply, undo = _patched(v)
            apply()
            try:
                replies, secs, st, params = c._serve_in_process(
                    c._durable_config("bfloat16", wal_dir), params)
            finally:
                undo()
            tokens = sum(len(x[0]) for x in replies.values())
            row = {"variant": v, "round": r, "tokens_per_s": tokens / secs,
                   "seconds": secs, "ttft_p50_ms": statistics.median(
                       x[3] for x in replies.values()),
                   "decode_step_p50_ms": st["ticks"]["step_p50_ms"].get("decode"),
                   "ragged_step_p50_ms": st["ticks"]["step_p50_ms"].get("ragged"),
                   "fsyncs": st["wal"]["wal"]["fsyncs"] if st["wal"] else 0}
            rows[v].append(row)
            print(json.dumps(row), flush=True)
    summary = {v: {"tokens_per_s": statistics.median(x["tokens_per_s"] for x in rs),
                   "decode_dispatch_ms": statistics.median(
                       x["decode_step_p50_ms"]["dispatch"] for x in rs),
                   "decode_detok_ms": statistics.median(
                       x["decode_step_p50_ms"]["detok"] for x in rs),
                   "ttft_p50_ms": statistics.median(x["ttft_p50_ms"] for x in rs)}
               for v, rs in rows.items()}
    print(json.dumps({"card": c.card_line(), "rounds": args.rounds,
                      "medians": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
