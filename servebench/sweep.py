"""Find a traffic mix's knee on the card: one process, one server, a few
offered rates in turn.

    python3 servebench/sweep.py --config qwen3-8b --traffic qwen3-rag \\
        --rates 3 4 5 6 --seconds 30 --seed 7

Each rate scales every stream of the traffic file by one factor so that
they offer that many requests a second together, and runs one open-loop
window of the cell's kind. Between windows the open connections are shut
and the engine drains. For each rate it prints one JSON line: offered
and completed requests a second, output tokens a second, TTFT p50/p95,
and the backlog (requests queued or prefilling, sampled every 0.25 s)
with its growth over the window's second half. The knee is the highest
rate whose backlog does not grow over the window. Never part of a
benchmark run.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

from servebench import cell as cellrun  # noqa: E402
from servebench import readings, spec, stats, traffic  # noqa: E402
from servebench.system import System  # noqa: E402


def backlog(system) -> int:
    rt = system.rt
    return (system.engine.core.total_queued() + len(rt.pending_prefill)
            + len(rt.chunking))


def slope(points) -> float:
    """Least-squares growth (requests per second) of (t, n) points."""
    if len(points) < 2:
        return 0.0
    mt = sum(t for t, _ in points) / len(points)
    mn = sum(n for _, n in points) / len(points)
    var = sum((t - mt) ** 2 for t, _ in points)
    return sum((t - mt) * (n - mn) for t, n in points) / var if var else 0.0


def one_rate(system, tr: dict, chat: dict, rate: float, seconds: float,
             seed: int) -> dict:
    total = sum(st["rate_rps"] for st in tr["streams"])
    scaled = dict(tr, streams=[dict(st, rate_rps=st["rate_rps"] * rate / total)
                               for st in tr["streams"]])
    sched = traffic.schedule(scaled, chat, seed, seconds)
    job = {"port": system.port, "model": system.name, "sampling": tr["sampling"],
           "timeout_s": seconds + 600,
           "requests": [{k: r[k] for k in ("i", "due", "user", "text", "max_tokens")}
                        for r in sched]}
    t0 = time.monotonic() + 0.5
    t1 = t0 + seconds
    samples, stop = [], threading.Event()

    def sample():
        while not stop.wait(0.25):
            samples.append((time.monotonic() - t0, backlog(system)))

    th = threading.Thread(target=sample, daemon=True)
    th.start()
    proc = cellrun._loadgen(dict(job, t0=t0, t_close=t1))
    out, err = proc.communicate(timeout=seconds + 300)
    stop.set()
    th.join()
    gen = json.loads(out)
    reqs = cellrun._merge(sched, gen["results"], t0)
    run = cellrun.Run(seconds=seconds, t0=t0, t1=t1, requests=reqs)
    done = sum(1 for q in reqs if q["done"] and q.get("t_done", t1 + 1) <= t1)
    late = [n for t, n in samples if t >= seconds / 2]
    ttft = readings.ttft_ms(run, reqs)
    while backlog(system) or system.rt.active_count():
        time.sleep(0.25)
    return {"rate_rps": rate, "offered_rps": len(sched) / seconds,
            "completed_rps": done / seconds,
            "output_tps": stats.rate_in_window(
                (f for q in reqs for f in q["frames"]), t0, t1),
            "ttft_p50_ms": stats.percentile(ttft, 50), "ttft_p95_ms": stats.percentile(ttft, 95),
            "backlog_end": samples[-1][1] if samples else None,
            "backlog_max": max((n for _, n in samples), default=None),
            "backlog_growth_rps": slope([(t, n) for t, n in samples if t >= seconds / 2]),
            "backlog_second_half_mean": sum(late) / len(late) if late else None,
            "failed": sum(1 for q in reqs if q["error"]), "late": gen["late"]}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--traffic", required=True)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args()
    bench = spec.benchmark()
    entry = {c["name"]: c for c in bench["configs"]}[args.config]
    conf = spec.load_json(os.path.join(spec.ROOT, entry["file"]))
    a = spec.arch(conf)
    tr = spec.load_json(os.path.join(HERE, "traffic", args.traffic + ".json"))
    system = System(args.config, conf, a, args.seed, "cuda:0")
    try:
        print(json.dumps({"warm_up": system.warm_up(tr["streams"], tr["sampling"])}),
              flush=True)
        for rate in args.rates:
            print(json.dumps(one_rate(system, tr, conf["chat"], rate, args.seconds,
                                      args.seed)), flush=True)
    finally:
        system.close()


if __name__ == "__main__":
    main()
