"""Engine step profiler: where each dispatch's milliseconds go.

Every dispatch the engine makes (a ragged mixed batch, a decode chunk,
a speculative verify) records ONE schema'd sample into a bounded ring:
how that step's milliseconds split over `host_prep` → `dispatch` →
`collect` → `detok` (the CLOSED phase vocabulary below), under which
shape (`(mode, T_pad, k_cap)`), over how many real vs padded token
positions. The same samples feed `ollamamq_step_phase_ms{phase,mode}`
histograms, a rolling per-shape p50/p99 table, `/debug/stepprof` and the
TUI's `step p99` chip. Phase names, modes, ring sizes and `brief()` keys
are the JAX package's, so one reader serves both.

Stdlib only (no torch, no numpy).

Contracts:

  * Phases are contiguous deltas between marks of one monotonic timer,
    so a sample's phase milliseconds sum EXACTLY to its recorded step
    wall clock.
  * The ring, the per-shape table, the compile-event ring, and the HBM
    timeline are all bounded — always-on means O(1) memory forever.
  * Self-overhead is metered: every profiler entry point times itself
    (perf_counter_ns) and `overhead_fraction()` reports it against the
    profiled step time.
  * The compile ledger keeps its API (`record_compile`, the
    `compile_storm` rate), but eager PyTorch compiles nothing per shape
    (the CUDA kernels are built once, before serving), so the engine
    records no compile event and `compiles` stays 0.

Module-global `PROFILER` (same pattern as metrics.REGISTRY): the engine
feeds it; the server and TUI read it; tests call `PROFILER.reset()` for
isolation.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

from ollamamq_tpu_torch.telemetry import schema as tm

# CLOSED phase vocabulary for ollamamq_step_phase_ms{phase}, the JAX
# package's. A new timed region of the dispatch path means a new entry
# HERE first.
PHASES = (
    "host_prep",   # python-side batch composition: admission bookkeeping,
    #                token/slot array builds — ends where device work
    #                starts
    "dispatch",    # issuing the forward, sampling and ring updates (the
    #                host to device upload included): kernels are queued on
    #                the stream and return with device tensors in flight
    "collect",     # device wait + the device-to-host read-back of the
    #                sampled tokens (.cpu()) — on the split decode path
    #                this spans the dispatch's end to collect, i.e. the device
    #                compute the engine overlapped with other work
    "detok",       # host-side emit loop: sampling bookkeeping, detokenize,
    #                stream writes, per-request finish handling
)

# Step modes (the `mode` label + the first element of the shape key).
# Not a validation gate — a sample carries whatever the engine said —
# but the set the engine emits today, for readers.
MODES = ("ragged", "spec_verify", "decode", "embed", "fake")

_RING = 2048          # sample ring (like --journal-ring's default)
_SHAPE_KEYS = 64      # distinct (mode, T_pad, k_cap) keys kept
_SHAPE_WINDOW = 256   # rolling per-shape totals window
_COMPILE_RING = 256   # compile-event ring
_HBM_RING = 512       # HBM/allocator timeline ring
_RATE_WINDOW_S = 60.0  # compile-rate lookback


def _pctl(window, q: float) -> Optional[float]:
    if not window:
        return None
    s = sorted(window)
    return s[min(len(s) - 1, int(q * len(s)))]


class StepTimer:
    """One step's phase clock. `mark(phase)` charges everything since
    the previous mark to `phase`; `finish(**fields)` records the sample
    (or never call it — an abandoned timer leaves no trace, which is
    exactly what a faulted/preempted dispatch should leave). Phases may
    be marked more than once (chunked host prep); deltas accumulate."""

    __slots__ = ("_prof", "mode", "_t0", "_last", "phases", "_done")

    def __init__(self, prof: "StepProfiler", mode: str):
        self._prof = prof
        self.mode = mode
        self._t0 = time.perf_counter()
        self._last = self._t0
        self.phases: Dict[str, float] = {}
        self._done = False

    def mark(self, phase: str) -> None:
        t = time.perf_counter()
        self.phases[phase] = self.phases.get(phase, 0.0) + (t - self._last) * 1e3
        self._last = t
        # Self-overhead: the mark itself (two clock reads + a dict op).
        self._prof._overhead_ns += time.perf_counter_ns() - int(t * 1e9)

    def finish(self, **fields) -> Optional[dict]:
        if self._done:  # double-finish is a bug upstream; stay silent
            return None
        self._done = True
        t = time.perf_counter()
        # The step ends at its LAST mark: total is then the exact sum of
        # the phase deltas (one contiguous chain from _t0), and the
        # microseconds between that mark and this call — argument
        # evaluation at the finish() call site — are profiler overhead,
        # not step time.
        total_ms = (self._last - self._t0) * 1e3
        sample = {
            "ts": time.time(),
            "mode": self.mode,
            "total_ms": round(total_ms, 4),
        }
        for ph in PHASES:
            sample[ph + "_ms"] = round(self.phases.get(ph, 0.0), 4)
        sample.update(fields)
        self._prof._record(sample, total_ms)
        self._prof._overhead_ns += time.perf_counter_ns() - int(t * 1e9)
        return sample


class StepProfiler:
    """Always-on bounded-ring step profiler + compile ledger + HBM
    timeline. Thread-safe: runtimes append from the engine loop while
    HTTP readers snapshot."""

    def __init__(self, ring: int = _RING):
        self._lock = threading.Lock()
        self._ring_n = ring
        self._overhead_ns = 0  # time spent inside profiler calls
        self._reset_locked()

    def _reset_locked(self) -> None:
        self.samples: deque = deque(maxlen=self._ring_n)
        self.seq = 0
        self._step_ns = 0      # profiled step wall time (denominator)
        self._overhead_ns = 0
        # (mode, T_pad, k_cap) -> deque of total_ms; insertion-ordered so
        # the oldest shape key is evicted when the table fills.
        self._shapes: Dict[Tuple, deque] = {}
        self._phase_sum: Dict[Tuple[str, str], float] = {}
        self._tokens = 0
        self._padded = 0
        self.compiles: deque = deque(maxlen=_COMPILE_RING)
        self.compile_seq = 0
        self._compile_ts: deque = deque(maxlen=_COMPILE_RING)
        self.hbm: deque = deque(maxlen=_HBM_RING)

    def reset(self) -> None:
        with self._lock:
            self._reset_locked()

    # -- step samples ------------------------------------------------------
    def start(self, mode: str) -> StepTimer:
        return StepTimer(self, mode)

    def _record(self, sample: dict, total_ms: float) -> None:
        t0 = time.perf_counter_ns()
        key = (sample["mode"], sample.get("T_pad", 0), sample.get("k_cap", 0))
        with self._lock:
            self.seq += 1
            sample["seq"] = self.seq
            self.samples.append(sample)
            self._step_ns += int(total_ms * 1e6)
            win = self._shapes.get(key)
            if win is None:
                while len(self._shapes) >= _SHAPE_KEYS:  # bounded key table
                    self._shapes.pop(next(iter(self._shapes)))
                win = self._shapes[key] = deque(maxlen=_SHAPE_WINDOW)
            win.append(total_ms)
            mode = sample["mode"]
            for ph in PHASES:
                v = sample.get(ph + "_ms", 0.0)
                if v:
                    self._phase_sum[(mode, ph)] = \
                        self._phase_sum.get((mode, ph), 0.0) + v
            self._tokens += int(sample.get("tokens", 0) or 0)
            self._padded += int(sample.get("padded_tokens", 0) or 0)
        for ph in PHASES:
            v = sample.get(ph + "_ms", 0.0)
            if v:
                tm.STEP_PHASE_MS.labels(phase=ph, mode=sample["mode"]) \
                    .observe(v)
        self._overhead_ns += time.perf_counter_ns() - t0

    # -- compile ledger ----------------------------------------------------
    def record_compile(self, site: str, key, wall_ms: float,
                       cache_size: int) -> dict:
        t0 = time.perf_counter_ns()
        ev = {
            "ts": time.time(),
            "site": site,
            "key": str(key),
            "wall_ms": round(wall_ms, 3),
            "cache_size": cache_size,
        }
        with self._lock:
            self.compile_seq += 1
            ev["seq"] = self.compile_seq
            self.compiles.append(ev)
            self._compile_ts.append(time.monotonic())
        tm.COMPILE_TOTAL.labels(site=site).inc()
        tm.COMPILE_MS.observe(wall_ms)
        self._overhead_ns += time.perf_counter_ns() - t0
        return ev

    def compile_count(self) -> int:
        with self._lock:
            return self.compile_seq

    def compile_rate_per_min(self, window_s: float = _RATE_WINDOW_S) -> float:
        """Recompiles per minute over the trailing window — the health
        monitor's compile_storm input. A full ladder warmup is a burst
        that ages out of the window; a storm doesn't."""
        now = time.monotonic()
        with self._lock:
            n = sum(1 for t in self._compile_ts if now - t <= window_s)
        return n * 60.0 / window_s if window_s > 0 else 0.0

    # -- HBM / allocator timeline ------------------------------------------
    def hbm_record(self, sample: dict) -> None:
        t0 = time.perf_counter_ns()
        sample.setdefault("ts", time.time())
        with self._lock:
            self.hbm.append(sample)
        self._overhead_ns += time.perf_counter_ns() - t0

    def hbm_tail(self, n: Optional[int] = None) -> List[dict]:
        with self._lock:
            out = list(self.hbm)
        return out[-n:] if n else out

    # -- readers -----------------------------------------------------------
    def overhead_fraction(self) -> float:
        """Profiler-internal time / profiled step wall time. The <1%
        always-on budget; 0.0 before any sample."""
        with self._lock:
            if self._step_ns <= 0:
                return 0.0
            return self._overhead_ns / self._step_ns

    def shape_table(self) -> List[dict]:
        with self._lock:
            items = [(k, list(w)) for k, w in self._shapes.items()]
        out = []
        for (mode, t_pad, k_cap), win in items:
            out.append({
                "mode": mode, "T_pad": t_pad, "k_cap": k_cap,
                "n": len(win),
                "p50_ms": round(_pctl(win, 0.50) or 0.0, 4),
                "p99_ms": round(_pctl(win, 0.99) or 0.0, 4),
            })
        out.sort(key=lambda r: -r["n"])
        return out

    def phase_summary(self) -> Dict[str, Dict[str, dict]]:
        """Per-mode, per-phase p50/p99 milliseconds over the ring."""
        with self._lock:
            ring = list(self.samples)
        by_mode: Dict[str, Dict[str, list]] = {}
        for s in ring:
            m = by_mode.setdefault(s["mode"], {ph: [] for ph in PHASES})
            for ph in PHASES:
                m[ph].append(s.get(ph + "_ms", 0.0))
        out: Dict[str, Dict[str, dict]] = {}
        for mode, per in by_mode.items():
            out[mode] = {}
            for ph, vals in per.items():
                out[mode][ph] = {
                    "p50_ms": round(_pctl(vals, 0.50) or 0.0, 4),
                    "p99_ms": round(_pctl(vals, 0.99) or 0.0, 4),
                }
            totals = [s["total_ms"] for s in ring if s["mode"] == mode]
            out[mode]["step"] = {
                "n": len(totals),
                "p50_ms": round(_pctl(totals, 0.50) or 0.0, 4),
                "p99_ms": round(_pctl(totals, 0.99) or 0.0, 4),
            }
        return out

    def padding_waste(self) -> float:
        with self._lock:
            if self._padded <= 0:
                return 0.0
            return max(0.0, 1.0 - self._tokens / self._padded)

    def step_p99_ms(self) -> Optional[float]:
        with self._lock:
            totals = [s["total_ms"] for s in self.samples]
        return _pctl(totals, 0.99)

    def window(self, t0: float, t1: float) -> List[dict]:
        """Ring slice by wall-clock timestamp — links a /debug/profile
        capture window to the step samples taken during it."""
        with self._lock:
            return [s for s in self.samples if t0 <= s["ts"] <= t1]

    def tail(self, n: Optional[int] = None) -> List[dict]:
        with self._lock:
            out = list(self.samples)
        return out[-n:] if n else out

    def brief(self) -> Optional[dict]:
        """TUI chip payload: `compiles N · step p99 X ms`."""
        p99 = self.step_p99_ms()
        n = self.compile_count()
        if p99 is None and n == 0:
            return None
        out = {"compiles": n}
        if p99 is not None:
            out["p99_ms"] = round(p99, 3)
        return out

    def summary(self) -> dict:
        """The bench `step_profile` block / bundle section: per-mode
        phase p50/p99, compile count + rate, padding waste, overhead."""
        return {
            "samples": self.seq,
            "modes": self.phase_summary(),
            "compiles": self.compile_count(),
            "compile_rate_per_min": round(self.compile_rate_per_min(), 3),
            "padding_waste": round(self.padding_waste(), 4),
            "overhead_fraction": round(self.overhead_fraction(), 6),
        }

    def snapshot(self, n: int = 128) -> dict:
        """/debug/stepprof payload."""
        with self._lock:
            compiles = list(self.compiles)
        return {
            "summary": self.summary(),
            "shapes": self.shape_table(),
            "recent": self.tail(n),
            "compile_events": compiles[-n:],
            "hbm_samples": len(self.hbm),
        }


# THE process-wide profiler (metrics.REGISTRY pattern): engine + fake +
# bench write, server/TUI read, tests reset().
PROFILER = StepProfiler()
