"""Process-wide metrics registry with Prometheus text exposition.

Three metric types (the Prometheus core set minus summaries — quantiles
are derived from fixed-bucket histograms instead, so merging across SPMD
hosts stays exact):

  Counter    monotonically increasing float
  Gauge      set/inc/dec float
  Histogram  fixed upper-bound buckets + sum + count

Design constraints, in order:
  - hot-path cheap: an observe() is one lock acquire, one bisect, three
    adds — no string formatting, no allocation beyond the first call for
    a given label set (children are cached on the parent).
  - thread-safe: the engine thread, HTTP threads, and the SPMD heartbeat
    publisher all touch the registry concurrently.
  - mergeable: snapshot() emits a JSON-able dict a peer host can publish
    over the jax.distributed KV store; render(extra=...) folds peer
    snapshots into one exposition (counters/histograms sum; gauge series
    union with local-wins, which is correct for the per-chip gauges whose
    label sets are disjoint across hosts).

No third-party deps, no jax: this module must import in the doc checker
and on worker hosts before any backend exists.
"""

from __future__ import annotations

import bisect
import json
import math
import threading
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

# Default histogram ladder for millisecond latencies: sub-ms dispatch up
# to the 300 s request timeout, roughly x2.5 per step.
DEFAULT_LATENCY_BUCKETS_MS = (
    1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0,
    1000.0, 2500.0, 5000.0, 10000.0, 30000.0,
)


def escape_label_value(v: str) -> str:
    """Prometheus label-value escaping: backslash, double-quote, newline."""
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def format_float(v: float) -> str:
    """Exposition float formatting: integers bare, +Inf spelled out."""
    if v == math.inf:
        return "+Inf"
    if v == -math.inf:
        return "-Inf"
    if v != v:  # NaN
        return "NaN"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


class _Child:
    __slots__ = ("_lock",)

    def __init__(self):
        self._lock = threading.Lock()


class CounterChild(_Child):
    __slots__ = ("value",)

    def __init__(self):
        super().__init__()
        self.value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("counters only go up")
        with self._lock:
            self.value += amount


class GaugeChild(_Child):
    __slots__ = ("value",)

    def __init__(self):
        super().__init__()
        self.value = 0.0

    def set(self, value: float) -> None:
        with self._lock:
            self.value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self.value += amount

    def dec(self, amount: float = 1.0) -> None:
        with self._lock:
            self.value -= amount


class HistogramChild(_Child):
    __slots__ = ("buckets", "counts", "sum", "count")

    def __init__(self, buckets: Tuple[float, ...]):
        super().__init__()
        self.buckets = buckets  # sorted finite upper bounds; +Inf implicit
        self.counts = [0] * (len(buckets) + 1)  # last = overflow (+Inf)
        self.sum = 0.0
        self.count = 0

    def observe(self, value: float) -> None:
        # bisect_left: observe(boundary) lands IN the le=boundary bucket
        # (Prometheus le is inclusive).
        i = bisect.bisect_left(self.buckets, value)
        with self._lock:
            self.counts[i] += 1
            self.sum += value
            self.count += 1

    def quantile(self, q: float) -> float:
        """Estimated q-quantile (0..1) by linear interpolation within the
        owning bucket; the +Inf bucket clamps to the last finite bound."""
        with self._lock:
            counts = list(self.counts)
            total = self.count
        if total == 0:
            return 0.0
        rank = q * total
        seen = 0.0
        for i, c in enumerate(counts):
            if seen + c >= rank and c > 0:
                lo = self.buckets[i - 1] if i > 0 else 0.0
                hi = self.buckets[i] if i < len(self.buckets) else self.buckets[-1]
                frac = (rank - seen) / c
                return lo + (hi - lo) * min(1.0, max(0.0, frac))
            seen += c
        return self.buckets[-1]

    def _reset_to(self, buckets: Tuple[float, ...]) -> None:
        with self._lock:
            self.buckets = buckets
            self.counts = [0] * (len(buckets) + 1)
            self.sum = 0.0
            self.count = 0


class Metric:
    """A named metric family; label combinations materialize children."""

    type: str = "untyped"

    def __init__(self, name: str, help: str, labelnames: Tuple[str, ...] = ()):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()
        self._children: Dict[Tuple[str, ...], _Child] = {}

    def _new_child(self) -> _Child:
        raise NotImplementedError

    def labels(self, **kw) -> _Child:
        if set(kw) != set(self.labelnames):
            raise ValueError(
                f"{self.name}: labels {sorted(kw)} != declared "
                f"{sorted(self.labelnames)}")
        key = tuple(str(kw[k]) for k in self.labelnames)
        child = self._children.get(key)
        if child is None:
            with self._lock:
                child = self._children.setdefault(key, self._new_child())
        return child

    def _default(self) -> _Child:
        if self.labelnames:
            raise ValueError(f"{self.name} is labeled; use .labels(...)")
        return self.labels()

    def clear(self) -> None:
        """Drop all children (for scrape-time rebuilt gauges: users and
        chips come and go; stale series must not linger)."""
        with self._lock:
            self._children = {}

    def series(self) -> List[Tuple[Tuple[str, ...], _Child]]:
        with self._lock:
            return list(self._children.items())


class Counter(Metric):
    type = "counter"

    def _new_child(self):
        return CounterChild()

    def inc(self, amount: float = 1.0) -> None:
        self._default().inc(amount)

    @property
    def value(self) -> float:
        return self._default().value


class Gauge(Metric):
    type = "gauge"

    def _new_child(self):
        return GaugeChild()

    def set(self, value: float) -> None:
        self._default().set(value)

    def inc(self, amount: float = 1.0) -> None:
        self._default().inc(amount)

    def dec(self, amount: float = 1.0) -> None:
        self._default().dec(amount)

    @property
    def value(self) -> float:
        return self._default().value


class Histogram(Metric):
    type = "histogram"

    def __init__(self, name, help, buckets: Sequence[float],
                 labelnames: Tuple[str, ...] = ()):
        super().__init__(name, help, labelnames)
        b = tuple(sorted(float(x) for x in buckets))
        if not b or not all(math.isfinite(x) for x in b):
            raise ValueError(
                f"{name}: buckets must be finite bounds (+Inf is implicit)")
        self.buckets = b

    def _new_child(self):
        return HistogramChild(self.buckets)

    def observe(self, value: float) -> None:
        self._default().observe(value)

    def quantile(self, q: float) -> float:
        return self._default().quantile(q)

    def set_buckets(self, buckets: Sequence[float]) -> None:
        """Re-bucket (operator --metrics-buckets): resets every child's
        observations — boundaries can't be translated between ladders."""
        b = tuple(sorted(float(x) for x in buckets))
        if not b:
            raise ValueError(f"{self.name}: empty bucket list")
        self.buckets = b
        for _, child in self.series():
            child._reset_to(b)


class MetricsRegistry:
    """Named metric families; the module-level REGISTRY is process-wide."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, Metric] = {}

    def _register(self, cls, name, help, labels, **kw) -> Metric:
        with self._lock:
            existing = self._metrics.get(name)
            if existing is not None:
                # Idempotent re-registration (tests build many engines in
                # one process); a TYPE flip is a bug, not a re-use.
                if not isinstance(existing, cls):
                    raise ValueError(
                        f"metric {name} already registered as "
                        f"{existing.type}, not {cls.type}")
                return existing
            m = cls(name, help, labelnames=tuple(labels), **kw)
            self._metrics[name] = m
            return m

    def counter(self, name: str, help: str, labels: Iterable[str] = ()) -> Counter:
        return self._register(Counter, name, help, labels)

    def gauge(self, name: str, help: str, labels: Iterable[str] = ()) -> Gauge:
        return self._register(Gauge, name, help, labels)

    def histogram(self, name: str, help: str, buckets: Sequence[float],
                  labels: Iterable[str] = ()) -> Histogram:
        return self._register(Histogram, name, help, labels, buckets=buckets)

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._metrics)

    def get(self, name: str) -> Optional[Metric]:
        with self._lock:
            return self._metrics.get(name)

    # -- exposition --------------------------------------------------------
    @staticmethod
    def _labels_str(labelnames, labelvalues, extra: str = "") -> str:
        parts = [f'{k}="{escape_label_value(v)}"'
                 for k, v in zip(labelnames, labelvalues)]
        if extra:
            parts.append(extra)
        return "{" + ",".join(parts) + "}" if parts else ""

    def render(self, extra_snapshots: Optional[List[dict]] = None,
               federated: Optional[List[Tuple[str, dict]]] = None) -> str:
        """Prometheus text exposition (format version 0.0.4). Peer-host
        snapshots merge in: counter/histogram series with identical
        labels sum; gauge series union with local values winning.

        `federated` is the fleet-router path: (replica_name, snapshot)
        pairs whose every series re-exports UNLABELED-MERGED-NEVER —
        each lands verbatim under the same family with an extra
        `replica` label next to the router's own series, so ONE
        Prometheus scrape of the router sees the whole fleet without
        double counting (label sets may differ per sample within a
        family; Prometheus accepts that)."""
        merged = self._merged_view(extra_snapshots or [])
        fed = self._federated_view(federated or [])
        out: List[str] = []
        for name in sorted(set(merged) | set(fed)):
            local = merged.get(name)
            fed_rows = fed.get(name, [])
            typ, help_ = ((local[0], local[1]) if local is not None
                          else (fed_rows[0][0], fed_rows[0][1]))
            out.append(f"# HELP {name} {help_}")
            out.append(f"# TYPE {name} {typ}")
            if local is not None:
                _, _, labelnames, buckets, series = local
                for labelvalues in sorted(series):
                    self._render_sample(out, name, typ, labelnames,
                                        buckets, labelvalues,
                                        series[labelvalues])
            for ftyp, _fhelp, labelnames, buckets, series in fed_rows:
                if ftyp != typ:
                    continue  # cross-process type drift: local wins
                for labelvalues in sorted(series):
                    self._render_sample(out, name, typ, labelnames,
                                        buckets, labelvalues,
                                        series[labelvalues])
        return "\n".join(out) + "\n"

    def _render_sample(self, out: List[str], name, typ, labelnames,
                       buckets, labelvalues, val) -> None:
        if typ == "histogram":
            counts, hsum, hcount = val
            cum = 0
            for i, ub in enumerate(list(buckets) + [math.inf]):
                cum += counts[i] if i < len(counts) else 0
                ls = self._labels_str(
                    labelnames, labelvalues, f'le="{format_float(ub)}"')
                out.append(f"{name}_bucket{ls} {cum}")
            ls = self._labels_str(labelnames, labelvalues)
            out.append(f"{name}_sum{ls} {format_float(hsum)}")
            out.append(f"{name}_count{ls} {hcount}")
        else:
            ls = self._labels_str(labelnames, labelvalues)
            out.append(f"{name}{ls} {format_float(val)}")

    @staticmethod
    def _federated_view(federated: List[Tuple[str, dict]]) -> dict:
        """name -> [(type, help, labelnames+('replica',), buckets,
        {labelvalues+(replica,): value})] rows, one per (replica,
        metric). Malformed member snapshots are skipped, never fail the
        scrape."""
        view: dict = {}
        for replica, snap in federated:
            for name, rec in (snap or {}).items():
                try:
                    typ = rec["type"]
                    labelnames = tuple(rec["labels"]) + ("replica",)
                    buckets = tuple(rec.get("buckets", ()))
                    series = {tuple(lv) + (str(replica),): v
                              for lv, v in rec["series"]}
                except (KeyError, TypeError):
                    continue
                view.setdefault(name, []).append(
                    (typ, rec.get("help", ""), labelnames, buckets,
                     series))
        return view

    def _merged_view(self, extras: List[dict]) -> dict:
        view: dict = {}
        with self._lock:
            metrics = list(self._metrics.values())
        for m in metrics:
            buckets = getattr(m, "buckets", ())
            series: dict = {}
            for labelvalues, child in m.series():
                if m.type == "histogram":
                    with child._lock:
                        series[labelvalues] = (
                            list(child.counts), child.sum, child.count)
                else:
                    series[labelvalues] = child.value
            view[m.name] = (m.type, m.help, m.labelnames, buckets, series)
        for snap in extras:
            self._merge_snapshot(view, snap)
        return view

    @staticmethod
    def _merge_snapshot(view: dict, snap: dict) -> None:
        for name, rec in snap.items():
            try:
                typ = rec["type"]
                labelnames = tuple(rec["labels"])
                buckets = tuple(rec.get("buckets", ()))
                incoming = {tuple(lv): v for lv, v in rec["series"]}
            except (KeyError, TypeError):
                continue  # malformed peer snapshot: skip, never fail scrape
            if name not in view:
                view[name] = (typ, rec.get("help", ""), labelnames, buckets,
                              dict(incoming))
                continue
            vtyp, vhelp, vnames, vbuckets, series = view[name]
            if vtyp != typ or vnames != labelnames:
                continue  # schema drift across hosts: local wins
            for lv, v in incoming.items():
                if vtyp == "histogram":
                    if tuple(vbuckets) != buckets:
                        continue  # different ladders can't sum
                    if lv in series:
                        counts, s, c = series[lv]
                        counts = [a + b for a, b in zip(counts, v[0])]
                        series[lv] = (counts, s + v[1], c + v[2])
                    else:
                        series[lv] = (list(v[0]), v[1], v[2])
                elif vtyp == "counter":
                    series[lv] = series.get(lv, 0.0) + v
                else:  # gauge: union, local wins on collision
                    series.setdefault(lv, v)

    # -- snapshots (SPMD host merge) ---------------------------------------
    def snapshot(self) -> dict:
        """JSON-able dump of every series, for publishing to peers."""
        out: dict = {}
        with self._lock:
            metrics = list(self._metrics.values())
        for m in metrics:
            series = []
            for labelvalues, child in m.series():
                if m.type == "histogram":
                    with child._lock:
                        series.append([list(labelvalues),
                                       [list(child.counts), child.sum,
                                        child.count]])
                else:
                    series.append([list(labelvalues), child.value])
            rec = {"type": m.type, "help": m.help,
                   "labels": list(m.labelnames), "series": series}
            if m.type == "histogram":
                rec["buckets"] = list(m.buckets)
            out[m.name] = rec
        return out

    def snapshot_json(self) -> str:
        return json.dumps(self.snapshot())


REGISTRY = MetricsRegistry()
