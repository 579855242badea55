"""The port's telemetry plane against the JAX package's (both stdlib
code; the port keeps its own copy):

- the process registries declare the same series: names, types, labels,
  help text and buckets, and no name of the port's own;
- the same operation sequence over those series renders byte-identical
  Prometheus text and equal snapshots, also with other ranks' snapshots
  merged in and a fleet member federated (a rank world's /metrics);
- flops_per_token / active_param_count agree for every model config the
  packages share, and the peak table is keyed on CUDA card names;
- the step profiler has the JAX package's phases, modes, sample, brief
  and snapshot keys;
- a synthetic request timeline gives the same Chrome trace, stitched
  trace and attribution timeline, and one SLO record sequence raises
  the same alerts with the same summaries.
"""

import json
import random
import time
import types

import pytest

from ollamamq_tpu.config import MODEL_CONFIGS as JAX_CONFIGS
from ollamamq_tpu.telemetry import REGISTRY as JAX_REGISTRY
from ollamamq_tpu.telemetry import attribution as jax_attribution
from ollamamq_tpu.telemetry import mfu as jax_mfu
from ollamamq_tpu.telemetry import slo as jax_slo
from ollamamq_tpu.telemetry import stepprof as jax_stepprof
from ollamamq_tpu.telemetry import tracing as jax_tracing
from ollamamq_tpu.telemetry.metrics import MetricsRegistry as JaxRegistry
from ollamamq_tpu_torch.config import MODEL_CONFIGS
from ollamamq_tpu_torch.telemetry import REGISTRY, attribution, mfu, slo, stepprof, tracing
from ollamamq_tpu_torch.telemetry.metrics import MetricsRegistry


def _decl(metric):
    return (metric.type, metric.labelnames, metric.help,
            getattr(metric, "buckets", None))


def test_registry_declares_the_jax_series():
    port = {n: _decl(REGISTRY.get(n)) for n in REGISTRY.names()}
    ref = {n: _decl(JAX_REGISTRY.get(n)) for n in JAX_REGISTRY.names()}
    assert set(port) == set(ref)
    assert port == ref
    assert len(port) > 60


def _mirror(source, registry_cls):
    """A fresh registry declaring every series of `source`."""
    reg = registry_cls()
    for name in sorted(source.names()):
        m = source.get(name)
        if m.type == "histogram":
            reg.histogram(name, m.help, buckets=m.buckets, labels=m.labelnames)
        else:
            getattr(reg, m.type)(name, m.help, labels=m.labelnames)
    return reg


def _apply_ops(reg, seed):
    rng = random.Random(seed)
    names = sorted(reg.names())
    values = ["a", "b", 'we"ird\\lab\nel', "llama3.2:1b"]
    for _ in range(800):
        m = reg.get(rng.choice(names))
        child = m.labels(**{k: rng.choice(values) for k in m.labelnames})
        if m.type == "counter":
            child.inc(rng.choice([1, 2.5, 7]))
        elif m.type == "gauge":
            rng.choice([lambda: child.set(rng.uniform(-5, 5)),
                        lambda: child.inc(rng.random()),
                        lambda: child.dec(rng.random())])()
        else:
            child.observe(rng.expovariate(0.01))
    return reg


def test_same_ops_render_byte_identical_text():
    port = _apply_ops(_mirror(REGISTRY, MetricsRegistry), 7)
    ref = _apply_ops(_mirror(JAX_REGISTRY, JaxRegistry), 7)
    text = port.render()
    assert text == ref.render()
    assert "ollamamq_ttft_ms_bucket" in text and "\\n" in text
    assert port.snapshot() == ref.snapshot()


def _drifted(snap):
    """A worker snapshot with the drift a merge must skip alike: a
    histogram on another ladder, a series under another type, another
    metric's labels, a malformed record, and one name the scraping
    process does not declare (merged in as is)."""
    out = json.loads(json.dumps(snap))
    out["ollamamq_ttft_ms"]["buckets"] = [1.0, 2.0]
    out["ollamamq_requests_total"]["type"] = "gauge"
    out["ollamamq_step_phase_ms"]["labels"] = ["mode", "phase"]
    out["ollamamq_queue_depth"] = {"type": "gauge"}
    out["ollamamq_worker_only_total"] = {
        "type": "counter", "help": "a series only a worker declares",
        "labels": ["rank"], "series": [[["1"], 3.0]]}
    return out


def test_worker_snapshots_render_byte_identical_text():
    """The rank world's /metrics: the same local series, the same worker
    snapshots (as they cross the store, JSON) and a fleet's federated
    member render byte-identical text through the JAX package's registry
    and the port's, with the drift cases skipped alike."""
    port = _apply_ops(_mirror(REGISTRY, MetricsRegistry), 11)
    ref = _apply_ops(_mirror(JAX_REGISTRY, JaxRegistry), 11)
    workers = [json.loads(_apply_ops(_mirror(REGISTRY, MetricsRegistry), seed)
                          .snapshot_json()) for seed in (12, 13)]
    assert workers == [json.loads(_apply_ops(_mirror(JAX_REGISTRY, JaxRegistry),
                                             seed).snapshot_json())
                       for seed in (12, 13)]
    fed = [("h0", workers[1])]
    for extra, federated in (([], []), (workers, []), (workers, fed),
                             ([_drifted(workers[0])], []),
                             (workers + [_drifted(workers[1])], fed)):
        text = port.render(extra_snapshots=extra, federated=federated)
        assert text == ref.render(extra_snapshots=extra, federated=federated)
    assert port.render(extra_snapshots=workers) != port.render()
    assert "ollamamq_worker_only_total" in text and 'replica="h0"' in text


def test_flops_per_token_agrees_on_shared_configs():
    shared = sorted(set(MODEL_CONFIGS) & set(JAX_CONFIGS))
    assert {"llama3.2:1b", "llama3:8b", "qwen3:8b", "test-tiny",
            "mixtral:8x7b", "test-tiny-moe"} <= set(shared)
    # MoE counts the routed-active experts only (tests/test_telemetry.py:238).
    for name in ("mixtral:8x7b", "test-tiny-moe"):
        moe = MODEL_CONFIGS[name]
        assert mfu.active_param_count(moe) < moe.param_count()
        assert moe.param_count() == JAX_CONFIGS[name].param_count()
    for name in shared:
        p, j = MODEL_CONFIGS[name], JAX_CONFIGS[name]
        assert mfu.active_param_count(p) == jax_mfu.active_param_count(j), name
        for ctx in (0.0, 1000.0):
            assert mfu.flops_per_token(p, ctx) == jax_mfu.flops_per_token(j, ctx), name
        assert (mfu.mfu(p, 96, 0.05, 989e12, context_len=300.0)
                == jax_mfu.mfu(j, 96, 0.05, 989e12, context_len=300.0))


def test_peak_table_is_keyed_on_card_names(monkeypatch):
    monkeypatch.delenv("OLLAMAMQ_PEAK_FLOPS", raising=False)
    assert mfu.peak_flops_per_chip("NVIDIA H100 80GB HBM3") == 989e12
    assert mfu.peak_flops_per_chip("NVIDIA H100 PCIe") == 756e12
    for other in ("", "cpu", "NVIDIA A100-SXM4-80GB", "TPU v5 lite"):
        assert mfu.peak_flops_per_chip(other) is None
    monkeypatch.setenv("OLLAMAMQ_PEAK_FLOPS", "1e12")
    assert mfu.peak_flops_per_chip("cpu") == 1e12


def test_step_profiler_keys_match_jax():
    assert stepprof.PHASES == jax_stepprof.PHASES
    assert stepprof.MODES == jax_stepprof.MODES
    port, ref = stepprof.StepProfiler(), jax_stepprof.StepProfiler()
    samples = []
    for prof in (port, ref):
        for mode in ("ragged", "decode"):
            t = prof.start(mode)
            for ph in stepprof.PHASES:
                t.mark(ph)
            samples.append(t.finish(T_pad=16, k_cap=0, n_prefill=1, n_decode=2,
                                    tokens=12, padded_tokens=16, compiled=False))
        prof.hbm_record({"models": {}})
    assert set(samples[0]) == set(samples[2]) and set(samples[1]) == set(samples[3])
    assert abs(samples[0]["total_ms"] - sum(samples[0][p + "_ms"]
                                            for p in stepprof.PHASES)) < 1e-3
    assert port.brief().keys() == ref.brief().keys() == {"compiles", "p99_ms"}
    assert port.snapshot().keys() == ref.snapshot().keys()
    assert port.summary().keys() == ref.summary().keys()
    assert port.phase_summary().keys() == ref.phase_summary().keys() == {"ragged", "decode"}
    assert port.phase_summary()["decode"].keys() == ref.phase_summary()["decode"].keys()
    assert port.padding_waste() == ref.padding_waste() == 0.25


def test_tracer_and_attribution_match_jax(monkeypatch):
    """One synthetic lifecycle on a fake monotonic clock through both
    tracers: the same Chrome export, stitched trace, timeline, summary
    and finish-time window."""
    clock = {"t": 1000.0}

    def tick():
        clock["t"] += 0.0125
        return clock["t"]

    fake_time = types.SimpleNamespace(monotonic=tick, time=time.time,
                                      perf_counter=time.perf_counter)
    for mod in (tracing, jax_tracing, attribution, jax_attribution):
        monkeypatch.setattr(mod, "time", fake_time)
    out = []
    for tr_mod, attr_mod in ((tracing, attribution), (jax_tracing, jax_attribution)):
        clock["t"] = 1000.0
        tracer = tr_mod.Tracer(capacity=4)
        traces = [tracer.begin(rid, f"u{rid}", "test-tiny", ctx="00-" + "ab" * 16
                               + "-" + "cd" * 8 + "-01") for rid in (1, 2)]
        for name, args in (("admit", {}), ("place", {"runtime": "test-tiny"}),
                           ("prefill_chunk", {"pos": 0, "tokens": 16}),
                           ("first_token", {"ttft_ms": 12.5}),
                           ("decode", {"tokens": 16}), ("preempt", {"slot": 1}),
                           ("requeue", {}), ("admit", {})):
            for tr in traces:
                tr.event(name, **args)
        traces[0].finish("stop")
        chrome = tracer.export_chrome()
        spans = tracer.export_spans([tracer.find(1)])
        out.append((chrome, tr_mod.merged_chrome(spans, root_origin=tracer.origin),
                    attr_mod.timeline(traces[0], now=2000.0),
                    attr_mod.summarize(tracer), len(tracer.finish_times),
                    [tr.events for tr in tracer.traces()]))
    assert out[0] == out[1]
    assert out[0][2]["state"] == "stop" and out[0][4] == 1


def test_alerts_and_slo_match_jax():
    runs = []
    for mod in (slo, jax_slo):
        alerts = mod.AlertManager()
        eng = mod.SLOEngine(alerts, ttft_ms=200.0, tpot_ms=20.0, target=0.99)
        rng = random.Random(5)
        for _ in range(300):
            eng.record("ttft", rng.choice([50.0, 150.0, 900.0]))
            eng.record("tpot", rng.choice([5.0, 15.0]), n=4)
        now = time.monotonic()
        summary = eng.evaluate(now=now)
        fired = alerts.fire("device_offline", "page", "probe failed", source="watchdog")
        again = alerts.fire("device_offline", "page", "probe failed", source="watchdog")
        active = sorted((a.name, a.severity, a.source) for a in alerts.active())
        resolved = alerts.resolve("device_offline")
        runs.append((summary, fired, again, active, resolved,
                     [a.name for a in alerts.active()], alerts.degraded()))
    assert runs[0] == runs[1]
    assert runs[0][0]["objectives"]["ttft"]["windows"]["fast"]["firing"]
    assert not runs[0][0]["objectives"]["tpot"]["windows"]["fast"]["firing"]


@pytest.mark.parametrize("seed", [1, 2])
def test_histogram_quantiles_match_jax(seed):
    """The per-model latency histograms' quantile math, on a seeded
    sample."""
    port = MetricsRegistry().histogram("t_ms", "h", buckets=(1, 5, 25, 125, 625))
    ref = JaxRegistry().histogram("t_ms", "h", buckets=(1, 5, 25, 125, 625))
    rng = random.Random(seed)
    for _ in range(500):
        v = rng.lognormvariate(3, 1.2)
        port.observe(v)
        ref.observe(v)
    for q in (0.5, 0.9, 0.99):
        assert port.quantile(q) == ref.quantile(q)
