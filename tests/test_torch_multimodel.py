"""Several models on one TorchEngine (CPU): load at run time through the
registry, serve both, evict, requests for an evicted model wait in the
queue and drain after a re-pull, evicting a busy model refuses (mirrors
of tests/test_multimodel.py); the runtime table changes only on the loop
thread while requests are served; an evicted runtime's weights are
freed; a failed encoder is rebuilt from its own source."""

import gc
import threading
import time
import weakref

import pytest
import torch

from ollamamq_tpu_torch.config import EngineConfig
from ollamamq_tpu_torch.engine.engine import EncoderRuntime, ModelRuntime, TorchEngine
from ollamamq_tpu_torch.engine.request import FinishReason
from ollamamq_tpu_torch.ops.sampling import SamplingParams
from ollamamq_tpu_torch.server.registry import ModelRegistry
from testutil import collect

SETTINGS = dict(model="test-tiny", max_slots=4, num_pages=128, page_size=8,
                max_pages_per_seq=16, max_new_tokens=8, decode_steps_per_iter=2,
                max_batch_tokens=48, token_granule=8)


@pytest.fixture(scope="module")
def setup():
    eng = TorchEngine(EngineConfig(**SETTINGS), device="cpu", dtype=torch.float32)
    eng.start()
    reg = ModelRegistry(eng)
    yield eng, reg
    eng.stop()


def run(eng, user, model, max_tokens=4, kind="generate"):
    tok = (eng.runtimes.get(model) or next(iter(eng.runtimes.values()))).tokenizer
    return eng.enqueue_request(user, "", model, prompt_tokens=tok.encode(f"for {model}"),
                               sampling=SamplingParams(max_tokens=max_tokens), kind=kind)


def test_pull_load_serve_evict_reload(setup):
    eng, reg = setup
    assert eng.loaded_models() == ["test-tiny"]
    reg.pull("test-tiny-gqa")
    assert set(eng.loaded_models()) == {"test-tiny", "test-tiny-gqa"}
    r1 = run(eng, "mmA", "test-tiny")
    r2 = run(eng, "mmB", "test-tiny-gqa")
    assert collect(r1)[-1].kind == "done"
    assert collect(r2)[-1].kind == "done"
    stats = eng.stats()
    assert len(stats["runtimes"]) == 2
    assert all(s["param_bytes"] > 0 for s in stats["runtimes"])

    # Evict: requests for the gone model wait in the queue.
    assert reg.delete("test-tiny-gqa")
    assert eng.loaded_models() == ["test-tiny"]
    r3 = run(eng, "mmC", "test-tiny-gqa")
    time.sleep(0.5)
    assert r3.stream.get(timeout=0.01) is None  # not served, not errored
    assert eng.core.snapshot()["users"]["mmC"]["queued"] == 1
    r4 = run(eng, "mmD", "test-tiny")  # the other model keeps serving
    assert collect(r4)[-1].kind == "done"

    # Re-pull: the parked request drains.
    reg.pull("test-tiny-gqa")
    assert collect(r3)[-1].kind == "done"


def test_evict_with_inflight_work_refuses(setup):
    eng, reg = setup
    if "test-tiny-gqa" not in eng.runtimes:  # independent of test order
        reg.pull("test-tiny-gqa")
    rt = eng.runtimes["test-tiny-gqa"]
    rt.tokenizer.eos_id = -1
    req = run(eng, "mmE", "test-tiny-gqa", max_tokens=10_000)
    deadline = time.monotonic() + 60
    while not req.stats.first_token_at and time.monotonic() < deadline:
        time.sleep(0.01)
    assert req.stats.first_token_at
    with pytest.raises(RuntimeError, match="in-flight"):
        eng.evict_model("test-tiny-gqa")
    eng.cancel(req.req_id)
    assert collect(req)[-1].finish_reason == FinishReason.CANCELLED
    rt.tokenizer.eos_id = 2


def test_evicted_weights_are_freed(setup):
    """After evict_model nothing keeps the runtime's tensors alive (the
    HBM timeline, the health monitor and stepprof keep numbers only)."""
    eng, reg = setup
    reg.pull("test-tiny-embed")
    rt = eng.runtimes["test-tiny-embed"]
    assert isinstance(rt, EncoderRuntime)
    req = run(eng, "mmF", "test-tiny-embed", kind="embed")
    assert collect(req)[-1].kind == "done"
    eng._hbm_last_sample = 0.0
    time.sleep(0.1)  # one loop pass samples the HBM timeline
    embed_ref = weakref.ref(rt.params["embed"])
    rt_ref = weakref.ref(rt)
    del rt
    assert reg.delete("test-tiny-embed")
    gc.collect()
    assert embed_ref() is None and rt_ref() is None
    assert "test-tiny-embed" not in eng.loaded_models()


def test_table_changes_on_the_loop_while_serving(setup):
    """Four threads pull and delete models again and again while six read
    the table (stats, resolve, cancel of an unknown id) and two users are
    served, with a short switch interval: no iteration sees the table
    change size and every request finishes."""
    import sys

    eng, reg = setup
    stop, errors = threading.Event(), []

    def churn(name):
        while not stop.is_set():
            try:
                reg.pull(name)
                reg.delete(name)
            except Exception as e:  # noqa: BLE001 — reported below
                errors.append(e)

    def read():
        while not stop.is_set():
            try:
                eng.stats()
                eng.resolve_runtime("", kind="embed")
                eng.cancel(-1)
            except Exception as e:  # noqa: BLE001 — reported below
                errors.append(e)

    workers = ([threading.Thread(target=churn, args=(m,)) for m in
                ("test-tiny-qwen3", "test-tiny-qwen", "test-tiny-embed", "test-tiny-gqa")]
               + [threading.Thread(target=read) for _ in range(6)])
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for t in workers:
            t.start()
        reqs = [run(eng, f"churn{i % 2}", "test-tiny", max_tokens=3) for i in range(6)]
        reqs += [run(eng, "churn-e", "test-tiny", kind="embed") for _ in range(3)]
        assert all(collect(r)[-1].kind == "done" for r in reqs)
    finally:
        stop.set()
        for t in workers:
            t.join(timeout=60)
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in workers)
    assert errors == []
    assert eng.loaded_models() == ["test-tiny"]


def test_failed_encoder_is_rebuilt_from_its_source():
    """An encode fault errors its batch and kills the encoder; the rebuild
    (same seeded weights) serves the next embed with the same vector."""
    from ollamamq_tpu_torch.testing.faults import FaultPlan

    eng = TorchEngine(EngineConfig(**{**SETTINGS, "step_retries": 0}, fault_plan=FaultPlan(
        [{"site": "encode", "kind": "exception", "at": [2]}])),
        device="cpu", dtype=torch.float32,
        models={"test-tiny": None, "test-tiny-embed": None})
    eng.recover_interval = 0.0
    eng.start()
    try:
        first = run(eng, "e", "test-tiny-embed", kind="embed")
        assert collect(first)[-1].kind == "done"
        old = eng.runtimes["test-tiny-embed"]
        hit = run(eng, "e", "test-tiny-embed", kind="embed")
        assert collect(hit)[-1].kind == "error"
        deadline = time.monotonic() + 30
        while eng.runtimes["test-tiny-embed"] is old and time.monotonic() < deadline:
            time.sleep(0.01)
        fresh = eng.runtimes["test-tiny-embed"]
        assert fresh is not old and isinstance(fresh, EncoderRuntime)
        again = run(eng, "e", "test-tiny-embed", kind="embed")
        assert collect(again)[-1].kind == "done"
        assert again.embedding == first.embedding
        assert isinstance(eng.runtimes["test-tiny"], ModelRuntime)
    finally:
        eng.stop()


def test_cli_models_and_checkpoints(monkeypatch):
    """--models / --checkpoints (and env MODELS / CHECKPOINTS) build the
    engine's model table; an unknown architecture fails before any
    engine is built."""
    from ollamamq_tpu_torch import cli
    from ollamamq_tpu_torch.engine import engine as engine_mod

    args = cli.build_parser().parse_args(
        ["--models", "test-tiny, test-tiny-embed", "--checkpoints",
         "test-tiny=/ckpt/a,other=/ckpt/b"])
    assert cli.model_table(args) == {"test-tiny": "/ckpt/a", "test-tiny-embed": None}
    assert cli.engine_config(args).model == "test-tiny"
    args = cli.build_parser().parse_args(["--model", "test-tiny-gqa"])
    assert cli.model_table(args) == {"test-tiny-gqa": None}
    monkeypatch.setenv("MODELS", "test-tiny-embed")
    monkeypatch.setenv("CHECKPOINTS", "test-tiny-embed=/ckpt/e")
    assert cli.model_table(cli.build_parser().parse_args([])) == \
        {"test-tiny-embed": "/ckpt/e"}

    def boom(*a, **k):
        raise AssertionError("the engine must not be built")

    monkeypatch.setattr(engine_mod, "TorchEngine", boom)
    assert cli.main(["--models", "test-tiny,no-such-model", "--device", "cpu",
                     "--no-tui"]) == 2
