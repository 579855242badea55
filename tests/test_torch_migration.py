"""KV page migration of the port held against the JAX package, on the CPU.

- Wire: a blob packed by either package unpacks in the other with equal
  headers and arrays: f32 pages, bf16 pages (a uint8 view of the last
  axis with the dtype name in the header; the port unpacks it to a torch
  bf16 tensor without ml_dtypes) and int8 payloads with their f32 scale
  planes.
- Runtime: test-tiny with the JAX runtime's weights bridged into the
  port's. A decode slot exported by one package's ModelRuntime after N
  tokens, shipped through the wire, imports into the other's and
  continues with ids IDENTICAL to the JAX runtime's unmigrated run, in
  both directions, with f32 and int8 KV pools; the imported pages read
  back bit for bit.
- Across packages over HTTP: the port's router drains a JAX member
  server into a port member over /admin/migrate, and the greedy stream
  continues token-identically (the JAX member runs the JAX package's
  aiohttp server, as tests/test_fleet.py starts it).

Tolerances: ids identical, pages bit-equal; no logits are compared.
"""

import codecs
import itertools
import time

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from ollamamq_tpu.config import MODEL_CONFIGS as JAX_CONFIGS
from ollamamq_tpu.config import EngineConfig as JaxEngineConfig
from ollamamq_tpu.core import MQCore as JaxMQCore
from ollamamq_tpu.engine import engine as jax_engine
from ollamamq_tpu.engine import kv_cache as jax_kvc
from ollamamq_tpu.engine.engine import TPUEngine
from ollamamq_tpu.ops.sampling import SamplingParams as JaxSampling
from ollamamq_tpu.testing.faults import FaultPlan as JaxFaultPlan
from ollamamq_tpu_torch.config import MODEL_CONFIGS, EngineConfig
from ollamamq_tpu_torch.core.mqcore import MQCore
from ollamamq_tpu_torch.engine import engine as port_engine
from ollamamq_tpu_torch.engine import kv_cache as kvc
from ollamamq_tpu_torch.engine.engine import ModelRuntime, TorchEngine
from ollamamq_tpu_torch.fleet import FleetRouter, HttpMember, LocalMember
from ollamamq_tpu_torch.models.weights import from_jax_numpy
from ollamamq_tpu_torch.ops.sampling import SamplingParams
from ollamamq_tpu_torch.tools.journal import check_no_dropped_streams
from test_fleet import _HttpBackend
from testutil import collect

SETTINGS = dict(model="test-tiny", max_slots=4, num_pages=64, page_size=8,
                max_pages_per_seq=8, decode_steps_per_iter=2,
                max_batch_tokens=48, token_granule=8)
MAX_TOKENS = 24
_IDS = itertools.count(1)


# ------------------------------------------------------------------ wire
def _arrays(rng):
    return {
        "f32": rng.standard_normal((2, 16, 2, 8)).astype(np.float32),
        "q": rng.integers(-127, 128, size=(2, 16, 2, 8), dtype=np.int8),
        "s": rng.random((2, 16, 2)).astype(np.float32),
        "bf": rng.standard_normal((2, 16, 2, 8)).astype(np.float32),
    }


def _header(**extra):
    return {"version": 1, "kind": "stream", "model": "test-tiny",
            "kv_len": 13, "last_token": 42, "n_pages": 2,
            "request": {"user": "u", "generated_ids": [5, 6, 7]}, **extra}


def test_jax_blobs_unpack_in_the_port():
    a = _arrays(np.random.default_rng(0))
    blob = {**_header(kv_dtype="int8"), "k_pages": a["q"], "k_scale": a["s"],
            "v_pages": a["f32"], "recent": np.arange(8, dtype=np.int32),
            "bf_pages": a["bf"].astype(ml_dtypes.bfloat16)}
    out = kvc.unpack_migration_blob(jax_kvc.pack_migration_blob(blob))
    for key, val in _header(kv_dtype="int8").items():
        assert out[key] == val
    for key in ("k_pages", "k_scale", "v_pages", "recent"):
        assert out[key].dtype == blob[key].dtype
        assert np.array_equal(out[key], blob[key])
    bf = out["bf_pages"]
    assert isinstance(bf, torch.Tensor) and bf.dtype == torch.bfloat16
    assert tuple(bf.shape) == blob["bf_pages"].shape
    assert np.array_equal(bf.view(torch.int16).numpy(),
                          blob["bf_pages"].view(np.int16))


def test_port_blobs_unpack_in_jax():
    a = _arrays(np.random.default_rng(1))
    bf = torch.from_numpy(a["bf"]).to(torch.bfloat16)
    blob = {**_header(kv_dtype="bfloat16"), "k_pages": bf,
            "v_pages": torch.from_numpy(a["f32"]),
            "k_scale": torch.from_numpy(a["s"]),
            "q_pages": torch.from_numpy(a["q"]),
            "recent": np.arange(8, dtype=np.int32), "_inc_decode": object(),
            "decoder_pending": [229, 131]}
    out = jax_kvc.unpack_migration_blob(kvc.pack_migration_blob(blob))
    for key, val in _header(kv_dtype="bfloat16").items():
        assert out[key] == val
    assert "_inc_decode" not in out
    # The ids the source's decoder held back cross the wire; the JAX
    # package unpacks them with the header and its importer ignores them.
    assert out["decoder_pending"] == [229, 131]
    assert out["k_pages"].dtype == ml_dtypes.bfloat16
    assert np.array_equal(out["k_pages"].view(np.int16),
                          bf.view(torch.int16).numpy())
    assert np.array_equal(out["v_pages"], a["f32"])
    assert np.array_equal(out["k_scale"], a["s"])
    assert out["q_pages"].dtype == np.int8
    assert np.array_equal(out["q_pages"], a["q"])
    # The migrate-bytes counter's unit is the JAX package's: every array
    # of the blob, the penalty-ring row included.
    assert kvc.migration_blob_bytes(blob) == jax_kvc.migration_blob_bytes(out)


def test_foreign_and_truncated_blobs_are_refused():
    with pytest.raises(ValueError, match="bad magic"):
        kvc.unpack_migration_blob(b"PK\x03\x04 not a blob")
    raw = kvc.pack_migration_blob({**_header(), "k": np.zeros(4, np.float32)})
    with pytest.raises(ValueError):
        kvc.unpack_migration_blob(raw[:10])
    with pytest.raises(ValueError):
        kvc.unpack_migration_blob(raw[:-20])


# --------------------------------------------------------------- runtime
def _runtimes(kv_dtype):
    jcfg = JaxEngineConfig(prefill_buckets=(16, 64), kv_dtype=kv_dtype,
                           **SETTINGS)
    jrt = jax_engine.ModelRuntime("test-tiny", JAX_CONFIGS["test-tiny"], jcfg,
                                  dtype=jnp.float32)
    jrt.tokenizer.eos_id = -1
    pnp = jax.tree_util.tree_map(np.asarray, jrt.params)
    trt = ModelRuntime("test-tiny", MODEL_CONFIGS["test-tiny"],
                       EngineConfig(kv_dtype=kv_dtype, **SETTINGS),
                       device="cpu", dtype=torch.float32,
                       params=from_jax_numpy(pnp, MODEL_CONFIGS["test-tiny"]))
    trt.tokenizer.eos_id = -1
    return jrt, trt


def _jreq(prompt, rp):
    return jax_engine.Request(next(_IDS), "u", "test-tiny", list(prompt),
                              JaxSampling(max_tokens=MAX_TOKENS,
                                          repeat_penalty=rp))


def _treq(prompt, rp):
    return port_engine.Request(next(_IDS), "u", "test-tiny", list(prompt),
                               SamplingParams(max_tokens=MAX_TOKENS,
                                              repeat_penalty=rp))


def _tick_until(rt, core, req, n):
    """Prefill, then decode one token a dispatch until `req` holds n
    generated ids (None: until it finishes)."""
    for _ in range(400):
        if req.stats.finished_at or (n is not None
                                     and len(req.generated_ids) >= n):
            return
        if not rt.step_ragged(core):
            rt.step_decode(core, k_steps=1)
    raise AssertionError("request wedged")


def _submit(rt, req):
    req._inc_decode = rt.tokenizer.make_incremental_decoder()
    rt.pending_prefill.append(req)


def _raw(v) -> bytes:
    """An array's bytes, torch (bf16 included) or numpy."""
    if isinstance(v, torch.Tensor):
        return v.contiguous().view(torch.uint8).numpy().tobytes()
    return np.ascontiguousarray(v).tobytes()


@pytest.mark.parametrize("kv_dtype", ["float32", "int8"])
@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
@pytest.mark.parametrize("rp", [1.0, 1.1], ids=["greedy", "repeat-penalty"])
def test_slot_migrates_across_packages_token_identically(direction, kv_dtype,
                                                         rp):
    """Export after N tokens on one package's runtime, ship the packed
    blob, import on the other's and finish there: the ids equal the JAX
    runtime's unmigrated run, and the imported page run (payload and
    scale planes) reads back bit for bit. Repeat penalty 1.1 makes the
    shipped penalty ring matter."""
    kv = "bfloat16" if kv_dtype == "float32" else kv_dtype  # f32 pools
    prompt = np.random.default_rng(5).integers(3, 500, size=19).tolist()
    jrt, trt = _runtimes(kv)
    jcore, tcore = JaxMQCore(None), MQCore(None)
    golden = _jreq(prompt, rp)
    _submit(jrt, golden)
    _tick_until(jrt, jcore, golden, None)
    want = list(golden.generated_ids)
    assert len(want) == MAX_TOKENS

    if direction == "jax_to_port":
        src, dst, score, dcore = jrt, trt, jcore, tcore
        req = _jreq(prompt, rp)
        pack, unpack = jax_kvc.pack_migration_blob, kvc.unpack_migration_blob
        rebuild = port_engine.request_from_migration_state
        dst_gather = kvc.gather_page_run
    else:
        src, dst, score, dcore = trt, jrt, tcore, jcore
        req = _treq(prompt, rp)
        pack, unpack = kvc.pack_migration_blob, jax_kvc.unpack_migration_blob
        rebuild = jax_engine.request_from_migration_state
        dst_gather = jax_kvc.gather_page_run
    _submit(src, req)
    _tick_until(src, score, req, 7)
    handle, blob = src.export_request(req.req_id)
    assert blob["kv_len"] == len(prompt) + len(req.generated_ids) - 1
    shipped = unpack(pack(blob))
    src.release_export(handle)
    assert src.alloc.used_pages == 0
    moved = rebuild(next(_IDS), shipped["request"])
    assert dst.import_request(shipped, moved)
    slot = next(i for i, r in enumerate(dst.slot_req) if r is moved)
    ps = SETTINGS["page_size"]
    landed = dst_gather(dst.kc, dst.vc, dst.slot_pages[slot], ps)
    assert set(landed) == ({"k_pages", "v_pages", "k_scale", "v_scale"}
                           if kv == "int8" else {"k_pages", "v_pages"})
    for key, val in landed.items():
        assert _raw(val) == _raw(shipped[key]), key
    _tick_until(dst, dcore, moved, None)
    assert list(moved.generated_ids) == want
    assert dst.alloc.used_pages == 0


# ------------------------------------------------------ across processes
def test_router_drains_jax_http_member_into_port_member():
    """The port's router over a JAX member server (h0) and a port
    TorchEngine member (r0) with the JAX engine's weights: draining h0
    ships the stream over /admin/migrate (export from JAX, import in the
    port, commit) and the greedy stream continues token-identically."""
    cfg = dict(SETTINGS, max_slots=2)
    slow = JaxFaultPlan([{"site": "decode", "kind": "slow", "every": 1,
                          "delay_s": 0.04}])
    jeng = TPUEngine(JaxEngineConfig(prefill_buckets=(16, 32), fault_plan=slow,
                                     **cfg),
                     blocklist_path=None, dtype=jnp.float32)
    jeng.start()
    prompt = "migrate me across packages"
    golden = jeng.enqueue_request(
        "g", "", "test-tiny", prompt_tokens=jeng.runtimes[
            "test-tiny"].tokenizer.encode(prompt),
        sampling=JaxSampling(max_tokens=MAX_TOKENS), raw_prompt=prompt)
    gitems = collect(golden, timeout=240)
    assert gitems[-1].kind == "done"
    want_ids = list(golden.generated_ids)
    pnp = jax.tree_util.tree_map(np.asarray, jeng.runtimes["test-tiny"].params)
    backend = _HttpBackend(jeng)
    teng = TorchEngine(EngineConfig(**cfg), device="cpu", dtype=torch.float32,
                       params=from_jax_numpy(pnp, MODEL_CONFIGS["test-tiny"]),
                       blocklist_path=None)
    # Least-loaded ties rotate from the second member: h0 takes the stream.
    members = [LocalMember("r0", teng),
               HttpMember("h0", backend.url, timeout_s=60, poll_period_s=0.1)]
    router = FleetRouter(members, EngineConfig(**cfg), blocklist_path=None,
                         probe_period_s=0.05, eject_heartbeat_s=30.0,
                         reprobe_backoff_s=0.2, evac_grace_s=1.0,
                         migrate_timeout_s=60.0)
    router.start()
    try:
        req = router.enqueue_request(
            "m", "", "test-tiny",
            prompt_tokens=teng.runtimes["test-tiny"].tokenizer.encode(prompt),
            sampling=SamplingParams(max_tokens=MAX_TOKENS), raw_prompt=prompt)
        deadline = time.monotonic() + 120
        flight = None
        while time.monotonic() < deadline:
            flight = next((f for f in list(router.flights) if f.req is req),
                          None)
            if flight is not None and flight.attempt is not None \
                    and flight.attempt.member_rid is not None \
                    and len(flight.attempt.token_ids) >= 4:
                break
            time.sleep(0.01)
        assert flight.member.name == "h0"
        router.drain_replica("h0")
        while flight.member is not members[0] and time.monotonic() < deadline:
            time.sleep(0.01)
        att = flight.attempt
        assert att.member is members[0], "the stream never migrated"
        items = collect(req, timeout=120)
        assert items[-1].kind == "done"
        assert list(att.req.generated_ids) == want_ids
        recs = router.journal.tail(None)
        migrated = [r for r in recs if r["kind"] == "migrate_import"]
        assert migrated and migrated[-1]["replica"] == "h0" \
            and migrated[-1]["to_replica"] == "r0"
        assert migrated[-1]["tokens"] >= 4
        assert router.failover_count == 0
        assert check_no_dropped_streams(recs) == []
    finally:
        router.stop()
        backend.stop()


def _holds_bytes(ids) -> bool:
    """Whether a byte-level decoder fed `ids` holds back an incomplete
    UTF-8 sequence (ids 3..258 are bytes)."""
    dec = codecs.getincrementaldecoder("utf-8")(errors="replace")
    for t in ids:
        if 3 <= t < 259:
            dec.decode(bytes([t - 3]))
    return bool(dec.getstate()[0])


def test_port_http_drain_keeps_bytes_the_decoder_held_back():
    """Port to port over /admin/migrate: the source member's stream is
    drained at the very token where its decoder holds an incomplete
    UTF-8 sequence back (the source's loop waits there for the export),
    and the client's text equals the unmigrated run's, ids included. The
    blob carries the held-back ids and the target primes its fresh
    decoder with them; without them the continuation bytes decode as
    U+FFFD."""
    from ollamamq_tpu_torch.server.app import serve_in_thread, stop_server

    cfg = EngineConfig(dtype="float32", **dict(SETTINGS, max_slots=2,
                                               decode_steps_per_iter=1))
    prompt = "hello world"
    golden_eng = TorchEngine(cfg, device="cpu", dtype=torch.float32,
                             blocklist_path=None)
    golden_eng.start()
    try:
        tok = golden_eng.runtimes["test-tiny"].tokenizer
        golden = collect(golden_eng.enqueue_request(
            "g", "", "test-tiny", prompt_tokens=tok.encode(prompt),
            sampling=SamplingParams(max_tokens=32), raw_prompt=prompt))
    finally:
        golden_eng.stop()
    want_ids = [i.token_id for i in golden if i.kind == "token"]
    want_text = "".join(i.text for i in golden if i.kind == "token")
    held = [n for n in range(3, len(want_ids) - 1)
            if _holds_bytes(want_ids[:n])]
    assert golden[-1].kind == "done" and held, \
        "the golden stream never holds bytes back: the test cannot bite"

    engines = [TorchEngine(cfg, device="cpu", dtype=torch.float32,
                           blocklist_path=None) for _ in range(2)]
    servers = [serve_in_thread(e, timeout_s=60) for e in engines]
    members = [HttpMember(f"h{i}", f"http://127.0.0.1:"
                          f"{srv.server_address[1]}", timeout_s=60,
                          poll_period_s=0.1)
               for i, srv in enumerate(servers)]
    router = FleetRouter(members, EngineConfig(**SETTINGS),
                         blocklist_path=None, probe_period_s=0.05,
                         eject_heartbeat_s=30.0, reprobe_backoff_s=0.2,
                         evac_grace_s=1.0, migrate_timeout_s=60.0)
    drained = {}

    def hook(eng, name):
        step = eng._loop_once

        def loop_once():
            step()
            if drained:
                return
            for req in eng.runtimes["test-tiny"].slot_req:
                if req is not None and len(req.generated_ids) >= 3 \
                        and _holds_bytes(req.generated_ids):
                    drained.update(member=name,
                                   at=len(req.generated_ids))
                    router.drain_replica(name)
                    # Hold the loop until the export call arrives: it
                    # then runs before the next decode step.
                    deadline = time.monotonic() + 60
                    while not eng._engine_calls \
                            and time.monotonic() < deadline:
                        time.sleep(0.002)
                    return

        eng._loop_once = loop_once

    for eng, mem in zip(engines, members):
        hook(eng, mem.name)
    router.start()
    try:
        req = router.enqueue_request(
            "m", "", "test-tiny", prompt_tokens=tok.encode(prompt),
            sampling=SamplingParams(max_tokens=32), raw_prompt=prompt)
        deadline = time.monotonic() + 60
        flight = None
        while flight is None and time.monotonic() < deadline:
            flight = next((f for f in list(router.flights) if f.req is req),
                          None)
        items = collect(req, timeout=120)
        assert items[-1].kind == "done"
        assert drained and drained["at"] == held[0]
        recs = router.journal.tail(None)
        migrated = [r for r in recs if r["kind"] == "migrate_import"]
        assert migrated and migrated[-1]["replica"] == drained["member"]
        assert migrated[-1]["tokens"] == held[0]
        assert router.failover_count == 0
        att = flight.attempt
        assert att.member.name != drained["member"]
        assert list(att.prior_ids) + list(att.token_ids) == want_ids
        assert "".join(i.text for i in items if i.kind == "token") \
            == want_text
        assert check_no_dropped_streams(recs) == []
    finally:
        router.stop()
        for srv in servers:
            stop_server(srv)
