"""Fleet members wider than one rank (fleet/wide.py) against the JAX
package's fleets of TPUEngine members.

The JAX package serves a fleet member at any TP width in one process;
the port runs a member wider than one rank as an SPMDEngine leading a
rank world of its own (gloo on the CPU here), whose other ranks the
router's process starts and reaps. Through the CLI's own build_fleet
(test-tiny, float32, the JAX engine's seed-0 weights as a checkpoint):

  - `--replicas 2 --tp 2`: both members serve, each one's greedy ids
    equal TPUEngine's, the router's /metrics merges each member's rank 1
    snapshot once beside its own registry (rank 0 posts none), and a kill -9
    of one rank of r0 errors r0's streams within the heartbeat bound
    while r1's finish;
  - `--tiers "interactive@tp2=r0;bulk@tp1=r1,r2"`: r0 starts at tp 2 and
    takes the interactive class; a live regroup of r1 to tp 2 migrates
    its streams first, journals start/done with tp_from 1 / tp_to 2,
    serves TPUEngine's ids at tp 2, and a regroup back to tp 1 reaps the
    tp-2 world's ranks; a world that cannot start aborts the regroup
    with restart_failed and the member keeps its tier and engine;
  - `--tiers "interactive@tp2=r0;bulk@tp2=r1,r2"`: a drained tp-2
    member's hot restart starts a new world and reaps the old; a regroup
    whose new world cannot start restores the member's width on a new
    world (restart_failed, tier kept); when the restore cannot start
    either the router ejects the member, and a re-probe rebuilds it;
  - `--tp 2 --autoscale`: a scaled-up member runs at tp 2 and its retire
    reaps its ranks; `--pp 2 --replicas 2` serves a stream; under `--sp
    2 --replicas 2` each member's prompts past the largest prefill
    bucket take the sequence-parallel prefill and give TPUEngine's ids;
    `--ep 2 --replicas 2` on test-tiny-moe starts both members' worlds
    at ep 2 (half the experts a rank), both giving TPUEngine's ids;
    `--dp 2
    --tp 2 --replicas 2` validates; a host short of the cards a fleet
    needs exits 2 naming them.

Each fleet is built once per module (its rank worlds take seconds to
start); waits poll with budgets.
"""

import dataclasses
import os
import time

import numpy as np
import pytest
import torch

from ollamamq_tpu_torch import cli
from ollamamq_tpu_torch.config import MODEL_CONFIGS
from ollamamq_tpu_torch.engine.engine import TorchEngine
from ollamamq_tpu_torch.fleet import wide
from ollamamq_tpu_torch.ops.sampling import SamplingParams
from ollamamq_tpu_torch.tools.journal import (check_no_dropped_streams,
                                              check_regroup_pairing)
from test_torch_spmd import PROBE_KIND, assert_federated, federated_scrape
from testutil import collect

TINY = ["--model", "test-tiny", "--device", "cpu", "--dtype", "float32",
        "--max-slots", "4", "--num-pages", "64", "--page-size", "8",
        "--max-pages-per-seq", "8", "--decode-steps", "2", "--blocklist", ""]
PROMPTS = ["the cat sat on the mat the cat sat on the",
           "pack my box with five dozen liquor jugs",
           "how vexingly quick daft zebras jump",
           "sphinx of black quartz judge my vow"]
NEW = 12
# Heartbeats fast enough that a dead rank surfaces in seconds.
HB = {"OLLAMAMQ_SPMD_HB_EVERY": "0.5", "OLLAMAMQ_SPMD_HB_STALE": "3"}
KILL_BOUND_S = 3.0 + 12.0  # staleness + a loaded CPU's slack


@pytest.fixture(scope="module", autouse=True)
def _fast_heartbeats():
    old = {k: os.environ.get(k) for k in HB}
    os.environ.update(HB)
    torch.set_num_threads(2)
    yield
    for k, v in old.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """(checkpoint dir, {prompt: TPUEngine's greedy ids}): the JAX
    engine's seed-0 test-tiny weights written as a safetensors
    checkpoint, and its tp-1 ids for PROMPTS."""
    import jax
    import jax.numpy as jnp

    from ollamamq_tpu.config import EngineConfig as JaxEngineConfig
    from ollamamq_tpu.engine.engine import TPUEngine
    from ollamamq_tpu.ops.sampling import SamplingParams as JaxSampling
    from ollamamq_tpu_torch.models.weights import (from_jax_numpy,
                                                   save_safetensors)

    eng = TPUEngine(JaxEngineConfig(model="test-tiny", max_slots=4,
                                    num_pages=64, page_size=8,
                                    max_pages_per_seq=8,
                                    decode_steps_per_iter=2,
                                    prefill_buckets=(16, 32)),
                    models={"test-tiny": None}, blocklist_path=None,
                    dtype=jnp.float32)
    eng.start()
    try:
        tok = eng.runtimes["test-tiny"].tokenizer
        reqs = [eng.enqueue_request(f"j{i}", "", "test-tiny",
                                    prompt_tokens=tok.encode(p),
                                    sampling=JaxSampling(max_tokens=NEW,
                                                         temperature=0.0))
                for i, p in enumerate(PROMPTS)]
        for r in reqs:
            assert collect(r, timeout=240)[-1].kind == "done"
        ids = {p: list(r.generated_ids) for p, r in zip(PROMPTS, reqs)}
        pnp = jax.tree_util.tree_map(np.asarray,
                                     eng.runtimes["test-tiny"].params)
    finally:
        eng.stop()
    path = str(tmp_path_factory.mktemp("ckpt"))
    save_safetensors(from_jax_numpy(pnp, MODEL_CONFIGS["test-tiny"]),
                     MODEL_CONFIGS["test-tiny"], path)
    return path, ids


def _fleet(extra, ckpt, **ecfg):
    """The CLI's own fleet over `extra` flags (its EngineConfig with the
    `ecfg` fields replaced); one-rank members are TorchEngines on the
    CPU loading the same checkpoint."""
    args = cli.build_parser().parse_args(
        TINY + ["--checkpoints", f"test-tiny={ckpt}"] + extra)
    assert cli.validate(args) == ""

    def make(cfg):
        return TorchEngine(cfg, device="cpu", blocklist_path=None,
                           models=cli.model_table(args))

    router = cli.build_fleet(
        args, dataclasses.replace(cli.engine_config(args), **ecfg), make)
    router.start()
    return router


def _member(router, name):
    return next(m for m in router.members if m.name == name)


def _run(router, user, prompt, max_tokens=NEW, deadline_ms=None):
    tok = router.resolve_runtime("test-tiny").tokenizer
    sp = SamplingParams(max_tokens=max_tokens, temperature=0.0)
    if deadline_ms is not None:
        sp.deadline_ms = deadline_ms
    return router.enqueue_request(user, "", "test-tiny",
                                  prompt_tokens=tok.encode(prompt),
                                  sampling=sp, raw_prompt=prompt)


def _direct(engine, prompt, max_tokens=NEW):
    """Greedy ids of one stream served by a member's engine itself."""
    tok = engine.runtimes["test-tiny"].tokenizer
    req = engine.enqueue_request("direct", "", "test-tiny",
                                 prompt_tokens=tok.encode(prompt),
                                 sampling=SamplingParams(max_tokens=max_tokens,
                                                         temperature=0.0))
    assert collect(req, timeout=120)[-1].kind == "done"
    return list(req.generated_ids)


def _ids(items):
    return [i.token_id for i in items if i.kind == "token" and i.token_id >= 0]


def _wait(pred, budget=60.0, period=0.02):
    deadline = time.monotonic() + budget
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(period)
    return False


def _gone(pid: int) -> bool:
    try:
        with open(f"/proc/{pid}/status") as f:
            return "zombie" in f.read()
    except FileNotFoundError:
        return True


def _pids(member):
    return [p.pid for p in getattr(member.engine, "worker_procs", [])]


# ------------------------------------------------------ --replicas 2 --tp 2
# A member's rank 1 that counts itself once under the federation probe
# (test_torch_spmd.PROBE_KIND) before it runs as a rank.
PROBED_RANK = [wide.sys.executable, "-c",
               "from ollamamq_tpu_torch.telemetry import schema as tm\n"
               f"tm.JOURNAL_EVENTS_TOTAL.labels(kind={PROBE_KIND!r}).inc()\n"
               "import runpy\n"
               "runpy.run_module('ollamamq_tpu_torch.fleet.wide', "
               "run_name='__main__')\n"]


@pytest.fixture(scope="module")
def tp2_fleet(reference):
    argv, wide.WORKER_ARGV = wide.WORKER_ARGV, PROBED_RANK
    try:
        router = _fleet(["--replicas", "2", "--tp", "2"], reference[0])
        yield router
        router.stop()
    finally:
        wide.WORKER_ARGV = argv


def test_tp2_members_serve_the_reference_ids(tp2_fleet, reference):
    """Both members run at tp 2, each leading a world of two ranks, and
    every stream's greedy ids equal TPUEngine's, whichever member it
    landed on."""
    router = tp2_fleet
    assert [(m.name, m.tp) for m in router.members] == [("r0", 2), ("r1", 2)]
    assert all(len(_pids(m)) == 1 for m in router.members)
    assert all(m.engine.runtimes["test-tiny"].tp.size == 2
               for m in router.members)
    reqs = [_run(router, f"u{i}", p) for i, p in enumerate(PROMPTS)]
    results = [collect(r, timeout=120) for r in reqs]
    assert all(items[-1].kind == "done" for items in results)
    placed = {r["runtime"] for r in router.journal.tail(None, kind="place")}
    assert placed == {"r0", "r1"}, placed
    for p, items in zip(PROMPTS, results):
        assert _ids(items) == reference[1][p]
    for m in router.members:
        assert _direct(m.engine, PROMPTS[0]) == reference[1][PROMPTS[0]]
    assert check_no_dropped_streams(router.journal.tail(None)) == []
    # One scrape of the router merges each member's rank 1 once: rank 0
    # of each world records into the router's own registry and posts
    # nothing.
    assert len(router.worker_metric_snapshots()) == 2
    assert_federated(federated_scrape(
        router, [m.engine._plane for m in router.members]), 2)


def test_killed_rank_fails_only_its_members_streams(tp2_fleet):
    """kill -9 of r0's rank 1 while both members decode: r0's streams end
    with an error within the heartbeat bound, r0 is ejected, and r1's
    streams finish; stopping the fleet leaves no rank behind."""
    router = tp2_fleet
    r0, r1 = _member(router, "r0"), _member(router, "r1")
    pids = _pids(r0) + _pids(r1)
    on = {}
    for i in range(4):
        on[i] = (r0 if i % 2 == 0 else r1).engine.enqueue_request(
            f"k{i}", "", "test-tiny",
            prompt_tokens=r0.engine.runtimes["test-tiny"].tokenizer.encode(
                PROMPTS[i]),
            sampling=SamplingParams(max_tokens=400, temperature=0.0))
    assert _wait(lambda: all(len(r.generated_ids) >= 4 for r in on.values()))
    os.kill(_pids(r0)[0], 9)
    t0 = time.monotonic()
    ends = {}
    for i, r in on.items():
        items = collect(r, timeout=300)
        ends[i] = (items[-1].kind, time.monotonic() - t0)
    assert ends[0][0] == ends[2][0] == "error", ends
    assert max(ends[0][1], ends[2][1]) <= KILL_BOUND_S, ends
    assert ends[1][0] == ends[3][0] == "done", ends
    assert _wait(lambda: r0.state == "ejected", budget=30.0)
    assert r1.state == "healthy"
    router.stop()
    assert _wait(lambda: all(_gone(p) for p in pids), budget=30.0)


# ------------------------------------------------- tiers at tp 2 and tp 1
@pytest.fixture(scope="module")
def tiered(reference):
    # A TTFT objective no CPU run misses: no burn overflow crosses tiers.
    router = _fleet(["--replicas", "3", "--slo-ttft-ms", "600000",
                     "--tiers", "interactive@tp2=r0;bulk@tp1=r1,r2"],
                    reference[0])
    yield router
    router.stop()


def test_tier_width_starts_members_and_places_interactive_on_them(tiered):
    router = tiered
    assert [(m.name, m.tier, m.tp) for m in router.members] == [
        ("r0", "interactive", 2), ("r1", "bulk", 1), ("r2", "bulk", 1)]
    router.core.set_vip("vip")
    items = collect(_run(router, "vip", PROMPTS[1]), timeout=120)
    items2 = collect(_run(router, "late", PROMPTS[2], deadline_ms=600000),
                     timeout=120)
    assert items[-1].kind == items2[-1].kind == "done"
    places = [r for r in router.journal.tail(None, kind="tier_place")
              if r["user"] in ("vip", "late")]
    assert len(places) == 2
    assert all(r["tier"] == "interactive" and r["replica"] == "r0"
               for r in places), places


def test_live_regroup_to_tp2_and_back_reaps_the_world(tiered, reference):
    """r1 (bulk, tp 1) with live streams regroups to interactive@tp2: its
    streams migrate to r2 first, the journal pairs start/done with
    tp_from 1 / tp_to 2, r1 then serves TPUEngine's ids from a world of
    two ranks, and the regroup back to bulk@tp1 reaps that world."""
    router = tiered
    r1 = _member(router, "r1")
    reqs = [_run(router, f"b{i}", p, max_tokens=48)
            for i, p in enumerate(PROMPTS)]
    assert _wait(lambda: any(
        f.member is r1 and f.attempt is not None
        and f.attempt.req.generated_ids for f in list(router.flights)))
    on_r1 = sorted(f.user for f in list(router.flights) if f.member is r1)
    router.retier_replica("r1", "interactive", why="test")
    results = [collect(r, timeout=180) for r in reqs]
    assert all(items[-1].kind == "done" for items in results)
    assert _wait(lambda: r1.tier == "interactive" and r1.state == "healthy")
    recs = router.journal.tail(None)
    regroup = [r for r in recs if r["kind"] == "tier_regroup"]
    assert [r["phase"] for r in regroup] == ["start", "done"]
    assert regroup[0]["tp_from"] == 1 and regroup[0]["tp_to"] == 2
    assert regroup[1]["tp_to"] == 2 and r1.tp == 2
    migrated = [r for r in recs if r["kind"] == "migrate_import"
                and r.get("what") != "prefix"]
    assert sorted(r["user"] for r in migrated) == on_r1
    assert all(r["replica"] == "r1" and r["to_replica"] == "r2"
               for r in migrated)
    assert check_no_dropped_streams(recs) == []
    assert check_regroup_pairing(recs) == []
    (pid,) = _pids(r1)
    assert _direct(r1.engine, PROMPTS[3]) == reference[1][PROMPTS[3]]
    router.retier_replica("r1", "bulk", why="test")
    assert _wait(lambda: r1.tier == "bulk" and r1.state == "healthy"
                 and r1.tp == 1)
    assert _wait(lambda: _gone(pid), budget=30.0)
    assert _pids(r1) == []
    assert _direct(r1.engine, PROMPTS[3]) == reference[1][PROMPTS[3]]
    assert check_regroup_pairing(router.journal.tail(None)) == []


def test_world_that_cannot_start_aborts_with_restart_failed(tiered,
                                                            monkeypatch):
    """A rebuild whose rank exits before joining its world: the regroup
    aborts with restart_failed, the member keeps its tier and its old
    engine, no rank is left, and it serves a stream afterwards."""
    router = tiered
    r2 = _member(router, "r2")
    old = r2.engine
    monkeypatch.setattr(wide, "WORKER_ARGV",
                        [wide.sys.executable, "-c", "raise SystemExit(3)"])
    n0 = len(router.journal.tail(None, kind="tier_regroup"))
    router.retier_replica("r2", "interactive", why="test")
    assert _wait(lambda: any(
        r["phase"] == "aborted" for r in
        router.journal.tail(None, kind="tier_regroup")[n0:]))
    rec = router.journal.tail(None, kind="tier_regroup")[-1]
    assert rec["why"] == "restart_failed"
    assert _wait(lambda: r2.state == "healthy" and r2.alive())
    assert r2.tier == "bulk" and r2.retier_to is None and r2.tp == 1
    assert r2.engine is old
    assert check_regroup_pairing(router.journal.tail(None)) == []
    monkeypatch.undo()
    items = collect(_run(router, "after", PROMPTS[0]), timeout=120)
    assert items[-1].kind == "done"


# ------------------------------------------- tiers with every member at tp 2
@pytest.fixture(scope="module")
def tiered_tp2(reference):
    router = _fleet(["--replicas", "3", "--slo-ttft-ms", "600000",
                     "--tiers", "interactive@tp2=r0;bulk@tp2=r1,r2"],
                    reference[0])
    yield router
    router.stop()


def _fails_once(marker):
    """A rank command that exits before joining its world the first time
    it runs, and is a real rank after."""
    code = ("import os, runpy, sys\n"
            f"p = {str(marker)!r}\n"
            "if not os.path.exists(p):\n"
            "    open(p, 'w').close()\n"
            "    sys.exit(3)\n"
            "runpy.run_module('ollamamq_tpu_torch.fleet.wide', "
            "run_name='__main__')\n")
    return [wide.sys.executable, "-c", code]


def test_drain_rebuilds_a_wide_members_world(tiered_tp2, reference):
    """A drained tp-2 member's hot restart starts a new world (a world's
    stop releases its ranks): the old rank is reaped, and the member
    serves TPUEngine's ids again at tp 2."""
    router = tiered_tp2
    r1 = _member(router, "r1")
    (pid,) = _pids(r1)
    old = r1.engine
    router.drain_replica("r1")
    assert _wait(lambda: r1.engine is not old and r1.state == "healthy")
    assert _wait(lambda: _gone(pid), budget=30.0)
    (new,) = _pids(r1)
    assert new != pid and r1.tp == 2 and r1.tier == "bulk"
    assert any(r["replica"] == "r1" and r["why"] == "drain_complete"
               for r in router.journal.tail(None, kind="replica_join"))
    assert _direct(r1.engine, PROMPTS[0]) == reference[1][PROMPTS[0]]


def test_wide_regroup_whose_world_cannot_start_restores_its_width(
        tiered_tp2, reference, monkeypatch, tmp_path):
    """r2 (bulk@tp2) regroups while its new world's rank exits before
    joining: the regroup aborts with restart_failed, r2 keeps its tier,
    its old world's rank is reaped and it serves TPUEngine's ids from a
    new world at its width."""
    router = tiered_tp2
    r2 = _member(router, "r2")
    (pid,) = _pids(r2)
    marker = tmp_path / "failed-once"
    monkeypatch.setattr(wide, "WORKER_ARGV", _fails_once(marker))
    n0 = len(router.journal.tail(None, kind="tier_regroup"))
    router.retier_replica("r2", "interactive", why="test")
    assert _wait(lambda: any(
        r["phase"] == "aborted" for r in
        router.journal.tail(None, kind="tier_regroup")[n0:]))
    rec = router.journal.tail(None, kind="tier_regroup")[-1]
    assert rec["why"] == "restart_failed" and marker.exists()
    assert _wait(lambda: r2.state == "healthy" and r2.alive())
    assert r2.tier == "bulk" and r2.retier_to is None and r2.tp == 2
    assert _wait(lambda: _gone(pid), budget=30.0)
    (new,) = _pids(r2)
    assert new != pid
    assert not any(r["replica"] == "r2" for r in
                   router.journal.tail(None, kind="replica_eject"))
    assert check_regroup_pairing(router.journal.tail(None)) == []
    assert _direct(r2.engine, PROMPTS[1]) == reference[1][PROMPTS[1]]


def test_wide_member_whose_restore_fails_is_ejected_then_heals(
        tiered_tp2, reference, monkeypatch):
    """No world can start: r1's regroup aborts with restart_failed, its
    old engine cannot start again either, so the router ejects it (its
    old rank reaped, its tier kept); once worlds start again a re-probe
    rebuilds it at its width and it rejoins bulk."""
    router = tiered_tp2
    r1 = _member(router, "r1")
    (pid,) = _pids(r1)
    monkeypatch.setattr(wide, "WORKER_ARGV",
                        [wide.sys.executable, "-c", "raise SystemExit(3)"])
    n0 = len(router.journal.tail(None, kind="replica_eject"))
    router.retier_replica("r1", "interactive", why="test")
    assert _wait(lambda: len(router.journal.tail(
        None, kind="replica_eject")) > n0)
    eject = router.journal.tail(None, kind="replica_eject")[-1]
    assert eject["replica"] == "r1" and eject["why"] == "restart_failed"
    regroup = router.journal.tail(None, kind="tier_regroup")[-1]
    assert regroup["phase"] == "aborted"
    assert regroup["why"] == "restart_failed"
    assert r1.tier == "bulk" and r1.retier_to is None
    assert _wait(lambda: _gone(pid), budget=30.0)
    assert check_regroup_pairing(router.journal.tail(None)) == []
    monkeypatch.undo()
    assert _wait(lambda: r1.state == "healthy", budget=120.0)
    assert r1.tp == 2 and r1.tier == "bulk" and len(_pids(r1)) == 1
    assert any(r["replica"] == "r1" and r["why"] == "heal"
               for r in router.journal.tail(None, kind="replica_join"))
    assert _direct(r1.engine, PROMPTS[2]) == reference[1][PROMPTS[2]]


# ------------------------------------------------------ autoscale, pp, dp
def test_autoscaled_member_runs_at_tp2_and_retires_clean(reference):
    """A backlog deeper than the scaler's mark makes the LocalProvisioner
    build a member through the member factory at --tp 2: it leads a world
    of its own, serves, and its retire reaps its rank."""
    router = _fleet(["--replicas", "1", "--tp", "2", "--autoscale",
                     "--max-replicas", "2"], reference[0])
    try:
        sc = router.autoscaler
        sc.tick_period_s, sc.sustain_s, sc.cooldown_s = 0.02, 0.05, 0.2
        sc.backlog_high = 1
        reqs = [_run(router, f"s{i}", PROMPTS[i % 4], max_tokens=24)
                for i in range(10)]
        assert _wait(lambda: len(router.members) == 2, budget=120.0)
        sc.min_replicas = 2  # no idle retire behind the test's back
        new = router.members[-1]
        assert new.tp == 2 and len(_pids(new)) == 1
        (pid,) = _pids(new)
        assert all(collect(r, timeout=180)[-1].kind == "done" for r in reqs)
        scale = router.journal.tail(None, kind="scale_up")
        assert [r["phase"] for r in scale] == ["start", "done"]
        assert _direct(new.engine, PROMPTS[1]) == reference[1][PROMPTS[1]]
        router.retire_replica(new.name, why="test")
        assert _wait(lambda: len(router.members) == 1, budget=60.0)
        assert _wait(lambda: _gone(pid), budget=30.0)
    finally:
        router.stop()


def test_pp2_members_serve(reference):
    router = _fleet(["--replicas", "2", "--pp", "2"], reference[0])
    try:
        assert [m.engine.runtimes["test-tiny"].mesh.pp
                for m in router.members] == [2, 2]
        items = collect(_run(router, "pp", PROMPTS[2]), timeout=120)
        assert items[-1].kind == "done"
        assert _ids(items) == reference[1][PROMPTS[2]]
    finally:
        router.stop()


def test_sp2_members_serve_long_prompts(reference):
    """Each member leads a world of two sequence shards; with prefill
    buckets up to 32 every prompt here (36-42 tokens) prefills over the
    ring, on both members, and gives TPUEngine's ids."""
    router = _fleet(["--replicas", "2", "--sp", "2"], reference[0],
                    prefill_buckets=(16, 32))
    try:
        rts = [m.engine.runtimes["test-tiny"] for m in router.members]
        assert [rt.mesh.sp for rt in rts] == [2, 2]
        reqs = [_run(router, f"sp{i}", p) for i, p in enumerate(PROMPTS)]
        for p, r in zip(PROMPTS, reqs):
            items = collect(r, timeout=120)
            assert items[-1].kind == "done"
            assert _ids(items) == reference[1][p]
        assert sum(rt.sp_prefill_dispatches for rt in rts) == len(PROMPTS)
        assert all(rt.sp_prefill_dispatches > 0 for rt in rts)
    finally:
        router.stop()


def test_ep2_members_serve_moe(tmp_path_factory):
    """`--ep 2 --replicas 2` on test-tiny-moe: each member leads a world
    of two expert ranks (half of every layer's experts a rank), and a
    stream on each member gives TPUEngine's greedy ids."""
    import jax
    import jax.numpy as jnp

    from ollamamq_tpu.config import EngineConfig as JaxEngineConfig
    from ollamamq_tpu.engine.engine import TPUEngine
    from ollamamq_tpu.ops.sampling import SamplingParams as JaxSampling
    from ollamamq_tpu_torch.models.weights import (from_jax_numpy,
                                                   save_safetensors)

    moe = "test-tiny-moe"
    eng = TPUEngine(JaxEngineConfig(model=moe, max_slots=4, num_pages=64,
                                    page_size=8, max_pages_per_seq=8,
                                    decode_steps_per_iter=2),
                    models={moe: None}, blocklist_path=None, dtype=jnp.float32)
    eng.start()
    try:
        tok = eng.runtimes[moe].tokenizer
        r = eng.enqueue_request("j", "", moe, prompt_tokens=tok.encode(PROMPTS[1]),
                                sampling=JaxSampling(max_tokens=NEW,
                                                     temperature=0.0))
        assert collect(r, timeout=240)[-1].kind == "done"
        want = list(r.generated_ids)
        pnp = jax.tree_util.tree_map(np.asarray, eng.runtimes[moe].params)
    finally:
        eng.stop()
    ckpt = str(tmp_path_factory.mktemp("moe"))
    save_safetensors(from_jax_numpy(pnp, MODEL_CONFIGS[moe]), MODEL_CONFIGS[moe],
                     ckpt)
    args = cli.build_parser().parse_args(
        TINY + ["--model", moe, "--checkpoints", f"{moe}={ckpt}",
                "--replicas", "2", "--ep", "2"])
    assert cli.validate(args) == ""
    router = cli.build_fleet(args, cli.engine_config(args), None)
    router.start()
    try:
        rts = [m.engine.runtimes[moe] for m in router.members]
        assert [(rt.mesh.ep, rt._ep) for rt in rts] == [(2, 2), (2, 2)]
        E = MODEL_CONFIGS[moe].num_experts
        assert [rt.params["layers"][0]["we_gate"].shape[0] for rt in rts] \
            == [E // 2] * 2
        assert [len(_pids(m)) for m in router.members] == [1, 1]
        tok = router.resolve_runtime(moe).tokenizer
        reqs = [router.enqueue_request(f"ep{i}", "", moe,
                                       prompt_tokens=tok.encode(PROMPTS[1]),
                                       sampling=SamplingParams(max_tokens=NEW,
                                                               temperature=0.0),
                                       raw_prompt=PROMPTS[1])
                for i in range(2)]
        for r in reqs:
            items = collect(r, timeout=120)
            assert items[-1].kind == "done"
            assert _ids(items) == want
        assert all(rt.tokens_generated > 0 for rt in rts)
    finally:
        router.stop()


@pytest.mark.parametrize("argv,widths", [
    (["--replicas", "2", "--dp", "2", "--tp", "2"], {"r0": 2, "r1": 2}),
    (["--replicas", "2", "--pp", "2", "--replica-urls", "http://127.0.0.1:1"],
     {"r0": 1, "r1": 1}),
    (["--replicas", "3", "--tiers", "interactive@tp2=r0;bulk=r1,r2"],
     {"r0": 2, "r1": 1, "r2": 1}),
], ids=["dp-tp-fleet", "pp-fleet-urls", "tier-width"])
def test_wide_fleets_validate(argv, widths):
    args = cli.build_parser().parse_args(TINY + argv)
    assert cli.validate(args) == ""
    assert cli.member_widths(args) == widths


def test_fleet_short_of_cards_exits_2_naming_them(caplog):
    """On cards, every member holds cards of its own: two tp-2 members
    need four, and a host with fewer exits 2 naming the missing ones."""
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    n = max(2, have)  # members x tp 2 > have
    argv = ["--model", "test-tiny", "--replicas", str(n), "--tp", "2",
            "--no-tui"]
    assert cli.main(argv) == 2
    assert f"cuda:{have}" in caplog.text
    assert "no member falls back to a shared or smaller set" in caplog.text


def test_card_plan_hands_out_disjoint_cards():
    plan = wide.CardPlan(["cuda:0", "cuda:1", "cuda:2", "cuda:3"])
    assert plan.take("r0", 2) == ["cuda:0", "cuda:1"]
    assert plan.take("r1", 1) == ["cuda:2"]
    with pytest.raises(RuntimeError, match="cuda:4"):
        plan.take("r1", 3)  # r1 keeps cuda:2; cuda:0-1 are r0's
    assert plan.holding("r1") == [2]
    # A rank world takes any free cards, its own among them; in-process
    # replicas need theirs in a row.
    plan.release("r0")
    assert plan.take("r0", 1) == ["cuda:0"]
    with pytest.raises(RuntimeError, match="cuda:4"):
        plan.take("r3", 2, in_a_row=True)  # cuda:1 and cuda:3 are free
    assert plan.take("r3", 2) == ["cuda:1", "cuda:3"]
    with pytest.raises(RuntimeError, match="cuda:4"):
        plan.take("r1", 2)  # only its own cuda:2 is free for it
    assert plan.holding("r1") == [2]
    shared = wide.CardPlan(["cuda:0"] * 4, backend="gloo")
    assert shared.take("r0", 2) == ["cuda:0", "cuda:0"]
    assert wide.CardPlan(device="cpu").take("r9", 3) == ["cpu"] * 3
