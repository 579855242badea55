"""The port's binding of the native fair-share core against the JAX
package's: both load the same cpp/libmqcore.so, so one seeded random
sequence of core operations (enqueue from several users and IPs,
next_window of 1-4, mark_done with tokens, VIP, boost, block/unblock of
users and IPs, unblock_item, reserve_req_ids, queue_len) over one MQCore
of each binding must give identical pops, return values and snapshot()s
after every operation, under request and token fairness."""

import random

import pytest

from ollamamq_tpu.core.mqcore import BlockedError as JaxBlocked
from ollamamq_tpu.core.mqcore import Fairness as JaxFairness
from ollamamq_tpu.core.mqcore import MQCore as JaxCore
from ollamamq_tpu_torch.core.mqcore import BlockedError, Fairness, MQCore

USERS = ["alice", "bob", "carol", "dave", "erin"]
IPS = ["10.0.0.1", "10.0.0.2", "10.0.0.3"]
MODELS = [None, "test-tiny", "llama3.2:1b"]


def _op(core, blocked_cls, name, args):
    """Run one operation; a BlockedError becomes a comparable value."""
    try:
        return getattr(core, name)(*args)
    except blocked_cls as e:
        return ("blocked", e.kind, e.item)


def _random_ops(rng, n):
    ops = []
    for _ in range(n):
        r = rng.random()
        user, ip = rng.choice(USERS), rng.choice(IPS)
        if r < 0.35:
            ops.append(("enqueue", (user, ip, rng.choice(MODELS))))
        elif r < 0.55:
            models = rng.choice([None, ["test-tiny"], ["test-tiny", "llama3.2:1b"]])
            ops.append(("next_window", (rng.randint(1, 4), models)))
        elif r < 0.65:
            ops.append(("mark_done", (user, rng.randint(0, 200))))
        elif r < 0.70:
            ops.append(("mark_started", (user,)))
        elif r < 0.74:
            ops.append(("set_vip", (rng.choice(USERS + [None]),)))
        elif r < 0.78:
            ops.append(("set_boost", (rng.choice(USERS + [None]),)))
        elif r < 0.81:
            ops.append(("block_user", (user,)))
        elif r < 0.84:
            ops.append(("unblock_user", (user,)))
        elif r < 0.86:
            ops.append(("block_ip", (ip,)))
        elif r < 0.88:
            ops.append(("unblock_ip", (ip,)))
        elif r < 0.91:
            ops.append(("unblock_item", (rng.choice(USERS + IPS),)))
        elif r < 0.93:
            ops.append(("reserve_req_ids", (rng.randint(1, 500),)))
        elif r < 0.97:
            ops.append(("queue_len", (user,)))
        else:
            ops.append(("mark_dropped", (user, rng.random() < 0.5)))
    return ops


@pytest.mark.parametrize("fairness", ["requests", "tokens"])
@pytest.mark.parametrize("seed", [0, 1])
def test_core_ops_match_jax_binding(tmp_path, fairness, seed):
    rng = random.Random(seed)
    jax_core = JaxCore(str(tmp_path / "jax_blocked.json"))
    port_core = MQCore(str(tmp_path / "port_blocked.json"))
    try:
        jax_core.set_fairness(getattr(JaxFairness, fairness.upper()))
        port_core.set_fairness(getattr(Fairness, fairness.upper()))
        ops = _random_ops(rng, 600)
        pops = 0
        for step, (name, args) in enumerate(ops):
            want = _op(jax_core, JaxBlocked, name, args)
            got = _op(port_core, BlockedError, name, args)
            assert got == want, f"op {step} {name}{args}: port {got} != jax {want}"
            if name == "next_window":
                pops += len(got[0])
            assert port_core.snapshot() == jax_core.snapshot(), f"op {step} {name}"
            assert port_core.total_queued() == jax_core.total_queued()
        assert pops > 50  # the sequence really exercised the pop order
        assert open(tmp_path / "port_blocked.json").read() == \
            open(tmp_path / "jax_blocked.json").read()
    finally:
        jax_core.close()
        port_core.close()


def test_fairness_modes_diverge_the_same_way():
    """Token fairness is not request fairness (tests/test_mqcore.py's
    token-fairness case): `a` was served one long request, `b` two short
    ones. Requests mode serves `a` first, tokens mode `b`, in both
    bindings."""
    orders = {}
    for label, make, fair in (("jax", JaxCore, JaxFairness), ("port", MQCore, Fairness)):
        for mode in ("REQUESTS", "TOKENS"):
            core = make(None)
            core.set_fairness(getattr(fair, mode))
            core.mark_done("a", tokens=1000)
            core.mark_done("b", tokens=10)
            core.mark_done("b", tokens=10)
            core.enqueue("a")
            core.enqueue("b")
            items, stuck = core.next_window(4)
            orders[label, mode] = ([u for _, u, _ in items], stuck)
            core.close()
    assert orders["port", "REQUESTS"] == orders["jax", "REQUESTS"] == (["a", "b"], False)
    assert orders["port", "TOKENS"] == orders["jax", "TOKENS"] == (["b", "a"], False)
