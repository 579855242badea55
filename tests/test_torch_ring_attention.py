"""The port's ring attention against the JAX package's, on the CPU: the
mirror of tests/test_ring_attention.py.

One gloo world per width (2 and 4 ranks, one compute thread each, every
rank running every case of its width) runs
parallel/ring_attention.py's ring_attention on its chunk of the same
numpy inputs, in float32; the test process computes the JAX
ring_attention under shard_map on the session's virtual CPU devices and
the port's plain causal attention on the whole sequence. Every valid
row (below seq_lens) of every rank's output is within 1e-5 of both.
Cases: GQA (4 query heads over 2 KV heads) and MHA, one full row and
one ragged (seq_lens < T), and query tiles smaller than a chunk. Each
rank also sees every K/V chunk exactly once, its own first, equal to
that chunk of the inputs, after sp - 1 hand-offs of K and V together.
"""

import os
import pickle
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ollamamq_tpu.parallel.mesh import make_mesh as jax_make_mesh
from ollamamq_tpu.parallel.ring_attention import ring_attention as jax_ring
from ollamamq_tpu_torch.ops.attention import causal_attention
from testutil import free_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-5, atol=1e-5)

# case -> (sp, B, T, H, Hk, hd, seq_lens, query tile)
CASES = {
    "sp2-gqa": (2, 2, 32, 4, 2, 16, (32, 19), 1024),
    "sp2-mha-tiled": (2, 2, 32, 4, 4, 16, (32, 9), 5),
    "sp4-gqa": (4, 2, 32, 4, 2, 16, (32, 19), 1024),
    "sp4-gqa-tiled": (4, 1, 48, 8, 2, 8, (41,), 4),
}

CHILD = r"""
import os, pickle, sys
rank, world, port, case_file, out_dir = (int(sys.argv[1]), int(sys.argv[2]),
                                         int(sys.argv[3]), sys.argv[4], sys.argv[5])
import torch
torch.set_num_threads(1)
from ollamamq_tpu_torch.parallel import distributed
from ollamamq_tpu_torch.parallel import ring_attention as ring
from ollamamq_tpu_torch.parallel.mesh import make_mesh

distributed.initialize(f"127.0.0.1:{port}", world, rank, devices=["cpu"] * world,
                       timeout_s=60)
mesh = make_mesh(sp=world, tp=1)
seq = mesh.seq
with open(case_file, "rb") as f:
    cases = pickle.load(f)
out = {}
for key, c in cases.items():
    q, k, v = (torch.from_numpy(c[n]) for n in ("q", "k", "v"))
    C = q.shape[1] // world
    lo = seq.index * C
    seen = []
    before = dict(seq.stats)
    ring.QUERY_TILE = c["tile"]
    res = ring.ring_attention(q[:, lo:lo + C], k[:, lo:lo + C], v[:, lo:lo + C],
                              torch.from_numpy(c["seq_lens"]), seq,
                              on_chunk=lambda j, kj, vj: seen.append(
                                  (j, kj.clone().numpy(), vj.clone().numpy())))
    out[key] = {"out": res.numpy(), "index": seq.index, "seen": seen,
                "stats": {n: seq.stats[n] - before[n] for n in seq.stats}}
with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
    pickle.dump(out, f)
distributed.exit_process(0)  # never through torch's teardown of live groups
"""


def _inputs(sp, B, T, H, Hk, hd, seq_lens, tile):
    rng = np.random.default_rng(T + H + sp)
    return {"q": rng.normal(size=(B, T, H, hd)).astype(np.float32),
            "k": rng.normal(size=(B, T, Hk, hd)).astype(np.float32),
            "v": rng.normal(size=(B, T, Hk, hd)).astype(np.float32),
            "seq_lens": np.asarray(seq_lens, np.int32), "tile": tile}


def _launch(world, cases, tmp):
    case_file = os.path.join(tmp, "cases.pkl")
    with open(case_file, "wb") as f:
        pickle.dump(cases, f)
    port = free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    logs = [open(os.path.join(tmp, f"r{r}.log"), "w") for r in range(world)]
    procs = [subprocess.Popen([sys.executable, "-c", CHILD, str(r), str(world),
                               str(port), case_file, tmp], cwd=REPO, env=env,
                              stdout=logs[r], stderr=subprocess.STDOUT)
             for r in range(world)]

    def wait():
        try:
            deadline = time.monotonic() + 180
            for p in procs:
                p.wait(timeout=max(1.0, deadline - time.monotonic()))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            for f in logs:
                f.close()
        for r, p in enumerate(procs):
            assert p.returncode == 0, open(os.path.join(tmp, f"r{r}.log")).read()[-3000:]
        outs = []
        for r in range(world):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                outs.append(pickle.load(f))
        return outs

    return wait


@pytest.fixture(scope="module")
def ring_runs(tmp_path_factory):
    """Every case's inputs, one world per width started at once, and the
    JAX ring and the plain attention computed while the worlds run."""
    cases = {key: _inputs(*args) for key, args in CASES.items()}
    by_world = {}
    for key, args in CASES.items():
        by_world.setdefault(args[0], {})[key] = cases[key]
    waits = {w: _launch(w, group, str(tmp_path_factory.mktemp(f"ring{w}")))
             for w, group in sorted(by_world.items())}
    refs = {}
    for key, c in cases.items():
        sp = CASES[key][0]
        mesh = jax_make_mesh(dp=1, sp=sp, tp=1, devices=jax.devices()[:sp])
        q, k, v, lens = (jnp.asarray(c[n]) for n in ("q", "k", "v", "seq_lens"))
        with jax.set_mesh(mesh):
            jout = np.asarray(jax_ring(q, k, v, lens, mesh))
        plain = causal_attention(*(torch.from_numpy(c[n]) for n in ("q", "k", "v")),
                                 torch.from_numpy(c["seq_lens"])).numpy()
        refs[key] = (jout, plain)
    return cases, refs, {w: wait() for w, wait in waits.items()}


@pytest.mark.parametrize("key", list(CASES))
def test_ring_matches_jax_ring_and_causal(key, ring_runs):
    """Every rank's valid rows within 1e-5 of the JAX ring and of plain
    causal attention over the whole sequence."""
    cases, refs, outs = ring_runs
    sp = CASES[key][0]
    jout, plain = refs[key]
    lens = cases[key]["seq_lens"]
    C = cases[key]["q"].shape[1] // sp
    got = np.zeros_like(jout)
    for o in outs[sp]:
        r = o[key]
        got[:, r["index"] * C:(r["index"] + 1) * C] = r["out"]
    for b, L in enumerate(lens):
        np.testing.assert_allclose(got[b, :L], jout[b, :L], **TOL)
        np.testing.assert_allclose(got[b, :L], plain[b, :L], **TOL)
    assert np.isfinite(got).all()


@pytest.mark.parametrize("sp", [2, 4])
def test_every_rank_sees_every_chunk_once(sp, ring_runs):
    """A rank holds its own chunk first, then the chunks before it around
    the ring, each equal to that chunk of the inputs: the prefill writes
    all of them into the rank's pages. sp - 1 hand-offs carry K and V
    together (the last rotation is skipped)."""
    cases, _, outs = ring_runs
    for key in (k for k, a in CASES.items() if a[0] == sp):
        c = cases[key]
        C = c["k"].shape[1] // sp
        for o in outs[sp]:
            r = o[key]
            idx = r["index"]
            assert [j for j, _, _ in r["seen"]] == [(idx - s) % sp for s in range(sp)]
            for j, kj, vj in r["seen"]:
                np.testing.assert_array_equal(kj, c["k"][:, j * C:(j + 1) * C])
                np.testing.assert_array_equal(vj, c["v"][:, j * C:(j + 1) * C])
            assert r["stats"]["handoffs"] == sp - 1
            assert r["stats"]["bytes"] == (sp - 1) * 2 * c["k"][:, :C].nbytes
