"""Multi-process runs of the port (svtrek_tpu_torch.parallel.mesh): the
counterpart of tests/test_distributed.py.

Two processes, each with a mesh of 4 CPU shards, join one gloo process
group through `init_distributed` (a free local port, a 240 s limit each)
and run `sharded_consensus_step` and `sharded_disc_step` over their half of
a shared problem.  The parent assembles the rows from the shards' global
offsets and holds them equal to the JAX package's single-process results:
the consensus problem of tests/distributed_worker.py (B=16, seed 7), a
production-shaped one (B=512, K=16, the main path's width), and the disc
problem (seed 11, a cap of 8 a shard).  This file is its own worker:
``python tests/test_torch_distributed.py COORD NUM_PROCS PROC_ID OUT``.
"""
from __future__ import annotations

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
LOCAL_SHARDS = 4
DISC_CAP = 8
# (name, B, K, seed, spread) of the consensus problems: JAX's, whose
# candidates spread +-400 bp and mostly refine to NA, and one at the main
# path's width whose candidates cluster within +-4 bp.
CONSENSUS = [("demo", 16, 32, 7, 400), ("production", 512, 16, 2026, 4)]


def consensus_problem(B: int, K: int, seed: int, spread: int = 400):
    """tests/distributed_worker.py's consensus problem at any B, K and
    candidate spread."""
    rng = np.random.default_rng(seed)
    base = rng.integers(10_000, 1_000_000, B).astype(np.int64)
    counts = rng.integers(0, K + 1, B).astype(np.int32)
    locs = np.full((B, K), 0x7FFFFFFF, np.int32)
    for i in range(B):
        v = np.sort((base[i] + rng.integers(-spread, spread + 1,
                                            counts[i]))
                    .astype(np.int32))
        locs[i, : counts[i]] = v
    return locs, counts, base.astype(np.int32)


def worker(coord: str, nproc: int, pid: int, out_path: str) -> None:
    """One process: join the group, run both steps over this process's
    rows on 4 CPU shards, dump each shard's rows with their global
    index."""
    sys.path[:0] = [ROOT, HERE]
    import torch  # noqa: F401  (the port's dependency; JAX is not loaded)

    from distributed_worker import build_disc_problem
    from svtrek_tpu_torch.parallel.mesh import (
        init_distributed, make_global_array, make_mesh,
        sharded_consensus_step, sharded_disc_step,
    )

    n_global = init_distributed(coord, nproc, pid, backend="gloo",
                                local_shards=LOCAL_SHARDS)
    mesh = make_mesh(["cpu"], LOCAL_SHARDS)
    result = {"pid": pid, "global_shards": n_global}

    for name, B, K, seed, spread in CONSENSUS:
        rows = B // nproc
        lo = pid * rows
        g = [make_global_array(a[lo:lo + rows], mesh)
             for a in consensus_problem(B, K, seed, spread)]
        out = sharded_consensus_step(mesh, num_windows=rows)(*g)
        result[name] = [
            [off + k, int(v), int(o)]
            for off, (ref, ovf) in zip(g[0].offsets, out.shards)
            for k, (v, o) in enumerate(zip(ref.tolist(), ovf.tolist()))]

    d = build_disc_problem()
    rows = d[0].shape[0] // nproc
    lo = pid * rows
    g = [make_global_array(a[lo:lo + rows], mesh) for a in d]
    out = sharded_disc_step(mesh, min_len=50, cap=DISC_CAP)(*g)
    disc = []
    for off, (total, *res) in zip(g[0].offsets, out.shards):
        n = int(total[0])
        assert n <= DISC_CAP, n
        for k in range(n):
            r, t, ref, read, ln = (int(a[k]) for a in res)
            disc.append([off + r, t, ref, read, ln])
    result["disc"] = disc
    with open(out_path, "w") as fh:
        json.dump(result, fh)


if __name__ == "__main__":
    worker(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
    sys.exit(0)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def worker_data(tmp_path_factory):
    """Run the two workers once; every test reads their dumps."""
    tmp = tmp_path_factory.mktemp("torch_dist")
    coord = f"127.0.0.1:{_free_port()}"
    outs = [tmp / f"w{i}.json" for i in range(2)]
    env = dict(os.environ, PYTHONPATH=ROOT)
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), coord, "2", str(i),
         str(outs[i])], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for i in range(2)]
    logs = []
    for p in procs:
        try:
            so, se = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
                q.communicate()
            pytest.fail("a distributed worker timed out")
        logs.append((p.returncode, so, se))
    for rc, so, se in logs:
        assert rc == 0, f"worker rc={rc}\nstdout:\n{so}\nstderr:\n{se}"
    return [json.loads(o.read_text()) for o in outs]


def test_two_process_global_shard_count(worker_data):
    assert [w["global_shards"] for w in worker_data] == [8, 8]


@pytest.mark.parametrize("name,B,K,seed,spread", CONSENSUS)
def test_two_process_consensus(worker_data, name, B, K, seed, spread):
    """The assembled rows equal svtrek_tpu's single-process consensus."""
    from svtrek_tpu.ops.consensus import consensus_pos_batch

    rows = {}
    for w in worker_data:
        for idx, val, ovf in w[name]:
            assert idx not in rows
            rows[idx] = (val, ovf)
    refined, ovf = (np.asarray(x) for x in consensus_pos_batch(
        *consensus_problem(B, K, seed, spread)))
    assert sorted(rows) == list(range(B))
    assert [rows[i] for i in range(B)] == \
        list(zip(refined.tolist(), ovf.astype(int).tolist()))
    if name == "production":
        assert (refined >= 0).sum() > B // 2


def test_two_process_disc(worker_data):
    """The assembled breakpoint rows equal svtrek_tpu's single-process
    compact scan (tests/test_distributed.py's disc check)."""
    from distributed_worker import build_disc_problem

    from svtrek_tpu.ops.discover import scan_projected_runs_compact

    got = sorted(tuple(r) for w in worker_data for r in w["disc"])
    total, rows, types, refs, reads, lns = (
        np.asarray(x) for x in scan_projected_runs_compact(
            *build_disc_problem(), min_len=50, cap=64))
    want = sorted(zip(*(a[:int(total)].tolist()
                        for a in (rows, types, refs, reads, lns))))
    assert want
    assert got == want
