"""The graph POA engine of the port (`--poa-engine graph`) against
svtrek_tpu, on the CPU: the plain DP `graph_dp_reference` against JAX's
`_graph_dp_batch` over the whole padded outputs, a numpy model of kernel
G1's decomposition (column strips, warp and block scans, the first-wins
stack, the end-row reduction, the one-thread walk over its code bytes, the
launch split) held to the plain DP, `align_batch` and
`consensus_sequence_poa_batch` against JAX and the scalar oracle, the
audt and disc pipelines against JAX's, and the dispatch.  Inputs come from
seeds (Python's `random` and numpy); everything is integer, tolerance 0."""
from __future__ import annotations

import io
import os
import random
import sys

import numpy as np
import pytest
import torch

from svtrek_tpu.config import AudtConfig, DiscConfig
from svtrek_tpu.ops import poa_graph_batch as jgb
from svtrek_tpu.pipeline import discover as jdisc
from svtrek_tpu.pipeline.audit import run_audit as jax_run_audit
from svtrek_tpu_torch import cli, kernels
from svtrek_tpu_torch.ops import poa_graph_batch as tgb
from svtrek_tpu_torch.ops import poa_graph_dp
from svtrek_tpu_torch.ops.poa import GAP, MATCH, MISMATCH, encode
from svtrek_tpu_torch.ops.poa_graph import (
    NEG, PoaGraph, consensus_sequence_poa,
)
from svtrek_tpu_torch.pipeline import audit as taudit
from svtrek_tpu_torch.pipeline import discover as tdisc
from tests.test_ins_consensus import build_fixture as build_ins_site
from tests.test_poa_graph import _rand_seq, _random_cluster
from tests.test_torch_discover import _disc_triple

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))

from ins_fixture import build_ins_fixture  # noqa: E402

INT32_MIN = -(1 << 31)
INT32_MAX = (1 << 31) - 1


def _grow(seqs: list[str]) -> PoaGraph:
    """A graph of seqs[0] with the others aligned in, as the consensus
    grows it."""
    g = PoaGraph()
    g.add_first(encode(seqs[0]))
    for s in seqs[1:]:
        q = encode(s)
        path, _ = g.align(q)
        g.add_alignment(q, path)
    return g


def _pairs(case: str):
    """(graphs, queries, P or None) of a seeded batch."""
    rng = random.Random(f"graph-{case}")
    if case in ("grown", "p_padding"):
        graphs, queries = [], []
        for _ in range(6):
            seqs = _random_cluster(rng, rng.randint(2, 4) + 1,
                                   rng.randint(40, 120), err=0.15)
            graphs.append(_grow(seqs[:-1]))
            queries.append(encode(seqs[-1]))
        # P padding: four times the slots the largest indegree needs.
        P = 4 * tgb._pow2(max(g.max_indegree() for g in graphs), 2) \
            if case == "p_padding" else None
        return graphs, queries, P
    seqs = _random_cluster(rng, 4, 60, err=0.15)
    g = _grow(seqs[:3])
    if case == "v1":
        return [_grow(["A"]), _grow(["G"]), g], \
            [encode(seqs[3]), encode("A"), encode("C")], None
    if case == "n1":
        return [g, g, g], [encode("A"), encode("T"), encode("N")], None
    if case == "query_n":
        return [g, _grow(["ACNNGT", "ACNGT"])], \
            [encode("N" * 30), encode("ACNNNGT")], None
    if case == "lengths":
        long_g = _grow(_random_cluster(rng, 2, 120, err=0.1))
        return [g, long_g], [encode(seqs[3] + _rand_seq(rng, 50)),
                             encode(_rand_seq(rng, 15))], None
    if case == "identical":
        s = _rand_seq(rng, 80)
        return [_grow([s, s]), _grow([s, s, s])], [encode(s), encode(s)], None
    raise ValueError(case)


CASES = ["grown", "p_padding", "v1", "n1", "query_n", "lengths", "identical"]


def _pack(graphs, queries, P=None):
    """align_batch's arrays (numpy) and static shapes."""
    P = P or tgb._pow2(max(max(g.max_indegree(), 1) for g in graphs), 2)
    Vmax = tgb._pow2(max(len(g.base) for g in graphs), 16)
    Nmax = tgb._pow2(max(len(q) for q in queries), 16)
    arrs = [g.to_arrays(Vmax, P) for g in graphs]
    qpad = np.full((len(queries), Nmax), 5, np.int8)
    for i, q in enumerate(queries):
        qpad[i, :len(q)] = q
    arrays = (np.stack([a["base_td"] for a in arrs]),
              np.stack([a["pred_rows"] for a in arrs]),
              np.stack([a["npred"] for a in arrs]),
              np.stack([a["is_sink"] for a in arrs]),
              np.array([a["V"] for a in arrs], np.int32), qpad,
              np.array([len(q) for q in queries], np.int32))
    return arrays, dict(P=P, Vmax=Vmax, Nmax=Nmax)


def _plain(arrays, shape):
    return [x.numpy() for x in poa_graph_dp.graph_dp_reference(
        *(torch.from_numpy(a) for a in arrays), **shape)]


@pytest.mark.parametrize("case", CASES)
def test_graph_dp_reference_matches_jax(case):
    graphs, queries, P = _pairs(case)
    arrays, shape = _pack(graphs, queries, P)
    want = [np.asarray(x) for x in jgb._graph_dp_batch(*arrays, **shape)]
    got = _plain(arrays, shape)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    if case == "p_padding":
        assert shape["P"] >= 8


# ------------------------- a model of kernel G1 ------------------------- #

def _g1_pair(arrays, b, P, Vmax, threads, warp, H, code):
    """G1's block on pair b, over its flat H and code cells: strips of S
    columns a thread, the 2P stack first-wins, the warp scans and the warps'
    totals, the end-row reduction, the walk.  Returns (score, matched,
    ins_after) of the pair."""
    base_td, pred_rows, npred, is_sink, Vs, qpad, ns = arrays
    V, n = int(Vs[b]), int(ns[b])
    W = n + 1
    S = -(-W // threads)
    strips = [range(t * S, min(t * S + S, W)) for t in range(threads)]
    q = qpad[b].tolist()
    for j in range(W):
        H[j] = GAP * j
    for i in range(1, V + 1):
        bi = int(base_td[b, i - 1])
        np_i = min(int(npred[b, i - 1]), P)
        prs = pred_rows[b, i - 1].tolist()
        best = [INT32_MIN] * W
        sel = [0] * W
        for cols in strips:
            for p in range(P):
                if p >= np_i:
                    for j in cols:
                        if NEG > best[j]:
                            best[j], sel[j] = NEG, 2 * p
                    continue
                row = prs[p] * W
                prev = H[row + cols[0] - 1] if len(cols) and cols[0] > 0 \
                    else 0
                for j in cols:
                    cur = H[row + j]
                    d = cur + GAP
                    dg = prev + (MATCH if q[j - 1] == bi else MISMATCH) \
                        if j > 0 else NEG + NEG
                    if d > best[j]:
                        best[j], sel[j] = d, 2 * p
                    if dg > best[j]:
                        best[j], sel[j] = dg, 2 * p + 1
                    prev = cur
        # Each thread's strip maximum, the warp's inclusive scan (shuffles
        # by 1, 2, 4, ...), the warps' totals, each thread's exclusive max.
        gmax = [max((best[j] - GAP * j for j in cols), default=INT32_MIN)
                for cols in strips]
        incl = []
        for w0 in range(0, threads, warp):
            lanes = gmax[w0:w0 + warp]
            d = 1
            while d < warp:
                lanes = [max(v, lanes[k - d]) if k >= d else v
                         for k, v in enumerate(lanes)]
                d *= 2
            incl += lanes
        totals = [incl[min(w0 + warp, threads) - 1]
                  for w0 in range(0, threads, warp)]
        for t, cols in enumerate(strips):
            run = incl[t - 1] if t % warp else INT32_MIN
            for w in range(t // warp):
                run = max(run, totals[w])
            for j in cols:
                left = (NEG if j == 0 else run) + GAP * j
                assert INT32_MIN <= left <= INT32_MAX
                if left > best[j]:
                    H[i * W + j], code[i * W + j] = left, 2
                else:
                    H[i * W + j] = best[j]
                    code[i * W + j] = ((sel[j] >> 1) << 2) | \
                        (0 if sel[j] & 1 else 1)
                run = max(run, best[j] - GAP * j)
    # The end row: per thread the rows t, t + threads, ...; the partials
    # combined by (larger value, then lower row).
    parts = []
    for t in range(threads):
        bv, br = INT32_MIN, INT32_MAX
        for r in range(t, Vmax, threads):
            v = H[(r + 1) * W + n] if r < V and is_sink[b, r] else NEG
            if v > bv:
                bv, br = v, r
        parts.append((bv, br))
    bv, br = parts[0]
    for v, r in parts[1:]:
        if v > bv or (v == bv and r < br):
            bv, br = v, r
    matched = np.zeros(Vmax, np.int8)
    ins_after = np.zeros(Vmax + 1, np.int32)
    i, j, steps = br + 1, n, 0
    while (i > 0 or j > 0) and steps <= V + n:
        steps += 1
        if i == 0:
            ins_after[0] += 1
            j -= 1
            continue
        cd = code[i * W + j]
        if cd & 3 == 2:
            ins_after[min(i, Vmax)] += 1
            j -= 1
            continue
        if cd & 3 == 0:
            matched[i - 1] = 1
            j -= 1
        i = int(pred_rows[b, i - 1, cd >> 2])
    return bv, matched, ins_after


def _g1_model(arrays, *, P, Vmax, Nmax, threads=128, warp=32,
              budget=kernels.GRAPH_SCRATCH_BYTES):
    """G1's launches as `kernels.poa_graph_dp_cuda` makes them: the pairs
    in runs under ``budget``, each run's pairs at their offsets in one flat
    H and one flat code buffer."""
    Vs, ns = arrays[4], arrays[6]
    B = len(Vs)
    score = np.empty(B, np.int32)
    matched = np.zeros((B, Vmax), np.int8)
    ins_after = np.zeros((B, Vmax + 1), np.int32)
    runs = kernels.poa_graph_chunks(
        [(int(v) + 1) * (int(n) + 1) for v, n in zip(Vs, ns)], budget)
    for b0, offsets in runs:
        H = [None] * offsets[-1]
        code = [None] * offsets[-1]
        for k in range(len(offsets) - 1):
            lo, hi = offsets[k], offsets[k + 1]
            h, c = H[lo:hi], code[lo:hi]
            score[b0 + k], matched[b0 + k], ins_after[b0 + k] = _g1_pair(
                arrays, b0 + k, P, Vmax, threads, warp, h, c)
            H[lo:hi], code[lo:hi] = h, c
    return [score, matched, ins_after], runs


@pytest.mark.parametrize("threads,warp", [(128, 32), (8, 4), (5, 1)])
@pytest.mark.parametrize("case", ["grown", "p_padding", "v1", "n1",
                                  "query_n", "identical"])
def test_g1_model_matches_plain(case, threads, warp):
    """G1's decomposition at its own block (128 threads, warps of 32) and
    at small ones whose strips hold several columns, in one launch and
    (at 8 threads) split over several, equals the plain DP (itself equal
    to JAX)."""
    graphs, queries, P = _pairs(case)
    arrays, shape = _pack(graphs, queries, P)
    cells = [(len(g.base) + 1) * (len(q) + 1)
             for g, q in zip(graphs, queries)]
    # At 8 threads, a budget that the largest pair fills alone.
    budget = 5 * max(cells) if threads == 8 else kernels.GRAPH_SCRATCH_BYTES
    got, runs = _g1_model(arrays, threads=threads, warp=warp, budget=budget,
                          **shape)
    assert (len(runs) >= 2) if threads == 8 else (len(runs) == 1)
    for g, w in zip(got, _plain(arrays, shape)):
        np.testing.assert_array_equal(g, w)


def test_launch_chunks():
    cells = [10, 20, 30, 40, 5, 1000, 1, 1]
    runs = kernels.poa_graph_chunks(cells, 5 * 60)
    assert runs == [(0, [0, 10, 30, 60]), (3, [0, 40, 45]), (5, [0, 1000]),
                    (6, [0, 1, 2])]
    assert kernels.poa_graph_chunks([], 100) == []


# ----------------------- align_batch and consensus ----------------------- #

def test_align_batch_matches_scalar_and_jax():
    rng = random.Random(5)
    graphs, queries, want = [], [], []
    for t in range(6):
        seqs = _random_cluster(rng, 4, 40 + 15 * t, err=0.15)
        g = _grow(seqs[:3])
        q = encode(seqs[3])
        path, score = g.align(q)
        want.append(([(v, j) for v, j in path if j is not None], score))
        graphs.append(g)
        queries.append(q)
    counts = {}
    paths, scores = tgb.align_batch(graphs, queries, counts=counts)
    jpaths, jscores = jgb.align_batch(graphs, queries)
    assert paths == jpaths
    np.testing.assert_array_equal(scores, np.asarray(jscores))
    assert [(p, int(s)) for p, s in zip(paths, scores)] == want
    assert counts == {"dp_calls": 1}


def _consensus_cases():
    rng = random.Random(1)
    clusters = [_random_cluster(rng, rng.randint(2, 8), rng.randint(30, 120),
                                err=0.12) for _ in range(10)]
    return clusters + [[], ["ACGT"]]


def test_consensus_batch_matches_jax_and_scalar():
    clusters = _consensus_cases()
    counts = {}
    got = tgb.consensus_sequence_poa_batch(clusters, device="cpu",
                                           counts=counts)
    assert got == jgb.consensus_sequence_poa_batch(clusters)
    assert got == [consensus_sequence_poa(c) for c in clusters]
    assert counts["graph_scalar"] == 0
    assert counts["dp_calls"] == max(len(c) for c in clusters) - 1


def test_consensus_over_n_cap_takes_the_scalar_route():
    """A member of N_CAP + 1 bases sends its cluster to the scalar POA (one
    alignment), in both packages."""
    rng = random.Random(3)
    long = _rand_seq(rng, tgb.N_CAP + 1)
    clusters = [[long, long[:500] + long[510:]],
                _random_cluster(rng, 3, 50, err=0.1)]
    counts = {}
    got = tgb.consensus_sequence_poa_batch(clusters, counts=counts)
    assert tgb.N_CAP == jgb.N_CAP
    assert got == jgb.consensus_sequence_poa_batch(clusters)
    assert got == [consensus_sequence_poa(c) for c in clusters]
    assert counts == {"dp_calls": 2, "graph_scalar": 1}


@pytest.mark.parametrize("cap,value", [("V_CAP", 60), ("P_CAP", 1)])
def test_consensus_graph_caps_take_the_scalar_route(monkeypatch, cap, value):
    """A graph past V_CAP nodes or P_CAP predecessors finishes on the
    scalar POA, with both modules' caps set small."""
    monkeypatch.setattr(tgb, cap, value)
    monkeypatch.setattr(jgb, cap, value)
    clusters = _consensus_cases()
    counts = {}
    got = tgb.consensus_sequence_poa_batch(clusters, counts=counts)
    assert got == jgb.consensus_sequence_poa_batch(clusters)
    assert got == [consensus_sequence_poa(c) for c in clusters]
    assert 0 < counts["graph_scalar"] < 10


# ------------------------------ pipelines ------------------------------ #

def _audit_both(bam, vcf):
    want = jax_run_audit(AudtConfig(bam_file=bam, vcf_file=vcf, data_shards=1,
                                    ins_consensus=True, poa_engine="graph"),
                         out=io.StringIO(), err=io.StringIO())
    err = io.StringIO()
    got = taudit.run_audit(AudtConfig(bam_file=bam, vcf_file=vcf,
                                      device="cpu", verbose=True,
                                      ins_consensus=True,
                                      poa_engine="graph"),
                           out=io.StringIO(), err=err)
    return want, got, err.getvalue()


# tests/test_ins_consensus.py's fixtures: (insert seed, length, depth,
# noisy, fixture seed)
INS_SITES = {"clean": (42, 80, 10, False, 0), "noisy": (7, 100, 10, True, 7),
             "depth2_na": (9, 64, 2, False, 9)}


@pytest.mark.parametrize("name", sorted(INS_SITES))
def test_run_audit_graph_matches_jax(tmp_path, name):
    iseed, length, depth, noisy, seed = INS_SITES[name]
    insert = _rand_seq(random.Random(iseed), length)
    bam, vcf = build_ins_site(str(tmp_path), insert, depth=depth,
                              noisy=noisy, seed=seed)
    want, got, err = _audit_both(bam, vcf)
    assert got == want and len(got) == 1
    if name == "clean":
        assert got[0].endswith(f"seq: {insert}")
        assert "graph_scalar=0" in err


def test_run_audit_graph_multi_site_matches_jax(tmp_path):
    """tools/ins_fixture.py's 24 sites (seed 3), the sites of at most 700
    bases (as chip_smoke.py's graph phase keeps them under N_CAP): every
    class below 700, a two-allele site."""
    bam, vcf, sites = build_ins_fixture(str(tmp_path), 24, seed=3)
    keep = [i for i, s in enumerate(sites) if s["length"] <= 700]
    with open(vcf) as fh:
        lines = fh.read().splitlines()
    head = [l for l in lines if l.startswith("#")]
    recs = [l for l in lines if not l.startswith("#")]
    sub = str(tmp_path / "sub.vcf")
    with open(sub, "w") as fh:
        fh.write("\n".join(head + [recs[i] for i in keep]) + "\n")
    want, got, err = _audit_both(bam, sub)
    assert got == want and len(got) == len(keep) >= 12
    assert any(sites[i]["alleles"] == 2 for i in keep)
    assert "graph_scalar=0" in err
    assert sum("seq: NA" not in l for l in got) >= 12


def test_run_discover_graph_matches_jax(tmp_path):
    gfa, gaf, fq = _disc_triple(tmp_path)
    cfg = dict(gfa_file=gfa, gaf_file=gaf, fq_file=fq, poa_engine="graph")
    want = jdisc.run_discover(DiscConfig(data_shards=1, **cfg),
                              out=io.StringIO(), err=io.StringIO())
    stats = {}
    got = tdisc.run_discover(DiscConfig(**cfg), out=io.StringIO(),
                             err=io.StringIO(), device="cpu", stats=stats)
    assert got == want and len(got) == 2 and "seq: NA" not in got[0]
    assert stats["dp_calls"] >= 1 and stats["graph_scalar"] == 0


# ------------------------------- dispatch ------------------------------- #

def test_graph_dp_dispatches_by_device():
    graphs, queries, _ = _pairs("grown")
    arrays, shape = _pack(graphs, queries)
    tensors = [torch.from_numpy(a) for a in arrays]
    before = poa_graph_dp.plain_calls["poa_graph_dp"]
    got = poa_graph_dp.graph_dp(*tensors, **shape)
    assert poa_graph_dp.plain_calls["poa_graph_dp"] == before + 1
    for g, w in zip(got, _plain(arrays, shape)):
        np.testing.assert_array_equal(g.numpy(), w)
    with pytest.raises(ValueError, match="takes CUDA tensors"):
        kernels.poa_graph_dp_cuda(*tensors, **shape)
    with pytest.raises(ValueError, match="no graph POA DP path"):
        poa_graph_dp.graph_dp(*(t.to("meta") for t in tensors), **shape)


def test_cli_graph_on_cuda_without_card_fails(tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible; this checks the refusal")
    insert = _rand_seq(random.Random(42), 80)
    bam, vcf = build_ins_site(str(tmp_path), insert)
    out = str(tmp_path / "out.txt")
    assert cli.main(["audt", "-b", bam, "-v", vcf, "-o", out,
                     "--ins-consensus", "--poa-engine", "graph"]) == 1
    assert "no CUDA device is visible" in capsys.readouterr().err
    assert not os.path.exists(out)
