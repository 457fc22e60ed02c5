"""The graph POA engine of the port (`--poa-engine graph`) against
svtrek_tpu, on the CPU: the plain DP `graph_dp_reference` against JAX's
`_graph_dp_batch` over the whole padded outputs, a numpy model of kernel
G1's decomposition (a warp per pair: column tiles with the carried warp
scan, the first-wins stack as a max over packed keys, the shared ring of
recent rows, its depth from the launch's longest query, and the rows kept
in global H, the end-row reduction, the one-byte slot codes and the walk
in runs, the launch split) held to the plain DP at the kernel's sizes, at
small ones, past the JAX package's routing caps and past G1's earlier
ones (n past 4,096, V past 16,384), G1's shared memory at its caps,
`align_batch` and
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

def _g1_pair(arrays, b, P, Vmax, lanes, strip, ring, H, code):
    """G1's warp on pair b, over its flat H (int32) and code (uint8) cells
    (rows of `kernels.graph_row_cells(n)`): row tiles of lanes x strip
    columns, a lane's strip maximum, the warp's log-step scan carried from
    tile to tile, the first-wins stack, predecessors within ring - 1 rows
    read from a ring of ``ring`` rows (slot i & (ring - 1)) and older ones
    from H, the end-row reduction, and the walk in runs of ``lanes``
    guessed cells over the one-byte codes (slot * 4 + move), each lane
    loading its cell's code and then the predecessor row its slot names.
    Returns (score, matched, ins_after, walk rounds) of the pair."""
    base_td, pred_rows, npred, is_sink, Vs, qpad, ns = arrays
    V, n = int(Vs[b]), int(ns[b])
    W = n + 1
    Wg = kernels.graph_row_cells(n)
    T = lanes * strip
    scan_id = 2 * NEG
    assert ring & (ring - 1) == 0 and ring >= 2
    # qsh[j] = q[j-1]; column 0 and the columns past n never match.
    qsh = np.full(Wg, -2, np.int64)
    qsh[1:W] = qpad[b, :n]
    rows = np.zeros((ring, Wg), np.int64)
    rows[0] = GAP * np.arange(Wg)
    H[:Wg] = rows[0]
    lane = np.arange(lanes)
    # The rows a later row reads from H (ring - 1 rows back or more): only
    # they go to H whole; of the others only column n (the end row's).
    need = np.zeros(V + 1, bool)
    for r in range(V):
        for pr in pred_rows[b, r, :min(int(npred[b, r]), P)]:
            if r + 1 - pr >= ring:
                need[pr] = True
    for i in range(1, V + 1):
        bi = int(base_td[b, i - 1])
        np_i = min(int(npred[b, i - 1]), P)
        assert np_i >= 1  # the wrapper refuses a row without a predecessor
        prs = [int(x) for x in pred_rows[b, i - 1]]
        carry = scan_id
        for t0 in range(0, W, T):
            j = t0 + np.arange(T)
            live = j < Wg            # the strips of active lanes
            jl = np.minimum(j, Wg - 1)
            sub = np.where(qsh[jl] == bi, MATCH, MISMATCH)
            # The stack's first maximum as one max over keys value * 64 +
            # (63 - rank), rank 2p for del_p and 2p + 1 for diag_p; diag_p's
            # key is del_p's key of the column before plus a column term.
            subk = np.where(j == 0, 0, sub * 64 - 1 - GAP * 64)
            key = np.full(T, INT32_MIN, np.int64)
            for p in range(np_i):
                pr = prs[p]
                src = rows[pr & (ring - 1)] if i - pr < ring \
                    else H[pr * Wg:(pr + 1) * Wg].astype(np.int64)
                cur = np.where(live, src[jl], 0)
                keyd = cur * 64 + GAP * 64 + 63 - 2 * p
                prev = int(src[t0 - 1]) * 64 + GAP * 64 + 63 - 2 * p if t0 \
                    else INT32_MIN // 2     # column 0's diag never wins
                keyg = np.concatenate([[prev], keyd[:-1]]) + subk
                key = np.maximum(key, np.maximum(keyd, keyg))
            # The keys' range at G1's caps: |value| < 2^19, a key < 2^25.
            assert np.abs(key).max() < 1 << 25
            best = key >> 6
            rank = 63 - (key & 63)
            cd = (rank >> 1) << 2 | (1 - (rank & 1))   # slot * 4 + move
            # Each lane's strip maximum, the warp's inclusive scan (shifts
            # by 1, 2, 4, ...), the exclusive prefix with the carry, then the
            # in-strip pass.
            # Columns past n come after every valid one: unmasked.
            g = (best - GAP * j).reshape(lanes, strip)
            incl = g.max(1)
            d = 1
            while d < lanes:
                incl = np.where(lane >= d, np.maximum(incl, np.roll(incl, d)),
                                incl)
                d *= 2
            run0 = np.maximum(np.concatenate([[scan_id], incl[:-1]]), carry)
            carry = max(carry, int(incl[-1]))
            excl = np.maximum.accumulate(
                np.concatenate([run0[:, None], g[:, :-1]], 1), 1).reshape(T)
            bc = best
            left = np.where(j == 0, NEG, excl) + GAP * j
            assert left.min() >= INT32_MIN
            use_ins = left > bc
            hv = np.where(use_ins, left, bc)
            cv = np.where(use_ins, 2, cd)
            m = live
            assert cv[m].max() < 1 << 8
            rows[i & (ring - 1), j[m]] = hv[m]
            hm = m if need[i] else m & (j == n)
            H[i * Wg + j[hm]] = hv[hm]
            code[(i - 1) * Wg + j[m]] = cv[m]
    # The end row: per lane the rows lane, lane + lanes, ...; the partials
    # combined by (larger value, then lower row).
    bv, br = INT32_MIN, INT32_MAX
    for t in range(lanes):
        for r in range(t, V, lanes):
            v = H[(r + 1) * Wg + n] if is_sink[b, r] else NEG
            if v > bv or (v == bv and r < br):
                bv, br = v, r
    matched = np.zeros(Vmax, np.int8)
    ins_after = np.zeros(Vmax + 1, np.int32)

    def cell_code(i, j):  # row 0: a virtual ins move
        return 2 if i == 0 else int(code[(i - 1) * Wg + j])

    def nxt(i, j, c):  # the second load: the slot's predecessor row
        if c & 3 == 2 or i == 0:
            return i, j - 1
        return int(pred_rows[b, i - 1, c >> 2]), j if c & 3 == 1 else j - 1

    def move(i, c, k=1):
        if c & 3 == 0:
            matched[i - 1] = 1
        elif c & 3 == 2:
            ins_after[min(i, Vmax)] += k

    limit = V + n + 1
    i, j = br + 1, n
    c = cell_code(i, j)
    i0, j0 = nxt(i, j, c)
    steps = rounds = 0
    while (i > 0 or j > 0) and steps < limit:
        move(i, c)
        steps += 1
        if (i0, j0) == (0, 0) or steps >= limit:
            break
        di, dj = int(c & 3 != 2), int(c & 3 != 1)
        rounds += 1
        gi, gj = i0 - di * lane, j0 - dj * lane
        ok = (gi >= 0) & (gj >= 0)
        gc = [cell_code(a, e) if k else 2 for a, e, k in zip(gi, gj, ok)]
        nx = [nxt(a, e, g) if k else (a, e - 1)
              for a, e, g, k in zip(gi, gj, gc, ok)]
        link = [bool(ok[k]) and (gi[k], gj[k]) != (0, 0) and k < lanes - 1
                and nx[k] == (gi[k] - di, gj[k] - dj)
                and gi[k] - di >= 0 and gj[k] - dj >= 0
                for k in range(lanes)]
        L = link.index(False)
        nap = min(L, limit - steps)
        for k in range(nap) if c & 3 == 0 else ():
            matched[gi[k] - 1] = 1
        if c & 3 == 2 and nap:
            move(i0, c, nap)
        steps += nap
        i, j, c = int(gi[nap]), int(gj[nap]), gc[nap]
        i0, j0 = nx[nap]
    return bv, matched, ins_after, rounds


def _g1_model(arrays, *, P, Vmax, Nmax, lanes=32, strip=32, ring=None,
              budget=kernels.GRAPH_SCRATCH_BYTES):
    """G1's launches as `kernels.poa_graph_dp_cuda` makes them: the pairs
    in runs under ``budget``, each run's pairs at their offsets in one flat
    H and one flat code buffer, its ring of ``ring`` rows or, by default,
    of `kernels.graph_ring_rows` of the run's longest query."""
    Vs, ns = arrays[4], arrays[6]
    B = len(Vs)
    score = np.empty(B, np.int32)
    matched = np.zeros((B, Vmax), np.int8)
    ins_after = np.zeros((B, Vmax + 1), np.int32)
    rounds = []
    runs = kernels.poa_graph_chunks(
        [(int(v) + 1) * kernels.graph_row_cells(int(n))
         for v, n in zip(Vs, ns)], budget)
    for b0, offsets in runs:
        count = len(offsets) - 1
        R = ring or kernels.graph_ring_rows(int(ns[b0:b0 + count].max()))
        H = np.zeros(offsets[-1], np.int32)
        code = np.zeros(offsets[-1], np.uint8)
        for k in range(count):
            lo, hi = offsets[k], offsets[k + 1]
            score[b0 + k], matched[b0 + k], ins_after[b0 + k], r = _g1_pair(
                arrays, b0 + k, P, Vmax, lanes, strip, R, H[lo:hi],
                code[lo:hi])
            rounds.append(r)
    return [score, matched, ins_after], runs, rounds


# (lanes, columns a lane, ring rows): the kernel's own at its deepest ring,
# small ones whose tiles, ring eviction and walk runs all show on the test
# batches, and the kernel's own with the ring of the launch's longest query
# (None: `kernels.graph_ring_rows`).
G1_SIZES = [(32, 32, 8), (4, 2, 2), (8, 1, 4), (32, 32, None)]


@pytest.mark.parametrize("lanes,strip,ring", G1_SIZES)
@pytest.mark.parametrize("case", ["grown", "p_padding", "v1", "n1",
                                  "query_n", "identical"])
def test_g1_model_matches_plain(case, lanes, strip, ring):
    """G1's decomposition at its own sizes (a warp of 32 lanes, 32 columns
    a lane, a ring of 8 rows) and at small ones whose rows span several
    tiles and whose predecessors leave the ring, in one launch and (at 4
    lanes) split over several, equals the plain DP (itself equal to
    JAX)."""
    graphs, queries, P = _pairs(case)
    arrays, shape = _pack(graphs, queries, P)
    cells = [(len(g.base) + 1) * kernels.graph_row_cells(len(q))
             for g, q in zip(graphs, queries)]
    split = lanes == 4
    budget = kernels.GRAPH_CELL_BYTES * max(cells) if split \
        else kernels.GRAPH_SCRATCH_BYTES
    got, runs, rounds = _g1_model(arrays, lanes=lanes, strip=strip,
                                  ring=ring, budget=budget, **shape)
    assert (len(runs) >= 2) if split else (len(runs) == 1)
    for g, w in zip(got, _plain(arrays, shape)):
        np.testing.assert_array_equal(g, w)
    if case == "grown":
        # The walk takes runs: fewer rounds than moves.
        moves = [int(w.sum()) + int(n) for w, n in
                 zip(got[1], arrays[6])]
        assert sum(rounds) < sum(moves) // 2


def _past_caps_pair():
    """A two-allele graph past the JAX package's routing caps, at a size
    the CPU can align: two chains of 1,100 nodes from the virtual start
    (V 2,200 > its V_CAP, the second chain's first predecessor 1,101 rows
    back), and a mutated copy of the second allele (n about 1,100 > its
    N_CAP)."""
    rng = np.random.default_rng(8)
    a = rng.integers(0, 4, 1100).astype(np.int8)
    other = rng.integers(0, 4, 1100).astype(np.int8)
    g = PoaGraph()
    g.add_first(a)
    g.add_alignment(other, [(None, j) for j in range(len(other))])
    from ins_fixture import mutate
    q = mutate(rng, other).astype(np.int8)
    return g, q


def test_g1_model_past_routing_caps():
    """A pair past the JAX package's V_CAP and N_CAP, which the port
    batches: the plain DP equals JAX's `_graph_dp_batch` and the scalar
    `PoaGraph.align`, and G1's model at its own sizes equals the plain
    DP."""
    g, q = _past_caps_pair()
    assert len(g.base) > jgb.V_CAP and len(q) > jgb.N_CAP
    assert len(g.base) <= tgb.V_CAP == kernels.GRAPH_V_CAP
    assert len(q) <= kernels.GRAPH_N_CAP
    arrays, shape = _pack([g], [q])
    want = _plain(arrays, shape)
    for x, y in zip(want, jgb._graph_dp_batch(*arrays, **shape)):
        np.testing.assert_array_equal(x, np.asarray(y))
    path, score = g.align(q)
    arrs = g.to_arrays(shape["Vmax"], shape["P"])
    assert int(want[0][0]) == score
    assert tgb.path_from_device(arrs, want[1][0], want[2][0], q) == \
        [(v, j) for v, j in path if j is not None]
    got, _, _ = _g1_model(arrays, **shape)
    for x, w in zip(got, want):
        np.testing.assert_array_equal(x, w)


def _copy_with_path(rng, seq):
    """A mutated copy of ``seq`` (base codes of a graph's first sequence,
    nodes 0 .. len - 1) and its add_alignment path, without a DP: 3 %
    substitutions (ring nodes), deletions of 1-12 bases at 1 % (skip
    edges, predecessors up to 13 rows back) and insertions at 1 %."""
    q, path = [], []
    k = 0
    while k < len(seq):
        r = rng.random()
        if r < 0.01:
            k += int(rng.integers(1, 13))
            continue
        b = int(seq[k]) if r >= 0.04 else (int(seq[k]) +
                                           int(rng.integers(1, 4))) % 4
        path.append((k, len(q)))
        q.append(b)
        if rng.random() < 0.01:
            path.append((None, len(q)))
            q.append(int(rng.integers(0, 4)))
        k += 1
    return np.array(q, np.int8), path


def _past_g1_n_cap_pair():
    """A query of 4,150-4,300 bases (a mutated copy of a 4,200-base
    insert), past G1's earlier cap of 4,096, against a graph of two
    mutated copies of the insert."""
    from ins_fixture import mutate

    rng = np.random.default_rng(41)
    truth = rng.integers(0, 4, 4200)
    first = mutate(rng, truth).astype(np.int8)
    g = PoaGraph()
    g.add_first(first)
    g.add_alignment(*_copy_with_path(rng, first))
    q = mutate(rng, truth).astype(np.int8)
    assert 4150 <= len(q) <= 4300 and g.max_indegree() >= 2
    return g, q


def _past_g1_v_cap_pair():
    """A graph of more than 16,384 nodes, G1's earlier cap: two alleles of
    8,300 bases (the second all insertions, its source 8,301 rows after
    the virtual start), substitution bubbles and skip edges on the first;
    and a query of 48 bases, a mutated copy of the second allele's end."""
    from ins_fixture import mutate

    rng = np.random.default_rng(43)
    a, other = (rng.integers(0, 4, 8300).astype(np.int8) for _ in range(2))
    g = PoaGraph()
    g.add_first(a)
    g.add_alignment(*_copy_with_path(rng, a))
    g.add_alignment(other, [(None, j) for j in range(len(other))])
    q = mutate(rng, other[-46:]).astype(np.int8)
    assert len(g.base) > 16384 and 32 <= len(q) <= 64
    return g, q


@pytest.mark.parametrize("pair", ["n_past_4096", "v_past_16384"])
def test_g1_past_its_earlier_caps(pair):
    """A pair past G1's earlier caps (n 4,096, V 16,384), within its own:
    the plain DP equals JAX's `_graph_dp_batch` (score, matched,
    ins_after), its path JAX's `align_batch`'s, and G1's model at the
    kernel's sizes, its ring from the query's length, equals the plain
    DP."""
    g, q = _past_g1_n_cap_pair() if pair == "n_past_4096" \
        else _past_g1_v_cap_pair()
    assert len(g.base) <= kernels.GRAPH_V_CAP and \
        len(q) <= kernels.GRAPH_N_CAP
    assert len(q) > 4096 if pair == "n_past_4096" else len(g.base) > 16384
    arrays, shape = _pack([g], [q])
    want = _plain(arrays, shape)
    for x, y in zip(want, jgb._graph_dp_batch(*arrays, **shape)):
        np.testing.assert_array_equal(x, np.asarray(y))
    paths, scores = tgb.align_batch([g], [q])
    jpaths, jscores = jgb.align_batch([g], [q])
    assert paths == jpaths and int(scores[0]) == int(jscores[0]) == \
        int(want[0][0])
    got, runs, rounds = _g1_model(arrays, **shape)
    assert len(runs) == 1 and rounds[0] < (len(g.base) + len(q)) // 4
    for x, w in zip(got, want):
        np.testing.assert_array_equal(x, w)


def _long_cluster():
    """Three mutated copies of a 4,200-base insert, past G1's earlier
    cap of 4,096 bases."""
    from tests.test_poa_graph import _mutate

    rng = random.Random(47)
    truth = _rand_seq(rng, 4200)
    cluster = [_mutate(rng, truth, 0.03) for _ in range(3)]
    assert all(4096 < len(s) <= tgb.N_CAP for s in cluster)
    return cluster


def _jax_at_port_caps(monkeypatch):
    """The JAX package's graph caps raised to the port's (set on the
    module, its source unchanged), so that it runs its own exact DP
    where it would take its scalar route."""
    monkeypatch.setattr(jgb, "N_CAP", tgb.N_CAP)
    monkeypatch.setattr(jgb, "V_CAP", tgb.V_CAP)


def test_consensus_past_g1_n_cap_batches(monkeypatch):
    """A cluster of 3 members of about 4,200 bases: the port aligns it on
    the batched DP (graph_scalar 0), to the consensus of the JAX package
    running its own DP at the port's caps."""
    cluster = _long_cluster()
    counts = {}
    got = tgb.consensus_sequence_poa_batch([cluster], counts=counts)
    assert counts == {"dp_calls": 2, "graph_scalar": 0}
    _jax_at_port_caps(monkeypatch)
    assert got == jgb.consensus_sequence_poa_batch([cluster])


def test_run_audit_graph_past_g1_n_cap_matches_jax(tmp_path, monkeypatch):
    """`run_audit` with the graph engine on a BAM with one insert of 4,200
    bases on 3 reads (mutated): the port's lines on the CPU, with no
    cluster on the scalar route, equal the JAX package's at the port's
    caps."""
    insert = _rand_seq(random.Random(53), 4200)
    bam, vcf = build_ins_site(str(tmp_path), insert, depth=3, noisy=True,
                              seed=53)
    _jax_at_port_caps(monkeypatch)
    want, got, err = _audit_both(bam, vcf)
    assert got == want and len(got) == 1 and "seq: NA" not in got[0]
    assert "graph_scalar=0" in err
    seq = got[0].split("seq: ")[1]
    assert len(seq) > 4096


def test_routing_caps_are_the_jax_packages():
    """The port routes at G1's own limits; the JAX package keeps its
    caps of 2,048 nodes, 1,024 bases and 32 predecessors (read here, not
    changed), at or below G1's."""
    assert (tgb.V_CAP, tgb.N_CAP, tgb.P_CAP) == (
        kernels.GRAPH_V_CAP, kernels.GRAPH_N_CAP, kernels.GRAPH_P_CAP)
    assert (jgb.V_CAP, jgb.N_CAP, jgb.P_CAP) == (2048, 1024, 32)
    assert jgb.V_CAP <= tgb.V_CAP and jgb.N_CAP <= tgb.N_CAP and \
        jgb.P_CAP <= tgb.P_CAP
    assert (kernels.GRAPH_V_CAP, kernels.GRAPH_N_CAP,
            kernels.GRAPH_P_CAP) == (65536, 16384, 32)
    # A code holds the predecessor slot and the move in one byte, the
    # plain DP's int8 code (slot * 4 + move); it does not bound V.
    assert (kernels.GRAPH_P_CAP - 1) * 4 + 2 < 1 << 7


@pytest.mark.parametrize("edit,count", [
    (None, 0), ("npred_0", 1), ("pred_later", 1), ("pred_negative", 1),
    ("dead_row", 0)])
def test_g1_refuses_bad_entries(edit, count):
    """What G1's wrapper refuses: a live row with no predecessor (its NEG
    row would overflow G1's packed keys) and a predecessor entry not of an
    earlier row; rows past V do not count."""
    graphs, queries, _ = _pairs("grown")
    arrays, shape = _pack(graphs, queries)
    _, pred_rows, npred, _, Vs, _, _ = (a.copy() for a in arrays)
    if edit == "npred_0":
        npred[0, 3] = 0
    elif edit == "pred_later":
        pred_rows[1, 2, 0] = 3
    elif edit == "pred_negative":
        pred_rows[0, 0, shape["P"] - 1] = -1
    elif edit == "dead_row":
        npred[0, int(Vs[0]):] = 0
        pred_rows[0, int(Vs[0]):] = shape["Vmax"]
        assert int(Vs[0]) < shape["Vmax"]
    got = kernels.graph_bad_entries(*(torch.from_numpy(a) for a in
                                      (pred_rows, npred, Vs)))
    assert int(got) == count


def test_launch_chunks():
    cells = [10, 20, 30, 40, 5, 1000, 1, 1]
    runs = kernels.poa_graph_chunks(cells, kernels.GRAPH_CELL_BYTES * 60)
    assert runs == [(0, [0, 10, 30, 60]), (3, [0, 40, 45]), (5, [0, 1000]),
                    (6, [0, 1, 2])]
    assert kernels.poa_graph_chunks([], 100) == []
    assert kernels.GRAPH_CELL_BYTES == 5
    assert [kernels.graph_row_cells(n) for n in
            (1, 15, 16, 1020, 4096, 16384)] == \
        [32, 32, 32, 1024, 4128, 16416]
    # A pair alone past the budget: 5.4 GB at G1's caps, a launch of its
    # own between two small ones.
    cap = (kernels.GRAPH_V_CAP + 1) * kernels.graph_row_cells(
        kernels.GRAPH_N_CAP)
    assert cap * kernels.GRAPH_CELL_BYTES > 5.3e9
    assert kernels.poa_graph_chunks([10, cap, 10]) == [
        (0, [0, 10]), (1, [0, cap]), (2, [0, 10])]


# (longest query of a launch, G1's ring rows there): 8 rows up to 6,751
# bases, 4 up to 13,119, 2 up to the cap.
SMEM_CASES = [(1, 8), (1020, 8), (4096, 8), (6900, 4), (13800, 2),
              (16384, 2)]


@pytest.mark.parametrize("n,ring", SMEM_CASES)
def test_g1_shared_memory_fits_at_the_caps(n, ring):
    """G1's launch at a longest query of n bases, over graphs of
    GRAPH_V_CAP nodes: its shared memory (the ring, the code stage, the
    shifted query, a flag bit a row) fits a Hopper block's 232,448 bytes,
    and its ring is the deepest of 8, 4 and 2 rows that fits."""
    assert kernels.GRAPH_SMEM_BYTES == 232_448
    assert kernels.graph_ring_rows(n) == ring
    cells = kernels.graph_row_cells(n)
    flags = (kernels.GRAPH_V_CAP // 32 + 1) * 4
    smem = kernels.graph_smem_bytes(n, kernels.GRAPH_V_CAP)
    assert smem == ring * cells * 4 + 1024 + cells + flags
    assert smem <= kernels.GRAPH_SMEM_BYTES
    if ring < 8:   # twice the rows would not fit
        assert 2 * ring * cells * 4 + 1024 + cells + flags > \
            kernels.GRAPH_SMEM_BYTES
    assert kernels.graph_smem_bytes(n, 16) < smem
    assert kernels.graph_ring_rows(kernels.GRAPH_N_CAP + 1) == 0


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


def test_consensus_over_n_cap_takes_the_scalar_route(monkeypatch):
    """A member of N_CAP + 1 bases sends its cluster to the scalar POA (one
    alignment), in both packages: the port's N_CAP set to the JAX
    package's 1,024, so that the CPU runs the scalar route at the size
    where JAX takes it."""
    monkeypatch.setattr(tgb, "N_CAP", jgb.N_CAP)
    rng = random.Random(3)
    long = _rand_seq(rng, tgb.N_CAP + 1)
    clusters = [[long, long[:500] + long[510:]],
                _random_cluster(rng, 3, 50, err=0.1)]
    counts = {}
    got = tgb.consensus_sequence_poa_batch(clusters, counts=counts)
    assert got == jgb.consensus_sequence_poa_batch(clusters)
    assert got == [consensus_sequence_poa(c) for c in clusters]
    assert counts == {"dp_calls": 2, "graph_scalar": 1}


@pytest.mark.parametrize("cap,value", [("V_CAP", 60), ("P_CAP", 1)])
def test_consensus_graph_caps_take_the_scalar_route(monkeypatch, cap, value):
    """A graph past V_CAP nodes or P_CAP predecessors finishes on the
    scalar POA, with both modules' caps set small (the port's are G1's,
    past any graph the CPU can grow in a test)."""
    monkeypatch.setattr(tgb, cap, value)
    monkeypatch.setattr(jgb, cap, value)
    clusters = _consensus_cases()
    counts = {}
    got = tgb.consensus_sequence_poa_batch(clusters, counts=counts)
    assert got == jgb.consensus_sequence_poa_batch(clusters)
    assert got == [consensus_sequence_poa(c) for c in clusters]
    assert 0 < counts["graph_scalar"] < 10


def test_consensus_past_jax_caps_takes_the_batched_dp():
    """A cluster of members of 1,100-1,200 bases, past the JAX package's
    N_CAP 1,024 (its scalar route) and within G1's: the port aligns it on
    the batched DP (graph_scalar 0) to JAX's consensus and the scalar
    consensus_sequence_poa's."""
    rng = random.Random(11)
    truth = _rand_seq(rng, 1150)
    from tests.test_poa_graph import _mutate
    cluster = [_mutate(rng, truth, 0.04) for _ in range(3)]
    assert all(jgb.N_CAP < len(s) <= tgb.N_CAP for s in cluster)
    counts = {}
    got = tgb.consensus_sequence_poa_batch([cluster], counts=counts)
    assert counts == {"dp_calls": 2, "graph_scalar": 0}
    assert got == jgb.consensus_sequence_poa_batch([cluster])
    assert got == [consensus_sequence_poa(cluster)]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_consensus_where_jax_goes_scalar_and_the_port_batches(monkeypatch,
                                                              seed):
    """The JAX package's N_CAP and V_CAP set low, so that it takes its
    scalar route for most clusters; the port, at its own caps, batches
    every one.  The consensus is the same."""
    monkeypatch.setattr(jgb, "N_CAP", 60)
    monkeypatch.setattr(jgb, "V_CAP", 90)
    rng = random.Random(f"caps-{seed}")
    clusters = [_random_cluster(rng, rng.randint(2, 6), rng.randint(30, 110),
                                err=0.12) for _ in range(8)]
    counts = {}
    got = tgb.consensus_sequence_poa_batch(clusters, counts=counts)
    assert counts["graph_scalar"] == 0
    assert max(len(s) for c in clusters for s in c) > jgb.N_CAP
    assert got == jgb.consensus_sequence_poa_batch(clusters)


def test_round_groups_by_size():
    """A round of one long pair and many short ones: `align_batch` packs
    them in groups of one pow2 size (no pair padded to twice its V or n,
    past the floor of 16) and gives the paths and scores of one ungrouped
    `graph_dp` call over the whole round, in the round's order."""
    rng = random.Random(21)
    graphs, queries = [], []
    for k in range(13):
        length = 400 if k == 5 else rng.randint(20, 90)
        seqs = _random_cluster(rng, 3, length, err=0.1)
        graphs.append(_grow(seqs[:2]))
        queries.append(encode(seqs[2]))
    Vs = [len(g.base) for g in graphs]
    ns = [len(q) for q in queries]
    groups = tgb.group_pairs(Vs, ns)
    assert sorted(i for g in groups for i in g) == list(range(13))
    assert 1 < len(groups) < 13
    for grp in groups:
        _, _, shape = tgb.pack_pairs([graphs[i] for i in grp],
                                     [queries[i] for i in grp])
        for i in grp:
            assert shape["Vmax"] < 2 * Vs[i] or shape["Vmax"] == 16
            assert shape["Nmax"] < 2 * ns[i] or shape["Nmax"] == 16
    arrays, shape = _pack(graphs, queries)
    score, matched, ins_after = _plain(arrays, shape)
    arrs = [g.to_arrays(shape["Vmax"], shape["P"]) for g in graphs]
    want = [tgb.path_from_device(arrs[i], matched[i], ins_after[i],
                                 queries[i]) for i in range(13)]
    counts = {}
    calls = poa_graph_dp.plain_calls["poa_graph_dp"]
    paths, scores = tgb.align_batch(graphs, queries, counts=counts)
    assert poa_graph_dp.plain_calls["poa_graph_dp"] - calls == len(groups)
    assert counts == {"dp_calls": 1}
    assert paths == want
    np.testing.assert_array_equal(scores, score)
    # The budget splits a group of one size; a pair alone may pass it.
    cell = kernels.GRAPH_CELL_BYTES
    assert tgb.group_pairs([100] * 5, [50] * 5, budget=129 * 65 * cell * 2) \
        == [[0, 1], [2, 3], [4]]
    assert tgb.group_pairs([100, 30], [50, 20], budget=1) == [[1], [0]]


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
