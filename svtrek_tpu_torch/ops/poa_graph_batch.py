"""Batched graph POA consensus (`--poa-engine graph`): every active
cluster aligns its next member to its graph in one DP round.

Port of svtrek_tpu/ops/poa_graph_batch.py (`_pow2`, `path_from_device`,
`align_batch`, `consensus_sequence_poa_batch`), line for line where the
output depends on it: the length-medoid seed, the round structure, the
scalar route for clusters past the caps, and the pow2 shapes (P >= 2,
Vmax >= 16, Nmax >= 16), which do not change a pair's result.  Two
things differ, and neither changes a result: the caps are kernel G1's
own (the JAX package keeps lower ones for its compiled shapes), and a
round is packed in groups of pairs of one pow2 size, not at the round's
largest.  The DP runs in `ops.poa_graph_dp.graph_dp` on the given
device: kernel G1 on the card, the plain PyTorch version on the CPU.
"""
from __future__ import annotations

import numpy as np
import torch

from ..kernels import (
    GRAPH_CELL_BYTES, GRAPH_N_CAP, GRAPH_P_CAP, GRAPH_SCRATCH_BYTES,
    GRAPH_V_CAP,
)
from .poa import encode
from .poa_graph import PoaGraph, consensus_sequence_poa
from .poa_graph_dp import graph_dp


def _pow2(n: int, lo: int) -> int:
    v = lo
    while v < n:
        v *= 2
    return v


def path_from_device(arrs, matched, ins_after, q: np.ndarray):
    """Reconstruct the scalar align() path (minus deletions, which
    add_alignment ignores) from the DP's compact traceback: leading
    insertions, then per matched topo row its aligned query base and the
    insertions that follow it.  Query is consumed monotonically."""
    order = arrs["order"]
    path: list[tuple[int | None, int]] = []
    c = 0
    for _ in range(int(ins_after[0])):
        path.append((None, c))
        c += 1
    for r in range(int(arrs["V"])):
        if matched[r]:
            path.append((order[r], c))
            c += 1
        for _ in range(int(ins_after[r + 1])):
            path.append((None, c))
            c += 1
    assert c == len(q), (c, len(q))
    return path


def pack_pairs(graphs: list[PoaGraph], queries: list[np.ndarray]):
    """The DP's inputs for query[i] against graph[i], one group: (each
    graph's to_arrays, the stacked numpy arrays (base_td, pred_rows,
    npred, is_sink, Vs, qpad, ns) of `graph_dp`, its static shapes {P,
    Vmax, Nmax}), as svtrek_tpu's align_batch builds them."""
    B = len(graphs)
    P = _pow2(max(max(g.max_indegree(), 1) for g in graphs), 2)
    Vmax = _pow2(max(len(g.base) for g in graphs), 16)
    Nmax = _pow2(max(len(q) for q in queries), 16)
    arrs = [g.to_arrays(Vmax, P) for g in graphs]
    base_td = np.stack([a["base_td"] for a in arrs])
    pred_rows = np.stack([a["pred_rows"] for a in arrs])
    npred = np.stack([a["npred"] for a in arrs])
    is_sink = np.stack([a["is_sink"] for a in arrs])
    Vs = np.array([a["V"] for a in arrs], np.int32)
    qpad = np.full((B, Nmax), 5, np.int8)
    ns = np.zeros(B, np.int32)
    for i, q in enumerate(queries):
        qpad[i, : len(q)] = q
        ns[i] = len(q)
    return arrs, (base_td, pred_rows, npred, is_sink, Vs, qpad, ns), \
        dict(P=P, Vmax=Vmax, Nmax=Nmax)


def group_pairs(Vs: list[int], ns: list[int],
                budget: int = GRAPH_SCRATCH_BYTES) -> list[list[int]]:
    """A round's pairs (graph sizes Vs, query lengths ns) in groups that
    are packed and aligned alone: sorted by (V, n) at pow2 granularity, a
    group holds pairs of one pow2 V and one pow2 n (so no pair is padded
    to twice its V or n or more, where the floor of 16 allows), and ends
    where its DP cells, (Vmax+1) * (Nmax+1) a pair at GRAPH_CELL_BYTES
    each (int32 H and a one-byte code: the plain DP's arrays and G1's
    scratch), would pass ``budget``; a pair alone may pass it.  Returns
    the pairs' indices."""
    def key(i):
        return _pow2(Vs[i], 16), _pow2(ns[i], 16)

    groups: list[list[int]] = []
    for i in sorted(range(len(Vs)), key=lambda i: (key(i), Vs[i], ns[i])):
        vmax, nmax = key(i)
        pair_bytes = (vmax + 1) * (nmax + 1) * GRAPH_CELL_BYTES
        if groups and key(groups[-1][0]) == (vmax, nmax) and \
                (len(groups[-1]) + 1) * pair_bytes <= budget:
            groups[-1].append(i)
        else:
            groups.append([i])
    return groups


def align_batch(graphs: list[PoaGraph], queries: list[np.ndarray], *,
                device: torch.device | str = "cpu",
                counts: dict | None = None):
    """Align query[i] to graph[i] for the whole round on ``device``: one
    `graph_dp` call per group of `group_pairs`, each packed at its own
    shapes by `pack_pairs` (the round counted once in
    ``counts["dp_calls"]`` when ``counts`` is given).  Returns (paths,
    scores) in the round's order: paths in add_alignment form.  Callers
    guard sizes (see consensus_sequence_poa_batch)."""
    paths: list = [None] * len(graphs)
    scores = np.zeros(len(graphs), np.int32)
    for grp in group_pairs([len(g.base) for g in graphs],
                           [len(q) for q in queries]):
        qs = [queries[i] for i in grp]
        arrs, arrays, shape = pack_pairs([graphs[i] for i in grp], qs)
        score, matched, ins_after = (x.cpu().numpy() for x in graph_dp(
            *(torch.from_numpy(a).to(device) for a in arrays), **shape))
        for k, i in enumerate(grp):
            paths[i] = path_from_device(arrs[k], matched[k], ins_after[k],
                                        qs[k])
            scores[i] = score[k]
    if counts is not None:
        counts["dp_calls"] = counts.get("dp_calls", 0) + 1
    return paths, scores


# Caps beyond which a cluster takes the scalar route: G1's own limits
# (kernels.GRAPH_*_CAP: 65,536 nodes, 16,384 bases, 32 predecessors), on
# either device (the plain DP on the CPU holds int32 H and an int8 code
# a cell, 5.4 GB a pair at the caps).  svtrek_tpu keeps 2,048 nodes,
# 1,024 bases and 32 predecessors, so that one outlier does not set its
# dense DP's compiled shape; each route is exact, so the consensus is the
# same.
V_CAP = GRAPH_V_CAP
N_CAP = GRAPH_N_CAP
P_CAP = GRAPH_P_CAP


def consensus_sequence_poa_batch(clusters: list[list[str]], *,
                                 device: torch.device | str = "cpu",
                                 counts: dict | None = None) -> list[str]:
    """True-POA consensus of many clusters, batched per round: round k
    aligns every active cluster's k-th member to its graph in one
    `align_batch` call on ``device`` (the graph-threading update is host
    work).  The semantics of the scalar consensus_sequence_poa (same seed
    choice, same preference order).  With ``counts``, counts["dp_calls"]
    counts the rounds' DP calls and counts["graph_scalar"] the clusters
    that took the scalar route (a member past N_CAP, or a graph past V_CAP
    nodes or P_CAP predecessors)."""
    results: list[str | None] = [None] * len(clusters)
    state: dict[int, tuple[PoaGraph, list[str], int]] = {}
    scalar = 0
    for ci, seqs in enumerate(clusters):
        seqs = [s for s in seqs if s]
        if not seqs:
            results[ci] = ""
            continue
        if len(seqs) == 1:
            results[ci] = seqs[0]
            continue
        if max(len(s) for s in seqs) > N_CAP:
            results[ci] = consensus_sequence_poa(seqs)
            scalar += 1
            continue
        order = sorted(range(len(seqs)), key=lambda i: len(seqs[i]))
        seed = order[len(order) // 2]
        g = PoaGraph()
        g.add_first(encode(seqs[seed]))
        rest = [s for i, s in enumerate(seqs) if i != seed]
        state[ci] = (g, rest, 0)

    while state:
        batch_ci, batch_g, batch_q = [], [], []
        for ci, (g, rest, k) in list(state.items()):
            if k >= len(rest):
                results[ci] = g.consensus()
                del state[ci]
                continue
            if (len(g.base) > V_CAP or g.max_indegree() > P_CAP):
                # outlier graph: finish scalar
                for s in rest[k:]:
                    q = encode(s)
                    path, _ = g.align(q)
                    g.add_alignment(q, path)
                results[ci] = g.consensus()
                del state[ci]
                scalar += 1
                continue
            batch_ci.append(ci)
            batch_g.append(g)
            batch_q.append(encode(rest[k]))
        if not batch_ci:
            continue
        paths, _ = align_batch(batch_g, batch_q, device=device,
                               counts=counts)
        for ci, q, path in zip(batch_ci, batch_q, paths):
            g, rest, k = state[ci]
            g.add_alignment(q, path)
            state[ci] = (g, rest, k + 1)
    if counts is not None:
        counts["graph_scalar"] = counts.get("graph_scalar", 0) + scalar
    return results  # type: ignore[return-value]
