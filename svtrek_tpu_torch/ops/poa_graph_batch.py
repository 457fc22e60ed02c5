"""Batched graph POA consensus (`--poa-engine graph`): every active
cluster aligns its next member to its graph in one DP call per round.

Port of svtrek_tpu/ops/poa_graph_batch.py (`_pow2`, `path_from_device`,
`align_batch`, the caps and `consensus_sequence_poa_batch`), line for line
where the output depends on it: the length-medoid seed, the round
structure, the scalar route for clusters past the caps, and the pow2
shapes (P >= 2, Vmax >= 16, Nmax >= 16), which do not change a pair's
result but keep the arrays those of the JAX package.  The DP runs in
`ops.poa_graph_dp.graph_dp` on the given device: kernel G1 on the card,
the plain PyTorch version on the CPU.
"""
from __future__ import annotations

import numpy as np
import torch

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
    """The DP's inputs for query[i] against graph[i]: (each graph's
    to_arrays, the stacked numpy arrays (base_td, pred_rows, npred,
    is_sink, Vs, qpad, ns) of `graph_dp`, its static shapes {P, Vmax,
    Nmax}), as svtrek_tpu's align_batch builds them."""
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


def align_batch(graphs: list[PoaGraph], queries: list[np.ndarray], *,
                device: torch.device | str = "cpu",
                counts: dict | None = None):
    """Align query[i] to graph[i] for the whole batch in one `graph_dp`
    call on ``device`` (counted in ``counts["dp_calls"]`` when ``counts``
    is given).  Returns (paths, scores): paths in add_alignment form.
    Callers guard sizes (see consensus_sequence_poa_batch)."""
    arrs, arrays, shape = pack_pairs(graphs, queries)
    scores, matched, ins_after = (x.cpu().numpy() for x in graph_dp(
        *(torch.from_numpy(a).to(device) for a in arrays), **shape))
    if counts is not None:
        counts["dp_calls"] = counts.get("dp_calls", 0) + 1
    paths = [path_from_device(arrs[i], matched[i], ins_after[i],
                              queries[i]) for i in range(len(graphs))]
    return paths, scores


# Caps beyond which a cluster takes the scalar route (svtrek_tpu's: there
# the dense DP's compiled shape would be dominated by one outlier).  G1
# takes no larger graph, query or indegree (kernels.GRAPH_V_CAP, ...).
V_CAP = 2048
N_CAP = 1024
P_CAP = 32


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
