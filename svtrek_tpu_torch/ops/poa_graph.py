"""TRUE partial-order alignment (scalar host oracle).

A copy of svtrek_tpu/ops/poa_graph.py, which is numpy only, so that the
port imports nothing of svtrek_tpu; tests/test_torch_standalone.py holds
it equal to the original.  From the original's docstring:

The north star names "abPOA-style partial-order-alignment consensus ...
banded DP over the POA graph as the inner loop" (BASELINE.json), and the
reference declares abPOA as a submodule without ever calling it
(the reference's .gitmodules:5-7, Makefile:32-33; SURVEY.md §2.14).
ops/poa.py is honest that it implements star MSA, NOT partial-order
alignment.  This module is the real thing, scalar form — the semantic
anchor the batched device kernel (ops/poa_graph_batch.py) is
property-tested against:

* a DAG of base nodes with weighted edges (weight = #sequences using
  the edge) and aligned-node rings (alternative bases at one alignment
  position, the Lee/Grasso/Sharma POA construction);
* each new sequence aligns to the WHOLE graph with a global DP over
  nodes in topological order (match/mismatch to a node via any
  predecessor, node-skip deletions, query insertions), then its
  alignment path adds nodes/edges — matches fuse onto existing nodes,
  mismatches reuse a ring node of the same base or create one;
* consensus = maximum-weight path through the final graph (DP over
  edge weights in topological order), the spoa convention.

Scoring constants are shared with the star-MSA module (ops/poa.py:
MATCH/MISMATCH/GAP) so quality comparisons isolate the algorithm, not
the scores.
"""
from __future__ import annotations

import numpy as np

from .poa import GAP, MATCH, MISMATCH, _BASES, encode

NEG = -(1 << 28)


class PoaGraph:
    """Partial-order graph over encoded bases (0..4)."""

    def __init__(self):
        self.base: list[int] = []
        self.preds: list[set[int]] = []
        self.succs: list[set[int]] = []
        self.aligned: list[set[int]] = []   # ring partners (excl. self)
        self.node_w: list[int] = []         # sequences through the node
        self.edge_w: dict[tuple[int, int], int] = {}
        self.n_seqs = 0

    def new_node(self, b: int) -> int:
        self.base.append(int(b))
        self.preds.append(set())
        self.succs.append(set())
        self.aligned.append(set())
        self.node_w.append(0)
        return len(self.base) - 1

    def add_edge(self, u: int | None, v: int):
        self.node_w[v] += 1
        if u is None:
            return
        self.preds[v].add(u)
        self.succs[u].add(v)
        self.edge_w[(u, v)] = self.edge_w.get((u, v), 0) + 1

    def topo_order(self) -> list[int]:
        """Kahn's algorithm, smallest-id-first for determinism."""
        import heapq

        indeg = [len(p) for p in self.preds]
        heap = [v for v in range(len(self.base)) if indeg[v] == 0]
        heapq.heapify(heap)
        out = []
        while heap:
            v = heapq.heappop(heap)
            out.append(v)
            for s in sorted(self.succs[v]):
                indeg[s] -= 1
                if indeg[s] == 0:
                    heapq.heappush(heap, s)
        assert len(out) == len(self.base), "cycle in POA graph"
        return out

    # ---------------------------------------------------------------- #

    def add_first(self, q: np.ndarray):
        prev = None
        for b in q:
            v = self.new_node(b)
            self.add_edge(prev, v)
            prev = v
        self.n_seqs = 1

    def align(self, q: np.ndarray):
        """Global DP of query q against the graph.  Returns the
        alignment as a list of (node | None, qpos | None) in path order:
        (v, j) = match/mismatch of q[j] onto node v; (v, None) = node
        skipped (deletion); (None, j) = q[j] inserted."""
        order = self.topo_order()
        rank = {v: i + 1 for i, v in enumerate(order)}   # DP row index
        V = len(order)
        n = len(q)
        H = np.full((V + 1, n + 1), NEG, np.int64)
        # move: 0 = diag, 1 = del (node skip), 2 = ins; prow = source row
        move = np.zeros((V + 1, n + 1), np.int8)
        prow = np.zeros((V + 1, n + 1), np.int32)
        H[0, :] = GAP * np.arange(n + 1)
        move[0, :] = 2
        for v in order:
            i = rank[v]
            prs = [rank[p] for p in sorted(self.preds[v])] or [0]
            b = self.base[v]
            for j in range(n + 1):
                best, bm, bp = NEG, 1, prs[0]
                for pr in prs:
                    d = H[pr, j] + GAP                     # deletion
                    if d > best:
                        best, bm, bp = d, 1, pr
                    if j > 0:
                        s = H[pr, j - 1] + (MATCH if q[j - 1] == b
                                            else MISMATCH)
                        if s > best:
                            best, bm, bp = s, 0, pr
                if j > 0:
                    s = H[i, j - 1] + GAP                  # insertion
                    if s > best:
                        best, bm, bp = s, 2, i
                H[i, j], move[i, j], prow[i, j] = best, bm, bp
        sinks = [v for v in order if not self.succs[v]]
        end = max(sinks, key=lambda v: (H[rank[v], n], -rank[v]))
        # traceback
        path = []
        i, j = rank[end], n
        inv = {r: v for v, r in rank.items()}
        while i > 0 or j > 0:
            m = move[i, j]
            if i == 0:
                m = 2
            if m == 0:
                path.append((inv[i], j - 1))
                i, j = int(prow[i, j]), j - 1
            elif m == 1:
                path.append((inv[i], None))
                i = int(prow[i, j])
            else:
                path.append((None, j - 1))
                j -= 1
        path.reverse()
        return path, int(H[rank[end], n])

    def add_alignment(self, q: np.ndarray, path) -> None:
        """Thread the aligned query through the graph (fuse matches,
        ring-reuse or ring-create mismatches, chain insertions)."""
        prev = None
        for v, j in path:
            if j is None:                      # deletion: node skipped
                continue
            b = int(q[j])
            if v is None:                      # insertion: new node
                node = self.new_node(b)
            elif self.base[v] == b:
                node = v
            else:
                node = next((r for r in sorted(self.aligned[v])
                             if self.base[r] == b), None)
                if node is None:
                    node = self.new_node(b)
                    ring = {v} | self.aligned[v]
                    for r in ring:
                        self.aligned[r].add(node)
                    self.aligned[node] = ring
            self.add_edge(prev, node)
            prev = node
        self.n_seqs += 1

    def to_arrays(self, Vmax: int, P: int, Nmax: int | None = None):
        """Padded topo-order arrays for the device DP
        (ops/poa_graph_batch.py).  pred_rows holds DP ROW indices
        (topo rank + 1; 0 = virtual start) in sorted-node-id order —
        the same preference order the scalar align() iterates, so the
        kernel's packed argmax tie-breaking matches exactly."""
        order = self.topo_order()
        rank = {v: i + 1 for i, v in enumerate(order)}
        V = len(order)
        assert V <= Vmax
        base_td = np.full(Vmax, 5, np.int8)
        pred_rows = np.zeros((Vmax, P), np.int32)
        npred = np.zeros(Vmax, np.int32)
        is_sink = np.zeros(Vmax, bool)
        for i, v in enumerate(order):
            base_td[i] = self.base[v]
            prs = [rank[p] for p in sorted(self.preds[v])] or [0]
            assert len(prs) <= P
            pred_rows[i, : len(prs)] = prs
            npred[i] = len(prs)
            is_sink[i] = not self.succs[v]
        return {
            "base_td": base_td, "pred_rows": pred_rows, "npred": npred,
            "is_sink": is_sink, "V": np.int32(V),
            "order": order,
        }

    def max_indegree(self) -> int:
        return max((len(p) for p in self.preds), default=0)

    def consensus(self) -> str:
        """Heaviest-bundle path (Lee 2003): each node's predecessor is
        chosen by LOCAL edge weight first (cumulative score breaks
        ties), so a majority deletion edge beats a longer minority
        branch — plain max-SUM-of-weights is length-biased and picks
        the minority full allele over a majority deletion
        (tests/test_poa_graph.py::test_deletion_allele_majority)."""
        order = self.topo_order()
        score = {v: 0 for v in order}
        back: dict[int, int | None] = {v: None for v in order}
        for v in order:
            best = None
            for p in sorted(self.preds[v]):
                key = (self.edge_w.get((p, v), 0), score[p], -p)
                if best is None or key > best:
                    best = key
                    back[v] = p
            if back[v] is not None:
                score[v] = score[back[v]] + best[0]
        end = max(order, key=lambda v: (score[v], self.node_w[v]))
        out = []
        v: int | None = end
        while v is not None:
            out.append(_BASES[self.base[v]])
            v = back[v]
        return "".join(reversed(out))


def consensus_sequence_poa(seqs: list[str]) -> str:
    """True-POA consensus of a cluster (scalar oracle).

    Seed order matters for POA; seed with the length-medoid (the same
    anchor choice as the star MSA) then add the rest in input order."""
    seqs = [s for s in seqs if s]
    if not seqs:
        return ""
    if len(seqs) == 1:
        return seqs[0]
    order = sorted(range(len(seqs)), key=lambda i: len(seqs[i]))
    seed = order[len(order) // 2]
    g = PoaGraph()
    g.add_first(encode(seqs[seed]))
    for i, s in enumerate(seqs):
        if i == seed:
            continue
        q = encode(s)
        path, _ = g.align(q)
        g.add_alignment(q, path)
    return g.consensus()
