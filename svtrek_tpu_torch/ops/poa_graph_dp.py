"""DP and traceback of the graph POA: one query against one partial-order
graph, a batch of (graph, query) pairs per call.

Counterpart of svtrek_tpu/ops/poa_graph_batch.py's `_graph_dp_one` and
`_graph_dp_batch`, a `jax.jit` of two `lax.scan`s (one step per topo-ordered
graph node, then the traceback) under `vmap`.  That is an XLA loop, not a
Pallas kernel.  `graph_dp` is the dispatch: CUDA tensors go to the
hand-written kernel G1 (csrc/poa_graph.cu through
`kernels.poa_graph_dp_cuda`), CPU tensors to the plain PyTorch version here,
`graph_dp_reference`.  The choice is made by the tensors' device; there is
no fallback from one to the other.

The plain version follows `_graph_dp_one` step by step over a written-out
batch dimension, with the same int32 algebra: NEG = -2^28; per DP row the
candidate stack [del_p0, diag_p0, del_p1, diag_p1, ...] over all P slots
(a slot at or past the node's predecessor count is NEG, diag at column 0
is NEG + NEG), a first-wins argmax over it, then the in-row insertions as
an exclusive cummax, taken only where strictly greater; the end row is the
first best-scoring sink; the walk runs from (end row, n) to (0, 0).  Rows
past a pair's V are never read by its walk, so the plain version stops at
the batch's largest V instead of Vmax.
"""
from __future__ import annotations

import torch

from .poa import GAP, MATCH, MISMATCH

NEG = -(1 << 28)
INT32_MIN = -(1 << 31)

# Calls of the plain version through `graph_dp` (the CPU route).
plain_calls: dict[str, int] = {"poa_graph_dp": 0}


def graph_dp_reference(base_td: torch.Tensor, pred_rows: torch.Tensor,
                       npred: torch.Tensor, is_sink: torch.Tensor,
                       Vs: torch.Tensor, qpad: torch.Tensor,
                       ns: torch.Tensor, *, P: int, Vmax: int, Nmax: int
                       ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain DP + traceback of every (graph, query) pair.

    base_td [B, Vmax] int8 (the base of each topo row), pred_rows [B, Vmax,
    P] int32 (predecessor DP rows, 0 = the virtual start, in the scalar
    align()'s preference order), npred [B, Vmax] int32, is_sink [B, Vmax]
    bool, Vs [B] int32, qpad [B, Nmax] int8 padded with 5, ns [B] int32
    (PoaGraph.to_arrays' arrays, stacked).  Returns (score [B] int32,
    matched [B, Vmax] int8, ins_after [B, Vmax+1] int32), equal to
    svtrek_tpu's `_graph_dp_batch` over the whole arrays."""
    B = base_td.shape[0]
    dev = base_td.device
    i32 = torch.int32
    bidx = torch.arange(B, device=dev)
    cols = torch.arange(Nmax + 1, dtype=i32, device=dev)
    gapj = GAP * cols
    n = ns.to(i32)
    V = Vs.to(i32)
    jvalid = cols[None, :] <= n[:, None]
    negcol = torch.full((B, 1), NEG, dtype=i32, device=dev)
    pvalid_all = torch.arange(P, device=dev)[None, None, :] < \
        npred.to(i32)[:, :, None]                       # [B, Vmax, P]
    q = qpad.to(i32)
    rows_needed = int(V.max()) if B else 0

    # Rows 0..rows_needed of H; the rows past them stay NEG in JAX's H.
    H = torch.full((B, rows_needed + 1, Nmax + 1), NEG, dtype=i32, device=dev)
    H[:, 0] = torch.where(jvalid, gapj, NEG)
    moves = torch.zeros((B, max(rows_needed, 1), Nmax + 1), dtype=torch.int8,
                        device=dev)
    psels = torch.zeros_like(moves)
    for i in range(1, rows_needed + 1):
        prs = pred_rows[:, i - 1].long()                   # [B, P]
        rows = H[bidx[:, None], prs]                       # [B, P, N+1]
        b = base_td[:, i - 1].to(i32)
        sub = torch.cat([negcol, torch.where(q == b[:, None], MATCH,
                                             MISMATCH).to(i32)], 1)
        pvalid = pvalid_all[:, i - 1]
        # The stack [del_p0, diag_p0, del_p1, ...] in order, each slot
        # taken only where strictly greater: the first maximum wins.
        best = torch.full((B, Nmax + 1), INT32_MIN, dtype=i32, device=dev)
        sel = torch.zeros((B, Nmax + 1), dtype=torch.int8, device=dev)
        for p in range(P):
            pv = pvalid[:, p, None]
            r = rows[:, p]
            diag = torch.cat([negcol, r[:, :-1]], 1) + sub
            for k, c in ((2 * p, r + GAP), (2 * p + 1, diag)):
                c = torch.where(pv, c, NEG)
                sel.masked_fill_(c > best, k)
                best = torch.maximum(best, c)
        base_move = (1 - sel % 2).to(torch.int8)           # 1 del, 0 diag
        base_psel = sel // 2
        cm = torch.cummax(best - gapj, dim=1).values
        left = torch.cat([negcol, cm[:, :-1]], 1) + gapj
        use_ins = left > best                              # strict
        row = torch.where(use_ins, left, best)
        moves[:, i - 1] = torch.where(use_ins, 2, base_move).to(torch.int8)
        psels[:, i - 1] = torch.where(use_ins, 0, base_psel).to(torch.int8)
        row = torch.where(jvalid & (i <= V)[:, None], row, NEG)
        H[:, i] = row

    finals = torch.full((B, Vmax), NEG, dtype=i32, device=dev)
    finals[:, :rows_needed] = H[bidx, 1:, n.long()]        # H[i, n]
    sink_ok = is_sink & (torch.arange(Vmax, device=dev)[None, :] < V[:, None])
    scores = torch.where(sink_ok, finals, NEG)
    end_row = torch.argmax(scores, dim=1) + 1              # lowest rank tie
    score = scores[bidx, end_row - 1]

    matched = torch.zeros((B, Vmax), dtype=torch.int8, device=dev)
    ins_after = torch.zeros((B, Vmax + 1), dtype=torch.int32, device=dev)
    i = end_row.long()
    j = n.long()
    while B and bool(((i > 0) | (j > 0)).any()):
        active = (i > 0) | (j > 0)
        im1 = (i - 1).clamp(min=0).clamp(max=moves.shape[1] - 1)
        m = torch.where(i == 0, 2, moves[bidx, im1, j].long())
        dg = active & (m == 0)
        dl = active & (m == 1)
        ins = active & (m == 2)
        matched[bidx, im1] = torch.where(dg, 1, matched[bidx, im1]).to(
            torch.int8)
        slot = i.clamp(0, Vmax)
        ins_after[bidx, slot] += ins.to(torch.int32)
        p = psels[bidx, im1, j].long()
        prow = pred_rows[bidx, (i - 1).clamp(min=0), p].long()
        i = torch.where(dg | dl, prow, i)
        j = j - (dg | ins).long()
    return score.to(i32), matched, ins_after


def graph_dp(base_td: torch.Tensor, pred_rows: torch.Tensor,
             npred: torch.Tensor, is_sink: torch.Tensor, Vs: torch.Tensor,
             qpad: torch.Tensor, ns: torch.Tensor, *, P: int, Vmax: int,
             Nmax: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """DP + traceback of a batch of (graph, query) pairs on the tensors'
    device: kernel G1 for CUDA tensors, `graph_dp_reference` for CPU
    tensors.  Arguments and results as `graph_dp_reference`."""
    args = (base_td, pred_rows, npred, is_sink, Vs, qpad, ns)
    if base_td.device.type == "cuda":
        from ..kernels import poa_graph_dp_cuda

        return poa_graph_dp_cuda(*args, P=P, Vmax=Vmax, Nmax=Nmax)
    if base_td.device.type != "cpu":
        raise ValueError(f"no graph POA DP path for device {base_td.device}")
    plain_calls["poa_graph_dp"] += 1
    return graph_dp_reference(*args, P=P, Vmax=Vmax, Nmax=Nmax)
