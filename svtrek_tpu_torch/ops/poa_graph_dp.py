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
the batch's largest V instead of Vmax; a cell depends only on cells of
its own column or to its left, and the walk starts at column n, so the
columns stop at the batch's largest n instead of Nmax; and each row's
stack stops at the largest predecessor count of that row in the batch
(the slots past it are NEG in every pair and never win).  It holds int32
H and an int8 code a cell of those rows and columns: 5.4 GB a pair at
G1's caps (65,536 nodes, 16,384 bases).
"""
from __future__ import annotations

import torch

from .poa import GAP, MATCH, MISMATCH

NEG = -(1 << 28)

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
    n = ns.to(i32)
    V = Vs.to(i32)
    rows_needed, cols_needed = (int(x) for x in torch.stack(
        [V.max(), n.max()]).tolist()) if B else (0, 0)
    W = cols_needed + 1
    cols = torch.arange(W, dtype=i32, device=dev)
    gapj = GAP * cols
    jvalid = cols[None, :] <= n[:, None]
    negcol = torch.full((B, 1), NEG, dtype=i32, device=dev)
    R = rows_needed + 1

    # Rows 0..rows_needed of H; the rows past them stay NEG in JAX's H.
    # Flat views: pair b's row r is row b * R + r of Hf.
    H = torch.full((B, R, W), NEG, dtype=i32, device=dev)
    H[:, 0] = torch.where(jvalid, gapj, NEG)
    Hf = H.view(B * R, W)
    pred_long = pred_rows.long()
    pred_in_hf = (bidx * R)[:, None, None] + pred_long[:, :rows_needed]
    # The substitution score of each base code (0-5) against each query
    # column, column 0 NEG (no diag move into it), as rows b * 6 + base.
    sub_by_base = torch.full((B, 6, W), NEG, dtype=i32, device=dev)
    sub_by_base[:, :, 1:] = torch.where(
        qpad[:, :cols_needed].to(i32)[:, None, :] == torch.arange(
            6, dtype=i32, device=dev)[None, :, None], MATCH, MISMATCH)
    sub_by_base = sub_by_base.view(B * 6, W)
    sub_row = (bidx * 6)[:, None] + base_td.long()          # [B, Vmax]
    # The candidate stack of a row, slot k = 2p + (0 del, 1 diag): where
    # predecessor slot p is not filled, NEG.
    slot_ok = (torch.arange(P, device=dev)[None, None, :] <
               npred.to(i32)[:, :, None]).repeat_interleave(2, dim=2)
    kidx = torch.arange(2 * P, dtype=torch.int8, device=dev)[None, :, None]
    negdiag = torch.full((B, P, 1), NEG, dtype=i32, device=dev)
    # The slots filled in some pair, a row: the others are NEG in every
    # pair and never win, so the stack stops before them.
    slots = npred[:, :rows_needed].amax(0).clamp(min=1).tolist() \
        if B else []
    # A cell's move (0 diag, 1 del, 2 ins) and predecessor slot, as
    # slot * 4 + move (P <= 32 fits int8).
    codes = torch.zeros((B, max(rows_needed, 1), W), dtype=torch.int8,
                        device=dev)
    for i in range(1, rows_needed + 1):
        p = slots[i - 1]
        rows = Hf.index_select(0, pred_in_hf[:, i - 1, :p].reshape(-1)).view(
            B, p, W)
        sub = sub_by_base.index_select(0, sub_row[:, i - 1])
        diag = torch.cat([negdiag[:, :p], rows[:, :, :-1]], 2) + sub[:, None]
        stack = torch.stack([rows + GAP, diag], 2).view(B, 2 * p, W)
        stack = torch.where(slot_ok[:, i - 1, :2 * p, None], stack, NEG)
        # The first maximum of the stack wins (each later slot was taken
        # only where strictly greater).
        best = stack.amax(1)
        sel = torch.where(stack == best[:, None], kidx[:, :2 * p],
                          2 * P).amin(1)
        cm = torch.cummax(best - gapj, dim=1).values
        left = torch.cat([negcol, cm[:, :-1]], 1) + gapj
        use_ins = left > best                              # strict
        # sel = 2 * slot + (0 del, 1 diag): code slot * 4 + 1 - sel % 2.
        codes[:, i - 1] = torch.where(use_ins, 2, sel * 2 - sel % 2 * 3 + 1)
        row = torch.where(use_ins, left, best)
        H[:, i] = torch.where(jvalid & (i <= V)[:, None], row, NEG)

    finals = torch.full((B, Vmax), NEG, dtype=i32, device=dev)
    finals[:, :rows_needed] = H[bidx, 1:, n.long()]        # H[i, n]
    sink_ok = is_sink & (torch.arange(Vmax, device=dev)[None, :] < V[:, None])
    scores = torch.where(sink_ok, finals, NEG)
    end_row = torch.argmax(scores, dim=1) + 1              # lowest rank tie
    score = scores[bidx, end_row - 1]

    # The walk, one step of every pair at a time, through flat indices:
    # (i, j) reads the code of row i-1, column j; row 0 moves left.  A
    # diag or del move goes to the predecessor row its slot names; each
    # row is matched at most once, so the marks are added.
    matched = torch.zeros((B, Vmax), dtype=torch.int8, device=dev)
    ins_after = torch.zeros((B, Vmax + 1), dtype=torch.int32, device=dev)
    codes_f = codes.view(-1)
    pred_f = pred_long.view(-1)
    code_row = bidx * codes.shape[1]
    i = end_row.long()
    j = n.long()
    while B and bool(((i > 0) | (j > 0)).any()):
        im1 = (i - 1).clamp(min=0)
        c = codes_f[(code_row + im1) * W + j].long()
        m = torch.where(i == 0, 2, c & 3)
        dg = m == 0
        ins = (m == 2) & (j > 0)
        matched.view(-1).index_put_((bidx * Vmax + im1,), dg.to(torch.int8),
                                    accumulate=True)
        ins_after.view(-1).index_put_((bidx * (Vmax + 1) + i,),
                                      ins.to(i32), accumulate=True)
        prow = pred_f[(bidx * Vmax + im1) * P + (c >> 2)]
        i = torch.where(m < 2, prow, i)
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
