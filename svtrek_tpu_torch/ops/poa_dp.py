"""Banded global-alignment DP, traceback and vote for the star consensus.

Counterpart of svtrek_tpu/ops/poa_pallas.py (kernels K2 and K3) and of the
DP half of svtrek_tpu/ops/poa_batch.py.  `dp_cols` is the dispatch: CUDA
tensors go to the hand-written kernels (csrc/poa.cu through
`kernels.poa_dp_cols_cuda`: K2, then K3 on K2's plan), CPU tensors
to the plain PyTorch versions here, `dp_ptr_reference` and
`traceback_reference`.  `vote` turns a round's cols and insert counts into
each cluster's new consensus (svtrek_tpu/ops/poa.py's `accumulate_votes`
and `assemble_consensus`, on the host there): kernel K5 for CUDA tensors
(`kernels.poa_vote_cuda`), `vote_reference` for CPU tensors.  The choice
is made by the tensors' device; there is no fallback from one to the
other.

The plain versions follow the JAX program step by step: one step per query
row over a band of 2W+1 cells with the same int32 algebra (NEG = -2^28,
ties to diag over up, left only when strictly greater, the j == 0 boundary
while i <= band, the in-row left gaps as an exclusive cummax), then the
walk from (n, m) stepped over all pairs at once.

A pair's result depends only on its own m, n and band: any storage width W
>= its band gives it the same pointers on its band's cells, and the walk
never leaves its band.  So the kernels store each pair at its own width
(`kernels.poa_ptr_offsets`), and the plain path works through the pairs in
chunks of at most PLAIN_CHUNK_BYTES pointer bytes, each at the widest band
of its chunk, instead of holding [N, B, 2W+1] for the whole batch.
"""
from __future__ import annotations

from collections import Counter

import numpy as np
import torch

from ..tracing import add
from .poa import _DEC, GAP, MATCH, MISMATCH

# NEG is far below every reachable score, as the scalar DP's -10^9 in
# int64 is (ops/poa.py): a cell's score is at least GAP * (i + j) and at
# most MATCH * min(i, j), and the pairs reach m <= 4,096 (max_len) with
# |n - m| < band <= 2,048 (kernels.POA_MAX_BAND), so n <= 6,143 and every
# score lies in [-2 * 10,239, 8,192] = [-20,478, 8,192].  A value built on
# NEG stays below NEG + 2 * (2 * 2,048 + 1) = -2^28 + 8,194 (a left gap's
# prefix term adds at most -GAP a cell of the band), so it never wins
# over a reachable score, and nothing comes near int32's -2^31.  (A later
# round's consensus may pass max_len a little; the margin holds to m of
# tens of millions.)
NEG = -(1 << 28)
PAD = 5  # the padding base of tpad/qpad
PLAIN_CHUNK_BYTES = 1 << 27

# Calls of the plain versions through `dp_cols` and `vote` (the CPU route).
plain_calls: dict[str, int] = {"poa_dp_ptr": 0, "poa_traceback": 0,
                               "poa_vote": 0}


def dp_ptr_reference(tpad: torch.Tensor, ms: torch.Tensor,
                     qpad: torch.Tensor, ns: torch.Tensor,
                     bands: torch.Tensor, *, W: int) -> torch.Tensor:
    """Pointer rows [N, B, 2W+1] int8 of the banded DP, row i-1 holding
    query row i (0 diag, 1 up, 2 left), band cell k at target column
    j = i + k - W.  tpad [B, M] / qpad [B, N] int8 padded with 5; ms, ns,
    bands [B] with bands <= W.  Equal to svtrek_tpu's `dp_ptr_pallas` on
    the first 2W+1 lanes of every row 1..n of every pair."""
    B, M = tpad.shape
    N = qpad.shape[1]
    dev = tpad.device
    width = 2 * W + 1
    i32 = torch.int32
    karr = torch.arange(width, dtype=i32, device=dev)
    gapk = GAP * karr
    neg = torch.tensor(NEG, dtype=i32, device=dev)
    negcol = torch.full((B, 1), NEG, dtype=i32, device=dev)
    # tbig[:, i + k] is the target base of row i's cell k (t[j-1]); padded
    # for the largest row start i = N, as _dp_one's tbig is.
    tbig = torch.full((B, max(M, N) + 2 * W + 2), PAD, dtype=torch.int8,
                      device=dev)
    tbig[:, W + 1:W + 1 + M] = tpad
    m = ms.to(i32)[:, None]
    band = bands.to(i32)[:, None]
    # Cell k of row i is column j = i + k - W: |j - i| <= band does not
    # depend on the row, and 1 <= j <= m is k >= W+1-i and k <= m+W-i.
    inband = (karr - W).abs() <= band
    m_w = m + W
    j0 = karr - W
    row = torch.where((j0 >= 0) & (j0 <= torch.minimum(m, band)), GAP * j0,
                      neg)
    ptr = torch.empty((N, B, width), dtype=torch.int8, device=dev)
    for i in range(1, N + 1):
        same = tbig[:, i:i + width] == qpad[:, i - 1:i]
        diag = row + torch.where(same, MATCH, MISMATCH).to(i32)
        up = torch.cat([row[:, 1:], negcol], 1) + GAP
        pc = (up > diag).to(torch.int8)  # a tie goes to diag
        validj = inband & (karr >= W + 1 - i) & (karr <= m_w - i)
        cand = torch.where(validj, torch.maximum(diag, up), neg)
        # The left-column boundary score[i, 0] = GAP*i while i <= band is
        # cell W - i; it takes part as a left-gap source.
        b0 = W - i
        if b0 >= 0:
            bmask = band[:, 0] >= i
            cand[:, b0] = torch.where(bmask, GAP * i, cand[:, b0])
            pc[:, b0] = torch.where(bmask, 1, pc[:, b0])
        # In-row left gaps: score[k] = GAP*k + max_{k'<k} (cand[k'] - GAP*k').
        cm = torch.cummax(cand - gapk, dim=1).values
        left = torch.cat([negcol, cm[:, :-1]], 1) + gapk
        use_left = validj & (left > cand)  # strict
        ptr[i - 1] = torch.where(use_left, 2, pc)
        # Cells outside the band (and the boundary cell once i > band) are
        # NEG again, so the prefix max never carries a score across the
        # band edge.
        row = torch.where(use_left, left, torch.where(validj, cand, neg))
        if b0 >= 0:
            row[:, b0] = torch.where(bmask, GAP * i, NEG)
    return ptr


def traceback_reference(ptr: torch.Tensor, offsets: torch.Tensor,
                        qpad: torch.Tensor, ms: torch.Tensor,
                        ns: torch.Tensor, bands: torch.Tensor, *, M: int
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """The walk from (n, m) to (0, 0) over pointers in K2's layout
    (`pointers_by_pair`), one step of every pair at a time (svtrek_tpu's
    `_traceback_one`): row 0 moves left, column 0 moves up, a diag move
    puts the query base on target column j-1, an up move counts an insert
    at boundary j.  Returns (cols [B, M] int8, -1 = gap; ins [B, M+1]
    int32)."""
    B = qpad.shape[0]
    dev = qpad.device
    i = ns.long().clone()
    j = ms.long().clone()
    band = bands.long()
    width = 2 * band + 1
    base = offsets[:-1].long() - width  # + i*width = row i-1
    bidx = torch.arange(B, device=dev)
    # Column M and boundary M+1 are dump slots for the pairs that do not
    # write in a step.
    cols_idx = torch.full((B, M + 1), -1, dtype=torch.long, device=dev)
    ins = torch.zeros((B, M + 2), dtype=torch.int32, device=dev)
    flat = ptr if ptr.numel() else torch.zeros(1, dtype=torch.int8,
                                               device=dev)
    steps = int((i + j).max()) if B else 0
    for _ in range(steps):
        k = torch.minimum((j - i + band).clamp(min=0), 2 * band)
        p = flat[torch.where(i > 0, base + i * width + k, 0)]
        p = torch.where(i == 0, 2, torch.where(j == 0, 1, p))
        dg = (i > 0) & (j > 0) & (p == 0)
        up = ~dg & (i > 0) & (p == 1)
        lf = ~dg & ~up & (j > 0)
        cols_idx[bidx, torch.where(dg, j - 1, M)] = torch.where(dg, i - 1, -1)
        ins[bidx, torch.where(up, j, M + 1)] += 1
        i = i - (dg | up).long()
        j = j - (dg | lf).long()
    qsafe = qpad if qpad.shape[1] else qpad.new_full((B, 1), PAD)
    qi = cols_idx[:, :M]
    bases = torch.gather(qsafe, 1, qi.clamp(0, qsafe.shape[1] - 1))
    cols = torch.where(qi >= 0, bases, torch.full_like(bases, -1))
    return cols.to(torch.int8), ins[:, :M + 1]


def pointers_by_pair(ptr: torch.Tensor, ns: torch.Tensor,
                     bands: torch.Tensor, *, W: int,
                     out: torch.Tensor | None = None,
                     offsets: torch.Tensor | None = None) -> torch.Tensor:
    """`dp_ptr_reference`'s [N, B, 2W+1] pointers in K2's layout: each
    pair's rows 1..n, cells W-band..W+band, at its offset (by default
    `kernels.poa_ptr_offsets(ns, bands)` in a new buffer)."""
    if out is None:
        from ..kernels import poa_ptr_offsets

        offsets = poa_ptr_offsets(ns, bands)
        out = ptr.new_empty(int(offsets[-1]))
    for b, (n, w, o) in enumerate(zip(ns.tolist(), bands.tolist(),
                                      offsets.tolist())):
        out[o:o + n * (2 * w + 1)] = ptr[:n, b, W - w:W + w + 1].reshape(-1)
    return out


def _dp_cols_plain(tpad, ms, qpad, ns, bands):
    """The plain DP over chunks of pairs of similar query length, each
    chunk stored at its own widest band and padded to its own longest
    target and query, into K2's layout; then one traceback of all pairs."""
    from ..kernels import poa_ptr_offsets

    B, M = tpad.shape
    offsets = poa_ptr_offsets(ns, bands)
    packed = torch.empty(int(offsets[-1]), dtype=torch.int8)
    n_h, m_h, band_h = ns.tolist(), ms.tolist(), bands.tolist()
    if any(abs(n - m) > w for n, m, w in zip(n_h, m_h, band_h)):
        raise ValueError("every pair needs band >= |n - m|")

    def run(chunk):
        idx = torch.tensor(chunk, dtype=torch.long)
        Wc = max(band_h[b] for b in chunk)
        t = tpad[idx, :max(m_h[b] for b in chunk)]
        q = qpad[idx, :max(n_h[b] for b in chunk)]
        ptr = dp_ptr_reference(t, ms[idx], q, ns[idx], bands[idx], W=Wc)
        pointers_by_pair(ptr, ns[idx], bands[idx], W=Wc, out=packed,
                         offsets=offsets[idx])

    # Pairs sorted by query length; a chunk ends at PLAIN_CHUNK_BYTES or
    # where the query length doubles, so no pair pads past twice its rows.
    chunk: list[int] = []
    widest = 0
    for b in sorted(range(B), key=lambda b: n_h[b]):
        w = max(widest, band_h[b])
        if chunk and (n_h[b] > 2 * n_h[chunk[0]] or (len(chunk) + 1)
                      * n_h[b] * (2 * w + 1) > PLAIN_CHUNK_BYTES):
            run(chunk)
            chunk, w = [], band_h[b]
        chunk.append(b)
        widest = w
    if chunk:
        run(chunk)
    return traceback_reference(packed, offsets, qpad, ms, ns, bands, M=M)


def dp_cols(tpad: torch.Tensor, ms: torch.Tensor, qpad: torch.Tensor,
            ns: torch.Tensor, bands: torch.Tensor
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Banded DP + traceback of a batch of (target, query) pairs on the
    tensors' device: kernels K2 and K3 for CUDA tensors, the plain versions
    for CPU tensors.

    tpad [B, M] / qpad [B, N] int8 bases padded with 5; ms, ns, bands [B]
    int32 with band >= |n - m| (`poa_batch.dp_pairs` sets |n - m| + 1 or
    more), so that the walk starts inside the band.  Returns
    (cols [B, M] int8, ins [B, M+1] int32), svtrek_tpu's
    `_dp_cols_batch` outputs for any storage W >= max(bands)."""
    if tpad.device.type == "cuda":
        from ..kernels import poa_dp_cols_cuda

        return poa_dp_cols_cuda(tpad, ms, qpad, ns, bands)
    if tpad.device.type != "cpu":
        raise ValueError(f"no POA DP path for device {tpad.device}")
    plain_calls["poa_dp_ptr"] += 1
    plain_calls["poa_traceback"] += 1
    return _dp_cols_plain(tpad, ms, qpad, ns, bands)


def vote_reference(cols: torch.Tensor, ins: torch.Tensor, qpad: torch.Tensor,
                   meta: torch.Tensor, targets: torch.Tensor, total: int
                   ) -> torch.Tensor:
    """The plain version of `vote`, on CPU tensors: per cluster, the
    column votes by one bincount, each pair's inserts cut from its query
    at the exclusive sum of ins + (cols >= 0) before their boundary
    (a pair's query is consumed in order), a Counter a boundary with an
    insert, then the assembly of svtrek_tpu's `assemble_consensus`."""
    out = torch.zeros(total, dtype=torch.uint8)
    buf, rows = out.numpy(), meta.tolist()
    C = len(rows)
    lens = buf[:4 * C].view(np.int32)
    cols_n, ins_n, q_n, t_n = (t.numpy() for t in (cols, ins, qpad, targets))
    for c, (lo, hi, m, n_members, n_equal, t_off, o_off, cap) in \
            enumerate(rows):
        tgt = t_n[t_off:t_off + m].astype(np.int64)
        # (a round with no pair may come with cols [0, 0] and ins [0, 1])
        cl = cols_n[lo:hi, :m].reshape(hi - lo, m)
        code = np.where(cl < 0, 5, cl).astype(np.int64)
        votes = np.bincount((np.arange(m) * 6 + code).ravel(),
                            minlength=6 * m).reshape(m, 6)
        votes[np.arange(m), tgt] += n_equal
        winner = votes.argmax(axis=1)
        counts = ins_n[lo:hi, :m + 1].reshape(hi - lo, m + 1).astype(
            np.int64)
        used = counts.copy()
        used[:, :m] += cl >= 0
        start = np.cumsum(used, axis=1) - used
        segs: dict[int, Counter] = {}
        for p, j in zip(*(a.tolist() for a in np.nonzero(counts))):
            s = start[p, j]
            segs.setdefault(j, Counter())[
                q_n[lo + p, s:s + counts[p, j]].tobytes()] += 1
        keep = {}
        for j, ctr in segs.items():
            seg, n = ctr.most_common(1)[0]
            if n > n_members // 2:
                keep[j] = _DEC[np.frombuffer(seg, np.int8)].tobytes()
        bases = _DEC[winner]
        kept = winner != 5
        parts, prev = [], 0
        for j in sorted(keep):
            parts += [bases[prev:j][kept[prev:j]].tobytes(), keep[j]]
            prev = j
        parts.append(bases[prev:][kept[prev:]].tobytes())
        seq = b"".join(parts)
        if len(seq) > cap:
            lens[c] = -1
            continue
        lens[c] = len(seq)
        buf[4 * C + o_off:4 * C + o_off + len(seq)] = np.frombuffer(
            seq, np.uint8)
    return out


def vote(cols: torch.Tensor, ins: torch.Tensor, qpad: torch.Tensor,
         meta: torch.Tensor, targets: torch.Tensor, total: int, *,
         counts: dict | None = None) -> torch.Tensor:
    """One round's vote of every cluster on the tensors' device: kernel K5
    for CUDA tensors, the plain version for CPU tensors.

    cols [B, M] int8 and ins [B, M+1] int32 of the round's pairs (`dp_cols`
    outputs, or the host DP's rows), qpad [B, N] int8 their queries;
    meta [C, kernels.POA_VOTE_META] int64, a row a cluster: its pairs'
    rows [lo, hi), m, n_members, n_equal (members equal to the target:
    each votes the target's base on every column and no insert), the
    offset of its m target codes in targets (int8), and the offset and
    size (at least m + 2 x its longest query) of its output.  Returns
    uint8 [total]: C int32 lengths (-1 where the output passed its size),
    then at 4 C + offset each cluster's new consensus in ASCII: the
    column's majority (the first of A C G T N gap; a gap drops the column)
    and each boundary's insert supported by more than n_members // 2.
    With ``counts``, counts["vote_card"] adds the clusters of each K5
    launch made (`kernels.launch_counts["poa_vote"]`)."""
    if cols.device.type == "cuda":
        from ..kernels import launch_counts, poa_vote_cuda

        before = launch_counts["poa_vote"]
        out = poa_vote_cuda(cols, ins, qpad, meta, targets, total)
        add(counts, "vote_card",
            meta.shape[0] * (launch_counts["poa_vote"] - before))
        return out
    if cols.device.type != "cpu":
        raise ValueError(f"no POA vote path for device {cols.device}")
    plain_calls["poa_vote"] += 1
    return vote_reference(cols, ins, qpad, meta, targets, total)
