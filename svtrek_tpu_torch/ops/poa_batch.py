"""Batched star-MSA consensus: many clusters' member alignments per call.

Port of svtrek_tpu/ops/poa_batch.py (`_segments_from_counts`,
`banded_cols_batch`, `consensus_sequence_batch`), line for line where the
output depends on it: the scalar fallback of degenerate pairs, the
`s[: 4 * m]` query cut, `max_len`, the fixed point and `rounds`.  The DP
runs in `ops.poa_dp.dp_cols` on the given device.  The JAX package's pow2
shape buckets (`_nbucket`), its dispatch policy and its band cap of 512
exist to limit what one outlier costs a TPU kernel's compiled shape and
are not carried over: pairs are padded to the batch's longest target and
query, K2 stores each pair at its own band (up to kernels.POA_MAX_BAND),
and a pair's result depends on neither.  Every route is exact, so the
output is the JAX package's.
"""
from __future__ import annotations

import numpy as np
import torch

from .poa import (
    accumulate_votes, assemble_consensus, banded_align_ins, decode,
    decode_ins, encode, majority_length_mode, new_vote_state,
)
from ..kernels import POA_MAX_BAND, POA_STRIP_MAX_BAND
from ..tracing import span
from .poa_dp import PAD, dp_cols

# svtrek_tpu's band cap: wider pairs take its scalar host DP, and here
# they are counted in counts["band_wide"].
JAX_BAND_CAP = 512


def _segments_from_counts(query: np.ndarray, cols: np.ndarray,
                          ins_counts: np.ndarray) -> list[str]:
    """Reconstruct the inserted query segment per boundary from the
    per-boundary counts: the global alignment consumes the query
    monotonically, so boundary j's insert is the ins_counts[j] query bases
    after the ones consumed before it (inserts and aligned columns before
    j), identical to the scalar banded_align_ins segments."""
    m = len(cols)
    segs = [""] * (m + 1)
    used = ins_counts.astype(np.int64)
    used[:m] += cols >= 0
    start = np.cumsum(used) - used
    for j in np.flatnonzero(ins_counts).tolist():
        segs[j] = decode(query[start[j]: start[j] + ins_counts[j]])
    return segs


def flat_index(ms: np.ndarray, M: int) -> np.ndarray:
    """The flat index, into a [B, M+1] row-major array, of each pair's
    columns 0..m_b: pair b's m_b+1 entries start at (m + 1)'s exclusive
    prefix sum.  int32 where B*(M+1) fits, else int64."""
    lens = ms.astype(np.int64) + 1
    starts = np.cumsum(lens) - lens
    shift = np.arange(len(ms), dtype=np.int64) * (M + 1) - starts
    idx = np.arange(int(lens.sum()), dtype=np.int64) + np.repeat(shift, lens)
    return idx.astype(np.int32 if len(ms) * (M + 1) < 1 << 31 else np.int64)


def cols_ins_flat(cols: torch.Tensor, ins: torch.Tensor, idx: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """A DP batch's cols [B, M] int8 and ins [B, M+1] int32 at each pair's
    own width: both gathered at ``idx`` (`flat_index`, on their device;
    cols padded by one column, so that both share it) into flat CPU
    tensors, pair b's cols and ins at the same offset.  On CUDA each
    comes back in one non-blocking copy into pinned memory, then the
    stream is synchronized once: Σ(m+1) + 4·Σ(m+1) bytes, not the padded
    B·M + 4·B·(M+1)."""
    cols_f = torch.nn.functional.pad(cols, (0, 1)).view(-1).index_select(
        0, idx)
    ins_f = ins.reshape(-1).index_select(0, idx)
    if cols.device.type == "cpu":
        return cols_f, ins_f
    host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            for t in (cols_f, ins_f)]
    for h, t in zip(host, (cols_f, ins_f)):
        h.copy_(t, non_blocking=True)
    torch.cuda.current_stream(cols.device).synchronize()
    return host[0], host[1]


def banded_cols_batch(targets, queries, band: int = 64,
                      band_cap: int = POA_MAX_BAND, *,
                      device: torch.device | str = "cpu",
                      counts: dict | None = None):
    """Batched drop-in for ``banded_align_ins`` over pair lists.

    targets/queries: lists of int8 numpy arrays.  Returns
    (cols_list, segs_list): per pair, the per-target-column query bases
    and the decoded inserted segment per boundary.  Pairs whose effective
    band max(band, |n-m|+1) exceeds ``band_cap`` (K2's widest by default)
    or reaches the summed lengths go through the scalar host path; the
    others through one `dp_cols` call on ``device``.  With ``counts``:
    counts["dp_calls"] counts that call, counts["band_wide"] the pairs it
    takes with a band above JAX_BAND_CAP (those the JAX package sends to
    the host), counts["band_wide_k2"] those with a band above
    kernels.POA_STRIP_MAX_BAND (K2's wide kernel's on CUDA),
    counts["band_scalar"] the pairs on the host path."""
    assert len(targets) == len(queries)
    nn = len(targets)
    cols_out = [None] * nn
    segs_out = [None] * nn
    dev_idx = []
    wide = wide_k2 = 0
    for i, (t, q) in enumerate(zip(targets, queries)):
        eb = max(band, abs(len(q) - len(t)) + 1)
        if eb > band_cap or eb >= max(len(t), 1) + len(q):
            cols_out[i], ins = banded_align_ins(t, q, band)
            segs_out[i] = decode_ins(ins)
        else:
            dev_idx.append(i)
            wide += eb > JAX_BAND_CAP
            wide_k2 += eb > POA_STRIP_MAX_BAND
    if counts is not None:
        counts["band_wide"] = counts.get("band_wide", 0) + wide
        counts["band_wide_k2"] = counts.get("band_wide_k2", 0) + wide_k2
        counts["band_scalar"] = counts.get("band_scalar", 0) + \
            nn - len(dev_idx)
    if not dev_idx:
        return cols_out, segs_out
    B = len(dev_idx)
    ms = np.array([len(targets[i]) for i in dev_idx], np.int32)
    ns = np.array([len(queries[i]) for i in dev_idx], np.int32)
    bands = np.maximum(band, np.abs(ns - ms) + 1).astype(np.int32)
    tpad = np.full((B, int(ms.max())), PAD, np.int8)
    qpad = np.full((B, int(ns.max())), PAD, np.int8)
    for bi, i in enumerate(dev_idx):
        tpad[bi, : ms[bi]] = targets[i]
        qpad[bi, : ns[bi]] = queries[i]
    tpad_d, ms_d, qpad_d, ns_d, bands_d, idx_d = (
        torch.from_numpy(a).to(device) for a in (
            tpad, ms, qpad, ns, bands, flat_index(ms, tpad.shape[1])))
    cols_h, ins_h = (t.numpy() for t in cols_ins_flat(
        *dp_cols(tpad_d, ms_d, qpad_d, ns_d, bands_d), idx_d))
    if counts is not None:
        counts["dp_calls"] = counts.get("dp_calls", 0) + 1
    start = 0
    for bi, i in enumerate(dev_idx):
        m = int(ms[bi])
        cols_out[i] = cols_h[start: start + m]
        segs_out[i] = _segments_from_counts(
            queries[i], cols_out[i], ins_h[start: start + m + 1])
        start += m + 1
    return cols_out, segs_out


def consensus_sequence_batch(clusters, band: int = 64, max_len: int = 4096,
                             rounds: int = 2, *,
                             device: torch.device | str = "cpu",
                             counts: dict | None = None) -> list[str]:
    """Batched consensus: the semantics of svtrek_tpu's scalar
    ``consensus_sequence`` (majority-mode selection, length-medoid seed,
    star alignment with insertion recovery, realign until a fixed point or
    ``rounds``) applied to many clusters, with every round's member to
    consensus alignments across ALL clusters in one `banded_cols_batch`
    call on ``device`` (``counts`` as there).  With ``counts``,
    counts["vote_s"] times the host's part (mode and seed selection,
    encode, `accumulate_votes`, `assemble_consensus`; profiler range
    `svtrek.cons.vote`) and counts["dp_s"] the `banded_cols_batch` calls
    (a timer only: they launch and wait for the device)."""
    results: list[str | None] = [None] * len(clusters)
    active: dict[int, tuple[list[str], str]] = {}
    with span(counts, "vote_s", "svtrek.cons.vote", round=0):
        for ci, seqs in enumerate(clusters):
            seqs = [s for s in seqs if s]
            if not seqs:
                results[ci] = ""
                continue
            if len(seqs) == 1:
                results[ci] = seqs[0]
                continue
            members = majority_length_mode(seqs)
            if len(members) == 1:
                results[ci] = members[0]
                continue
            order = sorted(range(len(members)),
                           key=lambda i: len(members[i]))
            cons = members[order[len(order) // 2]]
            if len(cons) > max_len:
                results[ci] = cons
                continue
            active[ci] = (members, cons)

    for r in range(1, max(rounds, 1) + 1):
        if not active:
            break
        votes = {}
        insv = {}
        pair_ci: list[int] = []
        pair_t: list[np.ndarray] = []
        pair_q: list[np.ndarray] = []
        with span(counts, "vote_s", "svtrek.cons.vote", round=r):
            for ci, (members, cons) in active.items():
                target = encode(cons)
                m = len(target)
                v, iv = new_vote_state(target)
                for s in members:
                    if s == cons:
                        v[np.arange(m), target] += 1
                    else:
                        pair_ci.append(ci)
                        pair_t.append(target)
                        pair_q.append(encode(s[: 4 * m]))
                votes[ci] = v
                insv[ci] = iv
        if pair_ci:
            with span(counts, "dp_s"):
                all_cols, all_segs = banded_cols_batch(
                    pair_t, pair_q, band, device=device, counts=counts)
        with span(counts, "vote_s", "svtrek.cons.vote", round=r):
            if pair_ci:
                for ci, cols, segs in zip(pair_ci, all_cols, all_segs):
                    accumulate_votes(votes[ci], insv[ci], cols, segs)
            nxt: dict[int, tuple[list[str], str]] = {}
            for ci, (members, cons) in active.items():
                new = assemble_consensus(votes[ci], insv[ci], len(members))
                if not new or new == cons:
                    results[ci] = cons
                else:
                    nxt[ci] = (members, new)
        active = nxt
    for ci, (_members, cons) in active.items():  # rounds exhausted
        results[ci] = cons
    return results  # type: ignore[return-value]
