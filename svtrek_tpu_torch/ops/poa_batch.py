"""Batched star-MSA consensus: many clusters' member alignments per call.

Port of svtrek_tpu/ops/poa_batch.py (`_segments_from_counts`,
`banded_cols_batch`, `consensus_sequence_batch`), line for line where the
output depends on it: the band_cap scalar fallback, the `s[: 4 * m]` query
cut, `max_len`, the fixed point and `rounds`.  The DP runs in
`ops.poa_dp.dp_cols` on the given device.  The JAX package's pow2 shape
buckets (`_nbucket`) and its dispatch policy exist to limit TPU kernel
recompiles and are not carried over: pairs are padded to the batch's
longest target and query, and a pair's result does not depend on that
padding.
"""
from __future__ import annotations

import numpy as np
import torch

from .poa import (
    accumulate_votes, assemble_consensus, banded_align_ins, decode,
    decode_ins, encode, majority_length_mode, new_vote_state,
)
from .poa_dp import PAD, dp_cols


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


def banded_cols_batch(targets, queries, band: int = 64, band_cap: int = 512,
                      *, device: torch.device | str = "cpu",
                      counts: dict | None = None):
    """Batched drop-in for ``banded_align_ins`` over pair lists.

    targets/queries: lists of int8 numpy arrays.  Returns
    (cols_list, segs_list): per pair, the per-target-column query bases
    and the decoded inserted segment per boundary.  Pairs whose effective
    band max(band, |n-m|+1) exceeds ``band_cap`` or reaches the summed
    lengths go through the scalar host path; the others through one
    `dp_cols` call on ``device``, counted in ``counts["dp_calls"]`` when
    ``counts`` is given."""
    assert len(targets) == len(queries)
    nn = len(targets)
    cols_out = [None] * nn
    segs_out = [None] * nn
    dev_idx = []
    for i, (t, q) in enumerate(zip(targets, queries)):
        eb = max(band, abs(len(q) - len(t)) + 1)
        if eb > band_cap or eb >= max(len(t), 1) + len(q):
            cols_out[i], ins = banded_align_ins(t, q, band)
            segs_out[i] = decode_ins(ins)
        else:
            dev_idx.append(i)
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
    cols_all, ins_all = (x.cpu().numpy() for x in dp_cols(
        *(torch.from_numpy(a).to(device)
          for a in (tpad, ms, qpad, ns, bands))))
    if counts is not None:
        counts["dp_calls"] = counts.get("dp_calls", 0) + 1
    for bi, i in enumerate(dev_idx):
        cols_out[i] = cols_all[bi, : ms[bi]]
        segs_out[i] = _segments_from_counts(
            queries[i], cols_out[i], ins_all[bi, : ms[bi] + 1])
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
    call on ``device`` (``counts`` as there)."""
    results: list[str | None] = [None] * len(clusters)
    active: dict[int, tuple[list[str], str]] = {}
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
        order = sorted(range(len(members)), key=lambda i: len(members[i]))
        cons = members[order[len(order) // 2]]
        if len(cons) > max_len:
            results[ci] = cons
            continue
        active[ci] = (members, cons)

    for _ in range(max(rounds, 1)):
        if not active:
            break
        votes = {}
        insv = {}
        pair_ci: list[int] = []
        pair_t: list[np.ndarray] = []
        pair_q: list[np.ndarray] = []
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
            all_cols, all_segs = banded_cols_batch(
                pair_t, pair_q, band, device=device, counts=counts)
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
