"""Batched star-MSA consensus: many clusters' member alignments per call.

Port of svtrek_tpu/ops/poa_batch.py's `consensus_sequence_batch` (its
`banded_cols_batch` is `dp_pairs`, whose rows stay on the device), line
for line where the output depends on it: the scalar fallback of
degenerate pairs, the `s[: 4 * m]` query cut, `max_len`, the fixed point
and `rounds`.  The DP runs in `ops.poa_dp.dp_cols` on the given device,
and so does the vote (`ops.poa_dp.vote`, which the JAX package does on
the host with a Counter a boundary): a round's pairs stay on the device
from the DP to the vote, and each cluster's new consensus comes back in
one copy.  The JAX
package's pow2 shape buckets (`_nbucket`), its dispatch policy and its
band cap of 512 exist to limit what one outlier costs a TPU kernel's
compiled shape and are not carried over: pairs are padded to the batch's
longest target and query, K2 stores each pair at its own band (up to
kernels.POA_MAX_BAND), and a pair's result depends on neither.  Every
route is exact, so the output is the JAX package's.
"""
from __future__ import annotations

import numpy as np
import torch

from .poa import banded_align_ins, encode, majority_length_mode
from ..kernels import POA_MAX_BAND, POA_STRIP_MAX_BAND
from ..tracing import add, span
from .poa_dp import PAD, dp_cols, vote

# svtrek_tpu's band cap: wider pairs take its scalar host DP, and here
# they are counted in counts["band_wide"].
JAX_BAND_CAP = 512


def dp_pairs(targets, queries, band: int = 64, band_cap: int = POA_MAX_BAND,
             *, device: torch.device | str = "cpu",
             counts: dict | None = None):
    """The DP of a list of (target, query) pairs, left on ``device``:
    returns (cols [B, M] int8, ins [B, M+1] int32, qpad [B, N] int8), pair
    i in row i, M and N the longest target and query (`dp_cols`'s
    outputs, and the queries padded with PAD).

    targets/queries: lists of int8 numpy arrays.  Pairs whose effective
    band max(band, |n-m|+1) exceeds ``band_cap`` (K2's widest by default)
    or reaches the summed lengths go through the scalar host DP
    (`banded_align_ins`), whose cols and insert counts are copied into
    their rows; the others through one `dp_cols` call.  With ``counts``:
    counts["dp_calls"] counts that call, counts["band_wide"] the pairs it
    takes with a band above JAX_BAND_CAP (those the JAX package sends to
    the host), counts["band_wide_k2"] those with a band above
    kernels.POA_STRIP_MAX_BAND (K2's wide kernel's on CUDA),
    counts["band_scalar"] the pairs on the host path."""
    assert len(targets) == len(queries)
    nn = len(targets)
    ms = np.array([len(t) for t in targets], np.int32)
    ns = np.array([len(q) for q in queries], np.int32)
    bands = np.maximum(band, np.abs(ns - ms) + 1).astype(np.int32)
    host = (bands > band_cap) | (bands >= np.maximum(ms, 1) + ns)
    dev_idx = np.flatnonzero(~host)
    if counts is not None:
        counts["band_wide"] = counts.get("band_wide", 0) + int(
            (bands[dev_idx] > JAX_BAND_CAP).sum())
        counts["band_wide_k2"] = counts.get("band_wide_k2", 0) + int(
            (bands[dev_idx] > POA_STRIP_MAX_BAND).sum())
        counts["band_scalar"] = counts.get("band_scalar", 0) + \
            nn - len(dev_idx)
    M, N = int(ms.max(initial=0)), int(ns.max(initial=0))
    qpad = np.full((nn, N), PAD, np.int8)
    for i, q in enumerate(queries):
        qpad[i, :len(q)] = q
    qpad_d = torch.from_numpy(qpad).to(device)
    if len(dev_idx):
        Md = int(ms[dev_idx].max())
        tpad = np.full((len(dev_idx), Md), PAD, np.int8)
        for bi, i in enumerate(dev_idx.tolist()):
            tpad[bi, :ms[i]] = targets[i]
        sel = None if len(dev_idx) == nn else \
            torch.from_numpy(dev_idx).to(device)
        q_dev = qpad_d if sel is None else qpad_d.index_select(0, sel)
        tpad_d, ms_d, ns_d, bands_d = (
            torch.from_numpy(a).to(device)
            for a in (tpad, ms[dev_idx], ns[dev_idx], bands[dev_idx]))
        cols, ins = dp_cols(tpad_d, ms_d, q_dev, ns_d, bands_d)
        if counts is not None:
            counts["dp_calls"] = counts.get("dp_calls", 0) + 1
        if sel is None:
            return cols, ins, qpad_d
    # Some pairs took the host DP: every pair's row in arrays of M columns.
    cols_h = np.full((nn, M), -1, np.int8)
    ins_h = np.zeros((nn, M + 1), np.int32)
    for i in np.flatnonzero(host).tolist():
        c, segs = banded_align_ins(targets[i], queries[i], band)
        cols_h[i, :ms[i]] = c
        ins_h[i, :ms[i] + 1] = [len(seg) for seg in segs]
    cols_all, ins_all = (torch.from_numpy(a).to(device)
                         for a in (cols_h, ins_h))
    if len(dev_idx):
        cols_all[sel, :Md] = cols
        ins_all[sel, :Md + 1] = ins
    return cols_all, ins_all, qpad_d


def vote_to_host(out: torch.Tensor) -> torch.Tensor:
    """A round's vote output on the host: on CUDA one non-blocking copy
    into pinned memory, then one wait on the current stream."""
    if out.device.type == "cpu":
        return out
    host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
    host.copy_(out, non_blocking=True)
    torch.cuda.current_stream(out.device).synchronize()
    return host


def consensus_sequence_batch(clusters, band: int = 64, max_len: int = 4096,
                             rounds: int = 2, *,
                             device: torch.device | str = "cpu",
                             counts: dict | None = None) -> list[str]:
    """Batched consensus: the semantics of svtrek_tpu's scalar
    ``consensus_sequence`` (majority-mode selection, length-medoid seed,
    star alignment with insertion recovery, realign until a fixed point or
    ``rounds``) applied to many clusters, with every round's member to
    consensus alignments across ALL clusters in one `dp_pairs` call and
    their vote in one `ops.poa_dp.vote` call on ``device`` (``counts`` as
    `dp_pairs`'s).  With ``counts``, counts["vote_s"] times the voting
    (mode and seed selection, encode, the vote's launch and copy back, the
    fixed point; profiler range `svtrek.cons.vote` around the host's
    stretches), counts["dp_s"] the `dp_pairs` calls (a timer only: they
    launch device work), counts["vote_rounds"] the cluster-rounds voted
    and counts["vote_card"] those in K5's launches (`vote`'s)."""
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
        meta: list[tuple[int, ...]] = []
        tgts: list[np.ndarray] = []
        pair_t: list[np.ndarray] = []
        pair_q: list[np.ndarray] = []
        with span(counts, "vote_s", "svtrek.cons.vote", round=r):
            t_off = o_off = 0
            for members, cons in active.values():
                target = encode(cons)
                m = len(target)
                lo, n_equal, longest = len(pair_q), 0, 0
                for s in members:
                    if s == cons:
                        n_equal += 1
                    else:
                        pair_t.append(target)
                        pair_q.append(encode(s[: 4 * m]))
                        longest = max(longest, len(pair_q[-1]))
                cap = m + 2 * longest
                meta.append((lo, len(pair_q), m, len(members), n_equal,
                             t_off, o_off, cap))
                tgts.append(target)
                t_off += m
                o_off += cap
        with span(counts, "dp_s"):  # no pair: empty rows, no DP call
            cols, ins, qpad = dp_pairs(pair_t, pair_q, band, device=device,
                                       counts=counts)
        C = len(meta)
        with span(counts, "vote_s"):  # launches, copies and waits: no range
            meta_d, tgts_d = (torch.from_numpy(a).to(device) for a in (
                np.array(meta, np.int64), np.concatenate(tgts)))
            out = vote_to_host(vote(cols, ins, qpad, meta_d, tgts_d,
                                    4 * C + o_off, counts=counts)).numpy()
        with span(counts, "vote_s", "svtrek.cons.vote", round=r):
            lens = out[:4 * C].view(np.int32)
            if (lens < 0).any():
                raise RuntimeError("a cluster's vote passed its output size")
            nxt: dict[int, tuple[list[str], str]] = {}
            for (ci, (members, cons)), row, n in zip(active.items(), meta,
                                                     lens.tolist()):
                at = 4 * C + row[6]
                new = out[at:at + n].tobytes().decode("ascii")
                if not new or new == cons:
                    results[ci] = cons
                else:
                    nxt[ci] = (members, new)
            add(counts, "vote_rounds", C)
        active = nxt
    for ci, (_members, cons) in active.items():  # rounds exhausted
        results[ci] = cons
    return results  # type: ignore[return-value]
