"""Host-side window packer for the host-extract path: VCF tasks → [B, K]
candidate batches.

A JAX-free copy of the host-extract subset of svtrek_tpu/pipeline/pack.py
(`WindowSpec`, `window_tid`, `windows_for_task`, `AuditBatchCand`,
`PackedCandBatch`, `pack_chunk_cand`, `_pow2`), single-device only.  It is
copied rather than imported because svtrek_tpu/pipeline/pack.py imports
`ops.audit_step`, and through it every JAX op, at module load
(pack.py:40); a machine with the card has no JAX.  It is the port's own
code; tests/test_torch_pack.py holds it equal to the original.

Each accepted VCF record expands into 1-2 refine windows:

  INS  → 1 × KIND_INS      interval [pos-median, pos+median]   (audit.c:178)
  DEL  → KIND_DEL_START    interval [pos-wider,  pos+narrow]   (audit.c:191)
         KIND_DEL_END      interval [end-narrow, end+narrow]   (audit.c:192)
  INV  → 2 × KIND_POINT    intervals ±wider around pos/end     (audit.c:224-225)

All interval arithmetic wraps in uint32 exactly like the C struct fields.
The native C reader fetches each chunk's reads and runs the reference's
CIGAR evidence walk (refinement.c:103-325), so a batch carries only the
sorted candidates of each window.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np

from .. import constants as C
from ..config import AudtConfig
from ..constants import (
    KIND_DEL_END, KIND_DEL_START, KIND_INS, KIND_INV_END, KIND_POINT, SVType,
)
from ..io.vcf import VcfTask

INT64_MIN = np.iinfo(np.int64).min
_I32_PAD = 0x7FFFFFFF


@dataclass
class WindowSpec:
    """One refine_* invocation."""

    kind: int
    chrom_index: int
    inter_start: int       # uint32, 1-based as the reference passes it
    inter_end: int         # uint32
    imprecise_pos: int
    record_index: int      # which VcfTask this belongs to
    slot: int              # 0 = start/point result, 1 = end result
    tid: int = -2          # explicit BAM tid (--chrom-by-name); -2 =
                           # the reference's tid = chrom-1 assumption


def window_tid(w: WindowSpec) -> int:
    """BAM tid for a window: the header-resolved tid when set
    (--chrom-by-name extension), else the reference's numeric mapping
    tid = chrom - 1 (refinement.c:114)."""
    return w.tid if w.tid != -2 else w.chrom_index - 1


def windows_for_task(task: VcfTask, cfg: AudtConfig
                     ) -> tuple[list[WindowSpec], bool]:
    """Expand a VCF task into refine windows.

    Returns (windows, emit): emit=False when the reference would print
    nothing (the DEL/INV `50 < end-pos` inner check failing on exact
    equality, audit.c:190, 223)."""
    u = C.u32
    t = task
    if t.sv_type == SVType.INS:
        return (
            [
                WindowSpec(
                    KIND_INS, t.chrom_index,
                    u(t.pos - cfg.median_interval), u(t.pos + cfg.median_interval),
                    t.pos, t.line_index, 0,
                )
            ],
            True,
        )
    if t.sv_type == SVType.DEL:
        if not (C.SV_MIN_LENGTH < u(t.end - t.pos)):
            return [], False
        return (
            [
                WindowSpec(
                    KIND_DEL_START, t.chrom_index,
                    u(t.pos - cfg.wider_interval), u(t.pos + cfg.narrow_interval),
                    t.pos, t.line_index, 0,
                ),
                WindowSpec(
                    KIND_DEL_END, t.chrom_index,
                    u(t.end - cfg.narrow_interval), u(t.end + cfg.narrow_interval),
                    t.end, t.line_index, 1,
                ),
            ],
            True,
        )
    if t.sv_type == SVType.INV:
        if not (C.SV_MIN_LENGTH < u(t.end - t.pos)):
            return [], False
        # --refine-inv (default off = reference parity): the reference
        # INTENDS INV refinement but refine_point collects nothing
        # (refinement.c:250), so both breakpoints always print NA.  With the
        # flag, the start breakpoint runs the DEL-start rules and the end
        # breakpoint the INV_END rules, over the reference's own INV
        # intervals (audit.c:221-231).
        k_start, k_end = (
            (KIND_DEL_START, KIND_INV_END)
            if cfg.refine_inv
            else (KIND_POINT, KIND_POINT)
        )
        return (
            [
                WindowSpec(
                    k_start, t.chrom_index,
                    u(t.pos - cfg.wider_interval), u(t.pos + cfg.wider_interval),
                    t.pos, t.line_index, 0,
                ),
                WindowSpec(
                    k_end, t.chrom_index,
                    u(t.end - cfg.wider_interval), u(t.end + cfg.wider_interval),
                    t.end, t.line_index, 1,
                ),
            ],
            True,
        )
    raise ValueError(f"unexpected sv type {t.sv_type}")


@dataclass
class AuditBatchCand:
    """Host-extracted candidate layout: the native C reader already ran the
    reference's CIGAR evidence walk per window, so the device receives
    only K sorted int32 candidates per window and runs the batched
    consensus sweep."""

    locs: np.ndarray           # [B, K] int32 sorted asc, INT32_MAX pad
    counts: np.ndarray         # [B] int32, clipped to K
    imprecise_pos: np.ndarray  # [B] int32

    @property
    def num_windows(self) -> int:
        return int(self.counts.shape[0])


@dataclass
class PackedCandBatch:
    """A host-extracted batch plus everything collect/emit need."""

    batch: AuditBatchCand
    windows: list[WindowSpec]
    true_counts: np.ndarray    # [n_win] int32, may exceed K
    refined_c: np.ndarray      # [n_win] int64; != INT64_MIN → precomputed
    num_reads: int = 0


def pack_chunk_cand(window_chunk: Sequence[WindowSpec], reader,
                    cfg: AudtConfig) -> PackedCandBatch:
    """Fetch + host-extract one chunk of windows (all heavy work in C).

    One `svbam_fetch_batch` + one `svbam_extract_batch` call per chunk;
    windows whose candidates overflow K arrive pre-refined by the C
    scalar consensus (exact)."""
    n_win = len(window_chunk)
    tids = np.empty(n_win, np.int32)
    begs = np.empty(n_win, np.int64)
    ends = np.empty(n_win, np.int64)
    kinds = np.empty(n_win, np.int32)
    istart = np.empty(n_win, np.int64)
    iend = np.empty(n_win, np.int64)
    ipos = np.empty(n_win, np.int64)
    for i, w in enumerate(window_chunk):
        kinds[i] = w.kind
        istart[i] = int(C.u32(w.inter_start))
        iend[i] = int(C.u32(w.inter_end))
        ipos[i] = int(C.u32(w.imprecise_pos))
        if w.kind == KIND_POINT or window_tid(w) < 0:
            tids[i] = -1  # refine_point collects nothing; skip I/O
            begs[i] = ends[i] = 0
        else:
            tids[i] = window_tid(w)
            begs[i] = int(C.u32(w.inter_start - 1))
            ends[i] = int(C.u32(w.inter_end - 1))

    # Merged fetch (default): overlapping/nearby windows share one region
    # fetch and each read is decoded once; the per-window read sets are
    # identical by construction (the C re-applies the overlap test per
    # window).
    if cfg.merge_fetch_gap > 0:
        total, win_counts = reader.fetch_batch_merged(tids, begs, ends,
                                                      cfg.merge_fetch_gap)
    else:
        total, win_counts = reader.fetch_batch(tids, begs, ends)
    K = _pow2(min(cfg.cand_width, 8192), lo=16)
    locs, counts, refined = reader.extract_batch(
        kinds, istart, iend, ipos, win_counts, K,
        cfg.consensus_min_count, cfg.consensus_interval,
        cfg.consensus_interval_range,
    )
    # Ship only this batch's live candidate width (pow2 bucket, >= 16).
    kmax = int(np.minimum(counts, K).max()) if n_win else 1
    keff = _pow2(max(kmax, 1), lo=16)
    if keff < K:
        locs = np.ascontiguousarray(locs[:, :keff])
        K = keff

    # Pad the window axis to a stable bucket.
    B = max(cfg.batch_windows, n_win, 1)
    if B != n_win:
        locs_p = np.full((B, K), _I32_PAD, np.int32)
        locs_p[:n_win] = locs
        counts_p = np.zeros(B, np.int32)
        counts_p[:n_win] = np.minimum(counts, K)
        ipos_p = np.zeros(B, np.int32)
        ipos_p[:n_win] = ipos.astype(np.int32)
    else:
        locs_p = locs
        counts_p = np.minimum(counts, K)
        ipos_p = ipos.astype(np.int32)

    return PackedCandBatch(
        batch=AuditBatchCand(locs=locs_p, counts=counts_p,
                             imprecise_pos=ipos_p),
        windows=list(window_chunk),
        true_counts=counts,
        refined_c=refined,
        num_reads=int(total),
    )


def _pow2(n: int, lo: int = 256) -> int:
    v = lo
    while v < n:
        v *= 2
    return v
