"""Host-side window packer: VCF tasks → fixed-shape device batches.

A JAX-free copy of svtrek_tpu/pipeline/pack.py.  It is copied rather
than imported because svtrek_tpu/pipeline/pack.py imports
`ops.audit_step`, and through it every JAX op, at module load
(pack.py:40); a machine with the card has no JAX.  It is the port's own
code; tests/test_torch_pack.py, tests/test_torch_audit_device.py and
tests/test_torch_sharding.py hold it equal to the original, the
shard-blockwise layouts of ``n_shards > 1`` included.

Each accepted VCF record expands into 1-2 refine windows:

  INS  → 1 × KIND_INS      interval [pos-median, pos+median]   (audit.c:178)
  DEL  → KIND_DEL_START    interval [pos-wider,  pos+narrow]   (audit.c:191)
         KIND_DEL_END      interval [end-narrow, end+narrow]   (audit.c:192)
  INV  → 2 × KIND_POINT    intervals ±wider around pos/end     (audit.c:224-225)

All interval arithmetic wraps in uint32 exactly like the C struct fields;
degenerate wrapped intervals yield empty BAM queries.  Three layouts:

- `pack_chunk_cand` (host extract, the default): the native C reader
  fetches each chunk's reads and runs the reference's CIGAR evidence walk
  (refinement.c:103-325), so a batch carries only each window's sorted
  candidates;
- `pack_chunk_native` (`--extract device`): one C fetch and the flat CSR
  op/len streams of the chunk (`AuditBatchCSR`), which the device walks
  where they lie;
- `pack_chunk` (`--no-native-io`): a per-window fetch, normalised to
  `PackedReads`, scattered into the padded [N, O] matrices of `AuditBatch`
  on the host, or, where a read passes the top ops bucket, laid out flat
  as `pack_chunk_native`'s batch (the JAX package sends such a window to
  the scalar oracle; the port's walk takes a read of any op count).

With ``n_shards > 1`` each packer lays its batch out shard-blockwise for
the sharded steps of `parallel.mesh`: every axis divisible by the shard
count, window ids local to their shard's block (padding reads carry the
local sentinel B_loc), and `PackedBatch.window_slots` mapping each window
to its global result slot.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Callable, Sequence

import numpy as np

from .. import constants as C
from ..config import AudtConfig
from ..constants import (
    KIND_DEL_END, KIND_DEL_START, KIND_INS, KIND_INV_END, KIND_POINT, SVType,
)
from ..io.vcf import VcfTask
from ..kernels import CONSENSUS_MAX_K
from ..ops.audit_step import AuditBatch, AuditBatchCSR

# The top width of the padded layout: a batch with a longer read is laid
# out flat (the JAX package sends its window to the host oracle).
MAX_OPS_BUCKET = 16384
OPS_BUCKETS = (64, 256, 1024, 2048, 4096, 8192, MAX_OPS_BUCKET)

PAD_OP = 9  # CIGAR op code that consumes nothing (padding sentinel)

# The widest window a second device pass takes: a window past the first
# pass's width (--cand-width, --max-candidates) and within this many
# candidates is refined on the device at the width it needs; past it, on
# the host.  K1's widest row.
WIDE_MAX_K = CONSENSUS_MAX_K


class PackedReads:
    """Columnar reads for one window: the native reader's layout.

    pos   [R] int64 — 0-based alignment start per read
    n_ops [R] int32 — CIGAR op count per read
    opoff [R] int64 — start offset of each read's ops in the flat streams
    ops   [T] uint8, lens [T] int32 — flat op/len streams
    """

    __slots__ = ("pos", "n_ops", "opoff", "ops", "lens")

    def __init__(self, pos, n_ops, opoff, ops, lens):
        self.pos = pos
        self.n_ops = n_ops
        self.opoff = opoff
        self.ops = ops
        self.lens = lens

    @property
    def num_reads(self) -> int:
        return int(self.pos.shape[0])

    @property
    def max_ops(self) -> int:
        return int(self.n_ops.max()) if self.n_ops.size else 0

    def flat(self) -> tuple[np.ndarray, np.ndarray]:
        """(ops_seq, lens_seq) in read order; no copy when the streams are
        already contiguous in read order (the native reader's case)."""
        if self.n_ops.size == 0:
            return (np.empty(0, np.uint8), np.empty(0, np.int32))
        starts = np.cumsum(self.n_ops.astype(np.int64)) - self.n_ops
        total = int(starts[-1] + self.n_ops[-1])
        if total == len(self.ops) and np.array_equal(self.opoff, starts):
            return self.ops, self.lens
        src = np.repeat(self.opoff, self.n_ops) + (
            np.arange(total, dtype=np.int64) - np.repeat(starts, self.n_ops)
        )
        return self.ops[src], self.lens[src]

    def to_list(self) -> list[tuple[int, list[tuple[int, int]]]]:
        """Oracle-fallback form: [(pos, [(op, len), ...]), ...]."""
        out = []
        for r in range(self.num_reads):
            o = int(self.opoff[r])
            n = int(self.n_ops[r])
            cig = list(
                zip(self.ops[o : o + n].tolist(), self.lens[o : o + n].tolist())
            )
            out.append((int(self.pos[r]), cig))
        return out

    @staticmethod
    def from_list(reads) -> "PackedReads":
        R = len(reads)
        n_ops = np.fromiter((len(c) for _, c in reads), np.int32, R)
        pos = np.fromiter((p for p, _ in reads), np.int64, R)
        opoff = (np.cumsum(n_ops.astype(np.int64)) - n_ops) if R else \
            np.empty(0, np.int64)
        total = int(n_ops.sum())
        ops = np.empty(total, np.uint8)
        lens = np.empty(total, np.int32)
        t = 0
        for _, cig in reads:
            for op, ln in cig:
                ops[t] = op
                lens[t] = ln
                t += 1
        return PackedReads(pos, n_ops, opoff, ops, lens)


_EMPTY = PackedReads(
    np.empty(0, np.int64), np.empty(0, np.int32), np.empty(0, np.int64),
    np.empty(0, np.uint8), np.empty(0, np.int32),
)


def as_packed(reads) -> PackedReads:
    """Normalize a fetch() result (PackedReads or list form)."""
    if isinstance(reads, PackedReads):
        return reads
    if not reads:
        return _EMPTY
    return PackedReads.from_list(reads)


def as_read_list(reads):
    """Normalize to the oracle-fallback list form."""
    if isinstance(reads, (PackedReads, LazyWindowReads)):
        return reads.to_list()
    return reads


_FALLBACK_READERS: dict = {}
_FALLBACK_LOCK = threading.Lock()


class LazyWindowReads:
    """Evidence for one window, re-fetched from the BAM on demand.

    `pack_chunk_native` leaves the fetched reads in the native reader's
    reusable buffers; the rare window that overflows K or the consensus
    sweep re-queries its region instead, through one cached native reader
    per BAM path (the path had one: it packed the batch)."""

    __slots__ = ("bam_path", "tid", "beg", "end")

    def __init__(self, bam_path: str, tid: int, beg: int, end: int):
        self.bam_path = bam_path
        self.tid = tid
        self.beg = beg
        self.end = end

    def to_list(self):
        if self.tid < 0:
            return []
        with _FALLBACK_LOCK:
            reader = _FALLBACK_READERS.get(self.bam_path)
            if reader is None:
                from ..native import native_bam_reader

                reader = native_bam_reader(self.bam_path)
                _FALLBACK_READERS[self.bam_path] = reader
            return PackedReads(
                *reader.fetch_packed(self.tid, self.beg, self.end)).to_list()


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


@dataclass
class PackedBatch:
    """A device batch (`AuditBatch` or `AuditBatchCSR`) plus everything
    the fallbacks and emit need."""

    batch: object
    windows: list[WindowSpec]
    reads_per_window: list  # PackedReads (or list / lazy form) per window
    # The shard count the batch was packed for (1 = the dense layout) and,
    # when > 1, the global result slot of each entry of `windows` (the
    # batch is padded shard by shard, so slots are not the identity).
    n_shards: int = 1
    window_slots: list[int] | None = None


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


def _bucket(value: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if value <= b:
            return b
    return buckets[-1]


def query_region(fetch, w: WindowSpec):
    """BAM region fetch with the reference's coordinate mapping:
    tid = chrom-1, beg = start-1, end = end-1 in uint32 arithmetic
    (refinement.c:114)."""
    tid = window_tid(w)
    beg = C.u32(w.inter_start - 1)
    end = C.u32(w.inter_end - 1)
    if tid < 0:
        return _EMPTY
    return fetch(tid, beg, end)


def pack_chunk(window_chunk: Sequence[WindowSpec],
               fetch: Callable[[int, int, int], object],
               cfg: AudtConfig, n_shards: int = 1) -> PackedBatch:
    """Fetch + pack one batch worth of windows in the dense layout, or
    shard-blockwise for ``n_shards > 1``; flat (`_csr_of_items`) where a
    read passes the top ops bucket.  ``fetch(tid, beg, end)`` returns
    PackedReads or ``[(pos, [(op, len), ...]), ...]``."""
    items: list[tuple[WindowSpec, PackedReads]] = []
    for w in window_chunk:
        if w.kind == KIND_POINT:
            reads = _EMPTY  # refine_point collects nothing; skip I/O
        else:
            reads = as_packed(query_region(fetch, w))
        items.append((w, reads))
    if max((pr.max_ops for _, pr in items), default=0) > MAX_OPS_BUCKET:
        return _csr_of_items(items, cfg, n_shards)
    if n_shards > 1:
        return _pack_one_sharded(items, cfg, n_shards)
    return _pack_one(items, cfg)


def _window_attrs(window_chunk: Sequence[WindowSpec], B: int):
    """kind / inter_start / inter_end / imprecise_pos [B] int32 of a chunk,
    padding windows KIND_POINT (they collect nothing).  Windows that still
    have reads have sane (< 2^31) interval coordinates, since wrapped
    intervals give empty queries, so the int32 casts are lossless where
    they matter."""
    kind = np.full(B, KIND_POINT, np.int32)
    istart = np.zeros(B, np.int32)
    iend = np.zeros(B, np.int32)
    ipos = np.zeros(B, np.int32)
    for b, w in enumerate(window_chunk):
        kind[b] = w.kind
        istart[b] = np.int64(w.inter_start).astype(np.int32)
        iend[b] = np.int64(w.inter_end).astype(np.int32)
        ipos[b] = np.int64(w.imprecise_pos).astype(np.int32)
    return kind, istart, iend, ipos


def pack_chunk_native(window_chunk: Sequence[WindowSpec], reader,
                      cfg: AudtConfig, n_shards: int = 1) -> PackedBatch:
    """Dense fetch + CSR pack, the heavy work in C (`--extract device`).

    One `svbam_fetch_batch` call pulls every window's reads (GIL released
    for the whole chunk) and the flat op/len streams are shipped as they
    are, reads of any op count; the Python layer builds only the
    per-window attribute vectors."""
    n_win = len(window_chunk)
    tids = np.empty(n_win, np.int32)
    begs = np.empty(n_win, np.int64)
    ends = np.empty(n_win, np.int64)
    for i, w in enumerate(window_chunk):
        if w.kind == KIND_POINT or window_tid(w) < 0:
            tids[i] = -1  # refine_point collects nothing; skip I/O
            begs[i] = ends[i] = 0
        else:
            tids[i] = window_tid(w)
            begs[i] = int(C.u32(w.inter_start - 1))
            ends[i] = int(C.u32(w.inter_end - 1))

    total, counts = reader.fetch_batch(tids, begs, ends)
    # Overflow-fallback evidence is re-fetched lazily (rare).
    reads_per_window = [
        LazyWindowReads(reader.path, int(tids[i]), int(begs[i]), int(ends[i]))
        for i in range(n_win)
    ]
    return _csr_batch(window_chunk, reader.batch_flat_n(total), counts, cfg,
                      n_shards, reads_per_window)


def _csr_batch(window_chunk, flat, counts: np.ndarray, cfg: AudtConfig,
               n_shards: int, reads_per_window: list) -> PackedBatch:
    """The flat (CSR) batch of a chunk whose reads lie in window order:
    ``flat`` = (pos [R], n_ops [R], ops [T], lens [T]) of every read,
    ``counts`` [n_win] the reads of each window.

    With ``n_shards`` > 1 the layout is shard-blockwise for
    `sharded_audit_step_csr`: a contiguous window->shard split keeps every
    per-shard read/flat-op range a contiguous slice, so the blocks are
    plain copies.  Layout contract: T/N/B all divisible by n_shards,
    window_id shard-local (padding sentinel b_loc), flat tails zero."""
    n_win = len(window_chunk)
    rpos, rnops, fops, flens = flat
    counts = np.asarray(counts, np.int64)

    b_loc = max(-(-cfg.batch_windows // n_shards), -(-n_win // n_shards), 1)
    B = n_shards * b_loc

    roff = np.concatenate([[0], np.cumsum(counts)])
    ooff = np.concatenate([[0], np.cumsum(rnops.astype(np.int64))])

    # Per-shard window ranges (contiguous) and their read/flat slices.
    wlo = [min(s * b_loc, n_win) for s in range(n_shards + 1)]
    rlo = [int(roff[w]) for w in wlo]
    olo = [int(ooff[r]) for r in rlo]
    n_loc = pow2(max(1, max(rlo[s + 1] - rlo[s]
                             for s in range(n_shards))), lo=64)
    t_loc = pow2(max(1, max(olo[s + 1] - olo[s]
                             for s in range(n_shards))), lo=256)

    N = n_shards * n_loc
    T = n_shards * t_loc
    ops_flat = np.zeros(T, np.uint8)
    lens_flat = np.zeros(T, np.int32)
    pos = np.zeros(N, np.int32)
    n_ops = np.zeros(N, np.int32)          # padding rows MUST be 0
    wid = np.full(N, b_loc, np.int32)      # shard-local padding sentinel
    kind = np.full(B, KIND_POINT, np.int32)
    istart = np.zeros(B, np.int32)
    iend = np.zeros(B, np.int32)
    ipos = np.zeros(B, np.int32)

    window_slots: list[int] = []
    for s in range(n_shards):
        a, b = wlo[s], wlo[s + 1]
        ra, rb = rlo[s], rlo[s + 1]
        oa, ob = olo[s], olo[s + 1]
        pos[s * n_loc:s * n_loc + (rb - ra)] = rpos[ra:rb].astype(np.int32)
        n_ops[s * n_loc:s * n_loc + (rb - ra)] = rnops[ra:rb]
        wid[s * n_loc:s * n_loc + (rb - ra)] = np.repeat(
            np.arange(b - a, dtype=np.int32), counts[a:b])
        ops_flat[s * t_loc:s * t_loc + (ob - oa)] = fops[oa:ob]
        lens_flat[s * t_loc:s * t_loc + (ob - oa)] = flens[oa:ob]
        attrs = _window_attrs(window_chunk[a:b], b - a)
        for arr, vals in zip((kind, istart, iend, ipos), attrs):
            arr[s * b_loc:s * b_loc + (b - a)] = vals
        window_slots += range(s * b_loc, s * b_loc + (b - a))

    batch = AuditBatchCSR(
        ops_flat=ops_flat, lens_flat=lens_flat, pos=pos, n_ops=n_ops,
        window_id=wid, kind=kind, inter_start=istart, inter_end=iend,
        imprecise_pos=ipos,
    )
    return PackedBatch(batch=batch, windows=list(window_chunk),
                       reads_per_window=reads_per_window, n_shards=n_shards,
                       window_slots=window_slots if n_shards > 1 else None)


def _csr_of_items(items: list[tuple[WindowSpec, PackedReads]],
                  cfg: AudtConfig, n_shards: int) -> PackedBatch:
    """The flat (CSR) batch of fetched windows (`_csr_batch`), for a
    chunk that holds a read past the top ops bucket."""
    prs = [pr for _, pr in items]
    flats = [pr.flat() for pr in prs]
    flat = (np.concatenate([pr.pos for pr in prs]),
            np.concatenate([pr.n_ops for pr in prs]),
            np.concatenate([f[0] for f in flats]),
            np.concatenate([f[1] for f in flats]))
    return _csr_batch([w for w, _ in items], flat,
                      [pr.num_reads for pr in prs], cfg, n_shards, prs)


INT64_MIN = np.iinfo(np.int64).min
_I32_PAD = 0x7FFFFFFF


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
    """A host-extracted batch plus everything collect/emit need.

    The windows past the batch's width K and within WIDE_MAX_K candidates
    (`wide_win`) keep a padding row in `batch`; their sorted candidates
    are the CSR `wide_off` / `wide_val`, which `wide_batch` lays out as
    the second pass's batch."""

    batch: AuditBatchCand
    windows: list[WindowSpec]
    true_counts: np.ndarray    # [n_win] int32, may exceed K
    refined_c: np.ndarray      # [n_win] int64; != INT64_MIN → precomputed
    num_reads: int = 0
    n_shards: int = 1
    wide_win: np.ndarray = field(                    # [m] window indices
        default_factory=lambda: np.empty(0, np.int32))
    wide_off: np.ndarray = field(                    # [m+1]
        default_factory=lambda: np.zeros(1, np.int64))
    wide_val: np.ndarray = field(                    # [wide_off[m]]
        default_factory=lambda: np.empty(0, np.int32))

    def wide_batch(self, sel=None) -> tuple[np.ndarray, np.ndarray,
                                            np.ndarray]:
        """The wide windows (those of ``sel``, indices into `wide_win`,
        default all) as a [b, K'] batch: (locs sorted with INT32_MAX
        padding, counts [b], imprecise_pos [b]) int32, K' the power of
        two (>= 16) of their largest count."""
        sel = np.arange(len(self.wide_win)) if sel is None else sel
        lo, hi = self.wide_off[sel], self.wide_off[np.asarray(sel) + 1]
        counts = (hi - lo).astype(np.int32)
        return (csr_rows(self.wide_val, lo, counts),
                counts, self.batch.imprecise_pos[self.wide_win[sel]])


def pack_chunk_cand(window_chunk: Sequence[WindowSpec], reader,
                    cfg: AudtConfig, n_shards: int = 1) -> PackedCandBatch:
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
    K = pow2(min(cfg.cand_width, 8192), lo=16)
    locs, counts, refined = reader.extract_batch(
        kinds, istart, iend, ipos, win_counts, K,
        cfg.consensus_min_count, cfg.consensus_interval,
        cfg.consensus_interval_range, wide_cap=WIDE_MAX_K,
    )
    wide_win, wide_off, wide_val = reader.wide_rows()
    # Ship only this batch's live candidate width (pow2 bucket, >= 16).
    kmax = int(np.minimum(counts, K).max()) if n_win else 1
    keff = pow2(max(kmax, 1), lo=16)
    if keff < K:
        locs = np.ascontiguousarray(locs[:, :keff])
        K = keff

    # Pad the window axis to a stable bucket; for a mesh, also to a
    # multiple of the shard count (rows shard blockwise).
    B = max(cfg.batch_windows, n_win, 1)
    if n_shards > 1:
        B = -(-B // n_shards) * n_shards
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
        n_shards=n_shards,
        wide_win=wide_win, wide_off=wide_off, wide_val=wide_val,
    )


def csr_rows(values: np.ndarray, starts: np.ndarray,
             counts: np.ndarray) -> np.ndarray:
    """Rows ``values[starts[i]:starts[i] + counts[i]]`` of a CSR, sorted
    already, as a [b, K'] int32 matrix padded with INT32_MAX, K' the power
    of two (>= 16) of the largest count."""
    width = pow2(int(counts.max()) if len(counts) else 1, lo=16)
    out = np.full((len(counts), width), _I32_PAD, np.int32)
    if len(counts) and counts.sum():
        r = np.repeat(np.arange(len(counts)), counts)
        c = np.arange(int(counts.sum())) - np.repeat(
            np.cumsum(counts) - counts, counts)
        out[r, c] = values[np.repeat(starts, counts) + c]
    return out


def _fill_reads(ops, lens, pos, n_ops, wid, prs: list[PackedReads],
                row_start: np.ndarray, wid_value: np.ndarray,
                O: int) -> None:
    """Scatter each PackedReads block into the device matrices: ``prs[i]``'s
    reads land in consecutive rows from ``row_start[i]`` with window id
    ``wid_value[i]``, in one fancy-indexed assignment over the batch."""
    if not prs:
        return
    counts = np.fromiter((p.num_reads for p in prs), np.int64, len(prs))
    if counts.sum() == 0:
        return
    dest_row = np.concatenate(
        [np.arange(s, s + c, dtype=np.int64)
         for s, c in zip(row_start, counts) if c]
    )
    pos_all = np.concatenate([p.pos for p in prs if p.num_reads])
    nops_all = np.concatenate([p.n_ops for p in prs if p.num_reads])
    flats = [p.flat() for p in prs if p.num_reads]
    ops_seq = np.concatenate([f[0] for f in flats])
    lens_seq = np.concatenate([f[1] for f in flats])

    pos[dest_row] = pos_all.astype(np.int32)
    n_ops[dest_row] = nops_all
    wid[dest_row] = np.repeat(wid_value, counts)

    nops64 = nops_all.astype(np.int64)
    starts = np.cumsum(nops64) - nops64
    T = int(starts[-1] + nops64[-1]) if len(nops64) else 0
    if T == 0:
        return
    col = np.arange(T, dtype=np.int64) - np.repeat(starts, nops_all)
    flat_idx = np.repeat(dest_row, nops_all) * O + col
    ops.reshape(-1)[flat_idx] = ops_seq.astype(np.int8)
    lens.reshape(-1)[flat_idx] = lens_seq


def pow2(n: int, lo: int = 256) -> int:
    v = lo
    while v < n:
        v *= 2
    return v


def _pack_one(items: list[tuple[WindowSpec, PackedReads]],
              cfg: AudtConfig) -> PackedBatch:
    n_win = len(items)
    counts = np.fromiter(
        (pr.num_reads for _, pr in items), np.int64, n_win
    ) if n_win else np.empty(0, np.int64)
    n_reads = int(counts.sum())
    max_ops = max((pr.max_ops for _, pr in items), default=1)
    O = _bucket(max(max_ops, 1), OPS_BUCKETS)
    # Constant window axis + pow2-bucketed reads axis.
    B = max(cfg.batch_windows, n_win, 1)
    N = pow2(max(n_reads, 1))

    ops = np.full((N, O), PAD_OP, np.int8)
    lens = np.zeros((N, O), np.int32)
    pos = np.zeros(N, np.int32)
    n_ops = np.zeros(N, np.int32)
    wid = np.full(N, B, np.int32)
    kind, istart, iend, ipos = _window_attrs([w for w, _ in items], B)

    row_start = (np.cumsum(counts) - counts) if n_win else \
        np.empty(0, np.int64)
    _fill_reads(
        ops, lens, pos, n_ops, wid,
        [pr for _, pr in items],
        row_start, np.arange(n_win, dtype=np.int64), O,
    )

    batch = AuditBatch(
        ops=ops, lens=lens, pos=pos, n_ops=n_ops, window_id=wid,
        kind=kind, inter_start=istart, inter_end=iend, imprecise_pos=ipos,
    )
    return PackedBatch(
        batch=batch,
        windows=[w for w, _ in items],
        reads_per_window=[pr for _, pr in items],
    )


def _pack_one_sharded(items: list[tuple[WindowSpec, PackedReads]],
                      cfg: AudtConfig, n_shards: int) -> PackedBatch:
    """Shard-blockwise packing for the multi-device audit step.

    Windows are binned greedily by descending read count, so that every
    shard gets near-equal evidence.  Layout contract of
    `sharded_audit_step`: both axes divisible by n_shards, window_id
    shard-local, padding reads use the local sentinel B_local."""
    bins: list[list[int]] = [[] for _ in range(n_shards)]
    bin_reads = [0] * n_shards
    order = sorted(
        range(len(items)), key=lambda i: -items[i][1].num_reads
    )
    for i in order:
        s = min(range(n_shards), key=lambda j: (bin_reads[j], len(bins[j])))
        bins[s].append(i)
        bin_reads[s] += items[i][1].num_reads

    # Window axis padded to the ceil(batch_windows / n_shards) capacity,
    # reads axis to pow2.
    b_cap = -(-cfg.batch_windows // n_shards)
    b_loc = max(b_cap, max((len(b) for b in bins), default=1), 1)
    n_loc = pow2(max(1, max(bin_reads, default=1)), lo=64)
    B = n_shards * b_loc
    N = n_shards * n_loc

    max_ops = max((pr.max_ops for _, pr in items), default=1)
    O = _bucket(max(max_ops, 1), OPS_BUCKETS)

    ops = np.full((N, O), PAD_OP, np.int8)
    lens = np.zeros((N, O), np.int32)
    pos = np.zeros(N, np.int32)
    n_ops = np.zeros(N, np.int32)
    wid = np.full(N, b_loc, np.int32)       # shard-local padding sentinel
    kind = np.full(B, KIND_POINT, np.int32)  # padding windows collect nothing
    istart = np.zeros(B, np.int32)
    iend = np.zeros(B, np.int32)
    ipos = np.zeros(B, np.int32)

    windows_out: list[WindowSpec] = []
    window_slots: list[int] = []
    prs: list[PackedReads] = []
    row_starts: list[int] = []
    wid_values: list[int] = []
    for s, bin_idx in enumerate(bins):
        r = s * n_loc
        for k, i in enumerate(bin_idx):
            w, pr = items[i]
            prs.append(pr)
            row_starts.append(r)
            wid_values.append(k)
            r += pr.num_reads
            windows_out.append(w)
            window_slots.append(s * b_loc + k)
    attrs = _window_attrs(windows_out, len(windows_out))
    for arr, vals in zip((kind, istart, iend, ipos), attrs):
        arr[window_slots] = vals

    _fill_reads(
        ops, lens, pos, n_ops, wid, prs,
        np.asarray(row_starts, np.int64), np.asarray(wid_values, np.int64), O,
    )

    batch = AuditBatch(
        ops=ops, lens=lens, pos=pos, n_ops=n_ops, window_id=wid,
        kind=kind, inter_start=istart, inter_end=iend, imprecise_pos=ipos,
    )
    return PackedBatch(
        batch=batch,
        windows=windows_out,
        reads_per_window=prs,
        n_shards=n_shards,
        window_slots=window_slots,
    )
