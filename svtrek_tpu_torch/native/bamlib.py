"""ctypes bindings for the native BAM reader and scalar baseline."""
from __future__ import annotations

import ctypes as ct
import dataclasses
from dataclasses import dataclass

import numpy as np

_LIB = None
# The batch inflate a reader's staged fetches call (svbam_inflate_fn).
_INFLATE_FN = ct.CFUNCTYPE(ct.c_int, ct.c_int32, ct.c_int64)
# A staged slice's most blocks (the C's STAGE_MAX_BLOCKS: 256 MiB
# inflated) and compressed bytes.
STAGE_BLOCKS, STAGE_IN_BYTES = 4096, 128 << 20


def load_library():
    """Load (building on demand) the native library; raises OSError
    (NativeBuildError when it does not build) on failure."""
    global _LIB
    if _LIB is not None:
        return _LIB
    from .build import build

    lib = ct.CDLL(build())
    lib.svbam_open.restype = ct.c_void_p
    lib.svbam_open.argtypes = [ct.c_char_p]
    lib.svbam_close.argtypes = [ct.c_void_p]
    lib.svbam_nref.restype = ct.c_int32
    lib.svbam_nref.argtypes = [ct.c_void_p]
    lib.svbam_error.restype = ct.c_char_p
    lib.svbam_error.argtypes = [ct.c_void_p]
    lib.svbam_ref_name.restype = ct.c_char_p
    lib.svbam_ref_name.argtypes = [ct.c_void_p, ct.c_int32]
    lib.svbam_tid.restype = ct.c_int32
    lib.svbam_tid.argtypes = [ct.c_void_p, ct.c_char_p]
    lib.svbam_fetch.restype = ct.c_int64
    lib.svbam_fetch.argtypes = [ct.c_void_p, ct.c_int32, ct.c_int64, ct.c_int64]
    for name, ty in [
        ("svbam_read_pos", ct.POINTER(ct.c_int64)),
        ("svbam_read_nops", ct.POINTER(ct.c_int32)),
        ("svbam_read_opoff", ct.POINTER(ct.c_int64)),
        ("svbam_ops", ct.POINTER(ct.c_uint8)),
        ("svbam_oplens", ct.POINTER(ct.c_int32)),
    ]:
        fn = getattr(lib, name)
        fn.restype = ty
        fn.argtypes = [ct.c_void_p]
    lib.svbam_total_ops.restype = ct.c_int64
    lib.svbam_total_ops.argtypes = [ct.c_void_p]
    lib.svbam_widx.restype = ct.POINTER(ct.c_int64)
    lib.svbam_widx.argtypes = [ct.c_void_p]
    lib.svbam_widx_n.restype = ct.c_int64
    lib.svbam_widx_n.argtypes = [ct.c_void_p]
    lib.svbam_fetch_batch.restype = ct.c_int64
    lib.svbam_fetch_batch.argtypes = [
        ct.c_void_p, ct.c_int32, ct.POINTER(ct.c_int32),
        ct.POINTER(ct.c_int64), ct.POINTER(ct.c_int64),
        ct.POINTER(ct.c_int64),
    ]
    lib.svbam_fetch_batch_merged.restype = ct.c_int64
    lib.svbam_fetch_batch_merged.argtypes = [
        ct.c_void_p, ct.c_int32, ct.POINTER(ct.c_int32),
        ct.POINTER(ct.c_int64), ct.POINTER(ct.c_int64),
        ct.c_int64, ct.POINTER(ct.c_int64),
    ]
    lib.svbam_fill.restype = None
    lib.svbam_fill.argtypes = [
        ct.c_void_p, ct.POINTER(ct.c_int32),
        ct.POINTER(ct.c_int8), ct.POINTER(ct.c_int32),
        ct.POINTER(ct.c_int32), ct.POINTER(ct.c_int32),
        ct.POINTER(ct.c_int32),
        ct.c_int64, ct.c_int64, ct.c_int32,
    ]
    lib.svbam_extract_batch.restype = None
    lib.svbam_extract_batch.argtypes = [
        ct.c_void_p, ct.c_int32, ct.POINTER(ct.c_int32),
        ct.POINTER(ct.c_int64), ct.POINTER(ct.c_int64),
        ct.POINTER(ct.c_int64), ct.POINTER(ct.c_int64),
        ct.c_int32, ct.c_int32, ct.c_int32, ct.c_int32, ct.c_int32,
        ct.POINTER(ct.c_int32), ct.POINTER(ct.c_int32),
        ct.POINTER(ct.c_int64),
    ]
    lib.svbam_wide_n.restype = ct.c_int64
    lib.svbam_wide_n.argtypes = [ct.c_void_p]
    for name, ty in [("svbam_wide_win", ct.POINTER(ct.c_int32)),
                     ("svbam_wide_off", ct.POINTER(ct.c_int64)),
                     ("svbam_wide_val", ct.POINTER(ct.c_int32))]:
        fn = getattr(lib, name)
        fn.restype = ty
        fn.argtypes = [ct.c_void_p]
    lib.svbaseline_refine.restype = ct.c_int64
    lib.svbaseline_refine.argtypes = [
        ct.c_int32,
        ct.POINTER(ct.c_int64), ct.POINTER(ct.c_int32), ct.POINTER(ct.c_int64),
        ct.POINTER(ct.c_uint8), ct.POINTER(ct.c_int32),
        ct.c_int64, ct.c_int64, ct.c_int64, ct.c_int64,
        ct.c_int32, ct.c_int32, ct.c_int32,
    ]
    lib.svbaseline_consensus.restype = ct.c_int64
    lib.svbaseline_consensus.argtypes = [
        ct.POINTER(ct.c_int32), ct.c_int64, ct.c_int64,
        ct.c_int32, ct.c_int32, ct.c_int32,
    ]
    lib.svbam_ins_seqs_batch.restype = ct.c_int64
    lib.svbam_ins_seqs_batch.argtypes = [
        ct.c_void_p, ct.c_int32, ct.POINTER(ct.c_int32),
        ct.POINTER(ct.c_int64), ct.POINTER(ct.c_int64), ct.c_int32,
        ct.POINTER(ct.c_int64), ct.POINTER(ct.c_int64),
        ct.POINTER(ct.c_int64),
    ]
    lib.svbam_take_counters.restype = None
    lib.svbam_take_counters.argtypes = [ct.c_void_p, ct.POINTER(ct.c_int64)]
    lib.svbam_stage_attach.restype = ct.c_int32
    lib.svbam_stage_attach.argtypes = [
        ct.c_void_p, _INFLATE_FN, ct.c_int32, ct.c_void_p, ct.c_int64,
        ct.c_void_p, ct.c_void_p, ct.c_void_p, ct.c_int32,
    ]
    lib.svbam_ins_buf.restype = ct.POINTER(ct.c_char)
    lib.svbam_ins_buf.argtypes = [ct.c_void_p]
    lib.svbam_ins_off.restype = ct.POINTER(ct.c_int64)
    lib.svbam_ins_off.argtypes = [ct.c_void_p]
    _LIB = lib
    return lib


@dataclass(frozen=True)
class ReaderCounters:
    """What a reader did since its open or its last `take_counters()`;
    counters of several readers or calls add up with ``+``."""

    inflate_ns: int = 0     # obtaining inflated blocks: zlib's time on a
                            # block, and the time around each staged
                            # slice's batch inflate (copies, kernel, wait)
    inflated_bytes: int = 0  # the bytes they made (a block served from the
                             # handle's cache or skipped unread counts none)
    card_bytes: int = 0     # of those, the card's batch inflates'
    zlib_staged_bytes: int = 0  # of those, zlib's during staged fetches:
                                # blocks the stage left out
    walk_ops: int = 0       # CIGAR ops of the reads `extract_batch` handed
                            # its windows' walks, a read once a window
    walked_bytes: int = 0   # bytes of the staged fetches' records the walk
                            # read: length, fixed fields, name, CIGAR

    def __add__(self, other: "ReaderCounters") -> "ReaderCounters":
        return ReaderCounters(*(a + b for a, b in zip(
            dataclasses.astuple(self), dataclasses.astuple(other))))


_N_COUNTERS = len(dataclasses.fields(ReaderCounters))


class NativeBamError(IOError):
    """A BAM/BGZF decode failure (corrupt or truncated input).  Raised
    instead of returning a silently-partial read set — the same contract
    htslib gives the reference (audit.c:270-272)."""


class NativeBamReader:
    """Indexed BAM reader backed by the C library (.bai or .csi index).

    fetch() mirrors the htslib iterator semantics (same contract as
    io.bam.BamReader.fetch) and returns python (pos, cigar) pairs;
    fetch_packed() returns the zero-copy-ish packed numpy arrays used by
    the device packer fast path.  Any decode failure raises
    NativeBamError with the C layer's detail message.
    """

    def __init__(self, path: str):
        lib = load_library()
        self._lib = lib
        self.path = path
        self._h = lib.svbam_open(path.encode())
        if not self._h:
            raise IOError(f"svbam_open failed for {path}")
        self._stage = None  # the attached batch inflate and its buffers

    def close(self):
        if self._h:
            self._lib.svbam_close(self._h)
            self._h = None
        self._stage = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def _raise_error(self):
        if self._stage and self._stage[0]:  # what the batch inflate raised
            raise self._stage[0].pop()
        msg = self._lib.svbam_error(self._h)
        raise NativeBamError(
            msg.decode() if msg else "BAM decode failed")

    def stage_inflate(self, device,
                      _slice: tuple[int, int] = (STAGE_BLOCKS,
                                                 STAGE_IN_BYTES)) -> None:
        """Have this reader's batch fetches (`fetch_batch`,
        `fetch_batch_merged`, `ins_seqs_batch`) inflate the blocks their
        walk can read ahead of it, a slice at a time, with
        `kernels.bgzf_inflate` on ``device``: the kernel on a card, on a
        stream of this reader's own, through pinned buffers allocated here
        once; zlib a block on the CPU.  Every other read stays lazy.
        ``_slice`` (a slice's most blocks and compressed bytes) is for tests
        of slices smaller than a fetch's blocks."""
        import torch

        from .. import kernels

        dev = torch.device(device)
        card = dev.type == "cuda"
        nblk, cap = _slice
        block = kernels.BGZF_BLOCK_BYTES
        h_in = torch.empty(cap, dtype=torch.uint8, pin_memory=card)
        h_out = torch.empty((nblk, block), dtype=torch.uint8,
                            pin_memory=card)
        h_meta = torch.empty((nblk, 3), dtype=torch.int64, pin_memory=card)
        h_status = torch.empty(nblk, dtype=torch.int32, pin_memory=card)
        if card:
            stream = torch.cuda.Stream(dev)
            d_in = torch.empty(cap, dtype=torch.uint8, device=dev)
            d_out = torch.empty((nblk, block), dtype=torch.uint8, device=dev)
            d_meta = torch.empty((nblk, 3), dtype=torch.int64, device=dev)
            d_status = torch.empty(nblk, dtype=torch.int32, device=dev)

        raised: list = []  # not self: the buffers go with the reader

        def inflate(n: int, nbytes: int) -> int:
            """Inflate the slice's n blocks; the C reads their statuses.
            A failure is kept for _raise_error and returns 1."""
            try:
                if not card:
                    kernels.bgzf_inflate(h_in[:nbytes], h_meta[:n],
                                         h_out[:n], h_status[:n])
                    return 0
                with torch.cuda.device(dev), torch.cuda.stream(stream):
                    d_in[:nbytes].copy_(h_in[:nbytes], non_blocking=True)
                    d_meta[:n].copy_(h_meta[:n], non_blocking=True)
                    kernels.bgzf_inflate(d_in[:nbytes], d_meta[:n],
                                         d_out[:n], d_status[:n])
                    h_out[:n].copy_(d_out[:n], non_blocking=True)
                    h_status[:n].copy_(d_status[:n], non_blocking=True)
                stream.synchronize()  # this worker's stream alone
                return 0
            except BaseException as e:  # noqa: BLE001 -- raised by the fetch
                raised.append(e)
                return 1

        fn = _INFLATE_FN(inflate)
        if self._lib.svbam_stage_attach(
                self._h, fn, int(card), h_in.data_ptr(), cap,
                h_out.data_ptr(), h_meta.data_ptr(), h_status.data_ptr(),
                nblk) != 0:
            raise ValueError(f"svbam_stage_attach refused {nblk} blocks, "
                             f"{cap} bytes")
        # the C holds the buffers' addresses and the callback
        self._stage = (raised, fn, h_in, h_out, h_meta, h_status,
                       *((d_in, d_out, d_meta, d_status) if card else ()))

    def take_counters(self) -> ReaderCounters:
        """This handle's counters since its open (which reads the header)
        or the last call, which zeroes them all."""
        out = np.zeros(_N_COUNTERS, np.int64)
        self._lib.svbam_take_counters(
            self._h, out.ctypes.data_as(ct.POINTER(ct.c_int64)))
        return ReaderCounters(*out.tolist())

    def ref_name(self, tid: int) -> str:
        """Reference name for a tid (BAM header)."""
        return self._lib.svbam_ref_name(self._h, tid).decode()

    def tid_by_name(self, name: str) -> int:
        """tid for a reference name (tolerates a chr-prefix difference);
        -1 if absent."""
        return int(self._lib.svbam_tid(self._h, name.encode()))

    def fetch_packed(self, tid: int, beg: int, end: int):
        """Returns (pos [R] i64, n_ops [R] i32, opoff [R] i64,
        ops [T] u8, lens [T] i32) — copies of the library's buffers."""
        n = self._lib.svbam_fetch(self._h, tid, beg, end)
        if n < 0:
            self._raise_error()
        if n == 0:
            return (np.empty(0, np.int64), np.empty(0, np.int32),
                    np.empty(0, np.int64), np.empty(0, np.uint8),
                    np.empty(0, np.int32))
        total = self._lib.svbam_total_ops(self._h)
        pos = np.ctypeslib.as_array(self._lib.svbam_read_pos(self._h), (n,)).copy()
        nops = np.ctypeslib.as_array(self._lib.svbam_read_nops(self._h), (n,)).copy()
        opoff = np.ctypeslib.as_array(self._lib.svbam_read_opoff(self._h), (n,)).copy()
        ops = np.ctypeslib.as_array(self._lib.svbam_ops(self._h), (total,)).copy()
        lens = np.ctypeslib.as_array(self._lib.svbam_oplens(self._h), (total,)).copy()
        return pos, nops, opoff, ops, lens

    def ins_seqs_batch(self, tids, begs, ends, min_len: int, los,
                       his) -> list[list[str]]:
        """Inserted-base strings of many sites in one library call: in
        list i, for every read overlapping [begs[i], ends[i]) on tids[i]
        with an I op >= min_len whose refine_ins-convention reference
        position lies in [los[i], his[i]], the decoded SEQ substring of
        that op (the payload the prefix-parse fetch path skips), one
        string per such op in file order; empty where tids[i] < 0.  With a
        batch inflate attached (`stage_inflate`) the sites' blocks are
        inflated by it a slice at a time before their walk; without, each
        site is read lazily."""
        n = len(tids)
        tids = np.ascontiguousarray(tids, np.int32)
        begs, ends, los, his = (np.ascontiguousarray(a, np.int64)
                                for a in (begs, ends, los, his))
        if any(len(a) != n for a in (begs, ends, los, his)):
            raise ValueError("ins_seqs_batch: the site arrays differ in "
                             "length")
        counts = np.zeros(n, np.int64)
        i64 = ct.POINTER(ct.c_int64)
        total = self._lib.svbam_ins_seqs_batch(
            self._h, n, tids.ctypes.data_as(ct.POINTER(ct.c_int32)),
            begs.ctypes.data_as(i64), ends.ctypes.data_as(i64), min_len,
            los.ctypes.data_as(i64), his.ctypes.data_as(i64),
            counts.ctypes.data_as(i64))
        if total < 0:
            self._raise_error()
        if total == 0:
            return [[] for _ in range(n)]
        off = np.ctypeslib.as_array(self._lib.svbam_ins_off(self._h),
                                    (total + 1,)).tolist()
        text = ct.string_at(self._lib.svbam_ins_buf(self._h),
                            off[total]).decode()
        seqs = [text[a:b] for a, b in zip(off, off[1:])]
        out, at = [], 0
        for c in counts.tolist():
            out.append(seqs[at:at + c])
            at += c
        return out

    def fetch_batch(self, tids, begs, ends):
        """Fetch many regions with ONE library call (GIL released for
        the whole batch).  Returns (total_reads, per_window_counts);
        the handle's internal buffers then hold the concatenated reads
        until the next fetch — scatter them with fill() and/or snapshot
        them with batch_columns()."""
        n = len(tids)
        tids = np.ascontiguousarray(tids, np.int32)
        begs = np.ascontiguousarray(begs, np.int64)
        ends = np.ascontiguousarray(ends, np.int64)
        counts = np.empty(n, np.int64)
        total = self._lib.svbam_fetch_batch(
            self._h, n,
            tids.ctypes.data_as(ct.POINTER(ct.c_int32)),
            begs.ctypes.data_as(ct.POINTER(ct.c_int64)),
            ends.ctypes.data_as(ct.POINTER(ct.c_int64)),
            counts.ctypes.data_as(ct.POINTER(ct.c_int64)),
        )
        if total < 0:
            self._raise_error()
        return int(total), counts

    def fetch_batch_merged(self, tids, begs, ends, merge_gap: int):
        """fetch_batch that decodes each read ONCE: windows within
        merge_gap bp of each other are fetched as one merged region and
        every window is assigned the rows of its overlapping reads
        (identical per-window read sets/order to fetch_batch — the
        htslib iterator overlap test is re-applied per window in C).
        The row selection stays on the handle; extract_batch consumes
        it transparently.  NOT compatible with fill()/batch_columns()
        consumers, which assume one row per (read, window) instance."""
        n = len(tids)
        tids = np.ascontiguousarray(tids, np.int32)
        begs = np.ascontiguousarray(begs, np.int64)
        ends = np.ascontiguousarray(ends, np.int64)
        counts = np.empty(n, np.int64)
        total = self._lib.svbam_fetch_batch_merged(
            self._h, n,
            tids.ctypes.data_as(ct.POINTER(ct.c_int32)),
            begs.ctypes.data_as(ct.POINTER(ct.c_int64)),
            ends.ctypes.data_as(ct.POINTER(ct.c_int64)),
            int(merge_gap),
            counts.ctypes.data_as(ct.POINTER(ct.c_int64)),
        )
        if total < 0:
            self._raise_error()
        return int(total), counts

    def extract_batch(self, kinds, istarts, iends, iposs, win_counts,
                      K: int, min_count: int, interval: int, range_: int,
                      wide_cap: int = 0):
        """Host-side evidence extraction over the last fetch_batch.

        Per window: the reference's CIGAR evidence walk
        (refinement.c:103-325) + ascending sort, done in C.  Returns
        (locs [n, K] int32 sorted w/ INT32_MAX padding,
         counts [n] int32 true candidate counts,
         refined [n] int64 — INT64_MIN where the device should run the
         consensus; otherwise the already-computed scalar consensus for
         windows whose candidates overflowed K and ``wide_cap``).  A
         window with K < count <= wide_cap keeps INT64_MIN and a padding
         row; its sorted candidates are in `wide_rows()`."""
        n = len(kinds)
        kinds = np.ascontiguousarray(kinds, np.int32)
        istarts = np.ascontiguousarray(istarts, np.int64)
        iends = np.ascontiguousarray(iends, np.int64)
        iposs = np.ascontiguousarray(iposs, np.int64)
        win_counts = np.ascontiguousarray(win_counts, np.int64)
        locs = np.empty((n, K), np.int32)
        counts = np.empty(n, np.int32)
        refined = np.empty(n, np.int64)
        self._lib.svbam_extract_batch(
            self._h, n,
            kinds.ctypes.data_as(ct.POINTER(ct.c_int32)),
            istarts.ctypes.data_as(ct.POINTER(ct.c_int64)),
            iends.ctypes.data_as(ct.POINTER(ct.c_int64)),
            iposs.ctypes.data_as(ct.POINTER(ct.c_int64)),
            win_counts.ctypes.data_as(ct.POINTER(ct.c_int64)),
            K, max(int(wide_cap), 0), min_count, interval, range_,
            locs.ctypes.data_as(ct.POINTER(ct.c_int32)),
            counts.ctypes.data_as(ct.POINTER(ct.c_int32)),
            refined.ctypes.data_as(ct.POINTER(ct.c_int64)),
        )
        return locs, counts, refined

    def wide_rows(self):
        """The side CSR of the last extract_batch, copied: (windows [m]
        int32, offsets [m+1] int64, candidates [offsets[m]] int32), each
        window's candidates sorted ascending."""
        lib = self._lib
        m = int(lib.svbam_wide_n(self._h))
        if m == 0:
            return (np.empty(0, np.int32), np.zeros(1, np.int64),
                    np.empty(0, np.int32))
        off = np.ctypeslib.as_array(lib.svbam_wide_off(self._h),
                                    (m + 1,)).copy()
        win = np.ctypeslib.as_array(lib.svbam_wide_win(self._h), (m,)).copy()
        val = np.ctypeslib.as_array(lib.svbam_wide_val(self._h),
                                    (int(off[m]),)).copy()
        return win, off, val

    def batch_flat_n(self, n_reads: int):
        """Fast snapshot of the last fetch as flat CSR columns:
        (pos i64[R], n_ops i32[R], ops u8[T], lens i32[T]).  The op
        streams are contiguous in read order (fetch appends), so no
        per-read offsets are needed."""
        lib = self._lib
        if n_reads == 0:
            return (np.empty(0, np.int64), np.empty(0, np.int32),
                    np.empty(0, np.uint8), np.empty(0, np.int32))
        total = int(lib.svbam_total_ops(self._h))

        def cp(ptr, n, cty, dt):
            if n == 0:
                return np.empty(0, dt)
            arr = ct.cast(ptr, ct.POINTER(cty * n)).contents
            return np.frombuffer(arr, dt).copy()

        return (
            cp(lib.svbam_read_pos(self._h), n_reads, ct.c_int64, np.int64),
            cp(lib.svbam_read_nops(self._h), n_reads, ct.c_int32, np.int32),
            cp(lib.svbam_ops(self._h), total, ct.c_uint8, np.uint8),
            cp(lib.svbam_oplens(self._h), total, ct.c_int32, np.int32),
        )

    def batch_columns_n(self, n_reads: int):
        """Snapshot (copy) the columnar buffers of the last fetch:
        (pos i64[R], n_ops i32[R], opoff i64[R], ops u8[T], lens i32[T])."""
        lib = self._lib
        total = lib.svbam_total_ops(self._h)
        if n_reads == 0:
            return (np.empty(0, np.int64), np.empty(0, np.int32),
                    np.empty(0, np.int64), np.empty(0, np.uint8),
                    np.empty(0, np.int32))
        pos = np.ctypeslib.as_array(lib.svbam_read_pos(self._h), (n_reads,)).copy()
        nops = np.ctypeslib.as_array(lib.svbam_read_nops(self._h), (n_reads,)).copy()
        opoff = np.ctypeslib.as_array(lib.svbam_read_opoff(self._h), (n_reads,)).copy()
        ops = np.ctypeslib.as_array(lib.svbam_ops(self._h), (total,)).copy()
        lens = np.ctypeslib.as_array(lib.svbam_oplens(self._h), (total,)).copy()
        return pos, nops, opoff, ops, lens

    def batch_widx(self) -> np.ndarray:
        """A copy of the last merged fetch's row selection: each window's
        rows in window order (empty after a plain fetch_batch)."""
        n = int(self._lib.svbam_widx_n(self._h))
        if n == 0:
            return np.empty(0, np.int64)
        return np.ctypeslib.as_array(self._lib.svbam_widx(self._h),
                                     (n,)).copy()

    def max_nops(self, n_reads: int) -> int:
        if n_reads == 0:
            return 0
        v = np.ctypeslib.as_array(
            self._lib.svbam_read_nops(self._h), (n_reads,)
        )
        return int(v.max())

    def fill(self, wid_of_read, ops_mat, lens_mat, pos, n_ops, wid,
             pad_wid: int):
        """Scatter the last fetch into the caller-allocated device
        matrices (C fills all padding; arrays must be C-contiguous)."""
        N, O = ops_mat.shape
        self._lib.svbam_fill(
            self._h,
            np.ascontiguousarray(wid_of_read, np.int32).ctypes.data_as(
                ct.POINTER(ct.c_int32)),
            ops_mat.ctypes.data_as(ct.POINTER(ct.c_int8)),
            lens_mat.ctypes.data_as(ct.POINTER(ct.c_int32)),
            pos.ctypes.data_as(ct.POINTER(ct.c_int32)),
            n_ops.ctypes.data_as(ct.POINTER(ct.c_int32)),
            wid.ctypes.data_as(ct.POINTER(ct.c_int32)),
            N, O, pad_wid,
        )

    def fetch(self, tid: int, beg: int, end: int):
        pos, nops, opoff, ops, lens = self.fetch_packed(tid, beg, end)
        out = []
        for r in range(len(pos)):
            o = int(opoff[r])
            n = int(nops[r])
            cig = list(zip(ops[o : o + n].tolist(), lens[o : o + n].tolist()))
            out.append(_Rec(int(pos[r]), cig))
        return out


class _Rec:
    """Minimal record shim matching the attrs the pipeline uses."""

    __slots__ = ("pos", "cigar")

    def __init__(self, pos, cigar):
        self.pos = pos
        self.cigar = cigar


def baseline_refine(lib, kind, reads_packed, istart, iend, ipos,
                    min_count, interval, range_):
    """Invoke the C scalar refine on packed arrays (bench baseline)."""
    pos, nops, opoff, ops, lens = reads_packed
    return lib.svbaseline_refine(
        kind,
        pos.ctypes.data_as(ct.POINTER(ct.c_int64)),
        nops.ctypes.data_as(ct.POINTER(ct.c_int32)),
        opoff.ctypes.data_as(ct.POINTER(ct.c_int64)),
        ops.ctypes.data_as(ct.POINTER(ct.c_uint8)),
        lens.ctypes.data_as(ct.POINTER(ct.c_int32)),
        len(pos), istart, iend, ipos, min_count, interval, range_,
    )
