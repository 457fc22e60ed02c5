"""ctypes bindings for the native BAM reader and scalar baseline."""
from __future__ import annotations

import ctypes as ct

import numpy as np

_LIB = None


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
    lib.svbam_ins_seqs.restype = ct.c_int64
    lib.svbam_ins_seqs.argtypes = [
        ct.c_void_p, ct.c_int32, ct.c_int64, ct.c_int64,
        ct.c_int32, ct.c_int64, ct.c_int64,
    ]
    lib.svbam_counters.restype = None
    lib.svbam_counters.argtypes = [ct.c_void_p, ct.POINTER(ct.c_int64)]
    lib.svbam_ins_buf.restype = ct.POINTER(ct.c_char)
    lib.svbam_ins_buf.argtypes = [ct.c_void_p]
    lib.svbam_ins_off.restype = ct.POINTER(ct.c_int64)
    lib.svbam_ins_off.argtypes = [ct.c_void_p]
    _LIB = lib
    return lib


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

    def close(self):
        if self._h:
            self._lib.svbam_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def _raise_error(self):
        msg = self._lib.svbam_error(self._h)
        raise NativeBamError(
            msg.decode() if msg else "BAM decode failed")

    def counters(self) -> tuple[int, int]:
        """(ns inside BGZF inflate, bytes inflated) on this handle since
        the last call, which zeroes them: a block served from the handle's
        cache or skipped unread counts nothing."""
        out = np.zeros(2, np.int64)
        self._lib.svbam_counters(self._h,
                                 out.ctypes.data_as(ct.POINTER(ct.c_int64)))
        return int(out[0]), int(out[1])

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

    def ins_seqs(self, tid: int, beg: int, end: int, min_len: int,
                 lo: int, hi: int) -> list[str]:
        """Inserted-base strings: for every read overlapping
        [beg, end) with an I op >= min_len whose refine_ins-convention
        reference position lies in [lo, hi], the decoded SEQ substring
        of that op (the payload the prefix-parse fetch path skips).
        One string per qualifying I op, file order."""
        n = self._lib.svbam_ins_seqs(self._h, tid, beg, end,
                                     min_len, lo, hi)
        if n < 0:
            self._raise_error()
        if n == 0:
            return []
        off = np.ctypeslib.as_array(self._lib.svbam_ins_off(self._h),
                                    (n + 1,))
        buf = ct.string_at(self._lib.svbam_ins_buf(self._h), int(off[n]))
        return [buf[off[i]:off[i + 1]].decode() for i in range(n)]

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
