"""ctypes wrapper for the native GAF tokenizer + projector.

The C fast path (native/svtrek_native.c, svgaf_*) parses GAF lines and
projects each read's graph alignment onto the rank-0 backbone with
semantics identical to the Python path (io/gaf.py: parse_gaf_line /
parse_nodes / project_alignment / iter_gaf's first-wins dedupe) — the
completed form of the reference's WIP parse_gaf loop
(discover.c:46-246).  Each batch arrives as CSR run arrays (flat op/len
+ per-read offsets), the exact shape the batched device scan packs from,
so no per-read Python objects exist on this path at all.

Golden-tested against the Python path in tests/test_gaf_native.py.
"""
from __future__ import annotations

import ctypes as ct

import numpy as np

from ..native.bamlib import load_library

_PROTO_DONE = False


def _proto(lib):
    global _PROTO_DONE
    if _PROTO_DONE:
        return
    lib.svgaf_open.restype = ct.c_void_p
    lib.svgaf_open.argtypes = [
        ct.c_char_p, ct.c_int64, ct.POINTER(ct.c_int64),
        ct.POINTER(ct.c_int32), ct.POINTER(ct.c_int64),
        ct.POINTER(ct.c_int64), ct.POINTER(ct.c_int64),
    ]
    lib.svgaf_close.argtypes = [ct.c_void_p]
    lib.svgaf_next_batch.restype = ct.c_int64
    lib.svgaf_next_batch.argtypes = [ct.c_void_p, ct.c_int64]
    for name, ty in [
        ("svgaf_nruns", ct.POINTER(ct.c_int32)),
        ("svgaf_runoff", ct.POINTER(ct.c_int64)),
        ("svgaf_ops", ct.POINTER(ct.c_int8)),
        ("svgaf_oplens", ct.POINTER(ct.c_int32)),
        ("svgaf_refstart", ct.POINTER(ct.c_int64)),
        ("svgaf_rc", ct.POINTER(ct.c_uint8)),
        ("svgaf_rmeta", ct.POINTER(ct.c_int32)),
        ("svgaf_names", ct.POINTER(ct.c_char)),
        ("svgaf_nameoff", ct.POINTER(ct.c_int64)),
        ("svgaf_err_names", ct.POINTER(ct.c_char)),
        ("svgaf_erroff", ct.POINTER(ct.c_int64)),
    ]:
        fn = getattr(lib, name)
        fn.restype = ty
        fn.argtypes = [ct.c_void_p]
    for name in ("svgaf_total_runs", "svgaf_err_count"):
        fn = getattr(lib, name)
        fn.restype = ct.c_int64
        fn.argtypes = [ct.c_void_p]
    _PROTO_DONE = True


class GafBatch:
    """One batch of projected reads in CSR form (copies — valid after
    the reader advances)."""

    __slots__ = ("n", "n_runs", "run_off", "flat_ops", "flat_lens",
                 "ref_start", "rc", "read_len", "read_start", "read_end",
                 "names_buf", "name_off")

    def name(self, i: int) -> str:
        return self.names_buf[self.name_off[i]:self.name_off[i + 1]].decode()

    def runs(self, i: int) -> list[tuple[int, int]]:
        """Row i's (op, len) runs — only used on rare fallback paths."""
        o = int(self.run_off[i])
        e = o + int(self.n_runs[i])
        return list(zip(self.flat_ops[o:e].tolist(),
                        self.flat_lens[o:e].tolist()))


def _arr(ptr, n, dtype):
    if n == 0:
        return np.empty(0, dtype)
    return np.ctypeslib.as_array(ptr, shape=(n,)).astype(dtype, copy=True)


class NativeGafReader:
    """Streams GafBatches from the C fast path.  Raises OSError if the
    native library is unavailable."""

    def __init__(self, gaf_path: str, gfa):
        lib = load_library()
        _proto(lib)
        self._lib = lib
        segs = gfa.segments
        ids = np.array([s.id for s in segs], np.int64)
        order = np.argsort(ids, kind="stable")
        self._ids = ids[order].copy()
        self._rank = np.array([segs[i].rank for i in order], np.int32)
        self._start = np.array([segs[i].start for i in order], np.int64)
        self._end = np.array([segs[i].end for i in order], np.int64)
        self._len = np.array([len(segs[i].seq) for i in order], np.int64)
        self.h = lib.svgaf_open(
            gaf_path.encode(), len(segs),
            self._ids.ctypes.data_as(ct.POINTER(ct.c_int64)),
            self._rank.ctypes.data_as(ct.POINTER(ct.c_int32)),
            self._start.ctypes.data_as(ct.POINTER(ct.c_int64)),
            self._end.ctypes.data_as(ct.POINTER(ct.c_int64)),
            self._len.ctypes.data_as(ct.POINTER(ct.c_int64)),
        )
        if not self.h:
            raise OSError(f"svgaf_open failed for {gaf_path}")
        self.errors: list[str] = []   # invalid-path read names, file order

    def next_batch(self, max_reads: int) -> GafBatch | None:
        lib, h = self._lib, self.h
        n = lib.svgaf_next_batch(h, max_reads)
        # Errors can accompany an EOF batch (n == 0) too.
        n_err = lib.svgaf_err_count(h)
        if n_err:
            eoff = _arr(lib.svgaf_erroff(h), n_err + 1, np.int64)
            ebuf = ct.string_at(lib.svgaf_err_names(h), int(eoff[-1]))
            self.errors.extend(
                ebuf[eoff[i]:eoff[i + 1]].decode() for i in range(n_err))
        if n == 0:
            return None
        b = GafBatch()
        b.n = int(n)
        b.n_runs = _arr(lib.svgaf_nruns(h), n, np.int32)
        b.run_off = _arr(lib.svgaf_runoff(h), n, np.int64)
        total = lib.svgaf_total_runs(h)
        b.flat_ops = _arr(lib.svgaf_ops(h), total, np.int8)
        b.flat_lens = _arr(lib.svgaf_oplens(h), total, np.int32)
        b.ref_start = _arr(lib.svgaf_refstart(h), n, np.int64)
        b.rc = _arr(lib.svgaf_rc(h), n, np.uint8)
        rmeta = _arr(lib.svgaf_rmeta(h), 3 * n, np.int32).reshape(n, 3)
        b.read_len, b.read_start, b.read_end = (
            rmeta[:, 0].copy(), rmeta[:, 1].copy(), rmeta[:, 2].copy())
        noff = _arr(lib.svgaf_nameoff(h), n + 1, np.int64)
        b.name_off = noff
        b.names_buf = ct.string_at(lib.svgaf_names(h), int(noff[-1]))
        return b

    def close(self):
        if self.h:
            self._lib.svgaf_close(self.h)
            self.h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
