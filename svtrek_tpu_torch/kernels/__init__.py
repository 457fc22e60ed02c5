"""Hand-written CUDA kernels and their ctypes bindings.

The library is built from `csrc/` at the first launch (`build.build`) and
loaded once.  Each wrapper takes CUDA tensors only, checks them, allocates
its outputs (filled where the kernel expects it), launches on the current
stream and raises if the launch fails.  `launch_counts` counts each
wrapper's launches, so a run can show that its main path went through the
kernels.
"""
from __future__ import annotations

import ctypes as ct
import threading
import zlib

import torch

# Kernel launches per wrapper since the last reset_launch_counts().
# "poa_dp_ptr" counts K2's strip-kernel launches, "poa_dp_ptr_wide" its
# wide kernel's.
launch_counts: dict[str, int] = {"consensus_pos": 0, "poa_dp_ptr": 0,
                                 "poa_dp_ptr_wide": 0, "poa_traceback": 0,
                                 "poa_vote": 0, "step_probe": 0,
                                 "poa_graph_dp": 0, "bgzf_inflate": 0}
# The widest row K1 takes: one warp's row and its int64 prefix sums in the
# shared memory of a block (csrc/consensus.cu).  The first pass ships K <=
# 8192; a window past the first pass's width takes a second pass at the
# width it needs (`ops.consensus.consensus_pos_full`), up to this one.
CONSENSUS_MAX_K = 16384
# The widest per-pair band K2 takes (the main path's band cap; the wide
# kernel's strips hold up to POA_WIDE_MAX_BAND).
POA_MAX_BAND = 2048
# K2's strip kernel: the strip widths S it is built for (one warp per pair,
# S score cells a lane), and the widest band they hold (32 * 33 cells >=
# 2 * 527 + 1).  Wider bands take the wide kernel: POA_WIDE_WARPS warps a
# pair, S cells a lane from POA_WIDE_STRIPS (32 * 8 * 17 cells >= 2 * 2175
# + 1).  A pair's class (W, S) is (1, S) or (POA_WIDE_WARPS, S), the
# smallest S of its table with 32*W*S >= 2*band+1.  csrc/poa.cu holds the
# same tables.
POA_STRIPS = (1, 2, 3, 4, 5, 6, 8, 12, 16, 24, 33)
POA_STRIP_MAX_BAND = (32 * POA_STRIPS[-1] - 1) // 2
POA_WIDE_WARPS = 8
POA_WIDE_STRIPS = (5, 6, 8, 10, 12, 14, 17)
POA_WIDE_MAX_BAND = (32 * POA_WIDE_WARPS * POA_WIDE_STRIPS[-1] - 1) // 2
# K5's int64 fields a cluster (`poa_vote_cuda`'s meta): its pairs' rows
# [lo, hi), m, n_members, n_equal, the offset of its target in targets,
# the offset and size of its output.
POA_VOTE_META = 8
# G1 (csrc/poa_graph.cu): the largest graph (nodes), query and predecessor
# count it takes (ops/poa_graph_batch.py routes at these: its V_CAP, N_CAP
# and P_CAP); a row's cells, n+1 rounded up to GRAPH_ROW_ALIGN (whole lane
# strips and 16-byte chunks); the scratch's bytes a cell (H int32 and a
# one-byte code, slot * 4 + move, of each pair's (V+1) rows) and of one
# launch (a larger batch is split into several launches); and a block's
# shared memory on the card, which holds G1's ring of recent rows
# (`graph_ring_rows`).
GRAPH_V_CAP, GRAPH_N_CAP, GRAPH_P_CAP = 65536, 16384, 32
GRAPH_ROW_ALIGN = 32
GRAPH_CELL_BYTES = 5
GRAPH_SMEM_BYTES = 232_448
GRAPH_SCRATCH_BYTES = 1 << 31
# The BGZF inflate (csrc/inflate.cu): a block's largest inflated size, the
# stride of its output rows, and the status it gives each block.
BGZF_BLOCK_BYTES = 65536
INFLATE_OK, INFLATE_BAD, INFLATE_LENGTH = 0, 1, 2

_LIB = None
# The producer pool's workers launch the inflate kernel from their own
# threads: the first launches must not build the library side by side.
_LIB_LOCK = threading.Lock()
# poa_strip_widths' lookup table on each device it has run on.
_STRIP_BY_NEED: dict[torch.device, torch.Tensor] = {}
# The stream of K2's wide kernel on each card (`_dp_ptr_launch`).
_SIDE_STREAM: dict[torch.device, "torch.cuda.Stream"] = {}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def load_library():
    """Build (if stale) and load the kernel library; raises on failure.
    Threads that ask at once build and load it once."""
    if _LIB is None:
        with _LIB_LOCK:
            _load()
    return _LIB


def _load():
    global _LIB
    if _LIB is None:
        from .build import build

        lib = ct.CDLL(build())
        ptr = ct.c_void_p
        lib.svtrek_consensus_pos.restype = ct.c_int
        lib.svtrek_consensus_pos.argtypes = [
            ptr, ptr, ptr, ct.c_int, ct.c_int, ct.c_int,
            ct.c_int, ct.c_int, ct.c_int, ptr, ptr, ptr,
        ]
        lib.svtrek_consensus_max_k.restype = ct.c_int
        if lib.svtrek_consensus_max_k() != CONSENSUS_MAX_K:
            raise RuntimeError("csrc/consensus.cu and "
                               "kernels.CONSENSUS_MAX_K differ")
        for fn in (lib.svtrek_poa_dp_ptr_strip, lib.svtrek_poa_dp_ptr_wide):
            fn.restype = ct.c_int
            fn.argtypes = [ptr, ct.c_int, ptr, ptr, ct.c_int, ptr, ptr, ptr,
                           ptr, ptr, ptr, ct.c_int, ptr]
        lib.svtrek_poa_strip_max_band.restype = ct.c_int
        lib.svtrek_poa_wide_max_band.restype = ct.c_int
        lib.svtrek_poa_strips.restype = ct.c_int
        lib.svtrek_poa_strips.argtypes = [ct.c_int, ptr, ct.c_int]
        if (lib.svtrek_poa_strip_max_band(), lib.svtrek_poa_wide_max_band(),
                _strip_table(lib, 0), _strip_table(lib, 1)) != (
                POA_STRIP_MAX_BAND, POA_WIDE_MAX_BAND, POA_STRIPS,
                POA_WIDE_STRIPS):
            raise RuntimeError("csrc/poa.cu and kernels.POA_STRIPS, "
                               "POA_WIDE_WARPS, POA_WIDE_STRIPS differ")
        lib.svtrek_poa_traceback.restype = ct.c_int
        lib.svtrek_poa_traceback.argtypes = [
            ptr, ct.c_longlong, ptr, ptr, ct.c_int, ptr, ptr, ptr, ptr,
            ct.c_int, ct.c_int, ptr, ptr, ptr,
        ]
        lib.svtrek_poa_vote_meta.restype = ct.c_int
        if lib.svtrek_poa_vote_meta() != POA_VOTE_META:
            raise RuntimeError("csrc/poa.cu and kernels.POA_VOTE_META differ")
        lib.svtrek_poa_vote.restype = ct.c_int
        lib.svtrek_poa_vote.argtypes = [ptr, ptr, ptr, ct.c_int, ct.c_int,
                                        ptr, ptr, ptr, ct.c_int, ptr, ptr]
        bind_graph(lib)
        lib.svtrek_bgzf_inflate.restype = ct.c_int
        lib.svtrek_bgzf_inflate.argtypes = [ptr, ptr, ct.c_int, ptr, ptr,
                                            ptr]
        if lib.svtrek_bgzf_block_bytes() != BGZF_BLOCK_BYTES:
            raise RuntimeError("csrc/inflate.cu and "
                               "kernels.BGZF_BLOCK_BYTES differ")
        lib.svtrek_step_probe.restype = ct.c_int
        lib.svtrek_step_probe.argtypes = [ptr, ct.c_int, ct.c_int, ct.c_int,
                                          ct.c_int, ct.c_int, ptr, ptr]
        lib.svtrek_cuda_error_string.restype = ct.c_char_p
        lib.svtrek_cuda_error_string.argtypes = [ct.c_int]
        _LIB = lib
    return _LIB


def _strip_table(lib, wide: int) -> tuple[int, ...]:
    """The strip widths csrc/poa.cu's strip (wide 0) or wide (1) kernel is
    built for (`svtrek_poa_strips`)."""
    out = (ct.c_int * 64)()
    return tuple(out[:lib.svtrek_poa_strips(wide, out, len(out))])


def bind_graph(lib) -> None:
    """Give a library built from csrc/poa_graph.cu (or a copy of it) G1's
    C interface; raises if its caps or its shared-memory arithmetic
    differ from kernels.GRAPH_* and `graph_smem_bytes`."""
    ptr = ct.c_void_p
    for name, argc in (("svtrek_poa_graph_cap", 1),
                       ("svtrek_poa_graph_ring_rows", 1),
                       ("svtrek_poa_graph_smem", 2)):
        fn = getattr(lib, name)
        fn.restype = ct.c_int
        fn.argtypes = [ct.c_int] * argc
    if tuple(lib.svtrek_poa_graph_cap(k) for k in range(5)) != (
            GRAPH_V_CAP, GRAPH_N_CAP, GRAPH_P_CAP, GRAPH_ROW_ALIGN,
            GRAPH_CELL_BYTES):
        raise RuntimeError("csrc/poa_graph.cu and kernels.GRAPH_* differ")
    for n in (0, 1, 1020, 4096, 6751, 6752, 13119, 13120, GRAPH_N_CAP,
              GRAPH_N_CAP + 1):
        for V in (16, GRAPH_V_CAP):
            if (lib.svtrek_poa_graph_ring_rows(n),
                    lib.svtrek_poa_graph_smem(n, V)) != (
                    graph_ring_rows(n), graph_smem_bytes(n, V)):
                raise RuntimeError(f"csrc/poa_graph.cu and kernels differ "
                                   f"on G1's ring at n={n}, V={V}")
    lib.svtrek_poa_graph_dp.restype = ct.c_int
    lib.svtrek_poa_graph_dp.argtypes = [
        ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ct.c_int, ct.c_int,
        ct.c_int, ct.c_int, ct.c_int, ct.c_int, ptr, ptr, ptr, ptr, ptr,
        ptr,
    ]


def _check(name: str, t: torch.Tensor, shape: tuple, device,
           dtype=torch.int32) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def _launched(name: str, lib, rc: int) -> None:
    """Raise if a launch failed; else count it."""
    if rc != 0:
        raise RuntimeError(
            f"{name} kernel launch failed: "
            f"{lib.svtrek_cuda_error_string(rc).decode()} ({rc})")
    launch_counts[name] += 1


def _require_cuda(name: str, t: torch.Tensor) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name} takes CUDA tensors, got {t.device}")


def consensus_pos_cuda(locs: torch.Tensor, n: torch.Tensor,
                       pos: torch.Tensor, *, min_count: int, interval: int,
                       range_: int, sweep_width: int
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel K1 (csrc/consensus.cu): the whole batched consensus_pos.

    locs [B, K] int32, rows sorted ascending with INT32_MAX padding;
    n [B] int32 valid counts (<= K); pos [B] int32.  Returns (refined [B]
    int32 with -1 = NA, overflow [B] bool), equal to
    `ops.consensus.consensus_pos_batch_reference`."""
    _require_cuda("consensus_pos_cuda", locs)
    if locs.dim() != 2 or not 1 <= locs.shape[1] <= CONSENSUS_MAX_K:
        raise ValueError(f"locs must be [B, K] with 1 <= K <= "
                         f"{CONSENSUS_MAX_K}, got {tuple(locs.shape)}")
    if sweep_width < 1:
        raise ValueError(f"sweep_width must be >= 1, got {sweep_width}")
    B, K = locs.shape
    _check("locs", locs, (B, K), locs.device)
    _check("n", n, (B,), locs.device)
    _check("pos", pos, (B,), locs.device)
    refined = torch.empty(B, dtype=torch.int32, device=locs.device)
    overflow = torch.empty(B, dtype=torch.bool, device=locs.device)
    if B == 0:
        return refined, overflow
    lib = load_library()
    with torch.cuda.device(locs.device):
        stream = torch.cuda.current_stream(locs.device).cuda_stream
        rc = lib.svtrek_consensus_pos(
            locs.data_ptr(), n.data_ptr(), pos.data_ptr(), B, K,
            min(sweep_width, K), min_count, interval, range_,
            refined.data_ptr(), overflow.data_ptr(), stream)
    _launched("consensus_pos", lib, rc)
    return refined, overflow


def poa_ptr_offsets(ns: torch.Tensor, bands: torch.Tensor) -> torch.Tensor:
    """Byte offsets [B+1] int64 of each pair's pointer rows in K2's output:
    pair b holds ns[b] rows of 2*bands[b]+1 codes."""
    sizes = ns.long() * (2 * bands.long() + 1)
    return torch.cat([sizes.new_zeros(1), torch.cumsum(sizes, 0)])


def _pair_args(tpad, ms, qpad, ns, bands) -> tuple[int, int, int]:
    """Check the types and shapes of a pair batch; returns (B, M, N)."""
    if tpad.dim() != 2 or qpad.dim() != 2:
        raise ValueError(f"tpad and qpad must be [B, M] and [B, N], got "
                         f"{tuple(tpad.shape)} and {tuple(qpad.shape)}")
    (B, M), N = tpad.shape, qpad.shape[1]
    dev = tpad.device
    _check("tpad", tpad, (B, M), dev, torch.int8)
    _check("qpad", qpad, (B, N), dev, torch.int8)
    for name, t in (("ms", ms), ("ns", ns), ("bands", bands)):
        _check(name, t, (B,), dev)
    return B, M, N


def poa_warps(band: int) -> int:
    """The warps of a band's K2 class: 1 (the strip kernel) up to
    POA_STRIP_MAX_BAND, POA_WIDE_WARPS (the wide kernel) above."""
    return 1 if band <= POA_STRIP_MAX_BAND else POA_WIDE_WARPS


def _strip_for(c: int) -> int:
    """The strip width S of the class of a row of c lane-widths (32 cells
    each): the smallest of POA_STRIPS >= c, or past them the smallest of
    POA_WIDE_STRIPS with POA_WIDE_WARPS*S >= c (0 past those too)."""
    if c <= POA_STRIPS[-1]:
        return min(w for w in POA_STRIPS if w >= c)
    return min((w for w in POA_WIDE_STRIPS if POA_WIDE_WARPS * w >= c),
               default=0)


def poa_strip_widths(bands: torch.Tensor) -> torch.Tensor:
    """Each pair's strip width S in its K2 class (W, S): W = `poa_warps`,
    S the smallest of its table with 32*W*S >= 2*band+1 (`_strip_for`),
    for every band up to POA_WIDE_MAX_BAND.  int32 [B], on bands'
    device."""
    need = (2 * bands.long() + 32) // 32  # ceil((2*band+1) / 32)
    by_need = _STRIP_BY_NEED.get(bands.device)
    if by_need is None:
        # by_need[c]: the strip width of c cells a lane; copied to each
        # device once.
        by_need = _STRIP_BY_NEED[bands.device] = torch.tensor(
            [_strip_for(c) for c in range(
                POA_WIDE_WARPS * POA_WIDE_STRIPS[-1] + 2)],
            dtype=torch.int32, device=bands.device)
    return by_need[need.clamp(max=len(by_need) - 1)]


def poa_work_order(ns: torch.Tensor, bands: torch.Tensor) -> torch.Tensor:
    """K2's work list, int32 [B]: the pairs of the strip kernel, then those
    of the wide kernel, each by n*(2*band+1) descending (ties in input
    order), so that the longest chains of rows start first."""
    work = ns.long() * (2 * bands.long() + 1)
    wide = (bands > POA_STRIP_MAX_BAND).long()
    return torch.argsort(wide * (1 << 42) - work, stable=True).to(torch.int32)


def _check_pairs(M: int, N: int, ms, ns, bands, *more) -> tuple[int, list]:
    """Raise unless 0 <= m <= M, 0 <= n <= N and |n - m| <= band <=
    POA_MAX_BAND for every pair (the walk starts inside the band).  The
    checks reduce on the device; their results and the 0-d tensors ``more``
    come to the host in one read.  Returns (the widest band, more as
    ints)."""
    m, n, band = ms.long(), ns.long(), bands.long()
    highs = torch.stack([-m, m, -n, n, band, (n - m).abs() - band]).amax(1)
    neg_lo_m, hi_m, neg_lo_n, hi_n, hi_band, outside, *rest = torch.cat(
        [highs, *(t.long().reshape(1) for t in more)]).tolist()
    lo_m, lo_n = -neg_lo_m, -neg_lo_n
    if lo_m < 0 or lo_n < 0 or hi_m > M or hi_n > N or outside > 0 \
            or hi_band > POA_MAX_BAND:
        raise ValueError(
            f"pair lengths or bands out of range: m in [{lo_m}, {hi_m}] "
            f"(M={M}), n in [{lo_n}, {hi_n}] (N={N}), max band {hi_band} "
            f"(at most {POA_MAX_BAND}), max |n - m| - band {outside} (at "
            f"most 0)")
    return hi_band, rest


def poa_dp_plan(M: int, N: int, ms: torch.Tensor, ns: torch.Tensor,
                bands: torch.Tensor):
    """K2's launch plan, made on the pairs' device: (offsets [B+1] int64 of
    `poa_ptr_offsets`, the work list [B] int32 of `poa_work_order`, the
    strip widths [B] int32 of `poa_strip_widths`, the pointer bytes, the
    number of strip pairs, which lead the work list).  The last two come
    to the host with the range checks of `_check_pairs`, in one read,
    which raises for a pair the kernels do not take.  Its cost is host
    dispatch, one launch per op, so the lengths are cast to int64 once:
    the helpers' own casts are then no-ops."""
    m, n, band = ms.long(), ns.long(), bands.long()
    offsets = poa_ptr_offsets(n, band)
    strips = poa_strip_widths(band)
    order = poa_work_order(n, band)
    _, (total, n_strip) = _check_pairs(
        M, N, m, n, band, offsets[-1], (band <= POA_STRIP_MAX_BAND).sum())
    return offsets, order, strips, total, n_strip


def _dp_ptr_launch(tpad, ms, qpad, ns, bands, plan) -> torch.Tensor:
    """K2's launches over a batch checked by `_pair_args` with its plan
    (`poa_dp_plan`); returns the pointers.  The wide pairs' launch runs on
    a side stream, after the current stream's work so far, beside the
    strip pairs' launch on the current stream, which then waits for it:
    the batch takes the longer of the two, not their sum.  (Every tensor
    the side stream touches is the current stream's, which waits for it
    before anything else runs.)"""
    offsets, order, strips, total, n_strip = plan
    (B, M), N, dev = tpad.shape, qpad.shape[1], tpad.device
    ptr = torch.empty(total, dtype=torch.int8, device=dev)
    lib = load_library()
    args = (tpad.data_ptr(), M, ms.data_ptr(), qpad.data_ptr(), N,
            ns.data_ptr(), bands.data_ptr(), offsets.data_ptr(),
            ptr.data_ptr())
    with torch.cuda.device(dev):
        cur = torch.cuda.current_stream(dev)
        if n_strip < B:
            side = _SIDE_STREAM.get(dev)
            if side is None:
                side = _SIDE_STREAM[dev] = torch.cuda.Stream(dev)
            side.wait_stream(cur)
            rc = lib.svtrek_poa_dp_ptr_wide(
                *args, order[n_strip:].data_ptr(), strips.data_ptr(),
                B - n_strip, side.cuda_stream)
            _launched("poa_dp_ptr_wide", lib, rc)
        if n_strip:
            rc = lib.svtrek_poa_dp_ptr_strip(
                *args, order.data_ptr(), strips.data_ptr(), n_strip,
                cur.cuda_stream)
            _launched("poa_dp_ptr", lib, rc)
        if n_strip < B:
            cur.wait_stream(side)
    return ptr


def _traceback_launch(ptr, offsets, order, qpad, ms, ns, bands, M: int
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """K3's launch over checked pointers in the work-list order `order`;
    the kernel writes every byte of cols and ins."""
    B, N = qpad.shape
    dev = qpad.device
    cols = torch.empty((B, M), dtype=torch.int8, device=dev)
    ins = torch.empty((B, M + 1), dtype=torch.int32, device=dev)
    lib = load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.svtrek_poa_traceback(
            ptr.data_ptr(), ptr.numel(), offsets.data_ptr(), qpad.data_ptr(),
            N, ms.data_ptr(), ns.data_ptr(), bands.data_ptr(),
            order.data_ptr(), B, M, cols.data_ptr(), ins.data_ptr(), stream)
    _launched("poa_traceback", lib, rc)
    return cols, ins


def poa_dp_ptr_cuda(tpad: torch.Tensor, ms: torch.Tensor, qpad: torch.Tensor,
                    ns: torch.Tensor, bands: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel K2 (csrc/poa.cu): the banded DP's pointer rows of every pair.

    tpad [B, M] / qpad [B, N] int8 bases padded with 5; ms, ns, bands [B]
    int32.  Returns (ptr, offsets): pair b's row i (1..n) lies at
    ptr[offsets[b] + (i-1)*(2*band+1) :][: 2*band+1], its cell k at target
    column j = i + k - band, with the codes of
    `ops.poa_dp.dp_ptr_reference` (0 diag, 1 up, 2 left).

    The plan (`poa_dp_plan`) is made on the device, with one host read.
    The pairs with a band up to POA_STRIP_MAX_BAND run in one launch of
    the strip kernel, the wider ones in one launch of the wide kernel
    beside it (`_dp_ptr_launch`)."""
    _require_cuda("poa_dp_ptr_cuda", tpad)
    B, M, N = _pair_args(tpad, ms, qpad, ns, bands)
    dev = tpad.device
    if B == 0:
        return (torch.empty(0, dtype=torch.int8, device=dev),
                torch.zeros(1, dtype=torch.int64, device=dev))
    plan = poa_dp_plan(M, N, ms, ns, bands)
    return _dp_ptr_launch(tpad, ms, qpad, ns, bands, plan), plan[0]


def poa_traceback_cuda(ptr: torch.Tensor, offsets: torch.Tensor,
                       qpad: torch.Tensor, ms: torch.Tensor, ns: torch.Tensor,
                       bands: torch.Tensor, *, M: int
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel K3 (csrc/poa.cu): the traceback of every pair over K2's
    pointers.  Returns (cols [B, M] int8: the query base aligned to each
    target column, -1 = gap; ins [B, M+1] int32: query bases inserted
    before each column), equal to `ops.poa_dp.traceback_reference`.

    For a caller that holds only the pointers: the pairs are checked with
    one host read, and walked in K2's work-list order."""
    _require_cuda("poa_traceback_cuda", ptr)
    if qpad.dim() != 2:
        raise ValueError(f"qpad must be [B, N], got {tuple(qpad.shape)}")
    B, N = qpad.shape
    dev = ptr.device
    _check("qpad", qpad, (B, N), dev, torch.int8)
    _check("offsets", offsets, (B + 1,), dev, torch.int64)
    for name, t in (("ms", ms), ("ns", ns), ("bands", bands)):
        _check(name, t, (B,), dev)
    if ptr.dim() != 1 or ptr.dtype != torch.int8:
        raise ValueError(f"ptr must be 1-D int8, got {ptr.dtype} "
                         f"{tuple(ptr.shape)}")
    if B == 0:
        return (torch.empty((0, M), dtype=torch.int8, device=dev),
                torch.empty((0, M + 1), dtype=torch.int32, device=dev))
    order = poa_work_order(ns, bands)
    _, (total,) = _check_pairs(M, N, ms, ns, bands, offsets[-1])
    if total != ptr.numel():
        raise ValueError(f"ptr holds {ptr.numel()} bytes, offsets say "
                         f"{total}")
    return _traceback_launch(ptr, offsets, order, qpad, ms, ns, bands, M)


def poa_dp_cols_cuda(tpad: torch.Tensor, ms: torch.Tensor, qpad: torch.Tensor,
                     ns: torch.Tensor, bands: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """K2 then K3 on one batch (`ops.poa_dp.dp_cols` on CUDA tensors): one
    plan and one host read for both, K3 walking K2's work list.  Returns
    (cols [B, M] int8, ins [B, M+1] int32) as `poa_traceback_cuda`."""
    _require_cuda("poa_dp_cols_cuda", tpad)
    B, M, N = _pair_args(tpad, ms, qpad, ns, bands)
    dev = tpad.device
    if B == 0:
        return (torch.empty((0, M), dtype=torch.int8, device=dev),
                torch.empty((0, M + 1), dtype=torch.int32, device=dev))
    plan = poa_dp_plan(M, N, ms, ns, bands)
    ptr = _dp_ptr_launch(tpad, ms, qpad, ns, bands, plan)
    return _traceback_launch(ptr, plan[0], plan[1], qpad, ms, ns, bands, M)


def poa_vote_cuda(cols: torch.Tensor, ins: torch.Tensor, qpad: torch.Tensor,
                  meta: torch.Tensor, targets: torch.Tensor, total: int
                  ) -> torch.Tensor:
    """Kernel K5 (csrc/poa.cu): one round's vote of every cluster, after
    K3 on the same stream, `ops.poa_dp.vote` on CUDA tensors.  Arguments
    and result as `ops.poa_dp.vote_reference`, whose output it equals up
    to each cluster's length (the bytes past it are left as they are)."""
    _require_cuda("poa_vote_cuda", cols)
    if cols.dim() != 2 or meta.dim() != 2:
        raise ValueError(f"cols must be [B, M] and meta [C, {POA_VOTE_META}]"
                         f", got {tuple(cols.shape)} and {tuple(meta.shape)}")
    (B, M), C, dev = cols.shape, meta.shape[0], cols.device
    N = qpad.shape[-1]
    _check("cols", cols, (B, M), dev, torch.int8)
    _check("ins", ins, (B, M + 1), dev)
    _check("qpad", qpad, (B, N), dev, torch.int8)
    _check("meta", meta, (C, POA_VOTE_META), dev, torch.int64)
    _check("targets", targets, tuple(targets.shape), dev, torch.int8)
    out = torch.empty(total, dtype=torch.uint8, device=dev)
    if C == 0:
        return out
    starts = torch.empty_like(ins)
    lib = load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.svtrek_poa_vote(cols.data_ptr(), ins.data_ptr(),
                                 qpad.data_ptr(), M, N, meta.data_ptr(),
                                 targets.data_ptr(), starts.data_ptr(), C,
                                 out.data_ptr(), stream)
    _launched("poa_vote", lib, rc)
    return out


def step_probe_cuda(ptr: torch.Tensor, rows_per: int, s0: int, s1: int,
                    out: torch.Tensor) -> torch.Tensor:
    """Kernel K4 (csrc/step_probe.cu): walk steps [s0, s1) of the step
    probe, each step reading rows_per rows of ptr [N, B, WP] int8, and add
    the per-b sums into out[:, 0] of out [B, 128] int32.  The launch with
    s0 == 0 initialises out (column 0 = its sum, columns 1-127 = 0); a
    launch with s0 > 0 adds to column 0.  Returns out."""
    _require_cuda("step_probe_cuda", ptr)
    if ptr.dim() != 3:
        raise ValueError(f"ptr must be [N, B, WP], got {tuple(ptr.shape)}")
    N, B, WP = ptr.shape
    _check("ptr", ptr, (N, B, WP), ptr.device, torch.int8)
    _check("out", out, (B, 128), ptr.device)
    if rows_per < 1 or N % rows_per:
        raise ValueError(f"rows_per {rows_per} must divide N = {N}")
    if not 0 <= s0 <= s1 <= N // rows_per:
        raise ValueError(f"step range [{s0}, {s1}) is outside "
                         f"[0, {N // rows_per}]")
    lib = load_library()
    with torch.cuda.device(ptr.device):
        stream = torch.cuda.current_stream(ptr.device).cuda_stream
        rc = lib.svtrek_step_probe(ptr.data_ptr(), B, WP, rows_per, s0, s1,
                                   out.data_ptr(), stream)
    _launched("step_probe", lib, rc)
    return out


def poa_graph_dp_cuda(base_td: torch.Tensor, pred_rows: torch.Tensor,
                      npred: torch.Tensor, is_sink: torch.Tensor,
                      Vs: torch.Tensor, qpad: torch.Tensor, ns: torch.Tensor,
                      *, P: int, Vmax: int, Nmax: int
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel G1 (csrc/poa_graph.cu): DP and traceback of every (graph,
    query) pair, `ops.poa_graph_dp.graph_dp` on CUDA tensors.  Arguments
    and results as `ops.poa_graph_dp.graph_dp_reference`, whose outputs it
    equals.

    The pairs' V and n, and `graph_bad_entries`, come to the host in one
    read; a pair with V outside [1, GRAPH_V_CAP], n outside [1,
    GRAPH_N_CAP], P above GRAPH_P_CAP or a bad entry raises (the pipeline
    sends the first three to the scalar route; PoaGraph makes no bad entry).
    Each launch takes pairs while their scratch stays within
    GRAPH_SCRATCH_BYTES (a pair alone past it takes a launch of its own),
    and sets its shared ring's rows and size from its largest n
    (`graph_ring_rows`)."""
    _require_cuda("poa_graph_dp_cuda", base_td)
    if base_td.dim() != 2:
        raise ValueError(f"base_td must be [B, Vmax], got "
                         f"{tuple(base_td.shape)}")
    if not 1 <= P <= GRAPH_P_CAP:
        raise ValueError(f"P = {P} is outside [1, {GRAPH_P_CAP}]")
    B = base_td.shape[0]
    dev = base_td.device
    _check("base_td", base_td, (B, Vmax), dev, torch.int8)
    _check("pred_rows", pred_rows, (B, Vmax, P), dev)
    _check("npred", npred, (B, Vmax), dev)
    _check("is_sink", is_sink, (B, Vmax), dev, torch.bool)
    _check("Vs", Vs, (B,), dev)
    _check("qpad", qpad, (B, Nmax), dev, torch.int8)
    _check("ns", ns, (B,), dev)
    score = torch.empty(B, dtype=torch.int32, device=dev)
    matched = torch.zeros((B, Vmax), dtype=torch.int8, device=dev)
    ins_after = torch.zeros((B, Vmax + 1), dtype=torch.int32, device=dev)
    if B == 0:
        return score, matched, ins_after
    host = torch.cat([Vs.long(), ns.long(), graph_bad_entries(
        pred_rows, npred, Vs).reshape(1)]).tolist()
    v_h, n_h, n_bad = host[:B], host[B:2 * B], host[-1]
    if min(v_h) < 1 or max(v_h) > min(Vmax, GRAPH_V_CAP) or min(n_h) < 1 \
            or max(n_h) > min(Nmax, GRAPH_N_CAP) or n_bad:
        raise ValueError(
            f"graph pairs out of range: V in [{min(v_h)}, {max(v_h)}] (1 to "
            f"{min(Vmax, GRAPH_V_CAP)}), n in [{min(n_h)}, {max(n_h)}] (1 to "
            f"{min(Nmax, GRAPH_N_CAP)}), {n_bad} predecessor entries not "
            f"of an earlier row or rows without a predecessor")
    lib = load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for b0, offsets in poa_graph_chunks(
                [(v + 1) * graph_row_cells(n) for v, n in zip(v_h, n_h)]):
            count = len(offsets) - 1
            total = offsets[-1]
            offsets = torch.tensor(offsets, dtype=torch.int64, device=dev)
            H = torch.empty(total, dtype=torch.int32, device=dev)
            codes = torch.empty(total, dtype=torch.uint8, device=dev)
            rc = lib.svtrek_poa_graph_dp(
                base_td.data_ptr(), pred_rows.data_ptr(), npred.data_ptr(),
                is_sink.data_ptr(), Vs.data_ptr(), qpad.data_ptr(),
                ns.data_ptr(), offsets.data_ptr(), b0, count, P, Vmax, Nmax,
                max(n_h[b0:b0 + count]), H.data_ptr(), codes.data_ptr(),
                score.data_ptr(), matched.data_ptr(), ins_after.data_ptr(),
                stream)
            _launched("poa_graph_dp", lib, rc)
    return score, matched, ins_after


def graph_bad_entries(pred_rows: torch.Tensor, npred: torch.Tensor,
                      Vs: torch.Tensor) -> torch.Tensor:
    """What G1 refuses in the live rows r < V of each pair, as a count (a
    0-dim int64 tensor on their device): predecessor entries outside [0, r]
    (a walk could loop) and rows with a predecessor count below 1 (their
    NEG row is past the range of G1's packed keys)."""
    Vmax = pred_rows.shape[1]
    row = torch.arange(Vmax, dtype=torch.int32, device=pred_rows.device)
    live = row[None, :] < Vs[:, None]
    bad = ((pred_rows < 0) | (pred_rows > row[None, :, None])) & \
        live[:, :, None]
    return bad.sum() + ((npred < 1) & live).sum()


def graph_row_cells(n: int) -> int:
    """The cells of one of G1's rows for a query of n bases: n+1 rounded up
    to GRAPH_ROW_ALIGN, so that a lane's strip and its 16-byte chunks never
    cross a row."""
    return (n + GRAPH_ROW_ALIGN) // GRAPH_ROW_ALIGN * GRAPH_ROW_ALIGN


def _graph_smem(ring: int, max_n: int, V: int) -> int:
    """G1's dynamic shared memory with a ring of ``ring`` rows: the ring
    (int32 rows of graph_row_cells(max_n)), the stage of a tile's codes
    (1,024 bytes), the shifted query (a byte a column) and a bit a row
    0 .. V of the global-H flags, in 32-bit words."""
    cells = graph_row_cells(max_n)
    return ring * cells * 4 + 1024 + cells + (V // 32 + 1) * 4


def graph_ring_rows(max_n: int) -> int:
    """The rows of H in G1's shared ring for a launch whose longest query
    is max_n bases: the largest of 8, 4 and 2 whose launch fits
    GRAPH_SMEM_BYTES with the flags of a GRAPH_V_CAP-node graph (8 up to
    6,751 bases, 4 up to 13,119, 2 up to GRAPH_N_CAP); 0 for max_n outside
    [1, GRAPH_N_CAP].  A predecessor within ring - 1 rows of its node is
    read from the ring (csrc/poa_graph.cu `ring_rows`, checked at load)."""
    if not 1 <= max_n <= GRAPH_N_CAP:
        return 0
    return next((r for r in (8, 4, 2) if _graph_smem(r, max_n, GRAPH_V_CAP)
                 <= GRAPH_SMEM_BYTES), 0)


def graph_smem_bytes(max_n: int, Vmax: int) -> int:
    """The dynamic shared memory of G1's launch whose longest query is
    max_n bases over graphs of at most Vmax nodes (its flags sized at
    min(Vmax, GRAPH_V_CAP)); 0 for max_n outside [1, GRAPH_N_CAP]."""
    ring = graph_ring_rows(max_n)
    return _graph_smem(ring, max_n, min(Vmax, GRAPH_V_CAP)) if ring else 0


def poa_graph_chunks(cells: list[int], budget: int = GRAPH_SCRATCH_BYTES
                     ) -> list[tuple[int, list[int]]]:
    """G1's launches over pairs of ``cells[b]`` = (V+1) * graph_row_cells(n)
    cells each: runs of consecutive pairs whose scratch (GRAPH_CELL_BYTES a
    cell: H int32 and a one-byte code) stays within ``budget`` (a pair alone
    may pass it), each as (its first pair, the offsets in cells of its
    pairs' H and codes, with the run's total last)."""
    out = []
    b0 = 0
    while b0 < len(cells):
        offsets = [0, cells[b0]]
        for c in cells[b0 + 1:]:
            if (offsets[-1] + c) * GRAPH_CELL_BYTES > budget:
                break
            offsets.append(offsets[-1] + c)
        out.append((b0, offsets))
        b0 += len(offsets) - 1
    return out


def bgzf_inflate(data: torch.Tensor, meta: torch.Tensor,
                 out: torch.Tensor | None = None,
                 status: torch.Tensor | None = None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Inflate n BGZF block payloads (raw deflate) at once.

    data uint8 [D] holds the payloads; meta int64 [n, 3] gives each one's
    offset in data, its bytes and its ISIZE.  Block i inflates into out[i],
    uint8 [n, BGZF_BLOCK_BYTES] (bytes past its length are left as they
    are), and status[i], int32 [n], is INFLATE_OK, INFLATE_BAD (an invalid
    stream, one that reads past its payload, or one longer than a block) or
    INFLATE_LENGTH (a valid stream whose length is not its ISIZE): what
    zlib's inflate makes of the block.  CUDA tensors launch the kernel
    (csrc/inflate.cu) on the current stream; CPU tensors take the plain
    version, zlib a block.  out and status are allocated where not given.
    Returns (out, status)."""
    if data.dim() != 1 or meta.dim() != 2 or meta.shape[1] != 3:
        raise ValueError(f"data must be [D] and meta [n, 3], got "
                         f"{tuple(data.shape)} and {tuple(meta.shape)}")
    n, dev = meta.shape[0], data.device
    _check("data", data, tuple(data.shape), dev, torch.uint8)
    _check("meta", meta, (n, 3), dev, torch.int64)
    if out is None:
        out = torch.empty((n, BGZF_BLOCK_BYTES), dtype=torch.uint8,
                          device=dev)
    if status is None:
        status = torch.empty(n, dtype=torch.int32, device=dev)
    _check("out", out, (n, BGZF_BLOCK_BYTES), dev, torch.uint8)
    _check("status", status, (n,), dev)
    if dev.type == "cpu":
        return bgzf_inflate_reference(data, meta, out, status)
    _require_cuda("bgzf_inflate", data)
    if n == 0:
        return out, status
    lib = load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.svtrek_bgzf_inflate(data.data_ptr(), meta.data_ptr(), n,
                                     out.data_ptr(), status.data_ptr(),
                                     stream)
    _launched("bgzf_inflate", lib, rc)
    return out, status


def bgzf_inflate_reference(data: torch.Tensor, meta: torch.Tensor,
                           out: torch.Tensor, status: torch.Tensor
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain version of `bgzf_inflate`, on CPU tensors: zlib a block
    (the C reader's inflate of a block, bgzf_inflate_block)."""
    buf, rows, st = data.numpy(), out.numpy(), status.numpy()
    for i, (off, csize, isize) in enumerate(meta.tolist()):
        d = zlib.decompressobj(-15)
        try:
            raw = d.decompress(buf[off:off + csize], BGZF_BLOCK_BYTES)
        except zlib.error:
            st[i] = INFLATE_BAD
            continue
        if not d.eof:  # truncated, or longer than a block
            st[i] = INFLATE_BAD
        elif len(raw) != isize:
            st[i] = INFLATE_LENGTH
        else:
            rows[i, :len(raw)] = memoryview(raw)
            st[i] = INFLATE_OK
    return out, status
