#!/usr/bin/env python
"""Time kernels K1, K2, K3 and G1 of this checkout beside an earlier design
of them, on the card, in one process and on the same inputs.

    python tools/torch_kernel_ab.py DIR

DIR holds the earlier design's sources, any of:
- `consensus.cu` and `poa.cu`, with the C entry points of K1's
  one-thread-per-window kernel and K3's one-thread-per-pair kernel:
  `svtrek_consensus_pos` (the same arguments as now) and
  `svtrek_poa_traceback(ptr, offsets, qpad, N, ms, ns, bands, B, M, cols,
  ins, stream)`, whose caller fills cols with -1 and ins with 0 (at
  commit 13c3105); K3 is timed against such a `poa.cu` only;
- a `poa.cu` with K2's strip kernel and its chunked kernel for bands past
  527 (commits 13c3105 to 4823a6b): `svtrek_poa_dp_ptr_strip` (the same
  arguments as now) and `svtrek_poa_dp_ptr_chunked(tpad, M, ms, qpad, N,
  ns, bands, offsets, ptr, order, count, max_band, stream)`, launched one
  after the other on one stream over the work list of this checkout's
  plan;
- `poa_graph.cu`, an earlier design of G1, either
  - the block-per-pair design (at commit c6ff5e5): `svtrek_poa_graph_dp(
    base_td, pred_rows, npred, is_sink, Vs, qpad, ns, offsets, b0, count,
    P, Vmax, Nmax, H, codes, score, matched, ins_after, stream)` over
    (V+1)(n+1) cells a pair, H int32 and an int8 code a cell; or
  - the warp-per-pair design with uint16 row codes and a fixed 8-row
    ring (at commit bab3b47; told apart by its `svtrek_poa_graph_cap`):
    the same arguments with `max_n` after Nmax, over (V+1) x
    `kernels.graph_row_cells(n)` cells a pair, H int32 and a uint16 code
    a cell.
For example, from a git checkout (into a gitignored directory, since the
card's copy of the repo has no .git):

    mkdir -p scratch_checkout/before
    git show bab3b47:svtrek_tpu_torch/csrc/poa_graph.cu \
        > scratch_checkout/before/poa_graph.cu
    git show 4823a6b:svtrek_tpu_torch/csrc/poa.cu \
        > scratch_checkout/before/poa.cu
    python tools/torch_kernel_ab.py scratch_checkout/before

The sources found are built with nvcc into a library of their own in a
temporary directory.  Both designs run on chip_smoke.py's inputs: K1 at
every `KERNEL_SHAPES` row, K2 on the `bench`, `flush`, `wide2k` and
`wide_main` pair batches, K3 on `bench` and `flush` (the pointers from
this checkout's K2), G1 on phase 13's `ins_mix` (256 pairs) and, against
the warp design, on `long` (V 4,283 and 8,351, n 4,096).
For each it prints the kernel's time alone (torch.profiler) and per call
(CUDA events of what each design's wrapper does: the new wrapper; for the
earlier K1 the same checks and its launch, for the earlier K2 this
checkout's plan and its two launches, for the earlier K3 the output
fills, the range checks' host read and its launch, for the earlier G1 its
wrapper: the range checks' host read, the launch split of the warp design
at its 6 bytes a cell, the offsets' copy, the scratch, the output fills and
its launches), whether the two designs' outputs are
equal, for K2 on the batches with bands past 527 also its wide kernel's
and the chunked kernel's times alone and the cycles a row of their
longest pair (at chip_smoke.SM_GHZ), and for K3 the longest walk's steps
and ns a step.  The two designs
are timed in turns (new, earlier, earlier, new), and each prints both of
its readings.  It ends with the card's name and power limit.  It needs a
CUDA card and nvcc.
"""
from __future__ import annotations

import ctypes as ct
import os
import re
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tools")]

import numpy as np  # noqa: E402

import chip_smoke as smoke  # noqa: E402
from torch_step_overhead import cuda_ms  # noqa: E402


SOURCES = ("consensus.cu", "poa.cu", "poa_graph.cu")


def nvcc_library(srcs: list[str], out_dir: str, name: str):
    """The CUDA sources ``srcs`` built by nvcc for this card, as the
    kernels' build does, into ``out_dir``/lib``name``.so, loaded (no C
    interface bound yet)."""
    from svtrek_tpu_torch.kernels import build as kbuild

    lib_path = os.path.join(out_dir, f"lib{name}.so")
    cmd = [kbuild.find_nvcc(), "-gencode", kbuild.ARCH, "-std=c++17", "-O3",
           "-Xcompiler", "-fPIC", "-shared", "-o", lib_path, *srcs]
    subprocess.run(cmd, check=True, capture_output=True, text=True,
                   timeout=600)
    return ct.CDLL(lib_path)


def build_before(src_dir: str, out_dir: str):
    """The earlier design's library from the SOURCES found in src_dir,
    loaded with its C interface; and the names of those sources."""
    found = [f for f in SOURCES if os.path.exists(os.path.join(src_dir, f))]
    if not found:
        raise SystemExit(f"{src_dir} holds none of {SOURCES}")
    lib = nvcc_library([os.path.join(src_dir, f) for f in found], out_dir,
                       "svtrek_before")
    if "poa.cu" in found:
        # K3's one-thread-per-pair design takes no pointer-buffer size.
        with open(os.path.join(src_dir, "poa.cu")) as fh:
            if re.search(r"svtrek_poa_traceback\(const void\* ptr,\s*"
                         r"const void\* offsets", fh.read()):
                found.append("k3")
    p = ct.c_void_p
    if "consensus.cu" in found:
        lib.svtrek_consensus_pos.restype = ct.c_int
        lib.svtrek_consensus_pos.argtypes = [p, p, p] + [ct.c_int] * 6 + \
            [p] * 3
    if "poa.cu" in found:
        if hasattr(lib, "svtrek_poa_dp_ptr_chunked"):
            lib.svtrek_poa_dp_ptr_strip.restype = ct.c_int
            lib.svtrek_poa_dp_ptr_strip.argtypes = [
                p, ct.c_int, p, p, ct.c_int, p, p, p, p, p, p, ct.c_int, p]
            lib.svtrek_poa_dp_ptr_chunked.restype = ct.c_int
            lib.svtrek_poa_dp_ptr_chunked.argtypes = [
                p, ct.c_int, p, p, ct.c_int, p, p, p, p, p, ct.c_int,
                ct.c_int, p]
    if "k3" in found:
        lib.svtrek_poa_traceback.restype = ct.c_int
        lib.svtrek_poa_traceback.argtypes = [p, p, p, ct.c_int, p, p, p,
                                             ct.c_int, ct.c_int, p, p, p]
    if "poa_graph.cu" in found:
        # The warp design's entry point takes max_n after Nmax.
        warp = hasattr(lib, "svtrek_poa_graph_cap")
        lib.svtrek_poa_graph_dp.restype = ct.c_int
        lib.svtrek_poa_graph_dp.argtypes = [p] * 8 + \
            [ct.c_int] * (6 if warp else 5) + [p] * 6
    return lib, found


def check(rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"the earlier design's launch failed ({rc})")


def in_turns(new, before, kernel: str, reps_alone: int, reps_call: int):
    """Each design's (alone, call) readings, timed new, before, before,
    new: {"new": [(alone, call), (alone, call)], "before": [...]}."""
    out = {"new": [], "before": []}
    for name in ("new", "before", "before", "new"):
        fn = new if name == "new" else before
        out[name].append((smoke.device_ms(fn, kernel, reps_alone),
                          cuda_ms(fn, reps_call)))
    return out


def readings(t, name: str, steps: int | None = None) -> str:
    """One design's two readings: alone (and ns a step), then call."""
    alone = " / ".join(smoke.fmt_ms(a) for a, _ in t[name])
    if steps is not None:
        alone += " (" + " / ".join(
            "not measured" if a is None else f"{a * 1e6 / steps:.1f} ns"
            for a, _ in t[name]) + " a step)"
    call = " / ".join(f"{c:.4f} ms" for _, c in t[name])
    return f"{name} alone {alone}, call {call}"


def k1(lib) -> None:
    import torch

    from svtrek_tpu_torch.kernels import _check, consensus_pos_cuda

    rng = np.random.default_rng(2026)  # chip_smoke.phase_kernel's rows
    for B, K, sw in smoke.KERNEL_SHAPES:
        locs, n, pos = (torch.from_numpy(a).cuda()
                        for a in smoke.kernel_rows(rng, B, K))
        kw = dict(min_count=3, interval=5, range_=500, sweep_width=sw)

        def new():
            return consensus_pos_cuda(locs, n, pos, **kw)

        def before():  # the earlier wrapper: the same checks, the launch
            for t, shape in ((locs, (B, K)), (n, (B,)), (pos, (B,))):
                _check("K1 input", t, shape, locs.device)
            refined = torch.empty(B, dtype=torch.int32, device="cuda")
            overflow = torch.empty(B, dtype=torch.bool, device="cuda")
            check(lib.svtrek_consensus_pos(
                locs.data_ptr(), n.data_ptr(), pos.data_ptr(), B, K,
                min(sw, K), 3, 5, 500, refined.data_ptr(),
                overflow.data_ptr(), torch.cuda.current_stream().cuda_stream))
            return refined, overflow

        a, b = new(), before()
        torch.cuda.synchronize()
        equal = all(torch.equal(x, y) for x, y in zip(a, b))
        t = in_turns(new, before, "consensus_pos_kernel", 20, 50)
        print(f"[ab] K1 B={B} K={K} sweep_width={sw}: {readings(t, 'new')}; "
              f"{readings(t, 'before')}; equal={equal}", flush=True)


def pair_batch(ts, qs, band):
    """chip_smoke.phase_poa_kernels' arrays of a pair batch, on the card:
    (tpad, ms, qpad, ns, bands) as numpy, then as CUDA tensors."""
    import torch

    B = len(ts)
    ms = np.array([len(t) for t in ts], np.int32)
    ns = np.array([len(q) for q in qs], np.int32)
    bands = np.maximum(band, np.abs(ns - ms) + 1).astype(np.int32)
    tpad = np.full((B, max(int(ms.max()), 1)), 5, np.int8)
    qpad = np.full((B, max(int(ns.max()), 1)), 5, np.int8)
    for b in range(B):
        tpad[b, :ms[b]] = ts[b]
        qpad[b, :ns[b]] = qs[b]
    host = (tpad, ms, qpad, ns, bands)
    return host, [torch.from_numpy(a).cuda() for a in host]


def k2(lib) -> None:
    import torch

    from svtrek_tpu_torch.kernels import (
        POA_STRIP_MAX_BAND, poa_dp_plan, poa_dp_ptr_cuda,
    )

    rng = np.random.default_rng(2027)  # chip_smoke.phase_poa_kernels' pairs
    for name, ts, qs, band in smoke.poa_batches(rng):
        if name not in ("bench", "flush", "wide2k", "wide_main"):
            continue
        (tpad, ms, qpad, ns, bands), args = pair_batch(ts, qs, band)
        B, M, N = len(ms), tpad.shape[1], qpad.shape[1]
        max_band = int(bands.max())

        def new():
            return poa_dp_ptr_cuda(*args)[0]

        def before():  # 4823a6b's wrapper: the plan, strip then chunked
            offsets, order, strips, total, n_strip = poa_dp_plan(
                M, N, args[1], args[3], args[4])
            ptr = torch.empty(total, dtype=torch.int8, device="cuda")
            stream = torch.cuda.current_stream().cuda_stream
            common = (args[0].data_ptr(), M, args[1].data_ptr(),
                      args[2].data_ptr(), N, args[3].data_ptr(),
                      args[4].data_ptr(), offsets.data_ptr(), ptr.data_ptr())
            if n_strip:
                check(lib.svtrek_poa_dp_ptr_strip(
                    *common, order.data_ptr(), strips.data_ptr(), n_strip,
                    stream))
            if n_strip < B:
                check(lib.svtrek_poa_dp_ptr_chunked(
                    *common, order[n_strip:].data_ptr(), B - n_strip,
                    max_band, stream))
            return ptr

        a, b = new(), before()
        torch.cuda.synchronize()
        equal = torch.equal(a, b)
        slow = name == "wide_main"  # the chunked kernel takes 100+ ms
        t = in_turns(new, before, "poa_dp_ptr", 2 if slow else 10,
                     3 if slow else 20)
        line = (f"[ab] K2 {name}: B={B}, bands {int(bands.min())}-"
                f"{max_band}; {readings(t, 'new')}; {readings(t, 'before')}; "
                f"equal={equal}")
        wide = bands > POA_STRIP_MAX_BAND
        if wide.any():
            far = int(np.argmax(np.where(wide, ns.astype(np.int64) * (
                2 * bands.astype(np.int64) + 1), -1)))
            parts = []
            for tag, fn, kernel in (
                    ("wide kernel", new, "poa_dp_ptr_wide"),
                    ("chunked kernel", before, "poa_dp_ptr_chunked"),
                    ("chunked kernel", before, "poa_dp_ptr_chunked"),
                    ("wide kernel", new, "poa_dp_ptr_wide")):
                ms_alone = smoke.device_ms(fn, kernel, 2 if slow else 5)
                parts.append(f"{tag} alone {smoke.fmt_ms(ms_alone)}" + (
                    "" if ms_alone is None else
                    f" ({ms_alone * smoke.SM_GHZ * 1e6 / ns[far]:.1f} "
                    f"cycles a row)"))
            line += (f"; on its {int(wide.sum())} pairs past band "
                     f"{POA_STRIP_MAX_BAND}, the longest (m, n, band) "
                     f"({int(ms[far])}, {int(ns[far])}, {int(bands[far])}): "
                     + ", ".join(parts))
        print(line, flush=True)


def k3(lib) -> None:
    import torch

    from svtrek_tpu_torch.kernels import (
        _check_pairs, poa_dp_ptr_cuda, poa_traceback_cuda,
    )

    rng = np.random.default_rng(2027)  # chip_smoke.phase_poa_kernels' pairs
    for name, ts, qs, band in smoke.poa_batches(rng):
        if name not in ("bench", "flush"):
            continue
        (tpad, ms, qpad, ns, bands), args = pair_batch(ts, qs, band)
        B = len(ms)
        _, m_d, q_d, n_d, b_d = args
        M, N = tpad.shape[1], qpad.shape[1]
        ptr, offsets = poa_dp_ptr_cuda(*args)

        def new():
            return poa_traceback_cuda(ptr, offsets, q_d, m_d, n_d, b_d, M=M)

        def before():
            cols = torch.full((B, M), -1, dtype=torch.int8, device="cuda")
            ins = torch.zeros((B, M + 1), dtype=torch.int32, device="cuda")
            _check_pairs(M, N, m_d, n_d, b_d, offsets[-1])
            check(lib.svtrek_poa_traceback(
                ptr.data_ptr(), offsets.data_ptr(), q_d.data_ptr(), N,
                m_d.data_ptr(), n_d.data_ptr(), b_d.data_ptr(), B, M,
                cols.data_ptr(), ins.data_ptr(),
                torch.cuda.current_stream().cuda_stream))
            return cols, ins

        a, b = new(), before()
        torch.cuda.synchronize()
        equal = all(torch.equal(x, y) for x, y in zip(a, b))
        steps = int((ns.astype(np.int64) + ms
                     - (a[0] >= 0).sum(1).cpu().numpy()).max())
        t = in_turns(new, before, "poa_traceback", 10, 20)
        print(f"[ab] K3 {name}: B={B}, longest walk {steps} steps; "
              f"{readings(t, 'new', steps)}; {readings(t, 'before', steps)}; "
              f"equal={equal}", flush=True)


def g1(lib) -> None:
    # The warp design (bab3b47) takes `long` too; the block design ins_mix.
    warp = hasattr(lib, "svtrek_poa_graph_cap")
    names = ("ins_mix", "long") if warp else ("ins_mix",)
    rng = np.random.default_rng(2029)  # chip_smoke.phase_graph_kernel's
    for name, graphs, queries in smoke.graph_batches(rng):
        if name in names:
            g1_batch(lib, warp, name, graphs, queries)
        if name == names[-1]:
            break


def g1_batch(lib, warp: bool, name: str, graphs, queries) -> None:
    import torch

    from svtrek_tpu_torch import kernels
    from svtrek_tpu_torch.ops.poa_graph_batch import pack_pairs

    _, arrays, shape = pack_pairs(graphs, queries)
    args = [torch.from_numpy(a).cuda() for a in arrays]
    base_td, pred_rows, npred, is_sink, Vs, qpad, ns = args
    P, Vmax, Nmax = shape["P"], shape["Vmax"], shape["Nmax"]
    B = len(arrays[4])

    def new():
        return kernels.poa_graph_dp_cuda(*args, **shape)

    def before():  # its wrapper at c6ff5e5 (one launch) or bab3b47
        dev = base_td.device
        score = torch.empty(B, dtype=torch.int32, device=dev)
        matched = torch.zeros((B, Vmax), dtype=torch.int8, device=dev)
        ins_after = torch.zeros((B, Vmax + 1), dtype=torch.int32, device=dev)
        host = torch.cat([Vs.long(), ns.long(), kernels.graph_bad_entries(
            pred_rows, npred, Vs).reshape(1)]).tolist()
        v_h, n_h = host[:B], host[B:2 * B]
        stream = torch.cuda.current_stream().cuda_stream
        if not warp:
            cells = [(v + 1) * (n + 1) for v, n in zip(v_h, n_h)]
            runs = [(0, np.concatenate([[0], np.cumsum(cells)]).tolist())]
        else:  # 6 bytes a cell: the same launch split
            runs = kernels.poa_graph_chunks(
                [(v + 1) * kernels.graph_row_cells(n)
                 for v, n in zip(v_h, n_h)],
                kernels.GRAPH_SCRATCH_BYTES * kernels.GRAPH_CELL_BYTES // 6)
        for b0, offsets in runs:
            count = len(offsets) - 1
            total = offsets[-1]
            offsets = torch.tensor(offsets, dtype=torch.int64, device=dev)
            H = torch.empty(total, dtype=torch.int32, device=dev)
            codes = torch.empty(total, dtype=torch.int16 if warp
                                else torch.int8, device=dev)
            sizes = (P, Vmax, Nmax, max(n_h[b0:b0 + count])) if warp \
                else (P, Vmax, Nmax)
            check(lib.svtrek_poa_graph_dp(
                base_td.data_ptr(), pred_rows.data_ptr(), npred.data_ptr(),
                is_sink.data_ptr(), Vs.data_ptr(), qpad.data_ptr(),
                ns.data_ptr(), offsets.data_ptr(), b0, count, *sizes,
                H.data_ptr(), codes.data_ptr(), score.data_ptr(),
                matched.data_ptr(), ins_after.data_ptr(), stream))
        return score, matched, ins_after

    a, b = new(), before()
    torch.cuda.synchronize()
    equal = all(torch.equal(x, y) for x, y in zip(a, b))
    t = in_turns(new, before, "poa_graph_dp", 3, 5)
    print(f"[ab] G1 {name} ({'bab3b47 warp' if warp else 'c6ff5e5 block'} "
          f"design before): B={B}, V {int(arrays[4].max())} and n "
          f"{int(arrays[6].max())} at most; {readings(t, 'new')}; "
          f"{readings(t, 'before')}; equal={equal}", flush=True)


def main() -> int:
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is false; this tool needs a card",
              file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    with tempfile.TemporaryDirectory() as tmp:
        lib, found = build_before(sys.argv[1], tmp)
        if "consensus.cu" in found:
            k1(lib)
        if "poa.cu" in found and hasattr(lib, "svtrek_poa_dp_ptr_chunked"):
            k2(lib)
        if "k3" in found:
            k3(lib)
        if "poa_graph.cu" in found:
            g1(lib)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
