#!/usr/bin/env python
"""Time kernels K1 and K3 of this checkout beside an earlier design of them,
on the card, in one process and on the same inputs.

    python tools/torch_kernel_ab.py DIR

DIR holds the earlier design's `consensus.cu` and `poa.cu`, with the C
entry points of K1's one-thread-per-window kernel and K3's one-thread-per-
pair kernel: `svtrek_consensus_pos` (the same arguments as now) and
`svtrek_poa_traceback(ptr, offsets, qpad, N, ms, ns, bands, B, M, cols,
ins, stream)`, whose caller fills cols with -1 and ins with 0.  For
example, from a git checkout:

    mkdir -p DIR && git show REV:svtrek_tpu_torch/csrc/poa.cu > DIR/poa.cu
    (and the same for consensus.cu)

The two sources are built with nvcc into a library of their own in a
temporary directory.  Both designs run on chip_smoke.py's inputs: K1 at
every `KERNEL_SHAPES` row, K3 on the `bench` and `flush` pair batches (the
pointers from this checkout's K2).  For each it prints the kernel's time
alone (torch.profiler) and per call (CUDA events of what each design's
wrapper does: the new wrapper; for the earlier K1 the same checks and
its launch, for the earlier K3 the output fills, the range checks' host
read and its launch), whether the two designs' outputs
are equal, and for K3 the longest walk's steps and ns a step.  The two
designs are timed in turns (new, earlier, earlier, new), and each prints
both of its readings.  It ends with the card's name and power limit.  It
needs a CUDA card and nvcc.
"""
from __future__ import annotations

import ctypes as ct
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tools")]

import numpy as np  # noqa: E402

import chip_smoke as smoke  # noqa: E402
from torch_step_overhead import cuda_ms  # noqa: E402


def build_before(src_dir: str, out_dir: str):
    """The earlier design's library, loaded with its C interface."""
    from svtrek_tpu_torch.kernels import build as kbuild

    lib_path = os.path.join(out_dir, "libsvtrek_before.so")
    cmd = [kbuild.find_nvcc(), "-gencode", kbuild.ARCH, "-std=c++17", "-O3",
           "-Xcompiler", "-fPIC", "-shared", "-o", lib_path,
           os.path.join(src_dir, "consensus.cu"),
           os.path.join(src_dir, "poa.cu")]
    subprocess.run(cmd, check=True, capture_output=True, text=True,
                   timeout=600)
    lib = ct.CDLL(lib_path)
    p = ct.c_void_p
    lib.svtrek_consensus_pos.restype = ct.c_int
    lib.svtrek_consensus_pos.argtypes = [p, p, p] + [ct.c_int] * 6 + [p] * 3
    lib.svtrek_poa_traceback.restype = ct.c_int
    lib.svtrek_poa_traceback.argtypes = [p, p, p, ct.c_int, p, p, p,
                                         ct.c_int, ct.c_int, p, p, p]
    return lib


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


def k3(lib) -> None:
    import torch

    from svtrek_tpu_torch.kernels import (
        _check_pairs, poa_dp_ptr_cuda, poa_traceback_cuda,
    )

    rng = np.random.default_rng(2027)  # chip_smoke.phase_poa_kernels' pairs
    for name, ts, qs, band in smoke.poa_batches(rng):
        if name not in ("bench", "flush"):
            continue
        B = len(ts)
        ms = np.array([len(t) for t in ts], np.int32)
        ns = np.array([len(q) for q in qs], np.int32)
        bands = np.maximum(band, np.abs(ns - ms) + 1).astype(np.int32)
        tpad = np.full((B, int(ms.max())), 5, np.int8)
        qpad = np.full((B, int(ns.max())), 5, np.int8)
        for b in range(B):
            tpad[b, :ms[b]] = ts[b]
            qpad[b, :ns[b]] = qs[b]
        args = [torch.from_numpy(a).cuda()
                for a in (tpad, ms, qpad, ns, bands)]
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
        lib = build_before(sys.argv[1], tmp)
        k1(lib)
        k3(lib)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
