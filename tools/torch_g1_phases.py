#!/usr/bin/env python
"""Where kernel G1's time goes, on the card: cycle counts inside the kernel.

    python tools/torch_g1_phases.py [PAIRS]

Builds two instrumented copies of this checkout's csrc/poa_graph.cu with
nvcc (clock64() stamps added by text edits; the kernel's arithmetic is
untouched) and runs each on chip_smoke.py's `ins_mix` batch (phase 13's
seed):
- `rows`: per row of a pair, the cycles of the predecessor-slot loop, the
  strip maxima and warp scan, the insertions into the ring and stage, and
  the stores to global memory (lane 0's clock, summed over the rows, over
  the pair's V);
- `walk`: the cycles of the DP rows and of the walk, the walk's rounds and
  moves.
The instrumented copies write their counters into the outputs, so their
results are not the DP's.  It prints the PAIRS (default 3) pairs with the
most DP cycles, with their V, n and mean filled predecessor slots a row,
then the card's name and power limit.  It needs a CUDA card and nvcc.
"""
from __future__ import annotations

import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tools")]

import numpy as np  # noqa: E402

import chip_smoke as smoke  # noqa: E402
from torch_kernel_ab import nvcc_library  # noqa: E402

KEY = ("      int key[kStrip];  // set by slot 0 (the wrapper refuses "
       "np == 0)\n")
# (anchor, replacement) edits: clock64() stamps between the row phases,
# and lane 0 writing the sums into ins_after[b][Vmax - k] before returning.
ROWS = [
    ("  int nxt_pr = lane < P ? prs_b[lane] : 0;",
     "  long long a_slot = 0, a_scan = 0, a_ins = 0, a_st = 0, tA = 0;\n"
     "  int nxt_pr = lane < P ? prs_b[lane] : 0;"),
    (KEY, KEY + "      tA = clock64();\n"),
    ("      // The lane's strip maximum of best[j] - GAP*j, the warp's scan.",
     "      { long long tB = clock64(); a_slot += tB - tA; tA = tB; }\n"
     "      // The lane's strip maximum of best[j] - GAP*j, the warp's scan."),
    ("      carry = max(carry, __shfl_sync(kFull, incl, 31));",
     "      carry = max(carry, __shfl_sync(kFull, incl, 31));\n"
     "      { long long tB = clock64(); a_scan += tB - tA; tA = tB; }"),
    ("      // The tile out to global memory, 16 bytes a lane, lanes on",
     "      { long long tB = clock64(); a_ins += tB - tA; tA = tB; }\n"
     "      // The tile out to global memory, 16 bytes a lane, lanes on"),
    ("      // The stage is reused by the next tile; the next row reads this",
     "      { long long tB = clock64(); a_st += tB - tA; tA = tB; }\n"
     "      // The stage is reused by the next tile; the next row reads this"),
    ("  // The end row: the first maximum",
     "  if (lane == 0) {\n"
     "    int* ir = ins_after + static_cast<long long>(b) * (Vmax + 1);\n"
     "    ir[Vmax] = static_cast<int>(a_slot);\n"
     "    ir[Vmax - 1] = static_cast<int>(a_scan);\n"
     "    ir[Vmax - 2] = static_cast<int>(a_ins);\n"
     "    ir[Vmax - 3] = static_cast<int>(a_st);\n"
     "  }\n"
     "  return;\n"
     "  // The end row: the first maximum"),
]
WALK = [
    ("  int nxt_pr = lane < P ? prs_b[lane] : 0;",
     "  const long long t_start = clock64();\n"
     "  int nxt_pr = lane < P ? prs_b[lane] : 0;"),
    ("  // The end row: the first maximum",
     "  const long long t_dp = clock64();\n"
     "  // The end row: the first maximum"),
    ("  int steps = 0;\n", "  int steps = 0;\n  int rounds = 0;\n"),
    ("    const int nap = min(L, limit - steps);",
     "    const int nap = min(L, limit - steps);\n    ++rounds;"),
    ("    j0 = __shfl_sync(kFull, nj, nap);\n  }\n",
     "    j0 = __shfl_sync(kFull, nj, nap);\n  }\n"
     "  const long long t_end = clock64();\n"
     "  if (lane == 0) {\n"
     "    irow[Vmax] = static_cast<int>(t_dp - t_start);\n"
     "    irow[Vmax - 1] = static_cast<int>(t_end - t_dp);\n"
     "    irow[Vmax - 2] = rounds;\n"
     "    irow[Vmax - 3] = steps;\n"
     "  }\n"),
]


def build(name: str, edits, out_dir: str):
    """An instrumented copy of csrc/poa_graph.cu, built and loaded with
    G1's C interface (`kernels.bind_graph`).  An anchor that is not in the
    source exactly once stops the tool: an edit of the kernel's text may
    need the anchors above to follow it."""
    from svtrek_tpu_torch.kernels import bind_graph

    src = open(os.path.join(ROOT, "svtrek_tpu_torch", "csrc",
                            "poa_graph.cu")).read()
    for anchor, new in edits:
        if src.count(anchor) != 1:
            raise SystemExit(f"{name}: the anchor {anchor!r} is not in "
                             f"csrc/poa_graph.cu once")
        src = src.replace(anchor, new)
    cu = os.path.join(out_dir, f"{name}.cu")
    with open(cu, "w") as fh:
        fh.write(src)
    lib = nvcc_library([cu], out_dir, name)
    bind_graph(lib)
    return lib


def main() -> int:
    import torch

    from svtrek_tpu_torch import kernels
    from svtrek_tpu_torch.ops.poa_graph_batch import pack_pairs

    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is false; this tool needs a card",
              file=sys.stderr)
        return 1
    top = int(sys.argv[1]) if len(sys.argv) > 1 else 3
    rng = np.random.default_rng(2029)  # chip_smoke.phase_graph_kernel's
    _, graphs, queries = next(iter(smoke.graph_batches(rng)))
    _, arrays, shape = pack_pairs(graphs, queries)
    args = [torch.from_numpy(a).cuda() for a in arrays]
    Vs, ns, npred, Vm, P = arrays[4], arrays[6], arrays[2], shape["Vmax"], \
        shape["P"]
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, edits in (("rows", ROWS), ("walk", WALK)):
            lib = build(name, edits, tmp)
            kernels._LIB, saved = lib, kernels._LIB
            try:
                ins_after = kernels.poa_graph_dp_cuda(*args, **shape)[2]
                torch.cuda.synchronize()
            finally:
                kernels._LIB = saved
            out[name] = ins_after.cpu().numpy()[:, Vm - 3:Vm + 1][:, ::-1]
    rows, walk = out["rows"].astype(np.int64), out["walk"].astype(np.int64)
    for b in np.argsort(-walk[:, 0])[:top]:
        V = int(Vs[b])
        slots = float(np.minimum(npred[b, :V], P).mean())
        slot, scan, ins, st = (rows[b] / V).tolist()
        print(f"[g1] pair {b}: V={V} n={int(ns[b])}, {slots:.3f} filled "
              f"slots a row; cycles a row: slots {slot:.0f}, scan "
              f"{scan:.0f}, insertions {ins:.0f}, stores {st:.0f} (sum "
              f"{slot + scan + ins + st:.0f}); DP {walk[b, 0]} cycles, "
              f"walk {walk[b, 1]} cycles in {walk[b, 2]} rounds of "
              f"{walk[b, 3]} moves ({walk[b, 1] / max(walk[b, 2], 1):.0f} "
              f"a round)", flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
