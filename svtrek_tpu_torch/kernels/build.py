"""Build the port's CUDA kernels: `python -m svtrek_tpu_torch.kernels.build`.

Every `csrc/*.cu` file is compiled by nvcc for Hopper (sm_90a), one nvcc
process per file, all in parallel, and linked into one shared library with
a plain C interface, `_build/libsvtrek_cuda.so`, which `kernels` loads
with ctypes.  The library is rebuilt when any source is
newer than it, like `svtrek_tpu_torch.native.build`.  Nothing is compiled at
import: the first kernel launch builds.
"""
from __future__ import annotations

import glob
import os
import shutil
import subprocess
import sys

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(PKG, "csrc")
BUILD_DIR = os.path.join(PKG, "_build")
LIB = os.path.join(BUILD_DIR, "libsvtrek_cuda.so")
ARCH = "arch=compute_90a,code=sm_90a"


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a source."""


def sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")) +
                  glob.glob(os.path.join(CSRC, "*.cuh")))


def find_nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or \
        "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise KernelBuildError(
            f"nvcc not found (looked in {cand} and on PATH); the CUDA "
            f"kernels build only where the CUDA toolkit is installed")
    return found


def build(force: bool = False, verbose: bool = False) -> str:
    """Compile the library if any source is newer; returns its path.

    Each `.cu` file is compiled by its own nvcc process, all started
    together, and the objects are linked into the library.  Raises
    KernelBuildError when nvcc is missing or fails.  With ``verbose`` the
    compilers' reports (ptxas registers, spills) are printed to stderr."""
    srcs = sources()
    if not force and os.path.exists(LIB) and all(
            os.path.getmtime(LIB) >= os.path.getmtime(s) for s in srcs):
        return LIB
    nvcc = find_nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    jobs = []
    for src in (s for s in srcs if s.endswith(".cu")):
        obj = os.path.join(BUILD_DIR, f"{os.path.basename(src)}.{tag}.o")
        cmd = [nvcc, "-gencode", ARCH, "-std=c++17", "-O3", "-Xcompiler",
               "-fPIC", "-Xptxas", "-v", "-c", "-o", obj, src]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    reports = []
    for cmd, _, proc in jobs:
        _, err = proc.communicate(timeout=600)
        if proc.returncode != 0:
            for _, _, other in jobs:
                other.kill()
            raise KernelBuildError(
                f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{err}")
        reports.append(err)
    tmp = f"{LIB}.{tag}"
    objs = [obj for _, obj, _ in jobs]
    cmd = [nvcc, "-shared", "-o", tmp, *objs]
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    for obj in objs:
        os.remove(obj)
    if r.returncode != 0:
        raise KernelBuildError(
            f"nvcc failed ({r.returncode}):\n{' '.join(cmd)}\n{r.stderr}")
    if verbose:
        print("".join(reports), end="", file=sys.stderr)
    os.replace(tmp, LIB)  # atomic: a concurrent loader never sees half a file
    return LIB


if __name__ == "__main__":
    print(build(force="--force" in sys.argv, verbose=True))
