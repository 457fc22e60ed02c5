"""Build the port's CUDA kernels: `python -m svtrek_tpu_torch.kernels.build`.

Every `csrc/*.cu` file is compiled by nvcc for Hopper (sm_90a) into one
shared library with a plain C interface, `_build/libsvtrek_cuda.so`, which
`kernels` loads with ctypes.  The library is rebuilt when any source is
newer than it, like `svtrek_tpu.native.build`.  Nothing is compiled at
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

    Raises KernelBuildError when nvcc is missing or fails.  With
    ``verbose`` the compiler's report (ptxas registers, spills) is
    printed to stderr."""
    srcs = sources()
    if not force and os.path.exists(LIB) and all(
            os.path.getmtime(LIB) >= os.path.getmtime(s) for s in srcs):
        return LIB
    nvcc = find_nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{LIB}.{os.getpid()}.tmp"
    cmd = [nvcc, "-gencode", ARCH, "-std=c++17", "-O3", "-shared",
           "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", tmp,
           *[s for s in srcs if s.endswith(".cu")]]
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if r.returncode != 0:
        raise KernelBuildError(
            f"nvcc failed ({r.returncode}):\n{' '.join(cmd)}\n{r.stderr}")
    if verbose:
        print(r.stderr, end="", file=sys.stderr)
    os.replace(tmp, LIB)  # atomic: a concurrent loader never sees half a file
    return LIB


if __name__ == "__main__":
    print(build(force="--force" in sys.argv, verbose=True))
