"""Build the native shared library: `python -m svtrek_tpu_torch.native.build`.

The library is compiled from `svtrek_native.c` into the gitignored
`svtrek_tpu_torch/_build/`, never next to the source, and rebuilt when the
source is newer.  Several processes may build it at the same moment (test
workers), so each compiles to a temporary file tagged with its pid and
moves it into place with `os.replace`: a loader never sees half a file.
"""
from __future__ import annotations

import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "svtrek_native.c")
BUILD_DIR = os.path.join(os.path.dirname(HERE), "_build")
OUT = os.path.join(BUILD_DIR, "libsvtrek_native.so")


class NativeBuildError(OSError):
    """The C compiler is missing or refused the source."""


def build(force: bool = False) -> str:
    """Compile the library if needed; returns the .so path.  Raises
    NativeBuildError when it cannot be built."""
    if not force and os.path.exists(OUT) and (
        os.path.getmtime(OUT) >= os.path.getmtime(SRC)
    ):
        return OUT
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{OUT}.{os.getpid()}.tmp"
    cmd = [
        "cc", "-O3", "-march=native", "-shared", "-fPIC", "-pthread",
        "-o", tmp, SRC, "-lz",
    ]
    # libdeflate decodes BGZF blocks ~2.7x faster than zlib; use it when
    # the dev package is present, else zlib, so the library builds anywhere.
    if os.path.exists("/usr/include/libdeflate.h"):
        cmd[cmd.index(SRC):cmd.index(SRC)] = ["-DSVTREK_HAVE_LIBDEFLATE"]
        cmd.append("-ldeflate")
    try:
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    except (OSError, subprocess.SubprocessError) as e:  # compiler missing
        raise NativeBuildError(f"native library build failed: {e}") from e
    if r.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise NativeBuildError(f"native library build failed:\n{r.stderr}")
    os.replace(tmp, OUT)
    return OUT


if __name__ == "__main__":
    try:
        print(f"built {build(force='--force' in sys.argv)}")
    except NativeBuildError as e:
        sys.exit(str(e))
