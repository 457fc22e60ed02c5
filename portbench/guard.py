"""The import guard: the benchmark never loads JAX or the JAX package.

`install` puts a finder first on ``sys.meta_path`` that refuses any module
whose top-level name (the part before the first dot) is one of REFUSED,
compared whole: ``svtrek_tpu_torch`` passes and ``svtrek_tpu`` does not.
`loaded` lists such modules already in ``sys.modules``, which the harness
checks again once the window has closed.  This module imports nothing but
the standard library, so it can be the first thing a run loads.
"""
from __future__ import annotations

import importlib.abc
import sys

REFUSED = ("jax", "jaxlib", "flax", "svtrek_tpu")


def refused(name: str) -> bool:
    return name.partition(".")[0] in REFUSED


class RefusedImport(ImportError):
    pass


class _Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, fullname, path=None, target=None):
        if refused(fullname):
            raise RefusedImport(
                f"portbench refuses to import {fullname!r}: the benchmark "
                f"measures the PyTorch port alone and loads none of "
                f"{', '.join(REFUSED)}")
        return None


def loaded() -> list[str]:
    return sorted(m for m in list(sys.modules) if refused(m))


def install() -> None:
    """Refuse the modules of REFUSED from now on; raise if one is
    already loaded."""
    if not any(isinstance(f, _Refuse) for f in sys.meta_path):
        sys.meta_path.insert(0, _Refuse())
    if loaded():
        raise RefusedImport(f"already loaded before the guard: {loaded()}")
