"""What the port does not run, refused before any work.

`Unsupported` is raised for an option or environment that the JAX package
runs and this port does not; its message says what is refused and why.
`raise_refused(cfg, *extra)` raises it, before any work, for a pipeline's
own refusals ``extra``.  Since mesh sharding (`--data-shards > 1`) and
multi-process runs (SVTREK_COORDINATOR) were ported (ROADMAP queue 1 item
9), audt and disc pass none and no option of audt, scan or disc is
refused; the disc pipeline raises `Unsupported` where the native GAF
reader does not load.
"""
from __future__ import annotations


class Unsupported(RuntimeError):
    """An option or environment this port does not run yet."""


def raise_refused(cfg, *extra: str) -> None:
    """Raise Unsupported, before any work on ``cfg``, naming the
    pipeline's ``extra`` refusals; return when there are none."""
    if extra:
        raise Unsupported("not supported by svtrek_tpu_torch yet: "
                          + "; ".join(extra))
