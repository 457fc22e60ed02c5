"""What the port does not run yet, refused before any work.

`Unsupported` is raised for an option or environment that the JAX package
runs and this port does not; each message names the ROADMAP item that ports
it.  `raise_refused` holds the refusals of the audt and disc pipelines:
mesh sharding (`--data-shards > 1`) and multi-host runs
(`SVTREK_COORDINATOR`), both ROADMAP queue 1 item 9.  The scan pipeline
refuses nothing.
"""
from __future__ import annotations

import os


class Unsupported(RuntimeError):
    """An option or environment this port does not run yet."""


def raise_refused(cfg, *extra: str) -> None:
    """Raise Unsupported, before any work, for what the audt and disc
    pipelines both refuse (mesh sharding, multi-host runs) and for the
    pipeline's own ``extra`` refusals."""
    refused = []
    if cfg.data_shards > 1:
        refused.append("--data-shards > 1 (mesh sharding runs on one GPU "
                       "here; ROADMAP queue 1 item 9)")
    if os.environ.get("SVTREK_COORDINATOR"):
        refused.append("SVTREK_COORDINATOR (multi-host runs; ROADMAP "
                       "queue 1 item 9)")
    refused += extra
    if refused:
        raise Unsupported("not supported by svtrek_tpu_torch yet: "
                          + "; ".join(refused))
