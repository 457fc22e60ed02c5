"""Native (C) fast paths: BGZF/BAM/BAI region fetch, the CIGAR evidence
walk and the GAF projector, loaded via ctypes.

The library builds at first use into `svtrek_tpu_torch/_build/` (`python
-m svtrek_tpu_torch.native.build`).  The port has no pure-Python fetch
path, so a library that does not build or load is an error, not a switch.
"""
from __future__ import annotations


def native_bam_reader(path: str):
    """Return a native-backed BAM reader.  Raises OSError when the library
    does not build or load, or the BAM or its index cannot be opened."""
    from .bamlib import NativeBamReader

    return NativeBamReader(path)
