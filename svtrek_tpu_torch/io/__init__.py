"""Host-side I/O: BGZF/BAM/BAI, VCF, GFA/GAF/FASTQ parsers and writers.

The reference delegates all alignment I/O to htslib (SURVEY.md §2.13);
this package is a from-scratch replacement: a pure-Python implementation
(always available, used for fixtures and as fallback) plus a C native
fast path (svtrek_tpu_torch/native) for the hot BAM region-fetch + CIGAR
extraction used by the audit pipeline.
"""
from .bam import BamReader, BamWriter, BamRecord
from .bgzf import BgzfReader, BgzfWriter
from .bai import reg2bin, reg2bins, BaiIndex

__all__ = [
    "BamReader",
    "BamWriter",
    "BamRecord",
    "BgzfReader",
    "BgzfWriter",
    "reg2bin",
    "reg2bins",
    "BaiIndex",
]
