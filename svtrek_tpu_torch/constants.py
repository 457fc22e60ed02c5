"""Shared constants: CIGAR op codes, SV types, default parameters.

Mirrors the reference's parameter surface (reference: params.h:10-41) so that
configuration names/defaults are identical, while the implementation is
TPU-native (JAX/XLA) rather than a C port.
"""
from __future__ import annotations

import enum

# CIGAR operation codes (BAM encoding order: MIDNSHP=X).
# Reference: params.h:10-18.
CIGAR_M = 0  # alignment match        (consumes query + ref)
CIGAR_I = 1  # insertion              (consumes query)
CIGAR_D = 2  # deletion               (consumes ref)
CIGAR_N = 3  # skipped region         (consumes ref)
CIGAR_S = 4  # soft clip              (consumes query)
CIGAR_H = 5  # hard clip
CIGAR_P = 6  # padding
CIGAR_EQ = 7  # sequence match        (consumes query + ref)
CIGAR_X = 8  # sequence mismatch      (consumes query + ref)

CIGAR_OPS = "MIDNSHP=X"
CIGAR_CODE = {c: i for i, c in enumerate(CIGAR_OPS)}

# Query/reference consumption predicates (reference: params.h:20-21).
CONSUMES_QUERY = frozenset({CIGAR_M, CIGAR_I, CIGAR_S, CIGAR_EQ, CIGAR_X})
CONSUMES_REF = frozenset({CIGAR_M, CIGAR_D, CIGAR_N, CIGAR_EQ, CIGAR_X})

# NOTE (quirk mirrored): the reference advances reference_pos for every op
# that is not I and not S (refinement.c:137-139) — which *includes* H and P,
# even though H/P consume neither query nor reference.  The evidence kernels
# reproduce this exactly; see ops/cigar.py.
ADVANCES_REFPOS = frozenset(
    {CIGAR_M, CIGAR_D, CIGAR_N, CIGAR_H, CIGAR_P, CIGAR_EQ, CIGAR_X}
)

# SAM flags (reference: params.h:23-25).
FLAG_MULTIPLE_SEGMENTS = 0x1
FLAG_UNMAPPED = 0x4
FLAG_REVERSE = 0x10
FLAG_SECONDARY_ALIGNMENT = 0x100
FLAG_SUPPLEMENTARY_ALIGNMENT = 0x800

# Default parameters (reference: params.h:27-41).
WIDER_INTERVAL = 20000
MEDIAN_INTERVAL = 10000
NARROW_INTERVAL = 2000
CONSENSUS_INTERVAL_RANGE = 500
CONSENSUS_INTERVAL = 5
CONSENSUS_MIN_COUNT = 3
SV_MIN_LENGTH = 50

THREAD_NUMBER = 4
THREAD_POOL_LOAD_FACTOR = 2

MAX_LINE = 1048576
MAX_CIGAR = 131072
MAX_SEQ = 1048576

U32 = 1 << 32
I32_MAX = (1 << 31) - 1


class SVType(enum.IntEnum):
    """SV type enum (reference: params.h:113-121)."""

    UNKNOWN = 0
    INS = 1
    DEL = 2
    INV = 3
    DUP = 4
    TRA = 5
    BND = 6


# Task kinds for the fused refinement kernel.  Each kind corresponds to one
# of the reference's refine_* entry points (refinement.c:103/169/231/278):
KIND_DEL_START = 0  # refine_start(SV_DEL, ...)   D>50 at op start + trailing S
KIND_DEL_END = 1    # refine_end(SV_DEL, ...)     D>50 at op end+1 + leading S
KIND_INS = 2        # refine_ins(...)             I>=50 at op start
KIND_POINT = 3      # refine_point(SV_INV, ...)   collects nothing (quirk)
KIND_INV_END = 4    # --refine-inv extension (no reference analog): D>50 at
                    # op end+1 + leading S recording the ALIGNMENT START —
                    # the clean rule, not refine_end's post-walk-position
                    # quirk (refinement.c:210-221).  INV start windows reuse
                    # KIND_DEL_START (trailing-clip alignment end + D>50
                    # start), whose rules are already the right evidence.


def u32(x: int) -> int:
    """Wrap a Python int to uint32, mirroring C unsigned arithmetic."""
    return x & 0xFFFFFFFF


def i32(x: int) -> int:
    """Reinterpret a Python int as int32 (two's complement wrap)."""
    x &= 0xFFFFFFFF
    return x - U32 if x >= (1 << 31) else x
