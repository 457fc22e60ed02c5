"""Reference-identical result-line formatting.

Reproduces the printf record stream of audit.c:175-236 byte-for-byte,
including signed/unsigned reinterpretation quirks:

- INS result is printed with %u, its diff with %d on uint32 arithmetic.
- DEL results are printed with %d (the uint32 interval fields reinterpret
  as int32), NA when 0xFFFFFFFF.
- INV results are printed with %u — an unrefined INV prints 4294967295
  (the reference's refine_point never collects evidence; SURVEY.md §3.2).

Unlike the reference (whose -o flag is parsed but ignored; init.c:102-107,
SURVEY.md §5), the framework really writes the stream to the output file
when configured, in deterministic input order.
"""
from __future__ import annotations

from . import constants as C
from .constants import SVType

NA32 = 0xFFFFFFFF


def format_ins(chrom: int, pos: int, result: int) -> str:
    r = C.u32(result)
    if r == NA32:
        return f"(INS) chr: {chrom}, org pos: {C.u32(pos)}, ref pos: NA"
    diff = C.i32(r - C.u32(pos))
    return (
        f"(INS) chr: {chrom}, org pos: {C.u32(pos)}, ref pos: {r}, "
        f"diff: {diff}"
    )


def format_del(chrom: int, pos: int, end: int, rstart: int, rend: int) -> str:
    rs, re_ = C.u32(rstart), C.u32(rend)
    out = f"(DEL) chr: {chrom}, org pos: {C.u32(pos)}, org end: {C.u32(end)}, ref pos: "
    out += "NA, ref end: " if rs == NA32 else f"{C.i32(rs)}, ref end: "
    out += "NA, " if re_ == NA32 else f"{C.i32(re_)}, "
    out += (
        "diff pos: NA, "
        if rs == NA32
        else f"diff pos: {C.i32(rs - C.u32(pos))}, "
    )
    out += (
        "diff end: NA"
        if re_ == NA32
        else f"diff end: {C.i32(re_ - C.u32(end))}"
    )
    return out


def format_inv(chrom: int, pos: int, end: int, rstart: int, rend: int) -> str:
    return (
        f"(INV) chr: {chrom}, org pos: {C.u32(pos)}, org end: {C.u32(end)}, "
        f"ref pos: {C.u32(rstart)}, ref end: {C.u32(rend)}"
    )


def format_result(sv_type: SVType, chrom: int, pos: int, end: int,
                  rstart: int, rend: int) -> str:
    if sv_type == SVType.INS:
        return format_ins(chrom, pos, rstart)
    if sv_type == SVType.DEL:
        return format_del(chrom, pos, end, rstart, rend)
    if sv_type == SVType.INV:
        return format_inv(chrom, pos, end, rstart, rend)
    raise ValueError(f"unexpected sv type {sv_type}")
