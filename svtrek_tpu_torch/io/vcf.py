"""VCF record parsing with the reference's exact field semantics.

Models the reference's per-line VCF handling (audit.c:50-173) including
its quirks, which are load-bearing for record-identical output:

- CHROM: optional "chr" prefix stripped, then C atoi semantics (leading
  integer, else 0) — audit.c:101-105.
- POS: strtol; a conversion error (0 result with non-'0' leading char)
  skips the record — audit.c:108-113.
- SVTYPE: the *first* "SVTYPE=" substring anywhere in INFO (strstr), value
  up to ';' — audit.c:116-131.
- If SVTYPE is absent, infer INS when len(REF)==1 and max ALT allele
  length > 50, DEL when len(REF) > 50 and min ALT allele length == 1,
  else skip — audit.c:133-141.
- END: the *first* "END=" substring anywhere in INFO — which matches the
  tail of "CIEND=..." when that tag precedes END, yielding a negative
  strtol result that wraps to a huge uint32.  This quirk is mirrored
  because simvcf-generated DEL/INV records hit it and the baseline output
  must be record-identical — audit.c:145-163 (see SURVEY.md 'hard parts').
- Missing END: end = pos + len(REF) — audit.c:165.
- DEL/INV shorter than 50 bp (in uint32 arithmetic) are dropped —
  audit.c:168-173.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, Iterator

from .. import constants as C
from ..constants import SVType


@dataclass
class VcfTask:
    """One parsed, accepted VCF record ready for refinement."""

    line_index: int          # input order for deterministic emit
    chrom_index: int         # numeric chrom (atoi semantics)
    pos: int                 # uint32
    end: int                 # uint32 (possibly wrapped; quirk)
    sv_type: SVType
    raw: str = ""            # original data line (for refined-VCF output)
    chrom_name: str = ""     # raw CHROM field (--chrom-by-name extension)


@dataclass
class VcfSkip:
    """A record that produced a diagnostic instead of a task."""

    line_index: int
    message: str | None      # stderr text (None = silent skip)


def _atoi(s: str) -> int:
    """C atoi: optional sign + leading digits, else 0."""
    s = s.lstrip()
    i = 0
    if i < len(s) and s[i] in "+-":
        i += 1
    j = i
    while j < len(s) and s[j].isdigit():
        j += 1
    if j == i:
        return 0
    v = int(s[:j])
    return C.i32(v)


def _strtol(s: str) -> int:
    return _atoi(s)


def parse_sv_type(sv_str: str) -> SVType:
    """Reference: audit.c:3-11."""
    if sv_str in ("INS", "INS:ME"):
        return SVType.INS
    if sv_str in ("DEL", "DEL:ME"):
        return SVType.DEL
    if sv_str == "INV":
        return SVType.INV
    if sv_str == "DUP":
        return SVType.DUP
    if sv_str == "TRA":
        return SVType.TRA
    if sv_str == "BND":
        return SVType.BND
    return SVType.UNKNOWN


def parse_vcf_line(line_index: int, line: str) -> VcfTask | VcfSkip:
    """Parse one data line exactly as thread_func does (audit.c:50-173)."""
    # strtok_r("\t") collapses consecutive delimiters, like the reference.
    fields = [f for f in line.split("\t") if f != ""]
    if len(fields) < 2:
        return VcfSkip(line_index, f"VCF: no index at line: {fields[0] if fields else line}")
    if len(fields) < 8:
        # The reference would pass NULL into strlen/strstr and crash; any
        # sane VCF has 8 fields.  Treat as a silent skip (documented
        # divergence: we don't reproduce crashes).
        return VcfSkip(line_index, None)

    chrom_s, pos_s, _id, ref, alt = fields[0], fields[1], fields[2], fields[3], fields[4]
    info = fields[7]

    seq_len = len(ref)
    alt_lens = [len(a) for a in alt.split(",") if a != ""] or [len(alt)]
    max_alt_len = max(alt_lens)
    min_alt_len = min(alt_lens)

    if chrom_s.startswith("chr"):
        chrom_index = _atoi(chrom_s[3:])
    else:
        chrom_index = _atoi(chrom_s)

    pos = C.u32(_strtol(pos_s))
    if pos == 0 and (not pos_s or pos_s[0] != "0"):
        return VcfSkip(line_index, f"[ERROR] Conversion error to pos {pos_s}")

    sv_type = SVType.UNKNOWN
    k = info.find("SVTYPE=")
    if k >= 0:
        v = info[k + 7 :]
        semi = v.find(";")
        if semi >= 0:
            v = v[:semi]
        v = v[:15]  # sv_buf[16] truncation (audit.c:123-127)
        sv_type = parse_sv_type(v)
    else:
        if seq_len == 1 and max_alt_len > C.SV_MIN_LENGTH:
            sv_type = SVType.INS
        elif seq_len > C.SV_MIN_LENGTH and min_alt_len == 1:
            sv_type = SVType.DEL
        else:
            return VcfSkip(line_index, None)

    k = info.find("END=")
    if k >= 0:
        v = info[k + 4 :]
        semi = v.find(";")
        if semi >= 0:
            v = v[:semi]
        v = v[:31]  # end_buf[32] truncation (audit.c:152-156)
        end = C.u32(_strtol(v))
        if end == 0 and (not v or v[0] != "0"):
            return VcfSkip(line_index, None)
    else:
        end = C.u32(pos + seq_len)

    if sv_type in (SVType.DEL, SVType.INV):
        if C.u32(end - pos) < C.SV_MIN_LENGTH:
            return VcfSkip(line_index, None)

    if sv_type in (SVType.INS, SVType.DEL, SVType.INV):
        return VcfTask(line_index, chrom_index, pos, end, sv_type, raw=line,
                       chrom_name=chrom_s)
    # DUP/TRA/BND/UNKNOWN → "[ERROR] Unkown type." (typo preserved,
    # audit.c:234).
    return VcfSkip(line_index, "[ERROR] Unkown type.")


def iter_vcf_tasks(lines: Iterable[str]) -> Iterator[VcfTask | VcfSkip]:
    """Stream data lines of a VCF: header/short-line filter per
    process_vcf (audit.c:324)."""
    idx = 0
    for raw in lines:
        # The reference checks the raw fgets length (newline included)
        # before stripping it (audit.c:303-330).
        if len(raw) < 2 or raw.startswith("#"):
            continue
        yield parse_vcf_line(idx, raw.rstrip("\n"))
        idx += 1
