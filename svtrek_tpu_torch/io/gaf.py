"""GAF (graph alignment) parsing + projection onto the rank-0 backbone.

Models parse_gaf/parse_nodes (discover.c:9-246) with the detection path
*completed*.  The reference's projection loop is WIP — its op arrays mix
raw CIGAR characters with numeric codes so the CIGAR_REF/CIGAR_QUE
classification never fires, its detection branch bodies are empty, and
the recorded breakpoints carry placeholder offset/type
(discover.c:156-239; SURVEY.md §2.8, §3.3).  This module defines the
completed semantics the stubs imply:

- alignments with mapq 0 are discarded (discover.c:89);
- one alignment per read, first wins (discover.c:97-102);
- path nodes must exist, have rank <= 1, and share one strand
  (parse_nodes, discover.c:27-39);
- reverse-complement alignments ('<' leading path) are normalized by
  reversing node order and flipping path/read coordinates
  (fix_indices: new_start = len-end, new_end = len-start; utils.c:37-43);
- the CIGAR is projected segment-by-segment onto the rank-0 backbone:
  ops on rank-0 segments keep their class, query-consuming ops on rank-1
  (alt) segments become insertions, the gap between consecutive rank-0
  segments is emitted as a deletion, and read prefix/suffix clips become
  soft clips (discover.c:131-191);
- run-length scanning of the projected alignment yields INS/DEL/clip
  breakpoints >= min length, each carrying its true backbone offset,
  read offset, and length (completing discover.c:203-239).

Projection is run-length (not per-base like the reference's MAX_CIGAR
char array) — semantically identical, and the right shape to feed the
batched device scan (ops/discover.py).
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field

from ..constants import CIGAR_CODE, CIGAR_D, CIGAR_I, CIGAR_M, CIGAR_S, CIGAR_EQ, CIGAR_X
from .gfa import Gfa

_NODE_RE = re.compile(r"([<>])(\d+)")

_QUERY_OPS = {CIGAR_M, CIGAR_I, CIGAR_S, CIGAR_EQ, CIGAR_X}
_REF_OPS = {CIGAR_M, CIGAR_D, CIGAR_EQ, CIGAR_X}


@dataclass
class GafAlignment:
    read_name: str
    read_len: int
    read_start: int
    read_end: int
    strand: str
    path: str
    path_len: int
    path_start: int
    path_end: int
    matches: int
    block_len: int
    qual: int
    cigar: str | None = None
    rc: bool = False               # '<'-leading path (normalized)


@dataclass
class ProjectedRead:
    """A read's graph alignment projected to backbone coordinates."""

    read_name: str
    read_len: int
    read_start: int
    read_end: int
    rc: bool
    reference_start: int           # 0-based backbone coord of first ref op
    runs: list[tuple[int, int]] = field(default_factory=list)  # (op, len)


@dataclass
class Breakpoint:
    """One detected SV signal on one read (completed gaf_breakpoint,
    params.h:148-154 with real offset/type)."""

    read_name: str
    type: str                      # "INS" | "DEL" | "CLIP"
    ref_pos: int                   # 0-based backbone position
    read_pos: int                  # 0-based offset in the (normalized) read
    length: int
    rc: bool


_CIG_RE = re.compile(r"(\d+)([MIDNSHP=X])")


def parse_cigar_runs(cigar: str, reverse: bool = False) -> list[tuple[int, int]]:
    """cg:Z CIGAR string → (op, len) runs (utils.c:45-70, run-length)."""
    code = CIGAR_CODE
    runs = [(code[m.group(2)], int(m.group(1)))
            for m in _CIG_RE.finditer(cigar)]
    if reverse:
        runs.reverse()
    return runs


def fix_indices(start: int, end: int, length: int) -> tuple[int, int]:
    """Reverse-complement index flip (utils.c:37-43)."""
    return length - end, length - start


def parse_gaf_line(line: str) -> GafAlignment | None:
    f = line.rstrip("\n").split("\t")
    if len(f) < 12:
        return None
    aln = GafAlignment(
        read_name=f[0], read_len=int(f[1]), read_start=int(f[2]),
        read_end=int(f[3]), strand=f[4], path=f[5], path_len=int(f[6]),
        path_start=int(f[7]), path_end=int(f[8]), matches=int(f[9]),
        block_len=int(f[10]), qual=int(f[11]),
    )
    for tok in f[12:]:
        if tok.startswith("cg:Z:"):
            aln.cigar = tok[5:]
    return aln


def parse_nodes(aln: GafAlignment, gfa: Gfa) -> list[int] | None:
    """Path → node id list with the reference's validations
    (parse_nodes, discover.c:9-44). None = reject (with stderr text left
    to the caller)."""
    nodes = []
    fwd = rev = 0
    for m in _NODE_RE.finditer(aln.path):
        strand, sid = m.group(1), int(m.group(2))
        if sid not in gfa.by_id:
            return None
        if gfa.seg(sid).rank > 1:
            return None
        if strand == ">":
            fwd += 1
        else:
            rev += 1
        if fwd and rev:
            return None
        nodes.append(sid)
    return nodes or None


def project_alignment(aln: GafAlignment, nodes: list[int], gfa: Gfa) -> ProjectedRead | None:
    """Project the graph alignment onto the rank-0 backbone
    (completed discover.c:131-191)."""
    rc = aln.path.startswith("<")
    path_start, path_end = aln.path_start, aln.path_end
    read_start, read_end = aln.read_start, aln.read_end
    if rc:
        nodes = list(reversed(nodes))
        path_start, path_end = fix_indices(aln.path_start, aln.path_end, aln.path_len)
        read_start, read_end = fix_indices(aln.read_start, aln.read_end, aln.read_len)
    if aln.cigar is None:
        return None
    cigar = parse_cigar_runs(aln.cigar, reverse=rc)

    runs: list[tuple[int, int]] = []

    def emit(op: int, ln: int):
        if ln <= 0:
            return
        if runs and runs[-1][0] == op:
            runs[-1] = (op, runs[-1][1] + ln)
        else:
            runs.append((op, ln))

    # Fast path — single rank-0 node whose remaining length covers the
    # whole alignment (the overwhelmingly common case: most long-read
    # graph alignments stay on one backbone segment).  Semantically
    # identical to the general loop below: every op lands on the one
    # segment, no deletion-gap or alt-segment rewriting can occur.
    seg0 = gfa.seg(nodes[0])
    if len(nodes) == 1 and seg0.rank == 0:
        ref_need = sum(l for op, l in cigar if op in _REF_OPS)
        if ref_need <= len(seg0.seq) - path_start:
            emit(CIGAR_S, read_start)
            for op, ln in cigar:
                emit(op, ln)
            emit(CIGAR_S, aln.read_len - read_end)
            return ProjectedRead(
                read_name=aln.read_name, read_len=aln.read_len,
                read_start=read_start, read_end=read_end, rc=rc,
                reference_start=seg0.start + path_start,
                runs=runs,
            )

    emit(CIGAR_S, read_start)   # prefix clip (discover.c:135)

    ni = 0
    seg = gfa.seg(nodes[ni])
    prev_ref_seg = seg if seg.rank == 0 else None
    p_remaining = len(seg.seq) - path_start
    reference_start = seg.start + path_start if seg.rank == 0 else -1
    ref_start_set = seg.rank == 0

    done = False
    for op, ln in cigar:
        while ln > 0 and not done:
            if op in _REF_OPS:
                take = min(ln, p_remaining)
            else:
                take = ln     # I consumes no path; emit wholly at this seg
            if seg.rank == 0:
                emit(op, take)
            elif op in _QUERY_OPS:
                emit(CIGAR_I, take)   # alt-segment query bases → insertion
            ln -= take
            if op not in _REF_OPS:
                break
            p_remaining -= take
            if p_remaining > 0:
                continue
            # advance to the next path node
            ni += 1
            if ni == len(nodes):
                done = True
                break
            seg = gfa.seg(nodes[ni])
            p_remaining = len(seg.seq)
            if seg.rank == 0:
                if not ref_start_set:
                    reference_start = seg.start
                    ref_start_set = True
                if prev_ref_seg is not None and seg.start > prev_ref_seg.end:
                    emit(CIGAR_D, seg.start - prev_ref_seg.end)
                prev_ref_seg = seg
        if done:
            break

    emit(CIGAR_S, aln.read_len - read_end)   # suffix clip (discover.c:191)

    return ProjectedRead(
        read_name=aln.read_name, read_len=aln.read_len,
        read_start=read_start, read_end=read_end, rc=rc,
        reference_start=reference_start if ref_start_set else -1,
        runs=runs,
    )


def scan_breakpoints(pr: ProjectedRead, min_len: int = 50) -> list[Breakpoint]:
    """Run-length SV scan of a projected read (the completed
    discover.c:203-222 detection), host scalar form — the batched device
    form lives in ops/discover.py and must agree exactly."""
    out = []
    ref = pr.reference_start
    read = 0
    n = len(pr.runs)
    for i, (op, ln) in enumerate(pr.runs):
        if op == CIGAR_I and ln >= min_len:
            out.append(Breakpoint(pr.read_name, "INS", ref, read, ln, pr.rc))
        elif op == CIGAR_D and ln >= min_len:
            out.append(Breakpoint(pr.read_name, "DEL", ref, read, ln, pr.rc))
        elif op == CIGAR_S and ln >= min_len and (i == 0 or i == n - 1):
            out.append(Breakpoint(pr.read_name, "CLIP", ref, read, ln, pr.rc))
        if op in _REF_OPS:
            ref += ln
        if op in _QUERY_OPS:
            read += ln
    return out


def iter_gaf(path: str, gfa: Gfa, errors: list[str] | None = None):
    """Stream accepted alignments as ProjectedReads (dedupe: first
    alignment per read wins, discover.c:97-102).

    Memory note: the dedupe set necessarily grows O(unique read names)
    — the reference's khashl map has the same bound (discover.c:97-102).
    At ~60 B/name that is ~60 MB per million reads here (~24 B/name in
    the C fast path's offset+hash set, io/gaf_native.py); the 1M-read
    soak (tools/soak.py) measures the end-to-end RSS envelope."""
    seen: set[str] = set()
    with open(path) as fh:
        for line in fh:
            if not line.strip():
                continue
            aln = parse_gaf_line(line)
            if aln is None:
                continue
            if aln.qual == 0:
                continue
            if aln.read_name in seen:
                continue
            nodes = parse_nodes(aln, gfa)
            if nodes is None:
                if errors is not None:
                    errors.append(aln.read_name)
                continue
            pr = project_alignment(aln, nodes, gfa)
            if pr is None:
                continue
            seen.add(aln.read_name)
            yield pr
