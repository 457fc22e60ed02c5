#!/usr/bin/env python
"""Independent scalar `audt`: VCF + BAM -> the reference tool's result lines.

A short re-statement of the reference's audt mode in plain Python and
numpy.  It shares no code with `svtrek_tpu` or `svtrek_tpu_torch`, so it
can hold either package's output to the reference semantics
(`chip_smoke.py` holds the PyTorch port to it on the card):

- VCF records, audit.c:50-173: the first `SVTYPE=` and `END=` substrings
  of INFO, the type inferred from allele lengths when SVTYPE is absent,
  uint32 positions, DEL/INV under 50 bp dropped;
- refine windows, audit.c:178-231: tid = chrom - 1, uint32 intervals,
  nothing printed for a DEL/INV of exactly 50 bp, INV windows running
  refine_point, which collects nothing;
- reads: the whole BAM decoded once with gzip, without its index; a
  window's reads are those with pos < end and endpos > beg, as htslib's
  region iterator gives them;
- the CIGAR evidence walks, refinement.c:103-325, and the clustering
  consensus, refinement.c:41-101, with their quirks;
- result lines, audit.c:175-236;
- with `--ins-consensus`, the framework's consensus of the inserted
  sequence on each INS line: the inserts of >= 50 bp that reads carry
  within `INTERVAL` of the refined position (the refine_ins walk's
  reference position, refinement.c:137-139), decoded from SEQ, and the
  star consensus of svtrek_tpu/ops/poa.py::consensus_sequence (majority
  length mode, length-medoid seed, banded alignment with insertion
  recovery, two voting rounds).

It runs the reference's defaults (params.h:27-41) and none of the
framework's other extensions (--refine-inv, --chrom-by-name, ...).

    python tools/audt_scalar.py [--ins-consensus] BAM VCF
"""
from __future__ import annotations

import bisect
import gzip
import re
import struct
import sys

import numpy as np

WIDER, MEDIAN, NARROW = 20000, 10000, 2000
RANGE, INTERVAL, MIN_COUNT, SV_MIN = 500, 5, 3, 50
M32 = 0xFFFFFFFF
OP_I, OP_D, OP_S = 1, 2, 4
REF_OPS = (0, 2, 3, 7, 8)  # M D N = X: the reference span (htslib endpos)
QUERY_OPS = (0, 1, 4, 7, 8)  # M I S = X: the ops that consume SEQ
NT16 = "=ACMGRSVTWYHKDBN"  # BAM 4-bit SEQ codes
# The star consensus (svtrek_tpu/ops/poa.py): scores, band, the longest
# seed it aligns, voting rounds.
MATCH, MISMATCH, GAP = 2, -4, -2
POA_BAND, POA_MAX_LEN, POA_ROUNDS = 64, 4096, 2
BASE_CODE = {"A": 0, "C": 1, "G": 2, "T": 3}
# The reference's four refine_* entry points (refinement.c:103/169/231/278).
START, END, POINT, INS = "start", "end", "point", "ins"


def u32(x: int) -> int:
    return x & M32


def i32(x: int) -> int:
    x &= M32
    return x - (1 << 32) if x >> 31 else x


def _atoi(s: str) -> int:
    m = re.match(r"\s*([+-]?\d+)", s)
    return i32(int(m.group(1))) if m else 0


def parse_record(line: str):
    """(sv_type, chrom, pos, end) of a data line, or None when the
    reference prints nothing for it."""
    f = [x for x in line.split("\t") if x]  # strtok_r collapses tabs
    if len(f) < 8:
        return None
    chrom_s, pos_s, ref, alt, info = f[0], f[1], f[3], f[4], f[7]
    chrom = _atoi(chrom_s[3:] if chrom_s.startswith("chr") else chrom_s)
    pos = u32(_atoi(pos_s))
    if pos == 0 and not pos_s.startswith("0"):
        return None
    k = info.find("SVTYPE=")
    if k >= 0:
        sv = {"INS": "INS", "INS:ME": "INS", "DEL": "DEL", "DEL:ME": "DEL",
              "INV": "INV"}.get(info[k + 7:].split(";")[0][:15])
    else:
        alts = [len(a) for a in alt.split(",") if a] or [len(alt)]
        sv = ("INS" if len(ref) == 1 and max(alts) > SV_MIN else
              "DEL" if len(ref) > SV_MIN and min(alts) == 1 else None)
    if sv is None:
        return None
    k = info.find("END=")  # also matches inside CIEND=, as strstr does
    if k >= 0:
        v = info[k + 4:].split(";")[0][:31]
        end = u32(_atoi(v))
        if end == 0 and not v.startswith("0"):
            return None
    else:
        end = u32(pos + len(ref))
    if sv != "INS" and u32(end - pos) < SV_MIN:
        return None
    return sv, chrom, pos, end


def windows(sv: str, pos: int, end: int):
    """[(kind, inter_start, inter_end, imprecise_pos)] per result slot, or
    None when the `50 < end - pos` check fails (audit.c:190, 223)."""
    if sv == "INS":
        return [(INS, u32(pos - MEDIAN), u32(pos + MEDIAN), pos)]
    if not SV_MIN < u32(end - pos):
        return None
    if sv == "DEL":
        return [(START, u32(pos - WIDER), u32(pos + NARROW), pos),
                (END, u32(end - NARROW), u32(end + NARROW), end)]
    return [(POINT, u32(pos - WIDER), u32(pos + WIDER), pos),
            (POINT, u32(end - WIDER), u32(end + WIDER), end)]


class Bam:
    """Every placed read of a BAM, by tid: start, end and CIGAR, and with
    ``with_seq`` its 4-bit SEQ bytes and length."""

    def __init__(self, path: str, with_seq: bool = False):
        by_tid: dict[int, list] = {}
        with gzip.open(path, "rb") as f:
            magic, l_text = struct.unpack("<4si", f.read(8))
            if magic != b"BAM\x01":
                raise ValueError(f"{path} is not a BAM file")
            f.read(l_text)
            (n_ref,) = struct.unpack("<i", f.read(4))
            for _ in range(n_ref):
                (l_name,) = struct.unpack("<i", f.read(4))
                f.read(l_name + 4)
            while len(head := f.read(4)) == 4:
                rec = f.read(struct.unpack("<i", head)[0])
                tid, pos, l_name, _, _, n_cig, _, l_seq = struct.unpack_from(
                    "<iiBBHHHi", rec)
                if tid < 0:
                    continue
                cig = np.frombuffer(rec, np.uint32, n_cig, 32 + l_name)
                ops, lens = (cig & 0xF).astype(np.uint8), cig >> 4
                span = int(lens[np.isin(ops, REF_OPS)].sum())
                read = (pos, pos + span if span > 0 else pos + 1, ops,
                        lens.astype(np.uint64))
                if with_seq:
                    at = 32 + l_name + 4 * n_cig
                    read += (l_seq, rec[at:at + (l_seq + 1) // 2])
                by_tid.setdefault(tid, []).append(read)
        self.reads = {}
        for tid, rs in by_tid.items():
            rs.sort(key=lambda r: r[0])  # stable: file order within a pos
            self.reads[tid] = (np.array([r[0] for r in rs], np.int64),
                               np.array([r[1] for r in rs], np.int64), rs)

    def fetch(self, tid: int, beg: int, end: int):
        """Reads overlapping [beg, end): pos < end and endpos > beg."""
        if tid not in self.reads:
            return []
        starts, ends, rs = self.reads[tid]
        hi = int(np.searchsorted(starts, end, "left"))
        return [rs[i] for i in np.flatnonzero(ends[:hi] > beg)]


def evidence(kind: str, pos: int, ops, lens, s: int, e: int) -> list[int]:
    """One read's candidate positions for one refine_* call.  The walk
    advances reference_pos on every op but I and S (H and P included)
    and stops after the op that takes it past the interval end."""
    if len(ops) == 0:
        return []
    pos = u32(pos)
    after = (pos + np.cumsum(np.where((ops == OP_I) | (ops == OP_S), 0,
                                      lens))) & M32
    before = np.concatenate((np.array([pos], np.uint64), after[:-1]))
    past = np.flatnonzero(after > e)
    walked = slice(0, past[0] + 1 if len(past) else len(ops))
    o, ln, b = ops[walked], lens[walked], before[walked]
    if kind == INS:  # refine_ins: I >= 50 at the op start
        out = b[(o == OP_I) & (ln >= SV_MIN)].tolist()
    elif kind == START:  # refine_start: D > 50 at the op start, and the
        # walk's end when a trailing soft clip ends an unbroken walk
        out = b[(o == OP_D) & (ln > SV_MIN)].tolist()
        if not len(past) and ops[-1] == OP_S and s <= int(after[-1]) <= e:
            out.append(int(after[-1]))
    elif kind == END:  # refine_end: D > 50 at op end + 1, and, for a
        # leading soft clip, the position where the walk stopped + 1
        hit = (o == OP_D) & (ln > SV_MIN)
        out = ((b[hit] + ln[hit] + 1) & M32).tolist()
        if ops[0] == OP_S and s <= pos <= e:
            out.append(u32(int(after[walked.stop - 1]) + 1))
    else:  # refine_point collects nothing (refinement.c:250)
        out = []
    return [i32(x) for x in out]


def consensus_pos(locs, pos: int, min_count: int = MIN_COUNT,
                  interval: int = INTERVAL, range_: int = RANGE) -> int:
    """refinement.c:41-101: the left then the right sweep over anchors
    within range_ of pos; clusters are summed in uint64 and their mean
    truncated to int32; a bigger cluster whose mean lands within interval
    of pos returns at once.  -1 is NA."""
    a = sorted(locs)
    n = len(a)
    if n < min_count or n == 0:
        return -1

    def mean(lo: int, hi: int) -> int:
        c = hi - lo
        return i32(((sum(a[lo:hi]) + c // 2) % (1 << 64)) // c)

    best, dist = [-1, -1], [0x7FFFFFFF, 0x7FFFFFFF]
    # lower_bound: the last element <= pos + 25, clamped to 0; the
    # reference's upper_bound: 0 if a[0] < pos - 25, else n - 1.
    starts = (max(bisect.bisect_right(a, pos + SV_MIN // 2) - 1, 0),
              0 if a[0] < pos - SV_MIN // 2 else n - 1)
    for side, step in ((0, -1), (1, 1)):
        i, most = starts[side], min_count - 1
        while 0 <= i < n and abs(pos - a[i]) < range_:
            if side == 0:
                lo, hi = bisect.bisect_left(a, a[i] - interval, 0, i), i + 1
            else:
                lo, hi = i, bisect.bisect_right(a, a[i] + interval, i)
            cand = mean(lo, hi)
            d = abs(pos - cand)
            if hi - lo > most:
                if d < interval:
                    return cand
                if d < dist[side]:
                    most, best[side], dist[side] = hi - lo, cand, d
            i += step
    return best[0] if dist[0] < dist[1] else best[1]


def ins_seqs(bam: Bam, tid: int, lo: int, hi: int) -> list[str]:
    """The inserted bases of every I op >= 50 bp whose reference position
    lies in [lo, hi], from the reads overlapping [max(lo, 0), hi + 1), in
    file order.  The position advances on every op but I and S, in uint32
    (refinement.c:137-139); an op that runs past SEQ is skipped."""
    out = []
    for pos, _, ops, lens, l_seq, nib in bam.fetch(tid, max(lo, 0), hi + 1):
        if l_seq <= 0:
            continue
        rp, qpos = pos, 0
        for op, ln in zip(ops.tolist(), lens.tolist()):
            if op == OP_I and ln >= SV_MIN and lo <= rp <= hi \
                    and qpos + ln <= l_seq:
                out.append("".join(
                    NT16[nib[q >> 1] >> 4 if q % 2 == 0 else nib[q >> 1] & 15]
                    for q in range(qpos, qpos + ln)))
            if op not in (OP_I, OP_S):
                rp = u32(rp + ln)
            if op in QUERY_OPS:
                qpos += ln
    return out


def _codes(seq: str) -> list[int]:
    """Base codes A C G T = 0..3, anything else 4 (N)."""
    return [BASE_CODE.get(c, 4) for c in seq.upper()]


def align_ins(t: list[int], q: list[int], band: int):
    """Global alignment of q onto t within |i - j| <= max(band, |n-m|+1):
    the query base on each target column (-1 = gap) and the query bases
    inserted before each column boundary 0..m.  Ties go to the diagonal,
    then to the query gap; the target gap wins only when strictly
    better."""
    n, m = len(q), len(t)
    band = max(band, abs(n - m) + 1)
    neg = -10 ** 9
    prev = [GAP * j if j <= band else neg for j in range(m + 1)]
    moves = [bytearray([2]) * (m + 1)]
    for i in range(1, n + 1):
        cur = [neg] * (m + 1)
        mv = bytearray(m + 1)
        if i <= band:
            cur[0], mv[0] = GAP * i, 1
        qi = q[i - 1]
        for j in range(max(1, i - band), min(m, i + band) + 1):
            best = prev[j - 1] + (MATCH if t[j - 1] == qi else MISMATCH)
            move = 0
            if prev[j] + GAP > best:
                best, move = prev[j] + GAP, 1
            if cur[j - 1] + GAP > best:
                best, move = cur[j - 1] + GAP, 2
            cur[j], mv[j] = best, move
        moves.append(mv)
        prev = cur
    cols, ins = [-1] * m, [[] for _ in range(m + 1)]
    i, j = n, m
    while i > 0 or j > 0:
        move = moves[i][j]
        if i > 0 and j > 0 and move == 0:
            cols[j - 1] = q[i - 1]
            i, j = i - 1, j - 1
        elif i > 0 and move == 1:
            ins[j].insert(0, q[i - 1])
            i -= 1
        else:
            j -= 1
    return cols, ins


def _vote(cons: str, members: list[str]) -> str:
    """One round: align every member to cons and vote per column (a gap
    majority drops it) and per boundary (an insert seen in more than half
    the members is kept; the first of equal counts wins)."""
    t = _codes(cons)
    m = len(t)
    votes = [[0] * 6 for _ in range(m)]
    ins_votes: list[dict] = [{} for _ in range(m + 1)]
    for s in members:
        if s == cons:
            for j, c in enumerate(t):
                votes[j][c] += 1
            continue
        cols, ins = align_ins(t, _codes(s[:4 * m]), POA_BAND)
        for j, c in enumerate(cols):
            votes[j][c if c >= 0 else 5] += 1
        for j, seg in enumerate(ins):
            if seg:
                key = "".join("ACGTN"[c] for c in seg)
                ins_votes[j][key] = ins_votes[j].get(key, 0) + 1
    out = []
    for j in range(m + 1):
        if ins_votes[j]:
            seg, count = max(ins_votes[j].items(), key=lambda kv: kv[1])
            if count > len(members) // 2:
                out.append(seg)
        if j < m:
            best = votes[j].index(max(votes[j]))
            if best != 5:
                out.append("ACGTN"[best])
    return "".join(out)


def star_consensus(seqs: list[str]) -> str:
    """The consensus of a site's inserts ("" for none): the largest group
    of lengths linked within max(10, 10 %) of each other, its length
    medoid as the seed, then voting rounds until the seed stops
    changing."""
    seqs = [s for s in seqs if s]
    if len(seqs) < 2:
        return seqs[0] if seqs else ""
    order = sorted(range(len(seqs)), key=lambda i: len(seqs[i]))
    groups = [[order[0]]]
    for a, b in zip(order, order[1:]):
        if len(seqs[b]) - len(seqs[a]) <= max(10, len(seqs[a]) // 10):
            groups[-1].append(b)
        else:
            groups.append([b])
    members = [seqs[i] for i in sorted(max(groups, key=len))]
    if len(members) == 1:
        return members[0]
    cons = sorted(members, key=len)[len(members) // 2]
    if len(cons) > POA_MAX_LEN:
        return cons
    for _ in range(POA_ROUNDS):
        new = _vote(cons, members)
        if not new or new == cons:
            break
        cons = new
    return cons


def result_line(sv: str, chrom: int, pos: int, end: int, r0: int,
                r1: int) -> str:
    """audit.c's printf of one record; r0/r1 are uint32, M32 for NA."""
    if sv == "INS":
        head = f"(INS) chr: {chrom}, org pos: {pos}, ref pos: "
        return head + ("NA" if r0 == M32 else f"{r0}, diff: {i32(r0 - pos)}")
    if sv == "INV":
        return (f"(INV) chr: {chrom}, org pos: {pos}, org end: {end}, "
                f"ref pos: {r0}, ref end: {r1}")
    p, e = [("NA", "NA") if r == M32 else (i32(r), i32(r - org))
            for r, org in ((r0, pos), (r1, end))]
    return (f"(DEL) chr: {chrom}, org pos: {pos}, org end: {end}, "
            f"ref pos: {p[0]}, ref end: {e[0]}, diff pos: {p[1]}, "
            f"diff end: {e[1]}")


def audt_lines(bam_path: str, vcf_path: str, ins_consensus: bool = False,
               seq_lines=None, consensus=star_consensus) -> list[str]:
    """The reference's result lines for a VCF against a BAM, in input
    order.  With ``ins_consensus`` each INS line ends in `, seq: S` (NA
    without a refined position or a consensus); ``seq_lines``, when given,
    limits that to the lines of those indices.  ``consensus`` maps a site's
    inserts to S: by default the star consensus (`star_consensus`); a
    caller may give another engine's scalar form, such as the graph POA's
    `consensus_sequence_poa`."""
    bam = Bam(bam_path, with_seq=ins_consensus)
    lines = []
    with open(vcf_path) as fh:
        for raw in fh:
            if len(raw) < 2 or raw.startswith("#"):
                continue
            rec = parse_record(raw.rstrip("\n"))
            if rec is None:
                continue
            sv, chrom, pos, end = rec
            wins = windows(sv, pos, end)
            if wins is None:
                continue
            res = [M32, M32]
            for slot, (kind, s, e, ipos) in enumerate(wins):
                cands = [] if kind == POINT else [
                    c for rpos, _, ops, lens, *_ in bam.fetch(
                        chrom - 1, u32(s - 1), u32(e - 1))
                    for c in evidence(kind, rpos, ops, lens, s, e)]
                res[slot] = u32(consensus_pos(cands, ipos))
            line = result_line(sv, chrom, pos, end, *res)
            if ins_consensus and sv == "INS" and (
                    seq_lines is None or len(lines) in seq_lines):
                seq = "" if res[0] == M32 or chrom < 1 else consensus(
                    ins_seqs(bam, chrom - 1, res[0] - INTERVAL,
                             res[0] + INTERVAL))
                line += f", seq: {seq or 'NA'}"
            lines.append(line)
    return lines


if __name__ == "__main__":
    args = [a for a in sys.argv[1:] if a != "--ins-consensus"]
    if len(args) != 2:
        sys.exit("usage: audt_scalar.py [--ins-consensus] BAM VCF")
    print("\n".join(audt_lines(*args, "--ins-consensus" in sys.argv)))
