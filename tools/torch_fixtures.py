#!/usr/bin/env python
"""The synthetic long-read `audt` fixture of tools/bench_e2e.py, built on the
PyTorch port's own BAM writer (svtrek_tpu_torch.io.bam), so that a run of
the port (chip_smoke.py) loads nothing of the JAX package; and the two
route fixtures of chip_smoke.py's routes phase.

`build_fixture` and `noisy_cigar` are copies of bench_e2e's: the same
random draws in the same order, so the files are byte-identical to
bench_e2e.build_fixture's for the same arguments.

The route fixtures are synthetic shapes that reach a route of the JAX
package's static shapes, not user traffic; they state no share of real
reads:

- `build_dense_disc_fixture`: tools/bench_disc.py's backbone and 1 kb
  noisy reads, where DENSE_SHARE of the reads carry one deletion of
  60-199 bases or a 60-259-base clip, so a batch of 8,192 reads holds
  about 2,450 hits, past the 2,048 of the scan's first page; and a few
  insertion sites whose clusters take the star consensus;
- `build_route_bam`: records 200 kbp apart whose windows hold, beside 10
  supporting reads, one read of 20,000-40,000 CIGAR ops (past the JAX
  package's top ops bucket of 16,384) or one read of 10-16 candidates
  (past its device walk's 8 a read), every window within the default K
  and sweep caps;
- `build_deep_bam`: records 200 kbp apart whose windows hold more
  candidates than the default first-pass widths (`--cand-width` 128,
  `--sweep-width` 128, `--max-candidates` 1,024), in three tiers of
  supporting depth (DEEP_TIERS), the shape of deep long-read sampling
  at a call; no window holds more than 4,096 candidates.

    python tools/torch_fixtures.py DIR [--records N] [--depth D]
        [--ops-per-read O] [--realistic-seq]
    python tools/torch_fixtures.py DIR --dense-disc READS
    python tools/torch_fixtures.py DIR --route-bam RECORDS
    python tools/torch_fixtures.py DIR --deep-bam [--seed S]
"""
from __future__ import annotations

import argparse
import os
import random
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import bench_disc  # noqa: E402

from svtrek_tpu_torch.constants import (  # noqa: E402
    CIGAR_D, CIGAR_I, CIGAR_M, CIGAR_S,
)
from svtrek_tpu_torch.io.bam import BamRecord, BamWriter  # noqa: E402


def noisy_cigar(rng, n_ops, sv_op=None, sv_len=0, lead=2000):
    """A long-read-like CIGAR: lead M, optional SV op, then n_ops small
    M/I/D ops (the indel-rich profile of real ONT/PacBio alignments)."""
    cig = []
    if rng.random() < 0.3:
        cig.append((CIGAR_S, rng.randint(20, 300)))
    cig.append((CIGAR_M, lead))
    if sv_op is not None:
        cig.append((sv_op, sv_len))
    for _ in range(n_ops):
        t = rng.random()
        if t < 0.5:
            cig.append((CIGAR_M, rng.randint(5, 120)))
        elif t < 0.75:
            cig.append((CIGAR_I, rng.randint(1, 40)))
        else:
            cig.append((CIGAR_D, rng.randint(1, 40)))
    if rng.random() < 0.3:
        cig.append((CIGAR_S, rng.randint(20, 300)))
    return cig


def build_fixture(tmpdir, n_records, depth, ops_per_read, seed=0,
                  realistic_seq=False):
    """Write bench.bam (+ .bai) and bench.vcf into tmpdir: n_records SV
    records (a third each DEL, INS, INV) on one 120 Mbp chromosome, depth
    supporting and depth // 2 noise reads per record, each with
    ops_per_read small CIGAR ops.  realistic_seq=False writes all-'A' SEQ;
    True writes random ACGT bases and QUAL.  Returns (bam, vcf, reads,
    CIGAR ops)."""
    rng = random.Random(seed)
    nprng = np.random.default_rng(seed)
    chrom_len = 120_000_000
    bam_path = os.path.join(tmpdir, "bench.bam")
    vcf_path = os.path.join(tmpdir, "bench.vcf")

    svs = []
    step = chrom_len // (n_records + 2)
    pos = step
    for i in range(n_records):
        svtype = ("DEL", "INS", "INV")[i % 3]
        svlen = rng.randint(60, 400)
        svs.append((pos, svtype, svlen))
        pos += step

    reads = []
    op_of = {"DEL": CIGAR_D, "INS": CIGAR_I}
    total_ops = 0
    for pos, svtype, svlen in svs:
        for _ in range(depth):
            start0 = (pos - 1) - rng.randint(2000, 9000)
            lead = (pos - 1) - start0 + rng.randint(-2, 2)
            cig = noisy_cigar(rng, ops_per_read, op_of.get(svtype),
                              svlen, lead=max(lead, 1))
            reads.append((start0, cig))
            total_ops += len(cig)
        # noise reads in the window (no SV op)
        for _ in range(depth // 2):
            start0 = (pos - 1) - rng.randint(2000, 9000)
            cig = noisy_cigar(rng, ops_per_read, None, 0,
                              lead=rng.randint(1000, 4000))
            reads.append((start0, cig))
            total_ops += len(cig)

    reads.sort(key=lambda r: r[0])
    with BamWriter(bam_path, [("1", chrom_len)]) as w:
        for i, (start0, cig) in enumerate(reads):
            qlen = sum(l for op, l in cig if op in (CIGAR_M, CIGAR_I, CIGAR_S))
            if realistic_seq:
                seq = nprng.integers(0, 4, qlen, dtype=np.uint8)
                seq = bytes(np.frombuffer(b"ACGT", np.uint8)[seq]) \
                    .decode("ascii")
                qual = nprng.integers(10, 50, qlen, dtype=np.uint8) \
                    .tobytes()
            else:
                seq, qual = "A" * qlen, None
            w.write(BamRecord(name=f"r{i}", flag=0, tid=0, pos=start0,
                              mapq=60, cigar=cig, seq=seq, qual=qual))

    with open(vcf_path, "w") as fh:
        fh.write("##fileformat=VCFv4.2\n")
        fh.write('##INFO=<ID=SVTYPE,Number=1,Type=String,Description="x">\n')
        fh.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n")
        for i, (pos, svtype, svlen) in enumerate(svs):
            end = pos + (svlen if svtype != "INS" else 0)
            fh.write(f"1\t{pos}\tsv{i}\tN\t<{svtype}>\t.\tPASS\t"
                     f"SVTYPE={svtype};END={end}\n")
    return bam_path, vcf_path, len(reads), total_ops


# The dense disc fixture's share of reads with one big deletion or clip.
DENSE_SHARE = 0.30


def build_dense_disc_fixture(tmpdir, n_reads, seed=0, ins_sites=8,
                             ins_depth=8):
    """Write bench.gfa / bench.gaf / bench.fq into tmpdir: tools/
    bench_disc.py's 1 MiB backbone and noisy 1 kb template reads, where
    DENSE_SHARE of the reads carry one deletion of 60-199 bases (spliced
    into the template) or a clip of 60-259 bases (half each), at random
    places, and ``ins_sites`` insertion sites of 55-119 bases each carry
    ``ins_depth`` reads spread over the file.  Returns the three paths."""
    bd = bench_disc
    rng = np.random.default_rng(seed)
    gfa = os.path.join(tmpdir, "bench.gfa")
    gaf = os.path.join(tmpdir, "bench.gaf")
    fq = os.path.join(tmpdir, "bench.fq")
    seqs = {}
    with open(gfa, "w") as fh:
        for i in range(1, bd.N_SEG + 1):
            seqs[i] = bd._rand_seq(rng, bd.SEG_LEN)
            fh.write(f"S\t{i}\t{seqs[i]}\n")
        fh.write("P\tref\t" + ",".join(
            f"{i}+" for i in range(1, bd.N_SEG + 1)) + "\t*\n")
        for i in range(1, bd.N_SEG):
            fh.write(f"L\t{i}\t+\t{i + 1}\t+\t0M\n")

    templates = [bd._noisy_runs(rng, bd.READ_LEN)
                 for _ in range(bd.N_TEMPLATES)]
    site_seg = rng.integers(1, bd.N_SEG + 1, ins_sites)
    site_off = rng.integers(2_000, bd.SEG_LEN - 2_000 - bd.READ_LEN,
                            ins_sites)
    ins_seq = [bd._rand_seq(rng, int(n))
               for n in rng.integers(55, 120, ins_sites)]
    step = max(n_reads // (ins_sites * ins_depth), 1)

    def splice(t: int, op: str, ln: int, lead_ref: int):
        runs, ref, placed = [], 0, False
        for o, l in templates[t]:
            if not placed and ref >= lead_ref:
                runs.append((op, ln))
                placed = True
            runs.append((o, l))
            if o in "=XD":
                ref += l
        if not placed:
            runs.append((op, ln))
        return runs

    with open(gaf, "w") as g, open(fq, "w") as f:
        for r in range(n_reads):
            t = int(rng.integers(0, bd.N_TEMPLATES))
            lead = int(rng.integers(200, bd.READ_LEN - 300))
            seg = int(rng.integers(1, bd.N_SEG + 1))
            off = int(rng.integers(0, bd.SEG_LEN - 2 * bd.READ_LEN))
            clip, big_ins = 0, None
            u = rng.random()
            if r % step == 0 and r // step < ins_sites * ins_depth:
                s = (r // step) % ins_sites
                seg, off = int(site_seg[s]), int(site_off[s]) - lead
                big_ins = ins_seq[s]
                runs = splice(t, "I", len(big_ins), lead)
            elif u < DENSE_SHARE / 2:
                runs = splice(t, "D", int(rng.integers(60, 200)), lead)
            elif u < DENSE_SHARE:
                runs, clip = templates[t], 60 + lead % 200
            else:
                runs = templates[t]
            qlen, span = bd._qlen(runs), bd._rspan(runs)
            g.write(f"rd{r}\t{qlen + clip}\t{clip}\t{qlen + clip}\t+\t"
                    f">{seg}\t{bd.SEG_LEN}\t{off}\t{off + span}\t{qlen}"
                    f"\t{qlen}\t60\tcg:Z:{bd._runs_str(runs)}\n")
            seq = bd._rand_seq(rng, clip) + bd._read_seq(
                rng, runs, seqs[seg], off, big_ins)
            f.write(f"@rd{r}\n{seq}\n+\n{'I' * len(seq)}\n")
    return gfa, gaf, fq


def _small_ops(rng, n_ops):
    """n_ops small M/I/D runs (1-8, 1-3, 1-3 bases), none a candidate."""
    kinds = rng.choice(np.array([CIGAR_M, CIGAR_M, CIGAR_I, CIGAR_D]),
                       n_ops)
    lens = np.where(kinds == CIGAR_M, rng.integers(1, 9, n_ops),
                    rng.integers(1, 4, n_ops))
    return list(zip(kinds.tolist(), lens.tolist()))


def build_route_bam(tmpdir, n_records, seed=0, depth=10):
    """Write route.bam (+ .bai) and route.vcf into tmpdir: n_records SV
    records (DEL and INS in turn) 200 kbp apart on one chromosome, each
    with ``depth`` supporting reads of about 100 ops and, in turn, one
    read of 20,000-40,000 small ops that carries the SV op at the
    breakpoint, or one read of 10-16 SV ops of 51-90 bases 300 bases
    apart inside the first window.  Returns (bam, vcf)."""
    rng = np.random.default_rng(seed)
    spacing = 200_000
    chrom_len = spacing * (n_records + 2)
    bam = os.path.join(tmpdir, "route.bam")
    vcf = os.path.join(tmpdir, "route.vcf")
    reads, records = [], []
    for i in range(n_records):
        pos = spacing * (i + 1)
        svtype = ("DEL", "INS")[i % 2]
        op = CIGAR_D if svtype == "DEL" else CIGAR_I
        svlen = int(rng.integers(60, 400))
        records.append((pos, svtype, svlen))
        for _ in range(depth):
            start = pos - 1 - int(rng.integers(1_000, 5_000))
            lead = pos - 1 - start + int(rng.integers(-2, 3))
            reads.append((start, [(CIGAR_M, lead), (op, svlen)] +
                          _small_ops(rng, 100)))
        start = pos - 1 - int(rng.integers(6_000, 9_000))
        if i % 4 < 2:
            tail = _small_ops(rng, int(rng.integers(20_000, 40_000)))
            reads.append((start, [(CIGAR_M, pos - 1 - start), (op, svlen)]
                          + tail))
        else:
            many = []
            for _ in range(int(rng.integers(10, 17))):
                many += [(CIGAR_M, 300), (op, int(rng.integers(51, 91)))]
            reads.append((start, many + [(CIGAR_M, 500)]))
    reads.sort(key=lambda r: r[0])
    with BamWriter(bam, [("1", chrom_len)]) as w:
        for i, (start, cig) in enumerate(reads):
            qlen = sum(l for o, l in cig if o in (CIGAR_M, CIGAR_I, CIGAR_S))
            w.write(BamRecord(name=f"r{i}", flag=0, tid=0, pos=start,
                              mapq=60, cigar=cig, seq="A" * qlen))
    with open(vcf, "w") as fh:
        fh.write("##fileformat=VCFv4.2\n")
        fh.write('##INFO=<ID=SVTYPE,Number=1,Type=String,Description="x">\n')
        fh.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n")
        for i, (pos, svtype, svlen) in enumerate(records):
            end = pos + (svlen if svtype == "DEL" else 0)
            fh.write(f"1\t{pos}\trt{i}\tN\t<{svtype}>\t.\tPASS\t"
                     f"SVTYPE={svtype};END={end}\n")
    return bam, vcf


# The deep BAM's tiers: (records, fewest and most supporting reads).  The
# first passes --cand-width 128 on the host path and --sweep-width 128 on
# the device walk, the second --max-candidates 1,024; the third stays in
# the first pass.
DEEP_TIERS = ((16, 150, 400), (8, 1_100, 2_500), (40, 10, 30))
DEEP_SPACING = 200_000


def deep_records(tiers=DEEP_TIERS) -> list[tuple[int, str, int]]:
    """The deep BAM's records in order, (pos, svtype, tier): DEL and INS
    in turn, DEEP_SPACING apart, tier after tier."""
    out, i = [], 0
    for t, (n, _, _) in enumerate(tiers):
        for _ in range(n):
            out.append((DEEP_SPACING * (i + 1), ("DEL", "INS")[i % 2], t))
            i += 1
    return out


def build_deep_bam(tmpdir, seed=0, tiers=DEEP_TIERS):
    """Write deep.bam (+ .bai) and deep.vcf into tmpdir: the records of
    `deep_records`, each with as many supporting reads as its tier draws,
    reads of 2-4 kb (M, the SV op of 60-399 bases at the breakpoint
    jittered by +-2, a few small indels, M).  Returns (bam, vcf)."""
    rng = np.random.default_rng(seed)
    recs = deep_records(tiers)
    chrom_len = DEEP_SPACING * (len(recs) + 2)
    bam = os.path.join(tmpdir, "deep.bam")
    vcf = os.path.join(tmpdir, "deep.vcf")
    reads, svlens = [], []
    for pos, svtype, t in recs:
        op = CIGAR_D if svtype == "DEL" else CIGAR_I
        svlen = int(rng.integers(60, 400))
        svlens.append(svlen)
        _, lo, hi = tiers[t]
        for _ in range(int(rng.integers(lo, hi + 1))):
            span = int(rng.integers(2_000, 4_001))
            lead = int(rng.integers(500, span - 500))
            start = pos - 1 + int(rng.integers(-2, 3)) - lead
            small = _small_ops(rng, 6)
            rest = span - lead - sum(l for o, l in small
                                     if o in (CIGAR_M, CIGAR_D))
            reads.append((start, [(CIGAR_M, lead), (op, svlen)] + small +
                          [(CIGAR_M, max(rest, 1))]))
    reads.sort(key=lambda r: r[0])
    with BamWriter(bam, [("1", chrom_len)]) as w:
        for i, (start, cig) in enumerate(reads):
            qlen = sum(l for o, l in cig if o in (CIGAR_M, CIGAR_I, CIGAR_S))
            w.write(BamRecord(name=f"d{i}", flag=0, tid=0, pos=start,
                              mapq=60, cigar=cig, seq="A" * qlen))
    with open(vcf, "w") as fh:
        fh.write("##fileformat=VCFv4.2\n")
        fh.write('##INFO=<ID=SVTYPE,Number=1,Type=String,Description="x">\n')
        fh.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n")
        for i, ((pos, svtype, _), svlen) in enumerate(zip(recs, svlens)):
            end = pos + (svlen if svtype == "DEL" else 0)
            fh.write(f"1\t{pos}\tdp{i}\tN\t<{svtype}>\t.\tPASS\t"
                     f"SVTYPE={svtype};END={end}\n")
    return bam, vcf


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("dir")
    ap.add_argument("--records", type=int, default=1500)
    ap.add_argument("--depth", type=int, default=12)
    ap.add_argument("--ops-per-read", type=int, default=1500)
    ap.add_argument("--realistic-seq", action="store_true")
    ap.add_argument("--dense-disc", type=int, metavar="READS",
                    help="build the dense disc route fixture instead")
    ap.add_argument("--route-bam", type=int, metavar="RECORDS",
                    help="build the device-walk route BAM instead")
    ap.add_argument("--deep-bam", action="store_true",
                    help="build the deep BAM (windows past the first "
                    "passes' widths) instead")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    os.makedirs(args.dir, exist_ok=True)
    if args.deep_bam:
        print(*build_deep_bam(args.dir, seed=args.seed))
        return
    if args.dense_disc:
        print(*build_dense_disc_fixture(args.dir, args.dense_disc))
        return
    if args.route_bam:
        print(*build_route_bam(args.dir, args.route_bam))
        return
    bam, vcf, n_reads, n_ops = build_fixture(
        args.dir, args.records, args.depth, args.ops_per_read,
        realistic_seq=args.realistic_seq)
    print(f"{bam} {vcf}: {n_reads} reads, {n_ops} CIGAR ops")


if __name__ == "__main__":
    main()
