#!/usr/bin/env python
"""The synthetic long-read `audt` fixture of tools/bench_e2e.py, built on the
PyTorch port's own BAM writer (svtrek_tpu_torch.io.bam), so that a run of
the port (chip_smoke.py) loads nothing of the JAX package.

`build_fixture` and `noisy_cigar` are copies of bench_e2e's: the same
random draws in the same order, so the files are byte-identical to
bench_e2e.build_fixture's for the same arguments.

    python tools/torch_fixtures.py DIR [--records N] [--depth D]
        [--ops-per-read O] [--realistic-seq]
"""
from __future__ import annotations

import argparse
import os
import random
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

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


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("dir")
    ap.add_argument("--records", type=int, default=1500)
    ap.add_argument("--depth", type=int, default=12)
    ap.add_argument("--ops-per-read", type=int, default=1500)
    ap.add_argument("--realistic-seq", action="store_true")
    args = ap.parse_args()
    os.makedirs(args.dir, exist_ok=True)
    bam, vcf, n_reads, n_ops = build_fixture(
        args.dir, args.records, args.depth, args.ops_per_read,
        realistic_seq=args.realistic_seq)
    print(f"{bam} {vcf}: {n_reads} reads, {n_ops} CIGAR ops")


if __name__ == "__main__":
    main()
