#!/usr/bin/env python
"""Synthetic long-read fixture for `audt --ins-consensus`.

    python tools/ins_fixture.py DIR [--sites N] [--seed S]

Writes DIR/ins.bam (+ .bai), DIR/ins.vcf and DIR/sites.json: N INS records
50 kb apart on one chromosome.  Each site has 8-20 supporting reads (5 % of
the sites have 2, too few for a refined position), each carrying a mutated
copy of the site's insert in SEQ (2 % substitutions, 1 % insertions, 1 %
deletions) at its I op, between random-ACGT flanks (lead 500-2,000 bp,
tail 500-1,500 bp), and 4 spanning reads without an insert.  Insert
lengths are drawn per site from the classes of `LENGTH_CLASSES`; the
longest class lies above the consensus's 4,096-base `max_len`, so those
sites take no DP.  10 % of the sites carry a second, longer allele on
about 40 % of their reads, which the majority length mode must drop.
SEQ is built with numpy, as tools/bench_e2e.py does.  sites.json lists per
site its position, length class, read count and allele count.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from svtrek_tpu_torch.constants import CIGAR_I, CIGAR_M  # noqa: E402
from svtrek_tpu_torch.io.bam import BamRecord, BamWriter  # noqa: E402

SPACING = 50_000
# (share of sites, shortest, longest insert)
LENGTH_CLASSES = [(0.35, 50, 150), (0.35, 280, 340), (0.20, 500, 2000),
                  (0.08, 2000, 4000), (0.02, 4200, 5000)]
ACGT = np.frombuffer(b"ACGT", np.uint8)


def mutate(rng: np.random.Generator, seq: np.ndarray, sub: float = 0.02,
           ins: float = 0.01, dele: float = 0.01) -> np.ndarray:
    """A copy of base codes `seq` (0-3) with substitutions to a random
    base, deleted bases, and a random base inserted after a kept base."""
    n = len(seq)
    r = rng.random(n)
    out = np.where((r >= dele) & (r < dele + sub),
                   rng.integers(0, 4, n), seq).astype(np.uint8)
    keep = r >= dele
    extra = keep & (rng.random(n) < ins)
    reps = keep.astype(np.int64) + extra
    res = np.repeat(out, reps)
    res[np.cumsum(reps)[extra] - 1] = rng.integers(0, 4, int(extra.sum()))
    return res


def _text(codes: np.ndarray) -> str:
    return ACGT[codes].tobytes().decode("ascii")


def build_ins_fixture(out_dir: str, n_sites: int = 2000, seed: int = 0):
    """Write the fixture; returns (bam, vcf, sites)."""
    rng = np.random.default_rng(seed)
    os.makedirs(out_dir, exist_ok=True)
    bam = os.path.join(out_dir, "ins.bam")
    vcf = os.path.join(out_dir, "ins.vcf")
    shares = np.array([c[0] for c in LENGTH_CLASSES])
    reads, sites = [], []
    for s in range(n_sites):
        pos = (s + 1) * SPACING  # 1-based VCF POS
        cls = int(rng.choice(len(LENGTH_CLASSES), p=shares / shares.sum()))
        _, lo, hi = LENGTH_CLASSES[cls]
        alleles = [rng.integers(0, 4, int(rng.integers(lo, hi + 1)))]
        depth = 2 if rng.random() < 0.05 else int(rng.integers(8, 21))
        if depth > 2 and rng.random() < 0.10:
            longer = len(alleles[0]) + max(30, len(alleles[0]) // 3)
            alleles.append(rng.integers(0, 4, longer))
        for _ in range(depth):
            allele = alleles[1] if len(alleles) > 1 and \
                rng.random() < 0.4 else alleles[0]
            lead = int(rng.integers(500, 2001))
            # The I op lands within 2 bp of POS - 1 (0-based).
            start0 = pos - 1 - lead + int(rng.integers(-2, 3))
            tail = int(rng.integers(500, 1501))
            insert = mutate(rng, allele)
            seq = np.concatenate([rng.integers(0, 4, lead), insert,
                                  rng.integers(0, 4, tail)])
            reads.append((start0, [(CIGAR_M, lead), (CIGAR_I, len(insert)),
                                   (CIGAR_M, tail)], seq))
        for _ in range(4):  # spanning reads without an insert
            start0 = pos - 1 - int(rng.integers(500, 2501))
            span = int(rng.integers(3000, 4501))
            reads.append((start0, [(CIGAR_M, span)],
                          rng.integers(0, 4, span)))
        sites.append({"pos": pos, "class": cls, "length": len(alleles[0]),
                      "reads": depth, "alleles": len(alleles)})
    reads.sort(key=lambda r: r[0])
    with BamWriter(bam, [("1", (n_sites + 2) * SPACING)]) as w:
        for i, (start0, cigar, seq) in enumerate(reads):
            w.write(BamRecord(name=f"r{i}", flag=0, tid=0, pos=start0,
                              mapq=60, cigar=cigar, seq=_text(seq)))
    with open(vcf, "w") as fh:
        fh.write("##fileformat=VCFv4.2\n")
        fh.write('##INFO=<ID=SVTYPE,Number=1,Type=String,Description="x">\n')
        fh.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n")
        for s, site in enumerate(sites):
            fh.write(f"1\t{site['pos']}\tins{s}\tN\t<INS>\t.\tPASS\t"
                     f"SVTYPE=INS;END={site['pos']}\n")
    with open(os.path.join(out_dir, "sites.json"), "w") as fh:
        json.dump(sites, fh)
    return bam, vcf, sites


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("dir")
    ap.add_argument("--sites", type=int, default=2000)
    ap.add_argument("--seed", type=int, default=0)
    a = ap.parse_args()
    print(build_ins_fixture(a.dir, a.sites, a.seed)[:2])
