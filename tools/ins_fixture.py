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

    python tools/ins_fixture.py DIR --spread [--sites N] [--seed S]

writes the spread-length sites of `build_spread_fixture` instead (40 by
default): a synthetic stress shape for K2's wide class, not a measured
traffic mix.  Each site is a tandem-repeat insertion whose reads' insert
lengths spread evenly over +-20 % of the site's median, so that the star
consensus aligns its median seed with members 600-680 bases longer and
shorter.  The spread and its share of a callset's sites are chosen, not
taken from a study.
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


def _supporting_read(rng: np.random.Generator, pos: int, allele):
    """A read that carries a mutated copy of `allele` at its I op, within
    2 bp of 1-based `pos`, between random flanks; (start0, cigar, seq)."""
    lead = int(rng.integers(500, 2001))
    # The I op lands within 2 bp of POS - 1 (0-based).
    start0 = pos - 1 - lead + int(rng.integers(-2, 3))
    tail = int(rng.integers(500, 1501))
    insert = mutate(rng, allele)
    seq = np.concatenate([rng.integers(0, 4, lead), insert,
                          rng.integers(0, 4, tail)])
    return start0, [(CIGAR_M, lead), (CIGAR_I, len(insert)),
                    (CIGAR_M, tail)], seq


def _spanning_reads(rng: np.random.Generator, pos: int):
    """4 reads that span 1-based `pos` without an insert."""
    out = []
    for _ in range(4):
        start0 = pos - 1 - int(rng.integers(500, 2501))
        span = int(rng.integers(3000, 4501))
        out.append((start0, [(CIGAR_M, span)], rng.integers(0, 4, span)))
    return out


def _write(out_dir: str, reads, sites):
    """DIR/ins.bam (+ .bai) of `reads` sorted by position, DIR/ins.vcf with
    an INS record at each site's pos, and DIR/sites.json; returns (bam,
    vcf, sites)."""
    bam = os.path.join(out_dir, "ins.bam")
    vcf = os.path.join(out_dir, "ins.vcf")
    reads.sort(key=lambda r: r[0])
    with BamWriter(bam, [("1", (len(sites) + 2) * SPACING)]) as w:
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


def build_ins_fixture(out_dir: str, n_sites: int = 2000, seed: int = 0):
    """Write the fixture; returns (bam, vcf, sites)."""
    rng = np.random.default_rng(seed)
    os.makedirs(out_dir, exist_ok=True)
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
            reads.append(_supporting_read(rng, pos, allele))
        reads += _spanning_reads(rng, pos)
        sites.append({"pos": pos, "class": cls, "length": len(alleles[0]),
                      "reads": depth, "alleles": len(alleles)})
    return _write(out_dir, reads, sites)


def build_spread_fixture(out_dir: str, n_sites: int = 40, seed: int = 0, *,
                         median: tuple[int, int] = (3000, 3400),
                         spread: float = 0.2,
                         depth: tuple[int, int] = (12, 20)):
    """Write the spread-length fixture; returns (bam, vcf, sites).

    Site s lies at (s + 1) * SPACING, as in `build_ins_fixture`.  Each has
    a random repeat unit of 30-60 bases (bounds inclusive), a median
    length drawn from `median` and a read count from `depth`.  Read r's
    insert is the unit repeated to length median * (1 - spread + 2 *
    spread * r / (reads - 1)), rounded (so the lengths are evenly spaced
    over +-spread of the median, in a random order), then mutated as
    `mutate` does; the flanks and the 4 spanning reads are the ins
    fixture's.  At the defaults the sorted lengths step by at most 124
    bases, under the majority length mode's link of 10 % of the shorter
    (at least 240), so every read stays a member, and the farthest sit
    600-680 bases from the median seed.  sites.json lists per site its
    position, unit, median, read count and its shortest and longest
    insert before mutation."""
    rng = np.random.default_rng(seed)
    os.makedirs(out_dir, exist_ok=True)
    reads, sites = [], []
    for s in range(n_sites):
        pos = (s + 1) * SPACING  # 1-based VCF POS
        rep = rng.integers(0, 4, int(rng.integers(30, 61)))
        mid = int(rng.integers(median[0], median[1] + 1))
        count = int(rng.integers(depth[0], depth[1] + 1))
        lengths = np.rint(mid * (1 - spread + 2 * spread * np.arange(count)
                                 / (count - 1))).astype(np.int64)
        for length in rng.permutation(lengths).tolist():
            reads.append(_supporting_read(rng, pos, np.resize(rep, length)))
        reads += _spanning_reads(rng, pos)
        sites.append({"pos": pos, "unit": len(rep), "median": mid,
                      "reads": count, "shortest": int(lengths[0]),
                      "longest": int(lengths[-1])})
    return _write(out_dir, reads, sites)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("dir")
    ap.add_argument("--sites", type=int,
                    help="sites (default 2000; with --spread, 40)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--spread", action="store_true",
                    help="the spread-length sites of build_spread_fixture")
    a = ap.parse_args()
    if a.spread:
        print(build_spread_fixture(a.dir, a.sites or 40, a.seed)[:2])
    else:
        print(build_ins_fixture(a.dir, a.sites or 2000, a.seed)[:2])
