#!/usr/bin/env python
"""Independent scalar `disc`: GFA + GAF + FASTQ -> disc's result lines.

A short restatement of the disc mode of `svtrek_tpu` in plain Python, for
holding a port's output to it (`chip_smoke.py` holds the PyTorch port's
to it on the card).  What it shares with the port is the Python GAF
projection only, the port's copy of the JAX package's:
`io.gaf.iter_gaf` and the scalar run scan `io.gaf.scan_breakpoints`, which
the packages' main paths do not run (they project with the native C
library and scan on the device), and `io.gfa.parse_gfa`, which the port's
disc path runs too.  A fault in the port's copy of parse_gfa would
therefore pass the check against this tool; what guards that copy is
tests/test_torch_standalone.py, which holds it equal to the JAX package's
on the CPU.  Its own:

- single-linkage clustering per type (INS, DEL, CLIP): signals sorted by
  (position, length) chain while each gap is <= the cluster window, and a
  chain of at least min_count signals is a cluster at the rounded means
  (total + n/2)/n of its positions and lengths;
- the FASTQ scan and the inserted substring of each supporting read
  (reverse-complemented for a '<' path);
- for the chosen clusters, the star consensus of the benchmark's plain
  reference, portbench/reference/audt_scalar.py;
- the lines `(DISC T) ref pos: P, len: L, support: N[, seq: S|NA]`, sorted
  by type name, then position.

    python tools/disc_scalar.py GFA GAF FASTQ
"""
from __future__ import annotations

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "portbench", "reference"), ROOT]

from audt_scalar import star_consensus  # noqa: E402

MIN_LEN, MIN_COUNT, WINDOW = 50, 3, 100
_COMP = str.maketrans("ACGTacgtNn", "TGCAtgcaNn")


def signals(gfa_path: str, gaf_path: str, min_len: int = MIN_LEN):
    """Every read's breakpoints as (type, ref_pos, read_pos, length, name,
    rc) tuples, in file order, from the Python projection."""
    from svtrek_tpu_torch.io.gaf import iter_gaf, scan_breakpoints
    from svtrek_tpu_torch.io.gfa import parse_gfa

    gfa = parse_gfa(gfa_path)
    return [(b.type, b.ref_pos, b.read_pos, b.length, b.read_name, b.rc)
            for p in iter_gaf(gaf_path, gfa)
            for b in scan_breakpoints(p, min_len)]


def clusters(sigs, min_count: int = MIN_COUNT, window: int = WINDOW):
    """[(type, pos, length, support, members)] in output order."""
    out = []
    for t in ("INS", "DEL", "CLIP"):
        chain: list = []
        for s in sorted((s for s in sigs if s[0] == t),
                        key=lambda s: (s[1], s[3])) + [None]:
            if chain and (s is None or s[1] - chain[-1][1] > window):
                n = len(chain)
                if n >= min_count:
                    out.append((t, (sum(c[1] for c in chain) + n // 2) // n,
                                (sum(c[3] for c in chain) + n // 2) // n, n,
                                chain))
                chain = []
            if s is not None:
                chain.append(s)
    return sorted(out, key=lambda c: (c[0], c[1]))


def inserts(fq_path: str, wanted: dict) -> dict:
    """{cluster index: [inserted substrings]} in FASTQ order; ``wanted``
    maps a read name to its [(cluster index, signal)]."""
    got: dict = {}
    with open(fq_path) as fh:
        while True:
            head, seq = fh.readline(), fh.readline()
            fh.readline()
            fh.readline()
            if not head:
                break
            toks = head[1:].split()
            for ci, s in wanted.get(toks[0] if toks else "", ()):
                read = seq.rstrip("\r\n")
                if s[5]:
                    read = read.translate(_COMP)[::-1]
                sub = read[s[2]:s[2] + s[3]]
                if sub:
                    got.setdefault(ci, []).append(sub)
    return got


def disc_lines(fq_path: str, cl, seq_clusters=None,
               consensus=star_consensus) -> list[str]:
    """The result lines of clusters ``cl``; INS lines carry `, seq:` only
    for the cluster indices in ``seq_clusters`` (all when None), the
    ``consensus`` of the cluster's inserts (by default the star
    consensus)."""
    chosen = {i for i, c in enumerate(cl) if c[0] == "INS"
              and (seq_clusters is None or i in seq_clusters)}
    wanted: dict = {}
    for i in sorted(chosen):
        for s in cl[i][4]:
            wanted.setdefault(s[4], []).append((i, s))
    subs = inserts(fq_path, wanted) if wanted else {}
    lines = []
    for i, (t, pos, ln, n, _) in enumerate(cl):
        line = f"(DISC {t}) ref pos: {pos}, len: {ln}, support: {n}"
        if i in chosen:
            line += f", seq: {consensus(subs.get(i, [])) or 'NA'}"
        lines.append(line)
    return lines


def main():
    if len(sys.argv) != 4:
        sys.exit(__doc__.rsplit("\n\n", 1)[-1])
    gfa, gaf, fq = sys.argv[1:]
    for line in disc_lines(fq, clusters(signals(gfa, gaf))):
        print(line)


if __name__ == "__main__":
    main()
