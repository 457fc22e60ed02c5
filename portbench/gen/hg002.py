"""Generator `hg002`: an HG002-shaped SV callset and long reads around it.

One chromosome holds ``loci`` DEL and INS sites about ``spacing`` apart.
Every seed gets the same sites, as (kind, length, hom or het, the VCF's
offsets from the truth), in another order: each length class holds its
share of the sites at lengths spread evenly over the class, the hom sites
are spread evenly over each kind's lengths, and the offsets come from a
generator seeded alike for every seed.  So the insert lengths and the
sites that refine, which set the consensus's work, do not move with the
seed; the reads around each site do.  The VCF gives a
site as an imprecise call, POS and END moved from the truth by
tools/simvcf.py's `jitter` (a random sign each, drawn once for all seeds:
an INS whose POS lies before its breakpoint does not refine, so the
signs set how many sites take the consensus).  Reads are drawn only
where audt's windows reach: the depth's share of reads at uniform starts
over the site's region, normal read lengths, from the ALT haplotype with
probability 1 (hom) or 1/2 (het):

- a DEL read that spans the junction with ``flank_min`` bases each side
  carries the D op; one with a shorter flank is soft-clipped there;
- an INS read that holds the whole insert with ``flank_min`` bases each
  side carries the I op and, in SEQ, a copy of the site's allele mutated
  as tools/ins_fixture.py's `mutate` does; a shorter flank is soft-clipped;
- the variant op sits at the breakpoint +-2 bp (ins_fixture's rule);
- between them, background noise: M runs of geometric length
  (``m_mean``), each followed by an I or a D of 1..``indel_max`` bases, the
  op mix of tools/torch_fixtures.py's `noisy_cigar` at the configured rate,
  and a soft clip of 20-300 bases at either end of 30 % of the reads, as
  `noisy_cigar` has;
- SEQ is random ACGT, QUAL is drawn from the configured binned alphabet.

The VCF written for the window lists the loci ``replays`` times over, each
copy in positional order; a second VCF lists them once (the warm pass and
the reference).  Every other draw comes from one numpy Generator seeded
with the run's seed, in a fixed order, so a seed gives the same files.
"""
from __future__ import annotations

import os
import time

import numpy as np

from bamio import NT4, encode_records, pack_seq, write_bam

OP_M, OP_I, OP_D, OP_S = 0, 1, 2, 4
FIXED_SEED = 16  # the offsets' own generator: the same for every run seed
# Each 4-bit value x packs bases x >> 2 and x & 3 into one SEQ byte.
PAIR16 = ((NT4[np.arange(16) >> 2] << 4) | NT4[np.arange(16) & 3]) \
    .astype(np.uint8)


def mutate(rng: np.random.Generator, seq: np.ndarray, sub: float,
           ins: float, dele: float) -> np.ndarray:
    """A copy of base codes ``seq`` with substitutions, deletions and a
    random base inserted after a kept base (tools/ins_fixture.py)."""
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


def jitter(rng: np.random.Generator, sv_len: np.ndarray) -> np.ndarray:
    """tools/simvcf.py's |rand * len * 0.06 + len * 0.01| + 25, signed."""
    mag = np.abs((rng.random(len(sv_len)) * sv_len * 0.06
                  + sv_len * 0.01).astype(np.int64)) + 25
    return np.where(rng.random(len(sv_len)) < 0.5, -mag, mag)


def split(total: int, shares) -> np.ndarray:
    """``total`` cut in proportion to ``shares`` (largest remainders)."""
    share = np.asarray(shares, float) / sum(shares)
    exact = share * total
    out = np.floor(exact).astype(np.int64)
    out[np.argsort(out - exact)[:total - int(out.sum())]] += 1
    return out


def class_lengths(classes, n: int) -> np.ndarray:
    """n lengths, ascending: each class holds its share of them exactly,
    spread evenly over its [lo, hi]."""
    count = split(n, [c[0] for c in classes])
    return np.sort(np.concatenate(
        [lo + (hi - lo) * (2 * np.arange(k) + 1) // (2 * k)
         for (_, lo, hi), k in zip(classes, count.tolist())]))


def even_pick(m: int, h: int) -> np.ndarray:
    """A mask of h of m ranks, spread evenly over them."""
    r = np.arange(m)
    return (r + 1) * h // m > r * h // m


def noise_pool(rng, spans: np.ndarray, m_mean: float, indel_max: int):
    """Background CIGARs of exact reference spans ``spans`` (each >= 1),
    cut from one pool of noise.

    The pool is a run of (M, I or D) pairs: M of geometric length
    (mean ``m_mean``), then an I or a D of 1..``indel_max`` bases.  Segment
    i starts at a random pair of the pool and keeps the pairs that end
    at least one base before spans[i], then a last M that fills the span.
    Returns (enc, start, count, last, query_len): segment i's ops are the
    flattened pairs enc[start[i]:start[i] + count[i]] and an M of
    last[i], as uint32 (len << 4 | op)."""
    spans = np.asarray(spans, np.int64)
    per = m_mean + (indel_max + 1) / 4.0
    widest = int(spans.max(initial=1) / per * 2 + 64)
    size = max(1 << 20, 8 * widest)
    m = rng.geometric(1.0 / m_mean, size).astype(np.int64)
    is_d = rng.random(size) < 0.5
    x = rng.integers(1, indel_max + 1, size)
    ref = np.concatenate(([0], np.cumsum(m + np.where(is_d, x, 0))))
    qry = np.concatenate(([0], np.cumsum(m + np.where(is_d, 0, x))))
    enc = np.empty((size, 2), np.uint32)
    enc[:, 0] = (m << 4) | OP_M
    enc[:, 1] = (x << 4) | np.where(is_d, OP_D, OP_I)
    start = rng.integers(0, size - widest, len(spans))
    # Pairs kept: those whose end lies at or before span - 1.
    stop = np.searchsorted(ref, ref[start] + spans - 1, "right") - 1
    count = stop - start
    if (stop >= size).any():
        raise ValueError("noise pool too small for a segment")
    last = spans - (ref[stop] - ref[start])
    return enc, start, count, last, qry[stop] - qry[start] + last


def _records(cfg: dict, rng: np.random.Generator):
    """The loci and their VCF fields, and every read as (ref start,
    pieces, insert copy or None, offset of the insert in the query)."""
    cs, rd = cfg["callset"], cfg["reads"]
    n_loci = cfg["loci"]
    # Every seed has the same sites (kind, length, hom); the seed draws
    # their order, places and reads.
    n_ins = int(split(n_loci, [cs["ins_share"], 1 - cs["ins_share"]])[0])
    n_del = n_loci - n_ins
    n_hom = int(split(n_loci, [cs["hom_share"], 1 - cs["hom_share"]])[0])
    h_ins, h_del = split(n_hom, [n_ins, n_del]).tolist()
    order = rng.permutation(n_loci)
    is_ins = (np.arange(n_loci) < n_ins)[order]
    hom = np.concatenate((even_pick(n_ins, h_ins),
                          even_pick(n_del, h_del)))[order]
    # The VCF's offsets from the truth belong to the sites too: their
    # signs and sizes decide which records refine (an INS whose POS lies
    # before its breakpoint does not), and so the work of a pass.  They
    # come from a generator of their own, seeded alike for every seed.
    fixed = np.random.default_rng(FIXED_SEED)
    canon_len = np.concatenate((class_lengths(cs["ins_classes"], n_ins),
                                class_lengths(cs["del_classes"], n_del)))
    jit_pos = jitter(fixed, canon_len)[order]
    jit_end = jitter(fixed, canon_len)[order]
    sv_len = canon_len[order]
    spacing = cs["spacing"]
    bp = cs["first_pos"] + np.arange(n_loci) * spacing \
        + rng.integers(0, spacing // 4, n_loci)
    pos = bp + 1 + jit_pos
    end = np.where(is_ins, pos, bp + 1 + sv_len + jit_end)
    loci = [dict(kind="INS" if is_ins[i] else "DEL", bp=int(bp[i]),
                 length=int(sv_len[i]), hom=bool(hom[i]), pos=int(pos[i]),
                 end=int(end[i])) for i in range(n_loci)]

    flank, depth = rd["flank_min"], rd["depth"]
    mut = rd["insert_mutation"]
    reads = []
    for lc in loci:
        b, n = lc["bp"], lc["length"]
        if lc["kind"] == "INS":
            lo, hi, alt_extra = b - 11000, b + 11000, n
            allele = rng.integers(0, 4, n).astype(np.uint8)
        else:
            lo, hi, alt_extra = b - 21000, b + n + 3000, -n
        count = round(depth * (hi - lo + rd["len_mean"]) / rd["len_mean"])
        lens = np.clip(rng.normal(rd["len_mean"], rd["len_sd"], count),
                       rd["len_min"], rd["len_max"]).astype(np.int64)
        alt = rng.random(count) < (1.0 if lc["hom"] else 0.5)
        starts = rng.integers(lo - lens, hi + max(alt_extra, 0) * alt)
        delta = rng.integers(-2, 3, count)
        clip_l = np.where(rng.random(count) < rd["end_clip_share"],
                          rng.integers(20, 301, count), 0)
        clip_r = np.where(rng.random(count) < rd["end_clip_share"],
                          rng.integers(20, 301, count), 0)
        for s, r, a, d, cl, cr in zip(starts.tolist(), lens.tolist(),
                                      alt.tolist(), delta.tolist(),
                                      clip_l.tolist(), clip_r.tolist()):
            e = s + r
            if not a or e <= b:
                reads.append((s, [("S", cl), ("G", r), ("S", cr)], None))
                continue
            if lc["kind"] == "DEL":
                if s >= b:
                    reads.append((s + n, [("S", cl), ("G", r), ("S", cr)],
                                  None))
                    continue
                left, right = b - s + d, e - b - d
                if left >= flank and right >= flank:
                    pieces = [("S", cl), ("G", left), ("D", n),
                              ("G", right), ("S", cr)]
                elif left >= flank:
                    pieces = [("S", cl), ("G", left), ("S", right)]
                else:
                    reads.append((b + d + n, [("S", left), ("G", right),
                                              ("S", cr)], None))
                    continue
                reads.append((s, pieces, None))
                continue
            if s >= b + n:  # INS: past the insert on the ALT haplotype
                reads.append((s - n, [("S", cl), ("G", r), ("S", cr)], None))
                continue
            left = max(0, b - s) + d
            right = max(0, e - (b + n)) - d
            part = r - max(0, b - s) - max(0, e - (b + n))
            if left >= flank and right >= flank:
                copy = mutate(rng, allele, *mut)
                reads.append((s, [("S", cl), ("G", left),
                                  ("I", len(copy)), ("G", right),
                                  ("S", cr)], copy))
            elif left >= flank:
                reads.append((s, [("S", cl), ("G", left),
                                  ("S", part + max(right, 0))], None))
            elif right >= flank:
                reads.append((b + d, [("S", max(left, 0) + part),
                                      ("G", right), ("S", cr)], None))
            # else: mostly insert, no anchor that an aligner would keep
    return loci, reads


def _assemble(cfg, rng, reads):
    """CIGARs, reference ends, query lengths and insert offsets."""
    rd = cfg["reads"]
    spans = [ln for _, pieces, _ in reads for kind, ln in pieces
             if kind == "G"]
    enc, seg0, segn, seg_last, seg_q = noise_pool(
        rng, np.array(spans, np.int64), rd["m_mean"], rd["indel_max"])
    cigars, ends, qlens, ins_at = [], [], [], []
    k = 0
    code = {"S": OP_S, "D": OP_D, "I": OP_I}
    for start, pieces, copy in reads:
        parts, q, ref, at = [], 0, 0, -1
        for kind, ln in pieces:
            if kind == "G":
                parts.append(enc[seg0[k]:seg0[k] + segn[k]].ravel())
                parts.append(np.array([(int(seg_last[k]) << 4) | OP_M],
                                      np.uint32))
                q += int(seg_q[k])
                ref += ln
                k += 1
            elif ln > 0:
                if kind == "I":
                    at = q
                parts.append(np.array([(ln << 4) | code[kind]], np.uint32))
                q += ln if kind != "D" else 0
                ref += ln if kind == "D" else 0
        cigars.append(np.concatenate(parts))
        ends.append(start + ref)
        qlens.append(q)
        ins_at.append(at)
    return cigars, np.array(ends, np.int64), np.array(qlens, np.int64), \
        ins_at


def write_vcf(path: str, loci, copies: int) -> None:
    rows = []
    for i, lc in enumerate(loci):
        svlen = lc["length"] if lc["kind"] == "INS" else -lc["length"]
        rows.append(f"1\t{lc['pos']}\tL{i}\tN\t<{lc['kind']}>\t.\tPASS\t"
                    f"SVTYPE={lc['kind']};END={lc['end']};SVLEN={svlen}\t"
                    f"GT\t{'1/1' if lc['hom'] else '0/1'}\n")
    with open(path, "w") as fh:
        fh.write("##fileformat=VCFv4.2\n"
                 '##INFO=<ID=SVTYPE,Number=1,Type=String,Description="x">\n'
                 "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
                 "HG002\n")
        for _ in range(copies):
            fh.writelines(rows)


def build(cfg: dict, seed: int, out_dir: str, threads: int = 8) -> dict:
    """Write out_dir/reads.bam (+ .bai), out_dir/calls.vcf (the loci
    ``replays`` times) and out_dir/loci.vcf (once); returns their paths
    and the fixture's sizes."""
    clock = [time.perf_counter()]

    def lap():
        clock.append(time.perf_counter())
        return round(clock[-1] - clock[-2], 3)

    rng = np.random.default_rng(seed % 2**63)
    loci, reads = _records(cfg, rng)
    order = sorted(range(len(reads)), key=lambda i: reads[i][0])
    reads = [reads[i] for i in order]
    t_reads = lap()
    cigars, ends, qlens, ins_at = _assemble(cfg, rng, reads)
    t_cigar = lap()
    # SEQ and QUAL: each read's bytes are cut at a random offset from a
    # pool of random bytes (16 MiB or more, so deflate's 32 KiB window never
    # meets a repeat); a read with an insert copy gets SEQ of its own.
    n_reads = len(reads)
    width = int(qlens.max(initial=1))
    size = max(1 << 24, 4 * width)
    seq_pool = PAIR16[rng.integers(0, 16, size, dtype=np.uint8)]
    bins, weights = zip(*cfg["reads"]["qual_bins"])
    cdf = np.cumsum(np.array(weights, float) / sum(weights))
    table = np.array(bins, np.uint8)[np.minimum(
        np.searchsorted(cdf, (np.arange(256) + 0.5) / 256), len(bins) - 1)]
    qual_pool = table[rng.integers(0, 256, size, dtype=np.uint8)]
    s_at = rng.integers(0, size - width, n_reads).tolist()
    q_at = rng.integers(0, size - width, n_reads).tolist()
    seqs, quals = [], []
    for i, (_, _, copy) in enumerate(reads):
        ql = int(qlens[i])
        quals.append(qual_pool[q_at[i]:q_at[i] + ql].tobytes())
        if copy is not None:
            codes = rng.integers(0, 4, ql).astype(np.uint8)
            codes[ins_at[i]:ins_at[i] + len(copy)] = copy
            seqs.append(pack_seq(codes))
            continue
        seq = seq_pool[s_at[i]:s_at[i] + (ql + 1) // 2].tobytes()
        if ql % 2:  # the last byte holds one base
            seq = seq[:-1] + bytes((seq[-1] & 0xF0,))
        seqs.append(seq)
    t_seq = lap()
    starts = np.array([r[0] for r in reads], np.int64)
    bam = os.path.join(out_dir, "reads.bam")
    pieces = encode_records(starts, ends, cigars, seqs, quals)
    t_encode = lap()
    write_bam(bam, "1", cfg["callset"]["chrom_len"], starts, ends, *pieces,
              threads)
    t_write = lap()
    calls = os.path.join(out_dir, "calls.vcf")
    once = os.path.join(out_dir, "loci.vcf")
    write_vcf(calls, loci, cfg["replays"])
    write_vcf(once, loci, 1)
    # Written back now, in set-up: left dirty, the kernel would write the
    # files back some 30 s later, inside the measured window.
    for path in (bam, bam + ".bai", calls, once):
        fd = os.open(path, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)
    t_sync = lap()
    return dict(bam=bam, vcf=calls, loci_vcf=once, loci=loci,
                reads=len(reads), bases=int(qlens.sum()),
                cigar_ops=int(sum(len(c) for c in cigars)),
                bam_bytes=os.path.getsize(bam),
                stage_s=dict(reads=t_reads, cigar=t_cigar, seq_qual=t_seq,
                             encode=t_encode, deflate_write=t_write,
                             sync=t_sync))
