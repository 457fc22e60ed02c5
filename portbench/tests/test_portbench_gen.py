"""The generator: the same seed gives the same files, and the reads hold
what the configuration says, read back by the frozen reference's decode."""
import hashlib
import json
import os

import numpy as np
import pytest

from conftest import PB

import harness  # noqa: E402

GEN = os.path.join(PB, "gen")


def tiny(name: str, loci: int = 6) -> dict:
    cfg = json.load(open(os.path.join(PB, "configs", name + ".json")))
    cfg.update(loci=loci, replays=2)
    return cfg


def build(cfg, seed, out):
    import sys

    sys.path.insert(0, GEN)
    import hg002

    os.makedirs(out, exist_ok=True)
    return hg002.build(cfg, seed, out, threads=2)


def digest(path):
    return hashlib.sha256(open(path, "rb").read()).hexdigest()


@pytest.mark.parametrize("name", ["hg002-hifi", "hg002-ont"])
def test_same_seed_same_files(tmp_path, name):
    a = build(tiny(name), 2**31 + 5, str(tmp_path / "a"))
    b = build(tiny(name), 2**31 + 5, str(tmp_path / "b"))
    c = build(tiny(name), 2**31 + 6, str(tmp_path / "c"))
    for key in ("bam", "vcf", "loci_vcf"):
        assert digest(a[key]) == digest(b[key])
    assert digest(a["bam"] + ".bai") == digest(b["bam"] + ".bai")
    assert digest(a["bam"]) != digest(c["bam"])


def test_composition_is_the_seeds_order_only(tmp_path):
    """Every seed has the same sites (kind, length, hom, the VCF's offsets
    of POS and END from the truth) in another order, with each length
    class's share and the hom share of the configuration, so a seed does
    not change the insert lengths or the sites that refine, which set the
    consensus's work."""
    cfg = tiny("hg002-hifi", loci=40)
    cs = cfg["callset"]

    def sites(seed):
        loci = build(cfg, seed, str(tmp_path / str(seed)))["loci"]
        return [(lc["kind"], lc["length"], lc["hom"], lc["pos"] - lc["bp"],
                 lc["end"] - lc["bp"]) for lc in loci]

    a, b = sites(1), sites(2**31 + 99)
    assert sorted(a) == sorted(b) and a != b
    assert sum(s[2] for s in a) == round(40 * cs["hom_share"])
    ins = [s[1] for s in a if s[0] == "INS"]
    assert len(ins) == round(40 * cs["ins_share"])
    for share, lo, hi in cs["ins_classes"]:
        assert abs(sum(lo <= n <= hi for n in ins) - share * len(ins)) < 1


@pytest.mark.parametrize("name", ["hg002-hifi", "hg002-ont"])
def test_reads_hold_the_variants(tmp_path, name):
    cfg = tiny(name)
    fx = build(cfg, 77, str(tmp_path))
    ref = harness.load_mode("audt").load_reference()
    bam = ref.Bam(fx["bam"], with_seq=True)
    rd = cfg["reads"]
    lens = []
    for lc in fx["loci"]:
        b, n = lc["bp"], lc["length"]
        reads = bam.fetch(0, b - 1000, b + 1000)
        depth = len(bam.fetch(0, b - 5000, b - 4999))
        assert rd["depth"] // 2 <= depth <= rd["depth"] * 2
        op = ref.OP_I if lc["kind"] == "INS" else ref.OP_D
        hits = []
        for pos, _, ops, ln, l_seq, _ in reads:
            qlen = int(ln[np.isin(ops, ref.QUERY_OPS)].sum())
            assert qlen == l_seq
            lens.append(qlen)
            at = pos + np.concatenate(([0], np.cumsum(
                np.where(np.isin(ops, (ref.OP_I, ref.OP_S)), 0, ln))))[:-1]
            big = (ops == op) & (ln >= 50)
            hits += [(int(a), int(x)) for a, x in zip(at[big], ln[big])]
        assert hits, lc
        for a, x in hits:
            assert abs(a - b) <= 2
            if op == ref.OP_D:
                assert x == n
        # the consensus of an insert's copies is its allele's length
        if lc["kind"] == "INS" and n <= 400:
            seqs = ref.ins_seqs(bam, 0, b - 3, b + 3)
            assert abs(len(ref.star_consensus(seqs)) - n) <= max(3, n // 20)
    slack = 1.2  # indels and clips move a read's SEQ from its span
    assert rd["len_min"] / slack <= min(lens)
    assert max(lens) <= rd["len_max"] * slack + 600


def test_vcf_replays_the_loci(tmp_path):
    fx = build(tiny("hg002-hifi"), 3, str(tmp_path))
    rows = [x for x in open(fx["vcf"]) if not x.startswith("#")]
    once = [x for x in open(fx["loci_vcf"]) if not x.startswith("#")]
    assert rows == once * 2
    pos = [int(x.split("\t")[1]) for x in once]
    assert pos == sorted(pos)
