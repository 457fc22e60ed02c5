"""The staged BGZF inflate of the producer pool's batch fetches: the C
reader stages the blocks a fetch's walk can read (`svbam_stage_attach`,
`NativeBamReader.stage_inflate`) and `kernels.bgzf_inflate` inflates them
a slice at a time (the kernel on a card, zlib a block on the CPU).

On the CPU: the staged fetches return what the lazy walk returns, their
block set covers every block the walk reads (no block left to zlib) within
1.35x of its bytes, a corrupt block raises the lazy path's error, the
counters keep their meaning, and the plain version (zlib a block) judges
each stream as zlib does.  On a card (the `card` marker; skipped without
one): the kernel against the plain version, bit for bit.
"""
from __future__ import annotations

import dataclasses
import io
import json
import os
import random
import sys
import zlib

import numpy as np
import pytest
import torch

from svtrek_tpu_torch import constants as C
from svtrek_tpu_torch import kernels
from svtrek_tpu_torch.config import AudtConfig
from svtrek_tpu_torch.native import native_bam_reader
from svtrek_tpu_torch.native.bamlib import (
    NativeBamError, NativeBamReader, ReaderCounters,
)
from svtrek_tpu_torch.pipeline import audit as taudit
from tests.fixtures import PlantedSV, write_fixture

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "portbench", "gen"),
                os.path.join(ROOT, "portbench")]

import bamio  # noqa: E402
import hg002  # noqa: E402

CHROM_LEN = 300_000
BLOCK = kernels.BGZF_BLOCK_BYTES


@pytest.fixture(scope="module")
def planted(tmp_path_factory):
    d = tmp_path_factory.mktemp("inflate_planted")
    svs = [PlantedSV(1, 50_000, 50_400, "DEL", 400),
           PlantedSV(1, 120_000, 120_001, "INS", 120),
           PlantedSV(1, 180_000, 180_300, "INV", 300),
           PlantedSV(2, 60_000, 60_200, "DEL", 200)]
    return write_fixture(str(d), svs, {1: CHROM_LEN, 2: 150_000}, seed=5)


@pytest.fixture(scope="module")
def hifi(tmp_path_factory):
    """A tiny hg002-hifi BAM of the benchmark's generator (12 loci): reads
    of 13.5 kb, records across block boundaries."""
    d = tmp_path_factory.mktemp("inflate_hifi")
    cfg = json.load(open(os.path.join(ROOT, "portbench", "configs",
                                      "hg002-hifi.json")))
    cfg.update(loci=12, replays=1)
    return hg002.build(cfg, 2**31 + 77, str(d), threads=2)


@pytest.fixture(scope="module")
def crossing(tmp_path_factory):
    """A BAM, cut into blocks by hand, in which a window [20,000, 32,768)
    stops at a record whose 36-byte prefix lies in two blocks: the long
    read at 33,000 (level-4 bin 585) starts its chunk 20 bytes before a
    block's end; the short read at 32,900, in a bin that starts at the
    window's end, is the index's bound (bins_past) before it."""
    d = str(tmp_path_factory.mktemp("inflate_crossing"))
    rng = np.random.default_rng(3)
    pos = np.sort(np.concatenate([rng.integers(1000, 32_500, 300),
                                  [32_900, 33_000],
                                  rng.integers(33_100, 60_000, 300)]))
    length = np.full(len(pos), 150)
    at = int(np.flatnonzero(pos == 33_000)[0])
    length[at] = 17_000  # across 49,152: bin 585
    cigars = [np.array([(int(n) << 4) | 0], np.uint32) for n in length]
    seqs = [bamio.pack_seq(rng.integers(0, 4, int(n))) for n in length]
    quals = [bytes(rng.integers(0, 40, int(n)).astype(np.uint8))
             for n in length]
    ends = pos + length
    pieces, sizes = bamio.encode_records(pos, ends, cigars, seqs, quals)
    head = bamio.header_bytes("1", 100_000)
    stream = b"".join([head, *pieces])
    ubeg = len(head) + np.concatenate(([0], np.cumsum(sizes)[:-1]))
    cut = int(ubeg[at]) + 20
    cuts = np.array(sorted({*range(0, len(stream), 60_000), cut}))
    comp = [bamio._deflate(stream[a:b]) for a, b in
            zip(cuts, [*cuts[1:], len(stream)])]
    coff = np.concatenate(([0], np.cumsum([len(c) for c in comp])))
    bam = os.path.join(d, "crossing.bam")
    with open(bam, "wb") as fh:
        fh.write(b"".join(comp) + bamio.BGZF_EOF)

    def voff(u):
        k = np.searchsorted(cuts, u, "right") - 1
        return (coff[k] << 16) | (u - cuts[k])

    bamio._write_bai(bam + ".bai", pos, ends, voff(ubeg), voff(ubeg + sizes))
    return bam


def _windows(kind: str, planted, hifi, crossing):
    """(bam, tids, begs, ends) of a case."""
    bam = planted[0] if planted else None
    if kind == "planted":
        rng = np.random.default_rng(11)
        n = 96
        tids = rng.integers(0, 2, n).astype(np.int32)
        begs = rng.integers(0, CHROM_LEN, n)
        ends = begs + rng.integers(1, 8000, n)
        return bam, tids, begs, ends
    if kind == "chrom_end":
        return (bam, np.array([0, 1], np.int32),
                np.array([CHROM_LEN - 4000, 140_000]),
                np.array([CHROM_LEN, 150_000]))
    if kind == "empty":
        return (bam, np.array([-1, 0, 0, 1, -1], np.int32),
                np.array([0, 5000, 70_000, 9000, 10]),
                np.array([100, 5000, 60_000, 9000, 20]))
    if kind == "crossing":
        return (crossing, np.array([0, 0], np.int32),
                np.array([20_000, 31_000]), np.array([32_768, 32_768]))
    if kind == "hifi":
        loci = hifi["loci"]
        begs = np.array([lc["pos"] - 500 for lc in loci] +
                        [lc["end"] - 500 for lc in loci])
        return (hifi["bam"], np.zeros(len(begs), np.int32), begs,
                begs + 1000)
    raise ValueError(kind)


def _fetch(reader, how: str, tids, begs, ends):
    """(every array a batch fetch leaves: counts, pos, n_ops, opoff, ops,
    lens, widx)."""
    if how == "merged":
        total, counts = reader.fetch_batch_merged(tids, begs, ends, 1000)
    else:
        total, counts = reader.fetch_batch(tids, begs, ends)
    return (counts, *reader.batch_columns_n(total), reader.batch_widx())


def _staged(bam: str, **kw) -> NativeBamReader:
    r = native_bam_reader(bam)
    r.stage_inflate("cpu", **kw)
    return r


CASES = ["planted", "chrom_end", "empty", "crossing", "hifi"]


@pytest.mark.parametrize("how", ["merged", "plain"])
@pytest.mark.parametrize("case", CASES)
def test_staged_fetch_covers_the_lazy_walk(planted, hifi, crossing, case,
                                           how):
    """On fresh handles: the staged fetch returns the lazy fetch's arrays,
    zlib inflates no block during it (the stage covers every block the
    walk reads), and it inflates at most 1.35x the lazy walk's bytes."""
    bam, tids, begs, ends = _windows(case, planted, hifi, crossing)
    lazy = native_bam_reader(bam)
    want = _fetch(lazy, how, tids, begs, ends)
    lazy_bytes = lazy.take_counters().inflated_bytes
    staged = _staged(bam)
    got = _fetch(staged, how, tids, begs, ends)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    if how == "merged":
        assert len(got[-1]) == int(got[0].sum())
    c = staged.take_counters()
    nbytes, card, missed = (c.inflated_bytes, c.card_bytes,
                            c.zlib_staged_bytes)
    assert card == 0 and missed == 0
    assert staged.take_counters() == ReaderCounters()  # zeroed on read
    # a block that several windows read inflates once a slice
    assert nbytes <= 1.35 * lazy_bytes, (nbytes, lazy_bytes)
    if case == "empty":
        assert not got[0].any()


@pytest.mark.parametrize("blocks", [1, 2, 5, 64])
@pytest.mark.parametrize("case", ["planted", "hifi"])
def test_small_slices_return_the_same(planted, hifi, crossing, case, blocks):
    """Slices of a few blocks (regions split across slices, continued when
    the walk reaches their next block) give the lazy fetch's arrays, on
    both batch fetches."""
    bam, tids, begs, ends = _windows(case, planted, hifi, crossing)
    lazy = native_bam_reader(bam)
    staged = _staged(bam, _slice=(blocks, 3 * BLOCK))
    for how in ("merged", "plain"):
        want = _fetch(lazy, how, tids, begs, ends)
        got = _fetch(staged, how, tids, begs, ends)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("case", ["planted", "hifi"])
def test_take_counters_is_one_snapshot_that_zeroes(planted, hifi, crossing,
                                                   case):
    """A fresh handle reads all zeros (the open zeroes what its header
    read); a staged fetch and an extract over it fill every field of one
    snapshot, which adds up field by field, and the next call reads zeros
    again."""
    bam, tids, begs, ends = _windows(case, planted, hifi, crossing)
    r = native_bam_reader(bam)
    assert r.take_counters() == ReaderCounters()
    r.stage_inflate("cpu")
    total, counts = r.fetch_batch(tids, begs, ends)
    cfg, n = AudtConfig(), len(tids)
    r.extract_batch(np.full(n, C.KIND_INS, np.int32), begs + 1, ends + 1,
                    np.zeros(n, np.int64), counts, 64,
                    cfg.consensus_min_count, cfg.consensus_interval,
                    cfg.consensus_interval_range)
    c = r.take_counters()
    assert total > 0 and c.inflate_ns > 0 and c.inflated_bytes > 0
    assert c.card_bytes == 0 and c.zlib_staged_bytes == 0  # the CPU's zlib
    assert c.walk_ops > 0 and c.walked_bytes > 0
    assert r.take_counters() == ReaderCounters()
    assert c + c == ReaderCounters(*(2 * v for v in dataclasses.astuple(c)))


def _corrupt(src: str, dst: str, how: str) -> None:
    """A copy of src with its fourth block broken: an invalid deflate block
    type, or an ISIZE that is not the block's length."""
    data = bytearray(open(src, "rb").read())
    off = 0
    for _ in range(3):
        off += int.from_bytes(data[off + 16:off + 18], "little") + 1
    xlen = int.from_bytes(data[off + 10:off + 12], "little")
    bsize = int.from_bytes(data[off + 16:off + 18], "little") + 1
    if how == "stream":
        data[off + 12 + xlen] |= 0b110  # BTYPE 3
    else:
        isize = int.from_bytes(data[off + bsize - 4:off + bsize], "little")
        data[off + bsize - 4:off + bsize] = (isize - 1).to_bytes(4, "little")
    open(dst, "wb").write(data)
    os.link(src + ".bai", dst + ".bai")


@pytest.mark.parametrize("how", ["stream", "isize"])
def test_a_corrupt_block_raises_the_lazy_error(hifi, tmp_path, how):
    bam = str(tmp_path / "bad.bam")
    _corrupt(hifi["bam"], bam, how)
    _, tids, begs, ends = _windows("hifi", None, hifi, None)
    errors = []
    for reader in (native_bam_reader(bam), _staged(bam)):
        with pytest.raises(NativeBamError) as e:
            reader.fetch_batch_merged(tids, begs, ends, 1000)
        errors.append(str(e.value))
    assert errors[0] == errors[1]


def test_a_failing_batch_inflate_raises_its_error(planted, monkeypatch):
    """What the batch inflate raises reaches the fetch's caller."""
    def refuse(*a, **k):
        raise RuntimeError("no inflate today")

    monkeypatch.setattr(kernels, "bgzf_inflate", refuse)
    bam, tids, begs, ends = _windows("planted", planted, None, None)
    with pytest.raises(RuntimeError, match="no inflate today"):
        _staged(bam).fetch_batch_merged(tids, begs, ends, 1000)


def test_workers_load_the_kernel_library_once(monkeypatch):
    """The pool's workers reach their first inflate launch together: the
    library is built and loaded once, and each of them gets it."""
    import threading
    import time

    calls = []

    def slow_load():
        if kernels._LIB is None:
            calls.append(1)
            time.sleep(0.01)
            kernels._LIB = object()
        return kernels._LIB

    monkeypatch.setattr(kernels, "_LIB", None)
    monkeypatch.setattr(kernels, "_load", slow_load)
    got = []
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(
            target=lambda: got.append(kernels.load_library()))
            for _ in range(4 * (os.cpu_count() or 1))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert len(calls) == 1 and len(got) == len(threads)
    assert all(x is kernels._LIB for x in got)


def _stages(bam, vcf, stage: bool, monkeypatch, **kw) -> dict:
    if not stage:
        monkeypatch.setattr(NativeBamReader, "stage_inflate",
                            lambda self, *a, **k: None)
    err = io.StringIO()
    lines = taudit.run_audit(
        AudtConfig(bam_file=bam, vcf_file=vcf, device="cpu", verbose=True,
                   **kw), out=io.StringIO(), err=err)
    monkeypatch.undo()
    line = next(x for x in err.getvalue().splitlines()
                if x.startswith("[VERBOSE] stages"))
    st = {k: float(v.rstrip("s")) for k, v in
          (t.split("=") for t in line.split()[2:])}
    return lines, st


@pytest.mark.parametrize("extract", ["auto", "device"])
def test_run_audit_counters_on_the_cpu(planted, monkeypatch, extract):
    """On the CPU the card inflates nothing, and the pool inflates what
    the lazy walk inflates and at most the blocks up to the index's bound
    past it, with the same lines."""
    bam, vcf = planted
    want, lazy = _stages(bam, vcf, False, monkeypatch, extract=extract)
    got, st = _stages(bam, vcf, True, monkeypatch, extract=extract)
    assert got == want
    assert st["card_inflated_mb"] == 0.0
    # the blocks between the walk's stop and the index's bound, at most
    assert 0 < st["inflated_mb"] <= 1.35 * lazy["inflated_mb"]
    assert st["inflate"] <= st["fetch"] + 0.001


# ---- the plain version (zlib a block), which the CPU runs -------------


def _deflate(raw: bytes, level: int, strategy: int) -> bytes:
    c = zlib.compressobj(level, zlib.DEFLATED, -15, 8, strategy)
    return c.compress(raw) + c.flush()


def _corpus(seed: int) -> list[bytes]:
    """Inflated blocks of several kinds: random bytes, HiFi-like quality
    strings, a short period, text, a full 64 KiB."""
    rng = random.Random(seed)
    quals = bytes(33 + min(93, int(rng.expovariate(0.08)))
                  for _ in range(9000))
    text = b" ".join(rng.choice([b"GATTACA", b"svtrek", b"BGZF", b"block",
                                 b"deflate"]) for _ in range(3000))
    return [bytes(rng.getrandbits(8) for _ in range(3000)), quals,
            b"ACGT" * 2000 + b"A" * 700, text, b"",
            (text * 30)[:BLOCK]]


STREAMS = [(lv, st) for lv in (0, 1, 6, 9)
           for st in (zlib.Z_DEFAULT_STRATEGY, zlib.Z_FIXED,
                      zlib.Z_HUFFMAN_ONLY, zlib.Z_RLE)]


def _plain(payload: bytes, isize: int) -> tuple[int, bytes]:
    """What the plain version makes of a payload: its status, and its
    bytes where it is ok."""
    data = torch.frombuffer(bytearray(payload) or bytearray(1),
                            dtype=torch.uint8)
    meta = torch.tensor([[0, len(payload), isize]], dtype=torch.int64)
    out, st = kernels.bgzf_inflate(data, meta)
    s = int(st[0])
    return s, (bytes(out[0, :isize].numpy()) if s == kernels.INFLATE_OK
               else b"")


def _zlib_judges(payload: bytes, isize: int) -> tuple[int, bytes]:
    """The status zlib's one-shot decompress implies for a payload."""
    try:
        raw = zlib.decompress(payload, -15)
    except zlib.error:
        return kernels.INFLATE_BAD, b""
    if len(raw) > BLOCK:
        return kernels.INFLATE_BAD, b""
    if len(raw) != isize:
        return kernels.INFLATE_LENGTH, b""
    return kernels.INFLATE_OK, raw


@pytest.mark.parametrize("level,strategy", STREAMS)
def test_plain_inflate_equals_zlib(level, strategy):
    """Each stream of the corpus inflates to its bytes; with an ISIZE that
    is not its length it gets INFLATE_LENGTH."""
    for raw in _corpus(level * 7 + strategy):
        payload = _deflate(raw, level, strategy)
        assert _plain(payload, len(raw)) == (kernels.INFLATE_OK, raw)
        assert _plain(payload, len(raw) + 1)[0] == kernels.INFLATE_LENGTH


def test_plain_inflate_judges_broken_streams_as_zlib():
    """Truncated and bit-flipped payloads: the plain version's status is
    what zlib's one-shot decompress implies, and where both accept a
    stream their bytes agree."""
    rng = random.Random(5)
    bad = 0
    for raw in _corpus(1)[:4]:
        payload = _deflate(raw, 6, zlib.Z_DEFAULT_STRATEGY)
        cases = [payload[:n] for n in (0, 1, len(payload) // 2,
                                       len(payload) - 1)]
        for _ in range(12):
            flip = bytearray(payload)
            i = rng.randrange(len(flip))
            flip[i] ^= 1 << rng.randrange(8)
            cases.append(bytes(flip))
        for case in cases:
            got = _plain(case, len(raw))
            assert got == _zlib_judges(case, len(raw))
            bad += got[0] != kernels.INFLATE_OK
    assert bad >= 16  # the truncations at least


def test_plain_inflate_on_the_bam_blocks(hifi):
    """Every block of the tiny hg002-hifi BAM, the empty EOF block last,
    in one call: each ok and equal to zlib's."""
    data = open(hifi["bam"], "rb").read()
    payloads, sizes = [], []
    off = 0
    while off < len(data):
        xlen = int.from_bytes(data[off + 10:off + 12], "little")
        bsize = int.from_bytes(data[off + 16:off + 18], "little") + 1
        payloads.append(data[off + 12 + xlen:off + bsize - 8])
        sizes.append(int.from_bytes(data[off + bsize - 4:off + bsize],
                                    "little"))
        off += bsize
    assert len(payloads) > 100 and sizes[-1] == 0
    offs = np.cumsum([0] + [len(p) for p in payloads])
    blob = torch.frombuffer(bytearray(b"".join(payloads)), dtype=torch.uint8)
    meta = torch.tensor(np.stack([offs[:-1], [len(p) for p in payloads],
                                  sizes], 1), dtype=torch.int64)
    out, st = kernels.bgzf_inflate(blob, meta)
    assert (st == kernels.INFLATE_OK).all()
    for i, (p, n) in enumerate(zip(payloads, sizes)):
        assert bytes(out[i, :n].numpy()) == zlib.decompress(p, -15), i


# ---- on the card ------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; torch sees none here")


@pytest.mark.card
def test_kernel_equals_zlib_on_the_card(card, hifi):
    """The kernel against the plain version, bit for bit: zlib's streams
    at levels 0, 1, 6 and 9 with each strategy, a full 64 KiB block, the
    empty EOF block, every block of the tiny hg002-hifi BAM, and truncated
    and bit-flipped payloads, each broken one between two empty payloads
    whose rows must stay untouched."""
    rng = random.Random(9)
    payloads, sizes = [], []
    for level, strategy in STREAMS:
        for raw in _corpus(level + strategy):
            payloads.append(_deflate(raw, level, strategy))
            sizes.append(len(raw))
    payloads.append(b"\x03\x00")  # BGZF's EOF block
    sizes.append(0)
    data = open(hifi["bam"], "rb").read()
    off = 0
    while off < len(data):
        xlen = int.from_bytes(data[off + 10:off + 12], "little")
        bsize = int.from_bytes(data[off + 16:off + 18], "little") + 1
        payloads.append(data[off + 12 + xlen:off + bsize - 8])
        sizes.append(int.from_bytes(data[off + bsize - 4:off + bsize],
                                    "little"))
        off += bsize
    guards = []
    for raw in _corpus(3)[:4]:
        p = _deflate(raw, 6, zlib.Z_DEFAULT_STRATEGY)
        broken = [p[:len(p) // 2], p[:-1]]
        for _ in range(8):
            flip = bytearray(p)
            flip[rng.randrange(len(flip))] ^= 1 << rng.randrange(8)
            broken.append(bytes(flip))
        for case in broken:
            guards.append(len(payloads))
            payloads += [b"", case, b""]
            sizes += [0, len(raw), 0]
    offs = np.cumsum([0] + [len(p) for p in payloads])
    blob = torch.frombuffer(bytearray(b"".join(payloads) + b"\0"),
                            dtype=torch.uint8)
    meta = torch.tensor(np.stack([offs[:-1], [len(p) for p in payloads],
                                  sizes], 1), dtype=torch.int64)
    want_out, want_st = kernels.bgzf_inflate(blob, meta)
    out = torch.full((len(payloads), BLOCK), 0xA5, dtype=torch.uint8,
                     device="cuda")
    kernels.reset_launch_counts()
    _, st = kernels.bgzf_inflate(blob.cuda(), meta.cuda(), out=out)
    torch.cuda.synchronize()
    assert kernels.launch_counts["bgzf_inflate"] == 1
    st, out = st.cpu(), out.cpu()
    assert torch.equal(st, want_st)
    for i, n in enumerate(sizes):
        if int(st[i]) == kernels.INFLATE_OK:
            assert torch.equal(out[i, :n], want_out[i, :n]), i
    for g in guards:  # the empty payloads around a broken one
        assert int(st[g]) == int(st[g + 2]) == kernels.INFLATE_BAD
        assert bool((out[g] == 0xA5).all()) and bool((out[g + 2] == 0xA5)
                                                     .all())
    assert int((want_st != 0).sum()) >= 8
