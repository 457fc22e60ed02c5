"""BAM reader/writer with BAI-indexed region queries (pure Python).

Replaces the htslib API surface the reference depends on
(hts_open / sam_hdr_read / sam_index_load / sam_itr_queryi /
sam_itr_next / bam_get_cigar; audit.c:270-272, refinement.c:113-117):

- `BamWriter` produces coordinate-sorted BAM + BAI for test fixtures and
  the simvcf acceptance harness.
- `BamReader.fetch(tid, beg, end)` reproduces htslib's region-iterator
  semantics: candidate chunks from the binning index, linear-index lower
  bound, records yielded in file order, overlap test
  (pos < end and endpos > beg), early stop once pos >= end.

The audit pipeline prefers the C fast path (svtrek_tpu_torch/native) when
built; this module is the always-available fallback and the fixture
generator.
"""
from __future__ import annotations

import struct
from dataclasses import dataclass

import numpy as np

from .bai import BaiIndex
from .bgzf import BgzfReader, BgzfWriter
from ..constants import CIGAR_OPS, CONSUMES_REF
from ..native.bamlib import ReaderCounters

_SEQ_NIBBLES = "=ACMGRSVTWYHKDBN"
_NIB = {c: i for i, c in enumerate(_SEQ_NIBBLES)}


def _build_nib_lut():
    lut = np.full(256, 15, np.uint8)  # unknown bases → 15 ('N'-ish)
    for c, i in _NIB.items():
        lut[ord(c)] = i
    return lut


_NIB_LUT = _build_nib_lut()
_NT16 = np.frombuffer(_SEQ_NIBBLES.encode(), np.uint8)


@dataclass
class BamRecord:
    name: str
    flag: int
    tid: int
    pos: int            # 0-based
    mapq: int
    cigar: list[tuple[int, int]]   # (op, len) BAM op codes
    seq: str = "*"
    qual: bytes = b""
    next_tid: int = -1
    next_pos: int = -1
    tlen: int = 0
    tags: bytes = b""

    @property
    def endpos(self) -> int:
        """0-based exclusive reference end (htslib bam_endpos)."""
        ref = sum(ln for op, ln in self.cigar if op in CONSUMES_REF)
        return self.pos + ref if ref > 0 else self.pos + 1

    def cigar_string(self) -> str:
        return "".join(f"{ln}{CIGAR_OPS[op]}" for op, ln in self.cigar) or "*"


def encode_record(rec: BamRecord) -> bytes:
    name_b = rec.name.encode() + b"\x00"
    cigar_b = b"".join(
        struct.pack("<I", (ln << 4) | op) for op, ln in rec.cigar
    )
    if rec.seq and rec.seq != "*":
        seq = rec.seq
        l_seq = len(seq)
        import numpy as _np

        codes = _NIB_LUT[_np.frombuffer(
            seq.upper().encode("latin-1", "replace"), _np.uint8)]
        if l_seq % 2:
            codes = _np.append(codes, _np.uint8(0))
        seq_b = ((codes[0::2] << 4) | codes[1::2]).astype(_np.uint8) \
            .tobytes()
        qual_b = rec.qual if rec.qual else b"\xff" * l_seq
    else:
        l_seq = 0
        seq_b = b""
        qual_b = b""
    from .bai import reg2bin

    bin_ = reg2bin(rec.pos, rec.endpos)
    body = struct.pack(
        "<iiBBHHHiiii",
        rec.tid,
        rec.pos,
        len(name_b),
        rec.mapq,
        bin_,
        len(rec.cigar),
        rec.flag,
        l_seq,
        rec.next_tid,
        rec.next_pos,
        rec.tlen,
    ) + name_b + cigar_b + seq_b + qual_b + rec.tags
    return struct.pack("<i", len(body)) + body


def decode_record(body: bytes) -> BamRecord:
    (
        tid, pos, l_name, mapq, _bin, n_cigar, flag, l_seq,
        next_tid, next_pos, tlen,
    ) = struct.unpack_from("<iiBBHHHiiii", body, 0)
    off = 32
    name = body[off : off + l_name - 1].decode()
    off += l_name
    # CIGAR and SEQ decoded with numpy (a per-op and per-base Python loop
    # takes milliseconds a long read); the values are the same.
    cig = np.frombuffer(body, "<u4", n_cigar, off)
    cigar = list(zip((cig & 0xF).tolist(), (cig >> 4).tolist()))
    off += 4 * n_cigar
    nib = np.frombuffer(body, np.uint8, (l_seq + 1) // 2, off)
    off += (l_seq + 1) // 2
    seq = "*"
    if l_seq:
        codes = np.empty(2 * len(nib), np.uint8)
        codes[0::2] = nib >> 4
        codes[1::2] = nib & 0xF
        seq = _NT16[codes[:l_seq]].tobytes().decode("ascii")
    qual = body[off : off + l_seq]
    off += l_seq
    tags = body[off:]
    return BamRecord(
        name, flag, tid, pos, mapq, cigar, seq, qual,
        next_tid, next_pos, tlen, tags,
    )


class BamWriter:
    """Coordinate-sorted BAM + BAI writer (for fixtures / harnesses)."""

    def __init__(self, path: str, references: list[tuple[str, int]]):
        self.path = path
        self.references = references
        self._bgzf = BgzfWriter(path)
        self._bai = BaiIndex.build(len(references))
        header_text = "@HD\tVN:1.6\tSO:coordinate\n" + "".join(
            f"@SQ\tSN:{name}\tLN:{length}\n" for name, length in references
        )
        h = b"BAM\x01" + struct.pack("<i", len(header_text))
        h += header_text.encode()
        h += struct.pack("<i", len(references))
        for name, length in references:
            nb = name.encode() + b"\x00"
            h += struct.pack("<i", len(nb)) + nb + struct.pack("<i", length)
        self._bgzf.write(h)
        self._last = (-1, -1)

    def write(self, rec: BamRecord):
        if (rec.tid, rec.pos) < self._last:
            raise ValueError("records must be coordinate sorted")
        self._last = (rec.tid, rec.pos)
        vbeg = self._bgzf.tell()
        self._bgzf.write(encode_record(rec))
        vend = self._bgzf.tell()
        if rec.tid >= 0:
            self._bai.add_record(rec.tid, rec.pos, rec.endpos, vbeg, vend)

    def close(self):
        self._bgzf.close()
        self._bai.finish()
        self._bai.save(self.path + ".bai")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class BamReader:
    """Indexed BAM reader mirroring the htslib iterator semantics."""

    def __init__(self, path: str):
        self.path = path
        self._bgzf = BgzfReader(path)
        magic = self._bgzf.read(4)
        if magic != b"BAM\x01":
            raise ValueError(f"{path}: not a BAM file")
        (l_text,) = struct.unpack("<i", self._bgzf.read(4))
        self.header_text = self._bgzf.read(l_text).decode(errors="replace")
        (n_ref,) = struct.unpack("<i", self._bgzf.read(4))
        self.references: list[tuple[str, int]] = []
        for _ in range(n_ref):
            (l_name,) = struct.unpack("<i", self._bgzf.read(4))
            name = self._bgzf.read(l_name)[:-1].decode()
            (l_ref,) = struct.unpack("<i", self._bgzf.read(4))
            self.references.append((name, l_ref))
        self._data_voffset = self._bgzf.tell()
        self._index: BaiIndex | None = None

    @property
    def index(self) -> BaiIndex:
        if self._index is None:
            self._index = BaiIndex.load_auto(self.path)
        return self._index

    def tid_of(self, name: str) -> int:
        """tid for a reference name; -1 if absent.  Tolerates a
        chr-prefix difference in either direction (matches the native
        reader's svbam_tid)."""
        for i, (n, _) in enumerate(self.references):
            if n == name or n == "chr" + name or "chr" + n == name:
                return i
        return -1

    # The native reader's names for what the pipeline calls on a reader.
    tid_by_name = tid_of

    def stage_inflate(self, device) -> None:
        """Nothing to stage: this reader inflates each block as it reads."""

    def take_counters(self) -> ReaderCounters:
        """This reader counts nothing: all zeros."""
        return ReaderCounters()

    def _read_record(self) -> BamRecord | None:
        size_b = self._bgzf.read(4)
        if len(size_b) < 4:
            return None
        (size,) = struct.unpack("<i", size_b)
        body = self._bgzf.read(size)
        if len(body) < size:
            return None
        return decode_record(body)

    def __iter__(self):
        self._bgzf.seek(self._data_voffset)
        while True:
            rec = self._read_record()
            if rec is None:
                return
            yield rec

    def fetch(self, tid: int, beg: int, end: int):
        """Yield records overlapping [beg, end) (0-based half-open) in file
        order — the sam_itr_queryi / sam_itr_next equivalent.

        Mirrors htslib boundary behavior: beg clamped to 0; empty when
        beg >= end or tid invalid (the reference's uint32-wrapped interval
        arithmetic produces exactly these degenerate queries; SURVEY.md
        §7 'hard parts')."""
        beg = max(beg, 0)
        if tid < 0 or tid >= len(self.references) or beg >= end:
            return
        for vbeg, vend in self.index.query_chunks(tid, beg, end):
            self._bgzf.seek(vbeg)
            while self._bgzf.tell() < vend:
                rec = self._read_record()
                if rec is None:
                    return
                if rec.tid != tid or rec.pos >= end:
                    return
                if rec.endpos > beg:
                    yield rec

    def close(self):
        self._bgzf.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
