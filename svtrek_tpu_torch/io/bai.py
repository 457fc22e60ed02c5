"""BAI (BAM index) reading, writing, and binning arithmetic.

Implements the UCSC/CSI binning scheme used by BAM: 5 levels, bins of
size 512 Mb/64 Mb/8 Mb/1 Mb/128 kb/16 kb, plus a 16 kb linear index.
Replaces htslib's index machinery used by the reference via
sam_index_load / sam_itr_queryi (audit.c:272, refinement.c:114).
"""
from __future__ import annotations

import struct
from dataclasses import dataclass, field

MAX_BIN = 37450  # ((1<<18)-1)/7 + 1
LINEAR_SHIFT = 14  # 16 kb


def reg2bin(beg: int, end: int) -> int:
    """Smallest bin containing [beg, end) (0-based half-open)."""
    end -= 1
    if beg >> 14 == end >> 14:
        return ((1 << 15) - 1) // 7 + (beg >> 14)
    if beg >> 17 == end >> 17:
        return ((1 << 12) - 1) // 7 + (beg >> 17)
    if beg >> 20 == end >> 20:
        return ((1 << 9) - 1) // 7 + (beg >> 20)
    if beg >> 23 == end >> 23:
        return ((1 << 6) - 1) // 7 + (beg >> 23)
    if beg >> 26 == end >> 26:
        return ((1 << 3) - 1) // 7 + (beg >> 26)
    return 0


def reg2bins(beg: int, end: int, min_shift: int = 14,
             depth: int = 5) -> list[int]:
    """All bins overlapping [beg, end).  Defaults are the BAI binning;
    CSI parameterizes (min_shift, depth)."""
    bins = [0]
    if beg >= end:
        return bins
    end -= 1
    s = min_shift + depth * 3
    t = 0
    for level in range(1, depth + 1):
        s -= 3
        t += 1 << ((level - 1) * 3)
        bins.extend(range(t + (beg >> s), t + (end >> s) + 1))
    return bins


@dataclass
class RefIndex:
    bins: dict[int, list[tuple[int, int]]] = field(default_factory=dict)
    linear: list[int] = field(default_factory=list)


class BaiIndex:
    """In-memory BAM index (BAI or CSI) with query + (de)serialization.

    htslib's sam_index_load transparently accepts either format
    (reference use: audit.c:272); load_auto mirrors that by trying
    `<bam>.bai` then `<bam>.csi`.
    """

    def __init__(self, refs: list[RefIndex] | None = None,
                 min_shift: int = 14, depth: int = 5):
        self.refs: list[RefIndex] = refs or []
        self.min_shift = min_shift
        self.depth = depth

    # --- construction (writer side) ------------------------------------

    @classmethod
    def build(cls, n_ref: int) -> "BaiIndex":
        return cls([RefIndex() for _ in range(n_ref)])

    def add_record(self, tid: int, pos: int, end: int, vbeg: int, vend: int):
        """Register one coordinate-sorted record (0-based [pos, end))."""
        ref = self.refs[tid]
        b = reg2bin(pos, max(end, pos + 1))
        chunks = ref.bins.setdefault(b, [])
        if chunks and chunks[-1][1] == vbeg:
            chunks[-1] = (chunks[-1][0], vend)  # merge adjacent chunks
        else:
            chunks.append((vbeg, vend))
        win_beg = pos >> LINEAR_SHIFT
        win_end = (max(end, pos + 1) - 1) >> LINEAR_SHIFT
        lin = ref.linear
        if len(lin) <= win_end:
            lin.extend([0] * (win_end + 1 - len(lin)))
        for w in range(win_beg, win_end + 1):
            if lin[w] == 0 or vbeg < lin[w]:
                lin[w] = vbeg

    def finish(self):
        """Fill linear-index gaps with the previous window's offset."""
        for ref in self.refs:
            prev = 0
            for i, v in enumerate(ref.linear):
                if v == 0:
                    ref.linear[i] = prev
                else:
                    prev = v

    # --- serialization --------------------------------------------------

    def save(self, path: str):
        with open(path, "wb") as fh:
            fh.write(b"BAI\x01")
            fh.write(struct.pack("<i", len(self.refs)))
            for ref in self.refs:
                fh.write(struct.pack("<i", len(ref.bins)))
                for b in sorted(ref.bins):
                    chunks = ref.bins[b]
                    fh.write(struct.pack("<Ii", b, len(chunks)))
                    for vbeg, vend in chunks:
                        fh.write(struct.pack("<QQ", vbeg, vend))
                fh.write(struct.pack("<i", len(ref.linear)))
                for v in ref.linear:
                    fh.write(struct.pack("<Q", v))

    def save_csi(self, path: str):
        """Write the index in CSI format (BGZF-compressed; per-bin
        loffset = earliest chunk start, a valid conservative bound)."""
        from .bgzf import BgzfWriter

        with BgzfWriter(path) as fh:
            fh.write(b"CSI\x01")
            fh.write(struct.pack("<iii", self.min_shift, self.depth, 0))
            fh.write(struct.pack("<i", len(self.refs)))
            for ref in self.refs:
                fh.write(struct.pack("<i", len(ref.bins)))
                for b in sorted(ref.bins):
                    chunks = ref.bins[b]
                    loffset = min((c[0] for c in chunks), default=0)
                    fh.write(struct.pack("<IQi", b, loffset, len(chunks)))
                    for vbeg, vend in chunks:
                        fh.write(struct.pack("<QQ", vbeg, vend))

    @classmethod
    def load(cls, path: str) -> "BaiIndex":
        with open(path, "rb") as fh:
            data = fh.read()
        if data[:4] != b"BAI\x01":
            raise ValueError(f"{path}: not a BAI index")
        off = 4
        (n_ref,) = struct.unpack_from("<i", data, off)
        off += 4
        refs = []
        for _ in range(n_ref):
            (n_bin,) = struct.unpack_from("<i", data, off)
            off += 4
            bins: dict[int, list[tuple[int, int]]] = {}
            for _ in range(n_bin):
                b, n_chunk = struct.unpack_from("<Ii", data, off)
                off += 8
                chunks = []
                for _ in range(n_chunk):
                    vbeg, vend = struct.unpack_from("<QQ", data, off)
                    off += 16
                    chunks.append((vbeg, vend))
                if b != MAX_BIN:  # skip the metadata pseudo-bin
                    bins[b] = chunks
            (n_intv,) = struct.unpack_from("<i", data, off)
            off += 4
            linear = list(struct.unpack_from(f"<{n_intv}Q", data, off))
            off += 8 * n_intv
            refs.append(RefIndex(bins, linear))
        return cls(refs)

    @classmethod
    def load_csi(cls, path: str) -> "BaiIndex":
        """CSI (.csi) index: BGZF-compressed, parameterized binning,
        per-bin loffset instead of a linear index."""
        from .bgzf import BgzfReader

        with BgzfReader(path) as fh:
            def read(n: int) -> bytes:
                buf = fh.read(n)
                if len(buf) != n:
                    raise ValueError(f"{path}: truncated CSI index")
                return buf

            if read(4) != b"CSI\x01":
                raise ValueError(f"{path}: not a CSI index")
            min_shift, depth, l_aux = struct.unpack("<iii", read(12))
            read(l_aux)
            (n_ref,) = struct.unpack("<i", read(4))
            max_bin = ((1 << ((depth + 1) * 3)) - 1) // 7 + 1
            refs = []
            for _ in range(n_ref):
                (n_bin,) = struct.unpack("<i", read(4))
                bins: dict[int, list[tuple[int, int]]] = {}
                for _ in range(n_bin):
                    b, _loffset, n_chunk = struct.unpack("<IQi", read(16))
                    chunks = []
                    for _ in range(n_chunk):
                        vbeg, vend = struct.unpack("<QQ", read(16))
                        chunks.append((vbeg, vend))
                    if b != max_bin:  # metadata pseudo-bin
                        bins[b] = chunks
                refs.append(RefIndex(bins, []))
        return cls(refs, min_shift=min_shift, depth=depth)

    @classmethod
    def load_auto(cls, bam_path: str) -> "BaiIndex":
        """Load `<bam>.bai`, falling back to `<bam>.csi` (htslib's
        sam_index_load contract)."""
        import os

        bai = bam_path + ".bai"
        if os.path.exists(bai):
            return cls.load(bai)
        csi = bam_path + ".csi"
        if os.path.exists(csi):
            return cls.load_csi(csi)
        raise FileNotFoundError(f"no .bai or .csi index for {bam_path}")

    # --- query ----------------------------------------------------------

    def query_chunks(self, tid: int, beg: int, end: int) -> list[tuple[int, int]]:
        """Candidate chunks for region [beg, end), linear-index filtered,
        sorted and merged — the htslib iterator's chunk list."""
        if tid < 0 or tid >= len(self.refs) or beg >= end:
            return []
        ref = self.refs[tid]
        win = beg >> LINEAR_SHIFT
        min_off = ref.linear[win] if win < len(ref.linear) else (
            ref.linear[-1] if ref.linear else 0
        )
        chunks = []
        for b in reg2bins(beg, end, self.min_shift, self.depth):
            for vbeg, vend in ref.bins.get(b, ()):
                if vend > min_off:
                    chunks.append((max(vbeg, min_off), vend))
        chunks.sort()
        merged: list[tuple[int, int]] = []
        for vbeg, vend in chunks:
            if merged and vbeg <= merged[-1][1]:
                merged[-1] = (merged[-1][0], max(merged[-1][1], vend))
            else:
                merged.append((vbeg, vend))
        return merged
