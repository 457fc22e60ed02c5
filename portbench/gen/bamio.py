"""A BAM + BAI writer for generated reads, independent of the program.

The arithmetic follows the SAM/BAM specification (section 4: BGZF blocks,
the record layout, the UCSC binning scheme and the 16 kb linear index), as
the port's own writer does (svtrek_tpu_torch/io/bgzf.py, io/bai.py, whose
`reg2bin`, block framing and linear-index fill this copies); it imports
nothing of the program, so a change to the program's writer cannot move
the benchmark's inputs.

The whole uncompressed stream is laid out in memory first; its 65,280-byte
blocks are then deflated in a thread pool (zlib releases the interpreter
lock) and written in order, and every virtual offset follows from the
block sizes.
"""
from __future__ import annotations

import struct
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np

BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000")
BLOCK = 65280           # uncompressed payload a block (htslib's convention)
LINEAR_SHIFT = 14       # 16 kb linear-index windows
# Deflate with Huffman coding alone (no LZ77 matches: random SEQ and QUAL
# hold none worth finding): 2.2x faster than level 1 on these reads and 7 %
# smaller, still a standard deflate stream that any BGZF reader inflates.
STRATEGY = zlib.Z_HUFFMAN_ONLY
# 4-bit SEQ code of each base code 0..3 (A C G T = 1 2 4 8).
NT4 = np.array([1, 2, 4, 8], np.uint8)


def reg2bin(beg: np.ndarray, end: np.ndarray) -> np.ndarray:
    """The smallest bin holding each [beg, end) (0-based, end > beg)."""
    beg = np.asarray(beg, np.int64)
    last = np.asarray(end, np.int64) - 1
    out = np.zeros(beg.shape, np.int64)
    done = np.zeros(beg.shape, bool)
    for shift, base in ((14, 4681), (17, 585), (20, 73), (23, 9), (26, 1)):
        hit = ~done & ((beg >> shift) == (last >> shift))
        out[hit] = base + (beg[hit] >> shift)
        done |= hit
    return out


def _deflate(payload) -> bytes:
    co = zlib.compressobj(1, zlib.DEFLATED, -15, 8, STRATEGY)
    comp = co.compress(payload) + co.flush()
    bsize = len(comp) + 26
    return (b"\x1f\x8b\x08\x04\x00\x00\x00\x00\x00\xff"
            + struct.pack("<HBBHH", 6, 66, 67, 2, bsize - 1) + comp
            + struct.pack("<II", zlib.crc32(payload) & 0xFFFFFFFF,
                          len(payload)))


def header_bytes(ref_name: str, ref_len: int) -> bytes:
    text = (f"@HD\tVN:1.6\tSO:coordinate\n"
            f"@SQ\tSN:{ref_name}\tLN:{ref_len}\n").encode()
    name = ref_name.encode() + b"\x00"
    return (b"BAM\x01" + struct.pack("<i", len(text)) + text
            + struct.pack("<ii", 1, len(name)) + name
            + struct.pack("<i", ref_len))


def encode_records(pos: np.ndarray, ends: np.ndarray, cigars, seqs,
                   quals) -> tuple[list[bytes], np.ndarray]:
    """BAM records of reads on tid 0, in the given (sorted) order, as a
    list of byte pieces (six a record) and each record's size.

    ``ends[i]`` is read i's reference end (its start plus the M, D, N, =
    and X lengths), ``cigars[i]`` a uint32 array of (len << 4 | op),
    ``seqs[i]`` the packed 4-bit SEQ (``ceil(l_seq / 2)`` bytes) and
    ``quals[i]`` the l_seq QUAL bytes."""
    bins = reg2bin(pos, np.maximum(ends, np.asarray(pos) + 1)).tolist()
    pieces, sizes = [], np.empty(len(bins), np.int64)
    for i, (p, cig, seq, qual) in enumerate(
            zip(np.asarray(pos).tolist(), cigars, seqs, quals)):
        name = b"r%d\x00" % i
        l_seq = len(qual)
        body = struct.pack("<iiBBHHHiiii", 0, p, len(name), 60, bins[i],
                           len(cig), 0, l_seq, -1, -1, 0)
        size = len(body) + len(name) + 4 * len(cig) + len(seq) + l_seq
        sizes[i] = size + 4
        pieces += (struct.pack("<i", size), body, name,
                   cig.astype("<u4").tobytes(), seq, qual)
    return pieces, sizes


def write_bam(path: str, ref_name: str, ref_len: int, pos: np.ndarray,
              ends: np.ndarray, pieces: list[bytes], sizes: np.ndarray,
              threads: int = 8) -> None:
    """Write the records of `encode_records` (sorted by ``pos``) as PATH
    and PATH.bai."""
    head = header_bytes(ref_name, ref_len)
    ubeg = len(head) + np.concatenate(([0], np.cumsum(sizes)[:-1])) \
        if len(sizes) else np.zeros(0, np.int64)
    stream = memoryview(b"".join([head, *pieces]))
    blocks = [stream[i:i + BLOCK] for i in range(0, len(stream), BLOCK)]
    with ThreadPoolExecutor(max(1, threads)) as ex:
        comp = list(ex.map(_deflate, blocks))
    coff = np.concatenate(([0], np.cumsum([len(c) for c in comp])))
    with open(path, "wb") as fh:
        for c in comp:
            fh.write(c)
        fh.write(BGZF_EOF)

    def voff(u: np.ndarray) -> np.ndarray:
        return (coff[u // BLOCK] << 16) | (u % BLOCK)

    vbeg, vend = voff(ubeg), voff(ubeg + sizes)
    _write_bai(path + ".bai", pos, ends, vbeg, vend)


def _write_bai(path, pos, ends, vbeg, vend) -> None:
    """One reference's bins (runs of consecutive records of one bin are
    one chunk) and its linear index (each 16 kb window's first record's
    virtual offset, gaps filled from the left)."""
    pos = np.asarray(pos, np.int64)
    bins = reg2bin(pos, ends)
    chunks: dict[int, list[tuple[int, int]]] = {}
    n = len(pos)
    if n:
        cut = np.flatnonzero(np.diff(bins)) + 1
        starts = np.concatenate(([0], cut))
        stops = np.concatenate((cut, [n]))
        for a, b in zip(starts.tolist(), stops.tolist()):
            chunks.setdefault(int(bins[a]), []).append(
                (int(vbeg[a]), int(vend[b - 1])))
    wb, we = pos >> LINEAR_SHIFT, (ends - 1) >> LINEAR_SHIFT
    n_win = int(we.max()) + 1 if n else 0
    lin = np.zeros(n_win, np.int64)
    if n:
        span = we - wb + 1
        win = np.repeat(wb, span) + (np.arange(int(span.sum()))
                                     - np.repeat(np.cumsum(span) - span, span))
        big = np.iinfo(np.int64).max
        best = np.full(n_win, big, np.int64)
        np.minimum.at(best, win, np.repeat(vbeg, span))
        have = best != big
        lin = np.where(have, best, 0)
        # A window no record covers takes the previous window's offset.
        idx = np.maximum.accumulate(np.where(have, np.arange(n_win), -1))
        lin = np.where(idx >= 0, lin[np.maximum(idx, 0)], 0)
    out = [b"BAI\x01", struct.pack("<ii", 1, len(chunks))]
    for b in sorted(chunks):
        out.append(struct.pack("<Ii", b, len(chunks[b])))
        out += [struct.pack("<QQ", v0, v1) for v0, v1 in chunks[b]]
    out.append(struct.pack("<i", n_win))
    out.append(lin.astype("<u8").tobytes())
    with open(path, "wb") as fh:
        fh.write(b"".join(out))


def pack_seq(codes: np.ndarray) -> bytes:
    """Base codes 0..3 as BAM's packed 4-bit SEQ (a last odd base's low
    nibble 0)."""
    nib = NT4[codes]
    if len(nib) % 2:
        nib = np.concatenate((nib, np.zeros(1, np.uint8)))
    return ((nib[0::2] << 4) | nib[1::2]).tobytes()
