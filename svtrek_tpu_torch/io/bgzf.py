"""BGZF (blocked gzip) reader/writer.

BGZF is the container format of BAM/BAI: a sequence of <=64 KiB gzip
members, each carrying a BC extra subfield with the compressed block size,
terminated by a fixed 28-byte empty EOF block.  Virtual file offsets are
(compressed_block_offset << 16) | offset_within_uncompressed_block.

Plays the role of htslib's bgzf.c for this framework (the reference links
htslib for all of this; SURVEY.md §2.13).  Fresh implementation from the
GZIP/BGZF specs.
"""
from __future__ import annotations

import struct
import zlib

BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000"
)
_MAX_BLOCK = 65280  # uncompressed payload per block (htslib convention)


def make_virtual_offset(coffset: int, uoffset: int) -> int:
    return (coffset << 16) | uoffset


def split_virtual_offset(voffset: int) -> tuple[int, int]:
    return voffset >> 16, voffset & 0xFFFF


class BgzfWriter:
    """Streaming BGZF writer."""

    def __init__(self, path_or_file, level: int = 6):
        if hasattr(path_or_file, "write"):
            self._fh = path_or_file
            self._own = False
        else:
            self._fh = open(path_or_file, "wb")
            self._own = True
        self._buf = bytearray()
        self._level = level
        self._coffset = 0

    def tell(self) -> int:
        """Virtual offset of the next byte to be written."""
        return make_virtual_offset(self._coffset, len(self._buf))

    def write(self, data: bytes) -> int:
        self._buf += data
        while len(self._buf) >= _MAX_BLOCK:
            self._flush_block(self._buf[:_MAX_BLOCK])
            del self._buf[:_MAX_BLOCK]
        return len(data)

    def flush(self):
        if self._buf:
            self._flush_block(bytes(self._buf))
            self._buf.clear()

    def _flush_block(self, payload: bytes):
        co = zlib.compressobj(self._level, zlib.DEFLATED, -15)
        comp = co.compress(payload) + co.flush()
        crc = zlib.crc32(payload) & 0xFFFFFFFF
        bsize = len(comp) + 25 + 1  # header(12) + XLEN payload(6) + footer(8)
        block = (
            b"\x1f\x8b\x08\x04" + b"\x00\x00\x00\x00" + b"\x00\xff"
            + struct.pack("<H", 6)
            + b"BC" + struct.pack("<H", 2) + struct.pack("<H", bsize - 1)
            + comp
            + struct.pack("<II", crc, len(payload))
        )
        assert len(block) == bsize
        self._fh.write(block)
        self._coffset += bsize

    def close(self):
        self.flush()
        self._fh.write(BGZF_EOF)
        if self._own:
            self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class BgzfReader:
    """Random-access BGZF reader with a small decompressed-block cache."""

    def __init__(self, path: str, cache_blocks: int = 64):
        self._fh = open(path, "rb")
        self._cache: dict[int, bytes] = {}
        self._cache_order: list[int] = []
        self._cache_blocks = cache_blocks
        self._coffset = 0       # compressed offset of current block
        self._block = b""
        self._uoffset = 0
        self._next_coffset = 0
        self._load_block(0)

    def _read_block_at(self, coffset: int) -> tuple[bytes, int]:
        """Return (payload, compressed size) of the block at coffset."""
        if coffset in self._cache:
            payload, bsize = self._cache[coffset]
            return payload, bsize
        fh = self._fh
        fh.seek(coffset)
        header = fh.read(12)
        if len(header) < 12:
            return b"", 0
        if header[:4] != b"\x1f\x8b\x08\x04":
            raise ValueError(f"not a BGZF block at offset {coffset}")
        xlen = struct.unpack("<H", header[10:12])[0]
        extra = fh.read(xlen)
        bsize = None
        i = 0
        while i + 4 <= len(extra):
            si1, si2, slen = extra[i], extra[i + 1], struct.unpack(
                "<H", extra[i + 2 : i + 4]
            )[0]
            if si1 == 0x42 and si2 == 0x43 and slen == 2:
                bsize = struct.unpack("<H", extra[i + 4 : i + 6])[0] + 1
            i += 4 + slen
        if bsize is None:
            raise ValueError("BGZF block missing BC subfield")
        comp = fh.read(bsize - 12 - xlen - 8)
        fh.read(8)  # CRC + ISIZE
        payload = zlib.decompress(comp, -15)
        self._cache[coffset] = (payload, bsize)
        self._cache_order.append(coffset)
        if len(self._cache_order) > self._cache_blocks:
            old = self._cache_order.pop(0)
            self._cache.pop(old, None)
        return payload, bsize

    def _load_block(self, coffset: int) -> bool:
        payload, bsize = self._read_block_at(coffset)
        self._coffset = coffset
        self._block = payload
        self._uoffset = 0
        self._next_coffset = coffset + bsize
        return bsize > 0

    def seek(self, voffset: int):
        coffset, uoffset = split_virtual_offset(voffset)
        if coffset != self._coffset or not self._block:
            if not self._load_block(coffset):
                raise EOFError(f"seek past EOF: {voffset}")
        self._uoffset = uoffset

    def tell(self) -> int:
        return make_virtual_offset(self._coffset, self._uoffset)

    def read(self, n: int) -> bytes:
        out = bytearray()
        while n > 0:
            avail = len(self._block) - self._uoffset
            if avail <= 0:
                if not self._load_block(self._next_coffset) or not self._block:
                    break
                continue
            take = min(n, avail)
            out += self._block[self._uoffset : self._uoffset + take]
            self._uoffset += take
            n -= take
        return bytes(out)

    def close(self):
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
