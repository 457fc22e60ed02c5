"""FASTQ reading (plain or gzip), replacing the reference's kseq usage
(parse_fq, discover.c:381-407)."""
from __future__ import annotations

import gzip
from typing import Iterator

_COMP = str.maketrans("ACGTacgtNn", "TGCAtgcaNn")


def reverse_complement(seq: str) -> str:
    return seq.translate(_COMP)[::-1]


def iter_fastq(path: str, names=None) -> Iterator[tuple[str, str]]:
    """Yield (name, sequence). Name is the first whitespace token.

    Reads in 4 MiB binary chunks and splits lines in bulk (the
    per-record readline loop was the disc pipeline's second-largest
    host cost at 100k reads).  With ``names`` (a set), records whose
    name is not in it are skipped without decoding the sequence —
    the consensus stage only needs the handful of cluster-supporting
    reads out of the whole file."""
    opener = gzip.open if path.endswith(".gz") else open
    if names is not None and not isinstance(names, (set, frozenset, dict)):
        names = set(names)

    def records(pend):
        n4 = len(pend) - (len(pend) % 4)
        for i in range(0, n4, 4):
            hdr = pend[i]
            # split() drops all whitespace incl. '\r'; a degenerate
            # header that is ONLY whitespace ('@\r') yields name "".
            toks = hdr[1:].split(None, 1) if len(hdr) > 1 else []
            name = toks[0].decode() if toks else ""
            if names is None or name in names:
                # CRLF input: splitting on b'\n' alone leaves a '\r' on
                # every line; the header's whitespace split already drops
                # it, the sequence needs an explicit strip (ADVICE r4).
                yield name, pend[i + 1].rstrip(b"\r").decode()
        del pend[:n4]

    with opener(path, "rb") as fh:
        tail = b""
        pend: list[bytes] = []
        while True:
            chunk = fh.read(1 << 22)
            if not chunk:
                break
            parts = (tail + chunk).split(b"\n")
            tail = parts.pop()
            pend.extend(parts)
            yield from records(pend)
        if tail:
            pend.append(tail)
        # A final record may end without a trailing quality line or
        # newline; pad so the header/sequence pair still yields (the
        # readline implementation returned "" for the missing lines).
        if len(pend) % 4 in (2, 3):
            pend.extend([b""] * (4 - len(pend) % 4))
        yield from records(pend)
