"""GFA (pangenome graph) parsing.

Models the reference's parse_gfa (discover.c:248-379): S-lines become
segments (numeric id, sequence, rank default 1), the P-line walk assigns
rank 0 and cumulative reference-backbone coordinates, L-lines chain
rank-1 (alt) segments and reject nonzero overlaps, and a final pass
assigns cumulative coordinates along alt chains.

Deliberate fix over the reference: the reference's chain-coordinate pass
only fires on nodes with `next == NULL` (discover.c:361), which skips
every real multi-node chain head — an ineffective pass.  Here chains are
walked from their heads (start == 0), assigning cumulative coordinates
correctly; rank-1 coordinates are not used by detection, so parity is
unaffected.
"""
from __future__ import annotations

from dataclasses import dataclass, field


class GfaError(ValueError):
    pass


@dataclass
class Segment:
    id: int
    seq: str
    rank: int = 1
    start: int = -1
    end: int = 0
    next_id: int | None = None      # alt-chain successor (rank-1 → rank-1)


@dataclass
class Gfa:
    segments: list[Segment] = field(default_factory=list)
    by_id: dict[int, int] = field(default_factory=dict)   # id → index

    def seg(self, seg_id: int) -> Segment:
        return self.segments[self.by_id[seg_id]]


def parse_gfa(path: str) -> Gfa:
    g = Gfa()
    links: list[tuple[int, int, int]] = []   # (id1, id2, overlap)

    with open(path) as fh:
        for line in fh:
            line = line.rstrip("\n")
            if not line:
                continue
            if line[0] == "S":
                f = line.split("\t")
                seg = Segment(id=int(f[1]), seq=f[2])
                seg.end = len(seg.seq)
                g.by_id[seg.id] = len(g.segments)
                g.segments.append(seg)
            elif line[0] == "P":
                f = line.split("\t")
                ref_pos = 0
                for tok in f[2].split(","):
                    if tok.endswith("+") or tok.endswith("-"):
                        tok = tok[:-1]
                    seg = g.seg(int(tok))
                    seg.rank = 0
                    seg.start = ref_pos
                    ref_pos += len(seg.seq)
                    seg.end = ref_pos
            elif line[0] == "L":
                f = line.split("\t")
                overlap = f[5] if len(f) > 5 else "0M"
                ov = int(overlap.rstrip("M") or 0)
                if ov:
                    # Reference exits on nonzero overlap (discover.c:330-333).
                    raise GfaError(
                        "[ERROR] Overlaps are not zero, cannot make conversion."
                    )
                links.append((int(f[1]), int(f[3]), ov))

    for id1, id2, _ in links:
        if id1 not in g.by_id or id2 not in g.by_id:
            raise GfaError(f"[ERROR] Segment {id1 if id1 not in g.by_id else id2} does not exists.")
        s1, s2 = g.seg(id1), g.seg(id2)
        if s1.rank and s2.rank:
            s1.next_id = id2
        elif s1.rank == 0 and s2.rank:
            s2.start = 0
            s2.end = len(s2.seq)

    # Cumulative coordinates along alt chains, walked from heads.
    has_pred = {s.next_id for s in g.segments if s.next_id is not None}
    for s in g.segments:
        if s.rank == 1 and s.start == 0 and s.id not in has_pred:
            path_length = 0
            cur: Segment | None = s
            while cur is not None:
                cur.start = path_length
                path_length += len(cur.seq)
                cur.end = path_length
                cur = g.seg(cur.next_id) if cur.next_id is not None else None
    return g
