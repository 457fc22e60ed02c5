"""Inputs of the star consensus's vote and of its batched consensus that
the port's tests share on the CPU and on the card (no JAX is imported
here, so the card's tests can load it).

- `VOTE_CASES`: rounds written out as alignments: a cluster's target, its
  members and those equal to the target, and each other member's
  alignment as its column bases ("-" a gap) and its inserts by boundary.
  `vote_inputs` lays them out as `ops.poa_dp.vote` takes them.
- `random_clusters(seed)`: the clusters of tests/test_poa_batch.py's
  consensus test, plus a bimodal one (tests/test_torch_poa.py).
- `EDGE_CLUSTERS`: member sequences whose star alignment meets the same
  edges as `VOTE_CASES` (ties, insert support at n // 2, inserts at the
  first and last boundary, a pair on the host DP, a round with no pair).
"""
from __future__ import annotations

import numpy as np
import torch

BASES = "ACGT"
_CODE = {c: i for i, c in enumerate("ACGTN")}


def mutate(rng, seq, sub=0.05, ins=0.02, dele=0.02):
    out = []
    for c in seq:
        r = rng.random()
        if r < dele:
            continue
        if r < dele + sub:
            out.append(BASES[rng.integers(4)])
        else:
            out.append(c)
        if rng.random() < ins:
            out.append(BASES[rng.integers(4)])
    return "".join(out)


def rand_seq(rng, n):
    return "".join(BASES[i] for i in rng.integers(0, 4, n))


def random_clusters(seed: int) -> list[list[str]]:
    rng = np.random.default_rng(seed)
    clusters = []
    for _ in range(12):
        base = rand_seq(rng, int(rng.integers(30, 300)))
        k = int(rng.integers(1, 7))
        clusters.append([mutate(rng, base) for _ in range(k)])
    clusters.append([])
    clusters.append(["ACGT"])
    clusters.append(["ACGTACGT"] * 4)
    short, long_ = rand_seq(rng, 80), rand_seq(rng, 200)
    clusters.append([mutate(rng, short) for _ in range(3)]
                    + [mutate(rng, long_) for _ in range(5)])
    return clusters


# ---- the vote, written out ----------------------------------------------

def _pair(target: str, cols: dict | None = None, ins: dict | None = None):
    """A member's alignment to ``target``: its column bases (the target's,
    except at the columns of ``cols``), its inserts by boundary."""
    row = list(target)
    for j, b in (cols or {}).items():
        row[j] = b
    return "".join(row), dict(ins or {})


def _ties():
    t = "ACGTACGTACGT"
    col = {0: "AACC", 1: "CCGG", 2: "GG--", 3: "---T", 4: "TTNN",
           5: "NN--", 6: "ACGT", 7: "--AA"}
    pairs = [_pair(t, {j: v[k] for j, v in col.items()}) for k in range(4)]
    return [dict(target=t, n_members=4, n_equal=0, pairs=pairs),
            # C and G tie at 2 over the target's T with one equal member
            dict(target="TTTT", n_members=5, n_equal=1,
                 pairs=[_pair("TTTT", {1: b}) for b in "CCGG"])]


def _insert_half():
    t = "ACGTTGCAAC"
    # 4 members: "GG" in 2 (n // 2, dropped), "TTA" in 3 (kept); 5
    # members, one equal: "CA" in 2 (dropped), "GGG" in 3 (kept)
    four = [_pair(t, ins={3: "GG", 5: "TTA"})] * 2 + \
        [_pair(t, ins={5: "TTA"}), _pair(t)]
    five = [_pair(t, ins={2: "CA", 7: "GGG"})] * 2 + \
        [_pair(t, ins={7: "GGG"}), _pair(t)]
    return [dict(target=t, n_members=4, n_equal=0, pairs=four),
            dict(target=t, n_members=5, n_equal=1, pairs=five)]


def _equal_length_segments():
    t = "GATTACAGAT"
    tie = [_pair(t, ins={4: s}) for s in ("AC", "GT", "AC", "GT")]
    tie5 = tie + [_pair(t)]
    order = [_pair(t, ins={4: s}) for s in ("GT", "AC", "AC", "GT", "AC")]
    last = [_pair(t, ins={6: s}) for s in ("ACG", "ACT", "ACG", "ACT", "ACT")]
    return [dict(target=t, n_members=4, n_equal=0, pairs=tie),
            dict(target=t, n_members=5, n_equal=0, pairs=tie5),
            dict(target=t, n_members=5, n_equal=0, pairs=order),
            dict(target=t, n_members=5, n_equal=0, pairs=last)]


def _edge_boundaries():
    t = "CCGGAATT"
    m = len(t)
    pairs = [_pair(t, ins={0: "GATT", m: "ACA"}), _pair(t, ins={0: "GATT"}),
             _pair(t, ins={0: "GATT", m: "ACA"}), _pair(t, ins={m: "ACA"})]
    return [dict(target=t, n_members=4, n_equal=0, pairs=pairs)]


def _all_but_one_equal():
    t = "ACGTACGTAA"
    return [dict(target=t, n_members=5, n_equal=4,
                 pairs=[_pair(t, {2: "-", 5: "T"}, {4: "GGG"})])]


def _long_insert():
    rng = np.random.default_rng(23)
    t = rand_seq(rng, 40)
    seg = rand_seq(rng, 300)
    near = seg[:299] + ("A" if seg[299] != "A" else "C")
    pairs = [_pair(t, ins={17: seg}), _pair(t, ins={17: near}),
             _pair(t, ins={17: seg}), _pair(t, ins={17: seg})]
    return [dict(target=t, n_members=5, n_equal=1, pairs=pairs)]


def _inserts_past_longest_query():
    """Five members whose columns are all gaps, each with three of five
    inserts: every insert has 3 of 5, so all are kept, 20 bases against a
    longest query of 12 (below its bound of twice that)."""
    t = "ACGTAC"
    segs = ["AAAC", "CCCG", "GGGT", "TTTA", "ACGT"]
    pairs = [_pair(t, dict.fromkeys(range(len(t)), "-"),
                   {b + 1: segs[b] for b in ((k + d) % 5 for d in range(3))})
             for k in range(5)]
    return [dict(target=t, n_members=5, n_equal=0, pairs=pairs)]


VOTE_CASES = {
    "column_ties": _ties(),
    "insert_half": _insert_half(),
    "equal_length_segments": _equal_length_segments(),
    "edge_boundaries": _edge_boundaries(),
    "all_but_one_equal": _all_but_one_equal(),
    "long_insert": _long_insert(),
    "inserts_past_longest_query": _inserts_past_longest_query(),
    "no_pairs": [dict(target="ACGTN", n_members=3, n_equal=3, pairs=[])],
    "all_gaps": [dict(target="ACG", n_members=2, n_equal=0,
                      pairs=[_pair("ACG", dict.fromkeys(range(3), "-"))] * 2)],
}
VOTE_CASES["all"] = [c for cs in VOTE_CASES.values() for c in cs]


def query_of(cols: str, ins: dict) -> str:
    """The member's query: each boundary's insert, then its column's base."""
    return "".join(ins.get(j, "") + (cols[j] if j < len(cols) and
                                     cols[j] != "-" else "")
                   for j in range(len(cols) + 1))


def codes(s: str) -> np.ndarray:
    return np.array([_CODE[c] for c in s], np.int8)


def vote_inputs(clusters, device="cpu"):
    """(cols, ins, qpad, meta, targets, total) of `ops.poa_dp.vote` for
    ``clusters`` (dicts of `VOTE_CASES`), on ``device``."""
    pairs = [p for c in clusters for p in c["pairs"]]
    M = max([len(c["target"]) for c in clusters], default=0)
    queries = [query_of(*p) for p in pairs]
    N = max(map(len, queries), default=0)
    cols = np.full((len(pairs), M), -1, np.int8)
    ins = np.zeros((len(pairs), M + 1), np.int32)
    qpad = np.full((len(pairs), N), 5, np.int8)
    for b, ((row, segs), q) in enumerate(zip(pairs, queries)):
        cols[b, :len(row)] = [-1 if c == "-" else _CODE[c] for c in row]
        for j, s in segs.items():
            ins[b, j] = len(s)
        qpad[b, :len(q)] = codes(q)
    meta, lo, t_off, o_off = [], 0, 0, 0
    for c in clusters:
        m, hi = len(c["target"]), lo + len(c["pairs"])
        cap = m + 2 * max(map(len, queries[lo:hi]), default=0)
        meta.append((lo, hi, m, c["n_members"], c["n_equal"], t_off, o_off,
                     cap))
        lo, t_off, o_off = hi, t_off + m, o_off + cap
    targets = np.concatenate([codes(c["target"]) for c in clusters]
                             + [np.zeros(0, np.int8)])
    return (*(torch.from_numpy(a).to(device) for a in (
        cols, ins, qpad, np.array(meta, np.int64).reshape(-1, 8), targets)),
        4 * len(clusters) + o_off)


def vote_strings(out: torch.Tensor, meta: torch.Tensor) -> list:
    """Each cluster's vote output: its string, or None for length -1."""
    buf = out.cpu().numpy()
    rows = meta.tolist()
    C = len(rows)
    lens = buf[:4 * C].view(np.int32).tolist()
    return [None if n < 0 else
            buf[4 * C + r[6]:4 * C + r[6] + n].tobytes().decode("ascii")
            for r, n in zip(rows, lens)]


# ---- the same edges through whole clusters ----------------------------

def _rng_base(seed: int, n: int = 40) -> str:
    return rand_seq(np.random.default_rng(seed), n)


def _edit(b: str, at: dict) -> str:
    """``b`` with base j replaced by at[j] ("" deletes it)."""
    return "".join(at.get(j, c) for j, c in enumerate(b))


def _shifted(b: str, ins_at: int, seg: str, del_at: int) -> str:
    """``b`` with ``seg`` inserted before base ins_at and len(seg) bases
    deleted from del_at: the same length, so the length medoid stays put."""
    out = b[:del_at] + b[del_at + len(seg):]
    return out[:ins_at] + seg + out[ins_at:]


def _edge_clusters() -> dict:
    """Each case's clusters (lists of member sequences).  The length
    medoid is the member at index len // 2 of the members sorted by
    length (stable), so the inserts below are balanced by deletions to
    keep every member at one length and put the seed where it is wanted.
    `host_dp_degenerate`: a 30-base member against its 32-base seed has a
    band (64) past the summed lengths; `host_dp_band_cap` is meant for a
    band cap of 80, past which its 300- and 483-base members fall against
    the 399-base seed."""
    B = _rng_base(31)
    ins5 = _shifted(B, 20, "GGATC", 30)
    ties = [_edit(B, {10: "G"}), _edit(B, {10: "G", 20: "T"}),
            _edit(B, {10: "C"}), _edit(B, {10: "C", 25: "A"})]
    gap_tie = [_edit(B, {30: ""}), _edit(B, {30: "", 5: "T"}), B,
               _edit(B, {12: "A"})]
    half = [ins5, ins5, B, B]
    half5 = [ins5, ins5, B, _edit(B, {3: "T"}), B]
    above = [ins5, ins5, B, ins5, B]
    segs = [_shifted(B, 20, "ACGTA", 30), _shifted(B, 20, "ACGTA", 30), B,
            _shifted(B, 20, "TGCAT", 30), _shifted(B, 20, "TGCAT", 30)]
    edge = "GATTACA" + B[:10] + B[24:] + "CCTTGGA"
    rng = np.random.default_rng(5)
    one_off = [B, B, mutate(rng, B, sub=0.1, ins=0.1), B, B]
    S = _rng_base(37, 32)
    short = [S, S[:15] + S[17:], S[:20] + "TTG" + S[20:], S[:9] + "A" + S[9:],
             S]
    L = _rng_base(41, 460)
    spread = [mutate(rng, L[:k], sub=0.03, ins=0.0, dele=0.0)
              for k in (300, 327, 356, 388, 422, 460)]
    return {"column_ties": [ties, gap_tie], "insert_half": [half, half5],
            "insert_above_half": [above],
            "equal_length_segments": [segs],
            "edge_boundaries": [[edge, edge, B, edge, B]],
            "all_but_one_equal": [one_off],
            "host_dp_degenerate": [short], "host_dp_band_cap": [spread],
            # every member equal to its seed: a round with no pair
            "no_pairs": [["ACGTACGTTT"] * 4, ["GGCA"] * 3]}


EDGE_CLUSTERS = _edge_clusters()
