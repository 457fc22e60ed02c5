"""The port's batched CIGAR evidence walk and window grouping
(svtrek_tpu_torch.ops.cigar) against svtrek_tpu.ops.cigar on the CPU:
bit-identical candidates, counts, sorted window rows and read_cap
overflow flags on the random reads and hand-built break / soft-clip edges
of tests/test_cigar_kernel.py, on rows whose positions wrap int32, and
the searchsorted rank-select against the JAX broadcast form; and the flat
walk (`walk_runs`, `group_walk`) against the JAX walk at a read_cap that
keeps every candidate, on reads past 16,384 ops."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svtrek_tpu import constants as C
from svtrek_tpu.constants import (
    CIGAR_D, CIGAR_H, CIGAR_I, CIGAR_M, CIGAR_S, KIND_DEL_END,
    KIND_DEL_START, KIND_INS, KIND_INV_END, KIND_POINT,
)
from svtrek_tpu.ops import cigar as jcigar
from svtrek_tpu_torch.ops import cigar as tcigar
from tests.test_cigar_kernel import pack_reads, random_read

PAD = C.I32_MAX
KINDS = [KIND_DEL_START, KIND_DEL_END, KIND_INS, KIND_POINT, KIND_INV_END]


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(np.asarray(a)))


def _per_read(packed, B):
    """extract_read_candidates' per-read inputs of a pack_reads batch."""
    ops, lens, pos, n_ops, wid, kind, istart, iend, _ = packed
    wc = np.clip(wid, 0, B - 1)
    return ops, lens, pos, n_ops, kind[wc], istart[wc], iend[wc]


def _extract_both(args):
    want = [np.asarray(x) for x in jcigar.extract_read_candidates(*args)]
    got = [x.numpy() for x in tcigar.extract_read_candidates(
        *(_t(a) for a in args))]
    return want, got


def _random_tasks(rng, n_tasks, max_reads, kinds=KINDS):
    tasks = []
    for _ in range(n_tasks):
        base = int(rng.integers(20_000, 200_000))
        reads = [random_read(rng, base)
                 for _ in range(int(rng.integers(0, max_reads)))]
        tasks.append((int(rng.choice(kinds)), reads,
                      base - int(rng.integers(500, 4000)),
                      base + int(rng.integers(500, 4000)), base))
    return tasks


@pytest.mark.parametrize("seed", range(6))
def test_extract_matches_jax(seed):
    rng = np.random.default_rng(seed)
    tasks = _random_tasks(rng, 24, 12)
    args = _per_read(pack_reads(tasks, 32, pad_n=256), len(tasks))
    (wc, wn), (gc, gn) = _extract_both(args)
    assert gc.dtype == np.int32 and gn.dtype == np.int32
    np.testing.assert_array_equal(gc, wc)
    np.testing.assert_array_equal(gn, wn)
    assert (wc < PAD).sum() > 10


def test_break_and_softclip_edges_match_jax():
    """tests/test_cigar_kernel.py's hand-built boundary reads: the D op
    that crosses the interval end, the trailing clip on and one past the
    end, leading clips with and without an early break, H advancing the
    walk, D of exactly 50 (not evidence) and I of exactly 50 (evidence),
    under every task kind."""
    iend = 10_000
    reads = [
        (9_800, [(CIGAR_M, 150), (CIGAR_D, 60), (CIGAR_M, 100)]),
        (9_900, [(CIGAR_M, 100), (CIGAR_S, 50)]),
        (9_901, [(CIGAR_M, 100), (CIGAR_S, 50)]),
        (9_950, [(CIGAR_S, 30), (CIGAR_M, 20)]),
        (9_990, [(CIGAR_S, 30), (CIGAR_M, 100), (CIGAR_M, 500)]),
        (9_000, [(CIGAR_H, 500), (CIGAR_D, 60), (CIGAR_M, 10)]),
        (9_500, [(CIGAR_M, 10), (CIGAR_D, 50), (CIGAR_M, 10)]),
        (9_500, [(CIGAR_M, 10), (CIGAR_I, 50), (CIGAR_M, 10)]),
        (8_999, [(CIGAR_S, 5)]),
    ]
    tasks = [(k, reads, 9_000, iend, 9_950) for k in KINDS]
    args = _per_read(pack_reads(tasks, 8), len(tasks))
    (wc, wn), (gc, gn) = _extract_both(args)
    np.testing.assert_array_equal(gc, wc)
    np.testing.assert_array_equal(gn, wn)
    # The oracle's values, as tests/test_cigar_kernel.py states them.
    r = len(reads)
    assert sorted(v for v in gc[0] if v < PAD) == [9_950]           # DEL_START
    assert sorted(v for v in gc[r + 3] if v < PAD) == [9_971]       # DEL_END
    assert sorted(v for v in gc[2 * r + 7] if v < PAD) == [9_510]   # INS


def test_int32_wrap_rows_match_jax():
    """Rows whose running position passes INT32_MAX (pos + cumsum and the
    D op's end + 1 wrap to negative), a walk that stops on a wrapped
    position, a soft clip at the wrapped end, and intervals at the int32
    edges: JAX's int32 cumsum wraps, so must the port's."""
    big = 2**31 - 1
    reads = [
        (big - 100, [(CIGAR_M, 50), (CIGAR_D, 60), (CIGAR_M, 200)]),
        (big - 40, [(CIGAR_M, 30), (CIGAR_D, 70), (CIGAR_I, 80),
                    (CIGAR_S, 20)]),
        (big - 10, [(CIGAR_S, 40), (CIGAR_M, 5), (CIGAR_D, 51)]),
        (2**31 - 2_000, [(CIGAR_M, 1_500), (CIGAR_I, 60), (CIGAR_M, 700),
                         (CIGAR_D, 90), (CIGAR_S, 30)]),
        (100, [(CIGAR_M, 2**30), (CIGAR_M, 2**30), (CIGAR_D, 55),
               (CIGAR_I, 55), (CIGAR_S, 10)]),
    ]
    tasks = []
    for k in KINDS:
        for lo, hi in [(-2**31, big), (big - 500, big), (0, 2**31 - 5),
                       (-2**31, -2**31 + 100)]:
            tasks.append((k, reads, lo, hi, big - 50))
    args = _per_read(pack_reads(tasks, 8), len(tasks))
    (wc, wn), (gc, gn) = _extract_both(args)
    np.testing.assert_array_equal(gc, wc)
    np.testing.assert_array_equal(gn, wn)
    assert (wc[(wc < PAD)] < 0).any(), "no candidate wrapped negative"


def _group_both(cand, wid, B, K, read_cap=8):
    want = [np.asarray(x) for x in jcigar.group_candidates_by_window(
        cand, wid, B, K, read_cap)]
    got = [x.numpy() for x in tcigar.group_candidates_by_window(
        _t(cand), _t(wid), B, K, read_cap)]
    return want, got


def _grouped_batch(rng, B, n_reads, Cw, fill):
    """Window-contiguous reads (ascending window ids, padding last) whose
    candidate rows hold ``fill`` valid values on average, unsorted, PAD
    elsewhere; some windows have no reads."""
    wid = np.sort(rng.integers(0, B, n_reads)).astype(np.int32)
    wid[-max(1, n_reads // 8):] = B
    cand = np.where(rng.random((n_reads, Cw)) < fill / Cw,
                    rng.integers(-2**31, 2**31 - 1, (n_reads, Cw)),
                    PAD).astype(np.int32)
    return cand, wid


@pytest.mark.parametrize("seed,K,read_cap,fill", [
    (0, 64, 8, 2.0),      # no overflow
    (1, 16, 8, 4.0),      # counts > K in many windows
    (2, 64, 8, 9.0),      # read_cap overflow in many reads
    (3, 128, 4, 3.0),     # a small read_cap
    (4, 64, 16, 12.0),    # a wide read_cap, both overflows
])
def test_group_matches_jax(seed, K, read_cap, fill):
    rng = np.random.default_rng(100 + seed)
    B = 24
    cand, wid = _grouped_batch(rng, B, 160, 33, fill)
    (wl, wcnt, wovf), (gl, gcnt, govf) = _group_both(cand, wid, B, K,
                                                     read_cap)
    assert gl.dtype == np.int32 and gcnt.dtype == np.int32
    assert govf.dtype == np.bool_
    np.testing.assert_array_equal(gl, wl)
    np.testing.assert_array_equal(gcnt, wcnt)
    np.testing.assert_array_equal(govf, wovf)
    if fill > read_cap:
        assert wovf.any()
    if seed == 1:
        assert (wcnt > K).any()


def test_group_of_extracted_candidates_matches_jax():
    """The grouping of the walk's own output, as audit_refine_step chains
    them, with the reads of a window past read_cap (many D > 50 ops)."""
    rng = np.random.default_rng(7)
    tasks = _random_tasks(rng, 16, 10, kinds=[KIND_DEL_START, KIND_INS])
    many = (30_000, [(CIGAR_M, 10), (CIGAR_D, 60)] * 12)
    tasks.append((KIND_DEL_START, [many, many], 29_000, 40_000, 30_000))
    packed = pack_reads(tasks, 32, pad_n=256)
    cand = np.asarray(jcigar.extract_read_candidates(
        *_per_read(packed, len(tasks)))[0])
    (wl, wcnt, wovf), (gl, gcnt, govf) = _group_both(cand, packed[4],
                                                     len(tasks), 64)
    np.testing.assert_array_equal(gl, wl)
    np.testing.assert_array_equal(gcnt, wcnt)
    np.testing.assert_array_equal(govf, wovf)
    assert wovf[-1] and wcnt[-1] == 24


@pytest.mark.parametrize("read_cap,Cw", [(8, 1), (8, 33), (16, 257)])
def test_rank_select_searchsorted_equals_broadcast(read_cap, Cw):
    """col_j by searchsorted on the inclusive rank rows equals JAX's
    broadcast-compare count over [N, read_cap, Cw], rows with fewer valid
    columns than read_cap and empty rows included."""
    rng = np.random.default_rng(Cw)
    valid = rng.random((200, Cw)) < rng.random((200, 1))
    valid[:5] = False
    rank = torch.cumsum(torch.from_numpy(valid), 1, dtype=torch.int32)
    j = torch.arange(1, read_cap + 1, dtype=torch.int32)
    broadcast = (rank[:, None, :] < j[None, :, None]).sum(-1)
    got = torch.searchsorted(rank, j.expand(200, read_cap).contiguous())
    assert torch.equal(got, broadcast)
    jax_cols = np.asarray(jnp.sum(
        jnp.asarray(rank.numpy())[:, None, :] <
        jnp.asarray(j.numpy())[None, :, None], axis=-1))
    np.testing.assert_array_equal(got.numpy(), jax_cols)


def test_walk_calls_count_by_device():
    before = tcigar.walk_calls["cpu"]
    rng = np.random.default_rng(1)
    args = _per_read(pack_reads(_random_tasks(rng, 3, 3), 16), 3)
    tcigar.extract_read_candidates(*(_t(a) for a in args))
    assert tcigar.walk_calls["cpu"] == before + 1


def _long_read(rng, base, n_pairs):
    """A read of 2 * n_pairs ops, small M runs and D runs of which about a
    third pass 50 bp, so that it holds many candidates in its window."""
    cig = []
    for _ in range(n_pairs):
        cig.append((CIGAR_M, int(rng.integers(1, 4))))
        cig.append((CIGAR_D if rng.random() < 0.7 else CIGAR_I,
                    int(rng.choice([2, 51, 60]))))
    return base - int(rng.integers(0, 400)), cig


def _csr(packed):
    """The flat streams of a pack_reads batch (its reads' runs end to end)."""
    ops, lens, pos, n_ops, *rest = packed
    keep = np.arange(ops.shape[1])[None, :] < n_ops[:, None]
    return (ops[keep].astype(np.uint8), lens[keep], pos, n_ops, *rest)


@pytest.mark.parametrize("seed", range(3))
def test_flat_walk_matches_jax_at_full_width(seed):
    """walk_runs over the flat CSR streams and group_walk against JAX's
    extract_read_candidates on the padded layout and
    group_candidates_by_window with read_cap the batch's largest per-read
    count (so JAX keeps every candidate too): reads past 16,384 ops with
    tens of candidates in one window, random reads, and rows that wrap
    int32.  Every slot's candidate, every clip, each window's row and
    count are equal."""
    rng = np.random.default_rng(300 + seed)
    tasks = _random_tasks(rng, 10, 8, kinds=KINDS)
    for k in (KIND_DEL_START, KIND_DEL_END, KIND_INS, KIND_INV_END):
        base = int(rng.integers(40_000, 60_000))
        long = _long_read(rng, base, 8_200 + int(rng.integers(0, 40)))
        tasks.append((k, [long, random_read(rng, base),
                          _long_read(rng, base, 20)],
                      base - 2_000, base + int(rng.integers(500, 3_000)),
                      base))
    big = 2**31 - 1
    tasks.append((KIND_DEL_END, [(big - 60, [(CIGAR_S, 9), (CIGAR_M, 30),
                                             (CIGAR_D, 70), (CIGAR_M, 90),
                                             (CIGAR_D, 55)])],
                  big - 500, big, big - 50))
    B, K = len(tasks), 32
    O = max(len(c) for _, reads, *_ in tasks for _, c in reads)
    assert O > 16_384
    packed = pack_reads(tasks, O)
    args = _per_read(packed, B)
    jc, jn = (np.asarray(x) for x in jcigar.extract_read_candidates(*args))
    cap = int(jn.max())
    assert cap > 8
    jl, jcnt, jovf = (np.asarray(x) for x in jcigar.group_candidates_by_window(
        jc, packed[4], B, K, cap))
    assert not jovf.any() and (jcnt > K).any()

    ops, lens, pos, n_ops, wid, *_ = _csr(packed)
    wc = np.clip(wid, 0, B - 1)
    op_cand, op_mask, clip, clip_ok, row = tcigar.walk_runs(
        *(_t(a) for a in (ops, lens, pos, n_ops, packed[5][wc],
                          packed[6][wc], packed[7][wc])))
    keep = np.arange(O)[None, :] < n_ops[:, None]
    np.testing.assert_array_equal(op_cand.numpy(), jc[:, :O][keep])
    np.testing.assert_array_equal(clip.numpy(), jc[:, O])
    count = np.bincount(row.numpy(), op_mask.numpy(), len(n_ops)) + \
        clip_ok.numpy()
    np.testing.assert_array_equal(count, jn)
    tl, tcnt = tcigar.group_walk(op_cand, row, clip, _t(wid), B, K)
    np.testing.assert_array_equal(tl.numpy(), jl)
    np.testing.assert_array_equal(tcnt.numpy(), jcnt)
    assert (jc[(jc < PAD)] < 0).any(), "no candidate wrapped negative"
