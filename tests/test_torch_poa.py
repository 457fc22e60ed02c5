"""The port's star-POA consensus (svtrek_tpu_torch.ops.poa, poa_dp,
poa_batch) against the JAX package on the CPU, tolerance 0 throughout:

- the plain DP pointers (`dp_ptr_reference`) against the Pallas kernel
  `dp_ptr_pallas` in interpret mode, on the first 2W+1 lanes of every
  row 1..n;
- the plain traceback (`traceback_reference`) on those pointers against
  `tb_batch_pallas` in interpret mode and against the XLA `_dp_cols_batch`;
- `dp_cols`, `banded_cols_batch` and `consensus_sequence_batch` against
  the JAX functions and the scalar `consensus_sequence`;
- results that do not change with the storage width W, the padded widths
  or the plain path's chunking;
- the host helpers copied from svtrek_tpu/ops/poa.py.

The CUDA kernels K2 and K3 are checked against the same plain versions on
the card by chip_smoke.py."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from svtrek_tpu.ops import poa as jpoa
from svtrek_tpu.ops import poa_batch as jbatch
from svtrek_tpu.ops.poa_pallas import (
    _round_up, dp_ptr_pallas, tb_batch_pallas,
)
from svtrek_tpu_torch import kernels
from svtrek_tpu_torch.ops import poa, poa_batch, poa_dp
from tests.test_poa_batch import _mutate as _mutate_batch
from tests.test_poa_batch import _rand_seq
from tests.test_poa_pallas import _build


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _degenerate():
    """Empty query, empty target, n >> m and n ~ m (test_poa_pallas.py:73)."""
    rng = np.random.default_rng(5)
    B, Mp, Np = 4, 128, 128
    tpad = np.full((B, Mp), 5, np.int8)
    qpad = np.full((B, Np), 5, np.int8)
    ms = np.array([40, 0, 10, 60], np.int32)
    ns = np.array([0, 40, 50, 55], np.int32)
    for i in range(B):
        tpad[i, : ms[i]] = rng.integers(0, 4, ms[i]).astype(np.int8)
        qpad[i, : ns[i]] = rng.integers(0, 4, ns[i]).astype(np.int8)
    bands = np.maximum(8, np.abs(ns - ms) + 1).astype(np.int32)
    return tpad, ms, qpad, ns, bands, 64


def _overrun():
    """m = 1011 in a 1024 bucket against n = 1048 (test_poa_batch.py:96)."""
    rng = np.random.default_rng(11)
    m, n = 1011, 1048
    t = rng.integers(0, 4, m).astype(np.int8)
    q = np.concatenate([t[: m // 2], rng.integers(0, 4, n - m).astype(np.int8),
                        t[m // 2:]])
    tpad = np.full((1, 1024), 5, np.int8)
    qpad = np.full((1, 1152), 5, np.int8)
    tpad[0, :m], qpad[0, :n] = t, q
    band = max(16, n - m + 1)
    return (tpad, np.array([m], np.int32), qpad, np.array([n], np.int32),
            np.array([band], np.int32), 64)


# (seed, B, M, band) of tests/test_poa_pallas.py::test_pallas_matches_xla
PALLAS_CASES = [(1, 8, 200, 16), (2, 5, 60, 8), (3, 16, 300, 32),
                (4, 4, 500, 64), (10, 2, 900, 64)]


def _case(name):
    if name == "degenerate":
        return _degenerate()
    if name == "overrun":
        return _overrun()
    if name == "b300":  # not a multiple of the TPU's 256-pair tile
        return _build(np.random.default_rng(7), 300, 30, 8, jitter=4)[:6]
    seed, B, M, band = PALLAS_CASES[int(name)]
    return _build(np.random.default_rng(seed), B, M, band)[:6]


CASES = [str(i) for i in range(len(PALLAS_CASES))] + [
    "degenerate", "overrun", "b300"]


def _pallas_ptr(tpad, ms, qpad, ns, bands, W):
    """dp_ptr_pallas in interpret mode, its inputs padded as
    dp_cols_batch_pallas pads them (poa_pallas.py:424-441)."""
    B, M = tpad.shape
    N = qpad.shape[1]
    WP = _round_up(2 * W + 1, 128)
    WPW = 128
    while WPW < WP + 128:
        WPW *= 2
    tbig = np.full((B, _round_up(max(M + 2 * W + 2, N + WPW + 1), 128)), 5,
                   np.int8)
    tbig[:, W + 1:W + 1 + M] = tpad
    qbig = np.full((B, _round_up(N, 128) + 128), 5, np.int8)
    qbig[:, :N] = qpad
    return np.asarray(dp_ptr_pallas(tbig, qbig, ms, bands, W=W, N=N,
                                    Bt=B, interpret=True))


@pytest.mark.parametrize("name", ["0", "1", "3", "degenerate"])
def test_dp_ptr_matches_pallas_and_traceback_matches_tb_pallas(name):
    tpad, ms, qpad, ns, bands, W = _case(name)
    got = poa_dp.dp_ptr_reference(*_t(tpad, ms, qpad, ns, bands), W=W)
    want = _pallas_ptr(tpad, ms, qpad, ns, bands, W)
    assert got.shape == (qpad.shape[1], len(ms), 2 * W + 1)
    for b in range(len(ms)):
        np.testing.assert_array_equal(got[: ns[b], b].numpy(),
                                      want[: ns[b], b, : 2 * W + 1])
    # The traceback over the Pallas kernel's own pointers, in K2's layout.
    lanes = torch.from_numpy(want[:, :, :2 * W + 1].copy())
    ptr = poa_dp.pointers_by_pair(lanes, *_t(ns, bands), W=W)
    offsets = kernels.poa_ptr_offsets(*_t(ns, bands))
    cols, ins = poa_dp.traceback_reference(
        ptr, offsets, *_t(qpad, ms, ns, bands), M=tpad.shape[1])
    cols_p, ins_p = (np.asarray(x) for x in tb_batch_pallas(
        want, qpad, ms, ns, W=W, M=tpad.shape[1], Bt=len(ms),
        interpret=True))
    np.testing.assert_array_equal(cols.numpy(), cols_p)
    np.testing.assert_array_equal(ins.numpy(), ins_p)


@pytest.mark.parametrize("name", CASES)
def test_dp_cols_matches_xla(name):
    """dp_cols (plain DP + traceback) against the XLA _dp_cols_batch, which
    the JAX package's own tests hold equal to the Pallas kernels."""
    tpad, ms, qpad, ns, bands, W = _case(name)
    want_cols, want_ins = (np.asarray(x) for x in jbatch._dp_cols_batch(
        tpad, ms, qpad, ns, bands, W=W))
    cols, ins = poa_dp.dp_cols(*_t(tpad, ms, qpad, ns, bands))
    assert cols.dtype == torch.int8 and ins.dtype == torch.int32
    np.testing.assert_array_equal(cols.numpy(), want_cols)
    np.testing.assert_array_equal(ins.numpy(), want_ins)


@pytest.mark.parametrize("name", ["1", "3", "degenerate", "overrun"])
def test_results_do_not_depend_on_storage_or_padding(name, monkeypatch):
    """A pair's pointers on its own band, its walk and its columns depend
    only on its m, n and band: not on the storage W, the padded widths or
    how the plain path chunks the batch."""
    tpad, ms, qpad, ns, bands, W = _case(name)
    args = _t(tpad, ms, qpad, ns, bands)
    by_pair = poa_dp.pointers_by_pair(
        poa_dp.dp_ptr_reference(*args, W=W), *_t(ns, bands), W=W)
    wide_t = np.full((len(ms), tpad.shape[1] + 77), 5, np.int8)
    wide_q = np.full((len(ms), qpad.shape[1] + 131), 5, np.int8)
    wide_t[:, : tpad.shape[1]], wide_q[:, : qpad.shape[1]] = tpad, qpad
    wide = _t(wide_t, ms, wide_q, ns, bands)
    W2 = 2 * W + 3
    assert torch.equal(by_pair, poa_dp.pointers_by_pair(
        poa_dp.dp_ptr_reference(*wide, W=W2), *_t(ns, bands), W=W2))
    cols, ins = poa_dp.dp_cols(*args)
    monkeypatch.setattr(poa_dp, "PLAIN_CHUNK_BYTES", 1)  # a chunk per pair
    cols_w, ins_w = poa_dp.dp_cols(*wide)
    assert torch.equal(cols_w[:, : tpad.shape[1]], cols)
    assert torch.equal(ins_w[:, : tpad.shape[1] + 1], ins)
    assert (cols_w[:, tpad.shape[1]:] == -1).all()
    assert (ins_w[:, tpad.shape[1] + 1:] == 0).all()


def test_dp_cols_dispatch_by_device():
    """CPU tensors take the plain path and count it; a band that does not
    reach the walk's start cell is refused; the CUDA wrappers refuse CPU
    tensors instead of computing on them."""
    tpad, ms, qpad, ns, bands, _ = _case("1")
    args = _t(tpad, ms, qpad, ns, bands)
    before = dict(poa_dp.plain_calls)
    poa_dp.dp_cols(*args)
    assert poa_dp.plain_calls["poa_dp_ptr"] == before["poa_dp_ptr"] + 1
    assert poa_dp.plain_calls["poa_traceback"] == before["poa_traceback"] + 1
    with pytest.raises(ValueError, match="band >= "):
        poa_dp.dp_cols(*args[:4], torch.zeros_like(args[4]))
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernels.poa_dp_ptr_cuda(*args)
    offsets = kernels.poa_ptr_offsets(args[3], args[4])
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernels.poa_traceback_cuda(torch.zeros(int(offsets[-1]),
                                               dtype=torch.int8), offsets,
                                   args[2], args[1], args[3], args[4],
                                   M=tpad.shape[1])


def test_banded_cols_batch_matches_jax_and_scalar():
    """tests/test_poa_batch.py::test_banded_cols_matches_scalar's pairs:
    random lengths, unrelated pairs and extreme length mismatches (band
    forced wide, or past the summed lengths: the scalar host path)."""
    rng = np.random.default_rng(7)
    targets, queries = [], []
    for _ in range(40):
        t = _rand_seq(rng, int(rng.integers(5, 220)))
        q = _mutate_batch(rng, t, sub=0.1, ins=0.05, dele=0.05)
        targets.append(jpoa.encode(t))
        queries.append(jpoa.encode(q if q else "A"))
    for m, n in [(8, 200), (200, 8), (3, 3), (1, 40)]:
        targets.append(jpoa.encode(_rand_seq(rng, m)))
        queries.append(jpoa.encode(_rand_seq(rng, n)))
    got_cols, got_segs = poa_batch.banded_cols_batch(targets, queries, 16)
    jax_cols, jax_segs = jbatch.banded_cols_batch(targets, queries, 16)
    for i, (t, q) in enumerate(zip(targets, queries)):
        want_cols, want_ins = jpoa.banded_align_ins(t, q, 16)
        np.testing.assert_array_equal(got_cols[i], want_cols, err_msg=str(i))
        np.testing.assert_array_equal(got_cols[i], jax_cols[i])
        assert got_segs[i] == jax_segs[i] == jpoa.decode_ins(want_ins), i


def test_banded_cols_band_cap_fallback():
    """A band above band_cap goes through the scalar host DP, as in the JAX
    package (poa_batch.py:272-276); the rest of the batch does not."""
    rng = np.random.default_rng(3)
    t = jpoa.encode(_rand_seq(rng, 10))
    q = jpoa.encode(_rand_seq(rng, 900))  # band 891 > cap
    t2 = jpoa.encode(_rand_seq(rng, 120))
    q2 = jpoa.encode(_mutate_batch(rng, jpoa.decode_ins([t2.tolist()])[0]))
    counts = {}
    got = poa_batch.banded_cols_batch([t, t2], [q, q2], band=8, band_cap=64,
                                      counts=counts)
    want = jbatch.banded_cols_batch([t, t2], [q, q2], band=8, band_cap=64)
    np.testing.assert_array_equal(got[0][0], jpoa.banded_align(t, q, 8))
    for a, b in zip(got[0], want[0]):
        np.testing.assert_array_equal(a, b)
    assert got[1] == want[1]
    assert counts == {"dp_calls": 1}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_consensus_batch_matches_jax_and_scalar(seed):
    """tests/test_poa_batch.py::test_consensus_batch_matches_scalar's
    clusters, plus a bimodal one for the majority length mode."""
    rng = np.random.default_rng(seed)
    clusters = []
    for _ in range(12):
        base = _rand_seq(rng, int(rng.integers(30, 300)))
        k = int(rng.integers(1, 7))
        clusters.append([_mutate_batch(rng, base) for _ in range(k)])
    clusters.append([])
    clusters.append(["ACGT"])
    clusters.append(["ACGTACGT"] * 4)
    short, long_ = _rand_seq(rng, 80), _rand_seq(rng, 200)
    clusters.append([_mutate_batch(rng, short) for _ in range(3)]
                    + [_mutate_batch(rng, long_) for _ in range(5)])
    counts = {}
    got = poa_batch.consensus_sequence_batch(clusters, counts=counts)
    assert got == jbatch.consensus_sequence_batch(clusters)
    for i, seqs in enumerate(clusters):
        assert got[i] == jpoa.consensus_sequence(seqs), i
    assert 1 <= counts["dp_calls"] <= 2


def test_consensus_max_len_and_rounds_match_jax():
    """A seed longer than max_len is returned as is, and rounds=1 stops
    after one vote, as in the JAX package."""
    rng = np.random.default_rng(4)
    base = _rand_seq(rng, 150)
    clusters = [[_mutate_batch(rng, base) for _ in range(5)]
                for _ in range(3)]
    for kw in (dict(max_len=100), dict(rounds=1), dict(band=16)):
        assert poa_batch.consensus_sequence_batch(clusters, **kw) == \
            jbatch.consensus_sequence_batch(clusters, **kw), kw


def test_host_helpers_match_jax():
    """The copied host half of svtrek_tpu/ops/poa.py."""
    rng = np.random.default_rng(12)
    for text in ("", "ACGT", "acgtn", "NNRYacgt=*", _rand_seq(rng, 500)):
        np.testing.assert_array_equal(poa.encode(text), jpoa.encode(text))
    segs = [rng.integers(0, 5, int(rng.integers(0, 4))).tolist()
            for _ in range(30)]
    assert poa.decode_ins(segs) == jpoa.decode_ins(segs)
    for _ in range(20):
        seqs = [_rand_seq(rng, int(rng.integers(1, 400)))
                for _ in range(int(rng.integers(1, 9)))]
        assert poa.majority_length_mode(seqs) == \
            jpoa.majority_length_mode(seqs)
        t = jpoa.encode(seqs[0][:120])
        q = jpoa.encode(_mutate_batch(rng, seqs[0][:120], sub=0.1, ins=0.1))
        c1, i1 = poa.banded_align_ins(t, q, 8)
        c2, i2 = jpoa.banded_align_ins(t, q, 8)
        np.testing.assert_array_equal(c1, c2)
        assert i1 == i2


def test_strip_widths_give_every_pair_one_class():
    """K2's dispatch: every band up to POA_MAX_BAND gets the smallest strip
    width S with 32*S >= 2*band+1, or 0 (the chunked kernel) above
    POA_STRIP_MAX_BAND, never both."""
    bands = torch.arange(0, kernels.POA_MAX_BAND + 1, dtype=torch.int32)
    strips = kernels.poa_strip_widths(bands)
    width = 2 * bands + 1
    strip_cls = strips > 0
    assert torch.equal(strip_cls, bands <= kernels.POA_STRIP_MAX_BAND)
    assert (32 * strips[strip_cls] >= width[strip_cls]).all()
    table = torch.tensor(kernels.POA_STRIPS)
    smaller = torch.cat([torch.zeros(1, dtype=table.dtype), table[:-1]])
    pos = torch.bucketize(strips[strip_cls], table)
    assert torch.equal(table[pos], strips[strip_cls].long())
    assert (32 * smaller[pos] < width[strip_cls]).all()  # the smallest fit
    assert set(strips.tolist()) == set(kernels.POA_STRIPS) | {0}
    assert strips.dtype == torch.int32


@pytest.mark.parametrize("case", [
    "ok", "m_over_M", "n_over_N", "m_negative", "outside_band",
    "band_over_max"])
def test_check_pairs_reads_the_plan_and_refuses_bad_pairs(case):
    """K2's and K3's range check reduces on the tensors' device and reads
    the widest band, the pointer bytes and the number of strip pairs back
    at once; a pair outside the range the kernels take raises.  K2's plan
    is made of the helpers the other tests hold to the plain DP."""
    ms = torch.tensor([40, 0, 10, 60, 300], dtype=torch.int32)
    ns = torch.tensor([0, 40, 50, 55, 290], dtype=torch.int32)
    bands = torch.tensor([41, 41, 41, 8, 600], dtype=torch.int32)
    M, N = 300, 290
    if case == "m_over_M":
        M = 299
    elif case == "n_over_N":
        N = 289
    elif case == "m_negative":
        ms[1] = -1
    elif case == "outside_band":
        bands[2] = 39  # |50 - 10| = 40
    elif case == "band_over_max":
        bands[4] = kernels.POA_MAX_BAND + 1
    offsets = kernels.poa_ptr_offsets(ns, bands)
    strips = kernels.poa_strip_widths(bands)
    args = (M, N, ms, ns, bands, offsets[-1], (strips > 0).sum())
    if case != "ok":
        with pytest.raises(ValueError, match="out of range"):
            kernels._check_pairs(*args)
        with pytest.raises(ValueError, match="out of range"):
            kernels.poa_dp_plan(M, N, ms, ns, bands)
        return
    max_band, (total, n_strip) = kernels._check_pairs(*args)
    assert (max_band, n_strip) == (600, 4)
    assert total == int((ns.long() * (2 * bands.long() + 1)).sum())
    assert all(isinstance(v, int) for v in (max_band, total, n_strip))
    p_off, p_order, p_strips, *p_rest = kernels.poa_dp_plan(M, N, ms, ns,
                                                            bands)
    assert torch.equal(p_off, offsets) and torch.equal(p_strips, strips)
    assert torch.equal(p_order, kernels.poa_work_order(ns, bands))
    assert p_rest == [max_band, total, n_strip]


@pytest.mark.parametrize("name", ["1", "3", "degenerate", "overrun", "wide"])
def test_work_order_scattered_back_equals_input_order(name):
    """The plain DP over the pairs in K2's work-list order, each pair's
    rows scattered back to its input-order offset, equals the plain DP in
    input order; the list is a permutation with the strip kernel's pairs
    first, each group longest first."""
    if name == "wide":  # bands on both sides of POA_STRIP_MAX_BAND
        rng = np.random.default_rng(8)
        ms = rng.integers(0, 90, 12).astype(np.int32)
        ns = rng.integers(0, 90, 12).astype(np.int32)
        bands = np.array([8, 600, 64, 527, 528, 1000, 200, 2048, 16, 513,
                          100, 700], np.int32)
        tpad = rng.integers(0, 4, (12, 90)).astype(np.int8)
        qpad = rng.integers(0, 4, (12, 90)).astype(np.int8)
        W = int(bands.max())
    else:
        tpad, ms, qpad, ns, bands, W = _case(name)
    args = _t(tpad, ms, qpad, ns, bands)
    n_t, b_t = args[3], args[4]
    want = poa_dp.pointers_by_pair(poa_dp.dp_ptr_reference(*args, W=W),
                                   n_t, b_t, W=W)
    order = kernels.poa_work_order(n_t, b_t).long()
    assert sorted(order.tolist()) == list(range(len(ms)))
    wide = (b_t > kernels.POA_STRIP_MAX_BAND)[order]
    assert not (wide[:-1] & ~wide[1:]).any()  # strip pairs first
    work = (n_t.long() * (2 * b_t.long() + 1))[order]
    same = wide[:-1] == wide[1:]
    assert (work[:-1][same] >= work[1:][same]).all()
    perm = [a[order] for a in args]
    got_perm = poa_dp.pointers_by_pair(poa_dp.dp_ptr_reference(*perm, W=W),
                                       perm[3], perm[4], W=W)
    offsets = kernels.poa_ptr_offsets(n_t, b_t)
    perm_off = kernels.poa_ptr_offsets(perm[3], perm[4])
    got = torch.empty_like(want)
    for p, b in enumerate(order.tolist()):
        got[offsets[b]:offsets[b + 1]] = got_perm[perm_off[p]:perm_off[p + 1]]
    assert torch.equal(got, want)
