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


def _bands_wide():
    """Bands 528-2,048 (K2's wide kernel's) at a few dozen rows: mutated
    and unrelated queries, n above and below m, an empty target and
    query, |n - m| up to the band."""
    rng = np.random.default_rng(13)
    shapes = [(30, 40, 528), (60, 45, 1024), (10, 50, 2048), (48, 20, 700),
              (0, 12, 600), (25, 0, 530), (64, 64, 1500), (5, 60, 575),
              (40, 40, 767), (33, 30, 768)]
    B = len(shapes)
    tpad = np.full((B, 64), 5, np.int8)
    qpad = np.full((B, 64), 5, np.int8)
    for b, (m, n, _) in enumerate(shapes):
        t = rng.integers(0, 4, m).astype(np.int8)
        q = np.resize(t, n) if b % 2 and m else rng.integers(0, 4, n)
        q = np.where(rng.random(n) < 0.1, rng.integers(0, 4, n), q)
        tpad[b, :m], qpad[b, :n] = t, q
    return (tpad, np.array([m for m, _, _ in shapes], np.int32), qpad,
            np.array([n for _, n, _ in shapes], np.int32),
            np.array([bd for _, _, bd in shapes], np.int32), 2048)


def _case(name):
    if name == "degenerate":
        return _degenerate()
    if name == "bands_wide":
        return _bands_wide()
    if name == "overrun":
        return _overrun()
    if name == "b300":  # not a multiple of the TPU's 256-pair tile
        return _build(np.random.default_rng(7), 300, 30, 8, jitter=4)[:6]
    seed, B, M, band = PALLAS_CASES[int(name)]
    return _build(np.random.default_rng(seed), B, M, band)[:6]


CASES = [str(i) for i in range(len(PALLAS_CASES))] + [
    "degenerate", "overrun", "b300", "bands_wide"]


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


@pytest.mark.parametrize("name", ["0", "1", "3", "degenerate", "bands_wide"])
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
    assert counts == {"dp_calls": 1, "band_wide": 0, "band_scalar": 1,
                      "band_wide_k2": 0}


def test_banded_cols_bands_past_jax_cap_take_the_device_path():
    """Pairs with |n - m| + 1 in 513-2,048 (past the JAX package's
    band_cap 512, which sends them to its scalar DP) go through the
    default call's DP, counted in band_wide (and in band_wide_k2 those
    past POA_STRIP_MAX_BAND 527, K2's wide kernel's on CUDA), and give
    JAX's default cols and segs; a degenerate pair (band >= m + n) and a
    pair past K2's widest band stay on the scalar DP, counted in
    band_scalar."""
    rng = np.random.default_rng(17)
    shapes = [(200, 800), (150, 700), (900, 300), (60, 40), (0, 600),
              (30, 2100), (400, 930)]
    targets, queries = [], []
    for m, n in shapes:
        t = _rand_seq(rng, m)
        q = _mutate_batch(rng, t) + _rand_seq(rng, max(n - m, 0))
        targets.append(jpoa.encode(t))
        queries.append(jpoa.encode(q[:n] if n < m else q))
    bands = [max(16, abs(len(q) - len(t)) + 1)
             for t, q in zip(targets, queries)]
    assert sum(512 < b <= kernels.POA_MAX_BAND and b < len(t) + len(q)
               for b, t, q in zip(bands, targets, queries)) == 4
    assert sum(kernels.POA_STRIP_MAX_BAND < b <= kernels.POA_MAX_BAND
               and b < len(t) + len(q)
               for b, t, q in zip(bands, targets, queries)) == 3
    assert bands[4] >= len(targets[4]) + len(queries[4])
    assert bands[5] > kernels.POA_MAX_BAND
    counts = {}
    got_cols, got_segs = poa_batch.banded_cols_batch(targets, queries, 16,
                                                     counts=counts)
    jax_cols, jax_segs = jbatch.banded_cols_batch(targets, queries, 16)
    for i, (t, q) in enumerate(zip(targets, queries)):
        np.testing.assert_array_equal(got_cols[i], jax_cols[i],
                                      err_msg=str(i))
        assert got_segs[i] == jax_segs[i], i
    assert counts == {"dp_calls": 1, "band_wide": 4, "band_scalar": 2,
                      "band_wide_k2": 3}


@pytest.mark.parametrize("B,M,noncontig", [(7, 40, False), (5, 1, True),
                                           (2, 300, True)])
def test_flat_gather_equals_slicing_the_padded_rows(B, M, noncontig):
    """`flat_index` and `cols_ins_flat` give each pair's cols[b, :m_b]
    and ins[b, :m_b+1] at one offset a pair, equal to slicing the padded
    rows, for contiguous and strided (the plain traceback's) outputs."""
    rng = np.random.default_rng(B * 1000 + M)
    ms = rng.integers(0, M + 1, B).astype(np.int32)
    ms[0] = M
    cols = torch.from_numpy(rng.integers(-1, 5, (B, M)).astype(np.int8))
    ins_full = torch.from_numpy(rng.integers(0, 9, (B, M + 2)).astype(
        np.int32))
    ins = ins_full[:, :M + 1] if noncontig else ins_full[:, :M + 1].clone()
    assert ins.is_contiguous() != noncontig
    idx = poa_batch.flat_index(ms, M)
    assert idx.dtype == np.int32 and len(idx) == int(ms.sum()) + B
    cols_h, ins_h = (t.numpy() for t in poa_batch.cols_ins_flat(
        cols, ins, torch.from_numpy(idx)))
    start = 0
    for b, m in enumerate(ms.tolist()):
        np.testing.assert_array_equal(cols_h[start:start + m],
                                      cols[b, :m].numpy())
        np.testing.assert_array_equal(ins_h[start:start + m + 1],
                                      ins[b, :m + 1].numpy())
        start += m + 1
    assert start == len(cols_h) == len(ins_h)


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
    """K2's dispatch: every band up to POA_MAX_BAND gets exactly one class
    (W, S), whose 32*W*S cells cover its 2*band+1: one warp (the strip
    kernel) and the smallest strip width of POA_STRIPS up to
    POA_STRIP_MAX_BAND, POA_WIDE_WARPS warps (the wide kernel) and the
    smallest of POA_WIDE_STRIPS above it.  The tables are the kernels'
    (csrc/poa.cu checks them at load)."""
    bands = torch.arange(0, kernels.POA_MAX_BAND + 1, dtype=torch.int32)
    strips = kernels.poa_strip_widths(bands)
    assert strips.dtype == torch.int32
    width = 2 * bands + 1
    warps = torch.tensor([kernels.poa_warps(b) for b in bands.tolist()])
    strip_cls = warps == 1
    assert torch.equal(strip_cls, bands <= kernels.POA_STRIP_MAX_BAND)
    assert set(warps.tolist()) == {1, kernels.POA_WIDE_WARPS}
    assert (32 * warps * strips >= width).all()
    for cls, table in ((strip_cls, kernels.POA_STRIPS),
                       (~strip_cls, kernels.POA_WIDE_STRIPS)):
        table = torch.tensor(table)
        smaller = torch.cat([torch.zeros(1, dtype=table.dtype), table[:-1]])
        pos = torch.bucketize(strips[cls], table)
        assert torch.equal(table[pos], strips[cls].long())  # in its table
        # the smallest fit
        assert (32 * warps[cls] * smaller[pos] < width[cls]).all()
        assert set(strips[cls].tolist()) == set(table.tolist())
    assert kernels.POA_MAX_BAND <= kernels.POA_WIDE_MAX_BAND
    assert 32 * kernels.POA_WIDE_WARPS * kernels.POA_WIDE_STRIPS[-1] >= \
        2 * kernels.POA_WIDE_MAX_BAND + 1


def test_poa_source_builds_the_plans_tables():
    """csrc/poa.cu's strip-width lists (each a kernel's switch cases and
    the table svtrek_poa_strips exports for the load check) and its warps
    a wide pair are kernels.POA_STRIPS, POA_WIDE_STRIPS and
    POA_WIDE_WARPS, and an unlisted width traps instead of writing
    nothing."""
    import pathlib
    import re

    src = (pathlib.Path(kernels.__file__).parent.parent / "csrc" /
           "poa.cu").read_text()

    def table(name):
        body = re.search(rf"#define {name}\(X\)((?:[^\n]*\\\n)*[^\n]*)",
                         src).group(1)
        return tuple(int(x) for x in re.findall(r"X\((\d+)\)", body))

    assert table("SVTREK_STRIPS") == kernels.POA_STRIPS
    assert table("SVTREK_WIDE_STRIPS") == kernels.POA_WIDE_STRIPS
    warps = re.search(r"constexpr int kWideWarps = (\d+);", src).group(1)
    assert int(warps) == kernels.POA_WIDE_WARPS
    for kernel in ("poa_dp_ptr_strip_kernel", "poa_dp_ptr_wide_kernel"):
        body = src[src.index(f"\n{kernel}("):]
        body = body[:body.index("\n}\n")]
        assert "default:\n      __trap();" in body


@pytest.mark.parametrize("case", [
    "ok", "m_over_M", "n_over_N", "m_negative", "outside_band",
    "band_over_max"])
def test_check_pairs_reads_the_plan_and_refuses_bad_pairs(case):
    """K2's and K3's range check reduces on the tensors' device and reads
    the widest band, the pointer bytes and the number of strip pairs back
    at once; a pair outside the range the kernels take raises.  K2's plan
    is made of the helpers the other tests hold to the plain DP: its work
    list leads with the strip pairs, and each wide pair (band above
    POA_STRIP_MAX_BAND) has its wide strip width."""
    ms = torch.tensor([40, 0, 10, 60, 300, 20, 0], dtype=torch.int32)
    ns = torch.tensor([0, 40, 50, 55, 290, 900, 5], dtype=torch.int32)
    bands = torch.tensor([41, 41, 41, 8, 600, 2048, 528], dtype=torch.int32)
    M, N = 300, 900
    if case == "m_over_M":
        M = 299
    elif case == "n_over_N":
        N = 899
    elif case == "m_negative":
        ms[1] = -1
    elif case == "outside_band":
        bands[2] = 39  # |50 - 10| = 40
    elif case == "band_over_max":
        bands[4] = kernels.POA_MAX_BAND + 1
    offsets = kernels.poa_ptr_offsets(ns, bands)
    strips = kernels.poa_strip_widths(bands)
    args = (M, N, ms, ns, bands, offsets[-1],
            (bands <= kernels.POA_STRIP_MAX_BAND).sum())
    if case != "ok":
        with pytest.raises(ValueError, match="out of range"):
            kernels._check_pairs(*args)
        with pytest.raises(ValueError, match="out of range"):
            kernels.poa_dp_plan(M, N, ms, ns, bands)
        return
    max_band, (total, n_strip) = kernels._check_pairs(*args)
    assert (max_band, n_strip) == (2048, 4)
    assert total == int((ns.long() * (2 * bands.long() + 1)).sum())
    assert all(isinstance(v, int) for v in (max_band, total, n_strip))
    p_off, p_order, p_strips, *p_rest = kernels.poa_dp_plan(M, N, ms, ns,
                                                            bands)
    assert torch.equal(p_off, offsets) and torch.equal(p_strips, strips)
    assert torch.equal(p_order, kernels.poa_work_order(ns, bands))
    assert p_rest == [total, n_strip]
    # the wide pairs, longest chain first, after the strip pairs
    assert p_order.tolist()[n_strip:] == [5, 4, 6]
    assert p_strips.tolist()[4:] == [5, 17, 5]


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


# K3's window and run (csrc/poa.cu kTbWin, kTbRun; its ring holds two runs
# of rows).
K3_WIN, K3_RUN = 128, 32


def _k3_model(ptr, offsets, qpad, ms, ns, bands, order, M, *, base=0,
              win=K3_WIN, run_len=K3_RUN, seed=0):
    """A numpy model of K3's walk (csrc/poa.cu poa_traceback_kernel), one
    warp per pair in work-list order: the outputs filled first; a ring of
    2 * `run_len` rows, each a window of `win` cells in 16-byte chunks
    (ptr's byte 0 at address `base`) centred on the walk's cell when the
    row was issued; one ballot over `run_len` rows for a diagonal run (the
    walk's cell in each row) and one for an up run (one cell higher a
    row); a row that starts neither: the highest non-left cell at or below
    the walk's (the ballot of a left run) in its window, reloaded in words
    when the walk drifted out and slid down by `win` while the run goes
    on; column 0 moves up to row 0; each boundary's up count stored once.
    Ring bytes the kernel does not load keep stale (random) values, which
    the walk must never read as cells of the row."""
    rng = np.random.default_rng(seed)
    mem = ptr.numpy().view(np.uint8)
    total = len(mem)
    first, last = base & ~15, (base + total - 1) & ~15
    B = qpad.shape[0]
    cols = np.zeros((B, M), np.int8)
    ins = np.zeros((B, M + 1), np.int32)
    ring = 2 * run_len

    def load(a, cells, unit):
        """The window at address a, in units of `unit` bytes, each read
        only where it lies in the buffer's first to last 16-byte chunk."""
        start = a + unit * np.arange(win // unit)
        ok = np.repeat((start >= first) & (start <= last + 16 - unit), unit)
        at = a - base + np.arange(win)
        inside = ok & (at >= 0) & (at < total)
        out = cells.copy()
        out[ok] = rng.integers(0, 256, int(ok.sum()))  # bytes past the ends
        out[inside] = mem[at[inside]]
        return out

    def scan_left(row, ka, cells, kc, kb):
        if kc < ka or kc >= ka + win:
            a = ((row + kc) & ~3) - (win - 4)
            ka, cells = a - row, load(a, np.zeros(win, np.uint8), 4)
        while True:
            k = ka + np.arange(win)
            hit = (k >= 0) & (k <= kc) & ((k == kb) | (cells <= 1))
            if hit.any():
                at = int(np.flatnonzero(hit)[-1])
                return 2 * int(k[at]) + (1 if k[at] == kb else int(cells[at]))
            if ka <= 0:
                return -1
            ka -= win
            cells = load(row + ka, np.zeros(win, np.uint8), 4)

    q_np = qpad.numpy()
    for b in order.tolist():
        n, m, band = int(ns[b]), int(ms[b]), int(bands[b])
        top_cell, width = 2 * band, 2 * band + 1
        pair = base + int(offsets[b])
        cols[b] = -1
        ins[b] = 0
        slots = rng.integers(0, 3, (ring, win)).astype(np.uint8)
        slot_k = np.zeros(ring, np.int64)
        slot_q = np.zeros(ring, np.int8)

        def slot_of(r):
            return (n - r) % ring

        def clamp_k(k):
            return min(max(k, 0), top_cell)

        def issue(r0, count, k):
            for r in range(r0, max(r0 - count, 0), -1):
                s = slot_of(r)
                row = pair + (r - 1) * width
                a = ((row + clamp_k(k + win // 2 - 1)) & ~15) - (win - 16)
                slots[s] = load(a, slots[s], 16)
                slot_k[s] = a - row
                slot_q[s] = q_np[b, r - 1]

        def code_at(r, k):
            off = k - int(slot_k[slot_of(r)])
            return int(slots[slot_of(r)][off]) if 0 <= off < win else 0xFF

        def first_stop(codes, want):
            return next((r for r, c in enumerate(codes) if c != want),
                        run_len)

        run = [-1, 0]  # the boundary of the current up run, its count

        def add_ups(at, count):
            if at != run[0]:
                if run[1]:
                    ins[b, run[0]] = run[1]  # stored once, as it ends
                run[:] = [at, 0]
            run[1] += count

        i, j = n, m
        issue(n, run_len, m - n + band)
        issue(n - run_len, run_len, m - n + band)
        nxt = n - ring
        while i > 0:
            if j == 0:
                add_ups(0, i)
                break
            kraw = j - i + band
            cd = [code_at(i - r, clamp_k(kraw))
                  if i - r >= 1 and j - r >= 1 else 0xFF
                  for r in range(run_len)]
            cu = [code_at(i - r, clamp_k(kraw + r)) if i - r >= 1 else 0xFF
                  for r in range(run_len)]
            if cd[0] == 0:
                used = first_stop(cd, 0)
                for r in range(used):
                    cols[b, j - r - 1] = slot_q[slot_of(i - r)]
                j -= used
            elif cu[0] == 1:
                used = first_stop(cu, 1)
                add_ups(j, used)
            else:
                kc = clamp_k(kraw)
                s = slot_of(i)
                found = scan_left(pair + (i - 1) * width, int(slot_k[s]),
                                  slots[s], kc, band - i)
                jstar, mv = 0, 1
                if found >= 0:
                    kstar, mv = found >> 1, found & 1
                    jstar = j if kstar == kc else kstar + i - band
                if mv == 0:
                    cols[b, jstar - 1] = slot_q[s]
                    j = jstar - 1
                else:
                    add_ups(jstar, 1)
                    j = jstar
                used = 1
            i -= used
            issue(nxt, used, j - i + band)
            nxt -= used
        if run[1]:
            ins[b, run[0]] = run[1]
    return torch.from_numpy(cols), torch.from_numpy(ins)


def _long_runs(kind):
    """Pairs whose walks make left runs longer than K3's window (m >> n:
    the query a piece of its target, bands up to 2,048) or long up runs
    (n >> m: a long insert), with degenerate pairs among them."""
    rng = np.random.default_rng(21 if kind == "left" else 22)
    if kind == "left":
        shapes = [(700, 40, 2048), (400, 9, 391), (300, 150, 200),
                  (520, 0, 520), (260, 1, 300)]
    else:
        shapes = [(40, 700, 2048), (9, 400, 391), (150, 300, 200),
                  (0, 520, 520), (1, 260, 300)]
    B = len(shapes)
    M = max(m for m, _, _ in shapes)
    N = max(n for _, n, _ in shapes)
    tpad = np.full((B, M), 5, np.int8)
    qpad = np.full((B, N), 5, np.int8)
    for b, (m, n, _) in enumerate(shapes):
        t = rng.integers(0, 4, m).astype(np.int8)
        if n <= m:
            start = int(rng.integers(0, m - n + 1))
            q = t[start:start + n].copy()
            q[rng.random(n) < 0.05] = rng.integers(0, 4)
        else:
            q = np.insert(t, m // 2, rng.integers(0, 4, n - m)).astype(
                np.int8)
        tpad[b, :m], qpad[b, :n] = t, q
    ms = np.array([m for m, _, _ in shapes], np.int32)
    ns = np.array([n for _, n, _ in shapes], np.int32)
    bands = np.array([bd for _, _, bd in shapes], np.int32)
    return tpad, ms, qpad, ns, bands, int(bands.max())


def _k3_inputs(name):
    tpad, ms, qpad, ns, bands, W = (_long_runs(name[5:])
                                    if name.startswith("runs_")
                                    else _case(name))
    args = _t(tpad, ms, qpad, ns, bands)
    lanes = poa_dp.dp_ptr_reference(*args, W=W)
    ptr = poa_dp.pointers_by_pair(lanes, args[3], args[4], W=W)
    offsets = kernels.poa_ptr_offsets(args[3], args[4])
    return tpad, ms, qpad, ns, bands, W, lanes, ptr, offsets


@pytest.mark.parametrize("name", CASES + ["runs_left", "runs_up"])
def test_k3_model_matches_traceback_and_jax(name):
    """K3's walk, at the kernel's window and run, equals the plain walk
    and JAX's `_traceback_one` (vmapped over the pairs, on the same
    pointers at the storage width W).  The two long-run cases walk left
    runs of hundreds of cells (several windows) and up runs of hundreds of
    rows."""
    import functools

    import jax

    from svtrek_tpu.ops.poa_pallas import _traceback_one

    tpad, ms, qpad, ns, bands, W, lanes, ptr, offsets = _k3_inputs(name)
    M, N = tpad.shape[1], qpad.shape[1]
    q_t, m_t, n_t, b_t = _t(qpad, ms, ns, bands)
    order = kernels.poa_work_order(n_t, b_t)
    got = _k3_model(ptr, offsets, q_t, m_t, n_t, b_t, order, M)
    want = poa_dp.traceback_reference(ptr, offsets, q_t, m_t, n_t, b_t, M=M)
    one = functools.partial(_traceback_one, W=W, M=M, N=N)
    jax_cols, jax_ins = (np.asarray(x) for x in jax.vmap(one)(
        lanes.numpy().transpose(1, 0, 2), qpad, ms, ns))
    for g, w, j in zip(got, want, (jax_cols, jax_ins)):
        np.testing.assert_array_equal(g.numpy(), w.numpy())
        np.testing.assert_array_equal(g.numpy(), j)
    if name.startswith("runs_"):
        runs = (ns - ms) if name == "runs_up" else (ms - ns)
        assert runs.max() > K3_WIN


@pytest.mark.parametrize("name,base,win,run_len", [
    ("1", 3, 16, 2), ("3", 1, 32, 4), ("degenerate", 2, 16, 1),
    ("overrun", 0, 48, 8), ("runs_left", 3, 16, 3), ("runs_up", 1, 16, 2)])
def test_k3_model_small_windows_and_unaligned_buffer(name, base, win,
                                                     run_len):
    """The same walk with windows of a few chunks and short runs, over a
    buffer that starts off a 4-byte boundary: many slides, reloads,
    stopped runs and partial chunks at the buffer's ends, the same
    outputs."""
    tpad, ms, qpad, ns, bands, W, _, ptr, offsets = _k3_inputs(name)
    M = tpad.shape[1]
    q_t, m_t, n_t, b_t = _t(qpad, ms, ns, bands)
    order = kernels.poa_work_order(n_t, b_t)
    got = _k3_model(ptr, offsets, q_t, m_t, n_t, b_t, order, M, base=base,
                    win=win, run_len=run_len, seed=7)
    want = poa_dp.traceback_reference(ptr, offsets, q_t, m_t, n_t, b_t, M=M)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_k3_model_reads_any_code_as_the_walk_does():
    """Pointers that K2 never writes (codes other than 0-2, up at the band
    edge, left through cell 0): K3's walk still takes the plain walk's
    moves, the clamp of k into [0, 2*band] and the forced moves included."""
    rng = np.random.default_rng(31)
    B, M, N = 12, 40, 40
    ms = rng.integers(0, M + 1, B).astype(np.int32)
    ns = rng.integers(0, N + 1, B).astype(np.int32)
    bands = (np.abs(ns - ms) + rng.integers(0, 4, B)).astype(np.int32)
    n_t, b_t = _t(ns, bands)
    offsets = kernels.poa_ptr_offsets(n_t, b_t)
    ptr = torch.from_numpy(rng.choice(
        np.array([0, 1, 2, 2, 2, 3, -1, 127], np.int8), int(offsets[-1])))
    qpad = rng.integers(0, 4, (B, N)).astype(np.int8)
    q_t, m_t = _t(qpad, ms)
    order = kernels.poa_work_order(n_t, b_t)
    want = poa_dp.traceback_reference(ptr, offsets, q_t, m_t, n_t, b_t, M=M)
    for win, run_len in ((K3_WIN, K3_RUN), (16, 1), (32, 3)):
        got = _k3_model(ptr, offsets, q_t, m_t, n_t, b_t, order, M,
                        base=1, win=win, run_len=run_len)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _k2_model(t, q, m, n, band, W, S, lanes=32):
    """A numpy model of K2's row on W warps of `lanes` lanes, S cells a
    lane (csrc/poa.cu dp_pair<W, S>; the strip kernel is W = 1): the
    score row in per-lane strips, the target bases shifted a cell a row
    with each warp's last lane loading its top cell's base, pass 1 with
    the up bit in the score's low bit, each warp's scan of its lanes'
    maxima and the carry of the warps before it, pass 2, the row's codes
    at its width.  Returns the pair's n rows of 2*band+1 codes."""
    T, width = lanes * W, 2 * band + 1
    assert T * S > width
    t = np.asarray(t, np.int64)

    def base(j):  # target base of column j, the pad outside [1, m]
        return np.where((j >= 1) & (j <= m), t[np.clip(j - 1, 0, max(m - 1,
                                                                     0))]
                        if m else poa_dp.PAD, poa_dp.PAD)

    k = np.arange(T * S).reshape(T, S)
    j0 = k - band
    sc = np.where((k < width) & (j0 >= 0) & (j0 <= min(m, band)),
                  poa.GAP * j0, poa_dp.NEG)
    tb = base(1 + j0)
    # each warp's last lane's top cell, as a column offset from the row
    top = lanes * (np.arange(W) + 1) * S - 1 - band
    last = np.arange(T) % lanes == lanes - 1
    s_idx = np.arange(S)
    out = np.empty((n, width), np.int8)
    for i in range(1, n + 1):
        up_next = np.append(sc[1:, 0], poa_dp.NEG)  # the next lane's first
        up = np.concatenate([sc[:, 1:], up_next[:, None]], 1) + poa.GAP
        diag = sc + np.where(tb == q[i - 1], poa.MATCH, poa.MISMATCH)
        jb = (i - band + k[:, :1])
        valid = (s_idx >= 1 - jb) & (s_idx <= np.minimum(m - jb,
                                                         width - 1 - k[:, :1]))
        bmask = s_idx == (-jb if i <= band else -1)
        cand = np.where(valid, np.maximum(diag, up),
                        np.where(bmask, poa.GAP * i, poa_dp.NEG))
        v = cand | (bmask | (up > diag))
        tot = (cand - poa.GAP * k).max(1).reshape(W, lanes)
        incl = np.maximum.accumulate(tot, 1)
        excl = np.concatenate([np.full((W, 1), poa_dp.NEG), incl[:, :-1]], 1)
        carry = np.concatenate([[poa_dp.NEG],
                                np.maximum.accumulate(incl[:, -1])[:-1]])
        run = np.maximum(excl, carry[:, None]).reshape(T, 1)
        c = v & ~1
        pre = np.maximum.accumulate(c - poa.GAP * k, 1)
        run = np.maximum(run, np.concatenate(
            [np.full((T, 1), poa_dp.NEG), pre[:, :-1]], 1))
        left = run + poa.GAP * k
        use = valid & (left > c)
        sc = np.where(use, left, c)
        out[i - 1] = np.where(use, 2, v & 1).reshape(-1)[:width]
        # the next row's bases: a cell down; each warp's last lane's top
        nxt = np.append(tb[1:, 0], poa_dp.PAD)
        nxt[last] = base(i + 1 + top)
        tb = np.concatenate([tb[:, 1:], nxt[:, None]], 1)
    return out


@pytest.mark.parametrize("lanes", [32, 4])
@pytest.mark.parametrize("name", ["1", "degenerate", "overrun",
                                  "bands_wide", "runs_left", "runs_up"])
def test_k2_model_matches_plain_dp(name, lanes):
    """K2's rows on W warps (the model of csrc/poa.cu's dp_pair) equal the
    plain DP's pointers, every cell of every pair's band: at each pair's
    own class (kernels.poa_warps and poa_strip_widths: the strip kernel's
    one warp, the wide kernel's eight) and, with 4-lane warps, on 1 to 5
    warps of a few cells a lane, so that small bands cross many warps."""
    tpad, ms, qpad, ns, bands, _, _, ptr, offsets = _k3_inputs(name)
    strips = kernels.poa_strip_widths(torch.from_numpy(bands)).tolist()
    for b in range(len(ms)):
        m, n, band = int(ms[b]), int(ns[b]), int(bands[b])
        width = 2 * band + 1
        if lanes == 32:
            warps, S = kernels.poa_warps(band), strips[b]
        else:
            warps = 1 + b % 5
            S = width // (lanes * warps) + 1
        got = _k2_model(tpad[b, :m], qpad[b, :n], m, n, band, warps, S,
                        lanes)
        want = ptr[int(offsets[b]):int(offsets[b + 1])].numpy()
        np.testing.assert_array_equal(got.reshape(-1), want,
                                      err_msg=f"pair {b} W={warps} S={S}")


def test_dp_cols_cuda_path_refuses_cpu_tensors():
    """K2 and K3 on one plan (`kernels.poa_dp_cols_cuda`, the CUDA route of
    dp_cols) takes CUDA tensors only; dp_cols on CPU tensors takes the plain
    path, counts it, launches nothing and equals the JAX program."""
    tpad, ms, qpad, ns, bands, W = _case("3")
    args = _t(tpad, ms, qpad, ns, bands)
    launches = dict(kernels.launch_counts)
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernels.poa_dp_cols_cuda(*args)
    before = dict(poa_dp.plain_calls)
    cols, ins = poa_dp.dp_cols(*args)
    assert kernels.launch_counts == launches
    assert poa_dp.plain_calls["poa_traceback"] == \
        before["poa_traceback"] + 1
    want_cols, want_ins = (np.asarray(x) for x in jbatch._dp_cols_batch(
        tpad, ms, qpad, ns, bands, W=W))
    np.testing.assert_array_equal(cols.numpy(), want_cols)
    np.testing.assert_array_equal(ins.numpy(), want_ins)
