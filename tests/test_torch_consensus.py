"""The port's consensus (svtrek_tpu_torch.ops) against the JAX package.

The plain PyTorch version must equal svtrek_tpu's consensus_pos_batch
(the lax.scan fold and the Pallas fold in interpret mode) and the scalar
oracle exactly, on the same numpy inputs: refined positions and overflow
flags.  Kernel K1 itself runs only on the card (chip_smoke.py); here its
wrapper must refuse CPU tensors and its build must fail loudly without
nvcc.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from svtrek_tpu import constants as C
from svtrek_tpu.ops.consensus import consensus_pos_batch as jax_consensus
from svtrek_tpu.ops.sweep_pallas import sweep_fold_pallas
from svtrek_tpu.oracle import consensus_pos
from svtrek_tpu_torch import kernels
from svtrek_tpu_torch.kernels import build as kbuild
from svtrek_tpu_torch.ops import consensus as tcons
from svtrek_tpu_torch.ops.sweep import sweep_fold

PAD = C.I32_MAX
BIG = 0x7FFFFFFF


def _pack(cases, K):
    B = len(cases)
    locs = np.full((B, K), PAD, np.int32)
    n = np.zeros(B, np.int32)
    pos = np.zeros(B, np.int32)
    for b, (vals, p) in enumerate(cases):
        s = np.sort(np.asarray(vals, np.int64)).astype(np.int32)
        locs[b, : len(s)] = s
        n[b] = len(s)
        pos[b] = p
    return locs, n, pos


def _random_cases(rng, rows: int, max_n: int, spread: int = 600):
    """Tight clusters, scattered noise and duplicates around a center
    (the generator of tests/test_consensus.py)."""
    cases = []
    for _ in range(rows):
        n = int(rng.integers(0, max_n))
        center = int(rng.integers(1000, 100000))
        vals = []
        for _ in range(n):
            mode = rng.integers(0, 3)
            if mode == 0:
                vals.append(center + int(rng.integers(-4, 5)))
            elif mode == 1:
                vals.append(center + int(rng.integers(-spread, spread)))
            else:
                vals.append(center + int(rng.integers(-30, 30)))
        cases.append((vals, center + int(rng.integers(-100, 100))))
    return cases


def _torch(locs, n, pos, **kw):
    out, ovf = tcons.consensus_pos_batch_reference(
        torch.from_numpy(locs), torch.from_numpy(n), torch.from_numpy(pos),
        **kw)
    assert out.dtype == torch.int32 and ovf.dtype == torch.bool
    return out.numpy(), ovf.numpy()


def _jax(locs, n, pos, **kw):
    out, ovf = jax_consensus(locs, n, pos, **kw)
    return np.asarray(out), np.asarray(ovf)


def _assert_same(got, want):
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("seed", range(4))
def test_reference_matches_jax_scan_and_oracle(seed):
    rng = np.random.default_rng(seed)
    cases = _random_cases(rng, 64, 40)
    locs, n, pos = _pack(cases, 64)
    got = _torch(locs, n, pos)
    _assert_same(got, _jax(locs, n, pos, impl="scan"))
    assert not got[1].any()
    want = np.array([consensus_pos(v, p) for v, p in cases], np.int32)
    np.testing.assert_array_equal(got[0], want)


@pytest.mark.parametrize("seed", range(2))
def test_reference_matches_jax_pallas_interpret(seed):
    rng = np.random.default_rng(300 + seed)
    locs, n, pos = _pack(_random_cases(rng, 40, 40), 64)
    _assert_same(_torch(locs, n, pos),
                 _jax(locs, n, pos, impl="pallas_interpret"))


@pytest.mark.parametrize("seed", range(3))
def test_reference_nondefault_params(seed):
    rng = np.random.default_rng(100 + seed)
    kw = dict(min_count=2, interval=12, range_=200)
    cases = []
    for _ in range(48):
        n = int(rng.integers(0, 30))
        center = int(rng.integers(500, 50000))
        vals = [center + int(rng.integers(-300, 300)) for _ in range(n)]
        cases.append((vals, center + int(rng.integers(-50, 50))))
    locs, n, pos = _pack(cases, 32)
    got = _torch(locs, n, pos, **kw)
    _assert_same(got, _jax(locs, n, pos, impl="scan", **kw))
    want = np.array([consensus_pos(v, p, 2, 12, 200) for v, p in cases],
                    np.int32)
    np.testing.assert_array_equal(got[0], want)


def test_reference_early_return_tiebreak():
    # Two equal-size clusters straddling pos: the left sweep runs first
    # and returns at once when its candidate lands within the interval.
    vals, p = [995, 996, 997, 1004, 1005, 1006], 1000
    locs, n, pos = _pack([(vals, p)], 16)
    got = _torch(locs, n, pos)
    assert int(got[0][0]) == consensus_pos(vals, p)
    _assert_same(got, _jax(locs, n, pos, impl="scan"))


@pytest.mark.parametrize("sweep_width", [8, 3])
def test_reference_sweep_overflow_flags(sweep_width):
    """A sweep budget smaller than the in-range anchors raises the
    overflow flag; flags and refined values equal the JAX program's, and
    rows without the flag equal the oracle."""
    rng = np.random.default_rng(7)
    cases = _random_cases(rng, 64, 40)
    locs, n, pos = _pack(cases, 64)
    got = _torch(locs, n, pos, sweep_width=sweep_width)
    _assert_same(got, _jax(locs, n, pos, impl="scan",
                           sweep_width=sweep_width))
    assert got[1].sum() > 10
    for b, (vals, p) in enumerate(cases):
        if not got[1][b]:
            assert int(got[0][b]) == consensus_pos(vals, p), b


def test_reference_large_k_1024():
    rng = np.random.default_rng(5)
    B, K = 4, 1024
    locs = np.full((B, K), PAD, np.int32)
    n = np.array([700, 1024, 3, 90], np.int32)
    pos = np.zeros(B, np.int32)
    for b in range(B):
        base = int(rng.integers(100_000, 1_000_000))
        locs[b, : n[b]] = np.sort(base + rng.integers(-400, 400, n[b]))
        pos[b] = base + int(rng.integers(-20, 20))
    got = _torch(locs, n, pos)
    _assert_same(got, _jax(locs, n, pos, impl="scan"))
    for b in range(B):
        if not got[1][b]:
            assert int(got[0][b]) == consensus_pos(
                locs[b, : n[b]].tolist(), int(pos[b])), b


def test_reference_edge_rows():
    """Padding rows, too few candidates, values near INT32_MAX (pos + 25
    wraps in int32) and near INT32_MIN: equal to the JAX program."""
    cases = [
        ([], 1000), ([], 0), ([5, 6], 5),
        ([BIG - 10, BIG - 9, BIG - 8, BIG - 3], BIG - 9),
        ([BIG - 100, BIG - 99, BIG - 98], BIG - 5),
        ([1, 2, 3], -2**31 + 3),
        ([-2**31, -2**31 + 1, -2**31 + 2], 2**31 - 1),
    ]
    locs, n, pos = _pack(cases, 16)
    got = _torch(locs, n, pos)
    _assert_same(got, _jax(locs, n, pos, impl="scan"))
    assert list(got[0][:3]) == [-1, -1, -1] and not got[1][:3].any()


@pytest.mark.parametrize("seed", range(3))
def test_sweep_fold_matches_pallas_interpret(seed):
    """The plain fold of ops/sweep.py against sweep_fold_pallas on random
    [B, W] anchor data (cumulative-AND activity, clustered candidates so
    that early returns, updates and ties all occur)."""
    rng = np.random.default_rng(900 + seed)
    B, W = 96, 24
    pos = rng.integers(10_000, 20_000, B).astype(np.int32)

    def side():
        cand = (pos[:, None] + rng.integers(-40, 40, (B, W))).astype(np.int32)
        count = rng.integers(0, 9, (B, W)).astype(np.int32)
        stop = rng.integers(0, W + 1, B)
        act = (np.arange(W)[None, :] < stop[:, None]).astype(np.int32)
        return cand, count, act

    cl, nl, al = side()
    cr, nr, ar = side()
    kw = dict(min_count=3, interval=5)
    got = sweep_fold(*(torch.from_numpy(x) for x in (pos, cl, nl, al,
                                                      cr, nr, ar)), **kw)
    want = np.asarray(sweep_fold_pallas(pos, cl, nl, al, cr, nr, ar,
                                        interpret=True, **kw))
    np.testing.assert_array_equal(got.numpy(), want)


def test_dispatch_takes_plain_path_for_cpu_tensors():
    rng = np.random.default_rng(11)
    locs, n, pos = _pack(_random_cases(rng, 16, 20), 32)
    t = [torch.from_numpy(x) for x in (locs, n, pos)]
    before = tcons.plain_calls["consensus_pos"]
    launches = dict(kernels.launch_counts)
    got = tcons.consensus_pos_batch(*t)
    assert tcons.plain_calls["consensus_pos"] == before + 1
    assert kernels.launch_counts == launches
    _assert_same((got[0].numpy(), got[1].numpy()), _torch(locs, n, pos))


def test_cuda_wrapper_refuses_cpu_tensors():
    t = torch.zeros((4, 16), dtype=torch.int32)
    n = torch.zeros(4, dtype=torch.int32)
    launches = dict(kernels.launch_counts)
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernels.consensus_pos_cuda(t, n, n, min_count=3, interval=5,
                                   range_=500, sweep_width=128)
    assert kernels.launch_counts == launches


def test_kernel_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(kbuild.KernelBuildError, match="nvcc not found"):
        kbuild.build(force=True)
    assert kbuild.sources() and all(
        s.startswith(kbuild.CSRC) for s in kbuild.sources())


def _wrap(x: int) -> int:
    return (x + 2**31) % 2**32 - 2**31


def _wrap_abs(x: int) -> int:
    return _wrap(-x) if x < 0 else x


def _k1_model(locs, n, pos, *, min_count=C.CONSENSUS_MIN_COUNT,
              interval=C.CONSENSUS_INTERVAL,
              range_=C.CONSENSUS_INTERVAL_RANGE, sweep_width=128):
    """A numpy model of K1's warp per window (csrc/consensus.cu): the
    row's int64 prefix sums; the left start as the count of values <= pos
    + 25; each anchor's clusters as index ranges of the sorted row (lower
    and upper bounds by search), their sums as differences of prefixes;
    the anchors in chunks of 32 lanes, and the fold jumping from one
    accepted anchor to the next (the first lane of the chunk that beats
    the carry), with activity followed to the end of the W anchors."""
    B, K = locs.shape
    W = min(sweep_width, K)
    lanes = np.arange(32)
    out = np.full(B, -1, np.int32)
    ovf = np.zeros(B, bool)

    def left(row, P, i, L):
        lo = L if L >= BIG - interval else _wrap(L - interval)
        first = int(np.searchsorted(row[:i + 1], lo, side="left"))
        c = i + 1 - first
        s = c * L - int(P[i + 1] - P[first])
        return _wrap(L + (c // 2 - s) // max(c, 1)), c

    def right(row, P, i, n_row, L):
        hi = L if L >= BIG - interval else _wrap(L + interval)
        end = i + int(np.searchsorted(row[i:n_row], hi, side="right"))
        c = end - i
        cs = max(c, 1)
        s = int(P[end] - P[i]) - c * L
        return _wrap(L + (s + cs // 2) // cs), c

    def sweep(d, sw, fold, row, P, point, nb, n_row, p):
        for c0 in range(0, W, 32):
            idx = point + d * (c0 + lanes)
            inb = (c0 + lanes < W) & ((idx >= 0) if d < 0 else (idx < nb))
            ic = np.minimum(idx, K - 1)
            L = np.where(inb, row[np.clip(ic, 0, K - 1)], 0)
            ok = inb & np.array([_wrap_abs(_wrap(p - int(v))) < range_
                                 for v in L])
            active = 32 if ok.all() else int(np.argmin(ok))
            fold = fold and not sw["returned"]
            if fold and active > 0:
                stats = [left(row, P, int(ic[t]), int(L[t])) if d < 0 else
                         right(row, P, int(ic[t]), n_row, int(L[t]))
                         for t in range(active)]
                last = -1
                while True:
                    steps = [t for t in range(last + 1, active)
                             if stats[t][1] > sw["max_count"] and (
                                 _wrap_abs(_wrap(p - stats[t][0]))
                                 < max(interval, sw["best_dist"]))]
                    if not steps:
                        break
                    last = steps[0]
                    cand, count = stats[last]
                    dist = _wrap_abs(_wrap(p - cand))
                    if dist < interval:
                        sw.update(returned=True, ret_val=cand)
                        break
                    sw.update(max_count=count, best_val=cand,
                              best_dist=dist)
            if active < min(32, W - c0):
                return False
        return True

    for b in range(B):
        nb, p = int(n[b]), int(pos[b])
        if nb < min_count or nb <= 0:
            continue
        row = locs[b].astype(np.int64)
        P = np.concatenate([[0], np.cumsum(row)])
        le = int((row <= _wrap(p + 25)).sum())
        last = nb - 1
        point_l = min(max(le - 1, 0), last)
        point_r = 0 if row[0] < _wrap(p - 25) else last
        n_row = min(nb, K)
        sl, sr = ({"max_count": min_count - 1, "best_dist": BIG,
                   "best_val": -1, "ret_val": -1, "returned": False}
                  for _ in range(2))
        act_l = sweep(-1, sl, True, row, P, point_l, nb, n_row, p)
        act_r = sweep(1, sr, not sl["returned"], row, P, point_r, nb, n_row,
                      p)
        res = sl["best_val"] if sl["best_dist"] < sr["best_dist"] \
            else sr["best_val"]
        if sr["returned"]:
            res = sr["ret_val"]
        if sl["returned"]:
            res = sl["ret_val"]
        out[b] = res
        ovf[b] = (act_l and point_l - (W - 1) > 0) or \
            (act_r and point_r + (W - 1) < last)
    return out, ovf


def _wrapping_rows():
    """Rows near INT32_MAX and INT32_MIN where pos +- 25, pos - loc and
    the cluster bounds wrap in int32, led by the edge rows and the
    early-return tie."""
    rng = np.random.default_rng(41)
    cases = [
        ([], 1000), ([5000, 5001], 5000),
        ([BIG - 10, BIG - 9, BIG - 8, BIG - 3], BIG - 9),
        ([BIG - 100, BIG - 99, BIG - 98], BIG - 5),
        ([995, 996, 997, 1004, 1005, 1006], 1000),
        ([1, 2, 3], -2**31 + 3),
        ([-2**31, -2**31 + 1, -2**31 + 2], 2**31 - 1),
        ([BIG - 2, BIG - 1, BIG - 1, BIG], BIG - 20),
        ([-2**31, -2**31, -2**31 + 3, -2**31 + 4], -2**31 + 10),
    ]
    for _ in range(24):
        edge = BIG - 40 if rng.random() < 0.5 else -2**31
        vals = (edge + rng.integers(0, 40, int(rng.integers(3, 12))))
        cases.append((vals.tolist(), int(_wrap(edge + int(
            rng.integers(-60, 60))))))
    return cases


K1_CASES = ["edge_wrap", "tie", "random", "sw3", "sw8", "k1024"]


def _k1_case(name):
    kw = {}
    if name == "edge_wrap":
        locs, n, pos = _pack(_wrapping_rows(), 16)
    elif name == "tie":
        locs, n, pos = _pack([([995, 996, 997, 1004, 1005, 1006], 1000),
                              ([990, 991, 992, 1008, 1009, 1010], 1000)], 16)
    elif name in ("random", "sw3", "sw8"):
        rng = np.random.default_rng(7)
        locs, n, pos = _pack(_random_cases(rng, 64, 40), 64)
        if name != "random":
            kw["sweep_width"] = int(name[2:])
    else:
        rng = np.random.default_rng(5)
        locs = np.full((4, 1024), PAD, np.int32)
        n = np.array([700, 1024, 3, 90], np.int32)
        pos = np.zeros(4, np.int32)
        for b in range(4):
            base = int(rng.integers(100_000, 1_000_000))
            locs[b, : n[b]] = np.sort(base + rng.integers(-400, 400, n[b]))
            pos[b] = base + int(rng.integers(-20, 20))
    return locs, n, pos, kw


@pytest.mark.parametrize("name", K1_CASES)
def test_k1_model_matches_reference_and_jax(name):
    """K1's range-and-prefix-sum clusters and ballot fold equal the plain
    version and JAX's consensus_pos_batch (its scan and its Pallas fold in
    interpret mode), overflow flags included."""
    locs, n, pos, kw = _k1_case(name)
    got = _k1_model(locs, n, pos, **kw)
    _assert_same(got, _torch(locs, n, pos, **kw))
    _assert_same(got, _jax(locs, n, pos, impl="scan", **kw))
    if name != "k1024":  # the interpret-mode fold is slow at K = 1024
        _assert_same(got, _jax(locs, n, pos, impl="pallas_interpret", **kw))
    if name.startswith("sw"):
        assert got[1].sum() > 10


@pytest.mark.parametrize("seed", range(2))
def test_k1_model_nondefault_params(seed):
    """min_count 2, interval 12, range 200, and a negative interval: the
    clamp and wrap of the cluster bounds, as the plain version computes
    them."""
    rng = np.random.default_rng(500 + seed)
    locs, n, pos = _pack(_random_cases(rng, 48, 30, spread=300), 32)
    for kw in (dict(min_count=2, interval=12, range_=200),
               dict(min_count=1, interval=-3, range_=400)):
        _assert_same(_k1_model(locs, n, pos, **kw), _torch(locs, n, pos,
                                                           **kw))


# ---- the full sweep (the second pass of a window past a first pass) ----

@pytest.mark.parametrize("K,B,seed", [(64, 8, 0), (128, 16, 1), (256, 12, 2)])
def test_full_sweep_matches_jax_at_sweep_width_k(K, B, seed):
    """consensus_pos_full equals the JAX consensus_pos_batch at
    sweep_width = K, rows filled to K included; neither side raises an
    overflow flag at that width."""
    rng = np.random.default_rng(600 + seed)
    cases = _random_cases(rng, B, K + 1, spread=300)
    cases[0] = ([cases[0][1] + int(d) for d in rng.integers(-3, 4, K)],
                cases[0][1])
    locs, n, pos = _pack(cases, K)
    got = tcons.consensus_pos_full(*(torch.from_numpy(x)
                                     for x in (locs, n, pos)))
    got = got[0].numpy(), got[1].numpy()
    want = _jax(locs, n, pos, impl="scan", sweep_width=K)
    _assert_same(got, want)
    assert not got[1].any() and not want[1].any()


def test_full_sweep_matches_oracle_where_w4_overflows():
    """Rows whose sweep overflows at W = 4 (the first pass's flag) are
    exact under the full sweep: equal to the scalar oracle."""
    rng = np.random.default_rng(77)
    cases = _random_cases(rng, 64, 64)
    locs, n, pos = _pack(cases, 64)
    _, ovf = _torch(locs, n, pos, sweep_width=4)
    assert ovf.sum() > 10
    full, full_ovf = tcons.consensus_pos_full(*(torch.from_numpy(x)
                                                for x in (locs, n, pos)))
    assert not full_ovf.any()
    for b in np.flatnonzero(ovf):
        vals, p = cases[b]
        assert int(full[b]) == consensus_pos(vals, p), b


@pytest.mark.parametrize("name", ["random", "edge_wrap", "k1024",
                                  "nondefault"])
def test_full_sweep_bounded_form_matches_mask_form(name, monkeypatch):
    """The bounded plain form (searches on the sorted row, int64 prefix
    differences, blocks of rows) equals the mask form of the first pass
    run at sweep_width = K, overflow flags included, with blocks of one
    row and of many."""
    kw = {}
    if name == "nondefault":
        rng = np.random.default_rng(81)
        locs, n, pos = _pack(_random_cases(rng, 40, 32, spread=300), 32)
        kw = dict(min_count=2, interval=12, range_=200)
    else:
        locs, n, pos, _ = _k1_case(name)
    t = [torch.from_numpy(x) for x in (locs, n, pos)]
    want = _torch(locs, n, pos, sweep_width=locs.shape[1], **kw)
    for block in (tcons._FULL_BLOCK, locs.shape[1]):
        monkeypatch.setattr(tcons, "_FULL_BLOCK", block)
        got = tcons.consensus_pos_full_reference(*t, **kw)
        _assert_same((got[0].numpy(), got[1].numpy()), want)
