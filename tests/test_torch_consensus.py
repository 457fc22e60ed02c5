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
