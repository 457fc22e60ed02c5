// Batched position-clustering consensus (refinement.c:41-101) for Hopper.
//
// Replaces the Pallas TPU kernel svtrek_tpu/ops/sweep_pallas.py
// (sweep_fold_pallas) and, with it, the whole device body of
// svtrek_tpu/ops/consensus.py::consensus_pos_batch: the two sweep start
// points (_row_searchsorted), the anchor gathers (_locs_at), the cluster
// stats (_anchor_stats) and both sequential sweeps with the final
// closer-of-two pick.  Outputs equal that function's (refined, overflow)
// exactly, including its int32 wrap-around and its clamp of cluster bounds
// near INT32_MAX.
//
// Bound: latency and launch, not bandwidth or arithmetic.  A batch is B
// <= a few thousand rows of K <= 16384 int32 (at most a few MB; the first
// pass ships K <= 8192, a second pass up to kMaxK), and at the main path's
// (512, 16) the bytes bound is about 0.01 us: the floor is the launch, a
// few us.  The design this one replaced ran one thread per
// window: a binary search, then up to W anchors each with a serial cluster
// scan, all dependent loads strided K*4 bytes from the next thread's, on 8
// of 132 SMs at (512, 16).
//
// Design: one warp per window, everything a window reads in shared memory.
// - The row is loaded once, coalesced, into shared memory, with its int64
//   prefix sums (one warp scan a 32-value chunk), so that a cluster's sum
//   is a difference of two prefixes.  Cluster totals are int64 (the
//   reference sums in uint64, refinement.c:59), and the rounded mean uses a
//   floor division because CUDA's "/" truncates toward zero.
// - The left start is the count of values <= pos + 25 (one ballot a chunk
//   over the sorted row); the right start the reference's upper_bound
//   quirk.
// - The row is sorted, so each anchor's clusters are index ranges: left
//   [lower_bound(lo), i], right [i, min(upper_bound(hi), n) - 1], found by
//   binary searches in shared memory.  Lane t takes the anchors t, t+32,
//   ... of a sweep, so up to 32 anchors' (candidate, count) are computed at
//   once: the precompute-then-fold split of the TPU version (_anchor_stats,
//   then sweep_fold_pallas).
// - The fold stays sequential in its order, with its early exit, but jumps
//   from one accepted anchor to the next: a step changes the carry only if
//   its count beats max_count and its distance is under interval or
//   best_dist, so one ballot over a chunk of 32 anchors finds the next
//   such step under the current carry; the steps it skips change nothing.
// - Small blocks, so that the main shape's 512 windows spread over the
//   card; the shared memory per warp grows with K (12 bytes a value), so
//   wide rows take fewer warps a block.
// What bounds it now is one warp's chain of dependent steps (the loads, the
// int64 scan, the searches and the fold's ballots): on an H100 about 2.5x
// the time of one elementwise op over the same B values at (512, 16).

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr int kBig = 0x7FFFFFFF;  // C int distance sentinel (refinement.c:49)
constexpr int kHalf = 25;         // SV_MIN_LENGTH / 2 (refinement.c:56, 78)
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxWarps = 4;      // windows per block at most
// The widest row the kernel takes (kernels.CONSENSUS_MAX_K): one warp's
// row and prefix sums, 12*K + 8 bytes, in a block's 227 KB.
constexpr int kMaxK = 16384;
constexpr int kSmemCap = 227 * 1024;
constexpr int kDefaultSmem = 48 * 1024;

// int32 arithmetic that wraps like XLA's (signed overflow is undefined in C++).
__device__ __forceinline__ int wrap_add(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}
__device__ __forceinline__ int wrap_sub(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) - static_cast<unsigned>(b));
}
__device__ __forceinline__ int wrap_abs(int a) {  // |INT32_MIN| stays INT32_MIN
  return a < 0 ? static_cast<int>(0u - static_cast<unsigned>(a)) : a;
}
__device__ __forceinline__ long long floor_div(long long a, long long b) {
  long long q = a / b;  // b > 0
  return (q * b > a) ? q - 1 : q;
}

// Running state of one sweep (refinement.c:47-50 / 76-79); every lane of
// the warp holds the same.
struct Sweep {
  int max_count;
  int best_dist;
  int best_val;
  int ret_val;
  bool returned;
};

__device__ __forceinline__ Sweep sweep_init(int min_count) {
  return Sweep{min_count - 1, kBig, -1, -1, false};
}

// An anchor within interval of INT32_MAX is padding: its cluster bounds
// are clamped to it (consensus.py:100-101), compared in int64 as the plain
// version does.
__device__ __forceinline__ bool near_max(int L, int interval) {
  return static_cast<long long>(L) >= static_cast<long long>(kBig) - interval;
}

// The number of row[lo..hi) values below x (strict) or at most x, in a
// sorted row: the binary search of lower_bound / upper_bound.
template <bool kInclusive>
__device__ __forceinline__ int count_below(const int* row, int lo, int hi,
                                           int x) {
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (kInclusive ? row[mid] <= x : row[mid] < x) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// Left cluster of anchor i with value L: {j <= i : row[j] >= lo}, the run
// [lower_bound(lo), i] of the sorted row (refinement.c:61-64).  Returns the
// rounded mean; *count gets the cluster size.  sum: the row's prefix sums.
__device__ __forceinline__ int left_cluster(const int* row,
                                            const long long* sum, int i,
                                            int L, int interval, int* count) {
  const int lo = near_max(L, interval) ? L : wrap_sub(L, interval);
  const int first = count_below<false>(row, 0, i + 1, lo);
  const long long c = i + 1 - first;
  *count = static_cast<int>(c);
  const long long s = c * L - (sum[i + 1] - sum[first]);  // >= 0
  return wrap_add(L, static_cast<int>(floor_div(c / 2 - s, c > 0 ? c : 1)));
}

// Right cluster: {i <= j < n : row[j] <= hi}, the run
// [i, upper_bound(hi) - 1] (refinement.c:83-86).
__device__ __forceinline__ int right_cluster(const int* row,
                                             const long long* sum, int i,
                                             int n, int L, int interval,
                                             int* count) {
  const int hi = near_max(L, interval) ? L : wrap_add(L, interval);
  const int end = count_below<true>(row, i, n, hi);
  const long long c = end - i;
  *count = static_cast<int>(c);
  const long long s = (sum[end] - sum[i]) - c * L;  // >= 0
  const long long cs = c > 0 ? c : 1;
  return wrap_add(L, static_cast<int>(floor_div(s + cs / 2, cs)));
}

// One sweep over the anchors point + dir*k, k < W: activity (in bounds,
// within range_ of pos, as a cumulative AND) followed to the end of the W
// anchors, and, while `fold`, the fold of the anchors' clusters into sw.
// An anchor past the row reads its last value, as the JAX program's
// clamped gather does.  Returns whether all W anchors were active.
template <int kDir>
__device__ __forceinline__ bool sweep(Sweep& sw, bool fold, const int* row,
                                      const long long* sum, int K, int point,
                                      int n, int n_row, int W, int pos,
                                      int interval, int range_, int lane) {
  int last = -1;  // the chunk's anchor (lane) of the last accepted step
  for (int c0 = 0; c0 < W; c0 += 32) {
    const int idx = point + kDir * (c0 + lane);
    const bool in = c0 + lane < W && (kDir < 0 ? idx >= 0 : idx < n);
    const int ic = min(idx, K - 1);
    const int L = in ? row[ic] : 0;
    const unsigned ok =
        __ballot_sync(kFull, in && wrap_abs(wrap_sub(pos, L)) < range_);
    // Active: this lane and every lane before it ok.
    const int active = ok == kFull ? 32 : __ffs(~ok) - 1;
    fold = fold && !sw.returned;
    if (fold && active > 0) {
      int count = 0, cand = 0;
      if (lane < active)
        cand = kDir < 0
                   ? left_cluster(row, sum, ic, L, interval, &count)
                   : right_cluster(row, sum, ic, n_row, L, interval, &count);
      const int d = wrap_abs(wrap_sub(pos, cand));
      last = -1;
      while (true) {
        const bool step = lane < active && lane > last &&
                          count > sw.max_count &&
                          (d < interval || d < sw.best_dist);
        const unsigned hit = __ballot_sync(kFull, step);
        if (!hit) break;
        last = __ffs(hit) - 1;
        const int c_cand = __shfl_sync(kFull, cand, last);
        const int c_count = __shfl_sync(kFull, count, last);
        const int c_d = __shfl_sync(kFull, d, last);
        if (c_d < interval) {
          sw.returned = true;
          sw.ret_val = c_cand;
          break;
        }
        sw.max_count = c_count;
        sw.best_val = c_cand;
        sw.best_dist = c_d;
      }
    }
    if (active < min(32, W - c0)) return false;
  }
  return true;
}

// Warp w of a block owns window blockIdx.x * warps + w; its row and prefix
// sums live in the block's dynamic shared memory, 12*K + 8 bytes a warp.
__global__ void __launch_bounds__(32 * kMaxWarps)
consensus_pos_kernel(const int* __restrict__ locs, const int* __restrict__ n_in,
                     const int* __restrict__ pos_in, int B, int K, int W,
                     int min_count, int interval, int range_,
                     int* __restrict__ refined, uint8_t* __restrict__ overflow) {
  extern __shared__ long long smem[];
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * warps + warp;
  if (b >= B) return;  // the whole warp leaves together
  const int n = n_in[b];
  const int pos = pos_in[b];
  if (n < min_count || n <= 0) {  // consensus.py:304-306
    if (lane == 0) {
      refined[b] = -1;
      overflow[b] = 0;
    }
    return;
  }
  long long* sum = smem + static_cast<size_t>(warp) * (K + 1);
  int* row = reinterpret_cast<int*>(smem + static_cast<size_t>(warps) *
                                               (K + 1)) +
             static_cast<size_t>(warp) * K;
  const int* g = locs + static_cast<size_t>(b) * K;

  // The row and its prefix sums; the left start is the count of values
  // <= pos + 25 over the whole row (refinement.c:3-10, 56;
  // consensus.py:237-238), the row being sorted.
  const int q = wrap_add(pos, kHalf);
  int le = 0;
  long long carry = 0;
  if (lane == 0) sum[0] = 0;
  for (int c0 = 0; c0 < K; c0 += 32) {
    const int x = c0 + lane;
    const int v = x < K ? g[x] : 0;
    le += __popc(__ballot_sync(kFull, x < K && v <= q));
    long long incl = x < K ? v : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const long long o = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl += o;
    }
    if (x < K) {
      row[x] = v;
      sum[x + 1] = carry + incl;
    }
    carry += __shfl_sync(kFull, incl, 31);
  }
  __syncwarp();
  const int last = n - 1;
  const int point_l = min(max(le - 1, 0), last);
  // Right start: the reference's upper_bound quirk, 0 or n-1
  // (refinement.c:12-19, 78; consensus.py:263-270).
  const int point_r = (row[0] < wrap_sub(pos, kHalf)) ? 0 : last;
  const int n_row = n < K ? n : K;  // right clusters stop at min(n, K)

  // The left sweep; the right one folds only if the left did not return.
  // Activity is followed to the end of the W anchors even after an early
  // return, because the overflow flag reads it (consensus.py:253-261).
  Sweep sl = sweep_init(min_count);
  const bool act_l = sweep<-1>(sl, true, row, sum, K, point_l, n, n_row, W,
                               pos, interval, range_, lane);
  const bool ovf_l = act_l && (point_l - (W - 1) > 0);
  Sweep sr = sweep_init(min_count);
  const bool act_r = sweep<1>(sr, !sl.returned, row, sum, K, point_r, n,
                              n_row, W, pos, interval, range_, lane);
  const bool ovf_r = act_r && (point_r + (W - 1) < last);

  // Closer of the two; left wins only on a strictly smaller distance
  // (refinement.c:100).
  if (lane == 0) {
    int out = sl.best_dist < sr.best_dist ? sl.best_val : sr.best_val;
    if (sr.returned) out = sr.ret_val;
    if (sl.returned) out = sl.ret_val;
    refined[b] = out;
    overflow[b] = (ovf_l || ovf_r) ? 1 : 0;
  }
}

// Windows a block: up to kMaxWarps whose rows fit in the block's shared
// memory; 0 when one row does not.
int warps_per_block(int K) {
  const long long per_warp = 12LL * K + 8;
  return static_cast<int>(
      std::min(static_cast<long long>(kMaxWarps), kSmemCap / per_warp));
}

}  // namespace

extern "C" {

// The widest row the kernel takes (kernels.CONSENSUS_MAX_K).
int svtrek_consensus_max_k() { return kMaxK; }

// locs [B, K] int32 row-major, each row sorted ascending with INT32_MAX
// padding, K <= kMaxK; n, pos [B] int32; refined [B] int32; overflow [B]
// uint8.  All device pointers.  Launches on `stream` and returns
// cudaGetLastError().
int svtrek_consensus_pos(const void* locs, const void* n, const void* pos,
                         int B, int K, int W, int min_count, int interval,
                         int range_, void* refined, void* overflow,
                         void* stream) {
  if (B <= 0) return 0;
  if (K < 1 || K > kMaxK) return static_cast<int>(cudaErrorInvalidValue);
  const int warps = warps_per_block(K);
  const size_t smem = static_cast<size_t>(warps) * (12LL * K + 8);
  if (smem > kDefaultSmem) {
    cudaError_t e = cudaFuncSetAttribute(
        consensus_pos_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int blocks = (B + warps - 1) / warps;
  consensus_pos_kernel<<<blocks, 32 * warps, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(locs), static_cast<const int*>(n),
      static_cast<const int*>(pos), B, K, W, min_count, interval, range_,
      static_cast<int*>(refined), static_cast<uint8_t*>(overflow));
  return static_cast<int>(cudaGetLastError());
}

const char* svtrek_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
