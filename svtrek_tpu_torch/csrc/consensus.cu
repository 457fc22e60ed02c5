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
// Design: one thread per window, the sweep carry in registers.  The sweep
// is a data-dependent sequential fold with an early exit, so a window is
// one thread's serial walk over at most W anchors; a left cluster is the
// run of the sorted row ending at the anchor, a right cluster the run
// starting at it, so each is a short scan of the row instead of the TPU
// version's masked [W, K] reduce.  Cluster totals are summed in int64 (the
// reference sums in uint64, refinement.c:59), and the rounded mean uses a
// floor division because CUDA's "/" truncates toward zero.
//
// Bound: latency, not bandwidth or arithmetic.  A batch is B <= a few
// thousand rows of K <= 1024 int32 (at most a few MB); each thread's loads
// are dependent and strided K*4 bytes from its neighbour's, so they do not
// coalesce and the L1/L2 caches carry them.  A warp per window over a
// [K, B] layout is the next step when this kernel shows in the profile.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBig = 0x7FFFFFFF;  // C int distance sentinel (refinement.c:49)
constexpr int kHalf = 25;         // SV_MIN_LENGTH / 2 (refinement.c:56, 78)
constexpr int kThreads = 64;      // small blocks: a 512-window batch still
                                  // spreads over 8 SMs

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

// Running state of one sweep (refinement.c:47-50 / 76-79).
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

// One accepted-or-not step of the fold (refinement.c:66-74 / 88-96).
__device__ __forceinline__ void sweep_step(Sweep& s, int cand, int count,
                                           int pos, int interval) {
  if (count <= s.max_count) return;
  int d = wrap_abs(wrap_sub(pos, cand));
  if (d < interval) {
    s.returned = true;
    s.ret_val = cand;
  } else if (d < s.best_dist) {
    s.max_count = count;
    s.best_val = cand;
    s.best_dist = d;
  }
}

// Left cluster of anchor i: {j <= i : row[j] >= L - interval}, the run of
// the sorted row ending at i (refinement.c:61-64).  Returns the rounded
// mean; *count gets the cluster size.
__device__ __forceinline__ int left_cluster(const int* row, int i, int L,
                                            int interval, int* count) {
  int lo = (L >= wrap_sub(kBig, interval)) ? L : wrap_sub(L, interval);
  long long c = 0, sum = 0;
  for (int j = i; j >= 0 && row[j] >= lo; --j) {
    ++c;
    sum += row[j];
  }
  *count = static_cast<int>(c);
  long long s = c * L - sum;  // sum of (L - value) over the cluster, >= 0
  return wrap_add(L, static_cast<int>(floor_div(c / 2 - s, c > 0 ? c : 1)));
}

// Right cluster of anchor i: {i <= j < n : row[j] <= L + interval}
// (refinement.c:83-86).
__device__ __forceinline__ int right_cluster(const int* row, int i, int n,
                                             int L, int interval,
                                             int* count) {
  int hi = (L >= wrap_sub(kBig, interval)) ? L : wrap_add(L, interval);
  long long c = 0, sum = 0;
  for (int j = i; j < n && row[j] <= hi; ++j) {
    ++c;
    sum += row[j];
  }
  *count = static_cast<int>(c);
  long long s = sum - c * L;  // sum of (value - L) over the cluster, >= 0
  long long cs = c > 0 ? c : 1;
  return wrap_add(L, static_cast<int>(floor_div(s + cs / 2, cs)));
}

__global__ void __launch_bounds__(kThreads)
consensus_pos_kernel(const int* __restrict__ locs, const int* __restrict__ n_in,
                     const int* __restrict__ pos_in, int B, int K, int W,
                     int min_count, int interval, int range_,
                     int* __restrict__ refined, uint8_t* __restrict__ overflow) {
  int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int* row = locs + static_cast<size_t>(b) * K;
  const int n = n_in[b];
  const int pos = pos_in[b];
  if (n < min_count || n <= 0) {  // consensus.py:304-306
    refined[b] = -1;
    overflow[b] = 0;
    return;
  }
  const int last = n - 1;
  const int n_row = n < K ? n : K;  // right clusters stop at min(n, K)

  // Left start: last index <= pos + 25 over the whole row, clamped to
  // [0, n-1] (refinement.c:3-10, 56; consensus.py:237-238).
  const int q = wrap_add(pos, kHalf);
  int lo = 0, hi = K;
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    if (row[mid] <= q) lo = mid + 1; else hi = mid;
  }
  const int point_l = min(max(lo - 1, 0), last);
  // Right start: the reference's upper_bound quirk, 0 or n-1
  // (refinement.c:12-19, 78; consensus.py:263-270).
  const int point_r = (row[0] < wrap_sub(pos, kHalf)) ? 0 : last;

  // Left sweep.  An anchor is active while it is in bounds and within
  // range_ of pos, as a cumulative AND; activity is followed to the end of
  // the W-step window even after an early return, because the overflow
  // flag reads it (consensus.py:253-261).
  Sweep sl = sweep_init(min_count);
  bool act_l = true;
  for (int k = 0; k < W; ++k) {
    int idx = point_l - k;
    if (idx < 0) { act_l = false; break; }
    int ic = min(idx, K - 1);
    int L = row[ic];
    if (!(wrap_abs(wrap_sub(pos, L)) < range_)) { act_l = false; break; }
    if (!sl.returned) {
      int count;
      int cand = left_cluster(row, ic, L, interval, &count);
      sweep_step(sl, cand, count, pos, interval);
    }
  }
  const bool ovf_l = act_l && (point_l - (W - 1) > 0);

  // Right sweep; it folds only if the left sweep did not return.
  Sweep sr = sweep_init(min_count);
  bool act_r = true;
  for (int k = 0; k < W; ++k) {
    int idx = point_r + k;
    if (idx >= n) { act_r = false; break; }
    int ic = min(idx, K - 1);
    int L = row[ic];
    if (!(wrap_abs(wrap_sub(pos, L)) < range_)) { act_r = false; break; }
    if (!sl.returned && !sr.returned) {
      int count;
      int cand = right_cluster(row, ic, n_row, L, interval, &count);
      sweep_step(sr, cand, count, pos, interval);
    }
  }
  const bool ovf_r = act_r && (point_r + (W - 1) < last);

  // Closer of the two; left wins only on a strictly smaller distance
  // (refinement.c:100).
  int out = sl.best_dist < sr.best_dist ? sl.best_val : sr.best_val;
  if (sr.returned) out = sr.ret_val;
  if (sl.returned) out = sl.ret_val;
  refined[b] = out;
  overflow[b] = (ovf_l || ovf_r) ? 1 : 0;
}

}  // namespace

extern "C" {

// locs [B, K] int32 row-major, each row sorted ascending with INT32_MAX
// padding; n, pos [B] int32; refined [B] int32; overflow [B] uint8.  All
// device pointers.  Launches on `stream` and returns cudaGetLastError().
int svtrek_consensus_pos(const void* locs, const void* n, const void* pos,
                         int B, int K, int W, int min_count, int interval,
                         int range_, void* refined, void* overflow,
                         void* stream) {
  if (B <= 0) return 0;
  int blocks = (B + kThreads - 1) / kThreads;
  consensus_pos_kernel<<<blocks, kThreads, 0,
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
