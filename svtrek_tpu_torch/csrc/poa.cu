// Banded global-alignment DP (K2) and its traceback (K3) for the star
// consensus of insertion clusters, for Hopper.
//
// K2 replaces the Pallas TPU kernel svtrek_tpu/ops/poa_pallas.py
// (dp_ptr_pallas, body _dp_rows_kernel); K3 replaces tb_batch_pallas (body
// _tb_rows_kernel).  Together they compute, for a batch of (target, query)
// pairs, ops/poa_batch.py::_dp_one: the banded DP of scalar
// ops/poa.py::_banded_dp, one query row at a time over a band of 2*band+1
// cells, then the walk from (n, m) back to (0, 0) that gives each target
// column its aligned query base (-1 = gap) and each column boundary the
// number of query bases inserted there.  Outputs equal the JAX program's
// exactly: the same int32 algebra (NEG = -2^28 for cells outside the band,
// ties to diag over up, left only when strictly greater, the j == 0
// boundary while i <= band), the same pointer codes (0 diag, 1 up, 2 left).
//
// Storage.  A pair's pointers depend only on its own m, n and band, so each
// pair stores its n rows at its own width 2*band+1, at a byte offset that
// is the prefix sum of n*(2*band+1) over the pairs before it (the TPU
// program padded every pair to the batch's widest band and longest query).
//
// K2 design: one warp per pair, the score row in shared memory (two rows,
// ping-pong), the band's cells striped over the lanes in chunks of 32.  The
// in-row left gap score[k] = GAP*k + max_{k'<k}(cand[k'] - GAP*k') is an
// exclusive prefix max: a warp shuffle scan within each chunk, carried from
// chunk to chunk, so a band of any width (up to 1,025 cells at band_cap
// 512) is one pass per row.  Bound: latency.  Each row is a dependent step
// of a few hundred instructions per warp; there is one warp per pair, so a
// batch of a few hundred pairs leaves most of the card idle, and the
// pointer stores (n*(2*band+1) bytes, coalesced per warp) are far below
// the memory bandwidth.  Staging the target in shared memory and fusing K3
// when a pair's pointers fit in shared memory are the next steps.
//
// K3 design: one thread per pair walking the pointers sequentially, as
// ops/poa_pallas.py::_traceback_one does per pair; the TPU's reverse row
// sweep exists for its vector lanes and is not needed here.  Bound: the
// latency of one dependent pointer load per step, n+m steps per pair.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMatch = 2;      // ops/poa.py MATCH / MISMATCH / GAP
constexpr int kMismatch = -4;
constexpr int kGap = -2;
constexpr int kNeg = -(1 << 28);  // band-invalid cells (poa_batch.py:41)
constexpr int kPad = 5;            // the padding base of the JAX program
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarpsPerBlock = 4;  // pairs per block of K2
constexpr int kTbThreads = 64;     // pairs per block of K3
constexpr int kDefaultSmem = 48 * 1024;

__device__ __forceinline__ int warp_inclusive_max(int v, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    int o = __shfl_up_sync(kFull, v, d);
    if (lane >= d) v = max(v, o);
  }
  return v;
}

// One warp per pair: pointer rows 1..n of the pair's band, written to
// ptr + offsets[b] as n rows of 2*band+1 int8 codes.  row_cap >= the
// widest band + 1 of the launch (the extra cell holds NEG, the "up" of the
// band's last cell).
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
poa_dp_ptr_kernel(const int8_t* __restrict__ tpad, int M,
                  const int* __restrict__ ms,
                  const int8_t* __restrict__ qpad, int N,
                  const int* __restrict__ ns, const int* __restrict__ bands,
                  const long long* __restrict__ offsets,
                  int8_t* __restrict__ ptr, int B, int row_cap) {
  extern __shared__ int smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarpsPerBlock + warp;
  if (b >= B) return;  // the whole warp leaves together; no block barrier
  int* prev = smem + warp * 2 * row_cap;
  int* cur = prev + row_cap;
  const int m = ms[b];
  const int n = ns[b];
  const int band = bands[b];
  const int width = 2 * band + 1;
  const int8_t* t = tpad + static_cast<size_t>(b) * M;
  const int8_t* q = qpad + static_cast<size_t>(b) * N;
  int8_t* out = ptr + offsets[b];

  // Row 0: score[0, j] = GAP*j for 0 <= j <= min(m, band); band cell k is
  // column j = i + k - band.
  const int j0_hi = min(m, band);
  for (int k = lane; k <= width; k += 32) {
    const int j0 = k - band;
    prev[k] = (k < width && j0 >= 0 && j0 <= j0_hi) ? kGap * j0 : kNeg;
    cur[k] = kNeg;
  }
  __syncwarp();

  for (int i = 1; i <= n; ++i) {
    const int qi = q[i - 1];
    int8_t* orow = out + static_cast<size_t>(i - 1) * width;
    int carry = kNeg;  // max of (cand - GAP*k) over the chunks done
    for (int k0 = 0; k0 < width; k0 += 32) {
      const int k = k0 + lane;
      const bool in = k < width;
      const int j = i + k - band;
      int cand = kNeg;
      int pc = 0;
      bool valid = false;
      bool bmask = false;
      if (in) {
        const int tb = (j >= 1 && j <= m) ? t[j - 1] : kPad;
        const int diag = prev[k] + (tb == qi ? kMatch : kMismatch);
        const int up = prev[k + 1] + kGap;
        pc = up > diag ? 1 : 0;  // a tie goes to diag
        valid = j >= 1 && j <= m && abs(j - i) <= band;
        cand = valid ? max(diag, up) : kNeg;
        // The left-column boundary score[i, 0] = GAP*i while i <= band
        // takes part as a left-gap source (poa_batch.py:90-94).
        bmask = j == 0 && i <= band;
        if (bmask) {
          cand = kGap * i;
          pc = 1;
        }
      }
      const int incl = warp_inclusive_max(in ? cand - kGap * k : kNeg, lane);
      const int before = __shfl_up_sync(kFull, incl, 1);
      const int excl = lane == 0 ? carry : max(carry, before);
      carry = max(carry, __shfl_sync(kFull, incl, 31));
      if (in) {
        const int left = excl + kGap * k;
        const bool use_left = valid && left > cand;  // strict
        // Cells outside the band are reset to NEG, so the prefix max never
        // carries a score across the band edge (poa_batch.py:104).
        cur[k] = (valid || bmask) ? (use_left ? left : cand) : kNeg;
        orow[k] = static_cast<int8_t>(use_left ? 2 : pc);
      }
    }
    __syncwarp();
    int* tmp = prev;
    prev = cur;
    cur = tmp;
  }
}

// One thread per pair: the walk of ops/poa_pallas.py::_traceback_one.
// cols [B, M] must hold -1 and ins [B, M+1] zeros on entry.
__global__ void __launch_bounds__(kTbThreads)
poa_traceback_kernel(const int8_t* __restrict__ ptr,
                     const long long* __restrict__ offsets,
                     const int8_t* __restrict__ qpad, int N,
                     const int* __restrict__ ms, const int* __restrict__ ns,
                     const int* __restrict__ bands, int B, int M,
                     int8_t* __restrict__ cols, int* __restrict__ ins) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int band = bands[b];
  const int width = 2 * band + 1;
  const int8_t* p0 = ptr + offsets[b];
  const int8_t* q = qpad + static_cast<size_t>(b) * N;
  int8_t* crow = cols + static_cast<size_t>(b) * M;
  int* irow = ins + static_cast<size_t>(b) * (M + 1);
  int i = ns[b];
  int j = ms[b];
  while (i > 0 || j > 0) {
    int p;
    if (i == 0) {
      p = 2;  // row 0 always moves left
    } else if (j == 0) {
      p = 1;  // column 0 always moves up
    } else {
      const int k = min(max(j - i + band, 0), 2 * band);
      p = p0[static_cast<size_t>(i - 1) * width + k];
    }
    if (i > 0 && j > 0 && p == 0) {  // diag: query base onto column j-1
      crow[j - 1] = q[i - 1];
      --i;
      --j;
    } else if (i > 0 && p == 1) {    // up: one inserted base at boundary j
      irow[j] += 1;
      --i;
    } else {                         // left: column j-1 is a gap
      --j;
    }
  }
}

}  // namespace

extern "C" {

// tpad [B, M] and qpad [B, N] int8 row-major (pad base 5); ms, ns, bands
// [B] int32 with m <= M, n <= N, 0 <= band <= max_band; offsets [B+1]
// int64 prefix sums of n*(2*band+1); ptr int8 of offsets[B] bytes.  All
// device pointers.  Launches on `stream` and returns cudaGetLastError().
int svtrek_poa_dp_ptr(const void* tpad, int M, const void* ms,
                      const void* qpad, int N, const void* ns,
                      const void* bands, const void* offsets, void* ptr,
                      int B, int max_band, void* stream) {
  if (B <= 0) return 0;
  const int row_cap = 2 * max_band + 2;
  const size_t smem =
      static_cast<size_t>(kWarpsPerBlock) * 2 * row_cap * sizeof(int);
  if (smem > kDefaultSmem) {
    cudaError_t e = cudaFuncSetAttribute(
        poa_dp_ptr_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int blocks = (B + kWarpsPerBlock - 1) / kWarpsPerBlock;
  poa_dp_ptr_kernel<<<blocks, 32 * kWarpsPerBlock, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(tpad), M, static_cast<const int*>(ms),
      static_cast<const int8_t*>(qpad), N, static_cast<const int*>(ns),
      static_cast<const int*>(bands),
      static_cast<const long long*>(offsets), static_cast<int8_t*>(ptr), B,
      row_cap);
  return static_cast<int>(cudaGetLastError());
}

// ptr/offsets as written by svtrek_poa_dp_ptr; qpad [B, N] int8; ms, ns,
// bands [B] int32; cols [B, M] int8 filled with -1 and ins [B, M+1] int32
// filled with 0 by the caller.  Launches on `stream` and returns
// cudaGetLastError().
int svtrek_poa_traceback(const void* ptr, const void* offsets,
                         const void* qpad, int N, const void* ms,
                         const void* ns, const void* bands, int B, int M,
                         void* cols, void* ins, void* stream) {
  if (B <= 0) return 0;
  const int blocks = (B + kTbThreads - 1) / kTbThreads;
  poa_traceback_kernel<<<blocks, kTbThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(ptr),
      static_cast<const long long*>(offsets),
      static_cast<const int8_t*>(qpad), N, static_cast<const int*>(ms),
      static_cast<const int*>(ns), static_cast<const int*>(bands), B, M,
      static_cast<int8_t*>(cols), static_cast<int*>(ins));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
