// Step-overhead probe (K4) for Hopper: a reduction of int8 pointer rows
// walked as a sequence of steps.
//
// K4 replaces the inline Pallas TPU kernel `k` of
// tools/pallas_step_overhead.py (`run`, pallas_call at :55).  That kernel
// ran a grid of N / rows_per sequential steps; each step read one
// [rows_per, B, WP] int8 block and added its per-b sums into column 0 of a
// [B, 128] int32 accumulator, which the first step zeroed.  Its purpose was
// to measure the fixed cost of one grid step.  The output here is the same:
// out[b, 0] = sum over n, w of ptr[n, b, w] in int32, out[b, 1:128] = 0.
//
// Bound: the bytes.  A call reads N*B*WP bytes once (83.9 MB at the tool's
// default 1280 x 256 x 256, 25 us at the H100's 3.35 TB/s) and does one add
// per byte, far below the card's integer rate.  Reaching the bytes bound
// takes a few MB of loads in flight across the card: tens of KB per SM.
//
// Design.  The grid is b-tiles x step ranges.  A block of 256 threads owns
// `tb` consecutive b rows, whose bytes are contiguous in each row n, and a
// range of consecutive steps; it walks its steps in order, each step ending
// with a block barrier, the counterpart of the TPU's grid step.  In a row
// every thread reads kLoads vectors of the tile at a time (16 bytes a lane
// where WP and the base address allow, else 4, else 1), all issued before
// any is summed, and adds their bytes with __dp4a into one int32 per
// vector; a row of one b wider than kLoads*kThreads vectors takes more
// such passes.  A vector never straddles two b rows, so each of a thread's
// sums belongs to one b for the whole walk.  At the end the block folds its sums
// per b in shared memory and adds each into out[b, 0] with an integer
// atomicAdd, exact in any order.  The host sizes the tile so that a row of
// it is kLoads vectors a thread (64 b rows at WP 256), and cuts the steps
// into ranges so that the launch has about kTargetBlocks blocks: 8 per SM,
// 128 KB of loads in flight on each.  (Loading a block's next row before
// its barrier, or 4 blocks per SM, took the same time on the card.)  A
// launch with s0 == 0 first zeroes out on its stream (so out[:, 1:] = 0); a
// launch with s0 > 0 adds to column 0.  So the same entry point gives both
// of the probe's measurements: one launch that walks all steps, and one
// launch per step (the per-launch cost that the ctypes-bound K2/K3 calls
// pay).
//
// It replaces the design of one warp per b row (64 blocks of 4 warps at
// B = 256, 16 lanes loading at WP 256, one load in flight a thread), which
// read 111-130 GB/s.  That kernel is kept below, as step_probe_warp_kernel
// behind the C entry point svtrek_step_probe_warp, only so that
// chip_smoke.py can time it beside this one in the same run; the port's
// wrapper never launches it.

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr int kThreads = 256;          // threads per block
constexpr int kLoads = 4;              // vectors a thread reads per row
constexpr int kTargetBlocks = 132 * 8;  // 8 blocks on each of 132 SMs
constexpr int kMaxTile = kLoads * kThreads;  // b rows of a tile at WP 1
constexpr int kCols = 128;  // the accumulator block's width
constexpr int kWarps = 4;   // b rows per block of the replaced design
constexpr unsigned kFull = 0xffffffffu;
constexpr int kOnes = 0x01010101;  // __dp4a weights: the sum of 4 bytes

template <int V>
__device__ __forceinline__ int sum_bytes(const int8_t* p, int acc);

template <>
__device__ __forceinline__ int sum_bytes<16>(const int8_t* p, int acc) {
  const int4 v = *reinterpret_cast<const int4*>(p);
  acc = __dp4a(v.x, kOnes, acc);
  acc = __dp4a(v.y, kOnes, acc);
  acc = __dp4a(v.z, kOnes, acc);
  return __dp4a(v.w, kOnes, acc);
}

template <>
__device__ __forceinline__ int sum_bytes<4>(const int8_t* p, int acc) {
  return __dp4a(*reinterpret_cast<const int*>(p), kOnes, acc);
}

template <>
__device__ __forceinline__ int sum_bytes<1>(const int8_t* p, int acc) {
  return acc + static_cast<int>(*p);
}

// The vector type of each width, for loads issued before the sums.
template <int V> struct Vec;
template <> struct Vec<16> { using T = int4; };
template <> struct Vec<4> { using T = int; };
template <> struct Vec<1> { using T = int8_t; };

template <int V>
__device__ __forceinline__ int add_bytes(const typename Vec<V>::T& v,
                                         int acc);
template <>
__device__ __forceinline__ int add_bytes<16>(const int4& v, int acc) {
  acc = __dp4a(v.x, kOnes, acc);
  acc = __dp4a(v.y, kOnes, acc);
  acc = __dp4a(v.z, kOnes, acc);
  return __dp4a(v.w, kOnes, acc);
}
template <>
__device__ __forceinline__ int add_bytes<4>(const int& v, int acc) {
  return __dp4a(v, kOnes, acc);
}
template <>
__device__ __forceinline__ int add_bytes<1>(const int8_t& v, int acc) {
  return acc + static_cast<int>(v);
}

// Block (x, y): b rows [x*tb, x*tb + tb), steps [s0 + y*spb, + spb) of
// [s0, s1).  A tile row of more than kLoads*kThreads vectors (WP/V > 1024,
// where the host sets tb = 1) is read in passes of kLoads*kThreads; every
// vector then belongs to the one b row, so each acc[u] still has one b.
template <int V>
__global__ void __launch_bounds__(kThreads)
step_probe_kernel(const int8_t* __restrict__ ptr, int B, int WP,
                  int rows_per, int s0, int s1, int tb, int spb,
                  int* __restrict__ out) {
  __shared__ int part[kMaxTile];
  using T = typename Vec<V>::T;
  const int b0 = blockIdx.x * tb;
  const int nb = min(tb, B - b0);
  const int nvec = nb * WP / V;  // vectors of the tile in one row
  const int sa = s0 + blockIdx.y * spb;
  const int sb = min(s1, sa + spb);
  int acc[kLoads];
#pragma unroll
  for (int u = 0; u < kLoads; ++u) acc[u] = 0;
  for (int s = sa; s < sb; ++s) {
    for (int r = 0; r < rows_per; ++r) {
      const long long n = static_cast<long long>(s) * rows_per + r;
      const T* row = reinterpret_cast<const T*>(ptr + (n * B + b0) * WP);
      for (int c = threadIdx.x; c < nvec; c += kMaxTile) {
        T v[kLoads];
#pragma unroll
        for (int u = 0; u < kLoads; ++u) {
          if (c + u * kThreads < nvec) v[u] = row[c + u * kThreads];
        }
#pragma unroll
        for (int u = 0; u < kLoads; ++u) {
          if (c + u * kThreads < nvec) acc[u] = add_bytes<V>(v[u], acc[u]);
        }
      }
    }
    __syncthreads();  // the end of one step
  }
  for (int i = threadIdx.x; i < nb; i += kThreads) part[i] = 0;
  __syncthreads();
#pragma unroll
  for (int u = 0; u < kLoads; ++u) {
    const int i = threadIdx.x + u * kThreads;
    if (i < nvec) atomicAdd(&part[i * V / WP], acc[u]);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nb; i += kThreads)
    atomicAdd(out + static_cast<long long>(b0 + i) * kCols, part[i]);
}

// The replaced design: one block owns kWarps consecutive b rows, one warp
// per b, and walks the steps [s0, s1), each warp reading its rows with one
// vector load a lane in flight.
template <int V>
__global__ void __launch_bounds__(32 * kWarps)
step_probe_warp_kernel(const int8_t* __restrict__ ptr, int B, int WP,
                       int rows_per, int s0, int s1, int* __restrict__ out) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarps + warp;
  const bool active = b < B;
  const int nvec = WP / V;
  int acc = 0;
  for (int s = s0; s < s1; ++s) {
    if (active) {
      for (int r = 0; r < rows_per; ++r) {
        const long long n = static_cast<long long>(s) * rows_per + r;
        const int8_t* row = ptr + (n * B + b) * WP;
        for (int v = lane; v < nvec; v += 32) acc = sum_bytes<V>(row + v * V, acc);
      }
    }
    __syncthreads();  // the end of one step
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) acc += __shfl_down_sync(kFull, acc, d);
  if (!active) return;
  int* o = out + static_cast<long long>(b) * kCols;
  if (lane == 0) o[0] = (s0 == 0 ? 0 : o[0]) + acc;
  if (s0 == 0) {
    for (int c = 1 + lane; c < kCols; c += 32) o[c] = 0;
  }
}

// The widest vector the rows allow: every row of WP bytes starts V-aligned.
int vector_bytes(const void* ptr, int WP) {
  const auto addr = reinterpret_cast<uintptr_t>(ptr);
  if (WP % 16 == 0 && addr % 16 == 0) return 16;
  if (WP % 4 == 0 && addr % 4 == 0) return 4;
  return 1;
}

int ceil_div(long long a, long long b) { return static_cast<int>((a + b - 1) / b); }

}  // namespace

extern "C" {

// ptr int8 [N, B, WP] row-major with N = (number of steps) * rows_per;
// out int32 [B, 128].  Walks steps [s0, s1); s0 == 0 initialises out.
// Device pointers.  Launches on `stream` and returns cudaGetLastError().
int svtrek_step_probe(const void* ptr, int B, int WP, int rows_per, int s0,
                      int s1, void* out, void* stream) {
  if (B <= 0) return 0;
  auto st = static_cast<cudaStream_t>(stream);
  auto* o = static_cast<int*>(out);
  if (s0 == 0) {
    cudaError_t e = cudaMemsetAsync(
        o, 0, static_cast<size_t>(B) * kCols * sizeof(int), st);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int steps = s1 - s0;
  if (steps <= 0 || WP <= 0) return static_cast<int>(cudaGetLastError());
  const int V = vector_bytes(ptr, WP);
  // A tile row is kLoads vectors a thread; with few steps (one launch per
  // step), smaller tiles give the launch more blocks while every thread
  // still has a vector.
  int tb = std::min(B, std::max(1, kLoads * kThreads * V / WP));
  while (tb > 1 && static_cast<long long>(ceil_div(B, tb)) * steps <
                       kTargetBlocks &&
         (tb / 2) * WP / V >= kThreads)
    tb /= 2;
  const int btiles = ceil_div(B, tb);
  const int ranges =
      std::min(steps, std::max(1, ceil_div(kTargetBlocks, btiles)));
  const int spb = ceil_div(steps, ranges);
  const dim3 grid(btiles, ceil_div(steps, spb));
  const auto* p = static_cast<const int8_t*>(ptr);
  if (V == 16) {
    step_probe_kernel<16><<<grid, kThreads, 0, st>>>(p, B, WP, rows_per, s0,
                                                    s1, tb, spb, o);
  } else if (V == 4) {
    step_probe_kernel<4><<<grid, kThreads, 0, st>>>(p, B, WP, rows_per, s0,
                                                   s1, tb, spb, o);
  } else {
    step_probe_kernel<1><<<grid, kThreads, 0, st>>>(p, B, WP, rows_per, s0,
                                                   s1, tb, spb, o);
  }
  return static_cast<int>(cudaGetLastError());
}

// The replaced design, with svtrek_step_probe's arguments and result.
int svtrek_step_probe_warp(const void* ptr, int B, int WP, int rows_per,
                           int s0, int s1, void* out, void* stream) {
  if (B <= 0) return 0;
  const int blocks = (B + kWarps - 1) / kWarps;
  const auto* p = static_cast<const int8_t*>(ptr);
  auto* o = static_cast<int*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  const int V = vector_bytes(ptr, WP);
  if (V == 16) {
    step_probe_warp_kernel<16><<<blocks, 32 * kWarps, 0, st>>>(
        p, B, WP, rows_per, s0, s1, o);
  } else if (V == 4) {
    step_probe_warp_kernel<4><<<blocks, 32 * kWarps, 0, st>>>(
        p, B, WP, rows_per, s0, s1, o);
  } else {
    step_probe_warp_kernel<1><<<blocks, 32 * kWarps, 0, st>>>(
        p, B, WP, rows_per, s0, s1, o);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
