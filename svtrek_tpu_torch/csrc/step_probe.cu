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
// Design.  One block owns kWarps consecutive b rows, one warp per b.  The
// block walks the steps [s0, s1) in order; in each step every warp reads
// its rows_per rows of WP bytes with vector loads (16 bytes a lane where
// WP and the base address allow, else 4, else 1) and adds the bytes into a
// per-lane int32 with __dp4a, and the step ends with a block barrier, the
// counterpart of the TPU's grid step.  The per-lane sums are reduced by
// warp shuffles at the end; the launch with s0 == 0 writes column 0 and
// zeroes columns 1-127, a launch with s0 > 0 adds to column 0.  So the same
// kernel gives both of the probe's measurements: one launch that walks all
// steps (the per-step cost), and one launch per step (the per-launch cost
// that the ctypes-bound K2/K3 calls pay).
//
// Bound: at the tool's default shape (84 MB of int8) the bytes, 3.35 TB/s
// of HBM on the H100; at few steps per launch, the launch itself.  It is
// not tuned: one warp per b leaves lanes idle where WP/16 < 32.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarps = 4;   // b rows per block
constexpr int kCols = 128;  // the accumulator block's width
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

template <int V>
__global__ void __launch_bounds__(32 * kWarps)
step_probe_kernel(const int8_t* __restrict__ ptr, int B, int WP,
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

}  // namespace

extern "C" {

// ptr int8 [N, B, WP] row-major with N = (number of steps) * rows_per;
// out int32 [B, 128].  Walks steps [s0, s1); s0 == 0 initialises out.
// Device pointers.  Launches on `stream` and returns cudaGetLastError().
int svtrek_step_probe(const void* ptr, int B, int WP, int rows_per, int s0,
                      int s1, void* out, void* stream) {
  if (B <= 0) return 0;
  const int blocks = (B + kWarps - 1) / kWarps;
  const auto addr = reinterpret_cast<uintptr_t>(ptr);
  const auto* p = static_cast<const int8_t*>(ptr);
  auto* o = static_cast<int*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  if (WP % 16 == 0 && addr % 16 == 0) {
    step_probe_kernel<16><<<blocks, 32 * kWarps, 0, st>>>(p, B, WP, rows_per,
                                                           s0, s1, o);
  } else if (WP % 4 == 0 && addr % 4 == 0) {
    step_probe_kernel<4><<<blocks, 32 * kWarps, 0, st>>>(p, B, WP, rows_per,
                                                          s0, s1, o);
  } else {
    step_probe_kernel<1><<<blocks, 32 * kWarps, 0, st>>>(p, B, WP, rows_per,
                                                          s0, s1, o);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
