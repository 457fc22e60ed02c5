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
// K2 bound.  The pointer bytes it must write (n*(2*band+1) per pair) and
// about a dozen int32 operations per cell put the whole card's bound at a
// few tenths of a ms for a DP batch; but the rows of one pair are a
// dependent chain, so a launch lasts at least as long as its longest pair
// takes row by row.  The design cuts that per-row chain and starts the
// longest chains first.
//
// K2 design (the strip kernel, bands up to kStripMaxBand):
// - One warp per pair.  Lane l holds the contiguous strip of S cells
//   k = l*S .. l*S+S-1 of the score row in registers, S chosen per pair
//   from kStrips (the smallest with 32*S >= 2*band+1; the kernel is
//   templated on S and each warp takes its pair's S).  diag reads the
//   lane's own register, up the next one or, for the last cell, one
//   shuffle from lane+1.
// - The in-row left gap, score[k] = GAP*k + max_{k'<k}(cand[k'] - GAP*k'),
//   is a serial max over the strip, then one warp scan of the 32 strip
//   maxima, then a second pass over the strip: one scan per row instead of
//   one per 32 cells, and no round trip of the score row through shared
//   memory.
// - The target bases of the strip follow the band in registers: each row
//   shifts them by one cell (one shuffle from lane+1); lane 31's new top
//   base and each row's query base come from a coalesced load per 32 rows,
//   issued 32 rows ahead, and reach the row by a shuffle.  The target is
//   read once per pair, not once per cell.
// - Each row's codes are staged in a per-warp shared-memory buffer (two,
//   alternating, so one __syncwarp per row suffices) at the alignment of
//   their global address, then written as whole 32-bit words; only the
//   partial words at a row's two ends are written byte by byte.
// - The work of a row that does not wait for the row before (the target
//   shift, the next query base, the copy-out of the row before) sits
//   between pass 1 and the scan, to fill the scan's shuffle latency.
// - The wrapper hands the kernel a work list: the pairs sorted by
//   n*(2*band+1), longest first, so the longest chains start in the first
//   wave; the offsets stay in input order.
// Pairs with a band above kStripMaxBand (up to POA_MAX_BAND 2048; the main
// path sends at most band_cap 512) take the chunked kernel, the design this
// one replaced: the score rows in shared memory, the band striped over the
// lanes in chunks of 32 with a warp scan carried from chunk to chunk, its
// shared memory sized by the widest band of its own launch.  Its registers
// do not grow with the band.
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
constexpr int kWarpsPerBlock = 4;  // pairs per block of K2's chunked kernel
// The strip kernel runs one pair per block of one warp, so that a small
// batch spreads over every SM, and at most 128 registers a thread, so that
// 16 pairs share an SM.
constexpr int kStripBlocksPerSm = 16;
constexpr int kTbThreads = 64;     // pairs per block of K3
constexpr int kDefaultSmem = 48 * 1024;
// The strip widths S of the strip kernel (kernels.POA_STRIPS), and the
// widest band they hold: 32 * 33 cells >= 2 * 527 + 1.
constexpr int kMaxStrip = 33;
constexpr int kStripMaxBand = (32 * kMaxStrip - 1) / 2;
// A row's staged codes: its widest row plus up to 3 bytes of alignment,
// in whole words.
constexpr int kRowWords = (32 * kMaxStrip + 3 + 3) / 4;

__device__ __forceinline__ int warp_inclusive_max(int v, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    int o = __shfl_up_sync(kFull, v, d);
    if (lane >= d) v = max(v, o);
  }
  return v;
}

// Target base of column j (1-based), the padding base outside [1, m].
__device__ __forceinline__ int target_base(const int8_t* t, int m, int j) {
  return (j >= 1 && j <= m) ? t[j - 1] : kPad;
}

// Row orow's width codes, staged in buf at orow's alignment a, to global
// memory (if `on`; predicated, not branched, so that the compiler can
// interleave it with other work): its whole aligned words, one a lane,
// unrolled for rows of up to 32*S cells; the bytes before and after them
// (at most 3 each, whose words a neighbouring row, maybe another pair's,
// shares) byte by byte, by lanes 0-2 and 3-5.
template <int S>
__device__ __forceinline__ void copy_row(int8_t* orow, int width,
                                         const int* buf, int lane, bool on) {
  const int a = static_cast<int>(reinterpret_cast<uintptr_t>(orow) & 3);
  const int e = a + width;
  const int wf = (a + 3) >> 2, wl = e >> 2;
  int* gw = reinterpret_cast<int*>(orow - a);
#pragma unroll
  for (int u = 0; u < (32 * S + 6 + 127) / 128; ++u) {
    const int w = wf + lane + 32 * u;
    if (on && w < wl) gw[w] = buf[w];
  }
  const int c = lane < 3 ? a + lane : max(4 * wl, 4 * wf) + lane - 3;
  if (on && lane < 6 && c < (lane < 3 ? min(4 * wf, e) : e))
    orow[c - a] = reinterpret_cast<const int8_t*>(buf)[c];
}

// One pair's pointer rows 1..n at out, n rows of 2*band+1 codes; the warp's
// score strip of S cells a lane in registers.  rows: the warp's two staging
// buffers of kRowWords words.  The work of the next row that does not wait
// for this row's scores (its bases, the copy-out of the row before) sits
// between pass 1 and the scan, where it fills the scan's shuffle latency.
template <int S>
__device__ __forceinline__ void dp_pair_strip(
    const int8_t* __restrict__ t, int m, const int8_t* __restrict__ q, int n,
    int band, int8_t* __restrict__ out, int* rows, int lane) {
  const int width = 2 * band + 1;
  const int k0 = lane * S;  // this lane's first cell
  int sc[S];  // the score row: prev on entry to a row, cur on exit
  int tb[S];  // the target base of each cell for the current row
  // Row 0: score[0, j] = GAP*j for 0 <= j <= min(m, band); cell k is column
  // j = i + k - band.
  const int j0_hi = min(m, band);
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int k = k0 + s;
    const int j0 = k - band;
    sc[s] = (k < width && j0 >= 0 && j0 <= j0_hi) ? kGap * j0 : kNeg;
    tb[s] = target_base(t, m, 1 + j0);
  }
  // Lane 31's top cell k = 32*S - 1 lies at column i + 32*S - 1 - band.
  // Rows come in blocks of 32: lane r holds the query base of row i0 + r
  // and lane 31's top base for it (qv, tv), loaded a block ahead (qn, tn).
  const int top = 32 * S - 1 - band;
  int qv = (1 + lane <= n) ? q[lane] : kPad;
  int tv = target_base(t, m, 1 + lane + top);
  int qn = (33 + lane <= n) ? q[32 + lane] : kPad;
  int tn = target_base(t, m, 33 + lane + top);
  int qi = __shfl_sync(kFull, qv, 0);
  for (int i = 1; i <= n; ++i) {
    // up of the strip's last cell: lane+1's first cell of the previous row
    // (lane 31's last cell is past the band: 32*S > width).
    const int up_next = __shfl_down_sync(kFull, sc[0], 1);
    // Cell s of the strip lies at column j = jb + s.  It is valid for
    // s_lo <= s <= s_hi (1 <= j <= m and k < width), the j == 0 boundary
    // at s == s_b while i <= band.
    const int jb = i - band + k0;
    const int s_lo = 1 - jb;
    const int s_hi = min(m - jb, width - 1 - k0);
    const int s_b = i <= band ? -jb : -1;
    const int gk0 = kGap * k0;  // GAP*k = gk0 + GAP*s
    // Pass 1: cand of every cell, the strip's max of cand - GAP*k.  Every
    // score is even (MATCH, MISMATCH, GAP and NEG are), so the cell keeps
    // its up-pointer bit in the lowest bit until pass 2.  Cells past the
    // band hold NEG and lie after every cell of the band, so they change
    // no cell's prefix.
    int tot = kNeg;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int diag = sc[s] + (tb[s] == qi ? kMatch : kMismatch);
      // ((s + 1) % S keeps the unrolled index in range where it is unused.)
      const int up = (s + 1 < S ? sc[(s + 1) % S] : up_next) + kGap;
      const bool valid = s >= s_lo && s <= s_hi;
      // The left-column boundary score[i, 0] = GAP*i while i <= band takes
      // part as a left-gap source (poa_batch.py:90-94); it points up.
      const bool bmask = s == s_b;
      const int cand = valid ? max(diag, up) : (bmask ? kGap * i : kNeg);
      sc[s] = cand | ((bmask || up > diag) ? 1 : 0);  // a tie goes to diag
      tot = max(tot, cand - gk0 - kGap * s);
    }
    // The next row's bases: the band moves one column right, so the target
    // bases shift one cell (lane 31's new top from tv), and its query base.
    const int r = i & 31;  // the next row's place in its block
    if (r == 0) {
      qv = qn;
      tv = tn;
      qn = (i + 33 + lane <= n) ? q[i + 32 + lane] : kPad;
      tn = target_base(t, m, i + 33 + lane + top);
    }
    const int next = __shfl_down_sync(kFull, tb[0], 1);
    const int topb = __shfl_sync(kFull, tv, r);
    const int q_next = __shfl_sync(kFull, qv, r);
    // The row before, staged and synced a row ago.
    copy_row<S>(out + static_cast<long long>(i - 2) * width, width,
                rows + ((i - 1) & 1) * kRowWords, lane, i > 1);
    // One warp scan: the max over the strips of the lanes before this one.
    const int incl = warp_inclusive_max(tot, lane);
    const int before = __shfl_up_sync(kFull, incl, 1);
    int run = lane == 0 ? kNeg : before;
    // Pass 2: the left gap, the final score and the pointer code, staged
    // at the row's global alignment.
    int* buf = rows + (i & 1) * kRowWords;
    int8_t* orow = out + static_cast<size_t>(i - 1) * width;
    int8_t* stage = reinterpret_cast<int8_t*>(buf) +
                    (reinterpret_cast<uintptr_t>(orow) & 3) + k0;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int v = sc[s];
      const int cand = v & ~1;
      const int left = run + gk0 + kGap * s;
      const bool use_left = s >= s_lo && s <= s_hi && left > cand;  // strict
      // Cells outside the band keep NEG, so the prefix max never carries a
      // score across the band edge (poa_batch.py:104).
      sc[s] = use_left ? left : cand;
      stage[s] = static_cast<int8_t>(use_left ? 2 : (v & 1));
      run = max(run, cand - gk0 - kGap * s);
    }
#pragma unroll
    for (int s = 0; s + 1 < S; ++s) tb[s] = tb[s + 1];
    tb[S - 1] = lane == 31 ? topb : next;
    qi = q_next;
    // One barrier a row: the next row copies this one out, and stages into
    // the other buffer only after every lane has copied the row before.
    __syncwarp();
  }
  copy_row<S>(out + static_cast<long long>(n - 1) * width, width,
              rows + (n & 1) * kRowWords, lane, n > 0);
}

// The strip kernel: block w of the launch runs pair order[w] with the strip
// width strips[pair].
__global__ void __launch_bounds__(32, kStripBlocksPerSm)
poa_dp_ptr_strip_kernel(const int8_t* __restrict__ tpad, int M,
                        const int* __restrict__ ms,
                        const int8_t* __restrict__ qpad, int N,
                        const int* __restrict__ ns,
                        const int* __restrict__ bands,
                        const long long* __restrict__ offsets,
                        int8_t* __restrict__ ptr,
                        const int* __restrict__ order,
                        const int* __restrict__ strips) {
  __shared__ int rows[2 * kRowWords];
  const int lane = threadIdx.x;
  const int b = order[blockIdx.x];
  const int8_t* t = tpad + static_cast<size_t>(b) * M;
  const int8_t* q = qpad + static_cast<size_t>(b) * N;
  const int m = ms[b], n = ns[b], band = bands[b];
  int8_t* out = ptr + offsets[b];
  int* rw = rows;
  switch (strips[b]) {
#define SVTREK_STRIP(S) \
  case S:               \
    dp_pair_strip<S>(t, m, q, n, band, out, rw, lane); \
    break;
    SVTREK_STRIP(1) SVTREK_STRIP(2) SVTREK_STRIP(3) SVTREK_STRIP(4)
    SVTREK_STRIP(5) SVTREK_STRIP(6) SVTREK_STRIP(8) SVTREK_STRIP(12)
    SVTREK_STRIP(16) SVTREK_STRIP(24) SVTREK_STRIP(33)
#undef SVTREK_STRIP
    default:
      break;  // the wrapper sends only the widths above
  }
}

// The chunked kernel: warp w of the launch runs pair order[w], its two
// score rows in shared memory (row_cap >= the launch's widest band + 1; the
// extra cell holds NEG, the "up" of the band's last cell), the band's cells
// striped over the lanes in chunks of 32.
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
poa_dp_ptr_chunked_kernel(const int8_t* __restrict__ tpad, int M,
                          const int* __restrict__ ms,
                          const int8_t* __restrict__ qpad, int N,
                          const int* __restrict__ ns,
                          const int* __restrict__ bands,
                          const long long* __restrict__ offsets,
                          int8_t* __restrict__ ptr,
                          const int* __restrict__ order, int count,
                          int row_cap) {
  extern __shared__ int smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int w = blockIdx.x * kWarpsPerBlock + warp;
  if (w >= count) return;  // the whole warp leaves together; no block barrier
  const int b = order[w];
  int* prev = smem + warp * 2 * row_cap;
  int* cur = prev + row_cap;
  const int m = ms[b];
  const int n = ns[b];
  const int band = bands[b];
  const int width = 2 * band + 1;
  const int8_t* t = tpad + static_cast<size_t>(b) * M;
  const int8_t* q = qpad + static_cast<size_t>(b) * N;
  int8_t* out = ptr + offsets[b];

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
        const int tb = target_base(t, m, j);
        const int diag = prev[k] + (tb == qi ? kMatch : kMismatch);
        const int up = prev[k + 1] + kGap;
        pc = up > diag ? 1 : 0;  // a tie goes to diag
        valid = j >= 1 && j <= m;
        cand = valid ? max(diag, up) : kNeg;
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

// The band widest the strip kernel takes (kernels.POA_STRIP_MAX_BAND).
int svtrek_poa_strip_max_band() { return kStripMaxBand; }

// tpad [B, M] and qpad [B, N] int8 row-major (pad base 5); ms, ns, bands
// [B] int32 with m <= M, n <= N; offsets [B+1] int64 prefix sums of
// n*(2*band+1); ptr int8 of offsets[B] bytes; order [count] int32 pair
// indices; strips [B] int32, each pair's strip width S (one of 1, 2, 3, 4,
// 5, 6, 8, 12, 16, 24, 33 with 32*S >= 2*band+1) for the pairs of order.
// All device pointers.  Launches the strip kernel over order on `stream`
// and returns cudaGetLastError().
int svtrek_poa_dp_ptr_strip(const void* tpad, int M, const void* ms,
                            const void* qpad, int N, const void* ns,
                            const void* bands, const void* offsets,
                            void* ptr, const void* order, const void* strips,
                            int count, void* stream) {
  if (count <= 0) return 0;
  poa_dp_ptr_strip_kernel<<<count, 32, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(tpad), M, static_cast<const int*>(ms),
      static_cast<const int8_t*>(qpad), N, static_cast<const int*>(ns),
      static_cast<const int*>(bands),
      static_cast<const long long*>(offsets), static_cast<int8_t*>(ptr),
      static_cast<const int*>(order), static_cast<const int*>(strips));
  return static_cast<int>(cudaGetLastError());
}

// As svtrek_poa_dp_ptr_strip, through the chunked kernel, for the pairs of
// order, whose bands are at most max_band (any band up to 2048).
int svtrek_poa_dp_ptr_chunked(const void* tpad, int M, const void* ms,
                              const void* qpad, int N, const void* ns,
                              const void* bands, const void* offsets,
                              void* ptr, const void* order, int count,
                              int max_band, void* stream) {
  if (count <= 0) return 0;
  const int row_cap = 2 * max_band + 2;
  const size_t smem =
      static_cast<size_t>(kWarpsPerBlock) * 2 * row_cap * sizeof(int);
  if (smem > kDefaultSmem) {
    cudaError_t e = cudaFuncSetAttribute(
        poa_dp_ptr_chunked_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int blocks = (count + kWarpsPerBlock - 1) / kWarpsPerBlock;
  poa_dp_ptr_chunked_kernel<<<blocks, 32 * kWarpsPerBlock, smem,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(tpad), M, static_cast<const int*>(ms),
      static_cast<const int8_t*>(qpad), N, static_cast<const int*>(ns),
      static_cast<const int*>(bands),
      static_cast<const long long*>(offsets), static_cast<int8_t*>(ptr),
      static_cast<const int*>(order), count, row_cap);
  return static_cast<int>(cudaGetLastError());
}

// ptr/offsets as written by K2; qpad [B, N] int8; ms, ns, bands [B] int32;
// cols [B, M] int8 filled with -1 and ins [B, M+1] int32 filled with 0 by
// the caller.  Launches on `stream` and returns cudaGetLastError().
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
