// Banded global-alignment DP (K2), its traceback (K3) and the vote (K5) for
// the star consensus of insertion clusters, for Hopper.
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
// K2 design (the wide kernel, bands kStripMaxBand+1 .. POA_MAX_BAND 2048,
// the main path's band cap).  A warp's strip runs out at 32*33 cells, and
// the design it replaced (a chunked kernel: the score rows in shared
// memory, one warp scan a chunk of 32 cells) spent about 400 cycles a
// chunk, 51,600 a row at band 2048, on one warp.  Here a block of
// kWideWarps warps holds the row in registers:
// - Lane l of warp w holds the strip of S cells from k0 = (32*w + l)*S, S
//   chosen per pair from kWideStrips (the smallest with 32*kWideWarps*S >=
//   2*band+1); each warp runs the strip kernel's row (the same code,
//   dp_pair<W, S>), with its own top cell for lane 31's target base.
// - One row: pass 1 over each strip, one scan of the warp's 32 strip
//   maxima, the warps' maxima through shared memory (a barrier), each warp
//   taking the max of those before it as its carry, pass 2.  Lane 0 of
//   each warp leaves its first cell's score in shared memory, where lane
//   31 of the warp before reads it as the up of its last cell in the next
//   row (a second barrier).  The row's codes are staged in shared memory
//   across the block and written as whole words by all its threads.
// - So a row costs two passes over S <= 17 cells, one warp scan and two
//   barriers, not a scan for every 32 cells of the band.  What bounds it
//   is the SM's integer issue rate: about two dozen int32 operations a
//   cell over the whole row, on the one SM that holds the pair.  Eight
//   warps put two on each of the SM's four sub-partitions, which hides
//   each warp's chains of dependent operations; four (one each, S up to
//   33) spilled registers and ran slower on the card, sixteen no faster.
// - The wrapper launches it on a side stream that waits for the current
//   one, beside the strip kernel's launch, and the current stream waits
//   for it: a batch pays the longer of the two launches, not their sum.
//
// K3 design.  The walk from (n, m) to (0, 0) is a chain: each step reads
// the pointer that the step before chose.  The design this one replaced
// walked it with one thread per pair, one dependent global load per step
// (a left move too), 600-800 ns a step on the card: the bytes bound is far
// below, and what bounds K3 is the longest pair's chain of steps.  This design makes the
// links of that chain cheap and takes many of them at once:
// - One warp per pair, the pairs in K2's work list (longest first), so the
//   longest chains start in the first wave.
// - Runs of moves in one ballot.  k = j - i + band is unchanged by a diag
//   move and one higher after an up move, so a diag run visits cell k of
//   rows i, i-1, ... and an up run cell k, k+1, ... of them: lane r reads
//   row i-r at each and two ballots give the lengths of both runs (up to
//   kTbRun rows); the diag run's columns are written by its lanes at once.
//   A row that starts neither is a left run: the nearest cell at or below
//   k whose code is not left, found by one ballot over a window of kTbWin
//   cells, four a lane (the TPU kernel's row sweep computes the same with
//   a cummax); a run that leaves the window slides it down by kTbWin cells
//   (one load), and j reaching 0 ends it with the forced up move.
// - The rows are loaded ahead of the walk.  A per-warp ring in shared
//   memory holds kTbRing = 2 * kTbRun rows: the run being read and the next
//   run's rows in flight, issued with cp.async (16 bytes a copy, a lane a
//   row) as the rows before them are used.  Each row brings a window of
//   kTbWin cells centred on the walk's cell when it was issued, and its
//   query base; a window that the walk has drifted out of is reloaded.
//   Measured on an H100: a row took about 660 cycles when each row was
//   its own ballot step, most of it the issue cost of the step itself, not
//   the loads; runs share that cost among their rows, and a step of the
//   longest walk takes about 100 cycles.  That chain still bounds K3, at
//   about 7 % of its bytes bound on a 2,048-pair batch.
// - The kernel writes every byte of its pair's outputs: first -1 over the
//   cols row and 0 over the ins row, then the walk's columns, and each
//   boundary's inserted count once, when the walk leaves it (the up moves
//   at one boundary are consecutive, as j never rises).
// The clamp of k into [0, 2*band] and the forced moves of row 0 and column
// 0 (poa_pallas.py::_traceback_one) hold exactly: an entry above the band
// reads cell 2*band until a left run brings it in, one below reads cell 0,
// and a run through cell 0 goes on to j = 0.  Any code other than 0 and 1
// moves left, as in the walk.
//
// K5, the vote (no TPU kernel: the JAX package votes on the host, in
// svtrek_tpu/ops/poa.py accumulate_votes and assemble_consensus).  After
// K3, each cluster of a round turns its pairs' cols and insert counts, and
// its members equal to the target, into its new consensus, exactly as
// those functions do:
// - One block per cluster.  Phase 1: a warp per pair scans its row of
//   ins + (cols >= 0) (the query bases consumed before each boundary) and
//   stores the exclusive sum where a boundary has an insert: that insert's
//   first query base (svtrek_tpu/ops/poa_batch.py::_segments_from_counts).
// - Phase 2, a thread per boundary j, the block over the boundaries in
//   tiles of kVoteThreads: the column's six counts (A C G T N gap; the
//   members equal to the target add its base) over the cluster's pairs,
//   the first maximum winning (numpy's argmax); the insert by a
//   Boyer-Moore pass over the pairs with an insert at j (length and bytes
//   compared exactly), then a count of the candidate, kept where it passes
//   n_members / 2: a strict majority is unique, so Counter.most_common's
//   order never matters.  A block scan of each boundary's output (the
//   insert, then the column's base unless the gap won) places its bytes.
// - The host sizes each cluster's output at m + 2 * (its longest query):
//   a kept insert is a piece of the query of more than half the members,
//   and a member's inserts are disjoint pieces of its query, so the kept
//   inserts of a cluster sum to less than twice its longest query.  A
//   cluster that would pass its size writes length -1 instead.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMatch = 2;      // ops/poa.py MATCH / MISMATCH / GAP
constexpr int kMismatch = -4;
constexpr int kGap = -2;
constexpr int kNeg = -(1 << 28);  // band-invalid cells (poa_batch.py:41)
constexpr int kPad = 5;            // the padding base of the JAX program
constexpr unsigned kFull = 0xffffffffu;
// The strip kernel runs one pair per block of one warp, so that a small
// batch spreads over every SM, and at most 128 registers a thread, so that
// 16 pairs share an SM.
constexpr int kStripBlocksPerSm = 16;
// The wide kernel runs one pair per block of kWideWarps warps, two on each
// of the SM's four sub-partitions, at most 128 registers a thread, so that
// 2 pairs share an SM.
constexpr int kWideWarps = 8;
constexpr int kWideBlocksPerSm = 2;
constexpr int kTbWarps = 4;        // pairs per block of K3
constexpr int kTbWin = 128;        // K3's window: 4 cells a lane
constexpr int kTbRing = 64;        // rows in K3's ring (loaded or in flight)
constexpr int kTbRun = 32;         // rows one ballot checks for a run
// A slot's words: the window, the row's query word and padding to 16 bytes.
constexpr int kTbSlot = kTbWin / 4 + 4;
constexpr int kVoteThreads = 256;  // K5: boundaries a tile, a block a cluster
constexpr int kVoteWarps = kVoteThreads / 32;
// K5's int64 fields a cluster (kernels.POA_VOTE_META): its pairs [lo, hi),
// m, n_members, n_equal, its target's offset, its output's offset and size.
constexpr int kVoteMeta = 8;
static_assert((kTbRing & (kTbRing - 1)) == 0 && kTbRing == 2 * kTbRun,
              "a power-of-two ring: one run read, one run in flight");
// The strip widths S of the strip kernel (kernels.POA_STRIPS), and the
// widest band they hold: 32 * 33 cells >= 2 * 527 + 1.  Each list makes
// its kernel's cases and the table svtrek_poa_strips exports.
#define SVTREK_STRIPS(X) \
  X(1) X(2) X(3) X(4) X(5) X(6) X(8) X(12) X(16) X(24) X(33)
// The wide kernel's strip widths (kernels.POA_WIDE_STRIPS) end at 17:
// 32 * 8 * 17 = 4,352 cells >= 2 * 2175 + 1, past POA_MAX_BAND 2048.
#define SVTREK_WIDE_STRIPS(X) X(5) X(6) X(8) X(10) X(12) X(14) X(17)
#define SVTREK_ENTRY(S) S,
constexpr int kStrips[] = {SVTREK_STRIPS(SVTREK_ENTRY)};
constexpr int kWideStrips[] = {SVTREK_WIDE_STRIPS(SVTREK_ENTRY)};
#undef SVTREK_ENTRY
constexpr int kNumStrips = sizeof(kStrips) / sizeof(int);
constexpr int kNumWideStrips = sizeof(kWideStrips) / sizeof(int);
constexpr int kMaxStrip = kStrips[kNumStrips - 1];
constexpr int kStripMaxBand = (32 * kMaxStrip - 1) / 2;
constexpr int kWideMaxStrip = kWideStrips[kNumWideStrips - 1];
constexpr int kWideMaxBand = (32 * kWideWarps * kWideMaxStrip - 1) / 2;
// A row of `Cells` staged codes plus up to 3 bytes of alignment, in whole
// words.
template <int Cells>
constexpr int kRowWords = (Cells + 3 + 3) / 4;

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
// interleave it with other work) by the 32*W threads of the pair (tid):
// its whole aligned words, one a thread, unrolled for rows of up to
// 32*W*S cells; the bytes before and after them (at most 3 each, whose
// words a neighbouring row, maybe another pair's, shares) byte by byte, by
// threads 0-2 and 3-5.
template <int W, int S>
__device__ __forceinline__ void copy_row(int8_t* orow, int width,
                                         const int* buf, int tid, bool on) {
  const int a = static_cast<int>(reinterpret_cast<uintptr_t>(orow) & 3);
  const int e = a + width;
  const int wf = (a + 3) >> 2, wl = e >> 2;
  int* gw = reinterpret_cast<int*>(orow - a);
#pragma unroll
  for (int u = 0; u < (32 * W * S + 6 + 128 * W - 1) / (128 * W); ++u) {
    const int w = wf + tid + 32 * W * u;
    if (on && w < wl) gw[w] = buf[w];
  }
  const int c = tid < 3 ? a + tid : max(4 * wl, 4 * wf) + tid - 3;
  if (on && tid < 6 && c < (tid < 3 ? min(4 * wf, e) : e))
    orow[c - a] = reinterpret_cast<const int8_t*>(buf)[c];
}

// One pair's pointer rows 1..n at out, n rows of 2*band+1 codes, on W
// warps (W == 1: the strip kernel's one warp; else the block of the wide
// kernel, thread 32*warp + lane); the score row in registers, S cells a
// lane, 32*W*S >= 2*band+1.  rows: two staging buffers of
// kRowWords<32*W*S> words.  xch (W > 1): 2*W words of shared memory.  The
// work of the next row that does not wait for this row's scores (its
// bases, the copy-out of the row before) sits between pass 1 and the scan,
// where it fills the scan's shuffle latency.
template <int W, int S>
__device__ __forceinline__ void dp_pair(
    const int8_t* __restrict__ t, int m, const int8_t* __restrict__ q, int n,
    int band, int8_t* __restrict__ out, int* rows, int* xch, int lane) {
  constexpr int kWords = kRowWords<32 * W * S>;
  const int warp = W == 1 ? 0 : static_cast<int>(threadIdx.x >> 5);
  const int tid = 32 * warp + lane;
  // xch[w]: warp w's lane 0's first score, the row before; xch[W + w]: its
  // max of cand - GAP*k, this row.
  const int width = 2 * band + 1;
  const int k0 = tid * S;  // this lane's first cell
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
  if constexpr (W > 1) {
    if (lane == 0) xch[warp] = sc[0];
    __syncthreads();
  }
  // Lane 31's top cell k = 32*(warp+1)*S - 1 lies at column i + that -
  // band.  Rows come in blocks of 32: lane r holds the query base of row
  // i0 + r and lane 31's top base for it (qv, tv), loaded a block ahead
  // (qn, tn).
  const int top = 32 * (warp + 1) * S - 1 - band;
  int qv = (1 + lane <= n) ? q[lane] : kPad;
  int tv = target_base(t, m, 1 + lane + top);
  int qn = (33 + lane <= n) ? q[32 + lane] : kPad;
  int tn = target_base(t, m, 33 + lane + top);
  int qi = __shfl_sync(kFull, qv, 0);
  for (int i = 1; i <= n; ++i) {
    // up of the strip's last cell: lane+1's first cell of the previous row;
    // lane 31's is the next warp's (the last lane's last cell is past the
    // band: 32*W*S > width).
    int up_next = __shfl_down_sync(kFull, sc[0], 1);
    if constexpr (W > 1) {
      if (lane == 31) up_next = warp + 1 < W ? xch[warp + 1] : kNeg;
    }
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
    copy_row<W, S>(out + static_cast<long long>(i - 2) * width, width,
                   rows + ((i - 1) & 1) * kWords, tid, i > 1);
    // One warp scan: the max over the strips of the lanes before this one;
    // on W warps, also over the warps before this one.
    const int incl = warp_inclusive_max(tot, lane);
    const int before = __shfl_up_sync(kFull, incl, 1);
    int run = lane == 0 ? kNeg : before;
    if constexpr (W > 1) {
      if (lane == 31) xch[W + warp] = incl;
      __syncthreads();
#pragma unroll
      for (int v = 0; v + 1 < W; ++v)
        if (v < warp) run = max(run, xch[W + v]);
    }
    // Pass 2: the left gap, the final score and the pointer code, staged
    // at the row's global alignment.
    int* buf = rows + (i & 1) * kWords;
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
    if constexpr (W > 1) {
      if (lane == 0) xch[warp] = sc[0];
    }
#pragma unroll
    for (int s = 0; s + 1 < S; ++s) tb[s] = tb[s + 1];
    tb[S - 1] = lane == 31 ? topb : next;
    qi = q_next;
    // The row's barrier: the next row copies this one out, and stages into
    // the other buffer only after every thread has copied the row before.
    // On W warps it also publishes each warp's first score for the next
    // row's pass 1 (the barrier after the scan keeps xch from being
    // rewritten before every warp has read it).
    if constexpr (W > 1) {
      __syncthreads();
    } else {
      __syncwarp();
    }
  }
  copy_row<W, S>(out + static_cast<long long>(n - 1) * width, width,
                 rows + (n & 1) * kWords, tid, n > 0);
}

// The strip kernel: block w of the launch runs pair order[w] on one warp
// with the strip width strips[pair].
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
  __shared__ int rows[2 * kRowWords<32 * kMaxStrip>];
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
    dp_pair<1, S>(t, m, q, n, band, out, rw, nullptr, lane); \
    break;
    SVTREK_STRIPS(SVTREK_STRIP)
#undef SVTREK_STRIP
    default:
      __trap();  // the wrapper sends only the widths above
  }
}

// The wide kernel: block w of the launch runs pair order[w] on kWideWarps
// warps with the strip width strips[pair].
__global__ void __launch_bounds__(32 * kWideWarps, kWideBlocksPerSm)
poa_dp_ptr_wide_kernel(const int8_t* __restrict__ tpad, int M,
                       const int* __restrict__ ms,
                       const int8_t* __restrict__ qpad, int N,
                       const int* __restrict__ ns,
                       const int* __restrict__ bands,
                       const long long* __restrict__ offsets,
                       int8_t* __restrict__ ptr,
                       const int* __restrict__ order,
                       const int* __restrict__ strips) {
  __shared__ int rows[2 * kRowWords<32 * kWideWarps * kWideMaxStrip>];
  __shared__ int xch[2 * kWideWarps];
  const int lane = threadIdx.x & 31;
  const int b = order[blockIdx.x];
  const int8_t* t = tpad + static_cast<size_t>(b) * M;
  const int8_t* q = qpad + static_cast<size_t>(b) * N;
  const int m = ms[b], n = ns[b], band = bands[b];
  int8_t* out = ptr + offsets[b];
  int* rw = rows;
  switch (strips[b]) {
#define SVTREK_WIDE(S) \
  case S:              \
    dp_pair<kWideWarps, S>(t, m, q, n, band, out, rw, xch, lane); \
    break;
    SVTREK_WIDE_STRIPS(SVTREK_WIDE)
#undef SVTREK_WIDE
    default:
      __trap();  // the wrapper sends only the widths above
  }
}

// cp.async of 4 and 16 bytes from global to shared memory (both aligned
// to the size), and its groups.
__device__ __forceinline__ void copy_async4(void* dst, uintptr_t src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void copy_async16(void* dst, uintptr_t src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void commit_async() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Every group but the newest is in: the rows of the next run.
__device__ __forceinline__ void wait_async_run() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}
__device__ __forceinline__ void wait_async_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// K3's view of the pointer buffer: the first and last of its 16-byte
// chunks.  A 4-byte word or 16-byte chunk that holds a byte of the buffer
// lies in the buffer's pages, so it may be read whole; one outside is never
// read.
struct PtrWords {
  uintptr_t first, last;
  __device__ __forceinline__ bool ok(uintptr_t a) const {
    return a >= first && a <= last + 12;
  }
  __device__ __forceinline__ bool ok16(uintptr_t a) const {
    return a >= first && a <= last;
  }
  __device__ __forceinline__ unsigned load(uintptr_t a) const {
    return ok(a) ? *reinterpret_cast<const unsigned*>(a) : 0u;
  }
};

// The first address of a window of kTbWin cells that ends at cell `top`
// of the row at byte `row`, aligned to `align` bytes (top's aligned unit is
// the window's last).
template <int kAlign>
__device__ __forceinline__ uintptr_t window_at(uintptr_t row, int top) {
  return ((row + top) & ~uintptr_t{kAlign - 1}) - (kTbWin - kAlign);
}

// The move of a row entered at cell kc whose code is left (or unknown):
// the nearest cell at or below kc whose code is not left, found by one
// ballot a window (cells [ka, ka + kTbWin) of the row at byte `row`, this
// lane's word `word`), reloaded if kc is outside it and slid down while
// the run goes on; kb is the cell of column 0, which moves up.  Returns
// kstar * 2 + its code, or -1 for a run through cell 0 (on to column 0,
// which moves up).
__device__ __forceinline__ int scan_left(const PtrWords& pw, uintptr_t row,
                                         int ka, unsigned word, int kc,
                                         int kb, int lane) {
  if (kc < ka || kc >= ka + kTbWin) {  // the walk drifted out: reload
    const uintptr_t a = window_at<4>(row, kc);
    ka = static_cast<int>(static_cast<long long>(a - row));
    word = pw.load(a + 4 * lane);
  }
  while (true) {
    const int k_lane = ka + 4 * lane;
    int mine = -1;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int k = k_lane + e;
      const unsigned c = (word >> (8 * e)) & 0xffu;
      if (k >= 0 && k <= kc && (k == kb || c <= 1u))
        mine = 2 * k + (k == kb ? 1 : static_cast<int>(c));
    }
    const unsigned hit = __ballot_sync(kFull, mine >= 0);
    if (hit) return __shfl_sync(kFull, mine, 31 - __clz(hit));
    if (ka <= 0) return -1;
    ka -= kTbWin;  // slide the window down by its width
    word = pw.load(row + ka + 4 * lane);
  }
}

// One warp per pair: the walk of the K3 design note.  Warp w of the launch
// walks pair order[w]; ptr holds `total` bytes.
__global__ void __launch_bounds__(32 * kTbWarps)
poa_traceback_kernel(const int8_t* __restrict__ ptr, long long total,
                     const long long* __restrict__ offsets,
                     const int8_t* __restrict__ qpad, int N,
                     const int* __restrict__ ms, const int* __restrict__ ns,
                     const int* __restrict__ bands,
                     const int* __restrict__ order, int count, int M,
                     int8_t* __restrict__ cols, int* __restrict__ ins) {
  __shared__ __align__(16) int ring[kTbWarps][kTbRing][kTbSlot];
  __shared__ int ring_k[kTbWarps][kTbRing];  // each slot's first cell
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int w = blockIdx.x * kTbWarps + warp;
  if (w >= count) return;  // the whole warp leaves together
  const int b = order[w];
  const int n = ns[b], m = ms[b], band = bands[b];
  const int top_cell = 2 * band;
  int8_t* crow = cols + static_cast<size_t>(b) * M;
  int* irow = ins + static_cast<size_t>(b) * (M + 1);
  for (int x = lane; x < M; x += 32) crow[x] = -1;
  for (int x = lane; x <= M; x += 32) irow[x] = 0;
  __syncwarp();  // the walk's stores below come after the fills

  const uintptr_t base = reinterpret_cast<uintptr_t>(ptr);
  const PtrWords pw{base & ~uintptr_t{15},
                    (base + total - 1) & ~uintptr_t{15}};
  const uintptr_t pair = base + offsets[b];
  const int width = top_cell + 1;
  const uintptr_t qrow = reinterpret_cast<uintptr_t>(qpad) +
                         static_cast<size_t>(b) * N;
  int(*slots)[kTbSlot] = ring[warp];
  int* slot_k = ring_k[warp];
  auto slot_of = [&](int r) { return (n - r) & (kTbRing - 1); };
  auto row_at = [&](int r) {
    return pair + static_cast<uintptr_t>(r - 1) * width;
  };
  auto clamp_k = [&](int k) { return min(max(k, 0), top_cell); };

  // Issue rows r0, r0-1, ..., r0-count+1 (lane u takes row r0-u): each
  // row's window centred on cell k (kept in the band), 16 bytes a copy,
  // and its query word, into the row's slot; one group.
  auto issue = [&](int r0, int count, int k) {
    const int r = r0 - lane;
    if (lane < count && r >= 1) {
      const int s = slot_of(r);
      const uintptr_t row = row_at(r);
      const uintptr_t a = window_at<16>(row, clamp_k(k + kTbWin / 2 - 1));
#pragma unroll
      for (int c = 0; c < kTbWin / 16; ++c)
        if (pw.ok16(a + 16 * c)) copy_async16(&slots[s][4 * c], a + 16 * c);
      copy_async4(&slots[s][kTbWin / 4], (qrow + r - 1) & ~uintptr_t{3});
      slot_k[s] = static_cast<int>(static_cast<long long>(a - row));
    }
    commit_async();
  };
  // Row r's code at cell k (in the band), 0xff where its window misses k.
  auto code_at = [&](int r, int k) {
    const int s = slot_of(r);
    const int off = k - slot_k[s];
    return off >= 0 && off < kTbWin
               ? static_cast<unsigned>(
                     reinterpret_cast<const uint8_t*>(slots[s])[off])
               : 0xffu;
  };
  // The query base of row r from its slot.
  auto query = [&](int r) {
    const unsigned qw = static_cast<unsigned>(slots[slot_of(r)][kTbWin / 4]);
    return static_cast<int8_t>(qw >> (8 * ((qrow + r - 1) & 3)));
  };

  int i = n, j = m;
  issue(n, kTbRun, m - n + band);
  issue(n - kTbRun, kTbRun, m - n + band);
  int next = n - kTbRing;     // the next row to issue
  int run_j = -1, run_c = 0;  // the boundary of the current up run
  auto add_ups = [&](int at, int count) {
    if (at != run_j) {
      if (lane == 0 && run_c) irow[run_j] = run_c;
      run_j = at;
      run_c = 0;
    }
    run_c += count;
  };
  while (i > 0) {
    if (j == 0) {  // column 0: every row left moves up
      add_ups(0, i);
      break;
    }
    wait_async_run();
    __syncwarp();  // every lane's copies of rows i .. i-kTbRun+1 are in
    // Lane r reads row i-r where a diag run reaches it (the cell k = j - i
    // + band, column j-r) and where an up run does (k + r, column j).
    const int kraw = j - i + band;
    const int ri = i - lane;
    const unsigned cd =
        ri >= 1 && j - lane >= 1 ? code_at(ri, clamp_k(kraw)) : 0xffu;
    const unsigned cu = ri >= 1 ? code_at(ri, clamp_k(kraw + lane)) : 0xffu;
    const unsigned stop_d = __ballot_sync(kFull, cd != 0u);
    const unsigned stop_u = __ballot_sync(kFull, cu != 1u);
    int used;
    if (!(stop_d & 1u)) {  // a diag run: query bases onto columns j-1, ...
      used = stop_d ? __ffs(stop_d) - 1 : kTbRun;
      if (lane < used) crow[j - lane - 1] = query(ri);
      j -= used;
    } else if (!(stop_u & 1u)) {  // an up run at boundary j
      used = stop_u ? __ffs(stop_u) - 1 : kTbRun;
      add_ups(j, used);
    } else {  // a left run (or a window that missed): one row
      const int kc = clamp_k(kraw);
      const int s = slot_of(i);
      const int found = scan_left(pw, row_at(i), slot_k[s],
                                  static_cast<unsigned>(slots[s][lane]), kc,
                                  band - i, lane);
      int jstar = 0, mv = 1;  // the move at column jstar: 0 diag, 1 up
      if (found >= 0) {
        const int kstar = found >> 1;
        mv = found & 1;
        jstar = kstar == kc ? j : kstar + i - band;
      }
      if (mv == 0) {
        if (lane == 0) crow[jstar - 1] = query(i);
        j = jstar - 1;
      } else {
        add_ups(jstar, 1);
        j = jstar;
      }
      used = 1;
    }
    i -= used;
    __syncwarp();  // every read of the used rows' slots is done
    issue(next, used, j - i + band);
    next -= used;
  }
  if (lane == 0 && run_c) irow[run_j] = run_c;
  wait_async_all();  // no copy into the ring outlives the warp
}

// The len query bases at a and b are the same.
__device__ __forceinline__ bool same_bases(const int8_t* a, const int8_t* b,
                                           int len) {
  for (int x = 0; x < len; ++x)
    if (a[x] != b[x]) return false;
  return true;
}

__device__ __forceinline__ int warp_inclusive_sum(int v, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int o = __shfl_up_sync(kFull, v, d);
    if (lane >= d) v += o;
  }
  return v;
}

// One block per cluster: the vote of the K5 design note.  cols [B, M] and
// ins [B, M+1] of K3 (or the host DP's rows), qpad [B, N]; meta [C,
// kVoteMeta]; starts [B, M+1] scratch.  out: C int32 lengths (-1 past the
// cluster's size), then each cluster's ASCII bases at its offset.
__global__ void __launch_bounds__(kVoteThreads)
poa_vote_kernel(const int8_t* __restrict__ cols, const int* __restrict__ ins,
                const int8_t* __restrict__ qpad, int M, int N,
                const long long* __restrict__ meta,
                const int8_t* __restrict__ targets, int* __restrict__ starts,
                int C, uint8_t* __restrict__ out) {
  __shared__ int warp_sum[kVoteWarps];
  const long long* mt = meta + static_cast<size_t>(blockIdx.x) * kVoteMeta;
  const int lo = static_cast<int>(mt[0]), hi = static_cast<int>(mt[1]);
  const int m = static_cast<int>(mt[2]);
  const int half = static_cast<int>(mt[3]) / 2;
  const int n_equal = static_cast<int>(mt[4]);
  const int8_t* tgt = targets + mt[5];
  uint8_t* dst = out + 4LL * C + mt[6];
  const long long cap = mt[7];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t Mi = static_cast<size_t>(M) + 1;

  // Phase 1: each pair's first query base of the insert at each boundary.
  for (int p = lo + warp; p < hi; p += kVoteWarps) {
    const int8_t* crow = cols + static_cast<size_t>(p) * M;
    const int* irow = ins + static_cast<size_t>(p) * Mi;
    int* srow = starts + static_cast<size_t>(p) * Mi;
    int carry = 0;
#pragma unroll 4
    for (int j0 = 0; j0 <= m; j0 += 32) {
      const int j = j0 + lane;
      int k = 0, used = 0;
      if (j <= m) {
        k = irow[j];
        used = k + (j < m && crow[j] >= 0);
      }
      const int incl = warp_inclusive_sum(used, lane);
      if (k > 0) srow[j] = carry + incl - used;
      carry += __shfl_sync(kFull, incl, 31);
    }
  }
  __syncthreads();

  // Phase 2: a thread per boundary of each tile.
  long long base = 0;  // the bytes of the tiles before, the same everywhere
  bool over = false;
  for (int j0 = 0; j0 <= m; j0 += kVoteThreads) {
    const int j = j0 + threadIdx.x;
    const bool col = j < m;
    int win = 5, cand_p = 0, cand_s = 0, cand_len = 0;
    if (j <= m) {
      int n0 = 0, n1 = 0, n2 = 0, n3 = 0, n4 = 0, n5 = 0;
      if (col) {
        const int t = tgt[j];
        n0 = t == 0 ? n_equal : 0;
        n1 = t == 1 ? n_equal : 0;
        n2 = t == 2 ? n_equal : 0;
        n3 = t == 3 ? n_equal : 0;
        n4 = t == 4 ? n_equal : 0;
      }
      int run = 0;  // Boyer-Moore's count of the candidate
#pragma unroll 4
      for (int p = lo; p < hi; ++p) {
        if (col) {
          const int x = cols[static_cast<size_t>(p) * M + j];
          n0 += x == 0;
          n1 += x == 1;
          n2 += x == 2;
          n3 += x == 3;
          n4 += x == 4;
          n5 += x < 0;
        }
        const int len = ins[static_cast<size_t>(p) * Mi + j];
        if (len > 0) {
          const int s = starts[static_cast<size_t>(p) * Mi + j];
          if (run == 0) {
            cand_p = p;
            cand_s = s;
            cand_len = len;
            run = 1;
          } else if (len == cand_len &&
                     same_bases(qpad + static_cast<size_t>(p) * N + s,
                                qpad + static_cast<size_t>(cand_p) * N +
                                    cand_s,
                                len)) {
            ++run;
          } else {
            --run;
          }
        }
      }
      if (col) {  // the first maximum in the order A C G T N gap
        int best = n0;
        win = 0;
        if (n1 > best) best = n1, win = 1;
        if (n2 > best) best = n2, win = 2;
        if (n3 > best) best = n3, win = 3;
        if (n4 > best) best = n4, win = 4;
        if (n5 > best) win = 5;
      }
      if (run > 0) {  // the candidate's support, kept past half
        const int8_t* cq = qpad + static_cast<size_t>(cand_p) * N + cand_s;
        int support = 0;
        for (int p = lo; p < hi; ++p) {
          const int len = ins[static_cast<size_t>(p) * Mi + j];
          if (len == cand_len)
            support += same_bases(
                qpad + static_cast<size_t>(p) * N +
                    starts[static_cast<size_t>(p) * Mi + j],
                cq, len);
        }
        if (support <= half) cand_len = 0;
      } else {
        cand_len = 0;
      }
    }
    const int own = cand_len + (col && win != 5);
    const int incl = warp_inclusive_sum(own, lane);
    if (lane == 31) warp_sum[warp] = incl;
    __syncthreads();
    int before = 0, total = 0;
#pragma unroll
    for (int w = 0; w < kVoteWarps; ++w) {
      before += w < warp ? warp_sum[w] : 0;
      total += warp_sum[w];
    }
    __syncthreads();  // warp_sum is the next tile's
    over = over || base + total > cap;
    if (!over && own) {
      uint8_t* o = dst + base + before + incl - own;
      const int8_t* q = qpad + static_cast<size_t>(cand_p) * N + cand_s;
      for (int x = 0; x < cand_len; ++x) o[x] = "ACGTN-"[q[x]];
      if (col && win != 5) o[cand_len] = "ACGTN-"[win];
    }
    base += total;
  }
  if (threadIdx.x == 0)
    reinterpret_cast<int*>(out)[blockIdx.x] =
        over ? -1 : static_cast<int>(base);
}

}  // namespace

extern "C" {

// The band widest the strip kernel takes (kernels.POA_STRIP_MAX_BAND) and
// the wide kernel's (from kernels.POA_WIDE_WARPS and POA_WIDE_STRIPS).
int svtrek_poa_strip_max_band() { return kStripMaxBand; }
int svtrek_poa_wide_max_band() { return kWideMaxBand; }

// The strip widths the kernels are built for: the strip kernel's
// (kernels.POA_STRIPS) if wide is 0, else the wide kernel's
// (POA_WIDE_STRIPS).  Writes up to cap of them to out and returns their
// count.
int svtrek_poa_strips(int wide, int* out, int cap) {
  const int* table = wide ? kWideStrips : kStrips;
  const int count = wide ? kNumWideStrips : kNumStrips;
  for (int i = 0; i < count && i < cap; ++i) out[i] = table[i];
  return count;
}

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

// As svtrek_poa_dp_ptr_strip, through the wide kernel, for the pairs of
// order, each with its strip width S (one of 5, 6, 8, 10, 12, 14, 17 with
// 32*8*S >= 2*band+1).
int svtrek_poa_dp_ptr_wide(const void* tpad, int M, const void* ms,
                           const void* qpad, int N, const void* ns,
                           const void* bands, const void* offsets,
                           void* ptr, const void* order, const void* strips,
                           int count, void* stream) {
  if (count <= 0) return 0;
  poa_dp_ptr_wide_kernel<<<count, 32 * kWideWarps, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(tpad), M, static_cast<const int*>(ms),
      static_cast<const int8_t*>(qpad), N, static_cast<const int*>(ns),
      static_cast<const int*>(bands),
      static_cast<const long long*>(offsets), static_cast<int8_t*>(ptr),
      static_cast<const int*>(order), static_cast<const int*>(strips));
  return static_cast<int>(cudaGetLastError());
}

// ptr (total bytes) and offsets [B+1] as written by K2; qpad [B, N] int8;
// ms, ns, bands [B] int32; order [count] int32 pair indices (each pair
// once); cols [B, M] int8 and ins [B, M+1] int32, every byte of the rows
// of the pairs of order written by the kernel.  Launches on `stream` and
// returns cudaGetLastError().
int svtrek_poa_traceback(const void* ptr, long long total,
                         const void* offsets, const void* qpad, int N,
                         const void* ms, const void* ns, const void* bands,
                         const void* order, int count, int M, void* cols,
                         void* ins, void* stream) {
  if (count <= 0) return 0;
  const int blocks = (count + kTbWarps - 1) / kTbWarps;
  poa_traceback_kernel<<<blocks, 32 * kTbWarps, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(ptr), total,
      static_cast<const long long*>(offsets),
      static_cast<const int8_t*>(qpad), N, static_cast<const int*>(ms),
      static_cast<const int*>(ns), static_cast<const int*>(bands),
      static_cast<const int*>(order), count, M, static_cast<int8_t*>(cols),
      static_cast<int*>(ins));
  return static_cast<int>(cudaGetLastError());
}

// K5's fields a cluster (kernels.POA_VOTE_META).
int svtrek_poa_vote_meta() { return kVoteMeta; }

// cols [B, M] int8, ins [B, M+1] int32, qpad [B, N] int8 row-major; meta
// [C, kVoteMeta] int64 (each cluster's pairs lo..hi-1 of those rows, m,
// n_members, n_equal, the offset of its m target bases in targets, the
// offset and size of its output); starts [B, M+1] int32 scratch; out
// uint8, C int32 lengths then the clusters' bases.  All device pointers.
// Launches on `stream` and returns cudaGetLastError().
int svtrek_poa_vote(const void* cols, const void* ins, const void* qpad,
                    int M, int N, const void* meta, const void* targets,
                    void* starts, int C, void* out, void* stream) {
  if (C <= 0) return 0;
  poa_vote_kernel<<<C, kVoteThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(cols), static_cast<const int*>(ins),
      static_cast<const int8_t*>(qpad), M, N,
      static_cast<const long long*>(meta),
      static_cast<const int8_t*>(targets), static_cast<int*>(starts), C,
      static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
