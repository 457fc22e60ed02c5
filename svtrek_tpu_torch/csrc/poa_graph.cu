// Graph POA DP and traceback (G1) for Hopper: one query aligned to one
// partial-order graph, a batch of (graph, query) pairs per launch.
//
// G1 replaces the XLA scan `_graph_dp_batch`
// (svtrek_tpu/ops/poa_graph_batch.py:127), a jax.jit of two lax.scans under
// vmap: one step per topo-ordered graph node, then the traceback.  There is
// no Pallas kernel behind it; on the card an eager loop would launch about
// 15 small ops a node, so the node loop lives in this kernel.  It computes
// `_graph_dp_one` exactly (ops/poa_graph_dp.py::graph_dp_reference is the
// plain version it is held to):
// - rows are the graph's topo order, row 0 the virtual start with
//   H[0][j] = GAP*j; row i's predecessors are any earlier rows;
// - per cell the candidate stack [del_p0, diag_p0, del_p1, diag_p1, ...]
//   over all P slots, a slot at or past the node's predecessor count being
//   NEG, diag at column 0 being NEG + NEG, sub comparing q[j-1] with the
//   node's base; the first maximum wins (updates on strict > only), so a
//   padding slot wins only in a row with no predecessor (its slot 0 del);
// - then the in-row insertions: left[j] = GAP*j + max_{j'<j}(best[j'] -
//   GAP*j'), NEG at j = 0, taken only where strictly greater than best;
// - the end row is the first (lowest rank) best-scoring sink, row 1 when
//   there is none, as jnp.argmax gives;
// - the walk from (end row, n) to (0, 0): row 0 moves left; a diag move
//   marks its node matched and goes to the chosen predecessor row and
//   column j-1, a del move to the predecessor row, an ins move counts an
//   inserted base after row i; at most V + n + 1 moves.  JAX's
//   fixed-length scan without its idle steps.
//
// Design (this card).  One warp per pair, a block of one warp, so that no
// row needs a block barrier and many pairs share an SM (a 256-pair batch
// is one wave on 132 SMs).
// - Column tiles.  A row is processed in tiles of kTile = 32 x kStrip
//   columns; lane l owns the kStrip = 32 consecutive columns t0 + 32 l ..
//   of tile t0 (one tile a row up to n = 1,023, 17 at n = 16,384), its
//   keys and substitution terms in registers.  The in-row insertion is a
//   5-step shuffle scan of the lanes' strip maxima per tile, carried from
//   tile to tile.  n is bounded by the shared ring and the scratch, not by
//   registers: kNCap 16,384 query bases, kVCap 65,536 graph nodes (G1's
//   own caps; ops/poa_graph_batch.py routes at them), P <= 32.
// - The stack as one max.  Each candidate is a key value * 64 + (63 -
//   rank), rank 2p for del_p and 2p + 1 for diag_p, so the first-wins
//   argmax is a max over keys; diag_p's key is del_p's key of the column
//   before plus a column term.  The range: a path of at most V + n moves
//   scores at least -4 (V + n) and at most 2 min(V, n), so |value| < 2^19
//   at the caps (327,680), and a key, value * 64 + 63, stays below 2^25;
//   the scan's identity kScanId = 2 NEG = -2^29, column 0's diag INT_MIN /
//   2 and GAP * j (j <= 16,416) stay clear of every key and score.  A row
//   with no predecessor would hold NEG, past a key's range for the rows
//   that read it, so the wrapper refuses a live row whose predecessor
//   count is below 1 (PoaGraph never makes one).  A slot costs a lane one
//   multiply-add, one add and two max a column; the slot and the move are
//   decoded once a row.  The int32 ALU pipe (16 lanes an SM sub-partition)
//   is what a lone warp's row waits on.
// - The recent rows in shared memory.  A ring of R rows of H per pair
//   (dynamic shared memory, R x Wg x 4 bytes, Wg = n+1 rounded up to
//   kRowAlign = 32).  R is the largest of 8, 4 and 2 whose launch fits a
//   block's 232,448 bytes at the launch's largest n (`ring_rows`;
//   kernels.graph_ring_rows): 8 up to n 6,751, 4 up to 13,119, 2 up to
//   16,384.  Row i goes to slot i & (R - 1); a predecessor within R - 1
//   rows is read from the ring, an older one from global H; only the rows
//   read so are stored to global H whole (a first pass over pred_rows sets
//   their bits in a shared bit set, V/8 bytes), the others only at column
//   n, for the end row.  In the ring a lane's strip is 16-byte chunks,
//   chunk k of strip s stored at chunk k ^ (s & 7), so a warp's 16-byte
//   loads and stores meet no bank conflict.  The query, shifted by one
//   column, is staged in shared memory too.
// - Coalesced stores.  After a tile, the warp writes the codes from a
//   shared stage (and H, where flagged, from the ring) to global memory,
//   lane l on 16-byte chunk l + 32 m, so each store instruction writes 512
//   contiguous bytes (st.global.cg: the rows are read back from L2 only).
// - Code format: one byte a cell, slot * 4 + move (move 0 diag, 1 del, 2
//   ins; an ins stores 2; slot < P <= 32 fits), the plain version's codes
//   byte for byte.  The code does not bound V.
// - The walk in runs.  From the current cell the next cell is known from its
//   code and, for a diag or del move, the predecessor row its slot names in
//   pred_rows; lane k loads the code of the k-th cell beyond it in the same
//   direction (diag: (i-k, j-k); del: (i-k, j); ins: (i, j-k)) and then the
//   predecessor row of that code; a ballot of the lanes whose cell leads to
//   the next lane's guess gives the run that is on the path, and the warp
//   applies it at once (diag: matched[] per lane; ins: one add).  A round
//   costs two dependent loads (the code, then pred_rows, whose walked rows
//   sit in L2) however long the run, and the lanes prefetch the next
//   round's cells into L2.  Row 0 is a virtual row of ins moves.  The V + n
//   + 1 move bound stays, and the wrapper refuses a predecessor row not
//   earlier than its node, so a bad graph cannot hang the card.
//
// Scratch: each pair's (V+1) x Wg cells at a prefix-sum offset
// (`kernels.poa_graph_chunks`), H int32 and a one-byte code a cell: 5 bytes
// a cell, 5.4 GB a pair at the caps.  The wrapper splits a batch whose
// scratch would pass kernels.GRAPH_SCRATCH_BYTES (2 GiB) into several
// launches; a pair alone past it takes a launch of its own.
//
// What bounds it.  Not bytes (5 bytes a cell written, a few read) nor the
// card's int32 throughput (about 10 operations a filled slot a cell): a
// pair's V rows are a dependent chain on one warp, each row a few hundred
// ALU instructions a lane a tile, and the walk a chain of one load a run.
// A batch takes as long as its largest pair.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kMatch = 2;      // ops/poa.py MATCH / MISMATCH / GAP
constexpr int kMismatch = -4;
constexpr int kGap = -2;
constexpr int kNeg = -(1 << 28);  // ops/poa_graph.py NEG
// The scan's identity: below every real score (a path of V + n moves scores
// above -4 (V + n) > 2 NEG), so an empty prefix never wins, and far enough
// from INT_MIN that GAP * j can be added to it.
constexpr int kScanId = 2 * kNeg;
// The largest graph (nodes), query and predecessor count G1 takes;
// kernels.py holds the same numbers and checks them at load.
constexpr int kVCap = 65536;
constexpr int kNCap = 16384;
constexpr int kPCap = 32;
constexpr int kStrip = 32;            // columns a lane, per tile
constexpr int kTile = 32 * kStrip;    // columns a tile
constexpr int kChunks = kStrip / 4;   // 16-byte chunks of a lane's H strip
constexpr int kCodeChunks = kStrip / 16;  // ... and of its codes
constexpr int kRowAlign = 32;         // a row's cells: n+1 rounded up to it
constexpr int kCellBytes = sizeof(int) + sizeof(uint8_t);  // H and a code
constexpr int kSmemBytes = 232448;    // a block's shared memory on Hopper
constexpr int kStageBytes = 32 * kCodeChunks * 16;  // a tile's codes
constexpr unsigned kFull = 0xffffffffu;
static_assert(kRowAlign % kStrip == 0 || kStrip % kRowAlign == 0, "");
static_assert(kChunks <= 8 && kCodeChunks >= 1, "");
static_assert((kPCap - 1) * 4 + 2 < 256, "a code is one byte");

__host__ __device__ constexpr int row_words(int n) {
  return (n + kRowAlign) / kRowAlign * kRowAlign;
}

// The 32-bit words of the global-H flags of a V-node graph: a bit for
// each row 0 .. V.
__host__ __device__ constexpr int need_words(int V) { return V / 32 + 1; }

// A launch's dynamic shared memory with a ring of r rows, its largest query
// max_n and its graphs' flags for V nodes: the ring, the code stage, the
// shifted query, the flags.
constexpr long long smem_bytes(int r, int max_n, int V) {
  return static_cast<long long>(r) * row_words(max_n) * 4 + kStageBytes +
         row_words(max_n) + need_words(V) * 4;
}

// The ring's rows for a launch whose largest query is max_n bases: the
// largest of 8, 4 and 2 whose launch fits a block's shared memory with the
// flags of a kVCap-node graph; 0 for max_n outside [1, kNCap].
int ring_rows(int max_n) {
  if (max_n < 1 || max_n > kNCap) return 0;
  for (int r = 8; r >= 2; r /= 2) {
    if (smem_bytes(r, max_n, kVCap) <= kSmemBytes) return r;
  }
  return 0;
}
static_assert(smem_bytes(2, kNCap, kVCap) <= kSmemBytes, "");

// The chunk swizzle: a lane's chunk k is stored at chunk k ^ f, f from its
// strip (column block) index, so that the 8 lanes of a 16-byte shared
// access phase hit 8 distinct groups of 4 banks.
template <int C>
__device__ __forceinline__ int chunk_swz(int blk) {
  return (blk / (8 / C)) & (C - 1);
}

// Word index of column c in a ring row.
__device__ __forceinline__ int swz(int c) {
  const int blk = c / kStrip;
  const int k = (c % kStrip) >> 2;
  return blk * kStrip + ((k ^ chunk_swz<kChunks>(blk)) << 2) + (c & 3);
}

__device__ __forceinline__ void ld_chunk(const int4& x, int* v) {
  v[0] = x.x;
  v[1] = x.y;
  v[2] = x.z;
  v[3] = x.w;
}

// A lane's strip from global H (row base, strip's first column j0).
__device__ __forceinline__ void load_strip(const int* row, int j0,
                                           int (&v)[kStrip]) {
  const int4* p4 = reinterpret_cast<const int4*>(row + j0);
#pragma unroll
  for (int k = 0; k < kChunks; ++k) ld_chunk(__ldcg(p4 + k), v + 4 * k);
}

// A lane's strip from a ring row.
__device__ __forceinline__ void load_strip_ring(const int* row, int j0,
                                                int (&v)[kStrip]) {
  const int s = chunk_swz<kChunks>(j0 / kStrip);
  const int4* p4 = reinterpret_cast<const int4*>(row + j0);
#pragma unroll
  for (int k = 0; k < kChunks; ++k) ld_chunk(p4[k ^ s], v + 4 * k);
}

// The cell a code leads to from (i, j), i >= 1 (prs: the pair's
// pred_rows): an ins move stays in row i, a diag or del move goes to the
// predecessor row its slot names.
__device__ __forceinline__ void next_cell(const int* prs, int P, int i, int j,
                                          int c, int& ni, int& nj) {
  const int m = c & 3;
  ni = m == 2 ? i : prs[static_cast<long long>(i - 1) * P + (c >> 2)];
  nj = m == 1 ? j : j - 1;
}

__global__ void __launch_bounds__(32) poa_graph_dp_warp_kernel(
    const int8_t* __restrict__ base_td, const int* __restrict__ pred_rows,
    const int* __restrict__ npred, const uint8_t* __restrict__ is_sink,
    const int* __restrict__ Vs, const int8_t* __restrict__ qpad,
    const int* __restrict__ ns, const long long* __restrict__ offsets, int b0,
    int P, int Vmax, int Nmax, int ring_words, int R, int* H_all,
    uint8_t* code_all, int* __restrict__ score, int8_t* __restrict__ matched,
    int* __restrict__ ins_after) {
  // Shared memory: the ring (R rows of ring_words), the tile's codes on
  // their way out, the shifted query, the rows' global-H flags (bits).
  extern __shared__ int4 smem4[];
  int* ring = reinterpret_cast<int*>(smem4);
  uint4* cstage = reinterpret_cast<uint4*>(ring + R * ring_words);
  uint8_t* qsh = reinterpret_cast<uint8_t*>(cstage + 32 * kCodeChunks);
  unsigned* need = reinterpret_cast<unsigned*>(qsh + ring_words);
  const int b = b0 + blockIdx.x;
  const int lane = threadIdx.x;
  const int V = Vs[b];
  const int n = ns[b];
  const int W = n + 1;
  const int Wg = row_words(n);
  // The wrapper refuses these pairs; a warp that gets one writes nothing.
  if (V < 1 || V > kVCap || V > Vmax || n < 1 || n > kNCap || n > Nmax ||
      Wg > ring_words) {
    return;
  }
  int* H = H_all + offsets[blockIdx.x];
  uint8_t* code = code_all + offsets[blockIdx.x];
  const int8_t* base = base_td + static_cast<long long>(b) * Vmax;
  const int* prs_b = pred_rows + static_cast<long long>(b) * Vmax * P;
  const int* np_b = npred + static_cast<long long>(b) * Vmax;
  const int8_t* q = qpad + static_cast<long long>(b) * Nmax;

  // The query shifted by one column (qsh[j] = q[j-1]; column 0 and the
  // columns past n never match a base), and row 0.
  for (int j = lane; j < Wg; j += 32) {
    qsh[j] = (j >= 1 && j <= n) ? static_cast<uint8_t>(q[j - 1]) : 0xfe;
    H[j] = kGap * j;
    ring[swz(j)] = kGap * j;
  }
  // The rows that a later row reads from global H (R - 1 rows back or
  // more): only they are stored whole; of the others only column n.
  for (int w = lane; w < need_words(V); w += 32) need[w] = 0;
  __syncwarp();
  for (int r = lane; r < V; r += 32) {
    const int np = min(np_b[r], P);
    for (int p = 0; p < np; ++p) {
      const int pr = prs_b[static_cast<long long>(r) * P + p];
      if (r + 1 - pr >= R) atomicOr(need + (pr >> 5), 1u << (pr & 31));
    }
  }
  __syncwarp();

  // Row i's predecessor slots, one a lane, loaded a row ahead.
  int nxt_pr = lane < P ? prs_b[lane] : 0;
  int nxt_np = np_b[0];
  int nxt_bi = base[0];
  for (int i = 1; i <= V; ++i) {
    const int my_pr = nxt_pr;
    const int np = min(nxt_np, P);
    const unsigned bq = static_cast<uint8_t>(nxt_bi) * 0x01010101u;
    if (i < V) {
      nxt_pr = lane < P ? prs_b[static_cast<long long>(i) * P + lane] : 0;
      nxt_np = np_b[i];
      nxt_bi = base[i];
    }
    const bool whole = (need[i >> 5] >> (i & 31)) & 1u;
    int* ring_i = ring + (i & (R - 1)) * Wg;
    int* hrow = H + static_cast<long long>(i) * Wg;
    uint8_t* crow = code + static_cast<long long>(i - 1) * Wg;
    int carry = kScanId;
    for (int t0 = 0; t0 < W; t0 += kTile) {
      const int j0 = t0 + lane * kStrip;
      const bool active = j0 < W;
      // Lanes past the row read the tile's first strip instead (their
      // results are never stored).
      const int jl = active ? j0 : t0;
      // The stack's first maximum as one max over keys value * 64 + (63 -
      // rank), rank 2p for del_p and 2p + 1 for diag_p (|value| < 2^19, so
      // a key stays below 2^25): the larger value wins, and on a tie the
      // lower rank.
      // diag_p's key is del_p's key of the column before plus subk, the
      // column's substitution term (sub * 64 - 1 - GAP * 64).
      int subk[kStrip];
      {
        const uint4* q4 = reinterpret_cast<const uint4*>(qsh + jl);
#pragma unroll
        for (int k = 0; k < kStrip / 16; ++k) {
          const uint4 x = q4[k];
          const unsigned mm[4] = {__vcmpeq4(x.x, bq), __vcmpeq4(x.y, bq),
                                  __vcmpeq4(x.z, bq), __vcmpeq4(x.w, bq)};
#pragma unroll
          for (int e = 0; e < 16; ++e) {
            subk[16 * k + e] = ((mm[e >> 2] >> (8 * (e & 3))) & 1)
                                   ? kMatch * 64 - 1 - kGap * 64
                                   : kMismatch * 64 - 1 - kGap * 64;
          }
        }
      }
      int key[kStrip];  // set by slot 0 (the wrapper refuses np == 0)
      for (int p = 0; p < np; ++p) {
        const int pr = __shfl_sync(kFull, my_pr, p);
        const int kc = kGap * 64 + 63 - 2 * p;
        int kd[kStrip];
        int fix = 0;  // column j0 - 1 of the predecessor row, for lane 0
        if (i - pr < R) {
          const int* src = ring + (pr & (R - 1)) * Wg;
          load_strip_ring(src, jl, kd);
          if (lane == 0 && j0 > 0) fix = src[swz(j0 - 1)];
        } else {
          const int* src = H + static_cast<long long>(pr) * Wg;
          load_strip(src, jl, kd);
          if (lane == 0 && j0 > 0) fix = __ldcg(src + j0 - 1);
        }
#pragma unroll
        for (int c = 0; c < kStrip; ++c) kd[c] = kd[c] * 64 + kc;
        int prev = __shfl_up_sync(kFull, kd[kStrip - 1], 1);
        // Column 0's diag (NEG + NEG) never wins.
        if (lane == 0) prev = j0 > 0 ? fix * 64 + kc : INT_MIN / 2;
        if (p == 0) {
#pragma unroll
          for (int c = 0; c < kStrip; ++c) {
            key[c] = max(kd[c], (c == 0 ? prev : kd[c - 1]) + subk[c]);
          }
        } else {
#pragma unroll
          for (int c = 0; c < kStrip; ++c) {
            const int kg = (c == 0 ? prev : kd[c - 1]) + subk[c];
            key[c] = max(key[c], max(kd[c], kg));
          }
        }
      }
      // Each column's best score and code, slot * 4 + move from the rank.
      int best[kStrip];
      int cd[kStrip];
#pragma unroll
      for (int c = 0; c < kStrip; ++c) {
        const int rank = ~key[c] & 63;
        best[c] = key[c] >> 6;
        cd[c] = ((rank >> 1) << 2) | (1 - (rank & 1));
      }
      // The lane's strip maximum of best[j] - GAP*j, the warp's scan.  The
      // columns past n come after every valid one, so they reach no valid
      // column's prefix; their scores stay bounded (each at most 2 above a
      // predecessor's), so no key overflows.
      int gmax = kScanId;
#pragma unroll
      for (int c = 0; c < kStrip; ++c) {
        gmax = max(gmax, best[c] - kGap * (j0 + c));
      }
      int incl = gmax;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int o = __shfl_up_sync(kFull, incl, d);
        if (lane >= d) incl = max(incl, o);
      }
      int run = __shfl_up_sync(kFull, incl, 1);
      if (lane == 0) run = kScanId;
      run = max(run, carry);
      carry = max(carry, __shfl_sync(kFull, incl, 31));
      // The insertions; H into the ring, the codes into the stage, both
      // swizzled by 16-byte chunk.
      {
        const int sh = chunk_swz<kChunks>(j0 / kStrip);
        const int sc = chunk_swz<kCodeChunks>(lane);
        int4* r4 = reinterpret_cast<int4*>(ring_i + jl);
        unsigned cw[4];
#pragma unroll
        for (int k = 0; k < kChunks; ++k) {
          int hv[4];
          unsigned cv = 0;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = 4 * k + e;
            const int j = j0 + c;
            const int bc = best[c];
            // For j >= 1 run holds column 0's value at least.
            const int left = (j == 0 ? kNeg : run) + kGap * j;
            const bool use_ins = left > bc;
            hv[e] = use_ins ? left : bc;
            cv |= (use_ins ? 2u : static_cast<unsigned>(cd[c])) << (8 * e);
            run = max(run, bc - kGap * j);
          }
          if (active) r4[k ^ sh] = make_int4(hv[0], hv[1], hv[2], hv[3]);
          // Codes 16k' .. 16k'+15 (H chunks 4k' .. 4k'+3) form the lane's
          // code chunk k'.
          cw[k & 3] = cv;
          if ((k & 3) == 3) {
            cstage[lane * kCodeChunks + ((k >> 2) ^ sc)] =
                make_uint4(cw[0], cw[1], cw[2], cw[3]);
          }
        }
      }
      __syncwarp();
      // The tile out to global memory, 16 bytes a lane, lanes on
      // consecutive chunks: H from the ring, the codes from the stage.
      if (whole) {
#pragma unroll
        for (int m = 0; m < kChunks; ++m) {
          const int qd = lane + 32 * m;     // the tile's chunk
          const int blk = qd / kChunks;     // its lane strip
          if (t0 + 4 * qd < Wg) {
            const int4 x = reinterpret_cast<const int4*>(ring_i + t0)
                [blk * kChunks + ((qd % kChunks) ^
                                  chunk_swz<kChunks>(t0 / kStrip + blk))];
            __stcg(reinterpret_cast<int4*>(hrow + t0) + qd, x);
          }
        }
      } else if (lane == 0 && n >= t0 && n < t0 + kTile) {
        __stcg(hrow + n, ring_i[swz(n)]);
      }
#pragma unroll
      for (int m = 0; m < kCodeChunks; ++m) {
        const int qd = lane + 32 * m;
        const int sl = qd / kCodeChunks;
        if (t0 + 16 * qd < Wg) {
          __stcg(reinterpret_cast<uint4*>(crow + t0) + qd,
                 cstage[sl * kCodeChunks +
                        ((qd % kCodeChunks) ^ chunk_swz<kCodeChunks>(sl))]);
        }
      }
      // The stage is reused by the next tile; the next row reads this one
      // from the ring and from global memory, from other lanes.
      __syncwarp();
    }
  }

  // The end row: the first maximum of H[r+1][n] over the sinks r < V (NEG
  // elsewhere; rows past V are NEG too, so the first maximum is among r < V).
  int bv = INT_MIN;
  int br = INT_MAX;
  for (int r = lane; r < V; r += 32) {
    const int v = is_sink[static_cast<long long>(b) * Vmax + r]
                      ? __ldcg(H + static_cast<long long>(r + 1) * Wg + n)
                      : kNeg;
    if (v > bv) {
      bv = v;
      br = r;
    }
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    const int ov = __shfl_xor_sync(kFull, bv, d);
    const int orow = __shfl_xor_sync(kFull, br, d);
    if (ov > bv || (ov == bv && orow < br)) {
      bv = ov;
      br = orow;
    }
  }
  if (lane == 0) score[b] = bv;

  // The walk in runs.  (i, j, c): the current cell and its code, its move
  // not yet applied; (i0, j0) the cell that move leads to; `steps` counts
  // the moves applied.
  int8_t* mrow = matched + static_cast<long long>(b) * Vmax;
  int* irow = ins_after + static_cast<long long>(b) * (Vmax + 1);
  const int limit = V + n + 1;
  int i = br + 1;
  int j = n;
  int c = __ldcg(code + static_cast<long long>(i - 1) * Wg + j);
  int i0, j0;
  next_cell(prs_b, P, i, j, c, i0, j0);
  int steps = 0;
  while ((i > 0 || j > 0) && steps < limit) {
    // Apply the current cell's move.
    if (lane == 0) {
      const int m = c & 3;
      if (m == 0) mrow[i - 1] = 1;
      if (m == 2) irow[min(i, Vmax)] += 1;
    }
    ++steps;
    if ((i0 == 0 && j0 == 0) || steps >= limit) {
      i = i0;
      j = j0;
      break;
    }
    // Lane k guesses the k-th cell past (i0, j0) in the same direction.
    const int m = c & 3;
    const int di = m == 2 ? 0 : 1;
    const int dj = m == 1 ? 0 : 1;
    const int gi = i0 - di * lane;
    const int gj = j0 - dj * lane;
    const bool ok = gi >= 0 && gj >= 0;
    const bool end = gi == 0 && gj == 0;
    int gc = 2;  // row 0: a virtual ins move
    {
      // The cells of the next round's guesses and their pred_rows, on to
      // L2 meanwhile.
      const int pi = gi - 32 * di;
      const int pj = gj - 32 * dj;
      if (pi > 0 && pj >= 0) {
        asm volatile("prefetch.global.L2 [%0];" ::"l"(
            code + static_cast<long long>(pi - 1) * Wg + pj));
        asm volatile("prefetch.global.L2 [%0];" ::"l"(
            prs_b + static_cast<long long>(pi - 1) * P));
      }
    }
    if (ok && gi > 0) {
      gc = __ldcg(code + static_cast<long long>(gi - 1) * Wg + gj);
    }
    // Row 0 and the lanes out of range: a virtual ins move.
    int ni = gi;
    int nj = gj - 1;
    if (ok && gi > 0) next_cell(prs_b, P, gi, gj, gc, ni, nj);
    // The cell leads to the next lane's guess, which is in range.
    const bool link = ok && !end && lane < 31 && ni == gi - di &&
                      nj == gj - dj && ni >= 0 && nj >= 0;
    const unsigned broken = __ballot_sync(kFull, !link);
    const int L = __ffs(broken) - 1;  // cells 0..L are on the path
    const int nap = min(L, limit - steps);
    // Cells 0..nap-1 all move in the guessed direction.
    if (m == 0 && lane < nap) mrow[gi - 1] = 1;
    if (m == 2 && lane == 0 && nap > 0) irow[min(i0, Vmax)] += nap;
    steps += nap;
    i = __shfl_sync(kFull, gi, nap);
    j = __shfl_sync(kFull, gj, nap);
    c = __shfl_sync(kFull, gc, nap);
    i0 = __shfl_sync(kFull, ni, nap);
    j0 = __shfl_sync(kFull, nj, nap);
  }
}

}  // namespace

extern "C" {

// G1's sizes: which 0 = the largest graph (V), 1 = query (n), 2 =
// predecessor slots (P), 3 = a row's cell alignment, 4 = the scratch's
// bytes a cell (kernels.GRAPH_V_CAP, GRAPH_N_CAP, GRAPH_P_CAP,
// GRAPH_ROW_ALIGN, GRAPH_CELL_BYTES).
int svtrek_poa_graph_cap(int which) {
  constexpr int kSizes[5] = {kVCap, kNCap, kPCap, kRowAlign, kCellBytes};
  return which >= 0 && which < 5 ? kSizes[which] : 0;
}

// The ring's rows of a launch whose largest query is max_n bases, 0 past
// kNCap (kernels.graph_ring_rows).
int svtrek_poa_graph_ring_rows(int max_n) { return ring_rows(max_n); }

// The dynamic shared memory (bytes) of a launch whose largest query is
// max_n bases over graphs of at most Vmax nodes, 0 past kNCap
// (kernels.graph_smem_bytes).
int svtrek_poa_graph_smem(int max_n, int Vmax) {
  const int r = ring_rows(max_n);
  return r ? static_cast<int>(smem_bytes(r, max_n, min(Vmax, kVCap))) : 0;
}

// base_td [B, Vmax] int8, pred_rows [B, Vmax, P] int32 (each entry of a
// row r < V in [0, r]), npred [B, Vmax] int32, is_sink [B, Vmax] uint8,
// Vs, ns [B] int32 with 1 <= V <= min(Vmax, 65536) and 1 <= n <= min(Nmax,
// 16384), qpad [B, Nmax] int8, all row-major; offsets [count+1] int64, the
// prefix sums of (V+1) * Wg over pairs b0 .. b0+count-1, Wg = n+1 rounded
// up to 32; H int32 and codes uint8 of offsets[count] cells each; max_n
// the largest n of those pairs (it sets the shared ring's rows and size);
// score [B] int32, matched [B, Vmax] int8 and ins_after [B, Vmax+1] int32,
// the last two zero-filled.  All device pointers.  Launches one warp per
// pair b0 .. b0+count-1 on `stream` and returns cudaGetLastError().
int svtrek_poa_graph_dp(const void* base_td, const void* pred_rows,
                        const void* npred, const void* is_sink,
                        const void* Vs, const void* qpad, const void* ns,
                        const void* offsets, int b0, int count, int P,
                        int Vmax, int Nmax, int max_n, void* H, void* codes,
                        void* score, void* matched, void* ins_after,
                        void* stream) {
  if (count <= 0) return 0;
  if (P < 1 || P > kPCap || Vmax < 1 || Nmax < 1 || max_n < 1 ||
      max_n > kNCap) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int ring = ring_rows(max_n);
  const int smem = svtrek_poa_graph_smem(max_n, Vmax);
  cudaError_t err = cudaFuncSetAttribute(
      poa_graph_dp_warp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  poa_graph_dp_warp_kernel<<<count, 32, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(base_td), static_cast<const int*>(pred_rows),
      static_cast<const int*>(npred), static_cast<const uint8_t*>(is_sink),
      static_cast<const int*>(Vs), static_cast<const int8_t*>(qpad),
      static_cast<const int*>(ns), static_cast<const long long*>(offsets), b0,
      P, Vmax, Nmax, row_words(max_n), ring, static_cast<int*>(H),
      static_cast<uint8_t*>(codes), static_cast<int*>(score),
      static_cast<int8_t*>(matched), static_cast<int*>(ins_after));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
