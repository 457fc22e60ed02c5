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
//   node's base; the first maximum wins (updates on strict > only);
// - then the in-row insertions: left[j] = GAP*j + max_{j'<j}(best[j'] -
//   GAP*j'), NEG at j = 0, taken only where strictly greater than best;
// - the end row is the first (lowest rank) best-scoring sink, row 1 when
//   there is none, as jnp.argmax gives;
// - the walk from (end row, n) to (0, 0): row 0 moves left; a diag move
//   marks its node matched and goes to the chosen predecessor row and
//   column j-1, a del move to the predecessor row, an ins move counts an
//   inserted base after row i.  JAX's fixed-length scan without its idle
//   steps.
//
// Layout.  One block of kThreads threads per pair; thread t owns the
// contiguous strip of S = ceil((n+1)/kThreads) columns from t*S, its best
// scores, choices and query bases in registers.  H (int32) and one code
// byte a cell ((psel << 2) | move: move 0 diag, 1 del, 2 ins) live in
// device memory, each pair's (V+1) x (n+1) cells at a prefix-sum offset
// (`kernels.poa_graph_chunks`), 5 bytes a cell: 10.5 MB a pair at the
// caps.  The wrapper splits a batch whose scratch would pass
// kernels.GRAPH_SCRATCH_BYTES (2 GiB) into several launches.  Predecessor
// rows are read back from device memory (through L1/L2): a row can depend
// on any earlier one.
//
// A row: the 2P candidates of each column of the strip (a predecessor's
// strip and the cell left of it loaded once per slot), the strip's maximum
// of best[j] - GAP*j, a block-wide exclusive max-scan of those maxima (a
// warp scan, then the warps' totals through shared memory), a pass over the
// strip that resolves the insertions and writes H and the codes, and a
// barrier, since the next row reads cells of other threads' strips.
//
// What bounds it.  Not bytes (about 5 bytes a cell written and a few read)
// nor int32 throughput (a few dozen operations a cell): the rows of a pair
// are a chain of V dependent steps, each with two block barriers and a
// scan, and the traceback is a chain of up to V + n dependent loads on one
// thread.  A batch takes as long as its largest pair's chain.  A later
// design could keep the recent rows in shared memory (most predecessors are
// the row just before), or give a pair a warp instead of a block, so that
// a row needs no block barrier and many pairs share an SM.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kMatch = 2;      // ops/poa.py MATCH / MISMATCH / GAP
constexpr int kMismatch = -4;
constexpr int kGap = -2;
constexpr int kNeg = -(1 << 28);  // ops/poa_graph.py NEG
// The caps of ops/poa_graph_batch.py (V_CAP, N_CAP, P_CAP); kernels.py
// holds the same numbers and checks them at load.
constexpr int kVCap = 2048;
constexpr int kNCap = 1024;
constexpr int kPCap = 32;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxStrip = (kNCap + 1 + kThreads - 1) / kThreads;  // 9
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kThreads) poa_graph_dp_kernel(
    const int8_t* __restrict__ base_td, const int* __restrict__ pred_rows,
    const int* __restrict__ npred, const uint8_t* __restrict__ is_sink,
    const int* __restrict__ Vs, const int8_t* __restrict__ qpad,
    const int* __restrict__ ns, const long long* __restrict__ offsets, int b0,
    int P, int Vmax, int Nmax, int* H_all, int8_t* code_all,
    int* __restrict__ score, int8_t* __restrict__ matched,
    int* __restrict__ ins_after) {
  __shared__ int warp_max[kWarps];
  __shared__ int red_val[kWarps];
  __shared__ int red_row[kWarps];
  const int b = b0 + blockIdx.x;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int V = Vs[b];
  const int n = ns[b];
  // The wrapper refuses these pairs; a block that gets one writes nothing.
  if (V < 1 || V > kVCap || V > Vmax || n < 1 || n > kNCap || n > Nmax) {
    return;
  }
  const int W = n + 1;
  int* H = H_all + offsets[blockIdx.x];
  int8_t* code = code_all + offsets[blockIdx.x];
  const int8_t* base = base_td + static_cast<long long>(b) * Vmax;
  const int* prs_b = pred_rows + static_cast<long long>(b) * Vmax * P;
  const int* np_b = npred + static_cast<long long>(b) * Vmax;
  const int S = (W + kThreads - 1) / kThreads;
  const int j0 = t * S;
  const int cnt = max(0, min(S, W - j0));

  // Row 0, and the strip's query bases: qs[c] = q[j0 + c - 1].
  int qs[kMaxStrip];
  const int8_t* q = qpad + static_cast<long long>(b) * Nmax;
#pragma unroll
  for (int c = 0; c < kMaxStrip; ++c) {
    const int j = j0 + c;
    qs[c] = (c < cnt && j > 0) ? static_cast<int>(q[j - 1]) : 0;
    if (c < cnt) H[j] = kGap * j;
  }
  __syncthreads();

  for (int i = 1; i <= V; ++i) {
    const int bi = base[i - 1];
    const int np = min(np_b[i - 1], P);
    const int* prs = prs_b + static_cast<long long>(i - 1) * P;
    int best[kMaxStrip];
    int sel[kMaxStrip];
#pragma unroll
    for (int c = 0; c < kMaxStrip; ++c) {
      best[c] = INT_MIN;
      sel[c] = 0;
    }
    for (int p = 0; p < P; ++p) {
      if (p < np) {
        const int* hp = H + static_cast<long long>(prs[p]) * W;
        int prev = j0 > 0 && cnt > 0 ? hp[j0 - 1] : 0;
#pragma unroll
        for (int c = 0; c < kMaxStrip; ++c) {
          if (c < cnt) {
            const int j = j0 + c;
            const int cur = hp[j];
            const int d = cur + kGap;
            const int dg = j > 0 ? prev + (qs[c] == bi ? kMatch : kMismatch)
                                 : kNeg + kNeg;
            if (d > best[c]) {
              best[c] = d;
              sel[c] = 2 * p;
            }
            if (dg > best[c]) {
              best[c] = dg;
              sel[c] = 2 * p + 1;
            }
            prev = cur;
          }
        }
      } else {
        // A padding slot: del and diag are NEG; only del can be first.
#pragma unroll
        for (int c = 0; c < kMaxStrip; ++c) {
          if (c < cnt && kNeg > best[c]) {
            best[c] = kNeg;
            sel[c] = 2 * p;
          }
        }
      }
    }
    // The strip's max of best[j] - GAP*j, then the block's exclusive scan.
    int gmax = INT_MIN;
#pragma unroll
    for (int c = 0; c < kMaxStrip; ++c) {
      if (c < cnt) gmax = max(gmax, best[c] - kGap * (j0 + c));
    }
    int incl = gmax;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int o = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl = max(incl, o);
    }
    if (lane == 31) warp_max[warp] = incl;
    int run = __shfl_up_sync(kFull, incl, 1);
    if (lane == 0) run = INT_MIN;
    __syncthreads();
    for (int w = 0; w < warp; ++w) run = max(run, warp_max[w]);
    int* hrow = H + static_cast<long long>(i) * W;
    int8_t* crow = code + static_cast<long long>(i) * W;
#pragma unroll
    for (int c = 0; c < kMaxStrip; ++c) {
      if (c < cnt) {
        const int j = j0 + c;
        // For j >= 1 run holds g[0] at least, so it is never INT_MIN here.
        const int left = (j == 0 ? kNeg : run) + kGap * j;
        const bool use_ins = left > best[c];
        hrow[j] = use_ins ? left : best[c];
        crow[j] = static_cast<int8_t>(
            use_ins ? 2 : ((sel[c] >> 1) << 2) | ((sel[c] & 1) ? 0 : 1));
        run = max(run, best[c] - kGap * j);
      }
    }
    __syncthreads();
  }

  // The end row: the first maximum of H[r+1][n] over the sinks r < V (NEG
  // elsewhere) among r < Vmax.
  int bv = INT_MIN;
  int br = INT_MAX;
  for (int r = t; r < Vmax; r += kThreads) {
    const int v = (r < V && is_sink[static_cast<long long>(b) * Vmax + r])
                      ? H[static_cast<long long>(r + 1) * W + n]
                      : kNeg;
    if (v > bv) {
      bv = v;
      br = r;
    }
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    const int ov = __shfl_down_sync(kFull, bv, d);
    const int orow = __shfl_down_sync(kFull, br, d);
    if (ov > bv || (ov == bv && orow < br)) {
      bv = ov;
      br = orow;
    }
  }
  if (lane == 0) {
    red_val[warp] = bv;
    red_row[warp] = br;
  }
  __syncthreads();
  if (t != 0) return;
  for (int w = 1; w < kWarps; ++w) {
    if (red_val[w] > bv || (red_val[w] == bv && red_row[w] < br)) {
      bv = red_val[w];
      br = red_row[w];
    }
  }
  score[b] = bv;

  // The walk, on one thread; at most V + n steps (each lowers i or j).
  int8_t* mrow = matched + static_cast<long long>(b) * Vmax;
  int* irow = ins_after + static_cast<long long>(b) * (Vmax + 1);
  int i = br + 1;
  int j = n;
  for (int steps = 0; (i > 0 || j > 0) && steps <= V + n; ++steps) {
    if (i == 0) {
      irow[0] += 1;
      --j;
      continue;
    }
    const int cd = code[static_cast<long long>(i) * W + j];
    const int m = cd & 3;
    if (m == 2) {
      irow[min(i, Vmax)] += 1;
      --j;
      continue;
    }
    if (m == 0) {
      mrow[i - 1] = 1;
      --j;
    }
    i = prs_b[static_cast<long long>(i - 1) * P + (cd >> 2)];
  }
}

}  // namespace

extern "C" {

// The caps G1 takes: which 0 = nodes (V), 1 = query length (n), 2 =
// predecessor slots (P) (kernels.GRAPH_V_CAP, GRAPH_N_CAP, GRAPH_P_CAP).
int svtrek_poa_graph_cap(int which) {
  return which == 0 ? kVCap : which == 1 ? kNCap : kPCap;
}

// base_td [B, Vmax] int8, pred_rows [B, Vmax, P] int32 (each entry of a
// row r < V in [0, r]), npred [B, Vmax] int32, is_sink [B, Vmax] uint8,
// Vs, ns [B] int32 with 1 <= V <= min(Vmax, 2048) and 1 <= n <= min(Nmax,
// 1024), qpad [B, Nmax] int8, all row-major; offsets [count+1] int64, the
// prefix sums of (V+1)*(n+1) over pairs b0 .. b0+count-1; H int32 and
// codes int8 of offsets[count] cells each; score [B] int32, matched [B,
// Vmax] int8 and ins_after [B, Vmax+1] int32, the last two zero-filled.
// All device pointers.  Launches one block per pair b0 .. b0+count-1 on
// `stream` and returns cudaGetLastError().
int svtrek_poa_graph_dp(const void* base_td, const void* pred_rows,
                        const void* npred, const void* is_sink,
                        const void* Vs, const void* qpad, const void* ns,
                        const void* offsets, int b0, int count, int P,
                        int Vmax, int Nmax, void* H, void* codes, void* score,
                        void* matched, void* ins_after, void* stream) {
  if (count <= 0) return 0;
  if (P < 1 || P > kPCap || Vmax < 1 || Nmax < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  poa_graph_dp_kernel<<<count, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(base_td), static_cast<const int*>(pred_rows),
      static_cast<const int*>(npred), static_cast<const uint8_t*>(is_sink),
      static_cast<const int*>(Vs), static_cast<const int8_t*>(qpad),
      static_cast<const int*>(ns), static_cast<const long long*>(offsets), b0,
      P, Vmax, Nmax, static_cast<int*>(H), static_cast<int8_t*>(codes),
      static_cast<int*>(score), static_cast<int8_t*>(matched),
      static_cast<int*>(ins_after));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
