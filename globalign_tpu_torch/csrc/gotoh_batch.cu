// gotoh_batch.cu — cost-only Gotoh fills of a batch of pairs for Hopper
// (sm_90a), one warp per pair: final3 and, optionally, each pair's last row.
//
// What it replaces.  Two TPU kernels of the batch cost path
// (globalign_tpu/ops/fill_pallas.py:batch_final3):
//   * _make_stacked_uniform_kernel (:1321, launched by
//     stacked_uniform_fill_last_rows :1441): B >= 8 pairs advance together,
//     a row at a time, one pair per vector slot; uniform schemes only;
//   * _make_batch_row_kernel (:458, launched by row_fill_last_rows_batch
//     :353): the grid-per-pair row kernel, any matrix.
// Both return each pair's row m_true[b] as (B, 3, R * 128), which
// batch_final3 reads at column n_true[b].
//
// What it computes.  For pair b, with 1-origin tokens tok_a[b, 0..M],
// tok_b[b, 0..N] and true lengths m = m_true[b], n = n_true[b]:
//   final3[b] = (M, Ix, Iy) at cell (m, n);
//   last[b, :, j] = (M, Ix, Iy) of row m at column j <= n; column 0 is
//   (BIG, BIG, Iy(m, 0)), or row 0's (0, 0, 0) when m = 0; columns past n
//   are written BIG — the contract of gotoh_fill's last-row mode.
// The arithmetic is gotoh_fill's (gotoh_fill.cu:37-45) operation for
// operation: int32, BIG = 1 << 30 clamps, the serial Ix carry X[j] =
// min(X[j-1] + d_j, H[j-1] + d_j) with the unclamped X passed across the
// strip edge, and the boundary of fill_scan.py.  So final3 and the last
// rows are bit-identical to the plain version (the row scan of
// ops/fill_rows.py, pair by pair).  It reads any (A, A) table from shared
// memory, A <= 256: one kernel for every scheme.
//
// Design: the TPU's idea in #8 is that many pairs share each row step;
// here many pairs share each SM.  One warp fills one pair; a block holds
// `warps` warps, so `warps` pairs of one bucket.  Lane l owns a strip of
// w = ceil(n / 32) columns, l*w+1 .. (l+1)*w, and walks it serially,
// which carries the horizontal Ix chain in registers.  Strips are skewed
// one row apart: in wave k lane l fills row k - l + 1, so its left
// neighbour finished the same row one wave earlier; the neighbour's right
// edge (M, Ix, Iy, unclamped X) comes by __shfl_up_sync — no block
// barrier in the wave loop.  Each strip's previous row lives in shared
// memory, [warp][level][c][lane] interleaved (conflict-free), with the
// strip's seq_2 tokens as bytes beside it: 13 bytes a column.  Each warp
// stops after its own m + S - 1 waves (S strips in use); that count is
// the same for every lane of the warp, so the shuffles never diverge.
//
// The width cap.  The wrapper (ops/fill_batch.py) launches this kernel for
// buckets of N <= 4096 columns (W = ceil(N / 32) <= 128 per lane): 4 warps
// of 4096 columns take 4 * 13 * 4096 = 208 KB of the 227 KB a block may
// opt in to, leaving 19 KB for the table (the 60-letter table is 14.4 KB,
// BLOSUM62's 2.5 KB).  Wider buckets, and tables that do not fit beside
// one warp's state, go to gotoh_fill's final3 / last-row mode.  The
// wrapper picks warps a block = clamp(B / SMs, 1, 4), lowered until the
// plan fits: a bucket of fewer pairs than SMs gets one warp per block, so
// its pairs spread over as many SMs as it has pairs.
//
// What bounds it on this card.  Its roofline is int32 throughput: 16 int32
// operations a cell (9 min, 7 add), plus 6 shared-memory loads and 3
// stores, and the only serial chain per cell is the Ix carry (an add and a
// min).  With many warps an SM (a bucket of >= 8 pairs an SM) latencies
// hide and that is the limit; a bucket of fewer pairs than the card has
// SMs puts one warp on each of a few SMs, which then waits out its own
// latencies (a warp runs its instructions in order).  The strip loop
// takes UNROLL columns at a time, loads first (strip_cells): the M and Iy
// lanes of those columns are independent, which hides part of that wait.
// The caller launches one bucket at a time, so a small bucket leaves most
// of the card idle.
//
// Launch conventions: the kernel runs on the caller's stream, allocates
// nothing, and the launcher returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BIG = 1 << 30;
constexpr int WARP = 32;
constexpr int MAX_WARPS = 4;
constexpr int UNROLL = 8;
constexpr unsigned FULL = 0xffffffffu;

// The carried values of a strip row: the diagonal predecessor (row i-1,
// column j-1) and the left neighbour (row i, column j-1; lXu is X
// unclamped) of the next cell.
struct Cell {
  int dM, dX, dY, lM, lX, lY, lXu;
};

// U consecutive cells of one strip row, from strip slot s.  The loads of
// all U columns come first: the M and Iy lanes of a cell depend only on
// the previous row, so U cells' worth of independent work hides the
// latencies that one warp alone on its SM sub-partition would otherwise
// wait out cell by cell; only the Ix carry (an add and a min) is serial.
template <int U>
__device__ __forceinline__ void strip_cells(
    Cell& cell, int* __restrict__ stM, int* __restrict__ stX,
    int* __restrict__ stY, const uint8_t* __restrict__ stB, int s,
    const int* __restrict__ sub_row, const int* __restrict__ gap_row, int go,
    int ic) {
  int mp[U], xp[U], yp[U], sub[U], d[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int t = s + u * WARP;
    const int bt = stB[t];
    mp[u] = stM[t], xp[u] = stX[t], yp[u] = stY[t];
    sub[u] = sub_row[bt], d[u] = gap_row[bt];
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int t = s + u * WARP;
    const int best = min(min(cell.dM, cell.dX), cell.dY);
    const int mc = min(best + sub[u], BIG);
    const int vy = min(min(mp[u] + go, xp[u] + go), yp[u]);
    const int yc = min(vy + ic, BIG);
    const int h = min(cell.lM, cell.lY) + go;
    const int xu = min(cell.lXu + d[u], h + d[u]);
    const int xc = min(xu, BIG);
    stM[t] = mc;
    stX[t] = xc;
    stY[t] = yc;
    cell = Cell{mp[u], xp[u], yp[u], mc, xc, yc, xu};
  }
}

template <bool LAST>
__global__ void __launch_bounds__(MAX_WARPS * WARP)
gotoh_batch_kernel(const int* __restrict__ tok_a,
                   const int* __restrict__ tok_b,
                   const int* __restrict__ cost_mat,
                   const int* __restrict__ m_true,
                   const int* __restrict__ n_true,
                   int* __restrict__ final3, int* __restrict__ last, int B,
                   int M, int N, int A, int gap_id, int go, int W) {
  extern __shared__ int smem[];
  const int warps = blockDim.x / WARP;
  const int lane = threadIdx.x % WARP;
  const int wid = threadIdx.x / WARP;
  const int cols = W * WARP;  // strip state capacity of one warp

  int* tab = smem;  // (A, A) cost table
  for (int k = threadIdx.x; k < A * A; k += blockDim.x) tab[k] = cost_mat[k];
  int* stM = smem + A * A + wid * 3 * cols;  // [level][c][lane]
  int* stX = stM + cols;
  int* stY = stM + 2 * cols;
  uint8_t* stB =  // tokens of seq_2, after every warp's int state
      reinterpret_cast<uint8_t*>(smem + A * A + warps * 3 * cols) + wid * cols;
  __syncthreads();  // the table is staged; no block barrier after this

  const int b = blockIdx.x * warps + wid;
  if (b >= B) return;  // warp-uniform
  const int m = m_true[b];
  const int n = n_true[b];
  const int* ta = tok_a + (long long)b * (M + 1);
  const int* tb = tok_b + (long long)b * (N + 1);
  const int* gap_row = tab + gap_id * A;  // dcost(c) = cost('-', c)
  const long long ld = N + 1;
  int* lst = LAST ? last + (long long)b * 3 * ld : nullptr;

  if (LAST)  // columns past n
    for (int j = n + 1 + lane; j <= N; j += WARP)
      lst[j] = lst[ld + j] = lst[2 * ld + j] = BIG;

  if (m == 0 || n == 0) {  // only boundary cells: fill_scan.py:90-104
    if (lane == 0) {
      int f0, f1, f2;
      if (m == 0) {  // row 0: (0, 0, 0), then (BIG, go + D[j], BIG)
        int acc = go;
        f0 = 0, f1 = 0, f2 = 0;
        if (LAST) lst[0] = lst[ld] = lst[2 * ld] = 0;
        for (int j = 1; j <= n; ++j) {
          acc += gap_row[tb[j]];
          f0 = BIG, f1 = acc, f2 = BIG;
          if (LAST) lst[j] = BIG, lst[ld + j] = acc, lst[2 * ld + j] = BIG;
        }
      } else {  // n == 0: column 0 only
        int acc = go;
        for (int i = 1; i <= m; ++i) acc += tab[ta[i] * A + gap_id];
        f0 = BIG, f1 = BIG, f2 = acc;
        if (LAST) lst[0] = BIG, lst[ld] = BIG, lst[2 * ld] = acc;
      }
      final3[3 * b] = f0;
      final3[3 * b + 1] = f1;
      final3[3 * b + 2] = f2;
    }
    return;
  }

  const int w = (n + WARP - 1) / WARP;  // columns per strip (<= W)
  const int S = (n + w - 1) / w;        // strips in use (<= 32)
  const int j0 = lane * w + 1;          // first column of this lane's strip
  const int wt = lane < S ? min(w, n - lane * w) : 0;

  // D[j0 - 1]: exclusive prefix over the strips of their dcost sums (a warp
  // scan; int32 wraps exactly as the row scan's cumsum).
  int part = 0;
  for (int c = 0; c < wt; ++c) part += gap_row[tb[j0 + c]];
  int incl = part;
  for (int off = 1; off < WARP; off <<= 1) {
    const int v = __shfl_up_sync(FULL, incl, off);
    if (lane >= off) incl += v;
  }
  const int d_before = incl - part;

  // Row 0: (BIG, go + D[j], BIG), dp[0][0] = (0, 0, 0).
  int acc = go + d_before;
  for (int c = 0; c < wt; ++c) {
    const int s = c * WARP + lane;
    const int bt = tb[j0 + c];
    acc += gap_row[bt];
    stM[s] = BIG;
    stX[s] = acc;
    stY[s] = BIG;
    stB[s] = (uint8_t)bt;
  }
  // Diagonal predecessor of the strip's first cell: row i-1, column j0-1.
  int dM = BIG, dX = go + d_before, dY = BIG;
  if (lane == 0) dM = 0, dX = 0, dY = 0;
  int col0y = go;  // lane 0: Iy at (i, 0) = go + icost(a_1) + ... + icost(a_i)
  // This lane's right edge of the row it filled last (M, Ix, Iy, X).
  int oM = BIG, oX = BIG, oY = BIG, oXu = BIG;
  int a_next = ta[1];  // the token of the lane's next row (read a wave ahead)

  const int waves = m + S - 1;
  for (int k = 0; k < waves; ++k) {
    // The left neighbour filled row k - lane + 1 in wave k - 1.
    const int rM = __shfl_up_sync(FULL, oM, 1);
    const int rX = __shfl_up_sync(FULL, oX, 1);
    const int rY = __shfl_up_sync(FULL, oY, 1);
    const int rXu = __shfl_up_sync(FULL, oXu, 1);
    const int i = k - lane + 1;
    if (lane < S && i >= 1 && i <= m) {
      const int* sub_row = tab + a_next * A;
      a_next = ta[min(i + 1, m)];
      const int ic = sub_row[gap_id];  // icost(a_i)
      if (lane == 0) col0y += ic;
      // Row i, column j0-1: the matrix edge for lane 0, else the neighbour's.
      Cell cell = lane == 0 ? Cell{dM, dX, dY, BIG, BIG, col0y, BIG}
                            : Cell{dM, dX, dY, rM, rX, rY, rXu};
      const int eM = cell.lM, eX = cell.lX, eY = cell.lY;
      int c = 0;
      for (; c + UNROLL <= wt; c += UNROLL)
        strip_cells<UNROLL>(cell, stM, stX, stY, stB, c * WARP + lane,
                            sub_row, gap_row, go, ic);
      for (; c < wt; ++c)
        strip_cells<1>(cell, stM, stX, stY, stB, c * WARP + lane, sub_row,
                       gap_row, go, ic);
      oM = cell.lM, oX = cell.lX, oY = cell.lY, oXu = cell.lXu;
      if (i == m && lane == S - 1) {  // column n ends the last strip
        final3[3 * b] = oM;
        final3[3 * b + 1] = oX;
        final3[3 * b + 2] = oY;
      }
      if (LAST && i == m) {  // the strip's share of the last row
        if (lane == 0) lst[0] = BIG, lst[ld] = BIG, lst[2 * ld] = col0y;
        for (int c = 0; c < wt; ++c) {
          const int t = c * WARP + lane;
          lst[j0 + c] = stM[t], lst[ld + j0 + c] = stX[t];
          lst[2 * ld + j0 + c] = stY[t];
        }
      }
      dM = eM, dX = eX, dY = eY;
    }
  }
}

}  // namespace

extern "C" {

// Launches the fills of B pairs on `stream`, `warps` pairs a block.
// `last` may be null (final3 only).  W is the strip capacity of a warp,
// ceil(N / 32) columns a lane; the dynamic shared memory is 4 * A * A +
// warps * 13 * 32 * W bytes and must fit the device's opt-in limit, else
// the launch is refused (no fallback).  Lengths in m_true / n_true must
// lie in [0, M] / [0, N] (the caller checks); tokens lie in [0, A).
int gotoh_batch_launch(const void* tok_a, const void* tok_b,
                       const void* cost_mat, const void* m_true,
                       const void* n_true, void* final3, void* last, int B,
                       int M, int N, int A, int gap_id, int gap_open,
                       int warps, int W, void* stream) {
  if (B < 1 || M < 0 || N < 0 || A < 1 || A > 256 || warps < 1 ||
      warps > MAX_WARPS || W < 1 || (long long)W * WARP < N)
    return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  int optin = 0;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = (size_t)A * A * sizeof(int) +
                      (size_t)warps * W * WARP * (3 * sizeof(int) + 1);
  if (smem > (size_t)optin) return (int)cudaErrorInvalidConfiguration;

  auto kernel = last ? gotoh_batch_kernel<true> : gotoh_batch_kernel<false>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (B + warps - 1) / warps;
  kernel<<<blocks, warps * WARP, smem, (cudaStream_t)stream>>>(
      (const int*)tok_a, (const int*)tok_b, (const int*)cost_mat,
      (const int*)m_true, (const int*)n_true, (int*)final3, (int*)last, B, M,
      N, A, gap_id, gap_open, W);
  return (int)cudaGetLastError();
}

const char* gotoh_batch_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
