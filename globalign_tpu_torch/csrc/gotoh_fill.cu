// gotoh_fill.cu — Gotoh affine-gap DP fill for Hopper (sm_90a), one block
// per pair, emitting final3 and (optionally) the packed move codes.
//
// What it replaces.  One kernel takes the place of three TPU kernels on the
// single-pair align path, and of a fourth one's final3 mode:
//   * globalign_tpu/ops/fill_lanes.py:_make_lane_kernel (via _lanes_run),
//     moves mode, uniform schemes   — entry lanes_batch_moves;
//   * the same kernel, general moves mode (select chain / bitmask
//     substitution)                 — entry lanes_general_moves;
//   * globalign_tpu/ops/fill_pallas.py:_make_stacked_kernel(want_moves=True)
//                                   — entry stacked_fill_with_moves;
//   * _make_lane_kernel's cost modes, final3 only (MOVES = false here)
//                                   — entries lanes_batch_final3 /
//                                     lanes_general_final3.
// The TPU needed three kernels because Mosaic has no per-lane gather and
// VMEM sizing picks the variant; here a thread reads the (A, A) cost table
// at any index, so one kernel serves every scheme and alphabet size.
//
// What it computes.  For pair b, with 1-origin tokens tok_a[b, 0..M] and
// tok_b[b, 0..N] and true lengths m = m_true[b], n = n_true[b]:
//   final3[b] = (M, Ix, Iy) at cell (m, n);
//   moves[b, i, j] for 1 <= i <= m, 1 <= j <= n: bits 0-1 the M
//   predecessor, 2-3 Ix, 4-5 Iy (0 = M, 1 = Ix, 2 = Iy).  Every other
//   byte of moves[b] (row 0, column 0, the padding) is written 0.
// The arithmetic is the row scan's (globalign_tpu/ops/fill_rows.py:133-289)
// operation for operation, in int32 with BIG = 1 << 30: the clamps
// min(., BIG) at :175, :177, :193, the code tests of :212-231 on unclamped
// sums with tie order M > Ix > Iy, and the boundary of fill_scan.py:90-104.
// The row scan's Ix prefix minimum, D[j] + min(BIG, min_{j'<j} H[j'] - D[j']),
// is carried here as its serial form X[j] = min(X[j-1] + d_j, H[j-1] + d_j)
// with X[0] = BIG — the same integers, so codes match bit for bit.
//
// Design: strip per thread (the TPU lane kernel's strip <-> lane idea,
// fill_lanes.py:9-35).  Thread t owns columns t*w+1 .. (t+1)*w and walks
// them serially, which carries the horizontal Ix chain in registers.
// Strips are skewed one row apart: in wave k thread t fills row k - t + 1,
// so its left neighbour finished the same row one wave earlier and left the
// edge values (M, Ix, Iy, unclamped X) in a shared-memory ping-pong buffer;
// one __syncthreads per wave.  The previous row of each strip, and its
// tokens, live in a [level][c][t] interleaved array (conflict-free in shared
// memory, coalesced in global memory) — in shared memory when it fits the
// card's opt-in limit, else in per-pair global scratch.  The cost table is
// in shared memory when it fits, else read from global memory, so no
// alphabet is refused.
//
// What bounds it on this card: each row of a strip is a serial dependency
// chain, and one pair runs on one SM (a block), so at B = 1 the kernel uses
// 1 of 132 SMs and is bound by that SM's issue rate and the per-wave
// barrier.  Move codes are stored a byte at a time, uncoalesced.  Many SMs
// per pair and coalesced code stores are later work.
//
// Launch conventions: the kernel runs on the caller's stream, allocates
// nothing (the caller passes final3, moves and scratch), and the launcher
// returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BIG = 1 << 30;
constexpr int MAX_THREADS = 1024;

template <bool MOVES>
__global__ void __launch_bounds__(MAX_THREADS)
gotoh_fill_kernel(const int* __restrict__ tok_a,
                  const int* __restrict__ tok_b,
                  const int* __restrict__ cost_mat,
                  const int* __restrict__ m_true,
                  const int* __restrict__ n_true,
                  int* __restrict__ final3,
                  uint8_t* __restrict__ moves,
                  int* __restrict__ scratch,
                  int M, int N, int A, int gap_id, int go, int W,
                  int table_in_smem, int state_in_smem) {
  extern __shared__ int4 smem[];
  const int T = blockDim.x;
  const int t = threadIdx.x;
  const int b = blockIdx.x;

  int4* edge = smem;  // [2][T] ping-pong of right-edge values
  int* smem_int = reinterpret_cast<int*>(smem + 2 * T);
  const int* tab = cost_mat;
  int* state_smem = smem_int;
  if (table_in_smem) {
    for (int k = t; k < A * A; k += T) smem_int[k] = cost_mat[k];
    tab = smem_int;
    state_smem = smem_int + A * A;
  }
  const long long WT = (long long)W * T;
  int* st = state_in_smem ? state_smem : scratch + (long long)b * 4 * WT;
  int* stM = st;
  int* stX = st + WT;
  int* stY = st + 2 * WT;
  int* stB = st + 3 * WT;  // tokens of seq_2

  const int m = m_true[b];
  const int n = n_true[b];
  const int* ta = tok_a + (long long)b * (M + 1);
  const int* tb = tok_b + (long long)b * (N + 1);
  const int* gap_row = tab + gap_id * A;  // dcost(c) = cost('-', c)
  const long long ld = N + 1;
  uint8_t* mv = MOVES ? moves + (long long)b * (M + 1) * ld : nullptr;

  if (MOVES) {  // zero every byte the waves do not write
    for (int j = t; j <= N; j += T) mv[j] = 0;
    for (int i = 1 + t; i <= M; i += T) mv[i * ld] = 0;
    for (int i = 1; i <= m; ++i)
      for (int j = n + 1 + t; j <= N; j += T) mv[i * ld + j] = 0;
    for (long long k = (m + 1) * ld + t; k < (M + 1) * ld; k += T) mv[k] = 0;
  }
  __syncthreads();  // cost table staged

  if (m == 0 || n == 0) {  // only boundary cells: fill_scan.py:90-104
    if (t == 0) {
      int f0 = 0, f1 = 0, f2 = 0;
      if (m == 0 && n > 0) {
        int acc = go;
        for (int j = 1; j <= n; ++j) acc += gap_row[tb[j]];
        f0 = BIG, f1 = acc, f2 = BIG;
      } else if (m > 0) {
        int acc = go;
        for (int i = 1; i <= m; ++i) acc += tab[ta[i] * A + gap_id];
        f0 = BIG, f1 = BIG, f2 = acc;
      }
      final3[3 * b] = f0;
      final3[3 * b + 1] = f1;
      final3[3 * b + 2] = f2;
    }
    return;
  }

  const int w = (n + T - 1) / T;  // columns per strip
  const int S = (n + w - 1) / w;  // strips in use (S <= T)
  const int j0 = t * w + 1;       // first column of this thread's strip
  const int wt = t < S ? min(w, n - t * w) : 0;

  // D[j0 - 1]: exclusive prefix over strips of the dcost sums (Hillis-Steele
  // in the edge buffer; int32 wraps exactly as the row scan's cumsum).
  int part = 0;
  for (int c = 0; c < wt; ++c) part += gap_row[tb[j0 + c]];
  int* scan = reinterpret_cast<int*>(edge);
  scan[t] = part;
  __syncthreads();
  for (int off = 1; off < T; off <<= 1) {
    const int v = t >= off ? scan[t - off] : 0;
    __syncthreads();
    scan[t] += v;
    __syncthreads();
  }
  const int d_before = scan[t] - part;
  __syncthreads();  // the edge buffer is reused below

  // Row 0: (BIG, go + D[j], BIG), dp[0][0] = (0, 0, 0).
  int acc = go + d_before;
  for (int c = 0; c < wt; ++c) {
    const int s = c * T + t;
    const int bt = tb[j0 + c];
    acc += gap_row[bt];
    stM[s] = BIG;
    stX[s] = acc;
    stY[s] = BIG;
    stB[s] = bt;
  }
  // Diagonal predecessor of the strip's first cell: row i-1, column j0-1.
  int dM = t == 0 ? 0 : BIG;
  int dX = t == 0 ? 0 : go + d_before;
  int dY = t == 0 ? 0 : BIG;
  int col0y = go;  // thread 0: Iy at (i, 0) = go + sum icost(a_1..a_i)

  const int waves = m + S - 1;
  for (int k = 0; k < waves; ++k) {
    const int i = k - t + 1;
    if (t < S && i >= 1 && i <= m) {
      const int* sub_row = tab + ta[i] * A;
      const int ic = sub_row[gap_id];  // icost(a_i)
      int lM, lX, lY, lXu;  // row i, column j0-1 (lXu: X unclamped)
      if (t == 0) {
        col0y += ic;
        lM = BIG, lX = BIG, lY = col0y, lXu = BIG;
      } else {
        const int4 e = edge[((k - 1) & 1) * T + t - 1];
        lM = e.x, lX = e.y, lY = e.z, lXu = e.w;
      }
      const int eM = lM, eX = lX, eY = lY;
      uint8_t* mrow = MOVES ? mv + i * ld + j0 : nullptr;
      for (int c = 0; c < wt; ++c) {
        const int s = c * T + t;
        const int mp = stM[s], xp = stX[s], yp = stY[s], bt = stB[s];
        const int sub = sub_row[bt];
        const int d = gap_row[bt];
        const int best = min(min(dM, dX), dY);
        const int mc = min(best + sub, BIG);
        const int vy = min(min(mp + go, xp + go), yp);
        const int yc = min(vy + ic, BIG);
        const int h = min(lM, lY) + go;
        const int xu = min(lXu + d, h + d);
        const int xc = min(xu, BIG);
        if (MOVES) {
          const int cm = dM == best ? 0 : (dX == best ? 1 : 2);
          const int cy = mp + go == vy ? 0 : (xp + go == vy ? 1 : 2);
          const int cx = xc == lM + go + d ? 0 : (xc == lX + d ? 1 : 2);
          mrow[c] = (uint8_t)(cm | (cx << 2) | (cy << 4));
        }
        stM[s] = mc;
        stX[s] = xc;
        stY[s] = yc;
        dM = mp, dX = xp, dY = yp;
        lM = mc, lX = xc, lY = yc, lXu = xu;
      }
      edge[(k & 1) * T + t] = make_int4(lM, lX, lY, lXu);
      if (i == m && t == S - 1) {  // column n ends the last strip
        final3[3 * b] = lM;
        final3[3 * b + 1] = lX;
        final3[3 * b + 2] = lY;
      }
      dM = eM, dX = eX, dY = eY;
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" {

// Launches the fill for B pairs on `stream`.  `moves` may be null (final3
// only).  `scratch` holds B * 4 * W * threads int32 and is used when the
// strip state does not fit in shared memory.  Lengths in m_true / n_true
// must lie in [0, M] / [0, N] (the caller checks).
int gotoh_fill_launch(const void* tok_a, const void* tok_b,
                      const void* cost_mat, const void* m_true,
                      const void* n_true, void* final3, void* moves,
                      void* scratch, int B, int M, int N, int A, int gap_id,
                      int gap_open, int threads, int W, void* stream) {
  if (threads < 32 || threads > MAX_THREADS || threads % 32 != 0 || W < 1 ||
      B < 1)
    return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  int optin = 0;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (err != cudaSuccess) return (int)err;

  const size_t edge_bytes = 2 * (size_t)threads * sizeof(int4);
  const size_t table_bytes = (size_t)A * A * sizeof(int);
  const size_t state_bytes = 4 * (size_t)W * threads * sizeof(int);
  const bool table_in_smem = edge_bytes + table_bytes <= (size_t)optin;
  size_t smem = edge_bytes + (table_in_smem ? table_bytes : 0);
  const bool state_in_smem = smem + state_bytes <= (size_t)optin;
  if (state_in_smem) smem += state_bytes;

  auto kernel = moves ? gotoh_fill_kernel<true> : gotoh_fill_kernel<false>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<B, threads, smem, (cudaStream_t)stream>>>(
      (const int*)tok_a, (const int*)tok_b, (const int*)cost_mat,
      (const int*)m_true, (const int*)n_true, (int*)final3, (uint8_t*)moves,
      (int*)scratch, M, N, A, gap_id, gap_open, W, table_in_smem ? 1 : 0,
      state_in_smem ? 1 : 0);
  return (int)cudaGetLastError();
}

const char* gotoh_fill_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
