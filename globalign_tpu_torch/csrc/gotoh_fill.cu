// gotoh_fill.cu — Gotoh affine-gap DP fill for Hopper (sm_90a), one block
// per pair, emitting final3 and, optionally, the packed move codes, the
// last DP row, a block boundary injected from a checkpoint row, and — in
// strip mode — a column strip's left boundary taken from its neighbour and
// its own right edge.
//
// What it replaces.  One kernel takes the place of these TPU kernels and
// modes (files under globalign_tpu/ops/):
//   * fill_lanes.py:_make_lane_kernel (via _lanes_run), moves mode, uniform
//     and general schemes — entries lanes_batch_moves / lanes_general_moves,
//     with their row0 / col0y_top injection (the blocked replay);
//   * fill_pallas.py:_make_stacked_kernel(want_moves=True) — entry
//     stacked_fill_with_moves, with its row0 / c0y_start injection;
//   * _make_lane_kernel's cost modes: final3 (lanes_batch_final3,
//     lanes_general_final3), last rows with injection
//     (lanes_batch_last_rows, lanes_general_last_rows) and the split's
//     2-pair last rows (lanes_split_fill_cost);
//   * fill_pallas.py:_make_stacked_kernel cost mode — stacked_fill_last_rows;
//   * fill_pallas.py:_make_row_kernel — row_fill_last_rows (row0 / col0y
//     overrides), the blocked traceback's checkpoint fill;
//   * fill_pallas.py:_make_strip_kernel (:1811) — strip_fill_block (:1956),
//     one column strip's block of rows in the sequence-parallel fill
//     (parallel/seqpar.py), as the strip mode below.
// The TPU needed several kernels because Mosaic has no per-lane gather and
// VMEM sizing picks the variant; here a thread reads the (A, A) cost table
// at any index, so one kernel serves every scheme, alphabet and mode.
//
// What it computes.  For pair b, with 1-origin tokens tok_a[b, 0..M] and
// tok_b[b, 0..N] and true lengths m = m_true[b], n = n_true[b]:
//   final3[b] = (M, Ix, Iy) at cell (m, n);
//   moves[b, i, j] for 1 <= i <= m, 1 <= j <= n: bits 0-1 the M
//   predecessor, 2-3 Ix, 4-5 Iy (0 = M, 1 = Ix, 2 = Iy).  Every other
//   byte of moves[b] (row 0, column 0, the padding) is written 0;
//   last[b, :, j] = (M, Ix, Iy) of row m at column j <= n; column 0 is
//   (BIG, BIG, Iy(m, 0)), or row 0's column 0 when m = 0; columns past n
//   are written BIG.
// Boundary: row 0 is (BIG, go + D[j], BIG) with the (0, 0, 0) corner, and
// Iy(i, 0) = go + icost(a_1) + ... + icost(a_i) — unless row0[b] (3, N+1)
// replaces row 0 (corner included) and col0y_top[b] replaces the go that
// starts the column-0 sum.  A block of rows i0+1..i1 of a larger matrix is
// filled exactly by injecting its checkpoint row i0 and Iy(i0, 0).
// Strip mode (col0 (B, 3, M+1) given, with row0): column 0 is a neighbour
// strip's right edge, cell (i, 0) = col0[b, :, i] in all three lanes, and
// that Ix continues into row i without a fresh gap-open (the row scan's
// col0_full mode, fill_rows.py:119-124, :183-194).  The strip's own right
// edge comes back in edge (B, 3, M+1): entry 0 is row0 at column n, entry i
// the lanes of cell (i, n) for 1 <= i <= m, entries past m are BIG.  last
// is then the row m, column 0 included — the TPU kernel's `fin`.  Its
// `last` (the state after every row of a padded block) differs only on a
// partial final block, which no block follows, so it is not emitted.
// The arithmetic is the row scan's (globalign_tpu/ops/fill_rows.py:133-289)
// operation for operation, in int32 with BIG = 1 << 30: the clamps
// min(., BIG) at :175, :177, :193, the code tests of :212-231 on unclamped
// sums with tie order M > Ix > Iy, and the boundary of fill_scan.py:90-104.
// The row scan's Ix prefix minimum, D[j] + min(BIG, min_{j'<j} H[j'] - D[j']),
// is carried here as its serial form X[j] = min(X[j-1] + d_j, H[j-1] + d_j)
// with X[0] = BIG — the same integers, so codes match bit for bit.  An
// injected row 0 is read only as the vertical and diagonal predecessor, so
// its (clamped) Ix needs no unclamped twin.
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
// per pair and coalesced code stores are later work.  In strip mode a
// launch is one block of M rows of one strip, and the skew costs S - 1 of
// its M + S - 1 waves (1023 of 1279 for a 256-row block over 1024 strips);
// fewer threads cut the skew but, measured on the card, lose more to the
// latency the 1024 threads hide, so the launch keeps the full block.
//
// Launch conventions: the kernel runs on the caller's stream, allocates
// nothing (the caller passes every output and the scratch), and the
// launcher returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BIG = 1 << 30;
constexpr int MAX_THREADS = 1024;

template <bool MOVES, bool LAST, bool INJECT, bool STRIP>
__global__ void __launch_bounds__(MAX_THREADS)
gotoh_fill_kernel(const int* __restrict__ tok_a,
                  const int* __restrict__ tok_b,
                  const int* __restrict__ cost_mat,
                  const int* __restrict__ m_true,
                  const int* __restrict__ n_true,
                  const int* __restrict__ row0,
                  const int* __restrict__ col0y_top,
                  const int* __restrict__ col0,
                  int* __restrict__ final3,
                  uint8_t* __restrict__ moves,
                  int* __restrict__ last,
                  int* __restrict__ edge_out,
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
  const int* r0 = INJECT && row0 ? row0 + (long long)b * 3 * ld : nullptr;
  int* lst = LAST ? last + (long long)b * 3 * ld : nullptr;
  const long long lc = M + 1;  // row stride of col0 and edge_out
  const int* c0s = STRIP ? col0 + (long long)b * 3 * lc : nullptr;
  int* eg = STRIP ? edge_out + (long long)b * 3 * lc : nullptr;
  // Iy(0, 0) seed of column 0
  const int c0 = INJECT && col0y_top ? col0y_top[b] : go;

  if (MOVES) {  // zero every byte the waves do not write
    for (int j = t; j <= N; j += T) mv[j] = 0;
    for (int i = 1 + t; i <= M; i += T) mv[i * ld] = 0;
    for (int i = 1; i <= m; ++i)
      for (int j = n + 1 + t; j <= N; j += T) mv[i * ld + j] = 0;
    for (long long k = (m + 1) * ld + t; k < (M + 1) * ld; k += T) mv[k] = 0;
  }
  if (LAST)  // columns past n
    for (int j = n + 1 + t; j <= N; j += T)
      lst[j] = lst[ld + j] = lst[2 * ld + j] = BIG;
  if (STRIP) {  // the edge's row 0 and the rows past m
    for (int i = m + 1 + t; i <= M; i += T)
      eg[i] = eg[lc + i] = eg[2 * lc + i] = BIG;
    if (t == 0) eg[0] = r0[n], eg[lc] = r0[ld + n], eg[2 * lc] = r0[2 * ld + n];
  }
  __syncthreads();  // cost table staged

  if (m == 0 || n == 0) {  // only boundary cells: fill_scan.py:90-104
    if (t == 0) {
      int f0, f1, f2;
      if (INJECT && m == 0 && r0) {  // the injected row is the last row
        f0 = r0[n], f1 = r0[ld + n], f2 = r0[2 * ld + n];
        if (LAST)
          for (int j = 0; j <= n; ++j)
            lst[j] = r0[j], lst[ld + j] = r0[ld + j], lst[2 * ld + j] = r0[2 * ld + j];
      } else if (m == 0) {  // row 0: (0, 0, 0), then (BIG, go + D[j], BIG)
        int acc = go;
        f0 = 0, f1 = 0, f2 = 0;
        if (LAST) lst[0] = lst[ld] = lst[2 * ld] = 0;
        for (int j = 1; j <= n; ++j) {
          acc += gap_row[tb[j]];
          f0 = BIG, f1 = acc, f2 = BIG;
          if (LAST) lst[j] = BIG, lst[ld + j] = acc, lst[2 * ld + j] = BIG;
        }
      } else if (STRIP) {  // n == 0: the strip is its left edge
        f0 = c0s[m], f1 = c0s[lc + m], f2 = c0s[2 * lc + m];
        for (int i = 1; i <= m; ++i)
          eg[i] = c0s[i], eg[lc + i] = c0s[lc + i], eg[2 * lc + i] = c0s[2 * lc + i];
        if (LAST) lst[0] = f0, lst[ld] = f1, lst[2 * ld] = f2;
      } else {  // n == 0: column 0 only
        int acc = c0;
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

  const int w = (n + T - 1) / T;  // columns per strip
  const int S = (n + w - 1) / w;  // strips in use (S <= T)
  const int j0 = t * w + 1;       // first column of this thread's strip
  const int wt = t < S ? min(w, n - t * w) : 0;

  // Diagonal predecessor of the strip's first cell: row i-1, column j0-1.
  int dM = BIG, dX = BIG, dY = BIG;
  if (INJECT && r0) {  // row 0 from the checkpoint row
    for (int c = 0; c < wt; ++c) {
      const int s = c * T + t;
      const int j = j0 + c;
      stM[s] = r0[j];
      stX[s] = r0[ld + j];
      stY[s] = r0[2 * ld + j];
      stB[s] = tb[j];
    }
    if (t < S) dM = r0[j0 - 1], dX = r0[ld + j0 - 1], dY = r0[2 * ld + j0 - 1];
  } else {
    // D[j0 - 1]: exclusive prefix over strips of the dcost sums
    // (Hillis-Steele in the edge buffer; int32 wraps exactly as the row
    // scan's cumsum).
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
    if (t == 0) dM = 0, dX = 0, dY = 0;
    else dX = go + d_before;
  }
  int col0y = c0;  // thread 0: Iy at (i, 0) = c0 + sum icost(a_1..a_i)

  const int waves = m + S - 1;
  for (int k = 0; k < waves; ++k) {
    const int i = k - t + 1;
    if (t < S && i >= 1 && i <= m) {
      const int* sub_row = tab + ta[i] * A;
      const int ic = sub_row[gap_id];  // icost(a_i)
      int lM, lX, lY, lXu;  // row i, column j0-1 (lXu: X unclamped)
      if (t == 0 && STRIP) {  // the neighbour's edge, its Ix run unopened
        lM = c0s[i], lX = c0s[lc + i], lY = c0s[2 * lc + i], lXu = lX;
      } else if (t == 0) {
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
      if (STRIP && t == S - 1)  // column n: the strip's right edge
        eg[i] = lM, eg[lc + i] = lX, eg[2 * lc + i] = lY;
      if (i == m && t == S - 1) {  // column n ends the last strip
        final3[3 * b] = lM;
        final3[3 * b + 1] = lX;
        final3[3 * b + 2] = lY;
      }
      if (LAST && i == m) {  // the strip's share of the last row
        if (t == 0) {
          lst[0] = STRIP ? eM : BIG, lst[ld] = STRIP ? eX : BIG;
          lst[2 * ld] = STRIP ? eY : col0y;
        }
        for (int c = 0; c < wt; ++c) {
          const int s = c * T + t;
          lst[j0 + c] = stM[s], lst[ld + j0 + c] = stX[s];
          lst[2 * ld + j0 + c] = stY[s];
        }
      }
      dM = eM, dX = eX, dY = eY;
    }
    __syncthreads();
  }
}

// The modes are template parameters, so the instance without last rows and
// injection (the full-matrix align, the direct cost fill) has the wave loop
// of the plain kernel, with no per-wave test for the modes it does not use.
// Strip mode has one instance: last rows and injection, no codes.
template <bool MOVES, bool LAST>
decltype(&gotoh_fill_kernel<MOVES, LAST, false, false>) pick_kernel(bool inject) {
  return inject ? gotoh_fill_kernel<MOVES, LAST, true, false>
                : gotoh_fill_kernel<MOVES, LAST, false, false>;
}

}  // namespace

extern "C" {

// Launches the fill for B pairs on `stream`.  `moves` and `last` may be
// null (not wanted); `row0` ((B, 3, N+1)) and `col0y_top` ((B,)) may be
// null (the default boundary).  `col0` ((B, 3, M+1)) selects strip mode,
// which needs `row0`, `last` and `edge` ((B, 3, M+1)) and no `moves`;
// otherwise `col0` and `edge` are null.  `scratch` holds B * 4 * W * threads
// int32 and is used when the strip state does not fit in shared memory.
// Lengths in m_true / n_true must lie in [0, M] / [0, N] (the caller
// checks).
int gotoh_fill_launch(const void* tok_a, const void* tok_b,
                      const void* cost_mat, const void* m_true,
                      const void* n_true, const void* row0,
                      const void* col0y_top, const void* col0, void* final3,
                      void* moves, void* last, void* edge, void* scratch,
                      int B, int M, int N, int A, int gap_id, int gap_open,
                      int threads, int W, void* stream) {
  if (threads < 32 || threads > MAX_THREADS || threads % 32 != 0 || W < 1 ||
      B < 1)
    return (int)cudaErrorInvalidValue;
  const bool strip = col0 != nullptr;
  if (strip ? (!row0 || !last || !edge || moves) : edge != nullptr)
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

  const bool inject = row0 != nullptr || col0y_top != nullptr;
  auto kernel = strip ? gotoh_fill_kernel<false, true, true, true>
                : moves ? (last ? pick_kernel<true, true>(inject)
                                : pick_kernel<true, false>(inject))
                        : (last ? pick_kernel<false, true>(inject)
                                : pick_kernel<false, false>(inject));
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<B, threads, smem, (cudaStream_t)stream>>>(
      (const int*)tok_a, (const int*)tok_b, (const int*)cost_mat,
      (const int*)m_true, (const int*)n_true, (const int*)row0,
      (const int*)col0y_top, (const int*)col0, (int*)final3, (uint8_t*)moves,
      (int*)last, (int*)edge, (int*)scratch, M, N, A, gap_id, gap_open, W,
      table_in_smem ? 1 : 0,
      state_in_smem ? 1 : 0);
  return (int)cudaGetLastError();
}

const char* gotoh_fill_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
