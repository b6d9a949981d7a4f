// gotoh_batch.cu — cost-only Gotoh fills of many pairs for Hopper (sm_90a),
// one warp per pair, the strip state in registers: final3 and, optionally,
// each pair's last row.  One launch takes pairs of any lengths (a ragged
// batch), described one by one.
//
// What it replaces.  Two TPU kernels of the batch cost path
// (globalign_tpu/ops/fill_pallas.py:batch_final3):
//   * _make_stacked_uniform_kernel (:1321, launched by
//     stacked_uniform_fill_last_rows :1441): B >= 8 pairs advance together,
//     a row at a time, one pair per vector slot; uniform schemes only;
//   * _make_batch_row_kernel (:458, launched by row_fill_last_rows_batch
//     :353): the grid-per-pair row kernel, any matrix.
// Both return each pair's row m_true[b] as (B, 3, R * 128), which
// batch_final3 reads at column n_true[b].  The JAX package also fuses a
// call's cost buckets into one dispatch (globalign_tpu/batch.py:252,
// _chunk_costs_jit); here one launch holds every pair of a width class.
//
// What it computes.  For pair p, with 1-origin tokens ta[0..m], tb[0..n]
// (its descriptor's pointers; entry 0 unused) and true lengths m, n:
//   final3[out] = (M, Ix, Iy) at cell (m, n);
//   last[:, j] = (M, Ix, Iy) of row m at column j <= n, last[:, 0] is
//   (BIG, BIG, Iy(m, 0)), or row 0's (0, 0, 0) when m = 0; columns
//   n < j < ld are written BIG — the contract of gotoh_fill's last-row mode.
// The arithmetic is gotoh_fill's (gotoh_fill.cu:514-579), with G kept less
// go: int32, BIG = 1 << 30 clamps, the serial Ix carry X[j] =
// min(X[j-1] + d_j, H[j-1] + d_j) (unrolled as min(L + D[c], G[c])) with
// the unclamped X passed across the strip edge, int32 wrap in the row-0
// prefix, and the boundary of fill_scan.py.  So final3 and the last rows
// are bit-identical to the plain version (the row scan of
// ops/fill_rows.py, pair by pair).
//
// Design.
//   * A warp per pair, the strip state in registers.  Lane l owns the W
//     consecutive columns l*W+1 .. (l+1)*W (W a template parameter: 4, 8,
//     16 or 32, so 32 W <= 1024 columns a pair) and keeps its previous row
//     (M, Ix, Iy), its seq_2 tokens (4 a register) and the prefix D of
//     their gap costs in registers.  Register arrays are indexed only by
//     unrolled constants; a strip narrower than W computes its unused
//     columns and never reads them, so nothing spills.  A pair of n
//     columns uses S = ceil(n / W) lanes.
//   * Skew by shuffles.  In wave k lane l fills row k - l + 1; its left
//     edge (M, Ix, Iy and X unclamped) comes from lane l - 1 by
//     __shfl_up_sync.  A warp runs m + S - 1 waves, the same count for
//     every lane, so the shuffles never diverge; no block barrier after
//     the table is staged.  Each lane reads its next row's seq_1 token a
//     wave ahead.
//   * Shared memory holds only the (A, A) cost table: one lookup a cell
//     for the substitution cost.  A <= 256 (tokens are bytes).
//   * A ragged launch.  Each pair is a descriptor of 8 int64 words: the
//     device addresses of its seq_1 and seq_2 tokens and of its last row
//     (0 without), m, n, the last row's stride ld (its bucket's N + 1), its
//     final3 row, and a pad.  The wrapper (ops/fill_batch.py) gives one
//     launch the pairs of one W class, longest (m * n) first, so the
//     launch's tail is short; final3 comes back in the caller's order.
//     Padding columns are never computed.
//   * Blocks of `warps` warps (2: fill_batch.WARPS), so the registers
//     and not the table set the warps an SM.  On sm_90a (ptxas -v,
//     tests/test_torch_cuda.py::test_ptxas_reports_no_spills), final3 /
//     last rows: W = 32 226 / 242
//     registers, 8 warps an SM; W = 16 152 / 141, 12 / 14; W = 8 84 / 96,
//     22 / 20; W = 4 54 / 64, 36 / 32; no spills.
//
// What bounds it on this card.  Its roofline is int32 issue: 10 int32
// operations a cell (DPX fused add-min and 3-way min), a byte extract, an
// address add and one shared-memory load; sm_90 issues 64 int32
// operations a clock an SM.  The only serial chain per cell is K's; the
// M and Iy lanes of a row's W cells are independent, so one warp exposes
// W-wide instruction-level parallelism, and the SM's other warps hide the
// rest once the launch holds several pairs an SM.  Measured on an H100
// (700 W): 1024 pairs of up to 1024^2 in one launch run 4.16 cells a
// clock an SM, 54% of the probe's cost-only cell rate; a lone warp takes
// ~0.47 ms for a 1024^2 pair, which still beats gotoh_fill's pair over a
// cluster (PERF.md section 6).
//
// Launch conventions: the kernel runs on the caller's stream, allocates
// nothing, and the launcher returns the launch's error code.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BIG = 1 << 30;
constexpr int WARP = 32;
constexpr int MAX_WARPS = 4;
constexpr int DESC = 8;  // int64 words a pair descriptor
constexpr unsigned FULL = 0xffffffffu;

// min(a + b, c) and min(a, b, c): sm_90's DPX forms.
__device__ __forceinline__ int addmin(int a, int b, int c) {
  return __viaddmin_s32(a, b, c);
}

__device__ __forceinline__ int min3(int a, int b, int c) {
  return __vimin3_s32(a, b, c);
}

template <int W, bool LAST>
__global__ void __launch_bounds__(MAX_WARPS * WARP)
gotoh_batch_kernel(const long long* __restrict__ desc, int B,
                   const int* __restrict__ cost_mat, int A, int gap_id,
                   int go, int* __restrict__ final3) {
  extern __shared__ int tab[];  // (A, A) cost table
  const int warps = blockDim.x / WARP;
  const int lane = threadIdx.x % WARP;
  const int wid = threadIdx.x / WARP;
  for (int k = threadIdx.x; k < A * A; k += blockDim.x) tab[k] = cost_mat[k];
  __syncthreads();  // the table is staged; no block barrier after this

  const int p = blockIdx.x * warps + wid;
  if (p >= B) return;  // warp-uniform
  const long long* d = desc + (long long)DESC * p;
  const int* ta = reinterpret_cast<const int*>(d[0]);
  const int* tb = reinterpret_cast<const int*>(d[1]);
  int* lst = LAST ? reinterpret_cast<int*>(d[2]) : nullptr;
  const int m = (int)d[3];
  const int n = (int)d[4];
  const long long ld = d[5];
  int* f3 = final3 + 3 * d[6];
  const int* gap_row = tab + gap_id * A;  // dcost(c) = cost('-', c)

  if (LAST)  // columns past n
    for (long long j = n + 1 + lane; j < ld; j += WARP)
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
      f3[0] = f0, f3[1] = f1, f3[2] = f2;
    }
    return;
  }

  const int S = (n + W - 1) / W;  // strips in use (<= 32)
  const int j0 = lane * W + 1;    // the lane's first column
  const int wt = lane < S ? min(W, n - lane * W) : 0;  // its real columns

  // Tokens (4 a register) and D[c] = d_0 + ... + d_c, the strip's prefix
  // of the gap costs d_c = dcost(b_{j0+c}); D[j0 - 1] of the row is the
  // exclusive warp scan of the strips' sums (int32 wraps exactly as the
  // row scan's cumsum).
  int tk4[W / 4], D[W];
  int part = 0;
#pragma unroll
  for (int c = 0; c < W; ++c) {
    const int t = c < wt ? tb[j0 + c] : 0;
    if (c % 4 == 0) tk4[c / 4] = t;
    else tk4[c / 4] |= t << (8 * (c % 4));
    const int g = gap_row[t];
    part += c < wt ? g : 0;
    D[c] = (c > 0 ? D[c - 1] : 0) + g;
  }
  int incl = part;
  for (int off = 1; off < WARP; off <<= 1) {
    const int v = __shfl_up_sync(FULL, incl, off);
    if (lane >= off) incl += v;
  }
  const int d_before = incl - part;

  // Row 0: (BIG, go + D[j], BIG); the diagonal predecessor of the strip's
  // first cell is row 0 at column j0 - 1, (0, 0, 0) at the corner.
  int pM[W], pX[W], pY[W];
#pragma unroll
  for (int c = 0; c < W; ++c) pM[c] = BIG, pX[c] = go + d_before + D[c], pY[c] = BIG;
  int dM = BIG, dX = go + d_before, dY = BIG;
  if (lane == 0) dM = 0, dX = 0, dY = 0;
  int col0y = go;  // lane 0: Iy(i, 0) = go + icost(a_1) + ... + icost(a_i)
  int oM = BIG, oX = BIG, oY = BIG, oXu = BIG;  // right edge of the last row
  int a_next = ta[1];  // the seq_1 token of the lane's next row
  const int cn = n - j0;  // column n's slot in the last strip
  const bool holds_n = lane == S - 1;

  const int waves = m + S - 1;
  for (int k = 0; k < waves; ++k) {
    // The left neighbour filled row k - lane + 1 in wave k - 1.
    const int rM = __shfl_up_sync(FULL, oM, 1);
    const int rX = __shfl_up_sync(FULL, oX, 1);
    const int rY = __shfl_up_sync(FULL, oY, 1);
    const int rXu = __shfl_up_sync(FULL, oXu, 1);
    const int i = k - lane + 1;
    if (lane < S && i >= 1 && i <= m) {
      const int* row = tab + a_next * A;
      a_next = ta[min(i + 1, m)];
      const int ic = row[gap_id];  // icost(a_i)
      // M and Iy need only the row above and the diagonal; so does G[c] =
      // min over 1 <= k <= c of h_k + d_{k+1} + ... + d_c, h_k =
      // min(M, Iy)(i, j0+k-1) + go + d_k, the part of Ix that does not
      // start at the left edge.  pX[c] holds K[c] = G[c] - go until the
      // edge comes: K[c] = min(K[c-1], M, Iy of column c-1) + d_c, two
      // operations where G's serial form takes four.
      int kx = 0;
#pragma unroll
      for (int c = 0; c < W; ++c) {
        const int mp = pM[c], xp = pX[c], yp = pY[c];
        const int sub = row[__byte_perm(tk4[c / 4], 0, 0x4440 | (c % 4))];
        const int mc = addmin(min3(dM, dX, dY), sub, BIG);
        const int yc = addmin(addmin(min(mp, xp), go, yp), ic, BIG);
        if (c > 0) {
          const int dd = D[c] - D[c - 1];
          kx = (c == 1 ? min(pM[0], pY[0]) : min3(kx, pM[c - 1], pY[c - 1])) + dd;
          pX[c] = kx;
        }
        dM = mp, dX = xp, dY = yp;
        pM[c] = mc, pY[c] = yc;
      }
      int lM, lX, lY, lXu;  // row i, column j0 - 1
      if (lane > 0) {
        lM = rM, lX = rX, lY = rY, lXu = rXu;
      } else {  // the matrix edge
        col0y += ic;
        lM = BIG, lX = BIG, lY = col0y, lXu = BIG;
      }
      // Ix: X[c] = min(L + D[c], G[c]) with L = min(X, min(M, Iy) + go) of
      // the left edge — the serial X[c] = min(X[c-1] + d_c, h_c) unrolled,
      // the same integers — taken as min(L - go + D[c], K[c]) + go.
      const int Lg = min(lXu - go, min(lM, lY));
      int xk = Lg + D[0];
#pragma unroll
      for (int c = 0; c < W; ++c) {
        if (c > 0) xk = addmin(Lg, D[c], pX[c]);
        pX[c] = addmin(xk, go, BIG);
      }
      oM = pM[W - 1], oX = pX[W - 1], oY = pY[W - 1], oXu = xk + go;
      if (i == m) {
        if (holds_n) {  // column n ends the last strip
          int fM = BIG, fX = BIG, fY = BIG;
#pragma unroll
          for (int c = 0; c < W; ++c)
            if (c == cn) fM = pM[c], fX = pX[c], fY = pY[c];
          f3[0] = fM, f3[1] = fX, f3[2] = fY;
        }
        if (LAST) {  // the strip's share of the last row
          if (lane == 0) lst[0] = BIG, lst[ld] = BIG, lst[2 * ld] = col0y;
#pragma unroll
          for (int c = 0; c < W; ++c)
            if (c < wt)
              lst[j0 + c] = pM[c], lst[ld + j0 + c] = pX[c],
              lst[2 * ld + j0 + c] = pY[c];
        }
      }
      dM = lM, dX = lX, dY = lY;
    }
  }
}

using Kernel = void (*)(const long long*, int, const int*, int, int, int, int*);

template <bool LAST>
Kernel pick_width(int W) {
  switch (W) {
    case 4: return gotoh_batch_kernel<4, LAST>;
    case 8: return gotoh_batch_kernel<8, LAST>;
    case 16: return gotoh_batch_kernel<16, LAST>;
    case 32: return gotoh_batch_kernel<32, LAST>;
    default: return nullptr;
  }
}

}  // namespace

extern "C" {

// Launches the fills of the B pairs described at `desc` ((B, 8) int64 on
// the device) on `stream`: W columns a lane (every pair has n <= 32 W),
// `warps` pairs a block.  `last` != 0 writes each pair's last row through
// its descriptor.  The dynamic shared memory is the table, 4 A^2 bytes,
// and must fit the device's opt-in limit, else the launch is refused (no
// fallback).  Lengths must lie in [0, its buffers]; tokens in [0, A).
int gotoh_batch_launch(const void* desc, int B, const void* cost_mat, int A,
                       int gap_id, int gap_open, void* final3, int last,
                       int W, int warps, void* stream) {
  if (B < 1 || A < 1 || A > 256 || gap_id < 0 || gap_id >= A || warps < 1 ||
      warps > MAX_WARPS)
    return (int)cudaErrorInvalidValue;
  const Kernel kernel = last ? pick_width<true>(W) : pick_width<false>(W);
  if (!kernel) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)A * A * sizeof(int);
  if (smem > 48 * 1024) {  // past the default: opt in (refused past the card's limit)
    const cudaError_t err = cudaFuncSetAttribute(
        (const void*)kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int blocks = (B + warps - 1) / warps;
  kernel<<<blocks, warps * WARP, smem, (cudaStream_t)stream>>>(
      (const long long*)desc, B, (const int*)cost_mat, A, gap_id, gap_open,
      (int*)final3);
  return (int)cudaGetLastError();
}

const char* gotoh_batch_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
