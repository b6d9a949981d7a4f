// gotoh_batch_moves.cu — Gotoh fills with move codes of many pairs for
// Hopper (sm_90a), one warp per pair, the strip state in registers: final3
// and every pair's codes, packed through per-pair descriptors.  One launch
// takes pairs of any lengths up to 1024 columns (a ragged batch).
//
// What it replaces.  The moves fills of a traceback align_pairs call, which
// the JAX package queues for one device walk over the call
// (globalign_tpu/batch.py:_lanes_walk_fills, _mega_walk_flush), through
// these TPU kernels (files under globalign_tpu/ops/):
//   * fill_lanes.py:_make_lane_kernel (:201) in moves mode, entries
//     lanes_batch_moves (:1978, uniform schemes) and lanes_general_moves
//     (:1791, any matrix);
//   * fill_pallas.py:_make_stacked_kernel(want_moves=True) (:496).
// Pairs wider than 1024 columns, or whose table does not fit in shared
// memory, stay on gotoh_fill's ragged moves mode (ops/fill_cuda.py routes;
// both write one buffer in one layout, walked by one walk_ragged launch).
//
// What it computes.  For pair p, described by desc[p] (8 int64 words: its
// seq_1 and seq_2 token addresses, m, n, the byte offset of its codes,
// their row stride ld, its row of final3, a pad), with 1-origin tokens
// ta[0..m], tb[0..n] (entry 0 unused):
//   final3[row] = (M, Ix, Iy) at cell (m, n);
//   codes[off + i * ld + j] for 1 <= i <= m, 1 <= j <= n: bits 0-1 the M
//   predecessor, 2-3 Ix, 4-5 Iy (0 = M, 1 = Ix, 2 = Iy); every other byte
//   of the (m + 1) rows of ld bytes (row 0, column 0, columns n < j < ld)
//   is written 0.  The layout: off and ld are multiples of 16
//   (ops/fill_cuda.py:ragged_stride, ragged_offsets), and codes is
//   16-byte aligned, so every store below is aligned.
// The arithmetic is gotoh_batch's (csrc/gotoh_batch.cu: int32, BIG = 1 << 30
// clamps, Ix carried as K = G - go), and the code tests are gotoh_fill's
// (gotoh_fill.cu, its moves mode): exact equalities on unclamped sums with
// tie order M > Ix > Iy, the row scan's rule (globalign_tpu/ops/
// fill_rows.py:210-231); the Ix test takes the clamped X against the left
// column's M + go + d and Ix + d, from the shuffled left edge at the strip's
// first column and from the matrix edge (BIG, BIG) at column 1.  Pairs with
// m = 0 or n = 0 take fill_scan.py's boundary, every code byte 0.  So
// final3 and the codes are bit-identical to the plain version (the row
// scan of ops/fill_rows.py, pair by pair).
//
// Design.
//   * gotoh_batch's wavefront.  Lane l of a warp owns the W consecutive
//     columns l*W+1 .. (l+1)*W (W a template parameter: 4, 8, 16 or 32,
//     ops/fill_batch.width_class) and keeps its previous row, its seq_2
//     tokens and the prefix of their gap costs in registers; in wave k it
//     fills row k - l + 1, its left edge from lane l - 1 by __shfl_up_sync;
//     no block barrier after the (A, A) table is staged in shared memory.
//   * Codes stored from registers, aligned, with no staging.  A lane packs
//     its row's W codes in W / 4 words and writes the row's bytes l*W ..
//     l*W + W - 1: byte l*W is column l*W, the last code of lane l - 1 on
//     the same row a wave earlier (one more shuffle; column 0 for lane 0),
//     and the rest its own columns but its last, shifted by one byte
//     (__funnelshift_l).  Rows start 16-byte aligned, so these are 16-byte
//     stores (W bytes at W = 4 and 8), each in its own row: no shared ring
//     (gotoh_fill's 32 skewed rows a warp, 33 KB at W = 32), no byte store,
//     no write shared by two lanes.  The lane that holds column n masks its
//     columns past n to 0 and writes the row's bytes from (S W) to ld, the
//     last lane's last code and zeros.  A unit of W = 32 is stored as soon
//     as its codes are complete, so its words need not stay live.
//   * A ragged launch a width class.  The wrapper (ops/fill_cuda.py,
//     batch_moves_ragged) gives one launch the pairs of one W, longest
//     (m * n) first; blocks of `warps` warps (2, ops/fill_batch.WARPS).
//   Registers and spills: ptxas -v, held to no spill by
//   tests/test_torch_cuda.py::test_ptxas_reports_no_spills.
//
// What bounds it on this card.  Int32 issue: the cost form's ~10 operations
// a cell, plus the code tests (four DPX min-with-predicate, two compares)
// and the packing, against sm_90's 64 int32 operations a clock an SM; the
// codes (one byte a cell) are a quarter of HBM3's rate at that cell rate.
// Times and bound: PERF.md section 6.
//
// Launch conventions: the kernel runs on the caller's stream, allocates
// nothing, and the launcher returns the launch's error code.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BIG = 1 << 30;
constexpr int WARP = 32;
constexpr int MAX_WARPS = 4;
constexpr int DESC = 8;     // int64 words a pair descriptor
constexpr int ALIGN = 16;   // bytes: code offsets, row strides, the buffer
constexpr unsigned FULL = 0xffffffffu;

// min(a + b, c): sm_90's DPX form.
__device__ __forceinline__ int addmin(int a, int b, int c) {
  return __viaddmin_s32(a, b, c);
}

// U bytes (4, 8 or 16) of words w at p, aligned to U.
template <int U>
__device__ __forceinline__ void store_unit(uint8_t* p, const uint32_t* w) {
  if constexpr (U == 16)
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  else if constexpr (U == 8)
    *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
  else
    *reinterpret_cast<uint32_t*>(p) = w[0];
}

// The warp writes `bytes` zero bytes (a multiple of 16) from p (aligned).
__device__ __forceinline__ void zero_bytes(uint8_t* p, long long bytes, int lane) {
  uint4* q = reinterpret_cast<uint4*>(p);
  for (long long k = lane; k < bytes / ALIGN; k += WARP) q[k] = make_uint4(0, 0, 0, 0);
}

template <int W>
__global__ void __launch_bounds__(MAX_WARPS * WARP)
gotoh_batch_moves_kernel(const long long* __restrict__ desc, int B,
                         const int* __restrict__ cost_mat, int A, int gap_id,
                         int go, int* __restrict__ final3,
                         uint8_t* __restrict__ codes) {
  constexpr int NW = W / 4;            // code words a lane
  constexpr int U = W < 16 ? W : 16;   // bytes a store
  constexpr int UW = U / 4;            // words a store
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
  const int m = (int)d[2];
  const int n = (int)d[3];
  uint8_t* mv = codes + d[4];
  const long long ld = d[5];
  int* f3 = final3 + 3 * d[6];
  const int* gap_row = tab + gap_id * A;  // dcost(c) = cost('-', c)

  if (m == 0 || n == 0) {  // only boundary cells: fill_scan.py:90-104
    zero_bytes(mv, (m + 1) * ld, lane);
    if (lane == 0) {
      int f0, f1, f2;
      if (m == 0) {  // row 0: (0, 0, 0), then (BIG, go + D[j], BIG)
        int acc = go;
        f0 = 0, f1 = 0, f2 = 0;
        for (int j = 1; j <= n; ++j) {
          acc += gap_row[tb[j]];
          f0 = BIG, f1 = acc, f2 = BIG;
        }
      } else {  // n == 0: column 0 only
        int acc = go;
        for (int i = 1; i <= m; ++i) acc += tab[ta[i] * A + gap_id];
        f0 = BIG, f1 = BIG, f2 = acc;
      }
      f3[0] = f0, f3[1] = f1, f3[2] = f2;
    }
    return;
  }
  zero_bytes(mv, ld, lane);  // row 0

  const int S = (n + W - 1) / W;  // strips in use (<= 32)
  const int j0 = lane * W + 1;    // the lane's first column
  const int wt = lane < S ? min(W, n - lane * W) : 0;  // its real columns
  // Bytes of code word u kept: those of columns j0 - 1 + 4u + t <= n, so
  // mask(u) = ~0 >> max(0, cut + 32 u) (0 once the shift reaches 32).
  const int cut = 24 - 8 * wt;

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
  uint32_t oC = 0;  // the code word of the lane's last 4 columns, last row
  int a_next = ta[1];  // the seq_1 token of the lane's next row
  const int cn = n - j0;  // column n's slot in the last strip
  const bool holds_n = lane == S - 1;
  const long long jb = (long long)lane * W;  // the lane's first byte of a row

  const int waves = m + S - 1;
  for (int k = 0; k < waves; ++k) {
    // The left neighbour filled row k - lane + 1 in wave k - 1.
    const int rM = __shfl_up_sync(FULL, oM, 1);
    const int rX = __shfl_up_sync(FULL, oX, 1);
    const int rY = __shfl_up_sync(FULL, oY, 1);
    const int rXu = __shfl_up_sync(FULL, oXu, 1);
    const uint32_t rC = __shfl_up_sync(FULL, oC, 1);
    const int i = k - lane + 1;
    if (lane < S && i >= 1 && i <= m) {
      const int* row = tab + a_next * A;
      a_next = ta[min(i + 1, m)];
      const int ic = row[gap_id];  // icost(a_i)
      uint8_t* out = mv + i * ld + jb;
      // M and Iy, with their codes, need only the row above and the
      // diagonal; so does K[c] = G[c] - go, the part of Ix that does not
      // start at the left edge (gotoh_batch.cu).  pX[c] holds K[c] until
      // the edge comes.
      uint32_t code[NW];
      int kx = 0;
#pragma unroll
      for (int c = 0; c < W; ++c) {
        const int mp = pM[c], xp = pX[c], yp = pY[c];
        const int sub = row[__byte_perm(tk4[c / 4], 0, 0x4440 | (c % 4))];
        bool p1, p2, p3, p4;
        const int m1 = __vibmin_s32(dX, dY, &p1);       // dX <= dY
        const int best = __vibmin_s32(dM, m1, &p2);     // dM first
        const int t2 = __vibmin_s32(mp, xp, &p3);       // mp <= xp
        const int vy = __vibmin_s32(t2 + go, yp, &p4);  // Iy opens
        const uint32_t cc = (uint32_t)((p2 ? 0 : (p1 ? 1 : 2)) |
                                       ((p4 ? (p3 ? 0 : 1) : 2) << 4));
        code[c / 4] = c % 4 ? code[c / 4] | cc << (8 * (c % 4)) : cc;
        if (c > 0) {
          const int dd = D[c] - D[c - 1];
          kx = (c == 1 ? min(pM[0], pY[0]) : __vimin3_s32(kx, pM[c - 1], pY[c - 1])) + dd;
          pX[c] = kx;
        }
        dM = mp, dX = xp, dY = yp;
        pM[c] = addmin(best, sub, BIG), pY[c] = addmin(vy, ic, BIG);
      }
      int lM, lX, lY, lXu;  // row i, column j0 - 1
      if (lane > 0) {
        lM = rM, lX = rX, lY = rY, lXu = rXu;
      } else {  // the matrix edge
        col0y += ic;
        lM = BIG, lX = BIG, lY = col0y, lXu = BIG;
      }
      // Ix: X[c] = min(L + D[c], G[c]) with L = min(X, min(M, Iy) + go) of
      // the left edge, taken as min(L - go + D[c], K[c]) + go; its code
      // against the left column's M + go + d and Ix + d (unclamped sums).
      const int Lg = min(lXu - go, min(lM, lY));
      const uint32_t left = lane > 0 ? rC : 0u;  // column j0 - 1's code
      int xk = Lg + D[0];
#pragma unroll
      for (int c = 0; c < W; ++c) {
        if (c > 0) xk = addmin(Lg, D[c], pX[c]);
        const int xc = min(xk + go, BIG);
        const int dd = c > 0 ? D[c] - D[c - 1] : D[0];
        const int hM = c > 0 ? pM[c - 1] : lM;  // M and Ix to the left
        const int hX = c > 0 ? pX[c - 1] : lX;
        code[c / 4] |= (uint32_t)(xc == hM + go + dd ? 0 : (xc == hX + dd ? 1 : 2))
                       << (8 * (c % 4) + 2);
        pX[c] = xc;
        if (c % U == U - 1) {  // bytes jb + c + 1 - U .. jb + c are complete
          const int q = c / U;
          if (q == 0 || jb + q * U < ld) {  // a unit of W = 32 may pass ld
            uint32_t w[UW];
#pragma unroll
            for (int u = 0; u < UW; ++u) {
              const int g = q * UW + u;  // byte 0: column j0 - 1 + 4 g
              const uint32_t lo = g > 0 ? code[g > 0 ? g - 1 : 0] : left;
              w[u] = __funnelshift_l(lo, code[g], 8) &
                     __funnelshift_rc(FULL, 0u, max(0, cut + 32 * g));
            }
            store_unit<U>(out + q * U, w);
          }
        }
      }
      oM = pM[W - 1], oX = pX[W - 1], oY = pY[W - 1], oXu = xk + go;
      oC = code[NW - 1];
      if (holds_n) {
        // Bytes S W .. ld - 1: column S W's code (the lane's last, kept only
        // when it is column n) and zeros.
#pragma unroll
        for (int q = 0; q < ALIGN / U; ++q) {
          const long long t = (long long)S * W + q * U;
          if (t < ld) {
            uint32_t w[UW];
#pragma unroll
            for (int u = 0; u < UW; ++u)
              w[u] = q == 0 && u == 0 && wt == W ? code[NW - 1] >> 24 : 0u;
            store_unit<U>(mv + i * ld + t, w);
          }
        }
        if (i == m) {  // column n ends the last strip
          int fM = BIG, fX = BIG, fY = BIG;
#pragma unroll
          for (int c = 0; c < W; ++c)
            if (c == cn) fM = pM[c], fX = pX[c], fY = pY[c];
          f3[0] = fM, f3[1] = fX, f3[2] = fY;
        }
      }
      dM = lM, dX = lX, dY = lY;
    }
  }
}

using Kernel = void (*)(const long long*, int, const int*, int, int, int, int*,
                        uint8_t*);

Kernel pick_width(int W) {
  switch (W) {
    case 4: return gotoh_batch_moves_kernel<4>;
    case 8: return gotoh_batch_moves_kernel<8>;
    case 16: return gotoh_batch_moves_kernel<16>;
    case 32: return gotoh_batch_moves_kernel<32>;
    default: return nullptr;
  }
}

}  // namespace

extern "C" {

// Launches the moves fills of the B pairs described at `desc` ((B, 8)
// int64 on the device) on `stream`: W columns a lane (every pair has
// 1 <= n <= 32 W, or m = 0 / n = 0), `warps` pairs a block; codes through
// the descriptors' offsets into `codes` (16-byte aligned; offsets and row
// strides multiples of 16, the caller checks them and the lengths).  The
// dynamic shared memory is the table, 4 A^2 bytes, and must fit the
// device's opt-in limit, else the launch is refused (no fallback).
int gotoh_batch_moves_launch(const void* desc, int B, const void* cost_mat,
                             int A, int gap_id, int gap_open, void* final3,
                             void* codes, int W, int warps, void* stream) {
  if (B < 1 || A < 1 || A > 256 || gap_id < 0 || gap_id >= A || warps < 1 ||
      warps > MAX_WARPS || !codes || (uintptr_t)codes % ALIGN)
    return (int)cudaErrorInvalidValue;
  const Kernel kernel = pick_width(W);
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
      (int*)final3, (uint8_t*)codes);
  return (int)cudaGetLastError();
}

const char* gotoh_batch_moves_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
